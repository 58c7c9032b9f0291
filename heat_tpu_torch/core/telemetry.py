"""Runtime telemetry: collective accounting, dispatch and host-sync counts,
spans, scoped sessions and the trace timeline (reference:
heat_tpu/core/telemetry.py).

The port keeps the reference's surface and its knobs, so one setting drives
both packages:

* **Collectives.** Every :class:`~.communication.MeshCommunication` verb
  (``allreduce``, ``allgather``, ``alltoall``, ``ppermute``, ``bcast``,
  ``exscan``, ``scan``) records the op, the mesh axis (``"split"``), the
  dtype and one participant's payload bytes (:func:`record_collective`,
  queried with :func:`collective_counts`). The verbs run in-process on
  every call, so the counts are what the port did on that call. The
  explicitly scheduled linear algebra (CholeskyQR2, TSQR, the panel QR, the
  blocked substitution) declares its schedule with the reference's op
  names, bytes and multiplicities instead. Recording reads shapes and
  dtypes only, never a value.
* **Dispatches and host reads.** The engines count their dispatches,
  deferred into a fused program or eager (:func:`record_dispatch`), with
  the reason of each op that did not defer (:func:`unfused_reasons`);
  ``item()``, ``numpy()`` and ``print`` are host reads that wait on the
  device, counted as blocking syncs with their wall time
  (:func:`record_blocking_sync`).
* **The fusion recorder** (``core/fusion.py``). Each force is attributed
  to its forcing point (:func:`forcing_points`, with the chain depths and
  the forces that built a program), each program build to its op family
  (:func:`retraces`; a family rebuilt under
  ``HEAT_TPU_TELEMETRY_RETRACE_WARN`` distinct leaf layouts warns
  :class:`RetraceWarning` once), each fused dispatch counted
  (``report()["async_forcing"]``) and each degraded program recorded
  (:func:`degraded`). ``report()`` carries the program cache
  (``fusion_cache``) and the top programs by dispatches (``programs``,
  ``HEAT_TPU_TELEMETRY_TOP_PROGRAMS``, with their cost estimates once
  :func:`program_costs` computed them). A chain's record, dispatch and
  blocking sync share a correlation id (``cid``): :func:`export_trace`
  pairs each sync with the dispatch it waited on.
* **Faults, retries, non-finite values, checkpoints.** The resilience layer
  and the I/O and checkpoint code record what they absorbed.

``HEAT_TPU_TELEMETRY={0,1,verbose}`` is the knob, read at import
(:func:`set_mode`/:func:`enabled` in-process). Off is the default and costs
one module-attribute read per instrumented site. ``verbose`` also keeps a
capped, timestamped event log (:func:`events`, cap
``HEAT_TPU_TELEMETRY_EVENTS``, drops counted in
``report()["timeline"]["events_dropped"]``) that :func:`export_trace`
renders as Chrome/Perfetto trace-event JSON.

A :func:`span` measures host time and never synchronizes the device: work
it enqueued may still run after it closes. ``utils.profiling.Timer`` and
``timed`` are the synchronized measurement.

Three hooks join the runtime's other layers without this module importing
them: ``core/memledger.py`` installs ``_MEM_HOOK`` (a throttled ledger
sample at the dispatch, collective and checkpoint record seams) and
``core/health_runtime.py`` installs ``_FLIGHT_HOOK`` (every typed event
into the flight ring, at mode 1 too) and ``_SYNC_HOOK`` (every closed
blocking sync into the latency histograms). :func:`reset` and
:func:`scope` reset and scope their session state as well, and
``report()`` carries their ``memory`` ledger and ``health`` blocks.

The recorder's collective nodes (a split-axis reduction's combine, a
deferred resplit, a per-shard schedule, a matmul) run inside fused
programs and call no verb: :func:`record_fused_collective` counts them at
record time (``report()["fused_collectives"]``), and
:func:`hlo_collective_counts` reads them back from a pending chain's
program text (``fusion.program_hlo``).

Two more hooks are set by the modules that read them:
``core/numlens.py`` installs ``_NUMLENS_HOOK`` while the numerics lens is
on (the fusion recorder calls it after a program's values land), and
``report()`` carries its ``numerics`` block and, once the serving layer has
sessions, ``core/serving.py``'s ``serving`` block. The lens's ``numeric``
timeline events export as instants, its sampled statistics also as
Perfetto counter tracks beside the memory ledger's.

Not here yet: the elastic, autoscale and multi-process blocks of
``report()``. Their modules come with later parts of the port.
"""

from __future__ import annotations

import atexit
import json
import os
import re
import threading
import time
import warnings
from collections import deque
from contextlib import contextmanager
from typing import Any, Dict, List, Optional

__all__ = [
    "RetraceWarning",
    "TimelineDroppedWarning",
    "active",
    "async_forcing",
    "async_pairs",
    "checkpoint_events",
    "collective_budget_excess",
    "collective_counts",
    "collectives",
    "current_trigger",
    "degraded",
    "degraded_counts",
    "dispatches",
    "enabled",
    "end_blocking_sync",
    "events",
    "export_trace",
    "fault_events",
    "force_trigger",
    "forcing_points",
    "hlo_collective_counts",
    "hlo_collectives",
    "io_retries",
    "merge_traces",
    "nonfinite_counts",
    "on_timer",
    "operand_bytes",
    "program_costs",
    "record_async_dispatch",
    "record_blocking_sync",
    "record_checkpoint",
    "record_collective",
    "record_collective_operand",
    "record_compile",
    "record_degraded",
    "record_dispatch",
    "record_event",
    "record_fault",
    "record_force",
    "record_fused_collective",
    "fused_collectives",
    "record_io_retry",
    "record_nonfinite",
    "record_retrace",
    "record_unfused",
    "report",
    "report_json",
    "reset",
    "retraces",
    "scope",
    "scope_reports",
    "set_metrics_sink",
    "set_mode",
    "span",
    "spans",
    "trace_collective_parity",
    "trace_events",
    "unfused_reasons",
    "validate_trace",
    "verbose",
]


class RetraceWarning(UserWarning):
    """One op family of the fusion recorder was rebuilt under
    ``HEAT_TPU_TELEMETRY_RETRACE_WARN`` distinct leaf layouts: shape churn
    defeats the program cache."""


class TimelineDroppedWarning(UserWarning):
    """The trace timeline hit its event cap and dropped the oldest events:
    the recorded window is truncated. One-shot per :func:`reset`; raise
    ``HEAT_TPU_TELEMETRY_EVENTS`` to keep the whole window."""


_OFF_VALUES = ("", "0", "false", "off", "no")


def _parse_mode(value) -> int:
    if isinstance(value, bool):
        return 1 if value else 0
    if isinstance(value, int):
        return max(0, min(2, value))
    v = str(value).strip().lower()
    if v in _OFF_VALUES:
        return 0
    if v in ("2", "verbose", "debug"):
        return 2
    return 1


#: 0 = off, 1 = on, 2 = verbose. A module attribute, so an instrumented site
#: gates on ``telemetry._MODE`` with one attribute read.
_MODE = _parse_mode(os.environ.get("HEAT_TPU_TELEMETRY", "0"))

#: distinct leaf layouts of one op family before :class:`RetraceWarning`
_RETRACE_WARN_AFTER = int(os.environ.get("HEAT_TPU_TELEMETRY_RETRACE_WARN", "8"))

#: event cap per state (global and per scope); overflow drops the oldest
#: events and counts them
_EVENT_CAP = int(os.environ.get("HEAT_TPU_TELEMETRY_EVENTS", "8192"))

#: programs listed in ``report()["programs"]["top"]``
_TOP_PROGRAMS = int(os.environ.get("HEAT_TPU_TELEMETRY_TOP_PROGRAMS", "5"))

#: one-shot latch of :class:`TimelineDroppedWarning`
_DROP_WARNED = False

_MODE_NAMES = {0: "off", 1: "on", 2: "verbose"}

#: the memory ledger's sampling hook (``core/memledger.py`` installs its
#: ``note`` at import): called at the dispatch, collective and checkpoint
#: record seams, so the high watermark follows the events that change
#: memory. None until the ledger is imported.
_MEM_HOOK = None

#: the flight recorder's hook (``core/health_runtime.py`` installs its ring
#: append at import): called with every typed event of :func:`_note_event`,
#: at mode 1 as well, where the verbose timeline stays empty. None while
#: ``HEAT_TPU_FLIGHT=0``.
_FLIGHT_HOOK = None

#: the blocking-sync hook (``core/health_runtime.py``): called as
#: ``_SYNC_HOOK(kind, cid, dur_s)`` when :func:`end_blocking_sync` closes a
#: token, feeding the host-wait latency histograms.
_SYNC_HOOK = None

#: the numerics lens's sampling hook (``core/numlens.py`` installs it while
#: the lens is on): called by ``fusion.force`` as ``_NUMLENS_HOOK(sig,
#: leaves, roots, values, info)`` after a program's values land, ``values``
#: holding each root's shard tensors. None while the lens is off, so the
#: dispatch seam pays one attribute read.
_NUMLENS_HOOK = None


def active() -> bool:
    """Whether telemetry is recording (``HEAT_TPU_TELEMETRY``)."""
    return _MODE > 0


def verbose() -> bool:
    """Whether the trace timeline is kept (``HEAT_TPU_TELEMETRY=verbose``)."""
    return _MODE >= 2


def set_mode(mode) -> int:
    """Set the mode in-process (0/off, 1/on, 2/'verbose', the knob's
    spellings); returns the previous mode."""
    global _MODE
    prev, _MODE = _MODE, _parse_mode(mode)
    return prev


@contextmanager
def enabled(mode=1):
    """Run the block with telemetry in ``mode``, then restore the old one."""
    prev = set_mode(mode)
    try:
        yield
    finally:
        set_mode(prev)


# ----------------------------------------------------------------------
# counter state: one _State per telemetry session
# ----------------------------------------------------------------------
class _State:
    """One isolated set of counters and an event deque.

    The module keeps one global state plus a thread-local stack of scope
    states. A record writes into the global state and every scope on the
    calling thread's stack (scopes roll up live); a query reads the calling
    thread's innermost scope (sessions are isolated)."""

    __slots__ = (
        "path", "t0", "wall_s", "calls", "collectives", "forces", "retraces",
        "compiles", "dispatches", "degraded", "unfused", "nonfinite",
        "io_retries", "checkpoint", "fused_collectives", "async_", "blocking", "sync_wait",
        "faults", "spans", "events", "events_dropped",
    )

    def __init__(self, path: str = ""):
        self.path = path
        self.calls = 1
        self.wall_s = 0.0
        self.clear()

    def clear(self) -> None:
        self.t0 = time.perf_counter()
        self.collectives: Dict[str, Dict[str, Any]] = {}
        self.forces: Dict[str, Dict[str, Any]] = {}
        self.retraces: Dict[tuple, Dict[str, Any]] = {}
        self.compiles: Dict[str, int] = {}
        self.dispatches: Dict[str, Dict[str, int]] = {}
        self.degraded: Dict[str, Dict[str, Any]] = {}
        self.unfused: Dict[str, Dict[str, int]] = {}
        self.nonfinite: Dict[str, int] = {}
        self.io_retries: Dict[str, int] = {}
        self.checkpoint: Dict[str, int] = {}
        self.fused_collectives: Dict[str, int] = {}
        self.async_ = {"dispatches": 0, "roots": 0, "multi_root_batches": 0}
        self.blocking: Dict[str, int] = {}
        self.sync_wait: Dict[str, Dict[str, float]] = {}
        self.faults: Dict[str, int] = {}
        self.spans: Dict[str, Dict[str, Any]] = {}
        self.events: deque = deque(maxlen=_EVENT_CAP)
        self.events_dropped = 0

    def append_event(self, ev: dict) -> None:
        if self.events.maxlen is not None and len(self.events) == self.events.maxlen:
            self.events_dropped += 1
            global _DROP_WARNED
            if not _DROP_WARNED:
                _DROP_WARNED = True
                warnings.warn(
                    f"trace timeline hit its event cap ({self.events.maxlen}): the "
                    "oldest events are being dropped and the recorded window is "
                    "truncated; raise HEAT_TPU_TELEMETRY_EVENTS to keep it whole",
                    TimelineDroppedWarning,
                    stacklevel=3,
                )
        self.events.append(ev)


def _add_int(dst: Dict[str, int], src: Dict[str, int]) -> None:
    for k, v in src.items():
        dst[k] = dst.get(k, 0) + v


def _merge_state(dst: _State, src: _State) -> None:
    """Accumulate ``src`` into ``dst`` (the completed-scope rollup)."""
    for op, rec in src.collectives.items():
        d = dst.collectives.setdefault(op, {"count": 0, "bytes": 0, "axes": {}, "dtypes": {}})
        d["count"] += rec["count"]
        d["bytes"] += rec["bytes"]
        _add_int(d["axes"], rec["axes"])
        _add_int(d["dtypes"], rec["dtypes"])
    for trig, rec in src.forces.items():
        d = dst.forces.setdefault(trig, {"count": 0, "depth_total": 0, "max_depth": 0, "compiles": 0})
        d["count"] += rec["count"]
        d["depth_total"] += rec["depth_total"]
        d["max_depth"] = max(d["max_depth"], rec["max_depth"])
        d["compiles"] += rec["compiles"]
    for fam, rec in src.retraces.items():
        d = dst.retraces.setdefault(fam, {"misses": 0, "keys": set(), "warned": False})
        d["misses"] += rec["misses"]
        if not d["warned"]:
            # the key set exists to cross the warn threshold: an archived
            # scope never holds more
            for key in rec["keys"]:
                if len(d["keys"]) >= _RETRACE_WARN_AFTER:
                    d["warned"] = True
                    break
                d["keys"].add(key)
        d["warned"] = d["warned"] or rec["warned"]
    _add_int(dst.compiles, src.compiles)
    for eng, rec in src.dispatches.items():
        _add_int(dst.dispatches.setdefault(eng, {}), rec)
    for key, rec in src.degraded.items():
        d = dst.degraded.setdefault(key, {"count": 0, "stages": {}, "last_error": ""})
        d["count"] += rec["count"]
        _add_int(d["stages"], rec["stages"])
        d["last_error"] = rec["last_error"] or d["last_error"]
    for eng, rec in src.unfused.items():
        _add_int(dst.unfused.setdefault(eng, {}), rec)
    _add_int(dst.nonfinite, src.nonfinite)
    _add_int(dst.io_retries, src.io_retries)
    _add_int(dst.checkpoint, src.checkpoint)
    _add_int(dst.fused_collectives, src.fused_collectives)
    _add_int(dst.async_, src.async_)
    _add_int(dst.blocking, src.blocking)
    for kind, rec in src.sync_wait.items():
        d = dst.sync_wait.setdefault(kind, {"count": 0, "total_s": 0.0, "max_s": 0.0})
        d["count"] += rec["count"]
        d["total_s"] += rec["total_s"]
        d["max_s"] = max(d["max_s"], rec["max_s"])
    _add_int(dst.faults, src.faults)
    for path, rec in src.spans.items():
        d = dst.spans.setdefault(
            path, {"calls": 0, "total_s": 0.0, "collectives": {}, "forces": 0, "retraces": 0, "timers": {}}
        )
        d["calls"] += rec["calls"]
        d["total_s"] += rec["total_s"]
        d["forces"] += rec["forces"]
        d["retraces"] += rec["retraces"]
        _add_int(d["collectives"], rec["collectives"])
        for t, s in rec["timers"].items():
            d["timers"][t] = d["timers"].get(t, 0.0) + s
    for ev in src.events:
        dst.append_event(ev)
    dst.events_dropped += src.events_dropped
    dst.wall_s += src.wall_s
    dst.calls += src.calls


_GLOBAL = _State()
#: completed-scope accumulators, keyed by scope path (re-entry accumulates)
_SCOPES: Dict[str, _State] = {}

# the scope, span and trigger stacks are thread-local: each thread resolves
# its own innermost scope, records still roll up into the shared global
# state, and the completed-scope archive is merged under _SCOPE_LOCK
_TLS = threading.local()
#: the common case (no scope on this thread), without a per-record allocation
_GLOBAL_ONLY = (_GLOBAL,)
#: every scope state active on any thread (reset() clears them all)
_ACTIVE_SCOPE_STATES: List[_State] = []
_SCOPE_LOCK = threading.Lock()


def _scope_stack() -> List[_State]:
    stack = getattr(_TLS, "scopes", None)
    if stack is None:
        stack = _TLS.scopes = []
    return stack


def _states():
    """The global state plus the calling thread's scope stack."""
    stack = getattr(_TLS, "scopes", None)
    if not stack:
        return _GLOBAL_ONLY
    return [_GLOBAL] + stack


def _span_stack() -> list:
    stack = getattr(_TLS, "spans", None)
    if stack is None:
        stack = _TLS.spans = []
    return stack


def _trigger_stack() -> List[str]:
    stack = getattr(_TLS, "triggers", None)
    if stack is None:
        stack = _TLS.triggers = []
    return stack


def _cur() -> _State:
    stack = getattr(_TLS, "scopes", None)
    return stack[-1] if stack else _GLOBAL


def reset() -> None:
    """Clear every counter, span, event and completed scope of every active
    state, and with them the session state of the surfaces ``report()``
    joins: the ``utils.profiling`` timer registry, the memory ledger's
    watermark, the health layer's ring, histograms, SLO windows and stall
    log, the numerics lens's statistics, drift ledger, canary, training
    streams and findings, and the serving layer's exited sessions. The mode and the other modules' settings are kept; active
    scopes and spans keep recording."""
    global _DROP_WARNED
    _DROP_WARNED = False
    _GLOBAL.clear()
    with _SCOPE_LOCK:
        for st in list(_ACTIVE_SCOPE_STATES):
            st.clear()
        _SCOPES.clear()
    from ..utils import profiling
    from . import health_runtime, memledger

    profiling.reset()
    memledger.reset()
    health_runtime.reset()
    from . import numlens, serving

    numlens.reset()
    serving.reset()


# ----------------------------------------------------------------------
# the trace timeline
# ----------------------------------------------------------------------
def _emit(kind: str, **fields) -> dict:
    """Append one typed event to every active state's timeline (callers gate
    on ``_MODE >= 2``): a monotonic ``ts`` in perf_counter seconds and the
    innermost scope path when a scope is active."""
    ev: Dict[str, Any] = {"kind": kind, "ts": time.perf_counter()}
    ev.update(fields)
    stack = getattr(_TLS, "scopes", None)
    if stack:
        ev["scope"] = stack[-1].path
    for st in _states():
        st.append_event(ev)
    return ev


def _note_event(kind: str, **fields) -> Optional[dict]:
    """Record one event on the verbose timeline and, at any mode on, on the
    flight ring once ``core/health_runtime.py`` has installed
    ``_FLIGHT_HOOK``. Returns the (shared) event, or None when nothing
    recorded it."""
    if _MODE >= 2:
        ev = _emit(kind, **fields)
        if _FLIGHT_HOOK is not None:
            _FLIGHT_HOOK(ev)
        return ev
    if _MODE and _FLIGHT_HOOK is not None:
        ev = {"kind": kind, "ts": time.perf_counter()}
        ev.update(fields)
        stack = getattr(_TLS, "scopes", None)
        if stack:
            ev["scope"] = stack[-1].path
        _FLIGHT_HOOK(ev)
        return ev
    return None


def record_event(kind: str, **fields) -> Optional[dict]:
    """Emit one typed timeline event without counters: the seam for
    lifecycle phases worth a timestamp (checkpoint phases, I/O milestones).
    Returns the event, or None when nothing recorded it."""
    if not _MODE:
        return None
    return _note_event(kind, **fields)


def events() -> List[dict]:
    """The timeline of the innermost active state (empty unless verbose)."""
    return list(_cur().events)


# ----------------------------------------------------------------------
# scoped sessions
# ----------------------------------------------------------------------
@contextmanager
def scope(name: str):
    """An isolated telemetry session named ``name``: what is recorded inside
    is the scope's own view through the query functions, and also rolls up
    into the enclosing scopes and the global state. Scopes nest (paths join
    as ``outer/inner``), the stack is per thread, and on exit the session is
    archived under ``report()["scopes"][path]`` (re-entry accumulates,
    ``calls`` counts entries). The health layer's latency histograms are
    scoped alongside. Yields the path, or None when off."""
    if not _MODE:
        yield None
        return
    from . import health_runtime

    stack = _scope_stack()
    path = (stack[-1].path + "/" + str(name)) if stack else str(name)
    st = _State(path)
    stack.append(st)
    with _SCOPE_LOCK:
        _ACTIVE_SCOPE_STATES.append(st)
    health_runtime._push_scope(path)
    try:
        yield path
    finally:
        st.wall_s = time.perf_counter() - st.t0
        # remove by identity: reset() or nesting must never pop another frame
        for i in range(len(stack) - 1, -1, -1):
            if stack[i] is st:
                del stack[i]
                break
        with _SCOPE_LOCK:
            for i in range(len(_ACTIVE_SCOPE_STATES) - 1, -1, -1):
                if _ACTIVE_SCOPE_STATES[i] is st:
                    del _ACTIVE_SCOPE_STATES[i]
                    break
            acc = _SCOPES.get(path)
            if acc is None:
                acc = _SCOPES[path] = _State(path)
                acc.calls = 0
                acc.wall_s = 0.0
            _merge_state(acc, st)
        health_runtime._pop_scope(path)


def _counter_blocks(st: _State) -> Dict[str, Any]:
    """The counter blocks that a report and an archived scope share."""
    return {
        "collectives": _render_collectives(st),
        "collective_counts": {op: rec["count"] for op, rec in st.collectives.items()},
        "fused_collectives": dict(st.fused_collectives),
        "async_forcing": _render_async(st),
        "forcing_points": _render_forces(st),
        "dispatches": {k: dict(v) for k, v in st.dispatches.items()},
        "unfused_reasons": {k: dict(v) for k, v in st.unfused.items()},
        "retraces": _render_retraces(st),
        "degraded": _render_degraded(st),
        "nonfinite": dict(st.nonfinite),
        "io_retries": dict(st.io_retries),
        "checkpoint": dict(st.checkpoint),
        "faults": dict(st.faults),
        "jit_compiles": dict(st.compiles),
        "spans": _render_spans(st),
        "timeline": {
            "events": len(st.events),
            "events_dropped": st.events_dropped,
            "cap": _EVENT_CAP,
        },
    }


def scope_reports() -> Dict[str, Dict[str, Any]]:
    """Every completed scope's archived counters, keyed by scope path."""
    return {
        path: dict({"calls": acc.calls, "wall_s": acc.wall_s}, **_counter_blocks(acc))
        for path, acc in _SCOPES.items()
    }


# ----------------------------------------------------------------------
# collectives
# ----------------------------------------------------------------------
def _leaves(x) -> list:
    """The tensors of a tensor, or of a (nested) tuple, list or dict of
    them."""
    if isinstance(x, (tuple, list)):
        return [leaf for v in x for leaf in _leaves(v)]
    if isinstance(x, dict):
        return [leaf for v in x.values() for leaf in _leaves(v)]
    return [x]


def _dtype_name(dtype) -> str:
    """A dtype by its numpy name (``float32``, ``bfloat16``, ``bool``)."""
    return str(dtype).replace("torch.", "")


def _leaf_bytes(leaf) -> int:
    shape = getattr(leaf, "shape", None)
    dtype = getattr(leaf, "dtype", None)
    if shape is None or dtype is None:
        return 0
    n = 1
    for s in shape:
        n *= int(s)
    size = getattr(leaf, "element_size", None)
    itemsize = size() if callable(size) else getattr(dtype, "itemsize", 0)
    return n * int(itemsize)


def operand_bytes(x) -> int:
    """Logical payload bytes of a tensor or a tree of tensors, from shapes
    and dtypes only; shapeless leaves (Python scalars, None) count zero."""
    return sum(_leaf_bytes(leaf) for leaf in _leaves(x))


def record_collective_operand(op: str, axis: Optional[str], x, count: int = 1) -> None:
    """Record a collective whose payload is ``x`` (one participant's
    operand): one walk derives its bytes and its dtype, the first leaf's.
    No-op when off."""
    if not _MODE:
        return
    total = 0
    dtype = None
    for leaf in _leaves(x):
        if getattr(leaf, "shape", None) is None or getattr(leaf, "dtype", None) is None:
            continue
        total += _leaf_bytes(leaf)
        if dtype is None:
            dtype = _dtype_name(leaf.dtype)
    record_collective(op, axis, total, dtype, count)


def record_collective(
    op: str,
    axis: Optional[str] = None,
    nbytes: int = 0,
    dtype: Optional[str] = None,
    count: int = 1,
) -> None:
    """Record ``count`` collectives of type ``op`` moving ``nbytes`` each
    over mesh axis ``axis``: the communication verbs and the declared
    linear-algebra schedules call this. No-op when off."""
    if not _MODE:
        return
    for st in _states():
        rec = st.collectives.get(op)
        if rec is None:
            rec = st.collectives[op] = {"count": 0, "bytes": 0, "axes": {}, "dtypes": {}}
        rec["count"] += count
        rec["bytes"] += int(nbytes) * count
        if axis is not None:
            rec["axes"][axis] = rec["axes"].get(axis, 0) + count
        if dtype is not None:
            rec["dtypes"][dtype] = rec["dtypes"].get(dtype, 0) + count
    if _MODE >= 2 or _FLIGHT_HOOK is not None:
        _note_event("collective", op=op, axis=axis, bytes=int(nbytes), dtype=dtype, count=count)
    for frame in _span_stack():
        frame.collectives[op] = frame.collectives.get(op, 0) + count
    if _MEM_HOOK is not None:
        _MEM_HOOK("collective")


def _render_collectives(st: _State) -> Dict[str, Dict[str, Any]]:
    return {
        op: {
            "count": rec["count"],
            "bytes": rec["bytes"],
            "axes": dict(rec["axes"]),
            "dtypes": dict(rec["dtypes"]),
        }
        for op, rec in st.collectives.items()
    }


def collective_counts() -> Dict[str, int]:
    """Per-type collective counts, ``{"allreduce": 3, ...}``: the scope's
    own view inside a :func:`scope`."""
    return {op: rec["count"] for op, rec in _cur().collectives.items()}


def collectives() -> Dict[str, Dict[str, Any]]:
    """Per-type count, bytes and per-axis and per-dtype breakdowns."""
    return _render_collectives(_cur())


# ----------------------------------------------------------------------
# blocking host reads
# ----------------------------------------------------------------------
def record_blocking_sync(kind: str, cid: Optional[int] = None) -> Optional[dict]:
    """Count one host boundary (``item``, ``numpy``, ``print``) that waits
    for the device to hand the host a value. Returns a token to close with
    :func:`end_blocking_sync` once the host holds the value, so the wait's
    wall time is recorded; None when off."""
    if not _MODE:
        return None
    for st in _states():
        st.blocking[kind] = st.blocking.get(kind, 0) + 1
    ev = _note_event("blocking_sync", where=kind, cid=cid)
    if ev is not None:
        return ev
    return {"kind": "blocking_sync", "ts": time.perf_counter(), "where": kind, "cid": cid}


def end_blocking_sync(token: Optional[dict]) -> None:
    """Close a token of :func:`record_blocking_sync`: stamp the wait's wall
    ``dur``, fold it into every active state's ``sync_wait`` aggregate
    (count, total and max per kind, kept at mode 1 too) and hand it to the
    health layer's latency histograms through ``_SYNC_HOOK``."""
    if token is None:
        return
    dur = time.perf_counter() - token["ts"]
    token["dur"] = dur
    kind = str(token.get("where"))
    for st in _states():
        rec = st.sync_wait.get(kind)
        if rec is None:
            rec = st.sync_wait[kind] = {"count": 0, "total_s": 0.0, "max_s": 0.0}
        rec["count"] += 1
        rec["total_s"] += dur
        if dur > rec["max_s"]:
            rec["max_s"] = dur
    if _SYNC_HOOK is not None:
        _SYNC_HOOK(kind, token.get("cid"), dur)


def record_async_dispatch(n_roots: int, cid: Optional[int] = None, cids=(), program: Optional[str] = None, sessions=None) -> None:
    """Count one fused-program dispatch of ``n_roots`` roots (more than one
    when the force batched other live roots into the program, a
    ``multi_root_batches`` entry). It installs the result tensors without
    waiting. ``cid`` is the chain's correlation id, ``cids`` every
    root's, ``program`` the program key (None for a degraded replay): the
    timeline's ``dispatch`` event joins the chain's record and its
    blocking sync. ``sessions`` (aligned with ``cids``) names each root's
    serving session, when the serving layer is in use."""
    if not _MODE:
        return
    for st in _states():
        st.async_["dispatches"] += 1
        st.async_["roots"] += int(n_roots)
        if n_roots > 1:
            st.async_["multi_root_batches"] += 1
    fields = {"sessions": list(sessions)} if sessions is not None else {}
    _note_event("dispatch", roots=int(n_roots), cid=cid, cids=list(cids), program=program, **fields)
    if _MEM_HOOK is not None:
        _MEM_HOOK("dispatch")


def _render_async(st: _State) -> Dict[str, Any]:
    return {
        "dispatches": st.async_["dispatches"],
        "roots_dispatched": st.async_["roots"],
        "multi_root_batches": st.async_["multi_root_batches"],
        "blocking_syncs": dict(st.blocking),
        "blocking_total": sum(st.blocking.values()),
        "sync_wait": {
            kind: {
                "count": rec["count"],
                "total_s": round(rec["total_s"], 6),
                "max_s": round(rec["max_s"], 6),
            }
            for kind, rec in st.sync_wait.items()
        },
    }


def async_forcing() -> Dict[str, Any]:
    """Fused-program dispatches (with the roots they carried) against the
    blocking host syncs by kind, with their wait times."""
    return _render_async(_cur())


# ----------------------------------------------------------------------
# forcing-point attribution
# ----------------------------------------------------------------------
class _TriggerScope:
    """Reentrant scope naming the forcing point of a force inside it; the
    outermost scope wins."""

    __slots__ = ("name",)

    def __init__(self, name: str):
        self.name = name

    def __enter__(self) -> "_TriggerScope":
        _trigger_stack().append(self.name)
        return self

    def __exit__(self, *exc) -> None:
        _trigger_stack().pop()


_TRIGGER_SCOPES: Dict[str, _TriggerScope] = {}


def force_trigger(name: str) -> _TriggerScope:
    """The (cached, reusable) attribution scope of forcing trigger ``name``."""
    scope_ = _TRIGGER_SCOPES.get(name)
    if scope_ is None:
        scope_ = _TRIGGER_SCOPES[name] = _TriggerScope(name)
    return scope_


def current_trigger() -> str:
    """The attribution of a force right now: the outermost trigger scope,
    else ``"parray"``."""
    stack = getattr(_TLS, "triggers", None)
    return stack[0] if stack else "parray"


# ----------------------------------------------------------------------
# compiles
# ----------------------------------------------------------------------
def record_compile(label: str, cid: Optional[int] = None) -> None:
    """Count one program build, keyed by ``label``."""
    if not _MODE:
        return
    for st in _states():
        st.compiles[label] = st.compiles.get(label, 0) + 1
    _note_event("compile", label=label, cid=cid)


# ----------------------------------------------------------------------
# engine dispatches
# ----------------------------------------------------------------------
def record_dispatch(engine: str, fused: bool) -> None:
    """Count one engine dispatch (``binary``/``local``/``reduce``/``cum``),
    deferred into a fused program (``fused``) or eager."""
    if not _MODE:
        return
    key = "fused" if fused else "eager"
    for st in _states():
        rec = st.dispatches.get(engine)
        if rec is None:
            rec = st.dispatches[engine] = {"fused": 0, "eager": 0}
        rec[key] += 1
    if _MEM_HOOK is not None:
        _MEM_HOOK("dispatch")


def dispatches() -> Dict[str, Dict[str, int]]:
    """Per-engine fused and eager dispatch counts."""
    return {k: dict(v) for k, v in _cur().dispatches.items()}


# ----------------------------------------------------------------------
# the fusion recorder: forces, retraces, unfused ops, degradations
# ----------------------------------------------------------------------
def record_force(trigger: str, depth: int, compiled: bool = False, cid: Optional[int] = None) -> None:
    """Count one forced chain: ``trigger`` names the forcing point,
    ``depth`` the chain's depth, ``compiled`` whether the force built its
    program, ``cid`` the chain's correlation id."""
    if not _MODE:
        return
    for st in _states():
        rec = st.forces.get(trigger)
        if rec is None:
            rec = st.forces[trigger] = {"count": 0, "depth_total": 0, "max_depth": 0, "compiles": 0}
        rec["count"] += 1
        rec["depth_total"] += int(depth)
        if depth > rec["max_depth"]:
            rec["max_depth"] = int(depth)
        if compiled:
            rec["compiles"] += 1
    _note_event("force", trigger=trigger, depth=int(depth), compiled=compiled, cid=cid)
    for frame in _span_stack():
        frame.forces += 1
    if _MEM_HOOK is not None:
        _MEM_HOOK("force")


def _render_forces(st: _State) -> Dict[str, Dict[str, Any]]:
    return {
        trigger: {
            "count": rec["count"],
            "mean_depth": round(rec["depth_total"] / rec["count"], 2) if rec["count"] else 0.0,
            "max_depth": rec["max_depth"],
            "compiles": rec["compiles"],
        }
        for trigger, rec in st.forces.items()
    }


def forcing_points() -> Dict[str, Dict[str, Any]]:
    """Forces per forcing point: count, mean and max chain depth, and the
    forces that built their program."""
    return _render_forces(_cur())


def record_retrace(family: tuple, shape_key) -> None:
    """Count one program-cache miss of op ``family`` under leaf layout
    ``shape_key``. At ``HEAT_TPU_TELEMETRY_RETRACE_WARN`` distinct layouts of
    one family a :class:`RetraceWarning` fires, once per family (the global
    ledger decides, so a scope never warns again)."""
    if not _MODE:
        return
    grec0 = _GLOBAL.retraces.get(family)
    already_warned = grec0 is not None and grec0["warned"]
    for st in _states():
        rec = st.retraces.get(family)
        if rec is None:
            rec = st.retraces[family] = {"misses": 0, "keys": set(), "warned": already_warned}
        rec["misses"] += 1
        if not rec["warned"] and not already_warned:
            rec["keys"].add(shape_key)
    for frame in _span_stack():
        frame.retraces += 1
    grec = _GLOBAL.retraces.get(family)
    if grec is None:
        return
    if not grec["warned"] and len(grec["keys"]) >= _RETRACE_WARN_AFTER:
        for st in _states():
            rec = st.retraces.get(family)
            if rec is not None:
                rec["warned"] = True
        warnings.warn(
            RetraceWarning(
                f"op family {'/'.join(family) or '<leaf>'} recompiled under {len(grec['keys'])} "
                f"distinct input shapes ({grec['misses']} cache misses): shape churn is defeating "
                "the fusion program cache; pad or bucket the varying dimension, or force the "
                "chain before the shape-dependent step"
            ),
            stacklevel=3,
        )


def _render_retraces(st: _State) -> Dict[str, Dict[str, Any]]:
    return {
        "/".join(family) or "<leaf>": {
            "misses": rec["misses"],
            "distinct_shapes": len(rec["keys"]),
            "warned": rec["warned"],
        }
        for family, rec in st.retraces.items()
    }


def retraces() -> Dict[str, Dict[str, Any]]:
    """Program-cache misses per op family."""
    return _render_retraces(_cur())


def record_fused_collective(kind: str, cid: Optional[int] = None, detail: Optional[str] = None) -> None:
    """Count one collective node recorded into a fused program: a
    split-crossing reduction's combine (``reduce.psum``), a deferred
    ``reshard``, a per-shard schedule (``apply:<kernel>``), a ``matmul``.
    These run inside the program and call no verb, so
    :func:`collective_counts` does not see them; ``detail`` (a reshard's
    target split, a matmul's split pair) rides the timeline event only."""
    if not _MODE:
        return
    for st in _states():
        st.fused_collectives[kind] = st.fused_collectives.get(kind, 0) + 1
    _note_event("fused_collective", op=kind, cid=cid, detail=detail)


def fused_collectives() -> Dict[str, int]:
    """Per-kind counts of the collective nodes recorded into fused programs."""
    return dict(_cur().fused_collectives)


def record_unfused(engine: str, reason: str) -> None:
    """Count an op that ``engine`` ran eagerly instead of deferring, by
    ``reason`` (``out=``, ``where=``, ``fusion_off``, ``padded_broadcast``,
    ``record_failed:<Type>``, ...)."""
    if not _MODE:
        return
    for st in _states():
        rec = st.unfused.get(engine)
        if rec is None:
            rec = st.unfused[engine] = {}
        rec[reason] = rec.get(reason, 0) + 1


def unfused_reasons() -> Dict[str, Dict[str, int]]:
    """Per engine, why ops ran eagerly instead of deferring."""
    return {k: dict(v) for k, v in _cur().unfused.items()}


def record_degraded(family: tuple, stage: str, error: str = "") -> None:
    """Count one degraded program: the program of op ``family`` failed at
    ``stage`` (``compile``/``execute``) and its chain was replayed op by
    op."""
    if not _MODE:
        return
    key = "/".join(family) or "<leaf>"
    for st in _states():
        rec = st.degraded.get(key)
        if rec is None:
            rec = st.degraded[key] = {"count": 0, "stages": {}, "last_error": ""}
        rec["count"] += 1
        rec["stages"][stage] = rec["stages"].get(stage, 0) + 1
        if error:
            rec["last_error"] = error
    _note_event("degraded", family=key, stage=stage, error=error)


def degraded_counts() -> Dict[str, int]:
    """Degradations per op family."""
    return {key: rec["count"] for key, rec in _cur().degraded.items()}


def _render_degraded(st: _State) -> Dict[str, Dict[str, Any]]:
    return {
        key: {"count": rec["count"], "stages": dict(rec["stages"]), "last_error": rec["last_error"]}
        for key, rec in st.degraded.items()
    }


def degraded() -> Dict[str, Dict[str, Any]]:
    """Degradations per op family: count, per stage, last error."""
    return _render_degraded(_cur())


# ----------------------------------------------------------------------
# resilience accounting (core/resilience.py)
# ----------------------------------------------------------------------
def record_fault(site: str, pattern: str = "") -> None:
    """Count one injected fault firing at ``site``."""
    if not _MODE:
        return
    for st in _states():
        st.faults[site] = st.faults.get(site, 0) + 1
    _note_event("fault", site=site, pattern=pattern)


def fault_events() -> Dict[str, int]:
    """Per-site injected-fault counts as telemetry saw them."""
    return dict(_cur().faults)


def record_nonfinite(where: str) -> None:
    """Count one ``errstate`` non-finite detection at ``where``."""
    if not _MODE:
        return
    for st in _states():
        st.nonfinite[where] = st.nonfinite.get(where, 0) + 1
    _note_event("nonfinite", where=where)


def nonfinite_counts() -> Dict[str, int]:
    """Per-site ``errstate`` non-finite detections."""
    return dict(_cur().nonfinite)


def record_io_retry(site: str) -> None:
    """Count one transient ``OSError`` retried at I/O site ``site``."""
    if not _MODE:
        return
    for st in _states():
        st.io_retries[site] = st.io_retries.get(site, 0) + 1
    _note_event("io_retry", site=site)


def io_retries() -> Dict[str, int]:
    """Per-site transient I/O retry counts."""
    return dict(_cur().io_retries)


def record_checkpoint(event: str, step: Optional[int] = None, detail: str = "") -> None:
    """Count one checkpoint lifecycle event: ``save`` (manifest committed),
    ``restore``, ``corrupt`` (failed verification), ``fallback`` (restore
    skipped newer unverifiable steps), ``gc`` (the sweep removed
    something)."""
    if not _MODE:
        return
    for st in _states():
        st.checkpoint[event] = st.checkpoint.get(event, 0) + 1
    _note_event("checkpoint", event=event, step=step, detail=detail)
    if _MEM_HOOK is not None:
        _MEM_HOOK("checkpoint")


def checkpoint_events() -> Dict[str, int]:
    """Per-event checkpoint lifecycle counts."""
    return dict(_cur().checkpoint)


# ----------------------------------------------------------------------
# spans
# ----------------------------------------------------------------------
class _SpanFrame:
    __slots__ = ("path", "t0", "collectives", "forces", "retraces", "timers")

    def __init__(self, path: str):
        self.path = path
        self.t0 = time.perf_counter()
        self.collectives: Dict[str, int] = {}
        self.forces = 0
        self.retraces = 0
        self.timers: Dict[str, float] = {}


@contextmanager
def span(name: str):
    """Scope the counters to a named region. Spans nest (``"fit"`` holding
    ``"fit/iter"``), take the collectives recorded inside them and the
    ``utils.profiling.Timer`` records closing inside them, and mirror their
    own host wall time into the Timer registry as ``span:<path>``. In verbose mode each span emits ``span_begin`` and
    ``span_end`` events. A span does not synchronize the device. Yields
    the span's path, or None when off."""
    if not _MODE:
        yield None
        return
    spans_ = _span_stack()
    path = (spans_[-1].path + "/" + name) if spans_ else name
    frame = _SpanFrame(path)
    spans_.append(frame)
    if _MODE >= 2:
        _emit("span_begin", name=path)
    try:
        yield path
    finally:
        spans_.pop()
        elapsed = time.perf_counter() - frame.t0
        if _MODE >= 2:
            _emit("span_end", name=path, dur=elapsed)
        for st in _states():
            rec = st.spans.get(path)
            if rec is None:
                rec = st.spans[path] = {
                    "calls": 0, "total_s": 0.0, "collectives": {}, "forces": 0, "retraces": 0, "timers": {},
                }
            rec["calls"] += 1
            rec["total_s"] += elapsed
            rec["forces"] += frame.forces
            rec["retraces"] += frame.retraces
            for op, cnt in frame.collectives.items():
                rec["collectives"][op] = rec["collectives"].get(op, 0) + cnt
            for tname, secs in frame.timers.items():
                rec["timers"][tname] = rec["timers"].get(tname, 0.0) + secs
        from ..utils import profiling

        profiling.record_timing("span:" + path, elapsed)


def on_timer(name: str, elapsed: float) -> None:
    """Called by ``utils.profiling`` on every timer record: a timer closing
    inside spans is attributed to every enclosing span (``span:`` mirrors
    excluded), and in verbose mode it lands on the timeline as a ``timer``
    event."""
    if name.startswith("span:"):
        return
    if _MODE >= 2:
        _emit("timer", name=name, dur=elapsed)
    for frame in _span_stack():
        frame.timers[name] = frame.timers.get(name, 0.0) + elapsed


def _render_spans(st: _State) -> Dict[str, Dict[str, Any]]:
    return {
        path: {
            "calls": rec["calls"],
            "total_s": rec["total_s"],
            "collectives": dict(rec["collectives"]),
            "forces": rec["forces"],
            "retraces": rec["retraces"],
            "timers": dict(rec["timers"]),
        }
        for path, rec in st.spans.items()
    }


def spans() -> Dict[str, Dict[str, Any]]:
    """Per-span calls, host wall seconds, collectives, forces, retraces
    and nested timer seconds."""
    return _render_spans(_cur())


# ----------------------------------------------------------------------
# report
# ----------------------------------------------------------------------
def _memory_block() -> Dict[str, Any]:
    """The memory picture: per-device allocator bytes, this process's host
    memory, the owner-attributed ledger (``core/memledger.py``) with its
    high watermark, and the live buffers of the default mesh once that mesh
    exists (``utils.health.memory_report``). It never initializes CUDA: the
    device stats are read only once CUDA is initialized, so ``report()``
    (and the metrics sink's thread) can never be the first code to touch
    the card. Nor does it walk the heap: on the CPU its ledger holds the
    tagged storages, and ``memledger.ledger()`` adds the foreign tensors."""
    import torch

    from ..utils import health, profiling
    from . import communication, memledger

    out: Dict[str, Any] = {"device": {}, "host": profiling.host_memory_stats(), "live_buffers": {}}
    if torch.cuda.is_initialized():
        out["device"] = profiling.device_memory_stats()
    out["ledger"] = memledger._scan(top=5)
    out["watermark"] = memledger.watermark()
    out["budget"] = memledger.budget_info()
    oom = memledger.last_oom()
    if oom is not None:
        out["last_oom"] = oom
    comm = communication._built_comm()
    if comm is not None:
        out["live_buffers"] = health.memory_report(comm)
    return out


def _programs_block(top: Optional[int] = None) -> Dict[str, Any]:
    """The top cached programs by dispatches (metadata; the cost
    estimates that :func:`program_costs` computed are merged in, the report
    computes none) and ``cost_errors``, the programs whose estimate
    failed."""
    from . import fusion

    progs = fusion.programs()
    ranked = sorted(progs.items(), key=lambda kv: kv[1].get("dispatches", 0), reverse=True)
    n = _TOP_PROGRAMS if top is None else top
    return {"cached": len(progs), "cost_errors": fusion.cost_error_count(), "top": [dict(rec, key=key) for key, rec in ranked[:n]]}


def program_costs(top: Optional[int] = None, refresh: bool = False) -> Dict[str, Dict[str, Any]]:
    """Cost estimates of the cached programs by program key
    (``fusion.program_costs``): operand and result bytes, flops and the
    static peak, from each program's node shapes. Memoized; never touches
    data or forces a chain."""
    from . import fusion

    return fusion.program_costs(top=top, refresh=refresh)


def report(*, _state: Optional[_State] = None) -> Dict[str, Any]:
    """The whole telemetry picture as one dict (JSON-ready through
    :func:`report_json`): the counter blocks (the scope's own view inside a
    :func:`scope`), the archived scopes, the memory block, the fusion
    recorder's program cache and top programs, the ``utils.profiling``
    timers, the numerics lens's block and, once sessions exist, the serving
    layer's. ``_state`` lets the metrics sink read the
    global state whatever scope another thread is in."""
    st = _state if _state is not None else _cur()
    doc: Dict[str, Any] = {"enabled": active(), "mode": _MODE_NAMES[_MODE]}
    doc.update(_counter_blocks(st))
    doc["scopes"] = scope_reports()
    doc["memory"] = _memory_block()
    from . import fusion, health_runtime

    doc["health"] = health_runtime.health_block(global_view=_state is not None)
    doc["fusion_cache"] = fusion.cache_stats()
    doc["programs"] = _programs_block()
    from ..utils import profiling

    doc["timers"] = profiling.report()
    from . import numlens, serving

    doc["numerics"] = numlens.numerics_block()
    if serving._SESSIONS:
        doc["serving"] = serving.sessions_block()
    if _MODE >= 2:
        doc["events"] = list(st.events)
    return doc


def _jsonable(obj):
    """Deterministic JSON projection: tuple keys join with "/", sets sort,
    tuples become lists, scalars with ``item()`` unbox."""
    if isinstance(obj, dict):
        out = {}
        for k, v in obj.items():
            if isinstance(k, tuple):
                k = "/".join(str(p) for p in k)
            elif not isinstance(k, str):
                k = str(k)
            out[k] = _jsonable(v)
        return out
    if isinstance(obj, (list, tuple, deque)):
        return [_jsonable(v) for v in obj]
    if isinstance(obj, (set, frozenset)):
        return sorted(str(v) for v in obj)
    if isinstance(obj, (str, int, float, bool)) or obj is None:
        return obj
    item = getattr(obj, "item", None)
    if callable(item):
        try:
            return item()
        except Exception:  # noqa: BLE001 - a multi-element array renders as text
            pass
    return str(obj)


def report_json(path: Optional[str] = None, indent: int = 2) -> str:
    """:func:`report` as deterministic JSON; written to ``path`` when given."""
    text = json.dumps(_jsonable(report()), indent=indent, default=str)
    if path is not None:
        with open(path, "w") as fh:
            fh.write(text)
            fh.write("\n")
    return text


# ----------------------------------------------------------------------
# Chrome/Perfetto trace export
# ----------------------------------------------------------------------
def _host_index() -> int:
    """This process's row in a trace: 0, since one process drives every
    device."""
    return 0


def _us(ts: float) -> float:
    return round(ts * 1e6, 3)


#: instant-event rendering: kind -> (category, name builder)
_INSTANT_KINDS = {
    "collective": ("collective", lambda ev: ev.get("op", "collective")),
    "fused_collective": ("collective", lambda ev: "fused:" + str(ev.get("op"))),
    "record": ("record", lambda ev: "record:" + str(ev.get("op"))),
    "compile": ("compile", lambda ev: "compile:" + str(ev.get("label") or ev.get("family") or ev.get("program"))),
    "force": ("force", lambda ev: "force:" + str(ev.get("trigger"))),
    "degraded": ("degrade", lambda ev: "degraded:" + str(ev.get("family"))),
    "fault": ("fault", lambda ev: "fault:" + str(ev.get("site"))),
    "io_retry": ("io", lambda ev: "io_retry:" + str(ev.get("site"))),
    "io": ("io", lambda ev: "io:" + str(ev.get("op", "op"))),
    "checkpoint": ("checkpoint", lambda ev: "checkpoint:" + str(ev.get("event"))),
    "checkpoint_phase": ("checkpoint", lambda ev: "ckpt:" + str(ev.get("phase"))),
    "nonfinite": ("errstate", lambda ev: "nonfinite:" + str(ev.get("where"))),
    "memory_gate": ("memory", lambda ev: "gate:" + str(ev.get("policy"))),
    "memory_oom": ("memory", lambda ev: "oom:" + str(ev.get("program"))),
    "stall": ("health", lambda ev: "stall:" + str(ev.get("site"))),
    "slo_breach": ("health", lambda ev: "slo:" + str(ev.get("metric"))),
    "flight_dump": ("health", lambda ev: "flight_dump:" + str(ev.get("reason"))),
    # the lens's drift, sdc and train instants (its stats also render as
    # counter tracks, see trace_events)
    "numeric": ("numeric", lambda ev: "numeric:" + str(ev.get("event"))),
}


def async_pairs(evs: Optional[List[dict]] = None) -> List[tuple]:
    """The timeline's ``dispatch`` events matched with the
    ``blocking_sync`` events that waited on them by correlation id: a sync
    waits on the dispatch whose roots (``cids``) hold its chain's ``cid``.
    Returns ``[(dispatch_event, sync_event), ...]``."""
    if evs is None:
        evs = list(_cur().events)
    by_cid: Dict[int, dict] = {}
    for ev in evs:
        if ev.get("kind") == "dispatch":
            for cid in ev.get("cids") or ([ev["cid"]] if ev.get("cid") is not None else []):
                by_cid[cid] = ev
    pairs = []
    for ev in evs:
        if ev.get("kind") == "blocking_sync" and ev.get("cid") is not None:
            disp = by_cid.get(ev["cid"])
            if disp is not None:
                pairs.append((disp, ev))
    return pairs


def trace_events(evs: Optional[List[dict]] = None, pid: Optional[int] = None) -> List[dict]:
    """The timeline as Chrome trace-event dicts: spans and timers as B/E
    pairs, blocking syncs with their duration as X events, memory samples
    and the numerics lens's sampled statistics as counter (C) tracks, each
    dispatch and the blocking sync that waited
    on it as an async b/e pair keyed by cid, everything else as
    thread-scoped instants; one process row, tid 0."""
    if evs is None:
        evs = list(_cur().events)
    if pid is None:
        pid = _host_index()
    tid = 0
    out: List[dict] = [
        {"ph": "M", "name": "process_name", "pid": pid, "tid": tid, "args": {"name": f"heat_tpu_torch host {pid}"}},
        {"ph": "M", "name": "thread_name", "pid": pid, "tid": tid, "args": {"name": "python"}},
    ]

    def args_of(ev, *skip):
        return {k: _jsonable(v) for k, v in ev.items() if k not in ("kind", "ts") and k not in skip and v is not None}

    for ev in sorted(evs, key=lambda e: e.get("ts", 0.0)):
        kind = ev.get("kind")
        ts = _us(ev.get("ts", 0.0))
        common = {"pid": pid, "tid": tid, "ts": ts}
        if kind == "span_begin":
            out.append(dict(common, ph="B", cat="span", name=ev.get("name"), args=args_of(ev, "name")))
        elif kind == "span_end":
            out.append(dict(common, ph="E", cat="span", name=ev.get("name")))
        elif kind == "timer":
            name = str(ev.get("name"))
            start = _us(ev["ts"] - float(ev.get("dur", 0.0)))
            out.append({"ph": "B", "cat": "timer", "name": name, "pid": pid, "tid": tid, "ts": start})
            out.append(dict(common, ph="E", cat="timer", name=name))
        elif kind == "blocking_sync":
            name = "sync:" + str(ev.get("where"))
            if "dur" in ev:
                out.append(dict(common, ph="X", cat="sync", name=name, dur=_us(float(ev["dur"])), args=args_of(ev, "dur")))
            else:
                out.append(dict(common, ph="i", s="t", cat="sync", name=name, args=args_of(ev)))
        elif kind == "memory":
            # counter ("C") tracks: Perfetto draws each args key as a stacked
            # series, one track for the owner split of the live bytes and one
            # for the high watermark
            series = {"total": int(ev.get("total", 0))}
            for owner, nbytes in (ev.get("by_owner") or {}).items():
                series[str(owner)] = int(nbytes)
            out.append(dict(common, ph="C", cat="memory", name="live_bytes", args=series))
            out.append(dict(common, ph="C", cat="memory", name="live_bytes_watermark",
                            args={"watermark": int(ev.get("watermark", 0))}))
        elif kind == "dispatch":
            out.append(dict(common, ph="i", s="t", cat="dispatch", name="dispatch", args=args_of(ev)))
        elif kind == "numeric" and ev.get("event") == "stats":
            # the lens's counter tracks beside the ledger's: one per sampled
            # program root (rms and absmax), and its saturation counts
            label = f"numerics:{ev.get('program')}[{ev.get('root')}]"
            out.append(dict(common, ph="C", cat="numeric", name=label,
                            args={"rms": float(ev.get("rms", 0.0)), "absmax": float(ev.get("absmax", 0.0))}))
            out.append(dict(common, ph="C", cat="numeric", name=label + ":saturation", args={
                "nonfinite": int(ev.get("nonfinite", 0)), "edge_low": int(ev.get("edge_low", 0)),
                "edge_high": int(ev.get("edge_high", 0)),
            }))
        else:
            cat, name_of = _INSTANT_KINDS.get(kind, ("event", lambda e, k=kind: str(k)))
            out.append(dict(common, ph="i", s="t", cat=cat, name=name_of(ev), args=args_of(ev)))

    # dispatch -> blocking sync pairs by correlation id: the sync is stamped
    # when the host read notes the pending chain, before the dispatch, so a
    # pair opens at the earlier stamp and closes when the host holds the value
    for disp, sync in async_pairs(evs):
        start = min(disp["ts"], sync["ts"])
        end = max(disp["ts"], sync["ts"] + float(sync.get("dur", 0.0)))
        common = {"cat": "async_forcing", "name": "dispatch→sync", "id": str(sync.get("cid")), "pid": pid, "tid": tid}
        out.append(dict(common, ph="b", ts=_us(start), args={
            "program": disp.get("program"), "roots": disp.get("roots"), "where": sync.get("where"), "cid": sync.get("cid"),
        }))
        out.append(dict(common, ph="e", ts=_us(end)))
    return out


def export_trace(path: Optional[str] = None, events: Optional[List[dict]] = None) -> Dict[str, Any]:
    """The timeline as Chrome/Perfetto trace-event JSON (the scope's own
    inside a :func:`scope`); written to ``path`` when given. The timeline
    holds what was recorded in verbose mode."""
    doc = {
        "traceEvents": trace_events(events),
        "displayTimeUnit": "ms",
        "otherData": {
            "tool": "heat_tpu_torch.telemetry",
            "host": _host_index(),
            "mode": _MODE_NAMES[_MODE],
            "events_dropped": _cur().events_dropped,
        },
    }
    if path is not None:
        with open(path, "w") as fh:
            json.dump(doc, fh)
            fh.write("\n")
    return doc


def merge_traces(paths: List[str], path: Optional[str] = None, align: bool = True, check_parity: bool = False) -> Dict[str, Any]:
    """Stitch trace files into one multi-process trace: each input keeps its
    own process row (re-numbered on collision) and, with ``align``, is
    shifted so its earliest timestamp is zero. ``check_parity`` runs
    :func:`trace_collective_parity` over the result and warns on problems,
    which land under ``otherData["collective_parity"]``."""
    merged: List[dict] = []
    seen_pids: set = set()
    dropped_total = 0
    for p in paths:
        with open(p) as fh:
            doc = json.load(fh)
        other = doc.get("otherData")
        if isinstance(other, dict):
            try:
                dropped_total += int(other.get("events_dropped") or 0)
            except (TypeError, ValueError):
                pass
        evs = doc.get("traceEvents", [])
        remap = {}
        for old in sorted({ev.get("pid", 0) for ev in evs}):
            new = old
            while new in seen_pids:
                new = max(seen_pids) + 1
            seen_pids.add(new)
            remap[old] = new
        stamps = [ev["ts"] for ev in evs if "ts" in ev]
        base = min(stamps) if (align and stamps) else 0.0
        for ev in evs:
            ev = dict(ev)
            ev["pid"] = remap.get(ev.get("pid", 0), ev.get("pid", 0))
            if "ts" in ev:
                ev["ts"] = round(ev["ts"] - base, 3)
            merged.append(ev)
    doc = {
        "traceEvents": merged,
        "displayTimeUnit": "ms",
        "otherData": {"tool": "heat_tpu_torch.telemetry", "merged_from": len(paths), "events_dropped": dropped_total},
    }
    if check_parity:
        problems = trace_collective_parity(doc)
        if problems:
            doc["otherData"]["collective_parity"] = problems
            warnings.warn(
                f"merged trace fails cross-host collective parity ({len(problems)} "
                f"problem(s), first: {problems[0]})",
                stacklevel=2,
            )
    if path is not None:
        with open(path, "w") as fh:
            json.dump(doc, fh)
            fh.write("\n")
    return doc


def _load_trace_doc(doc_or_path):
    if not isinstance(doc_or_path, str):
        return doc_or_path, None
    try:
        with open(doc_or_path) as fh:
            return json.load(fh), None
    except Exception as exc:  # noqa: BLE001 - the problem is the result
        return None, f"not valid JSON: {exc!r}"


def trace_collective_parity(doc_or_path) -> List[str]:
    """Cross-row collective parity of a (merged) trace: every process row
    must hold the same multiset of collective events keyed by (name,
    correlation id). Returns the problems; a one-row trace passes."""
    doc, err = _load_trace_doc(doc_or_path)
    if err is not None:
        return [err]
    if not isinstance(doc, dict) or not isinstance(doc.get("traceEvents"), list):
        return ["missing traceEvents list"]
    per_pid: Dict[Any, Dict[tuple, int]] = {}
    for ev in doc["traceEvents"]:
        if not isinstance(ev, dict):
            continue
        if ev.get("ph") == "M":
            per_pid.setdefault(ev.get("pid", 0), {})
            continue
        if ev.get("cat") != "collective":
            continue
        key = (str(ev.get("name")), (ev.get("args") or {}).get("cid"))
        counts = per_pid.setdefault(ev.get("pid", 0), {})
        counts[key] = counts.get(key, 0) + 1
    if len(per_pid) < 2:
        return []
    problems: List[str] = []
    pids = sorted(per_pid, key=str)
    ref_pid, ref = pids[0], per_pid[pids[0]]
    for pid in pids[1:]:
        counts = per_pid[pid]
        for key in sorted(set(ref) | set(counts), key=str):
            a, b = ref.get(key, 0), counts.get(key, 0)
            if a != b:
                name, cid = key
                where = f"collective {name!r}" + (f" cid {cid}" if cid is not None else "")
                problems.append(
                    f"{where}: host {ref_pid} recorded {a} event(s) but host {pid} "
                    f"recorded {b} — hosts diverged around this collective"
                )
    return problems


def validate_trace(doc_or_path, cross_host: bool = False) -> List[str]:
    """Structural problems of a Chrome trace-event document or file (empty
    = it loads and every event has its required keys); ``cross_host`` adds
    :func:`trace_collective_parity`."""
    doc, err = _load_trace_doc(doc_or_path)
    if err is not None:
        return [err]
    if not isinstance(doc, dict) or not isinstance(doc.get("traceEvents"), list):
        return ["missing traceEvents list"]
    problems: List[str] = []
    open_async: Dict[str, int] = {}
    for i, ev in enumerate(doc["traceEvents"]):
        if not isinstance(ev, dict):
            problems.append(f"event {i} is not an object")
            continue
        ph = ev.get("ph")
        if ph is None or "pid" not in ev:
            problems.append(f"event {i} missing ph/pid: {ev}")
            continue
        if ph != "M" and "ts" not in ev:
            problems.append(f"event {i} ({ph}) missing ts")
        if ph in ("b", "e") and "id" not in ev:
            problems.append(f"async event {i} missing id")
        if ph == "C":
            args = ev.get("args")
            if not isinstance(args, dict) or not args:
                problems.append(f"counter event {i} missing args series")
            elif any(not isinstance(v, (int, float)) or isinstance(v, bool) for v in args.values()):
                problems.append(f"counter event {i} has non-numeric series: {args}")
        if ph == "b":
            open_async[str(ev.get("id"))] = open_async.get(str(ev.get("id")), 0) + 1
        elif ph == "e":
            key = str(ev.get("id"))
            if open_async.get(key, 0) <= 0:
                problems.append(f"async end without begin (id {key})")
            else:
                open_async[key] -= 1
    for key, n in open_async.items():
        if n:
            problems.append(f"async begin without end (id {key})")
    if cross_host:
        problems.extend(trace_collective_parity(doc))
    return problems


# ----------------------------------------------------------------------
# the metrics sink: HEAT_TPU_METRICS=<path>
# ----------------------------------------------------------------------
class _MetricsSink:
    """Appends the global ``report()`` as one JSON line per flush: a daemon
    thread flushes every ``interval`` seconds (0 = at exit only) and the
    atexit hook writes the last line. A flush never raises and never
    initializes CUDA (see :func:`_memory_block`)."""

    def __init__(self, path: str, interval: float):
        self.path = path
        self.interval = float(interval)
        self.lines = 0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self) -> None:
        if self.interval > 0 and self._thread is None:
            self._thread = threading.Thread(target=self._loop, name="heat-tpu-metrics", daemon=True)
            self._thread.start()

    def _loop(self) -> None:
        while not self._stop.wait(self.interval):
            self.flush("periodic")

    def flush(self, event: str = "flush") -> bool:
        try:
            doc = report(_state=_GLOBAL)
            doc.pop("events", None)  # the timeline has its own exporter
            if "serving" not in doc:
                # every line carries the same keys, sessions or none
                from . import serving

                doc["serving"] = serving.sessions_block()
            line = json.dumps(_jsonable({"ts": time.time(), "event": event, "report": doc}), default=str)
            with open(self.path, "a") as fh:
                fh.write(line + "\n")
            self.lines += 1
            return True
        # the sink runs on a daemon thread and at exit: a failed flush drops
        # one metrics line, never the job
        except Exception:  # noqa: BLE001
            return False

    def stop(self, final: bool = True) -> None:
        self._stop.set()
        if final:
            self.flush("exit")


_SINK: Optional[_MetricsSink] = None


def set_metrics_sink(path: Optional[str], interval: Optional[float] = None) -> Optional[_MetricsSink]:
    """(Re)configure the JSON-lines metrics sink: ``path=None`` stops it
    without a last line; otherwise one ``report()`` line is appended to
    ``path`` every ``interval`` seconds (default
    ``HEAT_TPU_METRICS_INTERVAL``, 30; 0 = at exit only) and at exit."""
    global _SINK
    if _SINK is not None:
        _SINK.stop(final=False)
        _SINK = None
    if path:
        if interval is None:
            interval = float(os.environ.get("HEAT_TPU_METRICS_INTERVAL", "30"))
        _SINK = _MetricsSink(path, interval)
        _SINK.start()
    return _SINK


def _sink_atexit() -> None:
    if _SINK is not None:
        _SINK.stop(final=True)


atexit.register(_sink_atexit)
if os.environ.get("HEAT_TPU_METRICS"):
    set_metrics_sink(os.environ["HEAT_TPU_METRICS"])


# ----------------------------------------------------------------------
# collective instructions in compiled-program text
# ----------------------------------------------------------------------
#: collective opcodes in call position (``all-reduce(`` or the async
#: ``all-reduce-start(``), longest alternatives first
_HLO_COLLECTIVE_RE = re.compile(
    r"\b(all-reduce-scatter|reduce-scatter|all-gather|all-reduce|all-to-all|"
    r"collective-permute|collective-broadcast)(?:-start)?\("
)


def hlo_collectives(hlo_text: str) -> List[Dict[str, str]]:
    """Collective instructions of an HLO dump, one entry (op and source
    line) per instruction; async ``-start``/``-done`` pairs count once, and
    names and operand references never match."""
    out = []
    for line in hlo_text.splitlines():
        if "(" not in line or "=" not in line:
            continue
        m = _HLO_COLLECTIVE_RE.search(line)
        if m:
            out.append({"op": m.group(1), "line": line.strip()})
    return out


#: the collective nodes of a fused program's text (``fusion.program_hlo``,
#: a GraphModule's code): each node's target, by its op's name, and the
#: collective it stands for
_PROGRAM_COLLECTIVE_RE = re.compile(
    r"= heat_tpu_torch_core_fusion_(across_op|cum_split_op|gather_op|blocks_op|apply(?:_multi)?_op\w*)\("
)
_PROGRAM_COLLECTIVE_KIND = {
    "across_op": "all-reduce",
    "cum_split_op": "exscan",
    "gather_op": "all-gather",
    "blocks_op": "scatter",
}


def hlo_collective_counts(hlo_text: str) -> Dict[str, int]:
    """Per-type collective counts of an HLO dump, or of a fused program's
    text (``fusion.program_hlo``): there a split-crossing reduction counts
    as ``all-reduce``, a gather of split shards as ``all-gather``, a cut
    into a split's blocks as ``scatter``, a cumulative op along the split
    as ``exscan`` and a schedule over the shard list (a matmul among them)
    as ``apply``."""
    counts: Dict[str, int] = {}
    for entry in hlo_collectives(hlo_text):
        counts[entry["op"]] = counts.get(entry["op"], 0) + 1
    for m in _PROGRAM_COLLECTIVE_RE.finditer(hlo_text):
        kind = _PROGRAM_COLLECTIVE_KIND.get(m.group(1), "apply")
        counts[kind] = counts.get(kind, 0) + 1
    return counts


def collective_budget_excess(counts: Dict[str, int], budget: Dict[str, int]) -> Dict[str, str]:
    """Violations of a per-type collective budget: a type over its
    allowance, or present but not budgeted. Empty = within budget."""
    excess = {}
    for op, count in counts.items():
        allowed = budget.get(op)
        if allowed is None:
            excess[op] = f"{count} present but not budgeted"
        elif count > allowed:
            excess[op] = f"{count} > budget {allowed}"
    return excess
