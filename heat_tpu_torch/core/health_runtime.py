"""The runtime health layer (``ht.flight``): the flight recorder, the stall
watchdog and streaming latency histograms with rolling SLO gauges
(reference: heat_tpu/core/health_runtime.py).

* **Flight recorder.** A fixed-size ring of the compact typed events
  (blocking syncs, collectives, compiles, faults, checkpoints, stalls),
  kept at ``HEAT_TPU_TELEMETRY=1`` too, where the verbose timeline stays
  empty: ``telemetry._note_event`` hands every event to ``_FLIGHT_HOOK``
  and the ring costs one append under a lock. :func:`dump_flight` (or a
  watchdog trip under the ``dump`` and ``raise`` policies) exports the ring
  as a Chrome/Perfetto trace checked by ``telemetry.validate_trace``, next
  to a JSON bundle: the watchdog's state and stall diagnoses, the latency
  picture and the memory watermark. Knobs: ``HEAT_TPU_FLIGHT={0,1}``,
  ``HEAT_TPU_FLIGHT_EVENTS=N``, ``HEAT_TPU_FLIGHT_DIR`` and
  ``HEAT_TPU_FLIGHT_DUMP_EVERY_S`` (the per-reason throttle of
  :func:`auto_dump`).
* **Stall watchdog.** A daemon thread, started with the first guard,
  watches every armed :func:`watch` guard: the host reads
  ``DNDarray.numpy`` (``sync:numpy``), ``DNDarray.item`` (``sync:item``)
  and printing (``sync:print``). A guard still open past its deadline
  (``HEAT_TPU_WATCHDOG_MS``, default 30 s) gets a diagnosis: the site, the
  wait, the recent collective trail from the ring and the blocked thread's
  stack. Policies (``HEAT_TPU_WATCHDOG_POLICY``): ``warn`` emits a
  :class:`~heat_tpu_torch.core.resilience.StallWarning`, ``dump`` also
  dumps the ring, ``raise`` also raises
  :class:`~heat_tpu_torch.core.resilience.StallError` at the guarded site
  once the wait returns. The thread reads guard state and
  ``sys._current_frames()`` only: it never touches CUDA. The
  ``watchdog.stall`` fault site injects a real stall: an armed guard turns
  the fault into a sleep past its own deadline, so the thread trips on its
  own clock.
* **Latency histograms and SLO gauges.** Log-bucketed streaming histograms
  (buckets of 2^(1/8), ~9% relative error) of the blocking syncs' host
  wait per trigger, scoped like telemetry's counters (a record goes to
  every state on the stack, a query reads the innermost) and shown with
  p50/p90/p99 in ``report()["health"]``. ``HEAT_TPU_SLO_SYNC_MS`` turns
  each wait into a pass or a breach over a rolling window
  (``HEAT_TPU_SLO_WINDOW_S``); a breach lands on the ring. The fusion
  recorder's dispatches feed two more tables through :func:`note_dispatch`,
  keyed by program key: ``compile`` (the call of a fresh program, which
  builds it) and ``dispatch`` (from the call to the blocking sync that
  waited on its chain), with their SLOs ``HEAT_TPU_SLO_COMPILE_MS`` and
  ``HEAT_TPU_SLO_DISPATCH_MS``. A fused dispatch is a guarded site
  (``dispatch``), and a stall's diagnosis names the in-flight program and
  the pending roots of the recorder's registry.
* **Auto-dumps.** A degraded fused program (``degrade``), a memory
  exhaustion (``oom``) and a watchdog trip under ``dump``/``raise`` dump
  the ring, throttled per reason; the bundle carries the recorder's cache
  counters under ``programs``.

The port counts every host read as a blocking sync (the reference counts
only a pending chain's), so its ``sync`` histograms fill where the
reference's stay empty.

Nothing here syncs the card or initializes CUDA: it is module state and
metadata reads. ``telemetry.reset()`` and ``telemetry.scope()`` reset and
scope this module's session state too.
"""

from __future__ import annotations

import itertools
import json
import math
import os
import sys
import tempfile
import threading
import time
import traceback
import warnings
from collections import OrderedDict, deque
from typing import Any, Dict, List, Optional, Tuple

from . import resilience, telemetry
from .resilience import StallError, StallWarning

__all__ = [
    "StallError",
    "StallWarning",
    "auto_dump",
    "dump_flight",
    "flight_events",
    "flight_stats",
    "health_block",
    "last_dump",
    "last_stall",
    "note_dispatch",
    "reset",
    "set_dump_dir",
    "set_flight",
    "set_slo",
    "set_watchdog",
    "stalls",
    "watch",
    "watchdog_stats",
]

_UNSET = object()


def _env_float(name: str, default: float) -> float:
    raw = os.environ.get(name)
    if raw is None or not raw.strip():
        return default
    try:
        return float(raw.strip())
    except ValueError:
        warnings.warn(f"{name}: malformed value {raw!r}; using {default}", stacklevel=2)
        return default


def _env_ms(name: str) -> Optional[float]:
    """An optional millisecond knob, in seconds (None when unset)."""
    raw = os.environ.get(name)
    if raw is None or not raw.strip():
        return None
    try:
        return float(raw.strip()) / 1e3
    except ValueError:
        warnings.warn(f"{name}: malformed value {raw!r}; ignored", stacklevel=2)
        return None


# ----------------------------------------------------------------------
# the flight recorder: the always-on event ring
# ----------------------------------------------------------------------
_ENABLED = os.environ.get("HEAT_TPU_FLIGHT", "1").strip().lower() not in telemetry._OFF_VALUES
_RING_CAP = max(16, int(_env_float("HEAT_TPU_FLIGHT_EVENTS", 2048)))
_RING: deque = deque(maxlen=_RING_CAP)
_RING_DROPPED = 0
#: the ring is appended from any thread (the watchdog's stall events, the
#: lockstep threads' collectives) and read whole by dumps and diagnoses: a
#: deque read while another thread appends raises
_RING_LOCK = threading.Lock()
_DUMP_DIR = os.environ.get("HEAT_TPU_FLIGHT_DIR", "").strip() or tempfile.gettempdir()
_DUMP_EVERY_S = max(0.0, _env_float("HEAT_TPU_FLIGHT_DUMP_EVERY_S", 60.0))
_DUMP_COUNT = 0
_LAST_DUMP: Optional[Dict[str, Any]] = None
_LAST_AUTO_DUMP_TS: Dict[str, float] = {}


def _flight_note(ev: dict) -> None:
    """``telemetry._FLIGHT_HOOK``: one bounded append per typed event. The
    ring shares the event dict with the verbose timeline, so a ``dur``
    stamped later (a closed blocking sync) shows in dumps too."""
    global _RING_DROPPED
    with _RING_LOCK:
        if len(_RING) == _RING.maxlen:
            _RING_DROPPED += 1
        _RING.append(ev)


def _ring() -> List[dict]:
    with _RING_LOCK:
        return list(_RING)


def _install_hook() -> None:
    telemetry._FLIGHT_HOOK = _flight_note if _ENABLED else None


def set_flight(enabled: Optional[bool] = None, events: Optional[int] = None):
    """Turn the recorder on or off, or resize its ring, in-process; returns
    the previous ``(enabled, ring_cap)``. Resizing keeps the newest events."""
    global _ENABLED, _RING_CAP, _RING
    prev = (_ENABLED, _RING_CAP)
    if enabled is not None:
        _ENABLED = bool(enabled)
    if events is not None:
        with _RING_LOCK:
            _RING_CAP = max(1, int(events))
            _RING = deque(_RING, maxlen=_RING_CAP)
    _install_hook()
    return prev


def flight_events() -> List[dict]:
    """The ring's events, oldest first."""
    return _ring()


def flight_stats() -> Dict[str, Any]:
    """The ring's occupancy and the dump count: the report's and the
    command line's view."""
    return {
        "enabled": _ENABLED,
        "events": len(_RING),
        "cap": _RING_CAP,
        "dropped": _RING_DROPPED,
        "dumps": _DUMP_COUNT,
        "last_dump": (_LAST_DUMP or {}).get("path"),
    }


def set_dump_dir(path: str) -> str:
    """Send dumps to ``path``; returns the previous directory."""
    global _DUMP_DIR
    prev, _DUMP_DIR = _DUMP_DIR, str(path)
    return prev


def last_dump() -> Optional[Dict[str, Any]]:
    """The latest dump's ``{"path", "trace_path", "problems"}``."""
    return _LAST_DUMP


def dump_flight(path: Optional[str] = None, reason: str = "manual") -> Dict[str, Any]:
    """Export the ring as a Chrome/Perfetto trace (``<base>.trace.json``)
    checked by ``telemetry.validate_trace``, and a JSON bundle
    (``<base>.json``): the watchdog's state and stall diagnoses, the latency
    and SLO picture, the memory watermark and the numerics lens's findings,
    drift ledger and canary. Module state and metadata
    only. Returns ``{"path", "trace_path", "problems"}``, ``problems`` being
    ``validate_trace``'s findings (empty for a well-formed dump)."""
    global _DUMP_COUNT, _LAST_DUMP
    from . import fusion, memledger

    evs = _ring()
    _DUMP_COUNT += 1
    if path is None:
        base = os.path.join(_DUMP_DIR, f"heat_flight_h{telemetry._host_index()}_{reason}_{_DUMP_COUNT:03d}")
    else:
        base = path[:-5] if path.endswith(".json") else path
    trace_path = base + ".trace.json"
    bundle_path = base + ".json"
    doc = telemetry.export_trace(trace_path, events=evs)
    problems = [str(p) for p in telemetry.validate_trace(doc)]
    bundle: Dict[str, Any] = {
        "reason": reason,
        "captured_utc": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
        "host": telemetry._host_index(),
        "telemetry_mode": telemetry._MODE,
        "events": len(evs),
        "events_dropped": _RING_DROPPED,
        "ring_cap": _RING_CAP,
        "trace_path": trace_path,
        "trace_problems": problems,
        "collective_parity_problems": [str(p) for p in telemetry.trace_collective_parity(doc)],
        "watchdog": watchdog_stats(),
        "stalls": list(_STALLS),
        "health": health_block(global_view=True),
        "programs": fusion.cache_stats(),
        "memory": {
            "watermark": memledger.watermark(),
            "budget": memledger.budget_info(),
            "last_oom": memledger.last_oom(),
        },
    }
    from . import numlens

    # the value plane beside the runtime's: the numeric findings (SDC hits,
    # drift breaches, nonfinite provenance), the drift ledger and the canary
    bundle["numerics"] = {
        "findings": numlens.findings(), "drift": numlens.drift_ledger(), "canary": numlens.numerics_block()["canary"],
    }
    with open(bundle_path, "w") as fh:
        json.dump(telemetry._jsonable(bundle), fh, indent=1, default=str)
        fh.write("\n")
    _LAST_DUMP = {"path": bundle_path, "trace_path": trace_path, "problems": problems}
    telemetry.record_event("flight_dump", reason=reason, path=bundle_path, events=len(evs))
    return dict(_LAST_DUMP)


def auto_dump(reason: str) -> Optional[Dict[str, Any]]:
    """The dump of a failure seam (a degraded fused program, a memory
    exhaustion, a watchdog trip under the ``dump`` and ``raise`` policies),
    throttled per reason
    (``HEAT_TPU_FLIGHT_DUMP_EVERY_S``) so that a storm writes one bundle. A
    no-op unless the recorder is on and telemetry is active."""
    if not _ENABLED or not telemetry._MODE:
        return None
    now = time.perf_counter()
    last = _LAST_AUTO_DUMP_TS.get(reason)
    if last is not None and _DUMP_EVERY_S > 0 and now - last < _DUMP_EVERY_S:
        return None
    _LAST_AUTO_DUMP_TS[reason] = now
    try:
        return dump_flight(reason=reason)
    except OSError as exc:  # a full or missing dump directory must not take down the caller
        warnings.warn(f"flight auto-dump ({reason}) failed: {exc!r}", stacklevel=2)
        return None


# ----------------------------------------------------------------------
# streaming latency histograms (log-bucketed, HDR-style)
# ----------------------------------------------------------------------
#: bucket growth factor 2**(1/8) ~ 1.09: at most ~9% relative quantile error
_HIST_BASE = 2.0 ** 0.125
_HIST_LOG = math.log(_HIST_BASE)
_HIST_FLOOR = 1e-9  # sub-nanosecond waits fall into the first bucket


class _Hist:
    """One streaming histogram over seconds: sparse log-spaced buckets and
    exact count, total, min and max. A quantile walks the cumulative counts
    and returns its bucket's geometric midpoint, clamped to the observed
    range: bounded relative error in O(1) memory."""

    __slots__ = ("count", "total", "vmin", "vmax", "buckets")

    def __init__(self):
        self.count = 0
        self.total = 0.0
        self.vmin = math.inf
        self.vmax = 0.0
        self.buckets: Dict[int, int] = {}

    def observe(self, v: float) -> None:
        v = _HIST_FLOOR if v <= _HIST_FLOOR else float(v)
        idx = int(math.floor(math.log(v) / _HIST_LOG))
        self.buckets[idx] = self.buckets.get(idx, 0) + 1
        self.count += 1
        self.total += v
        if v < self.vmin:
            self.vmin = v
        if v > self.vmax:
            self.vmax = v

    def merge(self, other: "_Hist") -> None:
        for idx, n in other.buckets.items():
            self.buckets[idx] = self.buckets.get(idx, 0) + n
        self.count += other.count
        self.total += other.total
        self.vmin = min(self.vmin, other.vmin)
        self.vmax = max(self.vmax, other.vmax)

    def percentile(self, q: float) -> float:
        if not self.count:
            return 0.0
        target = q / 100.0 * self.count
        cum = 0
        for idx in sorted(self.buckets):
            cum += self.buckets[idx]
            if cum >= target:
                rep = _HIST_BASE ** (idx + 0.5)
                return min(max(rep, self.vmin), self.vmax)
        return self.vmax

    def snapshot(self) -> Dict[str, Any]:
        if not self.count:
            return {"count": 0}
        return {
            "count": self.count,
            "total_s": round(self.total, 6),
            "mean_s": round(self.total / self.count, 6),
            "min_s": round(self.vmin, 9),
            "max_s": round(self.vmax, 6),
            "p50_s": round(self.percentile(50.0), 6),
            "p90_s": round(self.percentile(90.0), 6),
            "p99_s": round(self.percentile(99.0), 6),
        }


_METRICS = ("sync", "dispatch", "compile")


class _HState:
    """One scope's histogram tables, as ``telemetry._State`` is one scope's
    counters: a record goes to every state on the stack, a query reads the
    innermost."""

    __slots__ = ("path", "overall", "sync", "dispatch", "compile")

    def __init__(self, path: str = ""):
        self.path = path
        self.clear()

    def clear(self) -> None:
        self.overall: Dict[str, _Hist] = {m: _Hist() for m in _METRICS}
        self.sync: Dict[str, _Hist] = {}
        self.dispatch: Dict[str, _Hist] = {}
        self.compile: Dict[str, _Hist] = {}


def _merge_hstate(dst: _HState, src: _HState) -> None:
    for m in _METRICS:
        dst.overall[m].merge(src.overall[m])
        table, out = getattr(src, m), getattr(dst, m)
        for key, h in table.items():
            acc = out.get(key)
            if acc is None:
                acc = out[key] = _Hist()
            acc.merge(h)


_H_GLOBAL = _HState()
#: completed-scope accumulators, keyed by scope path (re-entry accumulates)
_H_SCOPES: Dict[str, _HState] = {}

# the scope stack is thread-local, as telemetry's is: records roll up into
# the shared global tables and the archive merge runs under _H_LOCK
_H_TLS = threading.local()
_H_GLOBAL_ONLY = (_H_GLOBAL,)
#: every scope state active on any thread (reset() clears them all)
_H_ACTIVE: List[_HState] = []
_H_LOCK = threading.Lock()


def _h_stack() -> List[_HState]:
    stack = getattr(_H_TLS, "scopes", None)
    if stack is None:
        stack = _H_TLS.scopes = []
    return stack


def _h_states():
    stack = getattr(_H_TLS, "scopes", None)
    if not stack:
        return _H_GLOBAL_ONLY
    return [_H_GLOBAL] + stack


def _push_scope(path: str) -> None:
    """``telemetry.scope``'s seam: the histograms are scoped alongside the
    counters."""
    st = _HState(path)
    _h_stack().append(st)
    with _H_LOCK:
        _H_ACTIVE.append(st)


def _pop_scope(path: str) -> None:
    stack = _h_stack()
    for i in range(len(stack) - 1, -1, -1):
        if stack[i].path == path:
            st = stack.pop(i)
            with _H_LOCK:
                for j in range(len(_H_ACTIVE) - 1, -1, -1):
                    if _H_ACTIVE[j] is st:
                        del _H_ACTIVE[j]
                        break
                acc = _H_SCOPES.get(path)
                if acc is None:
                    acc = _H_SCOPES[path] = _HState(path)
                _merge_hstate(acc, st)
            return


def _observe(metric: str, key: Optional[str], v: float) -> None:
    """Fold one latency sample into every active state (the '*' overall row
    and the row of ``key``, the sync trigger) and the SLO window. Host
    reads on several threads share the global tables: the lock keeps each
    fold whole."""
    with _H_LOCK:
        for st in _h_states():
            st.overall[metric].observe(v)
            if key is None:
                continue
            table = getattr(st, metric)
            h = table.get(key)
            if h is None:
                h = table[key] = _Hist()
            h.observe(v)
    _slo_observe(metric, v)


def _render_hists(st: _HState, metric: str) -> Dict[str, Any]:
    with _H_LOCK:
        out = {"*": st.overall[metric].snapshot()}
        for key, h in getattr(st, metric).items():
            out[str(key)] = h.snapshot()
    return out


# ----------------------------------------------------------------------
# SLO gauges: rolling pass/breach windows per metric
# ----------------------------------------------------------------------
_SLO_LIMITS: Dict[str, Optional[float]] = {  # seconds; None = no SLO set
    "sync": _env_ms("HEAT_TPU_SLO_SYNC_MS"),
    "dispatch": _env_ms("HEAT_TPU_SLO_DISPATCH_MS"),
    "compile": _env_ms("HEAT_TPU_SLO_COMPILE_MS"),
}
_SLO_WINDOW_S = max(1.0, _env_float("HEAT_TPU_SLO_WINDOW_S", 300.0))
#: samples are ``(perf_counter_ts, seconds, tenant)``: the tenant is the
#: serving session active on the recording thread (None outside one)
_SLO_SAMPLES: Dict[str, deque] = {m: deque(maxlen=2048) for m in _METRICS}
_SLO_BREACHES: Dict[str, int] = {m: 0 for m in _METRICS}

#: the serving layer installs its current-session lookup here, so that a
#: sample carries its tenant without this module importing that layer
_TENANT_HOOK = None


def _slo_observe(metric: str, v: float) -> None:
    tenant = None
    if _TENANT_HOOK is not None:
        try:
            tenant = _TENANT_HOOK()
        # the tag is best effort: a latency sample always lands
        except Exception:  # noqa: BLE001
            tenant = None
    _SLO_SAMPLES[metric].append((time.perf_counter(), v, tenant))
    limit = _SLO_LIMITS.get(metric)
    if limit is not None and v > limit:
        _SLO_BREACHES[metric] += 1
        telemetry.record_event(
            "slo_breach", metric=metric, value_ms=round(v * 1e3, 3), limit_ms=round(limit * 1e3, 3), tenant=tenant,
        )


def set_slo(sync_ms=_UNSET, dispatch_ms=_UNSET, compile_ms=_UNSET, window_s=None) -> Dict[str, Optional[float]]:
    """Set SLO limits in milliseconds (None clears one) and the rolling
    window in-process; returns the previous limits in seconds keyed by
    metric."""
    global _SLO_WINDOW_S
    prev = dict(_SLO_LIMITS)
    for metric, value in (("sync", sync_ms), ("dispatch", dispatch_ms), ("compile", compile_ms)):
        if value is not _UNSET:
            _SLO_LIMITS[metric] = None if value is None else float(value) / 1e3
    if window_s is not None:
        _SLO_WINDOW_S = max(1.0, float(window_s))
    return prev


def _slo_block() -> Dict[str, Any]:
    now = time.perf_counter()
    out: Dict[str, Any] = {"window_s": _SLO_WINDOW_S}
    for metric, dq in _SLO_SAMPLES.items():
        limit = _SLO_LIMITS[metric]
        vals = sorted(s[1] for s in list(dq) if now - s[0] <= _SLO_WINDOW_S)
        entry: Dict[str, Any] = {
            "limit_ms": None if limit is None else round(limit * 1e3, 3),
            "recent": len(vals),
            "breaches_total": _SLO_BREACHES[metric],
        }
        if vals:
            def pct(q):
                return vals[min(len(vals) - 1, int(q / 100.0 * len(vals)))]

            entry["window_p50_ms"] = round(pct(50) * 1e3, 3)
            entry["window_p99_ms"] = round(pct(99) * 1e3, 3)
            if limit is not None:
                bad = sum(1 for v in vals if v > limit)
                entry["window_breaches"] = bad
                entry["ok_ratio"] = round(1.0 - bad / len(vals), 4)
        out[metric] = entry
    return out


# ----------------------------------------------------------------------
# dispatch to done
# ----------------------------------------------------------------------
#: in-flight fused dispatches: cid -> (dispatch perf_counter ts, program
#: key); a blocking sync on one of these cids closes its sample, and the
#: cap bounds the dispatches whose reads never block
_DISPATCHED: "OrderedDict[int, Tuple[float, str]]" = OrderedDict()
_DISPATCHED_CAP = 512


def note_dispatch(program: str, cids, compiled: bool, dur_s: float) -> None:
    """The fusion recorder's seam, right after a program call returns:
    start the dispatch-to-done clock of each root cid, and, when the call
    built the program, fold its duration into the ``compile`` table (a
    cached program's call is an enqueue, whose duration says nothing)."""
    now = time.perf_counter()
    for cid in cids:
        if cid is not None:
            _DISPATCHED[cid] = (now - dur_s, str(program))
            _DISPATCHED.move_to_end(cid)
    while len(_DISPATCHED) > _DISPATCHED_CAP:
        _DISPATCHED.popitem(last=False)
    if compiled:
        _observe("compile", str(program), dur_s)


def _on_sync_end(kind: str, cid: Optional[int], dur: float) -> None:
    """``telemetry._SYNC_HOOK``: every closed blocking sync feeds the host
    wait histogram of its trigger and, when its cid names an in-flight
    fused dispatch, the ``dispatch`` table of that program."""
    now = time.perf_counter()
    _observe("sync", kind, dur)
    if cid is not None:
        rec = _DISPATCHED.pop(cid, None)
        if rec is not None:
            _observe("dispatch", rec[1], max(0.0, now - rec[0]))


# ----------------------------------------------------------------------
# the stall watchdog
# ----------------------------------------------------------------------
_WD_ENABLED = os.environ.get("HEAT_TPU_WATCHDOG", "1").strip().lower() not in telemetry._OFF_VALUES
_WD_DEADLINE_S = max(0.0, _env_float("HEAT_TPU_WATCHDOG_MS", 30000.0)) / 1e3
_WD_POLICIES = ("warn", "dump", "raise")
_WD_POLICY = os.environ.get("HEAT_TPU_WATCHDOG_POLICY", "warn").strip().lower() or "warn"
if _WD_POLICY not in _WD_POLICIES:
    warnings.warn(f"HEAT_TPU_WATCHDOG_POLICY: unknown policy {_WD_POLICY!r}; using 'warn'", stacklevel=2)
    _WD_POLICY = "warn"
#: one attribute read decides the disarmed path
_WD_ACTIVE = _WD_ENABLED and _WD_DEADLINE_S > 0

_WD_COND = threading.Condition(threading.Lock())
_WD_GUARDS: Dict[int, "_Guard"] = {}
_WD_SEQ = itertools.count(1)  # idents without a lock on the arm path
_WD_THREAD: Optional[threading.Thread] = None
_WD_STATS = {"arms": 0, "trips": 0}
_STALLS: deque = deque(maxlen=16)


class _NullGuard:
    """The disarmed path: one shared no-op context manager."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_GUARD = _NullGuard()


class _Guard:
    """One armed watch over a blocking region. The daemon trips it past its
    deadline; under the ``raise`` policy the guarded thread raises when the
    region returns (the daemon only warns and dumps: it never throws into
    code it does not own)."""

    __slots__ = ("ident", "site", "deadline_s", "t0", "program", "cid", "cids", "thread_ident", "tripped")

    def __init__(self, site, deadline_s, program, cid, cids):
        self.ident = next(_WD_SEQ)
        self.site = site
        self.deadline_s = deadline_s
        self.program = program
        self.cid = cid
        self.cids = tuple(cids)
        self.t0 = 0.0
        self.thread_ident = 0
        self.tripped = False

    def __enter__(self) -> "_Guard":
        self.t0 = time.perf_counter()
        self.thread_ident = threading.get_ident()
        # lock-free arm: a dict store is atomic and the daemon scans a
        # snapshot; the condition's lock is paid on the rare paths only
        _WD_GUARDS[self.ident] = self
        _WD_STATS["arms"] += 1
        if _WD_THREAD is None or not _WD_THREAD.is_alive():
            with _WD_COND:
                _ensure_thread()
        if self.deadline_s < 2.0:
            # a short deadline wakes the daemon now; a long one rides its
            # 0.5 s poll
            with _WD_COND:
                _WD_COND.notify()
        if resilience._ARMED:
            # the injected stall: block for real past this guard's deadline,
            # so the daemon trips on its own clock. The bare site stalls the
            # first guard to arm; ``watchdog.stall:<site>`` targets one site
            try:
                resilience.check("watchdog.stall")
                resilience.check("watchdog.stall:" + str(self.site))
            except resilience.FaultInjected:
                time.sleep(self.deadline_s * 1.5 + 0.05)
        return self

    def __exit__(self, exc_type, exc, tb):
        _WD_GUARDS.pop(self.ident, None)
        if self.tripped and exc_type is None and _WD_POLICY == "raise":
            raise StallError(
                f"{self.site} blocked past its {self.deadline_s:.3f}s watchdog deadline "
                f"(program {self.program or '<unknown>'}); full diagnosis via health_runtime.last_stall()"
            )
        return False


def watch(site: str, program=None, cid=None, cids=(), deadline_ms=None):
    """Arm the watchdog around a blocking region::

        with health_runtime.watch("sync:numpy"):
            out = tensor.cpu().numpy()

    Returns a shared no-op guard while the watchdog is disarmed.
    ``deadline_ms`` overrides the ambient deadline for this region, and arms
    the guard even when the ambient watchdog is off."""
    if deadline_ms is None:
        if not _WD_ACTIVE:
            return _NULL_GUARD
        deadline_s = _WD_DEADLINE_S
    else:
        deadline_s = max(0.001, float(deadline_ms) / 1e3)
    return _Guard(site, deadline_s, program, cid, cids)


def _ensure_thread() -> None:
    global _WD_THREAD
    if _WD_THREAD is None or not _WD_THREAD.is_alive():
        _WD_THREAD = threading.Thread(target=_wd_loop, name="heat-tpu-watchdog", daemon=True)
        _WD_THREAD.start()


def _wd_loop() -> None:
    while True:
        due: List[_Guard] = []
        now = time.perf_counter()
        wait_s = 0.5
        # a snapshot: guards arm and disarm without the lock
        for g in list(_WD_GUARDS.values()):
            if g.tripped or g.t0 == 0.0:
                continue
            remaining = g.t0 + g.deadline_s - now
            if remaining <= 0:
                g.tripped = True
                due.append(g)
            elif remaining < wait_s:
                wait_s = remaining
        if not due:
            with _WD_COND:
                _WD_COND.wait(timeout=max(0.005, wait_s))
            continue
        for g in due:  # diagnose outside the lock: an arm never blocks
            try:
                _trip(g)
            except Exception as exc:  # noqa: BLE001 - the monitor outlives its own diagnosis
                warnings.warn(f"watchdog diagnosis failed: {exc!r}", stacklevel=1)


def _collective_trail(limit: int = 16) -> Dict[str, Any]:
    """This host's recent collectives from the ring: what the blocked
    region's peers were last asked to do."""
    recent: List[list] = []
    counts: Dict[str, int] = {}
    for ev in _ring():
        kind = ev.get("kind")
        if kind == "collective":
            op = str(ev.get("op"))
            recent.append([kind, op, ev.get("cid")])
            counts[op] = counts.get(op, 0) + int(ev.get("count", 1) or 1)
    return {"recent": recent[-limit:], "counts": counts}


def _stack_of(thread_ident: int) -> List[str]:
    frame = sys._current_frames().get(thread_ident)
    if frame is None:
        return []
    return [ln.rstrip() for ln in traceback.format_stack(frame)][-12:]


def _program_of_cid(cid) -> Optional[str]:
    """The program key a chain's cid was dispatched under, from the
    in-flight table or the ring."""
    if cid is None:
        return None
    rec = _DISPATCHED.get(cid)
    if rec is not None:
        return rec[1]
    for ev in reversed(_ring()):
        if ev.get("kind") == "dispatch" and (ev.get("cid") == cid or cid in (ev.get("cids") or ())):
            return ev.get("program")
    return None


def _pending_roots() -> List[dict]:
    """The still-pending roots of the fusion recorder's registry, by cid
    and depth (a metadata walk: nothing is forced)."""
    from . import fusion

    out = []
    for key in fusion._live_root_keys():
        payload = getattr(fusion._LIVE_ROOTS.get(key), "_payload", None)
        if isinstance(payload, fusion.LazyArray) and payload._value is None:
            out.append({"cid": payload.cid, "depth": payload.depth})
        if len(out) >= 32:
            break
    return out


def _trip(g: _Guard) -> None:
    waited = time.perf_counter() - g.t0
    diag = {
        "ts": time.time(),
        "site": g.site,
        "waited_s": round(waited, 4),
        "deadline_s": g.deadline_s,
        "policy": _WD_POLICY,
        "program": g.program or _program_of_cid(g.cid),
        "cid": g.cid,
        "cids": list(g.cids),
        "pending_roots": _pending_roots(),
        "collective_trail": _collective_trail(),
        "stack": _stack_of(g.thread_ident),
    }
    _STALLS.append(diag)
    _WD_STATS["trips"] += 1
    telemetry.record_event("stall", site=g.site, program=diag["program"], cid=g.cid, waited_s=diag["waited_s"])
    warnings.warn(
        StallWarning(
            f"watchdog: {g.site} has been blocked {waited:.2f}s (deadline {g.deadline_s:.2f}s); "
            f"in-flight program {diag['program'] or '<unknown>'}. Full diagnosis via "
            "health_runtime.last_stall()"
        ),
        stacklevel=2,
    )
    if _WD_POLICY in ("dump", "raise"):
        auto_dump("stall")


def set_watchdog(deadline_ms=_UNSET, policy=_UNSET, enabled=_UNSET):
    """Configure the watchdog in-process; returns the previous
    ``(deadline_ms, policy, enabled)`` (pass it back to restore)."""
    global _WD_DEADLINE_S, _WD_POLICY, _WD_ENABLED, _WD_ACTIVE
    prev = (_WD_DEADLINE_S * 1e3, _WD_POLICY, _WD_ENABLED)
    if deadline_ms is not _UNSET:
        _WD_DEADLINE_S = max(0.0, float(deadline_ms)) / 1e3
    if policy is not _UNSET:
        if policy not in _WD_POLICIES:
            raise ValueError(f"watchdog policy must be one of {_WD_POLICIES}")
        _WD_POLICY = policy
    if enabled is not _UNSET:
        _WD_ENABLED = bool(enabled)
    _WD_ACTIVE = _WD_ENABLED and _WD_DEADLINE_S > 0
    return prev


def watchdog_stats() -> Dict[str, Any]:
    return {
        "enabled": _WD_ENABLED,
        "deadline_ms": round(_WD_DEADLINE_S * 1e3, 3),
        "policy": _WD_POLICY,
        "armed": len(_WD_GUARDS),
        "arms": _WD_STATS["arms"],
        "trips": _WD_STATS["trips"],
    }


def stalls() -> List[dict]:
    """This session's stall diagnoses (the last 16, newest last)."""
    return list(_STALLS)


def last_stall() -> Optional[dict]:
    """The latest stall diagnosis, or None."""
    return _STALLS[-1] if _STALLS else None


# ----------------------------------------------------------------------
# the report's block
# ----------------------------------------------------------------------
def health_block(global_view: bool = False) -> Dict[str, Any]:
    """``report()["health"]``: the ring's occupancy, the watchdog's state
    and last stall, the three latency tables ('*' = the overall row;
    ``sync`` keyed by trigger) and the SLO gauges. Inside a
    ``telemetry.scope`` the histograms are the scope's own unless
    ``global_view``."""
    st = _H_GLOBAL if global_view else _h_states()[-1]
    return {
        "flight": flight_stats(),
        "watchdog": dict(watchdog_stats(), last_stall=last_stall()),
        "sync": _render_hists(st, "sync"),
        "dispatch": _render_hists(st, "dispatch"),
        "compile": _render_hists(st, "compile"),
        "slo": _slo_block(),
    }


def reset() -> None:
    """Zero the session state: the ring, the drop and dump counts, the
    histograms (every active scope's and the archive), the SLO windows, the
    stall log and the watchdog's counts. The settings stay (recorder on or
    off, ring size, deadline, policy, SLO limits, dump directory)."""
    global _RING_DROPPED, _DUMP_COUNT, _LAST_DUMP
    with _RING_LOCK:
        _RING.clear()
        _RING_DROPPED = 0
    _DUMP_COUNT = 0
    _LAST_DUMP = None
    _LAST_AUTO_DUMP_TS.clear()
    _DISPATCHED.clear()
    with _H_LOCK:
        _H_GLOBAL.clear()
        for st in list(_H_ACTIVE):
            st.clear()
        _H_SCOPES.clear()
    for dq in _SLO_SAMPLES.values():
        dq.clear()
    for m in _SLO_BREACHES:
        _SLO_BREACHES[m] = 0
    _STALLS.clear()
    for k in _WD_STATS:
        _WD_STATS[k] = 0


# the joined surfaces, installed on telemetry by attribute (telemetry stays
# importable before this module)
telemetry._SYNC_HOOK = _on_sync_end
_install_hook()
