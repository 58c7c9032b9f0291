"""Memory observability: the owner-attributed live-buffer ledger and the
high watermark (reference: heat_tpu/core/memledger.py).

* **Attribution** (:func:`tag`, :func:`owner_scope`). Every tensor a
  ``DNDarray`` stores as a shard is tagged ``dndarray``; the staging pieces
  of a sharded ingest (``core/io.py``) are tagged ``io``, or ``checkpoint``
  inside the restore's :func:`owner_scope`. The registry holds a weakref
  per tagged tensor, keyed by ``id`` and identity-checked (a recycled id
  never inherits a dead tensor's owner); the weakref's death callback drops
  the entry. The last tag wins, so an ingest piece wrapped into a
  ``DNDarray`` moves from ``io`` to ``dndarray``.
* **The ledger** (:func:`ledger`). A buffer is one storage, keyed by
  ``(device, untyped_storage().data_ptr())`` (:func:`_buffer_key`) and
  counted once with its storage's bytes: a view, a ``narrow`` and the one
  shard of ``parray`` at p = 1 share their shard's storage. Attributed
  owners claim their buffers first, so a storage that a tagged tensor and
  an untagged view share counts under the tag.
* **The high watermark** (:func:`watermark`): the largest total any
  :func:`sample` has seen, with its owner split. ``telemetry`` calls
  :func:`note` at its dispatch, collective and checkpoint record seams;
  samples are throttled to one per ``HEAT_TPU_MEMORY_SAMPLE_MS`` (default
  20 ms) and ``HEAT_TPU_MEMORY_LEDGER=0`` turns the hook off (one attribute
  read per seam). In verbose telemetry a sample is a ``memory`` timeline
  event, which ``export_trace`` renders as Perfetto counter tracks.

torch has no ``jax.live_arrays()``, so "total" and "unattributed" are
defined per device kind, as ``jax.live_arrays()`` covers the default
backend:

* **On the card** (once CUDA is initialized) the ledger covers the CUDA
  devices. A device's total is ``torch.cuda.memory_allocated(device)``,
  the caching allocator's host-side count (no sync, no walk), and its
  ``unattributed`` bytes are that total less the attributed storages' bytes
  on it: the foreign tensors, the allocator's rounding of each block to
  512 bytes, and the workspace of libraries. A tensor tagged without an
  owner lies in that remainder.
* **On the CPU**, where no allocator counts tensor bytes, the tagged
  storages are the total, and :func:`ledger` alone adds the foreign
  tensors it finds by walking the garbage collector's objects (an
  on-demand read: :func:`sample`, the seams, ``report()`` and
  ``utils.health.memory_report`` never walk the heap).

A replicated (``split=None``) array counts once per storage. On a mesh of
distinct devices that is the reference's one buffer per device; on a mesh
that repeats one device (the CPU mesh, four shards of one card) the shards
are one tensor and count once, where the reference, whose devices are
distinct, counts each.

Everything here is a read: nothing syncs the card, nothing initializes
CUDA (the allocator is read only once CUDA is initialized), and nothing
raises past a tensor that cannot name its storage.

* **The headroom admission gate** (:func:`admit`). The fusion recorder's
  dispatch seam checks the live total plus the program's static peak
  (computed from its GraphModule's node shapes, ``fusion._static_peak``)
  against ``HEAT_TPU_MEMORY_BUDGET``: bytes, a ``KiB``/``MiB``/``GiB``
  suffixed string, or a fraction in (0, 1] of the card's memory (the
  host's on the CPU). ``HEAT_TPU_MEMORY_POLICY`` picks what an overrun
  does: ``warn`` (once per program key), ``raise``
  (:class:`MemoryBudgetExceeded` before the dispatch, the chain left
  pending) or ``drain`` (force and wait for every other pending root, then
  check again and warn if still over). :func:`gate_stats` counts.
  :func:`admission_hold` refuses every new admission for a block, naming
  its reason (the chain stays pending), and :func:`gate_exempt` holds the
  gate open; the serving layer's token buckets compose before this gate.
* **OOM forensics** (:func:`is_oom`, :func:`record_oom`, :func:`last_oom`).
  A dispatch that dies of ``torch.cuda.OutOfMemoryError`` (or
  ``MemoryError``, or an injected ``memory.exhausted`` fault) gets a ranked
  diagnostic, the failing program's key and static peak, the top live
  buffers by owner and the last dispatches, as a
  :class:`MemoryExhaustedWarning` and a flight dump, before the guarded
  force degrades it.

The fusion recorder tags the results of a force ``fusion`` until a
``DNDarray`` claims them (``dndarray``).

"""

from __future__ import annotations

import gc
import os
import threading
import time
import warnings
import weakref
from contextlib import contextmanager
from typing import Any, Dict, List, Optional, Tuple

import torch

from . import telemetry

__all__ = [
    "MemoryBudgetExceeded",
    "MemoryBudgetWarning",
    "MemoryExhaustedWarning",
    "UNATTRIBUTED",
    "admission_hold",
    "admit",
    "budget_info",
    "current_owner",
    "gate_exempt",
    "gate_stats",
    "hold_info",
    "invalidate_resolved_budget",
    "is_oom",
    "last_oom",
    "ledger",
    "note",
    "owner_scope",
    "parse_budget",
    "record_oom",
    "reset",
    "reset_watermark",
    "sample",
    "set_budget",
    "set_enabled",
    "tag",
    "watermark",
]


class MemoryBudgetExceeded(MemoryError):
    """A dispatch refused by the headroom admission gate: the projected
    bytes exceed the memory budget. Raised before the program runs."""


class MemoryBudgetWarning(UserWarning):
    """The projected bytes of a dispatch exceed the memory budget under the
    ``warn`` policy (or still exceed it after a ``drain``)."""


class MemoryExhaustedWarning(UserWarning):
    """A dispatch died of device memory exhaustion; the warning carries the
    ranked forensic diagnostic."""


# ----------------------------------------------------------------------
# the owner registry: id(tensor) -> (weakref, owner)
# ----------------------------------------------------------------------
_REGISTRY: Dict[int, Tuple[Any, str]] = {}
#: reentrant: a weakref's death callback can fire on the thread that holds
#: the lock (a collection inside a store), and on any other thread
_LOCK = threading.RLock()

#: ambient owner of a tag without an explicit one; innermost wins
_OWNER_STACK: List[str] = []

#: the owner of every live buffer nobody tagged
UNATTRIBUTED = "unattributed"


def tag(t, owner: Optional[str] = None) -> None:
    """Attribute tensor ``t``'s storage to ``owner`` (or the innermost
    :func:`owner_scope`). The last tag wins. Anything but a tensor has no
    storage to account: a no-op."""
    if not isinstance(t, torch.Tensor):
        return
    if owner is None:
        owner = _OWNER_STACK[-1] if _OWNER_STACK else UNATTRIBUTED
    key = id(t)
    ref = weakref.ref(t, lambda r, key=key: _drop_entry(key, r))
    with _LOCK:
        _REGISTRY[key] = (ref, owner)


def _drop_entry(key: int, ref) -> None:
    with _LOCK:
        cur = _REGISTRY.get(key)
        if cur is not None and cur[0] is ref:
            del _REGISTRY[key]


def _owner_of(t) -> str:
    rec = _REGISTRY.get(id(t))
    if rec is not None and rec[0]() is t:
        return rec[1]
    return UNATTRIBUTED


@contextmanager
def owner_scope(owner: str):
    """Attribute every :func:`tag` without an explicit owner inside the
    block to ``owner``: the checkpoint restore wraps its ingest in
    ``owner_scope("checkpoint")``, so its staging pieces show up under
    their subsystem. Scopes nest; the innermost wins."""
    _OWNER_STACK.append(str(owner))
    try:
        yield
    finally:
        _OWNER_STACK.pop()


def current_owner() -> Optional[str]:
    """The innermost active :func:`owner_scope`, or None outside any."""
    return _OWNER_STACK[-1] if _OWNER_STACK else None


# ----------------------------------------------------------------------
# the live-buffer walk (shared by ledger, sample and utils.health)
# ----------------------------------------------------------------------
def _buffer_key(t) -> Optional[Tuple[str, int]]:
    """Dedupe key of the buffer under tensor ``t``: ``(device, storage
    pointer)``, so every view of one storage is one buffer. None for a
    tensor without a storage of its own (sparse, a functional wrapper)."""
    try:
        return (str(t.device), t.untyped_storage().data_ptr())
    except (RuntimeError, NotImplementedError, TypeError):
        return None


def _storage_bytes(t) -> int:
    try:
        return int(t.untyped_storage().nbytes())
    except (RuntimeError, NotImplementedError, TypeError):
        return 0


def _kind() -> str:
    """The device kind the ledger covers: the card once CUDA is in use,
    else the CPU."""
    return "cuda" if torch.cuda.is_initialized() else "cpu"


def _allocated() -> Dict[str, int]:
    """Each CUDA device's allocated bytes, from the caching allocator's
    host-side count (callers check that CUDA is initialized)."""
    out = {}
    for i in range(torch.cuda.device_count()):
        n = int(torch.cuda.memory_allocated(i))
        if n:
            out[f"cuda:{i}"] = n
    return out


def _tagged(kind: str) -> list:
    """The live tagged tensors of device kind ``kind`` with their owners,
    attributed owners first (the dedupe must let a tag win over a view
    tagged ``unattributed``, whatever the registry's order)."""
    with _LOCK:
        entries = [(ref(), owner) for ref, owner in _REGISTRY.values()]
    live = [(t, owner) for t, owner in entries if t is not None and t.device.type == kind]
    live.sort(key=lambda e: e[1] == UNATTRIBUTED)
    return live


def _dtype_name(dtype) -> str:
    return str(dtype).replace("torch.", "")


def _scan(top: int = 0, heap: bool = False, devices: Optional[set] = None) -> Dict[str, Any]:
    """One pass over the live buffers of the covered device kind: total
    bytes, bytes per owner and per device, the deduped buffer count and
    (``top`` > 0) the largest buffers. ``heap`` adds, on the CPU, the
    foreign tensors among the garbage collector's objects; ``devices``
    restricts the pass to those device names."""
    kind = _kind()
    out: Dict[str, Any] = {"total_bytes": 0, "by_owner": {}, "buffers": 0, "top": [], "per_device": {}}
    by_owner, per_device = out["by_owner"], out["per_device"]
    seen = set()
    largest: List[Tuple[int, str, tuple, str, str]] = []

    def claim(t, owner, counted: bool) -> None:
        key = _buffer_key(t)
        if key is None or key in seen or (devices is not None and key[0] not in devices):
            return
        seen.add(key)
        nbytes = _storage_bytes(t)
        out["buffers"] += 1
        if counted and nbytes:
            by_owner[owner] = by_owner.get(owner, 0) + nbytes
            per_device[key[0]] = per_device.get(key[0], 0) + nbytes
        if top:
            largest.append((nbytes, owner, tuple(int(d) for d in t.shape), _dtype_name(t.dtype), key[0]))

    for t, owner in _tagged(kind):
        # on the card an untagged buffer's bytes are the allocator's remainder
        claim(t, owner, counted=kind == "cpu" or owner != UNATTRIBUTED)
    if kind == "cuda":
        for dev, allocated in _allocated().items():
            if devices is not None and dev not in devices:
                continue
            rest = allocated - per_device.get(dev, 0)
            if rest > 0:
                by_owner[UNATTRIBUTED] = by_owner.get(UNATTRIBUTED, 0) + rest
                per_device[dev] = allocated
    elif heap:
        for obj in gc.get_objects():
            # type(), not isinstance(): some modules' objects warn on a
            # __class__ read
            if issubclass(type(obj), torch.Tensor) and obj.device.type == "cpu":
                claim(obj, UNATTRIBUTED, counted=True)
    out["total_bytes"] = sum(per_device.values())
    if top:
        largest.sort(key=lambda r: -r[0])
        out["top"] = [
            {"nbytes": n, "owner": o, "shape": list(sh), "dtype": dt, "device": dev}
            for n, o, sh, dt, dev in largest[:top]
        ]
    return out


def _scan_total() -> int:
    """The live total alone, without the owner split: the allocator's
    counts on the card (no walk at all), the tagged storages on the CPU.
    The sampling hook's fast path."""
    if _kind() == "cuda":
        return sum(_allocated().values())
    seen = set()
    total = 0
    for t, _ in _tagged("cpu"):
        key = _buffer_key(t)
        if key is not None and key not in seen:
            seen.add(key)
            total += _storage_bytes(t)
    return total


def ledger(top: int = 5) -> Dict[str, Any]:
    """The owner-attributed live-buffer ledger: ``total_bytes``, bytes per
    owner (``by_owner``) and per device (``per_device``), the deduped
    ``buffers`` count and the ``top`` largest buffers (owner, shape, dtype,
    device, bytes). A read: it never syncs and never initializes CUDA."""
    return _scan(top=max(0, int(top)), heap=True)


# ----------------------------------------------------------------------
# sampling and the high watermark
# ----------------------------------------------------------------------
_ENABLED = os.environ.get("HEAT_TPU_MEMORY_LEDGER", "1").strip().lower() not in telemetry._OFF_VALUES
_SAMPLE_EVERY_S = max(0.0, float(os.environ.get("HEAT_TPU_MEMORY_SAMPLE_MS", "20"))) / 1e3
_LAST_SAMPLE_TS = 0.0

_WATERMARK: Dict[str, Any] = {"bytes": 0, "by_owner": {}, "event": None, "samples": 0}
_WM_LOCK = threading.Lock()


def set_enabled(flag: bool) -> bool:
    """Turn the sampling hook on or off in-process (``HEAT_TPU_MEMORY_LEDGER``
    at import); returns the previous state. Tagging and :func:`ledger` work
    either way."""
    global _ENABLED
    prev, _ENABLED = _ENABLED, bool(flag)
    return prev


def sample(event: str = "manual", force: bool = False) -> Optional[Dict[str, Any]]:
    """Take one ledger sample, raise the high watermark if it is a new peak
    and, in verbose telemetry, emit a ``memory`` timeline event. Throttled
    to one sample per ``HEAT_TPU_MEMORY_SAMPLE_MS`` unless ``force``;
    returns the snapshot taken, or None when throttled or disabled.

    The hook's path pays for the total alone; the attributed walk runs when
    a new peak banks its owner split, when the caller forces the sample or
    in verbose mode (the counter tracks carry the owner split). No sample
    walks the heap."""
    global _LAST_SAMPLE_TS
    if not force:
        if not _ENABLED:
            return None
        now = time.perf_counter()
        if now - _LAST_SAMPLE_TS < _SAMPLE_EVERY_S:
            return None
    verbose = telemetry._MODE >= 2
    snap = _scan() if (force or verbose) else None
    total = snap["total_bytes"] if snap is not None else _scan_total()
    _LAST_SAMPLE_TS = time.perf_counter()
    if total > _WATERMARK["bytes"] and snap is None:
        snap = _scan()  # a new peak banks its owner split
    with _WM_LOCK:
        _WATERMARK["samples"] += 1
        if total > _WATERMARK["bytes"]:
            _WATERMARK["bytes"] = max(total, snap["total_bytes"])
            _WATERMARK["by_owner"] = dict(snap["by_owner"])
            _WATERMARK["event"] = event
        peak = _WATERMARK["bytes"]
    if verbose:
        telemetry.record_event(
            "memory", event=event, total=snap["total_bytes"], by_owner=dict(snap["by_owner"]), watermark=peak
        )
    if snap is not None:
        return snap
    return {"total_bytes": total, "by_owner": {}, "buffers": 0, "top": [], "per_device": {}}


def note(event: str) -> None:
    """The sampling hook of telemetry's record seams: one attribute read
    when disabled, throttled otherwise (the clock is read here, so that a
    throttled seam, nearly every one, makes no further call)."""
    if _ENABLED and time.perf_counter() - _LAST_SAMPLE_TS >= _SAMPLE_EVERY_S:
        sample(event)


def watermark() -> Dict[str, Any]:
    """The high watermark: the largest sampled total (``bytes``), its owner
    split, the event that set it and the number of samples taken. Module
    state only."""
    with _WM_LOCK:
        return {
            "bytes": _WATERMARK["bytes"],
            "by_owner": dict(_WATERMARK["by_owner"]),
            "event": _WATERMARK["event"],
            "samples": _WATERMARK["samples"],
        }


def reset_watermark() -> None:
    """Zero the watermark (a measured region is bracketed with this)."""
    with _WM_LOCK:
        _WATERMARK.update(bytes=0, by_owner={}, event=None, samples=0)


# ----------------------------------------------------------------------
# the headroom admission gate
# ----------------------------------------------------------------------
_UNITS = {
    "b": 1,
    "kb": 10**3, "mb": 10**6, "gb": 10**9, "tb": 10**12,
    "kib": 1 << 10, "mib": 1 << 20, "gib": 1 << 30, "tib": 1 << 40,
    # a bare letter reads as binary: "2G" is memory
    "k": 1 << 10, "m": 1 << 20, "g": 1 << 30, "t": 1 << 40,
}


def parse_budget(value) -> Optional[object]:
    """A budget spec: None or an off word disarms; an int, or a suffixed
    string such as ``"512MiB"``, is bytes; a float in (0, 1] is a fraction
    of the card's memory (the host's without CUDA), resolved at the first
    gate check. Returns int bytes, a float fraction or None."""
    if value is None:
        return None
    if isinstance(value, bool):
        raise ValueError("memory budget must be bytes or a fraction, not a bool")
    if isinstance(value, (int, float)):
        if isinstance(value, float) and 0.0 < value <= 1.0:
            return float(value)
        if value <= 0:
            return None
        return int(value)
    text = str(value).strip().lower()
    if text in telemetry._OFF_VALUES:
        return None
    for unit in sorted(_UNITS, key=len, reverse=True):
        if text.endswith(unit) and text[: -len(unit)].strip():
            return int(float(text[: -len(unit)].strip()) * _UNITS[unit])
    num = float(text)
    if 0.0 < num <= 1.0:
        return num
    if num <= 0:
        return None
    return int(num)


_POLICIES = ("warn", "raise", "drain")


def _parse_env_budget(value) -> Optional[object]:
    """:func:`parse_budget` of the knob: a malformed value warns and
    disarms instead of making the import raise."""
    try:
        return parse_budget(value)
    except (ValueError, TypeError):
        warnings.warn(
            f"HEAT_TPU_MEMORY_BUDGET={value!r} is not parseable (bytes, a KiB/MiB/GiB-suffixed "
            "string, or a 0-1 fraction); the admission gate stays disarmed",
            stacklevel=1,
        )
        return None


#: the armed budget (int bytes, float fraction or None): the dispatch seam
#: gates on it with one attribute read
_BUDGET_RAW = _parse_env_budget(os.environ.get("HEAT_TPU_MEMORY_BUDGET"))
_POLICY = os.environ.get("HEAT_TPU_MEMORY_POLICY", "warn").strip().lower() or "warn"
if _POLICY not in _POLICIES:
    warnings.warn(f"HEAT_TPU_MEMORY_POLICY={_POLICY!r} is not one of {_POLICIES}; using 'warn'", stacklevel=1)
    _POLICY = "warn"

#: a fractional budget resolved to bytes at the first gate check
_RESOLVED_BUDGET: Optional[int] = None

_GATE_STATS = {
    "checks": 0, "allowed": 0, "exceeded": 0, "drains": 0, "drained_roots": 0, "warned": 0, "raised": 0, "held": 0,
}
_WARNED_KEYS: set = set()

#: set while a drain forces other roots: their forces are the freeing, not
#: new admissions
_IN_GATE = False

#: the reason of an active :func:`admission_hold`: while set, every new
#: fused-dispatch admission is refused, naming it
_HOLD: Optional[str] = None


@contextmanager
def admission_hold(reason: str):
    """Refuse every new fused-dispatch admission for the block:
    :func:`admit` raises :class:`MemoryBudgetExceeded` naming ``reason``
    and the refused chain stays pending, to dispatch after the release (the
    budget's ``raise`` policy). The forces of a drain and of a
    :func:`gate_exempt` block pass: they are the draining, not new work."""
    global _HOLD
    prev, _HOLD = _HOLD, str(reason)
    try:
        yield
    finally:
        _HOLD = prev


@contextmanager
def gate_exempt():
    """Run the block with the gate held open: every :func:`admit` inside
    returns at once."""
    global _IN_GATE
    prev, _IN_GATE = _IN_GATE, True
    try:
        yield
    finally:
        _IN_GATE = prev


def hold_info() -> Optional[str]:
    """The active admission hold's reason, or None."""
    return _HOLD


def invalidate_resolved_budget() -> None:
    """Drop the resolved bytes of a fractional budget: the next gate check
    resolves it against the devices of the mesh then."""
    global _RESOLVED_BUDGET
    _RESOLVED_BUDGET = None


def set_budget(budget=None, policy: Optional[str] = None):
    """Arm the gate in-process: ``budget`` as :func:`parse_budget` takes it
    (None disarms), ``policy`` one of ``warn``/``raise``/``drain``. Returns
    the previous ``(budget, policy)``; clears the once-per-key warnings and
    the resolved fraction."""
    global _BUDGET_RAW, _POLICY, _RESOLVED_BUDGET
    prev = (_BUDGET_RAW, _POLICY)
    _BUDGET_RAW = parse_budget(budget)
    if policy is not None:
        if policy not in _POLICIES:
            raise ValueError(f"policy must be one of {_POLICIES}, got {policy!r}")
        _POLICY = policy
    _RESOLVED_BUDGET = None
    _WARNED_KEYS.clear()
    return prev


def _device_bytes_limit() -> Optional[int]:
    """The card's memory over the CUDA devices in use, or None before CUDA
    is initialized (the gate never initializes it)."""
    if not torch.cuda.is_initialized():
        return None
    try:
        totals = [torch.cuda.get_device_properties(i).total_memory for i in range(torch.cuda.device_count())]
    except (RuntimeError, AssertionError):
        return None
    return min(totals) * len(totals) if totals else None


def _host_bytes_total() -> Optional[int]:
    try:
        return int(os.sysconf("SC_PAGE_SIZE")) * int(os.sysconf("SC_PHYS_PAGES"))
    except (ValueError, OSError, AttributeError):
        return None


def _resolve_budget() -> Optional[int]:
    global _RESOLVED_BUDGET
    if _BUDGET_RAW is None:
        return None
    if isinstance(_BUDGET_RAW, int):
        return _BUDGET_RAW
    if _RESOLVED_BUDGET is None:
        base = _device_bytes_limit() or _host_bytes_total()
        if base is None:
            return None
        _RESOLVED_BUDGET = int(_BUDGET_RAW * base)
    return _RESOLVED_BUDGET


def budget_info(resolve: bool = False) -> Dict[str, Any]:
    """The gate's knob, resolved bytes (None while disarmed, or a fraction
    not yet resolved: the report never probes the card), policy and
    :func:`gate_stats`."""
    if _BUDGET_RAW is None:
        budget_bytes = None
    elif isinstance(_BUDGET_RAW, int):
        budget_bytes = _BUDGET_RAW
    elif resolve or _RESOLVED_BUDGET is not None:
        budget_bytes = _resolve_budget()
    else:
        budget_bytes = None
    return {"budget": _BUDGET_RAW, "budget_bytes": budget_bytes, "policy": _POLICY, **gate_stats()}


def gate_stats() -> Dict[str, int]:
    """The gate's counters: ``checks``, ``allowed``, ``exceeded``, the
    policies' outcomes ``warned``, ``raised``, ``drains``,
    ``drained_roots``, and ``held``, the refusals of an admission hold."""
    return dict(_GATE_STATS)


def admit(program: str, family: str, static_peak: int, source: str, drain_fn=None) -> None:
    """The headroom check at the fused-program dispatch seam: live bytes
    plus ``static_peak`` against the budget. Within it: returns. Over it:
    the policy acts (module docstring). The forces of a drain pass; an
    active :func:`admission_hold` refuses whatever the budget."""
    global _IN_GATE
    if _IN_GATE:
        return
    if _HOLD is not None:
        _GATE_STATS["held"] += 1
        raise MemoryBudgetExceeded(
            f"dispatch admission held ({_HOLD}) for program {program} ({family}) — the chain is left "
            "pending and dispatches once the hold lifts"
        )
    if _BUDGET_RAW is None:
        return
    budget = _resolve_budget()
    if budget is None:
        return
    _GATE_STATS["checks"] += 1
    live = _scan_total()
    if live > _WATERMARK["bytes"]:
        sample("gate", force=True)
    projected = live + int(static_peak)
    if projected <= budget:
        _GATE_STATS["allowed"] += 1
        return
    _GATE_STATS["exceeded"] += 1
    policy = _POLICY
    drained = None
    if policy == "drain" and drain_fn is not None:
        _GATE_STATS["drains"] += 1
        _IN_GATE = True
        try:
            drained = int(drain_fn() or 0)
        finally:
            _IN_GATE = False
        _GATE_STATS["drained_roots"] += drained
        live = _scan_total()
        projected = live + int(static_peak)
    if telemetry._MODE >= 2:
        telemetry.record_event(
            "memory_gate", program=program, policy=policy, projected=projected, live=live,
            static_peak=int(static_peak), budget=budget, drained=drained, over=projected > budget,
        )
    if projected <= budget:
        _GATE_STATS["allowed"] += 1
        return
    if policy != "raise" and program in _WARNED_KEYS:
        return
    snap = _scan()
    owners = ", ".join(f"{o} {_fmt_bytes(b)}" for o, b in sorted(snap["by_owner"].items(), key=lambda kv: -kv[1])[:4])
    msg = (
        f"memory budget {_fmt_bytes(budget)} exceeded: projected {_fmt_bytes(projected)} (live "
        f"{_fmt_bytes(live)} + static peak {_fmt_bytes(static_peak)} [{source}]) for program "
        f"{program} ({family}); top live owners: {owners or 'none'}"
    )
    if policy == "raise":
        _GATE_STATS["raised"] += 1
        raise MemoryBudgetExceeded(
            msg + " — the chain is left pending; lift the budget (memledger.set_budget) or free "
            "buffers, then force again"
        )
    if program not in _WARNED_KEYS:
        _WARNED_KEYS.add(program)
        _GATE_STATS["warned"] += 1
        suffix = f" — drained {drained} outstanding root(s), still over budget" if policy == "drain" else ""
        warnings.warn(MemoryBudgetWarning(msg + suffix), stacklevel=5)


# ----------------------------------------------------------------------
# OOM forensics
# ----------------------------------------------------------------------
_OOM_MARKERS = ("resource_exhausted", "resource exhausted", "out of memory", "memory.exhausted")

_LAST_OOM: Optional[Dict[str, Any]] = None


def is_oom(exc: BaseException) -> bool:
    """Whether ``exc`` is memory exhaustion: ``torch.cuda.OutOfMemoryError``,
    ``MemoryError``, an allocator error naming it, or an injected
    ``memory.exhausted`` fault (its message names the site)."""
    oom_type = getattr(torch.cuda, "OutOfMemoryError", None)
    if isinstance(exc, MemoryError) or (oom_type is not None and isinstance(exc, oom_type)):
        return True
    text = (type(exc).__name__ + ": " + str(exc)).lower()
    return any(marker in text for marker in _OOM_MARKERS)


def record_oom(
    exc: BaseException,
    program: Optional[str] = None,
    family: Optional[str] = None,
    static_peak: Optional[int] = None,
    top: int = 5,
) -> Dict[str, Any]:
    """Build, keep and warn the ranked diagnostic of a dispatch that died of
    memory exhaustion: the program's key, family and static peak, the live
    buffers by owner and the largest, the last dispatches of the timeline
    and the gate's state; then dump the flight ring. The fusion recorder
    calls it before the guarded replay churns the evidence."""
    global _LAST_OOM
    led = ledger(top=top)
    recent = [
        {"program": ev.get("program"), "roots": ev.get("roots"), "ts": ev.get("ts")}
        for ev in telemetry.events()
        if ev.get("kind") == "dispatch"
    ][-5:]
    report = {
        "error": repr(exc),
        "program": program,
        "family": family,
        "static_peak_bytes": None if static_peak is None else int(static_peak),
        "live_total_bytes": led["total_bytes"],
        "by_owner": dict(led["by_owner"]),
        "top_buffers": list(led["top"]),
        "recent_dispatches": recent,
        "watermark_bytes": _WATERMARK["bytes"],
        "budget": budget_info(),
    }
    _LAST_OOM = report
    if telemetry._MODE:
        telemetry.record_event("memory_oom", program=program, family=family, error=repr(exc), live=led["total_bytes"])
    owners = ", ".join(f"{o} {_fmt_bytes(b)}" for o, b in sorted(led["by_owner"].items(), key=lambda kv: -kv[1])[:4])
    tops = "; ".join(f"{_fmt_bytes(b['nbytes'])} {b['owner']} {b['dtype']}{b['shape']}" for b in led["top"][:3])
    peak = "unknown" if static_peak is None else _fmt_bytes(static_peak)
    warnings.warn(
        MemoryExhaustedWarning(
            f"device memory exhausted dispatching program {program or '<eager>'} ({family or '?'}; "
            f"static peak {peak}): {exc!r}. Live buffers {_fmt_bytes(led['total_bytes'])} by owner: "
            f"{owners or 'none'}. Largest: {tops or 'none'}. Full diagnostic via memledger.last_oom(); "
            "the chain degrades to per-op eager replay"
        ),
        stacklevel=5,
    )
    from . import health_runtime

    health_runtime.auto_dump("oom")
    return report


def last_oom() -> Optional[Dict[str, Any]]:
    """The last OOM diagnostic, or None."""
    return _LAST_OOM


def _fmt_bytes(n) -> str:
    try:
        n = float(n)
    except (TypeError, ValueError):
        return str(n)
    for unit in ("B", "KiB", "MiB", "GiB", "TiB"):
        if abs(n) < 1024.0 or unit == "TiB":
            return f"{int(n)} B" if unit == "B" else f"{n:.1f} {unit}"
        n /= 1024.0
    return f"{n:.1f} TiB"  # pragma: no cover - the loop returns


def reset() -> None:
    """Zero the session state: the watermark, the gate's counters and
    warnings, the last OOM diagnostic. The registry stays, since it tracks
    live tensors, not a session."""
    global _LAST_OOM
    reset_watermark()
    for k in _GATE_STATS:
        _GATE_STATS[k] = 0
    _WARNED_KEYS.clear()
    _LAST_OOM = None


# the sampling hook, installed on telemetry by attribute (telemetry stays
# importable before this module)
telemetry._MEM_HOOK = note
