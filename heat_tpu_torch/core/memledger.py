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

Not here yet: the headroom admission gate, the budget and its knobs, and
OOM forensics come with the fusion recorder, whose dispatch seam acts on
them; the admission hold and the gate exemption come with autoscale and
elastic. :class:`MemoryBudgetExceeded`, :class:`MemoryBudgetWarning` and
:class:`MemoryExhaustedWarning` are the classes those seams raise and warn.
"""

from __future__ import annotations

import gc
import os
import threading
import time
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
    "current_owner",
    "ledger",
    "note",
    "owner_scope",
    "reset",
    "reset_watermark",
    "sample",
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
    when disabled, throttled otherwise."""
    if _ENABLED:
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


def reset() -> None:
    """Zero the session state, the watermark; the registry stays, since it
    tracks live tensors, not a session."""
    reset_watermark()


# the sampling hook, installed on telemetry by attribute (telemetry stays
# importable before this module)
telemetry._MEM_HOOK = note
