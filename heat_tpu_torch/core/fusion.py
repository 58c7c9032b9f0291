"""The eager fusion recorder and its program cache (reference:
heat_tpu/core/fusion.py).

The four engines of ``core/_operations.py`` defer: an elementwise,
broadcast, cast, reduction or cumulative op records a node of an
expression DAG (:class:`LazyArray`, stored as the ``DNDarray``'s shard
list) instead of running, and the whole chain runs as ONE cached program at
a *forcing point*: a read of the shards (``shards``, ``parray``,
``larray``, ``lshards``, ``numpy()``, ``item()``, printing, I/O, indexing,
``out=`` buffers and the eager fallbacks; with the collective nodes off,
``resplit_`` and the other collectives too).

A node stands for all p shards of a value: its ``shape`` and ``dtype`` are
one physical shard's, its ``width`` is the number of shard tensors (p for a
split value, 1 for a replicated value, which is computed once on the mesh's
first device as the eager engines do). Identical-layout chains compute on
the physical shards, so padding stays in the padding; a reduction across
the split axis cuts each shard to its valid rows and combines the partials
in shard order inside the program, exactly as the eager engine's
``_across_split`` does. The recorder defers only on a mesh whose shards lie
on one device (the CPU mesh, a card's mesh): a program does not span
devices.

**A program.** A structural signature (op identities, topology, static
arguments, each leaf's width, shape, dtype, device, strides) keys an LRU of
programs. :func:`_build` emits the signature as a ``torch.fx.GraphModule``,
each op one ``call_function`` per shard in the eager engines' order. On the
CPU that module runs as it is: the program's plain version, so a fused
result equals the fusion-off result bit for bit. On CUDA leaves it runs
through ``torch.compile(gm, fullgraph=True, dynamic=False)`` (Inductor,
which fuses the chain into a few Triton kernels), compiled at its first
call; on CUDA leaves a program of more than one op never runs the plain
module (see **On a card** for one op). Each program is its own
GraphModule with its own code object, so Dynamo's per-code cache holds one
entry per program; the compile runs with errors unsuppressed and the
recompile limit an error (for that call only: other compiled code in the
process keeps its settings), so a failed build degrades visibly instead of
running eagerly in silence.

**On a card** the recorder skips what it cannot speed up: an op whose
array operands are all concrete and hold fewer than
:data:`_EAGER_BELOW_BYTES` together runs eagerly (``small_on_card``: the
host sets the pace there), and a program of one op runs its plain module,
the eager op, since it has nothing to fuse and a build costs seconds.

**Writes.** torch tensors are mutable where the reference's buffers are
not: an array's in-place write (``__setitem__``, ``fill_diagonal``) first
forces the live chains that read its storage (:func:`release`), and a
chain whose input was written behind the array's back refuses to run
(:class:`ChainInputWrittenError`).

**Forcing** installs the program's result tensors and never reads device
data: only the host boundaries (``item()``, ``numpy()``, printing, I/O)
wait on the card. :data:`_FORCE_LOCK` serializes forces (Dynamo is not
safe for concurrent compiles).

**Guarded forcing.** A program that fails to build, compile or run
(injectable at ``fusion.compile``, ``fusion.execute`` and
``memory.exhausted``) degrades to op-by-op replay of the plain module (the
eager result), records a ``degraded`` event, quarantines the signature and
auto-dumps the flight ring; a memory exhaustion first writes the OOM
forensic (``memledger.record_oom``). ``ht.errstate`` applies to the forced
value either way, at the ``DNDarray`` seam, on the logical extent.

**Memory.** Results are tagged ``fusion`` in the ledger until a wrapper
claims them (then ``dndarray``). With ``HEAT_TPU_MEMORY_BUDGET`` armed the
gate (``memledger.admit``) compares live bytes plus the program's static
peak with the budget before the dispatch. torch has no
``memory_analysis``: the static peak and :func:`program_costs` come from
the GraphModule's node shapes (meta tensors): bytes are the leaves plus the
outputs plus the intermediates live at the worst point of the op order, an
upper bound on what the fused program holds; flops come from a per-op
table (one per output element for elementwise ops, one per input element
for reductions). :func:`program_audit_info` adds, per program, the bytes
each op reads and writes on one rank, the same with every leaf whole on
every rank, and the collective nodes with their wire bytes: what
``analysis/audit.py`` checks.

**Collective nodes.** A collective of a pending chain records a node
instead of forcing the chain: a resplit (:func:`defer_reshard`: the
logical whole gathered, then cut into the new split's blocks by the eager
``resplit_``'s own functions), a schedule over the shard list with its
verbs (:func:`defer_apply`: the eager schedule's own code over shard
views, its verbs the shard-order arithmetic of
:class:`~.communication.MeshCommunication` without their telemetry and
fault sites), a multi-output kernel (:func:`defer_multi`; one node,
whose outputs :func:`record_multi`'s selectors pick, runs once in the
program) and a 2-D matmul (:func:`defer_matmul`, the eager case table's
per-shard products and combine order). Each is counted at record time
(``telemetry.record_fused_collective``); its fault site fires at record
time, before any metadata changes. :func:`program_hlo` gives a pending
chain's program text without forcing it.

**Batching.** A force takes other live pending roots into the same
program (:func:`_gather_batch`): in registration order, at most
:data:`_BATCH_MAX`, each of at most :data:`_BATCH_BYTES` (a selector whose
kernel is already in the program rides along at any size), never one
interior to the program, on another mesh, or while torch traces. Reading
the three moments of one array is one dispatch.

**The serving layer and the numerics lens** (``core/serving.py``,
``core/numlens.py``) set seams here, each one ``is None`` test while unset:
a node records the session of its thread, a top-level :func:`force` sleeps
the cross-session batch window and passes the admission gate before it
takes the lock (a recursive force passes both), the persistent index turns
a known program key's miss into a ``disk_hit``, each dispatch bills its
sessions, and the lens reads the values a program landed.

Knobs: ``HEAT_TPU_FUSION=0`` turns recording off (the eager engines run
exactly as before; pending nodes still force),
``HEAT_TPU_FUSION_COLLECTIVES=0`` turns the collective nodes and the
batching off (a collective forces the chain, a force runs one root),
``HEAT_TPU_FUSION_BATCH`` (roots per batch, 16) and
``HEAT_TPU_FUSION_BATCH_BYTES`` (the largest root batched, 16384),
``HEAT_TPU_FUSION_MAX_CHAIN`` (deeper chains force their pending children
first), ``HEAT_TPU_FUSION_CACHE`` (programs kept) and
``HEAT_TPU_FUSION_QUARANTINE`` (signatures kept in quarantine).
"""

from __future__ import annotations

import functools
import hashlib
import itertools
import math
import operator
import os
import threading
import time
import warnings
import weakref
from collections import OrderedDict
from contextlib import contextmanager
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.fx

from . import health_runtime, memledger, resilience, telemetry
from .communication import MeshCommunication, _combine, _exscan

__all__ = [
    "ChainInputWrittenError",
    "LazyArray",
    "ProgramCostWarning",
    "active",
    "cache_stats",
    "cast",
    "clear_cache",
    "clear_quarantine",
    "collectives_active",
    "collectives_disabled",
    "cost_error_count",
    "defer_apply",
    "defer_matmul",
    "defer_multi",
    "defer_reshard",
    "disabled",
    "force",
    "is_deferred",
    "phys_node",
    "program_audit_info",
    "program_costs",
    "program_hlo",
    "programs",
    "record",
    "record_multi",
    "register_root",
    "release",
    "set_collectives_enabled",
    "set_enabled",
    "wrap_node",
]


class ProgramCostWarning(UserWarning):
    """A cached program's cost estimate failed (the estimate carries
    ``cost["error"]``); failures count into
    ``report()["programs"]["cost_errors"]`` and warn once per session."""


_OFF_VALUES = ("0", "false", "off", "no")

#: recording past this chain depth forces the pending children first, so a
#: loop that never reads its result cannot grow one program without bound
_MAX_CHAIN = int(os.environ.get("HEAT_TPU_FUSION_MAX_CHAIN", "128"))
_CACHE_SIZE = int(os.environ.get("HEAT_TPU_FUSION_CACHE", "512"))
#: signatures whose program failed once stay quarantined (replayed op by
#: op, never compiled again) up to this many
_QUARANTINE_SIZE = int(os.environ.get("HEAT_TPU_FUSION_QUARANTINE", "256"))

#: the escape hatch, read once at import; in-process through
#: :func:`set_enabled`/:func:`disabled`
_ENABLED = os.environ.get("HEAT_TPU_FUSION", "1").lower() not in _OFF_VALUES

#: the collective nodes and the batching of live roots; with them off a
#: collective forces the chain and a force runs its one root
_COLLECTIVES = os.environ.get("HEAT_TPU_FUSION_COLLECTIVES", "1").lower() not in _OFF_VALUES

#: a force batches at most this many roots, each of at most this many bytes
#: (a large disjoint root keeps its own dispatch: batching it would write an
#: output nobody asked for yet)
_BATCH_MAX = int(os.environ.get("HEAT_TPU_FUSION_BATCH", "16"))
_BATCH_BYTES = int(os.environ.get("HEAT_TPU_FUSION_BATCH_BYTES", "16384"))


def active() -> bool:
    """Whether the recorder is on (``HEAT_TPU_FUSION``, read at import)."""
    return _ENABLED


def set_enabled(flag: bool) -> bool:
    """Turn the recorder on or off in-process; returns the previous state."""
    global _ENABLED
    prev, _ENABLED = _ENABLED, bool(flag)
    return prev


@contextmanager
def disabled():
    """Run the block with recording off (the eager engines)."""
    prev = set_enabled(False)
    try:
        yield
    finally:
        set_enabled(prev)


def collectives_active() -> bool:
    """Whether collectives record nodes and forces batch live roots
    (``HEAT_TPU_FUSION_COLLECTIVES``, read at import; the recorder on)."""
    return _ENABLED and _COLLECTIVES


def set_collectives_enabled(flag: bool) -> bool:
    """Turn the collective nodes and the batching on or off in-process;
    returns the previous state."""
    global _COLLECTIVES
    prev, _COLLECTIVES = _COLLECTIVES, bool(flag)
    return prev


@contextmanager
def collectives_disabled():
    """Run the block with the collective nodes and the batching off: every
    collective forces its chain."""
    prev = set_collectives_enabled(False)
    try:
        yield
    finally:
        set_collectives_enabled(prev)


#: correlation ids: a fresh chain takes the next one at record time and the
#: nodes recorded onto a pending chain inherit it, so one chain's record,
#: dispatch and blocking sync share a cid on the trace timeline
_CID_SEQ = itertools.count(1)


class LazyArray:
    """One recorded node of the expression DAG.

    ``children`` are other nodes or leaves (a tuple of shard tensors);
    ``kw`` is the sorted tuple of static arguments baked into the program.
    ``shape``/``dtype`` describe one physical shard of the result, inferred
    on meta tensors at record time; ``width`` is the number of shard
    tensors. ``cid`` is the chain's correlation id, ``program`` the key of
    the program that produced the value (None while pending or after a
    degraded replay) and ``_value`` the tuple of shard tensors once forced.
    ``session`` names the serving session the node was recorded under (None
    outside one), so a batch of several sessions' roots bills each its own;
    ``extent`` is the ``(gshape, split)`` of the array that holds the node
    (None for an interior node), which tells the numerics lens the logical
    elements from the padding.
    """

    __slots__ = (
        "fn", "children", "kw", "shape", "dtype", "width", "depth", "cid", "program", "session", "extent", "_value",
    )

    def __init__(self, fn, children, kw, shape, dtype, width, depth, cid=0):
        self.fn = fn
        self.children = children
        self.kw = kw
        self.shape = shape
        self.dtype = dtype
        self.width = width
        self.depth = depth
        self.cid = cid
        self.program = None
        self.session = None
        self.extent = None
        self._value = None

    @property
    def ndim(self) -> int:
        return len(self.shape)

    def astype(self, dtype) -> "LazyArray":
        """A deferred cast."""
        return cast(self, dtype)

    def __repr__(self) -> str:
        state = "forced" if self._value is not None else f"depth={self.depth}"
        return f"LazyArray({_name(self.fn)}, shape={self.shape}, dtype={self.dtype}, width={self.width}, {state})"


def _name(fn) -> str:
    return getattr(fn, "__name__", None) or type(fn).__name__


class _Leaf(tuple):
    """A leaf: the shard tensors a chain reads, with their version counters
    (``versions``) when the chain took them; a force refuses a chain whose
    leaf was written in place since (see **Writes** above)."""


def _leaf(tensors) -> _Leaf:
    leaf = _Leaf(tensors)
    leaf.versions = tuple(t._version for t in leaf)
    return leaf


class ChainInputWrittenError(RuntimeError):
    """A pending chain's input was written in place after the chain was
    recorded, bypassing the array: its result can no longer be computed."""


def _whole(fn):
    """Mark ``fn`` as an op over whole shard lists: it is called once with
    one tuple of shard tensors per child and returns a tuple of results
    (the layout ops below); every other op is called once per shard."""
    fn._fusion_whole = True
    return fn


# ----------------------------------------------------------------------
# the node ops: per-shard ops and the layout ops over whole shard lists
# ----------------------------------------------------------------------
def _astype_op(t, *, dtype):
    return t.to(dtype)


def _reduce_op(t, *, reduction, axes, keepdims):
    # a reduction whose inputs lie in one shard: each shard reduces alone
    return (reduction.direct or reduction.local)(t, axes, keepdims)


def _cum_op(t, *, operation, axis):
    return operation(t, axis)


@_whole
def _unpad_op(shards, *, axis, counts):
    """The mask step of pad+mask: each shard cut to its valid rows (the
    shards then differ in length; the node's shape is the first one's, a
    full block, and only the across-split reduction reads it)."""
    return tuple(s.narrow(axis, 0, c) for s, c in zip(shards, counts))


_unpad_op._fusion_ragged = True


@_whole
def _gather_op(shards, *, axis, size):
    """The logical whole of a split value on the first device (the eager
    ``larray``): the shards concatenated, the padding cut off."""
    whole = shards[0] if len(shards) == 1 else torch.cat(list(shards), dim=axis)
    if whole.shape[axis] != size:
        whole = whole.narrow(axis, 0, size)
    return (whole,)


@_whole
def _blocks_op(whole, *, axis, devices):
    """A logical whole cut into the pad+mask blocks of the mesh's shards,
    by the eager engines' own ``_distribute``."""
    return tuple(_distribute(whole[0], axis, _ProgramComm(devices)))


class _ProgramComm(MeshCommunication):
    """The mesh a schedule sees inside a program: the verbs' shard-order
    arithmetic of :class:`~.communication.MeshCommunication`, without their
    telemetry and fault sites (the program records none; the recorder
    counts its collective nodes at record time)."""

    _records = False

    def __init__(self, devices):
        self._devices = tuple(devices)
        self.rank = 0


class _ShardView:
    """What a schedule reads of a ``DNDarray`` (``shards``, ``lshards``,
    ``larray``, ``gshape``, ``split``, ``counts_displs()``, ``padded``,
    ``comm``), over the shard tensors of a program. A replicated value has
    one tensor, which every shard shares, as the eager array's shards do."""

    def __init__(self, shards, gshape, split, comm):
        self._shards = list(shards)
        self.gshape = self.shape = tuple(gshape)
        self.ndim = len(self.gshape)
        self.split = split
        self.comm = comm

    @property
    def shards(self):
        if self.split is None and len(self._shards) == 1:
            return self._shards * self.comm.size
        return list(self._shards)

    def counts_displs(self):
        return self.comm.counts_displs_shape(self.gshape, self.split)

    def is_distributed(self) -> bool:
        return self.split is not None and self.comm.is_distributed()

    @property
    def padded(self) -> bool:
        s = self.split
        return s is not None and self._shards[0].shape[s] * self.comm.size != self.gshape[s]

    @property
    def lshards(self):
        if self.split is None:
            return self.shards
        return [s.narrow(self.split, 0, c) for s, c in zip(self._shards, self.counts_displs()[0])]

    @property
    def larray(self):
        """The logical whole on the first device, as ``DNDarray.larray``."""
        shards, split = self._shards, self.split
        if split is None or len(shards) == 1:
            whole = shards[0]
        else:
            first = self.comm.devices[0]
            whole = torch.cat([t.to(first) for t in shards], dim=split)
        if split is not None and whole.shape[split] != self.gshape[split]:
            whole = whole.narrow(split, 0, self.gshape[split])
        return whole


@_whole
def _across_op(shards, *, reduction, across, axes, keepdims, gshape, split, devices, out_shape):
    """A reduction over axes that include the split axis: the reduction's
    across-split schedule on the shards' valid rows, partials combined in
    shard order; the result lies on the first device."""
    total = across(_ShardView(shards, gshape, split, _ProgramComm(devices)), axes, reduction)
    if not keepdims:
        total = total.reshape(out_shape)
    return (total,)


@_whole
def _cum_split_op(shards, *, operation, combine, axis, devices):
    """A cumulative op along the split axis: each shard's local scan
    combined with the exclusive scan of the shards' last rows."""
    out = [operation(s, axis) for s in shards]
    last = out[0].shape[axis] - 1
    offsets = _exscan([s.narrow(axis, last, 1) for s in out], combine, devices)
    fn = _combine(combine)
    return tuple(fn(s, o) for s, o in zip(out, offsets))


def _pick_op(t, *, i):
    """Output ``i`` of a multi-output node (:func:`record_multi`): the
    kernel runs once in the program, each selector reads one output."""
    return t[i]


def _run_kernel(shard_lists, kernel, metas, devices, kw):
    comm = _ProgramComm(devices)
    views = [_ShardView(s, g, sp, comm) for s, (g, sp) in zip(shard_lists, metas)]
    return kernel(*views, comm=comm, **dict(kw))


@_whole
def _apply_op(*shard_lists, kernel, metas, devices, kw):
    """A schedule over the shard list (:func:`defer_apply`): ``kernel``
    over one shard view per operand, the program's mesh as ``comm``; it
    returns the result's shard list."""
    return tuple(_run_kernel(shard_lists, kernel, metas, devices, kw))


@_whole
def _apply_multi_op(*shard_lists, kernel, metas, devices, kw):
    """:func:`_apply_op` of a kernel that returns several shard lists."""
    return tuple(tuple(o) for o in _run_kernel(shard_lists, kernel, metas, devices, kw))


_apply_multi_op._fusion_multi = True


# ----------------------------------------------------------------------
# recording
# ----------------------------------------------------------------------
def _aval(c) -> Tuple[int, Tuple[int, ...], torch.dtype]:
    """(width, shard shape, dtype) of a node or a leaf."""
    if isinstance(c, LazyArray):
        return c.width, c.shape, c.dtype
    return len(c), tuple(c[0].shape), c[0].dtype


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


@functools.lru_cache(maxsize=8192)
def _infer_cached(fn, child_avals, kw, width):
    """Abstract (shape, dtype, width) of a node, from one run of its op on
    meta tensors: the op is never executed on data at record time (a
    per-shard op also runs once on one-element CPU tensors of the same
    dtypes). A failure reads as "cannot record" (``NotImplementedError``),
    and the eager engine runs the op instead."""
    kw_d = _meta_kw(dict(kw))
    try:
        if getattr(fn, "_fusion_whole", False):
            outs = fn(*[tuple(_meta(s, d) for _ in range(w)) for w, s, d in child_avals], **kw_d)
            ragged = getattr(fn, "_fusion_ragged", False)
            if not outs or any(
                (not ragged and tuple(o.shape) != tuple(outs[0].shape)) or o.dtype != outs[0].dtype for o in outs
            ):
                raise NotImplementedError(f"{_name(fn)} gave shards of unequal shapes")
            return tuple(outs[0].shape), outs[0].dtype, len(outs)
        out = fn(*[_meta(s, d) for _, s, d in child_avals], **kw_d)
    except RuntimeError as exc:
        raise NotImplementedError(f"{_name(fn)} does not run on meta tensors: {exc}") from exc
    try:
        # meta kernels check shapes, not dtypes: one run on CPU tensors of
        # one element each raises what a kernel raises for a dtype it does
        # not support, so the eager engine raises it at the call, as the
        # reference raises it at record time
        fn(*[torch.ones((1,) * len(s), dtype=d) for _, s, d in child_avals], **kw_d)
    except Exception as exc:  # noqa: BLE001 - any failure: the eager engine reproduces it
        raise NotImplementedError(f"{_name(fn)} does not run on {[d for _, _, d in child_avals]}: {exc}") from exc
    if not isinstance(out, torch.Tensor):
        raise TypeError(f"{_name(fn)} does not return one tensor")
    return tuple(out.shape), out.dtype, width


def _join(children, kw) -> tuple:
    """What a new node takes from its children: the children (pending ones
    forced first past :data:`_MAX_CHAIN`), the sorted static arguments, the
    node's depth and its chain's correlation id (a pending child's, else a
    fresh one)."""
    if resilience._ARMED:
        resilience.check("fusion.record")
    kw_t = tuple(sorted(kw.items()))
    depth = 1 + max((c.depth for c in children if isinstance(c, LazyArray) and c._value is None), default=0)
    if depth > _MAX_CHAIN:
        children = tuple(force(c) if isinstance(c, LazyArray) and c._value is None else c for c in children)
        depth = 1
    cid = 0
    for c in children:
        if isinstance(c, LazyArray) and c._value is None:
            cid = c.cid  # join the pending chain
            break
    if not cid:
        cid = next(_CID_SEQ)
    return tuple(children), kw_t, depth, cid


def record(fn, children, width: Optional[int] = None, **kw) -> LazyArray:
    """Record ``fn`` over ``children`` as a node without running it.

    A per-shard op runs once per shard: ``width`` shards (default: the
    widest child), a child of width 1 going whole to every shard. An op
    marked whole-list runs once over the children's shard tuples. ``kw``
    values must be hashable (callers check). Raises when the shape cannot
    be inferred; callers route that through ``resilience.record_recoverable``
    and fall back to the eager engine, which reproduces any error."""
    children, kw_t, depth, cid = _join(children, kw)
    avals = tuple(_aval(c) for c in children)
    if width is None:
        width = max(a[0] for a in avals)
    shape, dtype, width = _infer_cached(fn, avals, kw_t, width)
    if telemetry._MODE >= 2:
        telemetry.record_event("record", op=_name(fn), cid=cid, depth=depth)
    node = LazyArray(fn, tuple(children), kw_t, shape, dtype, width, depth, cid)
    if _SESSION_OF is not None:
        node.session = _SESSION_OF()
    return node


@functools.lru_cache(maxsize=4096)
def _infer_multi_cached(fn, child_avals, kw):
    """(shape, dtype, width) of each output of a multi-output op, from one
    run on meta tensors (:func:`_infer_cached`'s multi-output form)."""
    kw_d = _meta_kw(dict(kw))
    try:
        outs = fn(*[tuple(_meta(s, d) for _ in range(w)) for w, s, d in child_avals], **kw_d)
    except RuntimeError as exc:
        raise NotImplementedError(f"{_name(fn)} does not run on meta tensors: {exc}") from exc
    avals = []
    for o in outs:
        if not o or any(tuple(t.shape) != tuple(o[0].shape) or t.dtype != o[0].dtype for t in o):
            raise NotImplementedError(f"{_name(fn)} gave shards of unequal shapes")
        avals.append((tuple(o[0].shape), o[0].dtype, len(o)))
    return tuple(avals)


def record_multi(fn, children, **kw) -> Tuple[LazyArray, ...]:
    """Record a multi-output op (one that returns several shard lists) as
    one parent node and one :func:`_pick_op` selector per output, and
    return the selectors. The parent stays interior: forcing a selector
    runs the op once in the program, and :func:`_gather_batch` takes the
    selectors of live siblings along, so every output lands in one
    dispatch (TSQR's Q and R, CholQR2's Q, R and ``ok``, a halo pair)."""
    children, kw_t, depth, cid = _join(children, kw)
    avals = _infer_multi_cached(fn, tuple(_aval(c) for c in children), kw_t)
    if telemetry._MODE >= 2:
        telemetry.record_event("record", op=_label(fn, kw_t), cid=cid, depth=depth)
    # the parent's own shape is never read: only its selectors consume it
    parent = LazyArray(fn, tuple(children), kw_t, avals[0][0], avals[0][1], len(avals), depth, cid)
    picks = tuple(
        LazyArray(_pick_op, (parent,), (("i", i),), shape, dtype, width, depth + 1, cid)
        for i, (shape, dtype, width) in enumerate(avals)
    )
    if _SESSION_OF is not None:
        parent.session = _SESSION_OF()
        for pick in picks:
            pick.session = parent.session
    return picks


def cast(c, dtype: torch.dtype):
    """A deferred cast node; the input itself when its dtype is ``dtype``."""
    if _aval(c)[2] == dtype:
        return c
    return record(_astype_op, (c,), dtype=dtype)


#: 0-d leaves of the scalar operands, by (type, repr, device), least
#: recently used first: a loop multiplying by the same constant reuses one
#: tensor, and a constant in constant use keeps it (chains batched together
#: then share its leaf, whatever other scalars passed meanwhile)
_SCALAR_LEAVES: "OrderedDict[tuple, tuple]" = OrderedDict()


def _scalar_leaf(value, device: torch.device) -> tuple:
    """A Python scalar operand as a 0-d leaf of its own type (numpy's
    ``result_type`` of it: float64 for a float, int64 for an int) on the
    mesh's first device; :func:`cast` then records its cast to the promoted
    type, as the reference records the cast of a scalar. Rounding the exact
    float64 or int64 value once gives the eager engine's
    ``torch.full((), value, dtype=promoted)``."""
    key = (type(value), repr(value), device)
    leaf = _SCALAR_LEAVES.get(key)
    if leaf is not None:
        try:
            _SCALAR_LEAVES.move_to_end(key)
        except KeyError:  # another thread evicted it meanwhile
            pass
    else:
        dtype = _types.canonical_heat_type(np.result_type(type(value))).torch_type()
        leaf = _SCALAR_LEAVES[key] = (torch.full((), value, dtype=dtype, device=device),)
        if len(_SCALAR_LEAVES) > 256:
            _SCALAR_LEAVES.popitem(last=False)
    return leaf


# ----------------------------------------------------------------------
# the program cache
# ----------------------------------------------------------------------
_PROGRAMS: "OrderedDict[tuple, _Program]" = OrderedDict()
#: signatures whose program failed: forced by op-by-op replay from then on
_QUARANTINE: "OrderedDict[tuple, None]" = OrderedDict()
#: per-program accounting: sig -> {key, family, compiles, dispatches, roots}
_PROGRAM_INFO: "OrderedDict[tuple, dict]" = OrderedDict()
#: memoized cost estimates by program key (program_costs())
_COSTS: Dict[str, dict] = {}
#: memoized estimates with every leaf whole on every rank (program_audit_info())
_REPL_COSTS: Dict[str, dict] = {}
#: program keys whose cost estimate failed: counted and warned once
_COST_ERROR_KEYS: set = set()
_COST_ERROR_WARNED = False
_STATS = {
    "compiles": 0,
    "hits": 0,
    "disk_hits": 0,
    "forces": 0,
    "evictions": 0,
    "degraded": 0,
    "quarantine_hits": 0,
}

#: one force at a time; reentrant for the ``drain`` policy, which forces
#: other roots from inside the gate
_FORCE_LOCK = threading.RLock()
#: ``.held``: how deep the calling thread is inside :func:`force` (a
#: recursive force passes the batch window and the admission gate)
_FORCE_TLS = threading.local()


def _kw_repr(kw) -> str:
    def one(v):
        if callable(v) and hasattr(v, "__qualname__"):
            return f"{getattr(v, '__module__', '')}.{v.__qualname__}"
        if isinstance(v, tuple):
            return "(" + ",".join(one(x) for x in v) + ")"
        return repr(v)

    return ",".join(f"{k}={one(v)}" for k, v in kw)


def _program_key(sig) -> str:
    """Stable short digest of a signature: op names, topology, static
    arguments, leaf layouts. It correlates the trace's ``dispatch`` events,
    ``cache_stats()["program_keys"]`` and :func:`program_costs`."""
    parts = []
    for e in sig:
        if e[0] == "L":
            parts.append("L:" + ":".join(str(x) for x in e[1:]))
        elif e[0] == "R":
            parts.append(f"R:{e[1]}")
        else:
            fn, idxs, kw, width = e
            parts.append(f"O:{getattr(fn, '__module__', '')}.{_name(fn)}:{idxs}:{_kw_repr(kw)}:{width}")
    return hashlib.sha1("|".join(parts).encode()).hexdigest()[:16]


def _label(fn, kw) -> str:
    """An op's name in the telemetry: a schedule's by its kernel
    (``apply:<kernel>``), a reduction's by its local function
    (``_across_op:sum``), as the reference names a program family by its
    ops (``sum``)."""
    if fn in (_apply_op, _apply_multi_op):
        return "apply:" + _name(dict(kw)["kernel"])
    if fn in (_reduce_op, _across_op):
        return f"{_name(fn)}:{_name(dict(kw)['reduction'].local).strip('_')}"
    return _name(fn)


def _family(sig) -> tuple:
    """The op names of a signature, without leaf shapes: the retrace
    detector's key."""
    return tuple(_label(e[0], e[2]) for e in sig if e[0] not in ("L", "R"))


def _leaf_key(sig) -> tuple:
    """The leaf part of a signature."""
    return tuple(e for e in sig if e[0] == "L")


def _program_info(sig) -> dict:
    info = _PROGRAM_INFO.get(sig)
    if info is None:
        info = _PROGRAM_INFO[sig] = {
            "key": _program_key(sig),
            "family": "/".join(_family(sig)) or "<leaf>",
            "compiles": 0,
            "dispatches": 0,
            "roots": 0,
        }
        while len(_PROGRAM_INFO) > _CACHE_SIZE:
            _PROGRAM_INFO.popitem(last=False)
    else:
        _PROGRAM_INFO.move_to_end(sig)
    return info


def _leaf_sig(leaf) -> tuple:
    t = leaf[0]
    return ("L", len(leaf), tuple(t.shape), t.dtype, t.device, tuple(t.stride()), t.requires_grad)


def _walk(root, entries, leaves, memo) -> None:
    """Postorder walk of a DAG into (entries, leaves, memo): a shared
    subexpression or leaf appears once and is referenced by index."""
    stack = [(root, False)]
    while stack:
        obj, expanded = stack.pop()
        pending = isinstance(obj, LazyArray) and obj._value is None
        if not pending:
            val = obj._value if isinstance(obj, LazyArray) else obj
            key = tuple(map(id, val))
            if key in memo:
                memo[id(obj)] = memo[key]
                continue
            versions = getattr(val, "versions", None)
            if versions is not None and versions != tuple(t._version for t in val):
                raise ChainInputWrittenError(
                    "a tensor this pending chain reads was written in place after the chain was recorded, "
                    "through a torch view of an array's shards; force the chain before such a write "
                    "(or write through the array, which does)"
                )
            memo[key] = memo[id(obj)] = len(entries)
            leaves.append(val)
            entries.append(_leaf_sig(val))
            continue
        if id(obj) in memo:
            continue
        if not expanded:
            stack.append((obj, True))
            for c in obj.children:
                stack.append((c, False))
        else:
            memo[id(obj)] = len(entries)
            entries.append((obj.fn, tuple(memo[id(c)] for c in obj.children), obj.kw, obj.width))


def _signature(root):
    """Structural signature and leaves of one DAG root."""
    entries, leaves, memo = [], [], {}
    _walk(root, entries, leaves, memo)
    entries.append(("R", (memo[id(root)],)))
    return tuple(entries), leaves, memo


def _flat(leaves) -> list:
    return [t for leaf in leaves for t in leaf]


def _meta_kw(kw_d: dict) -> dict:
    """Static arguments for a run on meta tensors: the shard-order verbs
    then move nothing between devices."""
    if "devices" in kw_d:
        kw_d = dict(kw_d, devices=(torch.device("meta"),) * len(kw_d["devices"]))
    return kw_d


def _target(fn, kw, meta: bool = False):
    """The ``call_function`` target of one op: ``fn`` with its static
    arguments bound, named after it (an FX target must have a name; its
    arguments hold graph nodes only)."""
    kw_d = _meta_kw(dict(kw)) if meta else dict(kw)

    def call(*args):
        return fn(*args, **kw_d)

    label = _name(fn) + ("_" + _name(kw_d["kernel"]) if "kernel" in kw_d else "")
    name = "".join(ch if ch.isalnum() or ch == "_" else "_" for ch in label).strip("_") or "op"
    call.__name__ = call.__qualname__ = name
    call.__module__ = __name__
    return call


def _build(sig, meta: bool = False) -> torch.fx.GraphModule:
    """The program of a signature as a GraphModule over the flattened leaf
    tensors, returning the root's shard tensors: every op one
    ``call_function`` per shard (or one over the shard lists), in the eager
    engines' order. ``meta`` builds it for a run on meta tensors."""
    graph = torch.fx.Graph()
    vals: List[list] = []
    n_in = 0
    for i, e in enumerate(sig):
        if e[0] == "L":
            made = [graph.placeholder(f"leaf{n_in + j}") for j in range(e[1])]
            vals.append(made)
            n_in += e[1]
        elif e[0] == "R":
            graph.output(tuple(n for r in e[1] for n in vals[r]))
            continue
        else:
            fn, idxs, kw, width = e
            if fn is _pick_op:
                # output i of a multi-output node, then its shards
                out = graph.call_function(operator.getitem, (vals[idxs[0]][0], dict(kw)["i"]))
                vals.append([graph.call_function(operator.getitem, (out, j)) for j in range(width)])
                made = [out] + vals[-1]
            else:
                target = _target(fn, kw, meta)
                if getattr(fn, "_fusion_multi", False):
                    vals.append([graph.call_function(target, tuple(tuple(vals[i]) for i in idxs))])
                    made = vals[-1]
                elif getattr(fn, "_fusion_whole", False):
                    node = graph.call_function(target, tuple(tuple(vals[i]) for i in idxs))
                    vals.append([graph.call_function(operator.getitem, (node, j)) for j in range(width)])
                    made = [node] + vals[-1]
                else:
                    vals.append([
                        graph.call_function(target, tuple(vals[i][j if len(vals[i]) > 1 else 0] for i in idxs))
                        for j in range(width)
                    ])
                    made = vals[-1]
        for n in made:
            # the signature entry a node computes: the cost walk sums per entry
            n.meta["entry"] = i
    return torch.fx.GraphModule(torch.nn.Module(), graph)


def _on_card(t: torch.Tensor) -> bool:
    return t.device.type == "cuda"


def _strict_dynamo():
    """Dynamo's settings for a program's compile, patched for this thread
    and only around the program's first call (where it compiles), so that
    other compiled code in the process keeps its own: errors are never
    suppressed into a silent eager run, and past the recompile limit a frame
    raises (later calls too: under ``fullgraph=True`` Dynamo raises there
    whatever the setting, in torch 2.11 and 2.13), which the
    guarded force degrades, counts and dumps."""
    import torch._dynamo

    cfg = torch._dynamo.config
    flags = {"suppress_errors": False}
    for flag in ("fail_on_recompile_limit_hit", "fail_on_cache_limit_hit"):
        if hasattr(cfg, flag):
            flags[flag] = True
            break
    return cfg.patch(**flags)


class _Program:
    """One cached program: the plain GraphModule and, once a force with
    CUDA leaves has run it, its compiled form (Inductor, built at that
    first call). A program of one op (not counting the un-pad views) has
    nothing to fuse: it runs its plain module on the card too, the eager
    engine's one op, and is never built by Inductor."""

    __slots__ = ("gm", "compiled", "fuses")

    def __init__(self, sig):
        self.gm = _build(sig)
        self.compiled = None
        self.fuses = sum(1 for e in sig if e[0] not in ("L", "R") and e[0] not in (_unpad_op, _pick_op)) > 1

    def __call__(self, flat: list):
        if self.fuses and flat and _on_card(flat[0]):
            if self.compiled is None:
                compiled = torch.compile(self.gm, fullgraph=True, dynamic=False)
                with _strict_dynamo():
                    values = compiled(*flat)
                self.compiled = compiled
                return values
            return self.compiled(*flat)
        return self.gm(*flat)


# ----------------------------------------------------------------------
# the live-root registry
# ----------------------------------------------------------------------
#: weakrefs to the DNDarrays whose payload is (was) a pending chain, in
#: registration order: the memory gate's drain policy forces them and the
#: stall diagnosis lists them; entries die with their arrays
_ROOT_SEQ = itertools.count()
_LIVE_ROOTS: "weakref.WeakValueDictionary[int, object]" = weakref.WeakValueDictionary()
_ROOTS_LOCK = threading.Lock()


def register_root(wrapper) -> None:
    """Track a DNDarray whose payload is a pending chain, and stamp the
    chain's root with the array's logical extent."""
    payload = wrapper._payload
    if isinstance(payload, LazyArray):
        payload.extent = (wrapper.gshape, wrapper.split)
    with _ROOTS_LOCK:
        _LIVE_ROOTS[next(_ROOT_SEQ)] = wrapper


def _live_root_keys() -> list:
    """A snapshot of the registry's keys, in registration order."""
    with _ROOTS_LOCK:
        return sorted(_LIVE_ROOTS.keys())


# the serving layer's seams (``core/serving.py`` sets them; one ``is None``
# test per force until then): ``_ROOT_PRIORITY`` maps a root's session to a
# sort key of the batch's candidates, or to ``_BATCH_EXCLUDED`` to keep the
# root out of other sessions' batches; ``_SERVING_NOTE`` bills a shared
# dispatch and an incident to each session; ``_SESSION_OF`` names the
# calling thread's session, stamped on each node at record time;
# ``_ADMIT_HOOK(cid)`` is the token-bucket gate, called by :func:`force`
# before it takes ``_FORCE_LOCK`` (a tenant sleeping for tokens blocks only
# itself), returning a refund for a dispatch that never runs or None;
# ``_DISK_INDEX`` is the persistent program-key index, whose known keys
# count as ``disk_hits`` instead of ``compiles``
_ROOT_PRIORITY = None
_BATCH_EXCLUDED = object()
_SERVING_NOTE = None
_SESSION_OF = None
_ADMIT_HOOK = None
_DISK_INDEX = None

#: the cross-session batch window (seconds; serving arms it while two or
#: more sessions are active): a top-level force sleeps this long before it
#: takes the lock, so other clients' threads register their roots and ride
#: the same program
_BATCH_WINDOW_S = 0.0
#: ids of the nodes some thread is forcing right now, while the serving
#: layer is in use: a root of another session rides a batch only when its
#: own thread is reading it (see :func:`_gather_batch`)
_FORCING: set = set()

#: the pending nodes of the signature held at the memory gate: while the
#: ``drain`` policy forces other roots, neither it nor their batches may
#: take one of them (the held program would dispatch them a second time)
_DRAIN_EXCLUDE: frozenset = frozenset()


def _node_nbytes(node: LazyArray) -> int:
    """The bytes of a node's shards together."""
    return node.width * math.prod(node.shape) * node.dtype.itemsize


def _anchor_devices(node, comm) -> Optional[tuple]:
    """The mesh devices of the chain a force runs: its array's mesh, or the
    mesh of the registered array that holds it; None when neither is known
    (the force then batches nothing)."""
    if comm is not None:
        return tuple(comm.devices)
    for key in _live_root_keys():
        wrapper = _LIVE_ROOTS.get(key)
        if wrapper is not None and wrapper._payload is node:
            return tuple(wrapper.comm.devices)
    return None


def _gather_batch(entries, leaves, memo, roots, devices) -> None:
    """Walk other live pending roots into the signature being built, to run
    in the same program as ``roots[0]``: in registration order (the
    program's cache key must not churn), up to :data:`_BATCH_MAX` roots.
    A candidate is skipped when it is interior to the walk (an output
    nobody asked for, and whether a caller holds an intermediate must not
    change the key), larger than :data:`_BATCH_BYTES` (unless it selects an
    output of a multi-output node already in the walk: the kernel runs
    once either way), held at the memory gate, on another mesh (a program
    runs on one), or reading a tensor written in place around its array
    (:class:`ChainInputWrittenError` is its own read's, not this one's).

    While the serving layer is in use, a root recorded under another
    session rides only while its own thread forces it (:data:`_FORCING`): a
    tenant's chain still being built is never cut by a neighbour's dispatch
    (its intermediates are registered arrays too), and a batch's structure
    depends only on the roots being read, so steady traffic keeps its
    programs."""
    keys = _live_root_keys()
    serving = _SESSION_OF is not None
    own = roots[0].session
    prio = _ROOT_PRIORITY
    if prio is not None:
        ranked = []
        for key in keys:
            payload = getattr(_LIVE_ROOTS.get(key), "_payload", None)
            p = prio(getattr(payload, "session", None))
            if p is not _BATCH_EXCLUDED:
                ranked.append(((1, float("inf")) if p is None else p, key))
        keys = [key for _, key in sorted(ranked)]
    stale = []
    for key in keys:
        if len(roots) >= _BATCH_MAX:
            break
        wrapper = _LIVE_ROOTS.get(key)
        if wrapper is None:
            continue
        payload = wrapper._payload
        if not (isinstance(payload, LazyArray) and payload._value is None):
            stale.append(key)  # forced since it registered
            continue
        if id(payload) in memo or id(payload) in _DRAIN_EXCLUDE:
            continue
        if serving and payload.session not in (None, own) and id(payload) not in _FORCING:
            continue
        if _node_nbytes(payload) > _BATCH_BYTES and not (
            payload.fn is _pick_op and id(payload.children[0]) in memo
        ):
            continue
        if tuple(wrapper.comm.devices) != devices:
            continue
        # a candidate whose input was written around its array stays pending
        # and raises at its own read, never at this one's: its walk is undone
        n_entries, n_leaves, saved = len(entries), len(leaves), dict(memo)
        try:
            _walk(payload, entries, leaves, memo)
        except ChainInputWrittenError:
            del entries[n_entries:], leaves[n_leaves:]
            memo.clear()
            memo.update(saved)
            continue
        roots.append(payload)
    with _ROOTS_LOCK:
        for key in stale:
            _LIVE_ROOTS.pop(key, None)


def _drain_pending_roots(exclude=()) -> int:
    """The ``drain`` policy's arm: force every OTHER live pending root and
    wait until its value is on the device. ``exclude`` holds the ids of
    every pending node of the gated signature, which is never forced here:
    it dispatches once, when the gate admits it. Returns the roots
    drained, each counted as a ``drain`` blocking sync."""
    global _DRAIN_EXCLUDE
    drained = 0
    prev, _DRAIN_EXCLUDE = _DRAIN_EXCLUDE, frozenset(exclude) | _DRAIN_EXCLUDE
    try:
        for key in _live_root_keys():
            wrapper = _LIVE_ROOTS.get(key)
            if wrapper is None:
                continue
            payload = wrapper._payload
            if not isinstance(payload, LazyArray) or id(payload) in exclude:
                continue
            if payload._value is None:
                force(payload, wrapper.comm)
            token = telemetry.record_blocking_sync("drain", cid=payload.cid) if telemetry._MODE else None
            with health_runtime.watch("sync:drain", cid=payload.cid):
                for t in payload._value:
                    if t.device.type == "cuda":
                        torch.cuda.current_stream(t.device).synchronize()
            telemetry.end_blocking_sync(token)
            drained += 1
    finally:
        _DRAIN_EXCLUDE = prev
    return drained


def _reads(root, keys) -> bool:
    """Whether the pending chain ``root`` reads a buffer of ``keys``."""
    stack, seen = [root], set()
    while stack:
        obj = stack.pop()
        if id(obj) in seen:
            continue
        seen.add(id(obj))
        if isinstance(obj, LazyArray) and obj._value is None:
            stack.extend(obj.children)
            continue
        val = obj._value if isinstance(obj, LazyArray) else obj
        if any(memledger._buffer_key(t) in keys for t in val):
            return True
    return False


def release(tensors) -> int:
    """Force every live pending chain that reads the storage of one of
    ``tensors``: called before an in-place write into them, so that a
    result recorded before the write never sees it (the reference's
    buffers are immutable). Returns the chains forced."""
    if not len(_LIVE_ROOTS):
        return 0
    keys = {memledger._buffer_key(t) for t in tensors}
    forced = 0
    for key in _live_root_keys():
        wrapper = _LIVE_ROOTS.get(key)
        payload = getattr(wrapper, "_payload", None)
        if isinstance(payload, LazyArray) and payload._value is None and _reads(payload, keys):
            wrapper._forced()
            forced += 1
    return forced


# ----------------------------------------------------------------------
# static peak and costs, from the GraphModule's node shapes
# ----------------------------------------------------------------------
#: flops per element of the ops the table knows; reductions count their
#: input elements, every other op its output elements, one flop each
_FLOPS_PER_ELEMENT = {"pow": 10, "exp": 4, "log": 4, "sqrt": 2, "true_divide": 1, "sin": 4, "cos": 4, "tanh": 6}


def _shape_walk(sig) -> List[Tuple[str, str, int, int, list, Optional[int]]]:
    """Run a signature's GraphModule on meta tensors: for each node, in
    order, its op kind, its target's name, the bytes it holds (0 for an op
    over whole shard lists, whose results its ``getitem`` nodes hold), the
    elements of its results, the indices of the nodes it reads and the
    signature entry whose value it holds (None where its result is a
    tuple, an op over whole shard lists, whose ``getitem`` nodes hold
    the entry's tensors)."""
    gm = _build(sig, meta=True)
    metas = [
        torch.empty_strided(e[2], e[5], dtype=e[3], device="meta")
        for e in sig if e[0] == "L" for _ in range(e[1])
    ]
    out: List[Tuple[str, str, int, int, list, Optional[int]]] = []
    index: Dict[Any, int] = {}

    class _Walk(torch.fx.Interpreter):
        def run_node(self, n):
            result = super().run_node(n)
            many = isinstance(result, (tuple, list))
            tensors = [t for t in (result if many else (result,)) if isinstance(t, torch.Tensor)]
            numel = sum(t.numel() for t in tensors)
            nbytes = 0 if (many and n.op == "call_function") else sum(t.numel() * t.element_size() for t in tensors)
            index[n] = len(out)
            out.append((n.op, getattr(n.target, "__name__", ""), nbytes, numel,
                        [index[a] for a in n.all_input_nodes], None if many else n.meta.get("entry")))
            return result

    _Walk(gm).run(*metas)
    return out


#: ops whose results are views of their operands: they move no bytes
_VIEW_OPS = (_unpad_op, _pick_op)
#: layout ops that a value held whole on every rank does not run
_LAYOUT_OPS = (_gather_op, _blocks_op)
#: the collective nodes, by the names ``telemetry.hlo_collective_counts``
#: gives them in a program's text
_COLLECTIVE_OPS = {
    _across_op: "all-reduce",
    _cum_split_op: "exscan",
    _gather_op: "all-gather",
    _blocks_op: "scatter",
    _apply_op: "apply",
    _apply_multi_op: "apply",
}


def _entry_bytes(nodes) -> Tuple[Dict[int, int], Dict[int, int]]:
    """Per signature entry, the bytes of one rank's tensor of its value (a
    shard of a split value, the whole of a replicated one) and of the
    value held whole (every shard summed)."""
    sizes: Dict[int, List[int]] = {}
    for node in nodes:
        if node[5] is not None:
            sizes.setdefault(node[5], []).append(node[2])
    shard = {i: max(v) for i, v in sizes.items()}
    whole = {i: sum(v) for i, v in sizes.items()}
    return shard, whole


def _traffic(sig, shard, whole) -> Tuple[int, int, Dict[int, int]]:
    """Bytes each op of a signature reads and writes, per rank: summed
    over one shard of its operands and results (``shard``), and over the
    whole values (``whole``, the layout ops then moving nothing); with each
    collective node's wire bytes, its result on one rank."""
    per_rank = held_whole = 0
    wire: Dict[int, int] = {}
    for i, e in enumerate(sig):
        if e[0] in ("L", "R"):
            continue
        fn, idxs = e[0], e[1]
        if fn is _pick_op:
            # the output of a multi-output node, written by it
            per_rank += shard.get(i, 0)
            held_whole += whole.get(i, 0)
            if idxs[0] in wire:
                wire[idxs[0]] += shard.get(i, 0)
            continue
        if fn in _VIEW_OPS:
            continue
        multi = getattr(fn, "_fusion_multi", False)
        reads = sum(shard.get(c, 0) for c in idxs)
        writes = 0 if multi else shard.get(i, 0)
        per_rank += reads + writes
        if fn not in _LAYOUT_OPS:
            held_whole += sum(whole.get(c, 0) for c in idxs) + (0 if multi else whole.get(i, 0))
        if fn in _COLLECTIVE_OPS:
            wire[i] = writes
    return per_rank, held_whole, wire


def _estimate_cost(sig, replicated: bool = False) -> dict:
    """Cost of one program from its node shapes; the program runs on meta
    tensors only.

    - ``operand_bytes``, ``result_bytes``, ``flops`` (from
      :data:`_FLOPS_PER_ELEMENT`) and the ``memory`` block's static peak
      (leaves + outputs + the intermediates live at the worst point of the
      op order, an upper bound on what the program holds);
    - ``bytes_accessed``: what each op reads and writes on one rank,
      ``Σ_op (Σ_operands b(operand) + b(result))``, where ``b(v)`` is one
      rank's tensor of value ``v`` (a shard of a split value, the whole of
      a replicated one) and a view (an un-pad, an output selector) moves
      nothing. A split chain resharded to replicated partway through pays
      the whole array per rank from there on, so it grows;
    - ``collectives``: the program's collective nodes by the names that
      ``telemetry.hlo_collective_counts`` gives them in
      :func:`program_hlo`'s text (``all-reduce``, ``all-gather``,
      ``scatter``, ``exscan``, ``apply``), and ``collective_bytes``: their
      wire bytes by the same names, each node's result on one rank.

    ``replicated=True`` costs the same signature with every leaf whole on
    every rank: ``b(v)`` is then the whole value, and the layout ops (a
    gather, a cut into blocks) move nothing, since a whole value needs
    neither; the audit divides its ``bytes_accessed`` by the mesh size to
    get what perfect sharding would pay per rank."""
    cost: Dict[str, Any] = {"operand_bytes": 0, "result_bytes": None, "flops": None, "bytes_accessed": None, "collectives": {}}
    for e in sig:
        if e[0] == "L":
            cost["operand_bytes"] += e[1] * math.prod(e[2]) * e[3].itemsize
    try:
        nodes = _shape_walk(sig)
    except Exception as exc:  # noqa: BLE001 - a best-effort estimate
        cost["error"] = repr(exc)
        return cost
    last_use: Dict[int, int] = {}
    for i, node in enumerate(nodes):
        for r in node[4]:
            last_use[r] = i
    outputs = set(nodes[-1][4])
    result_bytes = sum(nodes[i][2] for i in outputs)
    arg_bytes = sum(n[2] for n in nodes if n[0] == "placeholder")
    temp_peak = live = 0
    flops = 0
    for i, (op, name, nbytes, numel, reads, _entry) in enumerate(nodes):
        if op != "call_function":
            continue
        if i not in outputs:
            live += nbytes
        temp_peak = max(temp_peak, live)
        for r in reads:
            if last_use.get(r) == i and r not in outputs and nodes[r][0] == "call_function":
                live -= nodes[r][2]
        if name == "getitem":
            continue
        in_numel = sum(nodes[r][3] for r in reads)
        per = _FLOPS_PER_ELEMENT.get(name.strip("_"), 1)
        flops += per * (in_numel if ("reduce" in name or "across" in name) else numel)
    shard, whole = _entry_bytes(nodes)
    per_rank, held_whole, wire = _traffic(sig, shard, whole)
    counts: Dict[str, int] = {}
    wire_bytes: Dict[str, int] = {}
    for i, nbytes in wire.items():
        kind = _COLLECTIVE_OPS[sig[i][0]]
        counts[kind] = counts.get(kind, 0) + 1
        wire_bytes[kind] = wire_bytes.get(kind, 0) + nbytes
    cost["result_bytes"] = result_bytes
    cost["flops"] = float(flops)
    cost["bytes_accessed"] = float(held_whole if replicated else per_rank)
    cost["collectives"] = {} if replicated else counts
    cost["collective_bytes"] = {} if replicated else wire_bytes
    cost["memory"] = {
        "argument_bytes": arg_bytes,
        "output_bytes": result_bytes,
        "temp_bytes": temp_peak,
        "alias_bytes": 0,
        "generated_code_bytes": 0,
        "peak_bytes": arg_bytes + result_bytes + temp_peak,
    }
    return cost


def _static_peak(key: str, sig) -> Tuple[int, str]:
    """The program's static peak for the gate and the OOM forensic, from
    its node shapes (memoized with :func:`program_costs`'s estimate)."""
    cost = _COSTS.get(key)
    if cost is None:
        cost = _COSTS[key] = _estimate_cost(sig)
        _note_cost_error(key, cost)
    peak = (cost.get("memory") or {}).get("peak_bytes")
    if peak:
        return int(peak), "static"
    return int(cost.get("operand_bytes") or 0), "estimate"


def _note_cost_error(key: str, cost: dict) -> None:
    global _COST_ERROR_WARNED
    if "error" not in cost:
        _COST_ERROR_KEYS.discard(key)
        return
    _COST_ERROR_KEYS.add(key)
    if not _COST_ERROR_WARNED:
        _COST_ERROR_WARNED = True
        warnings.warn(
            ProgramCostWarning(
                f"cost estimate failed for cached program {key} ({cost['error']}); further "
                "failures are counted into report()['programs']['cost_errors'] without re-warning"
            ),
            stacklevel=4,
        )


def cost_error_count() -> int:
    """Cached programs whose cost estimate failed."""
    return len(_COST_ERROR_KEYS)


def programs() -> dict:
    """Per-program accounting by program key: op ``family``, ``compiles``,
    ``dispatches``, ``roots``, and the memoized :func:`program_costs`
    estimate as ``cost`` where one was computed."""
    out = {}
    for info in _PROGRAM_INFO.values():
        rec = {k: v for k, v in info.items() if k != "key"}
        cost = _COSTS.get(info["key"])
        if cost is not None:
            rec["cost"] = dict(cost)
        out[info["key"]] = rec
    return out


def program_costs(top: Optional[int] = None, refresh: bool = False) -> dict:
    """Cost estimates of the cached programs by program key, ranked by
    dispatches (``top`` limits them): operand and result bytes, flops, the
    ``memory`` block with the static peak, the ``family`` and
    ``dispatches``. Memoized per key (``refresh=True`` recomputes); never
    touches data or forces a chain. Failures count into
    :func:`cost_error_count` and warn once per session."""
    ranked = sorted(_PROGRAM_INFO.items(), key=lambda kv: kv[1]["dispatches"], reverse=True)
    if top is not None:
        ranked = ranked[:top]
    out = {}
    for sig, info in ranked:
        key = info["key"]
        cost = None if refresh else _COSTS.get(key)
        if cost is None:
            cost = _COSTS[key] = _estimate_cost(sig)
            _note_cost_error(key, cost)
        out[key] = dict(cost, family=info["family"], dispatches=info["dispatches"])
    return out


def program_audit_info(top: Optional[int] = None, refresh: bool = False) -> dict:
    """Per cached program, by program key, what ``analysis/audit.py``
    reasons over: the op ``family``, ``dispatches``, the ``leaves`` (the
    ``shape`` and ``dtype`` of one rank's tensor, the ``shards`` holding
    the leaf, its ``nbytes`` over all of them, and ``replicated``: one
    tensor that every rank shares), ``mesh_size`` (the widest leaf),
    ``split_leaves``, and the memoized estimates of :func:`_estimate_cost`
    as recorded (``cost``) and with every leaf whole on every rank
    (``replicated_cost``). Ranked by dispatches (``top`` limits them).
    Runs the programs on meta tensors only: never touches data or forces
    a chain, and builds nothing."""
    ranked = sorted(_PROGRAM_INFO.items(), key=lambda kv: kv[1]["dispatches"], reverse=True)
    if top is not None:
        ranked = ranked[:top]
    out = {}
    for sig, info in ranked:
        key = info["key"]
        cost = None if refresh else _COSTS.get(key)
        if cost is None:
            cost = _COSTS[key] = _estimate_cost(sig)
            _note_cost_error(key, cost)
        rcost = None if refresh else _REPL_COSTS.get(key)
        if rcost is None:
            rcost = _REPL_COSTS[key] = _estimate_cost(sig, replicated=True)
        leaves = [
            {
                "shape": tuple(int(s) for s in e[2]),
                "dtype": str(e[3]).removeprefix("torch."),
                "shards": e[1],
                "nbytes": e[1] * math.prod(e[2]) * e[3].itemsize,
                "replicated": e[1] == 1,
            }
            for e in sig if e[0] == "L"
        ]
        out[key] = {
            "family": info["family"],
            "dispatches": info["dispatches"],
            "mesh_size": max((leaf["shards"] for leaf in leaves), default=1),
            "split_leaves": sum(1 for leaf in leaves if not leaf["replicated"]),
            "leaves": leaves,
            "cost": dict(cost),
            "replicated_cost": dict(rcost),
        }
    return out


# ----------------------------------------------------------------------
# forcing
# ----------------------------------------------------------------------
def _quarantine(sig) -> None:
    _QUARANTINE[sig] = None
    while len(_QUARANTINE) > _QUARANTINE_SIZE:
        _QUARANTINE.popitem(last=False)


def _degrade(sig, flat, exc, missed):
    """Guarded forcing's recovery arm: drop the failed program, quarantine
    its signature, record a ``degraded`` event, warn, auto-dump the flight
    ring and replay the chain op by op through the plain module: the eager
    result. If the replay fails, that error surfaces."""
    _PROGRAMS.pop(sig, None)
    _PROGRAM_INFO.pop(sig, None)
    _quarantine(sig)
    _STATS["degraded"] += 1
    stage = "compile" if missed else "execute"
    family = _family(sig)
    if _SERVING_NOTE is not None:
        # billed to the tripping tenant only
        _SERVING_NOTE("degraded", program=_program_key(sig), stage=stage)
    if telemetry._MODE:
        telemetry.record_degraded(family, stage, repr(exc))
    warnings.warn(
        resilience.DegradedDispatchWarning(
            f"fused program for op chain {'/'.join(family) or '<leaf>'} failed at {stage} "
            f"({exc!r}); degraded to per-op eager dispatch and quarantined the DAG key "
            "(correct result, slower; fusion.clear_cache() lifts the quarantine)"
        ),
        stacklevel=4,
    )
    health_runtime.auto_dump("degrade")
    return _build(sig)(*flat)


def force(node, comm=None):
    """Run a recorded chain as one cached program and return the root's
    shard tensors (a tuple of ``node.width``).

    With the collective nodes on, other small live pending roots of the
    same mesh (``comm``, else the mesh of the array holding ``node``) run
    in the same program (:func:`_gather_batch`), and their arrays find
    their values installed. Asynchronous: the call installs the result
    tensors and reads no device data. Guarded: a program that fails to
    build, compile or run degrades to op-by-op replay (:func:`_degrade`);
    the policy signals (the memory gate's refusal, the serving layer's
    admission refusal, the errstate and stall errors) propagate with the
    chain still pending.

    Under the serving layer, a top-level force first sleeps the batch
    window (other sessions' roots register meanwhile) and passes the
    admission gate, both before it takes the lock."""
    if not isinstance(node, LazyArray):
        return node
    if node._value is not None:
        return node._value
    if _SESSION_OF is None:
        return _force_top(node, comm)
    _FORCING.add(id(node))
    try:
        return _force_top(node, comm)
    finally:
        _FORCING.discard(id(node))


def _force_top(node, comm):
    if _BATCH_WINDOW_S > 0.0 and not getattr(_FORCE_TLS, "held", 0):
        time.sleep(_BATCH_WINDOW_S)
        if node._value is not None:
            return node._value
    admit = _ADMIT_HOOK  # a last session's exit may clear the seam meanwhile
    if admit is not None and not getattr(_FORCE_TLS, "held", 0):
        refund = admit(node.cid)
        if node._value is not None:
            # a neighbour's batch landed this node during the wait: the
            # token goes back, nothing dispatches
            if refund is not None:
                refund()
            return node._value
    with _FORCE_LOCK:
        _FORCE_TLS.held = getattr(_FORCE_TLS, "held", 0) + 1
        try:
            return _force_locked(node, comm)
        finally:
            _FORCE_TLS.held -= 1


def _force_locked(node, comm=None):
    if node._value is not None:
        return node._value
    roots = [node]
    entries, leaves, memo = [], [], {}
    _walk(node, entries, leaves, memo)
    if _COLLECTIVES and _ENABLED and len(_LIVE_ROOTS) and not torch.compiler.is_compiling():
        # never while torch traces: a batched root would come back as a
        # value of the caller's graph
        devices = _anchor_devices(node, comm)
        if devices is not None:
            _gather_batch(entries, leaves, memo, roots, devices)
    entries.append(("R", tuple(memo[id(r)] for r in roots)))
    sig = tuple(entries)
    flat = _flat(leaves)
    _STATS["forces"] += 1
    info = None
    missed = disk_warm = False
    if _QUARANTINE and sig in _QUARANTINE:
        _STATS["quarantine_hits"] += 1
        if _SERVING_NOTE is not None:
            _SERVING_NOTE("quarantine_hit", program=_program_key(sig), cid=node.cid,
                          sessions=[r.session for r in roots])
        if telemetry._MODE:
            telemetry.record_force(telemetry.current_trigger(), node.depth, compiled=False, cid=node.cid)
        values = _build(sig)(*flat)
    else:
        prog = _PROGRAMS.get(sig)
        missed = prog is None
        info = _program_info(sig)
        if missed:
            prog = _PROGRAMS[sig] = _Program(sig)
            # a key the persistent index knows is a disk hit: Inductor's FX
            # graph cache, in the same directory, serves its compiled code
            disk_warm = _DISK_INDEX is not None and _DISK_INDEX.has(info["key"])
            if disk_warm:
                _STATS["disk_hits"] += 1
            else:
                _STATS["compiles"] += 1
                info["compiles"] += 1
            if _DISK_INDEX is not None:
                _DISK_INDEX.note(info["key"], info["family"])
            while len(_PROGRAMS) > _CACHE_SIZE:
                _PROGRAMS.popitem(last=False)
                _STATS["evictions"] += 1
            if telemetry._MODE and not disk_warm:
                telemetry.record_retrace(_family(sig), _leaf_key(sig))
                telemetry.record_event("compile", program=info["key"], family=info["family"], cid=node.cid)
        else:
            _PROGRAMS.move_to_end(sig)
            _STATS["hits"] += 1
        if telemetry._MODE:
            telemetry.record_force(telemetry.current_trigger(), node.depth, compiled=missed, cid=node.cid)
        if memledger._BUDGET_RAW is not None or memledger._HOLD is not None:
            # the headroom gate (and an admission hold) sits before the
            # guarded call: a refusal surfaces with the chain still pending,
            # never degraded
            peak, peak_src = _static_peak(info["key"], sig)
            exclude = frozenset(k for k in memo if isinstance(k, int))
            try:
                memledger.admit(
                    info["key"], info["family"], peak, peak_src,
                    drain_fn=lambda: _drain_pending_roots(exclude),
                )
            except memledger.MemoryBudgetExceeded:
                if _SERVING_NOTE is not None:
                    # billed to the refused tenant only
                    _SERVING_NOTE("mem_refused", program=info["key"], cid=node.cid,
                                  sessions=[r.session for r in roots])
                raise
            if node._value is not None:  # pragma: no cover - a drain forced this chain
                return node._value
        try:
            if resilience._ARMED:
                # the compile happens inside the first call: the sites
                # model that split
                resilience.check("fusion.compile" if missed else "fusion.execute")
                resilience.check("memory.exhausted")
            if telemetry._MODE or health_runtime._WD_ACTIVE:
                cids = [r.cid for r in roots]
                t_disp = time.perf_counter()
                with health_runtime.watch("dispatch", program=info["key"], cid=node.cid, cids=cids):
                    values = prog(flat)
                if telemetry._MODE:
                    health_runtime.note_dispatch(info["key"], cids, missed, time.perf_counter() - t_disp)
            else:
                values = prog(flat)
            info["dispatches"] += 1
            info["roots"] += len(roots)
        except Exception as exc:  # noqa: BLE001 - routed through one policy
            if memledger.is_oom(exc):
                # the forensic comes before the replay churns the evidence
                peak, _ = _static_peak(info["key"], sig)
                memledger.record_oom(exc, program=info["key"], family=info["family"], static_peak=peak)
            if not resilience.force_recoverable(exc):
                raise
            values = _degrade(sig, flat, exc, missed)
            info = None
    pos = 0
    for root in roots:
        value = _leaf(values[pos:pos + root.width])
        pos += root.width
        root._value = value
        root.program = None if info is None else info["key"]
        # the chain's operands become collectable; a later force of a
        # consumer reads this node as a leaf
        root.children = ()
        for t in value:
            memledger.tag(t, "fusion")
    if telemetry._NUMLENS_HOOK is not None and info is not None:
        # the numerics lens over the landed values: it never raises and
        # never forces
        telemetry._NUMLENS_HOOK(sig, leaves, roots, [r._value for r in roots], info)
    sessions = None
    if _SESSION_OF is not None or any(r.session is not None for r in roots):
        sessions = [r.session for r in roots]
    if _SERVING_NOTE is not None and info is not None:
        # each tenant is billed its own roots of a shared dispatch, and the
        # compile (a disk hit is none) the triggering tenant
        _SERVING_NOTE("dispatch", program=info["key"], sessions=sessions, compiled=missed and not disk_warm,
                      trigger=node.session)
    if telemetry._MODE:
        telemetry.record_async_dispatch(len(roots), cid=node.cid, cids=[r.cid for r in roots], program=node.program,
                                        sessions=sessions)
    return node._value


def is_deferred(x) -> bool:
    """Whether a DNDarray (or a node) holds a chain not yet run."""
    payload = getattr(x, "_payload", x)
    return isinstance(payload, LazyArray) and payload._value is None


def cache_stats() -> dict:
    """Program-cache counters: ``compiles`` (program builds, one per cache
    miss whose key the persistent index does not know), ``hits``,
    ``disk_hits`` (misses whose key the index of ``serving.arm_cache``
    knows),
    ``forces``, ``misses``, ``evictions``, the cache ``size``, the
    ``program_keys``, and the guarded-forcing counters ``degraded``,
    ``quarantine_hits`` and ``quarantined``."""
    return dict(
        _STATS,
        misses=_STATS["compiles"] + _STATS["disk_hits"],
        size=len(_PROGRAMS),
        quarantined=len(_QUARANTINE),
        program_keys=[info["key"] for info in _PROGRAM_INFO.values()],
    )


def clear_cache() -> None:
    """Drop every program, its accounting and costs, lift every quarantine,
    forget the live-root registry and zero every counter."""
    _PROGRAMS.clear()
    _PROGRAM_INFO.clear()
    _COSTS.clear()
    _REPL_COSTS.clear()
    _COST_ERROR_KEYS.clear()
    _QUARANTINE.clear()
    with _ROOTS_LOCK:
        _LIVE_ROOTS.clear()
    _STATS.update(compiles=0, hits=0, disk_hits=0, forces=0, evictions=0, degraded=0, quarantine_hits=0)


def clear_quarantine() -> None:
    """Lift the quarantine only: the next force of a failed signature tries
    its program again."""
    _QUARANTINE.clear()


# ----------------------------------------------------------------------
# the engines' deferral front-ends
# ----------------------------------------------------------------------
_SCALARS = (int, float, bool, complex, np.number, np.bool_)

# sibling modules, resolved at first use (dndarray imports this module)
DNDarray = None
_distribute = None
_types = None
_broadcast_shapes = None


def _resolve_siblings():
    global DNDarray, _distribute, _types, _broadcast_shapes
    from . import types as types_mod
    from .dndarray import DNDarray as dnd_cls
    from .dndarray import _distribute as distribute
    from .stride_tricks import broadcast_shapes

    DNDarray, _distribute, _types, _broadcast_shapes = dnd_cls, distribute, types_mod, broadcast_shapes


def hashable_kwargs(kw: dict) -> bool:
    """Whether ``kw`` can key a program (an unhashable value, such as a
    list or a tensor, cannot)."""
    items = tuple(sorted(kw.items()))
    try:
        hash(items)
        return True
    except TypeError:
        return False


def _unfused(engine: str, reason: str):
    """Record why an op was not deferred; returns None, the "use the eager
    engine" answer of the front-ends."""
    if telemetry._MODE:
        telemetry.record_unfused(engine, reason)
    return None


#: On a card, an op whose array operands are all concrete and hold fewer
#: bytes than this together runs eagerly (unfused reason ``small_on_card``):
#: the host sets the pace there, and recording and forcing a chain cost
#: more than the launches it saves. ``chip_smoke.py`` phase 18's sweep of
#: the 10-op chain (two n x 16 float32 operands, a host read per chain) on
#: an H100 found eager ahead up to n = 10^6 (128 MB) and the recorded
#: chain ahead from n = 3 x 10^6 (384 MB). A pending chain is joined at any
#: size.
_EAGER_BELOW_BYTES = 192 << 20


def _small_on_card(*operands) -> bool:
    """Whether the array operands are concrete, lie on a card, and hold
    fewer than :data:`_EAGER_BELOW_BYTES` together."""
    total = 0
    for x in operands:
        if not isinstance(x, DNDarray):
            continue
        payload = x._payload
        if isinstance(payload, LazyArray):
            if payload._value is None:
                return False
            payload = payload._value
        t = payload[0]
        if not _on_card(t):
            return False
        # the shards' elements (one copy of a replicated array), without
        # the shape arithmetic of ``nbytes``: this runs before every op
        total += t.numel() * t.element_size() * (len(payload) if x.split is not None else 1)
    return total < _EAGER_BELOW_BYTES


def _placement_reason(comm) -> Optional[str]:
    """Why a program cannot run over ``comm``'s shards, or None: a program
    runs on one device (``multi_device``), in one process
    (``spans_processes``: a chain that one process forces and another does
    not would call the mesh's verbs in a different order in each)."""
    if comm.spans_processes:
        return "spans_processes"
    devices = comm.devices
    return None if all(d == devices[0] for d in devices) else "multi_device"


def _phys_node(x):
    """A DNDarray's physical payload as a recordable child: its pending
    node, or its shard tensors (the first only for a replicated array,
    which the eager engines compute once)."""
    payload = x._payload
    if isinstance(payload, LazyArray):
        return payload if payload._value is None else payload._value
    return _leaf(payload if x.split is not None else payload[:1])


def _logical_node(x):
    """:func:`_phys_node` with the padding cut off inside the program: each
    shard narrowed to its valid rows (the mask step of pad+mask)."""
    n = _phys_node(x)
    if x.padded:
        n = record(_unpad_op, (n,), axis=x.split, counts=x.counts_displs()[0])
    return n


def _needs_grad(*children) -> bool:
    """Whether autograd would record an op on these children: the eager
    engines build the graph at the op, so such ops stay eager."""
    if not torch.is_grad_enabled():
        return False
    for c in children:
        if isinstance(c, tuple) and c[0].requires_grad:
            return True
    return False


def _wrap(node: LazyArray, gshape, split, ref):
    """A DNDarray over a pending node, with ``ref``'s device and mesh."""
    gshape = tuple(int(s) for s in gshape)
    if split is not None and (len(gshape) == 0 or split >= len(gshape)):
        split = None
    obj = DNDarray.__new__(DNDarray)
    obj._DNDarray__shards = node
    obj._DNDarray__gshape = gshape
    obj._DNDarray__dtype = _types.canonical_heat_type(node.dtype)
    obj._DNDarray__split = split
    obj._DNDarray__device = ref.device
    obj._DNDarray__comm = ref.comm
    register_root(obj)
    return obj


def wrap_node(node: LazyArray, gshape, split, ref):
    """Public :func:`_wrap`."""
    if DNDarray is None:
        _resolve_siblings()
    return _wrap(node, gshape, split, ref)


def _block_shape(shape, split, p) -> tuple:
    shape = list(shape)
    n = shape[split]
    shape[split] = -(-n // p) if n else 0
    return tuple(shape)


def _aligned(x, out_shape, out_split, comm, dtype):
    """One binary operand recorded in the result's layout, as the eager
    engine's ``_aligned`` cuts it: its own shards where it is split along
    the result's split axis, else its logical whole, sent whole to every
    shard where it is broadcast along that axis, else cut into blocks."""
    if isinstance(x, _SCALARS):
        return cast(_scalar_leaf(x, comm.devices[0]), dtype)
    k = None if out_split is None else out_split - (len(out_shape) - x.ndim)
    child = _phys_node(x)
    if k is not None and x.split == k and x.gshape[k] != 1:
        return cast(child, dtype)
    if x.split is not None and comm.size > 1:
        child = record(_gather_op, (child,), axis=x.split, size=x.gshape[x.split])
    whole = cast(child, dtype)
    if k is None or k < 0 or x.gshape[k] == 1:
        return whole
    return record(_blocks_op, (whole,), axis=k, devices=comm.devices)


def defer_binary(operation, t1, t2, dtype: torch.dtype, fn_kwargs):
    """Record a binary elementwise or broadcast op; None: use the eager
    engine. The deferral rules are the reference's: identical layouts,
    an array with a scalar, and broadcasts of unpadded operands defer;
    padded broadcasts, mixed meshes and foreign operands do not."""
    if DNDarray is None:
        _resolve_siblings()
    if _small_on_card(t1, t2):
        return _unfused("binary", "small_on_card")
    if getattr(operation, "_no_fusion", False):
        return _unfused("binary", "no_fusion_op")
    d1, d2 = isinstance(t1, DNDarray), isinstance(t2, DNDarray)
    ref = t1 if d1 else t2
    if d1 and d2:
        if t1.comm is not t2.comm:
            return _unfused("binary", "mixed_comm")
        if not (t1.split == t2.split and t1.shape == t2.shape) and (t1.padded or t2.padded):
            return _unfused("binary", "padded_broadcast")
    elif not ((d1 and isinstance(t2, _SCALARS)) or (d2 and isinstance(t1, _SCALARS))):
        return _unfused("binary", "foreign_operand")
    comm = ref.comm
    reason = _placement_reason(comm)
    if reason is not None:
        return _unfused("binary", reason)
    shapes = [t.gshape if isinstance(t, DNDarray) else () for t in (t1, t2)]
    out_shape = _broadcast_shapes(*shapes)  # the eager engine's shape error
    out_split = None
    for t, sh in zip((t1, t2), shapes):
        if isinstance(t, DNDarray) and t.split is not None:
            out_split = t.split + len(out_shape) - len(sh)
            break
    if not out_shape:
        out_split = None
    width = comm.size if out_split is not None else 1
    try:
        a = _aligned(t1, out_shape, out_split, comm, dtype)
        b = _aligned(t2, out_shape, out_split, comm, dtype)
        if _needs_grad(a, b):
            return _unfused("binary", "autograd")
        node = record(operation, (a, b), width=width, **fn_kwargs)
    except Exception as exc:  # narrowed: one policy decides what falls back
        if not resilience.record_recoverable(exc):
            raise
        return _unfused("binary", "record_failed:" + type(exc).__name__)
    expected = tuple(out_shape) if out_split is None else _block_shape(out_shape, out_split, comm.size)
    if node.shape != expected:
        return _unfused("binary", "shape_changed")
    return _wrap(node, out_shape, out_split, ref)


def defer_local(operation, x, promote: Optional[torch.dtype], kwargs):
    """Record a unary elementwise op on the physical shards (padding stays
    in the padding); None: use the eager engine."""
    if DNDarray is None:
        _resolve_siblings()
    if _small_on_card(x):
        return _unfused("local", "small_on_card")
    if getattr(operation, "_no_fusion", False):
        return _unfused("local", "no_fusion_op")
    if not hashable_kwargs(kwargs):
        return _unfused("local", "unhashable_kwargs")
    reason = _placement_reason(x.comm)
    if reason is not None:
        return _unfused("local", reason)
    n = _phys_node(x)
    if _needs_grad(n):
        return _unfused("local", "autograd")
    shape = _aval(n)[1]
    try:
        if promote is not None:
            n = cast(n, promote)
        node = record(operation, (n,), **kwargs)
    except Exception as exc:  # narrowed: one policy decides what falls back
        if not resilience.record_recoverable(exc):
            raise
        return _unfused("local", "record_failed:" + type(exc).__name__)
    if node.shape != shape:
        return _unfused("local", "shape_changed")
    return _wrap(node, x.gshape, x.split, x)


def defer_reduce(reduction, across, x, axes, keepdims, gshape, split, dtype: Optional[torch.dtype]):
    """Record a reduction over ``axes``: each shard alone where every
    result element's inputs lie in one shard, else the across-split
    schedule ``across`` over the shards' valid rows, combined in shard
    order. None: use the eager engine."""
    if DNDarray is None:
        _resolve_siblings()
    if _small_on_card(x):
        return _unfused("reduce", "small_on_card")
    if getattr(reduction.local, "_no_fusion", False):
        return _unfused("reduce", "no_fusion_op")
    comm = x.comm
    reason = _placement_reason(comm)
    if reason is not None:
        return _unfused("reduce", reason)
    if _needs_grad(_phys_node(x)):
        return _unfused("reduce", "autograd")
    try:
        if x.split is None or x.split not in axes or comm.size == 1:
            node = record(_reduce_op, (_phys_node(x),), reduction=reduction, axes=axes, keepdims=keepdims)
        else:
            # the padding never enters a reduction across the split
            node = record(
                _across_op, (_logical_node(x),), reduction=reduction, across=across, axes=axes, keepdims=keepdims,
                gshape=x.gshape, split=x.split, devices=comm.devices, out_shape=gshape,
            )
        if dtype is not None:
            node = cast(node, dtype)
    except Exception as exc:  # narrowed: one policy decides what falls back
        if not resilience.record_recoverable(exc):
            raise
        return _unfused("reduce", "record_failed:" + type(exc).__name__)
    return _wrap(node, gshape, split, x)


def defer_cum(operation, combine, x, axis: int, dtype: Optional[torch.dtype]):
    """Record a cumulative op (the padding is a suffix, so a scan along any
    axis leaves the valid rows right); None: use the eager engine."""
    if DNDarray is None:
        _resolve_siblings()
    if _small_on_card(x):
        return _unfused("cum", "small_on_card")
    if getattr(operation, "_no_fusion", False):
        return _unfused("cum", "no_fusion_op")
    comm = x.comm
    reason = _placement_reason(comm)
    if reason is not None:
        return _unfused("cum", reason)
    n = _phys_node(x)
    if _needs_grad(n):
        return _unfused("cum", "autograd")
    shape = _aval(n)[1]
    try:
        if x.split == axis and comm.size > 1 and shape[axis] > 0:
            node = record(_cum_split_op, (n,), operation=operation, combine=combine, axis=axis, devices=comm.devices)
        else:
            node = record(_cum_op, (n,), operation=operation, axis=axis)
        if dtype is not None:
            node = cast(node, dtype)
    except Exception as exc:  # narrowed: one policy decides what falls back
        if not resilience.record_recoverable(exc):
            raise
        return _unfused("cum", "record_failed:" + type(exc).__name__)
    if node.shape != shape:
        return _unfused("cum", "shape_changed")
    return _wrap(node, x.gshape, x.split, x)


# ----------------------------------------------------------------------
# collective nodes: a deferred resplit, schedules over the shard list,
# global-view ops, matmul
# ----------------------------------------------------------------------
def defer_reshard(payload: LazyArray, gshape, split, axis, comm):
    """Record the redistribution of a pending chain from split ``split`` to
    split ``axis``: the logical whole gathered (:func:`_gather_op`, the
    padding cut off), then cut into the new split's pad+mask blocks
    (:func:`_blocks_op`, the eager ``_distribute``), so the shards after the
    force, padding included, are the eager ``resplit_``'s. Returns the new
    payload node, or None when recording fails recoverably (the caller then
    forces and resplits eagerly). The ``collective.reshard`` fault site is
    the caller's, before any metadata changes."""
    if DNDarray is None:
        _resolve_siblings()
    try:
        node = payload
        if split is not None:
            node = record(_gather_op, (node,), axis=split, size=int(gshape[split]))
        if axis is not None:
            node = record(_blocks_op, (node,), axis=axis, devices=comm.devices)
    except Exception as exc:  # narrowed: one policy decides what falls back
        if not resilience.record_recoverable(exc):
            raise
        return _unfused("reshard", "record_failed:" + type(exc).__name__)
    if telemetry._MODE:
        detail = "replicated" if axis is None else f"split={int(axis)}"
        telemetry.record_fused_collective("reshard", cid=node.cid, detail=detail)
    return node


def _operands(engine: str, comm, xs):
    """The children and view layouts of a schedule's operands: a DNDarray's
    physical payload with its (gshape, split), or a staged ``(node or
    shard tensors, gshape, split)`` triple. None (after the unfused
    breadcrumb) when one cannot be recorded."""
    children, metas, arrays = [], [], []
    for x in xs:
        if isinstance(x, DNDarray):
            if tuple(x.comm.devices) != tuple(comm.devices):
                return _unfused(engine, "mixed_comm")
            children.append(_phys_node(x))
            metas.append((x.gshape, x.split))
            arrays.append(x)
        elif isinstance(x, tuple) and len(x) == 3:
            child, gshape, split = x
            if isinstance(child, LazyArray):
                child = child if child._value is None else child._value
            elif not isinstance(child, _Leaf):
                child = _leaf(tuple(child))
            children.append(child)
            metas.append((tuple(gshape), split))
        else:
            return _unfused(engine, "foreign_operand")
    if _small_on_card(*arrays) and not any(isinstance(c, LazyArray) for c in children):
        return _unfused(engine, "small_on_card")
    if _needs_grad(*children):
        return _unfused(engine, "autograd")
    return children, metas


def _defer_kernel(engine: str, label: str, op, comm, kernel, xs, kw, site: bool = True, detail=None):
    """Record ``kernel`` over the shard views of ``xs`` as one ``op`` node
    (the selectors of a multi-output op), counted as the fused collective
    ``label``; ``site`` fires ``collective.<engine>`` first. None
    declines."""
    if DNDarray is None:
        _resolve_siblings()
    if not (_ENABLED and _COLLECTIVES):
        return None
    if getattr(kernel, "_no_fusion", False):
        return _unfused(engine, "no_fusion_op")
    if not hashable_kwargs(kw):
        return _unfused(engine, "unhashable_kwargs")
    reason = _placement_reason(comm)
    if reason is not None:
        return _unfused(engine, reason)
    got = _operands(engine, comm, xs)
    if got is None:
        return None
    children, metas = got
    if site and resilience._ARMED:
        # record time is dispatch time for the fault contract
        resilience.check("collective." + engine)
    static = dict(kernel=kernel, metas=tuple(metas), devices=comm.devices, kw=tuple(sorted(kw.items())))
    try:
        if getattr(op, "_fusion_multi", False):
            nodes = record_multi(op, tuple(children), **static)
        else:
            nodes = record(op, tuple(children), **static)
    except Exception as exc:  # narrowed: one policy decides what falls back
        if not resilience.record_recoverable(exc):
            raise
        return _unfused(engine, "record_failed:" + type(exc).__name__)
    if telemetry._MODE:
        cid = nodes[0].cid if isinstance(nodes, tuple) else nodes.cid
        telemetry.record_fused_collective(label, cid=cid, detail=detail)
    return nodes


def defer_apply(comm, kernel, xs, out_split=None, **kw):
    """Record a schedule over the shard list as one node of the chain (the
    port's deferred ``MeshCommunication.apply``): ``kernel(*views,
    comm=comm, **kw)`` over one shard view per operand of ``xs``
    (DNDarrays, whose pending chains stay pending, or staged ``(node or
    shard tensors, gshape, split)`` triples) returns the result's shard
    list. Inside the program ``comm`` runs the verbs' shard-order
    arithmetic, so the same kernel called eagerly with the arrays and their
    mesh gives the same shards. A tuple ``out_split`` declares a kernel of
    several outputs: a tuple of selector nodes comes back. Callers wrap the
    nodes (:func:`wrap_node`); None declines (collectives off, another
    mesh, record failures: the eager schedule). The ``collective.apply``
    fault site fires here, at record time."""
    op = _apply_multi_op if isinstance(out_split, (tuple, list)) else _apply_op
    return _defer_kernel("apply", "apply:" + _name(kernel), op, comm, kernel, xs, kw)


def defer_multi(fn, xs, comm=None, **kw):
    """Record a multi-output kernel over the operands' shard views (a
    view's ``larray`` is its global view), such as CholQR2's (Q, R, ok):
    :func:`defer_apply`'s multi-output form, counted as ``multi:<fn>``.
    Returns the tuple of selector nodes, or None to decline."""
    if comm is None:
        comm = next(x.comm for x in xs if isinstance(x, DNDarray))
    return _defer_kernel("multi", "multi:" + _name(fn), _apply_multi_op, comm, fn, xs, kw)


def defer_matmul(a, b, kernel, **kw):
    """Record a 2-D ``a @ b`` as one node: ``kernel(a_view, b_view,
    comm=comm, **kw)`` runs the eager case table's per-shard products and
    combine order, so pending operands stay pending and the contraction's
    combine runs inside the program. The case table: a split-0 ``a`` gives
    a split-0 result, a split-1 ``b`` a split-1 one, anything else a
    replicated one. Returns the wrapped DNDarray, or None to decline. The
    ``collective.matmul`` fault site is the caller's."""
    if DNDarray is None:
        _resolve_siblings()
    if a.ndim != 2 or b.ndim != 2:
        return _unfused("matmul", "non_2d")
    out_split = 0 if a.split == 0 else 1 if b.split == 1 else None
    detail = f"{a.split}x{b.split}->{out_split}"
    node = _defer_kernel("matmul", "matmul", _apply_op, a.comm, kernel, (a, b), kw, site=False, detail=detail)
    return None if node is None else _wrap(node, (a.gshape[0], b.gshape[1]), out_split, a)


def phys_node(x):
    """Public :func:`_phys_node`: a DNDarray's physical payload as a
    recordable child, for call sites that stage a cast before a schedule."""
    if DNDarray is None:
        _resolve_siblings()
    return _phys_node(x)


def program_hlo(x, optimized: bool = True) -> str:
    """The text of the program that would force ``x``'s pending chain (a
    DNDarray or a node): the GraphModule's code, one line per node, which
    ``telemetry.hlo_collective_counts`` reads. Nothing is forced, built or
    cached. ``optimized`` is accepted for the reference's signature: the
    plain module is what the CPU runs and what Inductor compiles on a
    card."""
    node = getattr(x, "_payload", x)
    if not (isinstance(node, LazyArray) and node._value is None):
        raise ValueError("program_hlo needs a pending recorded chain")
    sig, _, _ = _signature(node)
    return _build(sig).code
