"""The eager operator engines (reference: heat/core/_operations.py;
heat_tpu/core/_operations.py as it runs with ``HEAT_TPU_FUSION=0``).

Every operator of the library goes through one of four engines, which do
the dtype promotion, the split bookkeeping and the per-shard work on the
pad+mask layout of :class:`~heat_tpu_torch.core.dndarray.DNDarray`:

* :func:`__binary_op`: elementwise on two operands, computed shard by shard
  on the result's layout; an operand that is broadcast along the split axis
  goes to every shard whole, one that is not split is cut into the result's
  blocks, and a same-shape operand split along another axis is resplit
  first (reference :83-100);
* :func:`__local_op`: elementwise on one operand, shard by shard;
* :func:`__reduce_op`: a reduction. Across the split axis of more than one
  shard each shard reduces its valid rows (``lshards``) and the partials
  are combined in shard order through :meth:`MeshCommunication.allreduce`;
  over other axes, or on one shard, each physical shard is reduced, its
  padding landing in the result's padding;
* :func:`__cum_op`: a cumulative op; along the split axis each shard's local
  result is combined with an ``exscan`` of the shards' totals.

The padding of a shard is garbage that stays in the padding. A replicated
array (``split=None``) is computed once, on the mesh's first device, and
placed on the others. Over a mesh whose ranks span processes every shard
list is this process's (``comm.local_devices``), a replicated value is
computed in every process on its ``home`` device, and every combine across
the split is the mesh's verb, which folds in rank order across processes
as in one. Nothing here reads a value back to the host, except
the ``ht.errstate`` check of each result while a policy is active
(heat_tpu/core/_operations.py:29-37). Each engine counts its dispatches in
:mod:`.telemetry`.

Each engine first offers its op to the fusion recorder (``core/fusion.py``;
reference _operations.py:111-129, 222-234, 312-333, 397-406): a deferred op
is a node of a pending chain, counted as a ``fused`` dispatch, and the
chain runs as one program at its forcing point. What cannot defer
(``out=``, ``where=``, unhashable keyword arguments, a padded broadcast, a
recorder turned off by ``HEAT_TPU_FUSION=0``) runs eagerly below and leaves
its reason in ``telemetry.unfused_reasons()``. The same-shape operand on
another split axis is resplit first, a collective that forces its chain.
"""

from __future__ import annotations

from typing import Callable, List, NamedTuple, Optional, Tuple, Union

import numpy as np
import torch

from . import fusion, resilience, telemetry, types
from .communication import SPLIT_AXIS, MeshCommunication, _combine, _neutral
from .dndarray import DNDarray, _distribute
from .sanitation import sanitize_in, sanitize_mesh, sanitize_out
from .stride_tricks import broadcast_shapes, sanitize_axis

__all__: List[str] = []  # private module, mirrors the reference

_SCALARS = (int, float, bool, complex, np.number, np.bool_)


def _aligned(x, out_shape, out_split, comm: MeshCommunication, dtype: torch.dtype) -> List:
    """One operand cast to ``dtype`` and cut to the result's layout: one
    tensor per shard of a result split along ``out_split`` (the operand's
    own shards where it is split along that axis, the whole operand where
    it is broadcast along it, else its blocks), or the logical tensor on the
    ``home`` device for a replicated result."""
    first = comm.home
    if isinstance(x, _SCALARS):
        devices = comm.local_devices if out_split is not None else (first,)
        return [torch.full((), x, dtype=dtype, device=d) for d in devices]
    k = None if out_split is None else out_split - (len(out_shape) - len(_shape(x)))
    if isinstance(x, DNDarray):
        if k is not None and x.split == k and x.gshape[k] != 1:
            return [s.to(dtype) for s in x.shards]
        whole = x.larray.to(dtype)
    else:
        whole = torch.as_tensor(np.asarray(x) if isinstance(x, (list, tuple)) else x).to(first, dtype)
    if k is None:
        return [whole]
    if k < 0 or whole.shape[k] == 1:
        return [whole.to(d) for d in comm.local_devices]
    return _distribute(whole, k, comm)


def _nonfinite_checked(res: DNDarray) -> DNDarray:
    """The numeric error policy (``ht.errstate``) on an engine's result: its
    logical shards (never the padding) take one ``isfinite`` reduction each
    and one scalar read. Two module-attribute reads when no policy is
    active (the global one or a session's)."""
    if resilience._ERRSTATE is not None or resilience._TLS_ARMED:
        resilience.check_nonfinite(res.lshards if res.split is not None else res.shards[:1], "eager")
    return res


def _shape(x) -> Tuple[int, ...]:
    if isinstance(x, DNDarray):
        return x.gshape
    return tuple(x.shape) if hasattr(x, "shape") else np.shape(x)


def _result(shards, gshape, split, ref: DNDarray) -> DNDarray:
    """Wrap per-shard results (or one logical tensor for ``split=None``)."""
    gshape = tuple(gshape)
    if split is None or not gshape:
        whole = shards[0]
        return DNDarray(
            _distribute(whole, None, ref.comm), gshape, types.canonical_heat_type(whole.dtype),
            None, ref.device, ref.comm,
        )
    return DNDarray(shards, gshape, types.canonical_heat_type(shards[0].dtype), split, ref.device, ref.comm)


def _into_out(result: DNDarray, out: Optional[DNDarray]) -> DNDarray:
    """Store ``result`` in ``out`` when given (reference: out's payload and
    split are replaced, its dtype kept)."""
    if out is None:
        return result
    sanitize_out(out, result.gshape, result.split, result.device)
    out._replace(
        [s.to(out.dtype.torch_type()) for s in result.shards], result.gshape, result.split
    )
    return out


def __binary_op(
    operation: Callable,
    t1,
    t2,
    out: Optional[DNDarray] = None,
    where=None,
    fn_kwargs: Optional[dict] = None,
) -> DNDarray:
    """Generic distributed binary operation (reference _operations.py:53).

    Both operands are cast to :func:`~.types.result_type` first, so an op's
    own promotion (true division of integers) survives. The result is split
    along the first split operand's axis, shifted by broadcasting. With
    ``where``, positions where it is False keep ``out``'s value (or 0)."""
    fn_kwargs = fn_kwargs or {}
    if not isinstance(t1, DNDarray) and not isinstance(t2, DNDarray):
        raise TypeError(
            f"Only DNDarrays and numeric scalars are supported, but input was {type(t1)}, {type(t2)}"
        )
    sanitize_mesh(t1, t2, where, out)
    ref = t1 if isinstance(t1, DNDarray) else t2
    comm = ref.comm
    if (
        isinstance(t1, DNDarray)
        and isinstance(t2, DNDarray)
        and t1.split is not None
        and t2.split is not None
        and t1.split != t2.split
        and t1.shape == t2.shape
    ):
        from .manipulations import resplit

        if telemetry._MODE:
            # the same-shape operand on another split axis moves to the first
            # operand's (heat_tpu/core/_operations.py:93-102)
            # heat-lint: disable=H005 — one dispatch, one site (collective.reshard fires in resplit below)
            telemetry.record_collective(
                "reshard", SPLIT_AXIS, t2.nbytes, telemetry._dtype_name(t2.dtype.torch_type())
            )
        t2 = resplit(t2, t1.split)
    dtype = types.result_type(t1, t2).torch_type()
    if out is None and where is None and fusion.active() and fusion.hashable_kwargs(fn_kwargs):
        lazy = fusion.defer_binary(operation, t1, t2, dtype, fn_kwargs)
        if lazy is not None:
            if telemetry._MODE:
                telemetry.record_dispatch("binary", fused=True)
            return lazy
        # defer_binary left its own reason
    elif telemetry._MODE:
        telemetry.record_unfused(
            "binary",
            "out=" if out is not None
            else "where=" if where is not None
            else "fusion_off" if not fusion.active()
            else "unhashable_kwargs",
        )
    if telemetry._MODE:
        telemetry.record_dispatch("binary", fused=False)
    shapes = [_shape(t) for t in (t1, t2)]
    out_shape = broadcast_shapes(*shapes)
    out_split = None
    for t, sh in zip((t1, t2), shapes):
        if isinstance(t, DNDarray) and t.split is not None:
            out_split = t.split + len(out_shape) - len(sh)
            break
    a = _aligned(t1, out_shape, out_split, comm, dtype)
    b = _aligned(t2, out_shape, out_split, comm, dtype)
    shards = [operation(x, y, **fn_kwargs) for x, y in zip(a, b)]
    if where is not None:
        w = _aligned(where, out_shape, out_split, comm, torch.bool)
        if out is not None:
            base = _aligned(out, out_shape, out_split, comm, shards[0].dtype)
        else:
            base = [torch.zeros((), dtype=shards[0].dtype, device=s.device) for s in shards]
        shards = [torch.where(c, r, z) for c, r, z in zip(w, shards, base)]
    return _nonfinite_checked(_into_out(_result(shards, out_shape, out_split, ref), out))


def __local_op(
    operation: Callable,
    x: DNDarray,
    out: Optional[DNDarray] = None,
    no_cast: bool = False,
    **kwargs,
) -> DNDarray:
    """Generic elementwise operation without communication (reference
    _operations.py:211). Exact types are promoted to floating first unless
    ``no_cast``."""
    sanitize_in(x)
    dtype = None
    if not no_cast and types.heat_type_is_exact(x.dtype):
        dtype = types.promote_types(x.dtype, types.float32).torch_type()
    if out is None and fusion.active():
        lazy = fusion.defer_local(operation, x, dtype, kwargs)
        if lazy is not None:
            if telemetry._MODE:
                telemetry.record_dispatch("local", fused=True)
            return lazy
    elif telemetry._MODE:
        telemetry.record_unfused("local", "out=" if out is not None else "fusion_off")
    if telemetry._MODE:
        telemetry.record_dispatch("local", fused=False)
    shards = x.shards if x.split is not None else x.shards[:1]
    shards = [operation(s if dtype is None else s.to(dtype), **kwargs) for s in shards]
    return _nonfinite_checked(_into_out(_result(shards, x.gshape, x.split, x), out))


class Reduction(NamedTuple):
    """How the reduce engine computes one reduction.

    ``local(t, dims, keepdim)`` reduces a tensor over ``dims`` (a tuple,
    empty only for a 0-d tensor); ``combine`` names the op (or is the
    callable) that merges the shards' partials in shard order. ``direct``,
    when given, replaces ``local`` where one tensor holds every reduced
    element (a mean, not a sum); ``across(x, axes, reduction)``, when given, replaces
    the partial-and-combine schedule across the split axis and returns the
    result, reduced dims kept, on the mesh's first device."""

    local: Callable
    combine: Union[str, Callable]
    direct: Optional[Callable] = None
    across: Optional[Callable] = None


def _axes(x: DNDarray, axis) -> Tuple[int, ...]:
    axis = sanitize_axis(x.gshape, axis)
    if axis is None or x.ndim == 0:
        return tuple(range(x.ndim))
    return (axis,) if isinstance(axis, int) else tuple(sorted(axis))


def _reduced_shape(shape, axes, keepdims: bool) -> Tuple[int, ...]:
    if keepdims:
        return tuple(1 if i in axes else s for i, s in enumerate(shape))
    return tuple(s for i, s in enumerate(shape) if i not in axes)


def _reduced_split(split, axes, keepdims: bool) -> Optional[int]:
    if split is None or split in axes:
        return None
    return split if keepdims else split - sum(1 for a in axes if a < split)


def __reduce_op(
    reduction: Reduction,
    x: DNDarray,
    axis,
    out: Optional[DNDarray] = None,
    keepdims: bool = False,
    dtype=None,
) -> DNDarray:
    """Generic distributed reduction (reference _operations.py:281-382)."""
    sanitize_in(x)
    axes = _axes(x, axis)
    gshape = _reduced_shape(x.gshape, axes, keepdims)
    split = _reduced_split(x.split, axes, keepdims)
    torch_dtype = None if dtype is None else types.canonical_heat_type(dtype).torch_type()
    if out is None and fusion.active():
        lazy = fusion.defer_reduce(
            reduction, reduction.across or _across_split, x, axes, keepdims, gshape, split, torch_dtype
        )
        if lazy is not None:
            if telemetry._MODE:
                telemetry.record_dispatch("reduce", fused=True)
                if x.split is not None and x.split in axes and x.comm.is_distributed():
                    # the combine across the split runs inside the program: a
                    # collective node (heat_tpu/core/_operations.py:322-329)
                    telemetry.record_fused_collective("reduce.psum")
            return lazy
    elif telemetry._MODE:
        telemetry.record_unfused("reduce", "out=" if out is not None else "fusion_off")
    if telemetry._MODE:
        telemetry.record_dispatch("reduce", fused=False)
    direct = reduction.direct or reduction.local
    if x.split is None or x.split not in axes or x.comm.size == 1:
        # each result element's inputs lie in one shard: nothing to combine
        source = x.shards if x.split is not None else x.shards[:1]
        shards = [direct(s, axes, keepdims) for s in source]
    else:
        total = (reduction.across or _across_split)(x, axes, reduction)
        if not keepdims:
            total = total.reshape(gshape)
        shards = [total]
    if torch_dtype is not None:
        shards = [s.to(torch_dtype) for s in shards]
    return _nonfinite_checked(_into_out(_result(shards, gshape, split, x), out))


def _across_split(x: DNDarray, axes, reduction: Reduction) -> torch.Tensor:
    """A reduction over axes that include the split axis: each shard's valid
    rows reduce to a partial (keeping the reduced dims), and the partials
    combine in shard order; a shard without valid rows contributes the
    combine's neutral element. Returns the result on the ``home`` device."""
    comm = x.comm
    counts = comm.local_counts_displs(x.gshape, x.split)[0]
    lshards = x.lshards
    partials = [reduction.local(s, axes, True) if c else None for s, c in zip(lshards, counts)]
    like = next((t for t in partials if t is not None), None)
    if like is None and x.gshape[x.split]:
        # this process's ranks hold no row, another's do: a padding row
        # gives the neutral element's shape and type
        like = reduction.local(x.shards[0].narrow(x.split, 0, 1), axes, True)
    elif like is None:  # no element at all: the local op decides (0 or an error)
        like = partials[0] = reduction.local(lshards[0], axes, True)
    partials = [
        t if t is not None else _neutral(reduction.combine, like).to(dev)
        for t, dev in zip(partials, comm.local_devices)
    ]
    return x.comm.allreduce(partials, reduction.combine)[0]


def __cum_op(
    operation: Callable,
    combine: str,
    x: DNDarray,
    axis: int,
    out: Optional[DNDarray] = None,
    dtype=None,
) -> DNDarray:
    """Generic cumulative operation (reference _operations.py:384).

    ``operation(t, dim)`` is the local cumulative op and ``combine`` ("sum"
    or "prod") its binary op. Along the split axis shard d's local result is
    combined with the exclusive scan of the shards' totals (their last
    rows); the padding is a suffix, so every shard before one with valid
    rows is full."""
    sanitize_in(x)
    axis = sanitize_axis(x.gshape, axis)
    if not isinstance(axis, int):
        raise TypeError("axis must be a single integer for cumulative operations")
    torch_dtype = None if dtype is None else types.canonical_heat_type(dtype).torch_type()
    if out is None and fusion.active():
        lazy = fusion.defer_cum(operation, combine, x, axis, torch_dtype)
        if lazy is not None:
            if telemetry._MODE:
                telemetry.record_dispatch("cum", fused=True)
            return lazy
    elif telemetry._MODE:
        telemetry.record_unfused("cum", "out=" if out is not None else "fusion_off")
    if telemetry._MODE:
        telemetry.record_dispatch("cum", fused=False)
    source = x.shards if x.split is not None else x.shards[:1]
    shards = [operation(s, axis) for s in source]
    if x.split == axis and x.comm.size > 1 and shards[0].shape[axis] > 0:
        last = shards[0].shape[axis] - 1
        offsets = x.comm.exscan([s.narrow(axis, last, 1) for s in shards], combine)
        shards = [_combine(combine)(s, o) for s, o in zip(shards, offsets)]
    if torch_dtype is not None:
        shards = [s.to(torch_dtype) for s in shards]
    return _nonfinite_checked(_into_out(_result(shards, x.gshape, x.split, x), out))
