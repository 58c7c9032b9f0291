"""Shape and distribution manipulations (reference:
heat/core/manipulations.py, heat_tpu/core/manipulations.py).

An op that keeps the split axis's rows where they are (``expand_dims``,
``squeeze``, ``flip`` or a transpose of other axes) works shard by shard;
the others assemble the logical array on the mesh's first device, compute
there, and cut the result into shards again.

Not ported yet: ``sort``, ``unique``, ``topk``, ``balance``,
``redistribute``, ``pad``, ``roll``, ``rot90``, ``tile``, ``repeat``, the
``split`` family and ``diag`` (the next slice).
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from . import types
from ._operations import _into_out
from .dndarray import DNDarray, _wrap
from .sanitation import sanitize_in
from .stride_tricks import broadcast_shapes, sanitize_axis, sanitize_shape

__all__ = [
    "broadcast_arrays",
    "broadcast_to",
    "column_stack",
    "concatenate",
    "expand_dims",
    "flatten",
    "flip",
    "fliplr",
    "flipud",
    "hstack",
    "moveaxis",
    "ravel",
    "reshape",
    "resplit",
    "row_stack",
    "shape",
    "squeeze",
    "stack",
    "swapaxes",
    "vstack",
]


def _like(x: DNDarray, shards, gshape, split) -> DNDarray:
    return DNDarray(shards, gshape, types.canonical_heat_type(shards[0].dtype), split, x.device, x.comm)


def broadcast_arrays(*arrays: DNDarray) -> List[DNDarray]:
    """Broadcast arrays against each other (reference manipulations.py:111-158)."""
    target = broadcast_shapes(*[a.gshape for a in arrays])
    return [broadcast_to(a, target) for a in arrays]


def broadcast_to(x: DNDarray, shape) -> DNDarray:
    """Broadcast to a new shape (reference manipulations.py:159-187)."""
    sanitize_in(x)
    shape = sanitize_shape(shape)
    result = x.larray.broadcast_to(shape).contiguous()
    split = None if x.split is None else x.split + len(shape) - x.ndim
    return _wrap(result, split, x.device, x.comm)


def column_stack(arrays: Sequence[DNDarray]) -> DNDarray:
    """Stack 1-D or 2-D arrays as columns (reference manipulations.py:188-246)."""
    return concatenate([reshape(a, (a.gshape[0], 1)) if a.ndim == 1 else a for a in arrays], axis=1)


def row_stack(arrays: Sequence[DNDarray]) -> DNDarray:
    """Stack arrays as rows (reference manipulations.py:3426-3483)."""
    return concatenate([reshape(a, (1, a.gshape[0])) if a.ndim == 1 else a for a in arrays], axis=0)


vstack = row_stack


def hstack(arrays: Sequence[DNDarray]) -> DNDarray:
    """Stack horizontally: along axis 0 for 1-D arrays, else axis 1
    (reference manipulations.py:1053-1127)."""
    arrays = list(arrays)
    return concatenate(arrays, axis=0 if all(a.ndim == 1 for a in arrays) else 1)


def concatenate(arrays: Sequence[DNDarray], axis: int = 0) -> DNDarray:
    """Join arrays along an existing axis in their promoted type; the result
    takes the first split operand's split (reference manipulations.py:247-511)."""
    if not isinstance(arrays, (tuple, list)):
        raise TypeError(f"arrays must be a list or a tuple, got {type(arrays)}")
    if not arrays:
        raise ValueError("need at least one array to concatenate")
    for a in arrays:
        sanitize_in(a)
    axis = sanitize_axis(arrays[0].gshape, axis)
    dtype = arrays[0].dtype
    for a in arrays[1:]:
        dtype = types.promote_types(dtype, a.dtype)
    first = arrays[0].comm.devices[0]
    result = torch.cat([a.larray.to(first, dtype.torch_type()) for a in arrays], dim=axis)
    split = next((a.split for a in arrays if a.split is not None), None)
    return _wrap(result, split, arrays[0].device, arrays[0].comm)


def expand_dims(a: DNDarray, axis: int) -> DNDarray:
    """Insert an axis of length 1 (reference manipulations.py:742-795)."""
    sanitize_in(a)
    axis = sanitize_axis(tuple(a.gshape) + (1,), axis)
    split = a.split if a.split is None or axis > a.split else a.split + 1
    gshape = a.gshape[:axis] + (1,) + a.gshape[axis:]
    return _like(a, [s.unsqueeze(axis) for s in a.shards], gshape, split)


def flatten(a: DNDarray) -> DNDarray:
    """Flatten to 1-D, split along 0 if ``a`` is split (reference
    manipulations.py:796-827)."""
    sanitize_in(a)
    return _wrap(a.larray.reshape(-1), 0 if a.split is not None else None, a.device, a.comm)


ravel = flatten


def flip(a: DNDarray, axis=None) -> DNDarray:
    """Reverse the order of the elements along axes (reference
    manipulations.py:828-887)."""
    sanitize_in(a)
    axis = sanitize_axis(a.gshape, axis)
    dims = tuple(range(a.ndim)) if axis is None else ((axis,) if isinstance(axis, int) else axis)
    if a.split is None or a.split not in dims:
        return _like(a, [torch.flip(s, dims) for s in a.shards], a.gshape, a.split)
    return _wrap(torch.flip(a.larray, dims), a.split, a.device, a.comm)


def fliplr(a: DNDarray) -> DNDarray:
    """Flip along axis 1 (reference manipulations.py:888-931)."""
    if a.ndim < 2:
        raise IndexError("Input must be >= 2-d.")
    return flip(a, 1)


def flipud(a: DNDarray) -> DNDarray:
    """Flip along axis 0 (reference manipulations.py:932-974)."""
    return flip(a, 0)


def moveaxis(x: DNDarray, source, destination) -> DNDarray:
    """Move axes to new positions (reference manipulations.py:1075-1127)."""
    from .linalg import basics

    source = (source,) if isinstance(source, int) else tuple(source)
    destination = (destination,) if isinstance(destination, int) else tuple(destination)
    source = tuple(sanitize_axis(x.gshape, s) for s in source)
    destination = tuple(sanitize_axis(x.gshape, d) for d in destination)
    if len(source) != len(destination):
        raise ValueError("source and destination arguments must have the same number of elements")
    order = [n for n in range(x.ndim) if n not in source]
    for dest, src in sorted(zip(destination, source)):
        order.insert(dest, src)
    return basics.transpose(x, order)


def reshape(a: DNDarray, *shape, new_split: Optional[int] = None) -> DNDarray:
    """Reshape to a new global shape, redistributed along ``new_split``:
    by default the input's split where the new shape has that axis, else 0
    (reference manipulations.py:323)."""
    sanitize_in(a)
    if len(shape) == 1 and isinstance(shape[0], (tuple, list)):
        shape = tuple(shape[0])
    shape = list(shape)
    unknown = [i for i, s in enumerate(shape) if s == -1]
    if len(unknown) > 1:
        raise ValueError("can only specify one unknown dimension")
    if unknown:
        known = int(np.prod([s for s in shape if s != -1])) or 1
        shape[unknown[0]] = a.size // known
    shape = sanitize_shape(shape)
    if int(np.prod(shape)) != a.size:
        raise ValueError(f"cannot reshape array of size {a.size} into shape {tuple(shape)}")
    if new_split is None:
        if a.split is None or not shape:
            new_split = None
        else:
            new_split = a.split if a.split < len(shape) else 0
    else:
        new_split = sanitize_axis(shape, new_split)
    return _wrap(a.larray.reshape(shape), new_split, a.device, a.comm)


def resplit(arr: DNDarray, axis: Optional[int] = None) -> DNDarray:
    """Out-of-place redistribution to a new split axis; a copy when the axis
    is the same (reference manipulations.py:350)."""
    sanitize_in(arr)
    axis = sanitize_axis(arr.gshape, axis)
    if axis == arr.split:
        from . import memory

        return memory.copy(arr)
    return _wrap(arr.larray, axis, arr.device, arr.comm)


def shape(a: DNDarray) -> Tuple[int, ...]:
    """The global shape (reference manipulations.py:417)."""
    sanitize_in(a)
    return a.gshape


def squeeze(x: DNDarray, axis=None) -> DNDarray:
    """Remove axes of length 1 (reference manipulations.py:3602-3713)."""
    sanitize_in(x)
    if axis is not None:
        axis = sanitize_axis(x.gshape, axis)
        axes = (axis,) if isinstance(axis, int) else tuple(axis)
        for ax in axes:
            if x.gshape[ax] != 1:
                raise ValueError(f"Dimension along axis {ax} is not 1 for shape {x.gshape}")
    else:
        axes = tuple(i for i, s in enumerate(x.gshape) if s == 1)
    gshape = tuple(s for i, s in enumerate(x.gshape) if i not in axes)
    if x.split is not None and x.split in axes:
        return _wrap(x.larray.reshape(gshape), None, x.device, x.comm)
    split = None if x.split is None else x.split - sum(1 for ax in axes if ax < x.split)
    shards = [s.squeeze(axes) if axes else s for s in x.shards]
    return _like(x, shards, gshape, split)


def stack(arrays: Sequence[DNDarray], axis: int = 0, out=None) -> DNDarray:
    """Join arrays of one shape along a new axis (reference
    manipulations.py:3714-3833)."""
    if not isinstance(arrays, (tuple, list)):
        raise TypeError(f"arrays must be a list or a tuple, got {type(arrays)}")
    arrays = list(arrays)
    if len(arrays) < 2:
        raise ValueError("stack expects at least two arrays")
    for a in arrays:
        sanitize_in(a)
        if a.gshape != arrays[0].gshape:
            raise ValueError(
                f"all input arrays must have the same shape, got {[a.gshape for a in arrays]}"
            )
    axis = sanitize_axis(tuple(arrays[0].gshape) + (1,), axis)
    return _into_out(concatenate([expand_dims(a, axis) for a in arrays], axis=axis), out)


def swapaxes(x: DNDarray, axis1: int, axis2: int) -> DNDarray:
    """Interchange two axes (reference manipulations.py:680)."""
    from .linalg import basics

    axis1 = sanitize_axis(x.gshape, axis1)
    axis2 = sanitize_axis(x.gshape, axis2)
    order = list(range(x.ndim))
    order[axis1], order[axis2] = order[axis2], order[axis1]
    return basics.transpose(x, order)
