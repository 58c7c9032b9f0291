"""Shape and distribution manipulations (reference:
heat/core/manipulations.py, heat_tpu/core/manipulations.py).

An op that keeps the split axis's rows where they are (``expand_dims``,
``squeeze``, ``flip``, a transpose of other axes, a sort along another axis)
works shard by shard; the others assemble the logical array on the mesh's
first device, compute there, and cut the result into shards again. A result
never shares storage with its input.

Along the split axis of more than one shard, ``sort`` runs the reference's
merge-exchange network over the shard list (:func:`_dist_sort`), so that no
device holds more than two blocks; ``unique`` rides it and gathers only the
unique values, and ``topk`` merges the shards' local top-k partials with
one ``allreduce`` (:func:`mpi_topk`).
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from . import fusion, resilience, types
from ._operations import _into_out
from .dndarray import DNDarray, _wrap
from .sanitation import sanitize_in, warn_replicated
from .stride_tricks import broadcast_shapes, sanitize_axis, sanitize_shape

__all__ = [
    "balance",
    "broadcast_arrays",
    "broadcast_to",
    "collect",
    "column_stack",
    "concatenate",
    "diag",
    "diagonal",
    "dsplit",
    "expand_dims",
    "flatten",
    "flip",
    "fliplr",
    "flipud",
    "hsplit",
    "hstack",
    "moveaxis",
    "mpi_topk",
    "pad",
    "ravel",
    "redistribute",
    "repeat",
    "reshape",
    "resplit",
    "roll",
    "rot90",
    "row_stack",
    "shape",
    "sort",
    "split",
    "squeeze",
    "stack",
    "swapaxes",
    "tile",
    "topk",
    "unique",
    "vsplit",
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
    first_shape = arrays[0].gshape
    for i, a in enumerate(arrays[1:], 1):
        if a.ndim != len(first_shape):
            raise ValueError(
                "all the input arrays must have same number of dimensions, but the array at "
                f"index 0 has {len(first_shape)} dimension(s) and the array at index {i} has {a.ndim} dimension(s)"
            )
        for d, (m, n) in enumerate(zip(first_shape, a.gshape)):
            if d != axis and m != n:
                raise ValueError(
                    "all the input array dimensions except for the concatenation axis must match "
                    f"exactly, but along dimension {d}, the array at index 0 has size {m} and the "
                    f"array at index {i} has size {n}"
                )
    dtype = arrays[0].dtype
    for a in arrays[1:]:
        dtype = types.promote_types(dtype, a.dtype)
    first = arrays[0].comm.devices[0]
    result = torch.cat([a.larray.to(first, dtype.torch_type()) for a in arrays], dim=axis)
    split = next((a.split for a in arrays if a.split is not None), None)
    return _wrap(result, split, arrays[0].device, arrays[0].comm)


def expand_dims(a: DNDarray, axis) -> DNDarray:
    """Insert axes of length 1 at the positions ``axis`` (an int or a tuple)
    of the result, as numpy does (reference manipulations.py:742-795)."""
    sanitize_in(a)
    n_new = len(axis) if isinstance(axis, (tuple, list)) else 1
    out_ndim = a.ndim + n_new
    axes = sanitize_axis((1,) * out_ndim, axis)
    axes = sorted(axes) if isinstance(axes, tuple) else [axes]
    kept = [d for d in range(out_ndim) if d not in axes]  # where the old axes go
    split = None if a.split is None else kept[a.split]
    gshape = [1] * out_ndim
    for d, n in zip(kept, a.gshape):
        gshape[d] = n
    shards = a.shards
    for ax in axes:
        shards = [s.unsqueeze(ax) for s in shards]
    return _like(a, shards, tuple(gshape), split)


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
    is the same (reference manipulations.py:350). A pending chain stays
    pending, the source's and the result's (heat_tpu/core/manipulations.py:
    355-378)."""
    sanitize_in(arr)
    axis = sanitize_axis(arr.gshape, axis)
    if axis == arr.split:
        from . import memory

        return memory.copy(arr)
    if resilience._ARMED:
        resilience.check("collective.reshard")
    payload = arr._payload
    if isinstance(payload, fusion.LazyArray) and payload._value is None and fusion.collectives_active():
        node = fusion.defer_reshard(payload, arr.gshape, arr.split, axis, arr.comm)
        if node is not None:
            return fusion.wrap_node(node, arr.gshape, axis, arr)
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


def _fresh(t: torch.Tensor) -> torch.Tensor:
    """``t`` as a contiguous tensor that shares no storage with its source."""
    return t.clone(memory_format=torch.contiguous_format) if t._is_view() else t.contiguous()


def _wrap_result(t: torch.Tensor, split: Optional[int], ref: DNDarray) -> DNDarray:
    """Wrap a new logical tensor like ``ref``; a split past its dims is None."""
    if t.ndim == 0 or (split is not None and split >= t.ndim):
        split = None
    return _wrap(_fresh(t), split, ref.device, ref.comm)


def balance(array: DNDarray, copy: bool = False) -> DNDarray:
    """A balanced array (reference manipulations.py:79): the pad+mask layout
    always is, so ``array`` itself, or a copy."""
    from . import memory

    return memory.copy(array) if copy else array


def collect(arr: DNDarray, target_rank: int = 0) -> DNDarray:
    """The whole array on every device, ``split=None`` (reference
    manipulations.py:105)."""
    return resplit(arr, None)


def redistribute(arr: DNDarray, lshape_map=None, target_map=None) -> DNDarray:
    """Out-of-place :meth:`DNDarray.redistribute_` (reference
    manipulations.py:297)."""
    from . import memory

    return memory.copy(arr).redistribute_(lshape_map=lshape_map, target_map=target_map)


def diag(a: DNDarray, offset: int = 0) -> DNDarray:
    """A 2-d array with ``a`` on a diagonal for 1-d ``a``, else
    :func:`diagonal` (reference manipulations.py:154)."""
    sanitize_in(a)
    if a.ndim == 1:
        return _wrap_result(torch.diag(a.larray, offset), 0 if a.split is not None else None, a)
    return diagonal(a, offset=offset)


def diagonal(a: DNDarray, offset: int = 0, dim1: int = 0, dim2: int = 1) -> DNDarray:
    """The diagonal of the (dim1, dim2) planes, as the last axis (reference
    manipulations.py:163); a split on either of them moves there."""
    sanitize_in(a)
    dim1, dim2 = sanitize_axis(a.gshape, dim1), sanitize_axis(a.gshape, dim2)
    if dim1 == dim2:
        raise ValueError(f"Dim1 and dim2 need to be different, got {dim1}, {dim2}")
    result = torch.diagonal(a.larray, offset=offset, dim1=dim1, dim2=dim2)
    split = a.split
    if split is not None:
        split = result.ndim - 1 if split in (dim1, dim2) else split - sum(1 for d in (dim1, dim2) if d < split)
    return _wrap_result(result, split, a)


def split(x: DNDarray, indices_or_sections, axis: int = 0) -> List[DNDarray]:
    """Split into sub-arrays along ``axis``, numpy's rules (reference
    manipulations.py:179-211): an int is a number of equal sections, a
    sequence the split points."""
    sanitize_in(x)
    axis = sanitize_axis(x.gshape, axis)
    if isinstance(indices_or_sections, DNDarray):
        indices_or_sections = indices_or_sections.tolist()
    if isinstance(indices_or_sections, (float, np.floating)):
        # numpy takes a float as a number of sections when it divides the axis
        if x.gshape[axis] % indices_or_sections:
            raise ValueError("array split does not result in an equal division")
        indices_or_sections = int(indices_or_sections)
    if isinstance(indices_or_sections, (int, np.integer)):
        if x.gshape[axis] % int(indices_or_sections) != 0:
            raise ValueError("array split does not result in an equal division")
        parts = torch.tensor_split(x.larray, int(indices_or_sections), dim=axis)
    else:
        indices = np.asarray(indices_or_sections)
        if indices.ndim > 1:  # numpy's error: an index must be a scalar
            raise TypeError("only integer scalar arrays can be converted to a scalar index")
        parts = torch.tensor_split(x.larray, [int(i) for i in indices.reshape(-1)], dim=axis)
    return [_wrap_result(p, x.split, x) for p in parts]


def dsplit(x: DNDarray, indices_or_sections) -> List[DNDarray]:
    """Split along axis 2 (reference manipulations.py:179)."""
    return split(x, indices_or_sections, axis=2)


def hsplit(x: DNDarray, indices_or_sections) -> List[DNDarray]:
    """Split along axis 1, axis 0 for 1-d (reference manipulations.py:187)."""
    return split(x, indices_or_sections, axis=1 if x.ndim >= 2 else 0)


def vsplit(x: DNDarray, indices_or_sections) -> List[DNDarray]:
    """Split along axis 0 (reference manipulations.py:196)."""
    return split(x, indices_or_sections, axis=0)


_PAD_MODES = (
    "constant", "edge", "empty", "linear_ramp", "maximum", "mean", "median", "minimum",
    "reflect", "symmetric", "wrap",
)


def _pad_index(n: int, before: int, after: int, mode: str, device) -> torch.Tensor:
    """The source position of each output position along one axis."""
    i = torch.arange(-before, n + after, device=device)
    if mode == "edge":
        return i.clamp(0, n - 1)
    if mode == "wrap":
        return i.remainder(n)
    if mode == "reflect":
        if n == 1:
            return torch.zeros_like(i)
        j = i.remainder(2 * n - 2)
        return torch.where(j < n, j, 2 * n - 2 - j)
    j = i.remainder(2 * n)  # symmetric
    return torch.where(j < n, j, 2 * n - 1 - j)


def _pad_axis(t: torch.Tensor, axis: int, before: int, after: int, mode: str, values) -> torch.Tensor:
    n = t.shape[axis]

    def block(fill, width: int) -> torch.Tensor:
        shape = list(t.shape)
        shape[axis] = width
        return fill.expand(shape) if isinstance(fill, torch.Tensor) else torch.full(shape, fill, dtype=t.dtype, device=t.device)

    def cast(v) -> torch.Tensor:
        return torch.as_tensor(v, dtype=torch.float64).to(t.dtype).to(t.device)

    if mode in ("constant", "empty"):
        lo, hi = (cast(v) for v in values) if mode == "constant" else (cast(0), cast(0))
        return torch.cat([block(lo, before), t, block(hi, after)], dim=axis)
    if n == 0:
        raise ValueError(f"can't extend empty axis {axis} using modes other than 'constant' or 'empty'")
    if mode in ("edge", "wrap", "reflect", "symmetric"):
        return t.index_select(axis, _pad_index(n, before, after, mode, t.device))
    if mode == "linear_ramp":
        parts = []
        for width, edge_at, end, reverse in ((before, 0, values[0], False), (after, n - 1, values[1], True)):
            edge = t.narrow(axis, edge_at, 1).double()
            shape = [1] * t.ndim
            shape[axis] = width
            k = torch.arange(width, dtype=torch.float64, device=t.device).reshape(shape) / max(width, 1)
            ramp = float(end) + (edge - float(end)) * k
            if not (t.is_floating_point() or t.is_complex()):
                ramp = ramp.floor()  # numpy's integer linspace rounds down
            parts.append((ramp.flip(axis) if reverse else ramp).to(t.dtype))
        return torch.cat([parts[0], t, parts[1]], dim=axis)
    # the statistic modes, over the whole axis
    if mode in ("maximum", "minimum"):
        stat = (torch.amax if mode == "maximum" else torch.amin)(t, dim=axis, keepdim=True)
    else:
        work = t.double() if not (t.is_floating_point() or t.is_complex()) else t
        stat = work.mean(dim=axis, keepdim=True) if mode == "mean" else work.quantile(0.5, dim=axis, keepdim=True)
        if not (t.is_floating_point() or t.is_complex()):
            stat = stat.round()
        stat = stat.to(t.dtype)
    return torch.cat([block(stat, before), t, block(stat, after)], dim=axis)


def pad(array: DNDarray, pad_width, mode: str = "constant", constant_values=0) -> DNDarray:
    """Pad with numpy's modes (reference manipulations.py:283): 'constant',
    'edge', 'reflect', 'symmetric', 'wrap', 'linear_ramp' (to 0), the
    statistics 'maximum', 'minimum', 'mean' and 'median' over the whole
    axis, and 'empty' (zeros here). The axes are padded in order, each over
    the array padded along the ones before it, as numpy does."""
    sanitize_in(array)
    if mode not in _PAD_MODES:
        raise ValueError(f"mode {mode!r} is not supported")
    if isinstance(pad_width, DNDarray):
        pad_width = pad_width.tolist()
    widths = np.asarray(pad_width)
    if widths.dtype.kind not in "iu":
        raise TypeError("`pad_width` must be of integral type.")
    widths = np.broadcast_to(widths.astype(np.int64), (array.ndim, 2))
    if (widths < 0).any():
        raise ValueError("index can't contain negative values")
    values = np.broadcast_to(np.asarray(constant_values if mode == "constant" else 0), (array.ndim, 2))
    t = array.larray
    for axis, (before, after) in enumerate(widths):
        if before or after:
            t = _pad_axis(t, axis, int(before), int(after), mode, values[axis].tolist())
    return _wrap_result(t, array.split, array)


def repeat(a, repeats, axis: Optional[int] = None) -> DNDarray:
    """Repeat each element (reference manipulations.py:306); over the
    flattened array for ``axis=None``."""
    from . import factories

    if not isinstance(a, DNDarray):
        a = factories.array(a)
    if isinstance(repeats, DNDarray):
        repeats = repeats.larray.to(a.comm.devices[0])
    elif isinstance(repeats, (list, tuple, np.ndarray)):
        repeats = torch.as_tensor(np.asarray(repeats), device=a.comm.devices[0])
    elif not isinstance(repeats, (int, np.integer)):
        raise TypeError(f"repeats must be int, list, tuple or DNDarray, got {type(repeats)}")
    else:
        repeats = int(repeats)
    if bool(repeats < 0) if isinstance(repeats, int) else bool((repeats < 0).any()):
        raise ValueError("repeats may not contain negative values.")
    t = a.larray
    if axis is None:
        t, axis_, split = t.reshape(-1), 0, 0 if a.split is not None else None
    else:
        axis_ = sanitize_axis(a.gshape, axis)
        split = a.split
    return _wrap_result(torch.repeat_interleave(t, repeats, dim=axis_), split, a)


def roll(x: DNDarray, shift, axis=None) -> DNDarray:
    """Roll elements along axes, over the flattened array for ``axis=None``
    (reference manipulations.py:384)."""
    sanitize_in(x)
    if isinstance(shift, DNDarray):
        shift = tuple(shift.tolist())
    if axis is None:
        return _wrap_result(torch.roll(x.larray, shift), x.split, x)
    axis = sanitize_axis(x.gshape, axis)
    return _wrap_result(torch.roll(x.larray, shift, axis), x.split, x)


def rot90(m: DNDarray, k: int = 1, axes=(0, 1)) -> DNDarray:
    """Rotate by 90 degrees ``k`` times in the plane of ``axes`` (reference
    manipulations.py:399)."""
    sanitize_in(m)
    if len(axes) != 2:
        raise ValueError("len(axes) must be 2")
    axes = tuple(sanitize_axis(m.gshape, ax) for ax in axes)
    if axes[0] == axes[1]:
        raise ValueError("axes must be different")
    split = m.split
    if split is not None and k % 2:
        split = {axes[0]: axes[1], axes[1]: axes[0]}.get(split, split)
    return _wrap_result(torch.rot90(m.larray, k, list(axes)), split, m)


def tile(x: DNDarray, reps) -> DNDarray:
    """Tile an array ``reps`` times per axis, numpy's rules (reference
    manipulations.py:691)."""
    sanitize_in(x)
    if isinstance(reps, DNDarray):
        reps = reps.tolist()
    reps = (int(reps),) if isinstance(reps, (int, np.integer)) else tuple(int(r) for r in reps)
    result = torch.tile(x.larray, reps)
    split = None if x.split is None else x.split + result.ndim - x.ndim
    return _wrap_result(result, split, x)


# ---------------------------------------------------------------------------
# sorting (reference manipulations.py:423-830)
# ---------------------------------------------------------------------------
def _lexsort_complex(t: torch.Tensor, dim: int, descending: bool) -> torch.Tensor:
    """Stable order of a complex tensor along ``dim``, real part first."""
    order = torch.sort(t.imag, dim=dim, descending=descending, stable=True)[1]
    real = torch.take_along_dim(t.real, order, dim)
    return torch.take_along_dim(order, torch.sort(real, dim=dim, descending=descending, stable=True)[1], dim)


def _stable_sort(t: torch.Tensor, dim: int, descending: bool):
    """(values, int64 indices) of the stable sort along ``dim``: ties keep
    their order, NaN goes last ascending and first descending."""
    if t.is_complex():
        order = _lexsort_complex(t, dim, descending)
        return torch.take_along_dim(t, order, dim), order
    return torch.sort(t, dim=dim, descending=descending, stable=True)


def sort(a: DNDarray, axis: int = -1, descending: bool = False, out=None):
    """Stable sort along an axis, returning ``(values, indices)`` (reference
    manipulations.py:423). Along another axis than the split each shard
    sorts its own rows; along the split axis of more than one shard the
    merge-exchange network of :func:`_dist_sort` runs."""
    sanitize_in(a)
    axis = sanitize_axis(a.gshape, axis)
    is_complex = a.dtype in (types.complex64, types.complex128)
    if a.split == axis and a.comm.size > 1 and is_complex:
        warn_replicated(
            "sort",
            "complex dtypes have no total-order pad sentinel for the merge-exchange "
            "network; sorting on the gathered view",
        )
    if a.split == axis and a.comm.size > 1 and not is_complex:
        vs, gs = _dist_sort(a, axis, descending)
        v = DNDarray(vs, a.gshape, a.dtype, a.split, a.device, a.comm)
        i = DNDarray(gs, a.gshape, types.int64, a.split, a.device, a.comm)
    elif a.split is not None and a.split != axis:
        pairs = [_stable_sort(s, axis, descending) for s in a.shards]
        v = DNDarray([p[0] for p in pairs], a.gshape, a.dtype, a.split, a.device, a.comm)
        i = DNDarray([p[1] for p in pairs], a.gshape, types.int64, a.split, a.device, a.comm)
    else:
        values, indices = _stable_sort(a.larray, axis, descending)
        v, i = _wrap_result(values, a.split, a), _wrap_result(indices, a.split, a)
    if out is not None:
        out._replace(v.shards, v.gshape, v.split)
        return out, i
    return v, i


def _sort_sentinel(dtype: torch.dtype, descending: bool):
    """The value that sorts a pad slot to the global tail (reference
    manipulations.py:475): NaN ascending (stability keeps real NaNs, which
    hold lower positions, ahead of it), -inf descending, the integer
    extremes, and True/False for bool."""
    if dtype.is_floating_point:
        return -math.inf if descending else math.nan
    if dtype == torch.bool:
        return not descending
    info = torch.iinfo(dtype)
    return info.min if descending else info.max


_KEY_TYPES = {torch.float16: torch.int16, torch.bfloat16: torch.int16, torch.float32: torch.int32, torch.float64: torch.int64}


def _flip(k: torch.Tensor) -> torch.Tensor:
    """Flip the magnitude bits of the integers whose sign bit is set: the
    map between a float's bits and its order-preserving integer key, in
    both directions."""
    bits = k.element_size() * 8
    return k ^ ((k >> (bits - 1)) & ((1 << (bits - 1)) - 1))


def _sort_keys(t: torch.Tensor) -> torch.Tensor:
    """The float values as signed integers in the same order (-0.0 just
    below +0.0)."""
    return _flip(t.view(_KEY_TYPES[t.dtype]))


def _order_keys(t: torch.Tensor, descending: bool) -> torch.Tensor:
    """Integers whose ascending order is the order of ``torch.sort``: every
    NaN largest, -0.0 equal to +0.0; reversed for ``descending``."""
    if t.is_floating_point():
        k = _sort_keys(torch.where(t == 0, 0.0, t))
        k = torch.where(torch.isnan(t), torch.iinfo(k.dtype).max, k)
    else:
        k = t.to(torch.int16) if t.element_size() == 1 else t
    return ~k if descending else k


def _merge_half(own, received, own_is_lower: bool, axis: int, descending: bool):
    """One side of a compare-exchange: the lower or upper half of the
    stable merge of two sorted blocks, the lower device's block first on
    a tie. Each element's place in the merge is its place in its block
    plus the count of the other block's elements before it (a
    ``searchsorted``), so no sort of the pair runs and a device holds
    little beyond the two blocks."""
    (v_own, g_own), (v_in, g_in) = own, received
    (va, ga), (vb, gb) = ((v_own, g_own), (v_in, g_in)) if own_is_lower else ((v_in, g_in), (v_own, g_own))
    va, vb = va.movedim(axis, -1), vb.movedim(axis, -1)
    ka, kb = _order_keys(va, descending).contiguous(), _order_keys(vb, descending).contiguous()
    block = va.shape[-1]
    rank = torch.arange(block, device=va.device)
    pos_a = torch.searchsorted(kb, ka) + rank  # B's elements strictly before
    pos_b = torch.searchsorted(ka, kb, right=True) + rank  # A's elements at or before
    del ka, kb
    if not own_is_lower:
        pos_a, pos_b = pos_a - block, pos_b - block
    # this side's half; the other half lands in one spare slot, then dropped
    pos_a = torch.where((pos_a >= 0) & (pos_a < block), pos_a, block)
    pos_b = torch.where((pos_b >= 0) & (pos_b < block), pos_b, block)

    def place(a, b):
        out = a.new_empty(a.shape[:-1] + (block + 1,))
        out.scatter_(-1, pos_a, a)
        out.scatter_(-1, pos_b, b)
        return out.narrow(-1, 0, block).movedim(-1, axis).contiguous()

    values = place(va, vb)
    if ga is None:
        return values, None
    return values, place(ga.movedim(axis, -1), gb.movedim(axis, -1))


def _dist_sort(a: DNDarray, axis: int, descending: bool, with_indices: bool = True):
    """The merge-exchange sort over the shard list (reference
    manipulations.py:497-629): the pad slots get the sentinel, each shard
    sorts its block, then p rounds alternate the even pairings (0,1)(2,3)…
    and the odd ones (1,2)(3,4)…; in each, paired shards swap blocks through
    ``MeshCommunication.ppermute`` and keep the lower or upper half of a
    stable merge. Global indices ride along. A device never holds more than
    its block, its partner's and their merge, and the whole array is never
    assembled. Returns the value and index shards at the physical shape,
    the sentinels in the padding (indices None without ``with_indices``)."""
    comm = a.comm
    p = comm.size
    counts, _ = a.counts_displs()
    block = a.shards[0].shape[axis]
    sentinel = _sort_sentinel(a.shards[0].dtype, descending)
    values, indices = [], []
    for r, (s, c) in enumerate(zip(a.shards, counts)):
        if c < block:
            s = s.clone()
            s.narrow(axis, c, block - c).fill_(sentinel)
        v, o = torch.sort(s, dim=axis, descending=descending, stable=True)
        values.append(v)
        indices.append(o + r * block if with_indices else None)
        del o
    for rnd in range(p):
        pairs = [(lo, lo + 1) for lo in range(rnd % 2, p - 1, 2)]  # (lower, upper) shards
        partner = list(range(p))  # an unpaired shard keeps its own block
        for lo, hi in pairs:
            partner[lo], partner[hi] = hi, lo
        perm = [(d, partner[d]) for d in range(p)]
        received_v = comm.ppermute(values, perm=perm)
        received_g = comm.ppermute(indices, perm=perm) if with_indices else [None] * p
        for lo, hi in pairs:
            new_lo = _merge_half((values[lo], indices[lo]), (received_v[lo], received_g[lo]), True, axis, descending)
            new_hi = _merge_half((values[hi], indices[hi]), (received_v[hi], received_g[hi]), False, axis, descending)
            received_v[lo] = received_v[hi] = received_g[lo] = received_g[hi] = None
            (values[lo], indices[lo]), (values[hi], indices[hi]) = new_lo, new_hi
        del received_v, received_g
    return values, indices


def mpi_topk(a, b, k: int, largest: bool = True):
    """Merge two ``(values, indices)`` top-k partials along the last axis
    into their top k, stably: on a tie the first partial's entry first
    (reference manipulations.py:833)."""
    vals = torch.cat([a[0], b[0].to(a[0].device)], dim=-1)
    inds = torch.cat([a[1], b[1].to(a[1].device)], dim=-1)
    if k > vals.shape[-1]:
        raise ValueError(f"k={k} out of range for combined partials of size {vals.shape[-1]}")
    order = torch.sort(vals, dim=-1, descending=largest, stable=True)[1].narrow(-1, 0, k)
    return torch.take_along_dim(vals, order, -1), torch.take_along_dim(inds, order, -1)


def topk(a: DNDarray, k: int, dim: int = -1, largest: bool = True, sorted: bool = True, out=None):
    """The k largest (or smallest) values along ``dim`` and their indices,
    the lower index first on a tie (reference manipulations.py:734). Across
    the split axis, when it is not padded and k <= n/p, each shard takes
    its local top k with global indices and one ``allreduce`` merges them
    with :func:`mpi_topk`; the result is replicated."""
    sanitize_in(a)
    dim = sanitize_axis(a.gshape, dim)
    if k > a.gshape[dim]:
        raise ValueError(f"k={k} out of range for dimension of size {a.gshape[dim]}")
    comm = a.comm
    if a.split == dim and not a.padded and comm.size > 1 and k <= a.gshape[dim] // comm.size:
        block = a.gshape[dim] // comm.size
        partials = []
        for r, s in enumerate(a.shards):
            last = s.movedim(dim, -1)
            order = torch.sort(last, dim=-1, descending=largest, stable=True)[1].narrow(-1, 0, k)
            partials.append((torch.take_along_dim(last, order, -1), order + r * block))
        gv, gi = comm.allreduce(partials, op=lambda x, y: mpi_topk(x, y, k, largest))[0]
        v = _wrap_result(gv.movedim(-1, dim), None, a)
        i = _wrap_result(gi.movedim(-1, dim), None, a)
    else:
        t = a.larray
        order = torch.sort(t, dim=dim, descending=largest, stable=True)[1].narrow(dim, 0, k)
        split = a.split if a.split != dim else None
        v = _wrap_result(torch.take_along_dim(t, order, dim), split, a)
        i = _wrap_result(order, split, a)
    if out is not None:
        out[0]._replace(v.shards, v.gshape, v.split)
        out[1]._replace(i.shards, i.gshape, i.split)
        return out
    return v, i


def _first_flags(sv: torch.Tensor, before: Optional[torch.Tensor]) -> torch.Tensor:
    """True where a sorted run starts: where a value differs from the one
    before it (``before`` precedes ``sv[0]``; None starts a run). NaN runs
    collapse into one, as numpy's unique does."""
    prev = sv[:-1] if before is None else torch.cat([before.reshape(1), sv[:-1]])
    flags = sv[1:] != sv[:-1] if before is None else sv != prev
    if sv.is_floating_point() or sv.is_complex():
        tail = sv[1:] if before is None else sv
        flags = flags & ~(torch.isnan(tail) & torch.isnan(prev))
    if before is None:
        flags = torch.cat([torch.ones(1 if sv.numel() else 0, dtype=torch.bool, device=sv.device), flags])
    return flags


def unique(a: DNDarray, sorted: bool = False, return_inverse: bool = False, axis: Optional[int] = None):
    """The sorted unique values (reference manipulations.py:778-830), NaN
    once, as numpy and the reference's dense path give it (torch.unique
    keeps every NaN). The flat unique of a split array over more than one
    shard sorts without indices through :func:`_dist_sort`, flags the first
    of each run with one shift of the shards' last values, and gathers only
    the unique values."""
    sanitize_in(a)
    if axis is not None:
        axis = sanitize_axis(a.gshape, axis)
    is_complex = a.dtype in (types.complex64, types.complex128)
    if is_complex and axis is None and a.split is not None and a.comm.size > 1:
        warn_replicated(
            "unique",
            "complex dtypes have no total-order pad sentinel for the merge-exchange "
            "network; deduplicating on the gathered view",
        )
    comm = a.comm
    if axis is None and not return_inverse and a.split is not None and comm.size > 1 and a.ndim >= 1 and a.size > 0 and not is_complex:
        flat = ravel(a) if a.ndim > 1 else a
        shards, _ = _dist_sort(flat, 0, False, with_indices=False)
        counts = flat.counts_displs()[0]
        valid = [s[:c] for s, c in zip(shards, counts)]
        last = comm.ppermute(
            [v[-1:] if v.numel() else s[:1] for v, s in zip(valid, shards)], perm=[(j, j + 1) for j in range(comm.size - 1)]
        )
        uniques = [
            v[_first_flags(v, None if r == 0 else last[r])] if v.numel() else v for r, v in enumerate(valid)
        ]
        return _wrap_result(comm.allgather(uniques)[0], 0, a)
    split = 0 if a.split is not None else None
    t = a.larray
    if axis is not None and t.numel() == 0:
        # numpy: the slices along an axis of an empty array are all equal
        n = t.shape[axis]
        uniq = t.narrow(axis, 0, min(n, 1))
        res = (uniq, torch.zeros(n, dtype=torch.int64, device=t.device)) if return_inverse else uniq
    elif axis is not None:
        res = torch.unique(t, sorted=True, return_inverse=return_inverse, dim=axis)
    else:
        res = _unique_flat(t, return_inverse)
    if return_inverse:
        return _wrap_result(res[0], split, a), _wrap_result(res[1], None, a)
    return _wrap_result(res, split, a)


def _unique_flat(t: torch.Tensor, return_inverse: bool):
    """Sorted uniques of the flattened ``t``, NaN collapsed, and with
    ``return_inverse`` the index of each element's unique, in ``t``'s shape."""
    flat = t.reshape(-1)
    if not return_inverse and not flat.is_complex():
        sv = torch.sort(flat)[0]  # the values alone: no order to keep
        return sv[_first_flags(sv, None)]
    sv, order = _stable_sort(flat, 0, False)
    flags = _first_flags(sv, None)
    values = sv[flags]
    if not return_inverse:
        return values
    inverse = torch.empty_like(order)
    inverse[order] = torch.cumsum(flags, 0) - 1
    return values, inverse.reshape(t.shape)
