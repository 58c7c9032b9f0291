"""Statistical operations (reference: heat/core/statistics.py,
heat_tpu/core/statistics.py).

Moments reduce through the engine of :mod:`._operations`. Across the split
axis, ``mean`` adds the shards' partial sums in shard order; ``var`` takes
the global mean first and then the sum of squared deviations from it, shard
by shard, never E[x²] - E[x]². ``min``/``max`` propagate NaN across shards
(numpy's rule), and ``argmin``/``argmax`` merge (value, global index) pairs
with :func:`mpi_argmin`/:func:`mpi_argmax`: the NaN side wins, and on a tie
the lower global index.

The flat ``percentile``/``median`` of a split, unpadded array finds its
order statistics by bisection (:func:`_order_stats_bisect`): each step
counts the elements at or below the midpoint, shard by shard, and nothing
waits for the device. The other order statistics sort the logical
array. The histograms count through ``torch.bincount`` in int64, exactly.
"""

from __future__ import annotations

import builtins
import functools
import math
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from . import factories, fusion, types
from ._operations import Reduction, _across_split, _reduced_shape, _reduced_split, _result
from ._operations import __binary_op as _binary_op
from ._operations import __local_op as _local_op
from ._operations import __reduce_op as _reduce_op
from .arithmetics import SUM, _sum
from .communication import _maximum, _minimum
from .arithmetics import sum as _ht_sum
from .dndarray import DNDarray, _wrap
from .logical import any as any_
from .manipulations import _flip, _sort_keys, broadcast_to, reshape
from .sanitation import sanitize_in, sanitize_out
from .stride_tricks import sanitize_axis

__all__ = [
    "argmax",
    "argmin",
    "average",
    "bincount",
    "bucketize",
    "cov",
    "digitize",
    "histc",
    "histogram",
    "kurtosis",
    "max",
    "maximum",
    "mean",
    "median",
    "min",
    "minimum",
    "mpi_argmax",
    "mpi_argmin",
    "percentile",
    "skew",
    "std",
    "var",
]


def _is_nan(t: torch.Tensor) -> torch.Tensor:
    return torch.isnan(t) if t.dtype.is_floating_point else torch.zeros_like(t, dtype=torch.bool)


def _arg_combiner(better):
    def combine(a, b):
        av, ai = a
        bv, bi = b
        a_nan, b_nan = _is_nan(av), _is_nan(bv)
        tie = (av == bv) | (a_nan & b_nan)
        take_b = (better(bv, av) & ~a_nan) | (b_nan & ~a_nan) | (tie & (bi < ai))
        return torch.where(take_b, bv, av), torch.where(take_b, bi, ai)

    return combine


mpi_argmax = _arg_combiner(torch.gt)
mpi_argmax.__doc__ = """Merge two ``(values, global indices)`` pairs into the
elementwise maximum and its index (reference statistics.py:619): a NaN side
wins, and on a tie (two NaN included) the lower global index."""
mpi_argmin = _arg_combiner(torch.lt)
mpi_argmin.__doc__ = """Merge two ``(values, global indices)`` pairs into the
elementwise minimum and its index (reference statistics.py:631): a NaN side
wins, and on a tie (two NaN included) the lower global index."""


def argmax(x: DNDarray, axis: Optional[int] = None, out=None, **kwargs) -> DNDarray:
    """Indices of the maximum values, the first one on a tie, the first NaN
    where there is one (reference statistics.py:37-116)."""
    return _arg_reduce(x, axis, out, torch.max, mpi_argmax)


def argmin(x: DNDarray, axis: Optional[int] = None, out=None, **kwargs) -> DNDarray:
    """Indices of the minimum values (reference statistics.py:117-196)."""
    return _arg_reduce(x, axis, out, torch.min, mpi_argmin)


@torch.library.custom_op("heat_tpu_torch::extreme", mutates_args=())
def _extreme_op(t: torch.Tensor, dim: int, largest: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """``torch.max`` (``largest``) or ``torch.min`` along ``dim``, values and
    indices, as one op that a fused program calls as it is: Inductor does
    not split an argmax reduction, so its own code for a column of a tall
    shard ran 50x slower than ATen's (75 ms against 1.5 for argmax and
    argmin along the split of BASELINE config 3's table on four shards of
    an H100, chip_smoke.py phase 19)."""
    return (torch.max if largest else torch.min)(t, dim=dim)


@_extreme_op.register_fake
def _(t, dim, largest):
    # the meta kernel: shapes, and torch's error for an empty reduction
    return (torch.max if largest else torch.min)(t, dim=dim)


def _extreme(t: torch.Tensor, axis, extreme):
    """(values, indices) of ``extreme`` (torch.max or torch.min) along
    ``axis``, over the flattened tensor for ``axis=None``."""
    flat = axis is None
    return _extreme_op(t.reshape(-1) if flat else t, 0 if flat else axis, extreme is torch.max)


def _arg_reduce(x: DNDarray, axis, out, extreme, combiner) -> DNDarray:
    sanitize_in(x)
    axis = sanitize_axis(x.gshape, axis)
    if isinstance(axis, tuple):
        raise TypeError("axis must be None or an int")
    if x.ndim == 0:
        axis = None
    split = None if axis is None else _reduced_split(x.split, (axis,), False)
    gshape = () if axis is None else _reduced_shape(x.gshape, (axis,), False)
    kw = dict(axis=axis, extreme=extreme, combiner=combiner)
    if out is None and (x.size if axis is None else x.gshape[axis]):
        # a node of a pending chain (heat_tpu/core/statistics.py:105-122);
        # an empty reduction raises torch's error at the call instead
        node = fusion.defer_apply(x.comm, _arg_kernel, (x,), **kw)
        if node is not None:
            return fusion.wrap_node(node, gshape, split, x)
    ret = _result(_arg_kernel(x, comm=x.comm, **kw), gshape, split, x)
    if out is not None:
        sanitize_out(out, ret.gshape, ret.split, ret.device)
        out._replace([s.to(out.dtype.torch_type()) for s in ret.shards], ret.gshape, ret.split)
        return out
    return ret


def _arg_kernel(x, *, comm, axis, extreme, combiner) -> List[torch.Tensor]:
    """The indices' shards of ``x`` (a DNDarray, or a shard view inside a
    fused program): each shard alone where every result element's inputs
    lie in one shard, else the split-axis schedule, one tensor."""
    if x.split is None or (axis is not None and axis != x.split) or comm.size == 1:
        source = x.shards if x.split is not None else x.shards[:1]
        return [_extreme(s, axis, extreme)[1] for s in source]
    return [_arg_across_split(x, axis, extreme, combiner)]


def _arg_across_split(x: DNDarray, axis, extreme, combiner) -> torch.Tensor:
    """Per shard the local extreme and its global index, merged in shard
    order by ``combiner``; a shard without valid rows does not take part.
    Across processes the shards' pairs are gathered first, in rank order,
    with one ``allgather`` each for the values and the indices."""
    comm = x.comm
    counts, displs = comm.local_counts_displs(x.gshape, x.split)
    first = comm.home
    pairs = []
    for s, c, d in zip(x.lshards, counts, displs):
        if not c:
            pairs.append(None)
            continue
        value, index = _extreme(s, axis, extreme)
        if axis is None:  # the flat index in the shard, as one in the whole array
            index = _global_flat_index(index, s.shape, x.gshape, x.split, d)
        else:
            index = index + d
        pairs.append((value, index))
    if comm.spans_processes and x.gshape[x.split]:
        # a padding row gives the empty shards' pieces their shape and type
        v0, i0 = _extreme(x.shards[0].narrow(x.split, 0, 1), axis, extreme)
        v0, i0 = v0[None][:0], i0[None][:0]
        values = comm.allgather([v0 if p is None else p[0][None] for p in pairs])[0]
        indices = comm.allgather([i0 if p is None else p[1][None] for p in pairs])[0]
        pairs = list(zip(values, indices))
    best = None
    for pair in pairs:
        if pair is not None:
            pair = (pair[0].to(first), pair[1].to(first))
            best = pair if best is None else combiner(best, pair)
    if best is None:  # no element at all: torch raises, as numpy does
        _extreme(x.lshards[0], axis, extreme)
    return best[1]


def _global_flat_index(index: torch.Tensor, lshape, gshape, split: int, offset: int) -> torch.Tensor:
    """A flat index into a shard of shape ``lshape``, whose rows along
    ``split`` start at ``offset``, as a flat index into ``gshape``. Python
    strides only: no host-to-device copy, so no wait for the device."""
    total = None
    for k, n in enumerate(lshape):
        coord = torch.remainder(torch.div(index, math.prod(lshape[k + 1:]), rounding_mode="floor"), n)
        if k == split:
            coord = coord + offset
        term = coord * math.prod(gshape[k + 1:])
        total = term if total is None else total + term
    return total


def average(x: DNDarray, axis=None, weights: Optional[DNDarray] = None, returned: bool = False):
    """Weighted average along axis (reference statistics.py:197-316)."""
    sanitize_in(x)
    if weights is None:
        result = mean(x, axis)
        if returned:
            count = x.size // builtins.max(result.size, 1) if x.size else 0
            return result, factories.full_like(result, float(count))
        return result
    if weights.gshape != x.gshape:
        if axis is None or isinstance(axis, tuple):
            raise TypeError("Axis must be specified when shapes of x and weights differ.")
        if weights.ndim != 1:
            raise TypeError("1D weights expected when shapes of x and weights differ.")
        axis = sanitize_axis(x.gshape, axis)
        if weights.gshape[0] != x.gshape[axis]:
            raise ValueError("Length of weights not compatible with specified axis.")
        shape = [1] * x.ndim
        shape[axis] = -1
        weights = reshape(weights, shape, new_split=axis if weights.split is not None else None)
    wsum = _ht_sum(broadcast_to(weights, x.gshape), axis)
    if any_(wsum == 0).item():
        raise ZeroDivisionError("Weights sum to zero, can't be normalized")
    result = _ht_sum(x * weights, axis) / wsum
    if returned:
        return result, broadcast_to(wsum, result.gshape)
    return result


def cov(m: DNDarray, y: Optional[DNDarray] = None, rowvar: bool = True, bias: bool = False, ddof: Optional[int] = None) -> DNDarray:
    """Covariance matrix estimate of the variables in the rows of ``m``
    (columns with ``rowvar=False``), replicated (reference statistics.py:444-525)."""
    if ddof is not None and not isinstance(ddof, int):
        raise TypeError("ddof must be integer")
    sanitize_in(m)
    if m.ndim > 2:
        raise ValueError("m has more than 2 dimensions")
    dtype = types.promote_types(m.dtype, types.float32).torch_type()

    def rows(a: DNDarray) -> torch.Tensor:
        t = a.larray.to(dtype)
        if t.ndim == 1:
            t = t[None, :]
        return t.T if not rowvar and t.shape[0] != 1 else t

    x = rows(m)
    if y is not None:
        sanitize_in(y)
        if y.ndim > 2:
            raise ValueError("y has more than 2 dimensions")
        x = torch.cat([x, rows(y).to(x.device)], dim=0)
    if ddof is None:
        ddof = 0 if bias else 1
    centered = x - x.mean(dim=1, keepdim=True)
    result = (centered @ centered.T.conj()) / (x.shape[1] - ddof)
    result = result.squeeze()
    return _result([result], tuple(result.shape), None, m)


def kurtosis(x: DNDarray, axis: Optional[int] = None, unbiased: bool = True, Fischer: bool = True) -> DNDarray:
    """Kurtosis, the fourth standardized moment, minus 3 with ``Fischer``
    (reference statistics.py:700-784); ``unbiased`` applies the sample
    correction."""
    return _moment_stat(x, axis, 4, unbiased, Fischer)


def skew(x: DNDarray, axis: Optional[int] = None, unbiased: bool = True) -> DNDarray:
    """Skewness, the third standardized moment (reference statistics.py:1860-1935)."""
    return _moment_stat(x, axis, 3, unbiased)


def _moment_stat(x: DNDarray, axis, order: int, unbiased: bool, fischer: bool = True) -> DNDarray:
    sanitize_in(x)
    axis = sanitize_axis(x.gshape, axis)
    if isinstance(axis, tuple):
        raise TypeError("axis must be None or an int")
    # every type computes in promote_types(dtype, float32), half floats too
    # (heat_tpu/core/statistics.py:397)
    x = x.astype(types.promote_types(x.dtype, types.float32))
    n = x.size if axis is None else x.gshape[axis]
    centered = x - mean(x, axis, keepdims=True)
    m2 = mean(centered**2, axis)
    mk = mean(centered**order, axis)
    if order == 3:
        g = mk / m2**1.5
        if unbiased:
            g = g * (math.sqrt(n * (n - 1)) / (n - 2))
    else:
        g = mk / m2**2
        if unbiased:
            g = ((n**2 - 1) * g - 3 * (n - 1) ** 2) / ((n - 2) * (n - 3)) + 3
        if fischer:
            g = g - 3
    return g


def _lex_extreme(t: torch.Tensor, dims, keepdim: bool, greater: bool) -> torch.Tensor:
    """amax/amin of a complex tensor in numpy's lexicographic order: the
    extreme real part, then among its holders the extreme imaginary part;
    NaN where the window holds one."""
    reduce = torch.amax if greater else torch.amin
    real = reduce(t.real, dim=dims, keepdim=True)
    imag = torch.where(t.real == real, t.imag, -math.inf if greater else math.inf)
    out = torch.complex(real, reduce(imag, dim=dims, keepdim=True))
    out = torch.where(torch.isnan(t).any(dim=dims, keepdim=True) if dims else torch.isnan(t), torch.complex(real.new_tensor(math.nan), real.new_tensor(0.0)), out)
    return out.squeeze(dims) if dims and not keepdim else out


def _amax(t, dims, keepdim):
    if t.is_complex():
        return _lex_extreme(t, dims, keepdim, True)
    return torch.amax(t, dim=dims, keepdim=keepdim)


def _amin(t, dims, keepdim):
    if t.is_complex():
        return _lex_extreme(t, dims, keepdim, False)
    return torch.amin(t, dim=dims, keepdim=keepdim)


MAX = Reduction(_amax, "max")
MIN = Reduction(_amin, "min")


def max(x: DNDarray, axis=None, out=None, keepdims=False, keepdim=None) -> DNDarray:
    """Maximum along axis; NaN where the window holds one, across shards
    too (reference statistics.py:785-901)."""
    return _reduce_op(MAX, x, axis, out=out, keepdims=keepdims if keepdim is None else keepdim)


def maximum(x1, x2, out=None) -> DNDarray:
    """Elementwise maximum, NaN-propagating; complex values in lexicographic
    order (reference statistics.py:902-940)."""
    return _binary_op(_maximum, x1, x2, out=out)


def min(x: DNDarray, axis=None, out=None, keepdims=False, keepdim=None) -> DNDarray:
    """Minimum along axis; NaN where the window holds one (reference
    statistics.py:1114-1230)."""
    return _reduce_op(MIN, x, axis, out=out, keepdims=keepdims if keepdim is None else keepdim)


def minimum(x1, x2, out=None) -> DNDarray:
    """Elementwise minimum, NaN-propagating; complex values in lexicographic
    order (reference statistics.py:1231-1269)."""
    return _binary_op(_minimum, x1, x2, out=out)


def _count(x: DNDarray, axes) -> int:
    # a list, not a generator: the fusion recorder's programs run this under
    # Dynamo, which cannot pass a generator to math.prod
    return math.prod([x.gshape[a] for a in axes])


def _mean_direct(t, dims, keepdim):
    return torch.mean(t, dim=dims, keepdim=keepdim)


def _mean_across(x: DNDarray, axes, reduction) -> torch.Tensor:
    return _across_split(x, axes, SUM) / _count(x, axes)


MEAN = Reduction(_sum, "sum", direct=_mean_direct, across=_mean_across)


_HALF = (types.float16, types.bfloat16)


def _in_float32(reduce, x: DNDarray) -> DNDarray:
    """``reduce(x)`` with half-precision input accumulated in float32 and
    the result cast back, as numpy does for float16: partial sums and M2 of
    many half values overflow or lose their digits in half precision."""
    if x.dtype not in _HALF:
        return reduce(x)
    return reduce(x.astype(types.float32)).astype(x.dtype, copy=False)


def mean(x: DNDarray, axis=None, keepdims: bool = False) -> DNDarray:
    """Arithmetic mean along axis; integer types as heat's float for them,
    half floats accumulated in float32 (reference statistics.py:941-1007)."""
    sanitize_in(x)
    if types.heat_type_is_exact(x.dtype):
        x = x.astype(types.promote_types(x.dtype, types.float32))
    return _in_float32(lambda t: _reduce_op(MEAN, t, axis, keepdims=keepdims), x)


@functools.lru_cache(maxsize=None)
def _var_reduction(ddof: int) -> Reduction:
    # one Reduction per ddof: the fusion recorder keys programs on its identity
    def direct(t, dims, keepdim):
        return torch.var(t, dim=dims, correction=ddof, keepdim=keepdim)

    def across(x: DNDarray, axes, reduction) -> torch.Tensor:
        # per shard: its mean and Σ(x - its mean)², one pass (torch.var_mean)
        comm = x.comm
        counts = comm.local_counts_displs(x.gshape, x.split)[0]
        others = _count(x, axes) // builtins.max(x.gshape[x.split], 1)
        parts = []
        for s, c in zip(x.lshards, counts):
            if c:
                v, m = torch.var_mean(s, dim=axes, correction=0, keepdim=True)
                parts.append((m, v * (c * others), c * others))
            else:
                parts.append(None)
        like = next((p for p in parts if p is not None), None)
        if like is None and x.gshape[x.split]:
            # this process's ranks hold no row, another's do: a padding row
            # gives the zeros' shape and type
            v, m = torch.var_mean(x.shards[0].narrow(x.split, 0, 1), dim=axes, correction=0, keepdim=True)
            like = (m, v, 0)
        elif like is None:  # no element: numpy's nan
            return direct(x.lshards[0], axes, True)
        # 1. the global mean, from the shards' sums in shard order
        sums = [torch.zeros_like(like[0]).to(d) if p is None else p[0] * p[2] for p, d in zip(parts, comm.local_devices)]
        n = _count(x, axes)
        mu = [t / n for t in comm.allreduce(sums)]
        # 2. Σ|x - μ|² per shard, exactly Σ|x - μ_d|² + n_d |μ_d - μ|², combined
        # in shard order; real for complex x too
        dev2 = [
            torch.zeros_like(like[1]).to(d) if p is None else p[1] + p[2] * (p[0] - m).abs() ** 2
            for p, m, d in zip(parts, mu, comm.local_devices)
        ]
        return comm.allreduce(dev2)[0] / (n - ddof)

    return Reduction(_sum, "sum", direct=direct, across=across)


def std(x: DNDarray, axis=None, ddof: int = 0, **kwargs) -> DNDarray:
    """Standard deviation along axis, the square root of :func:`var`
    (reference statistics.py:1936-1996)."""
    return _local_op(torch.sqrt, var(x, axis, ddof=ddof, **kwargs), no_cast=True)


def var(x: DNDarray, axis=None, ddof: int = 0, **kwargs) -> DNDarray:
    """Variance along axis, ``ddof`` 0 or 1 (``bessel=True`` is 1); the
    mean is taken first, then the squared deviations from it (reference
    statistics.py:2046-2126)."""
    sanitize_in(x)
    if not isinstance(ddof, int):
        raise TypeError(f"ddof must be integer, is {type(ddof)}")
    if ddof not in (0, 1):
        raise ValueError("Only ddof=0 or ddof=1 is supported")
    if kwargs.get("bessel") is not None:
        ddof = 1 if kwargs["bessel"] else 0
    keepdims = bool(kwargs.get("keepdims", False))
    if types.heat_type_is_exact(x.dtype):
        x = x.astype(types.promote_types(x.dtype, types.float32))
    return _in_float32(lambda t: _reduce_op(_var_reduction(ddof), t, axis, keepdims=keepdims), x)


# ---------------------------------------------------------------------------
# counting (reference statistics.py:212-354)
# ---------------------------------------------------------------------------
def _fast_bincount(idx: torch.Tensor, length: int, weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The counting core of bincount, histc and histogram (reference
    statistics.py:212): ``torch.bincount`` of indices in [0, length), int64
    counts without weights."""
    return torch.bincount(idx, weights=weights, minlength=length)[:length]


def _masked_counts(idx: torch.Tensor, valid: torch.Tensor, length: int) -> torch.Tensor:
    """Exact int64 counts of ``idx`` where ``valid``: the others go to an
    extra bin that is dropped."""
    return _fast_bincount(torch.where(valid, idx, length), length + 1)[:length]


def _replicated(t: torch.Tensor, ref: DNDarray) -> DNDarray:
    return _wrap(t, None, ref.device, ref.comm)


def bincount(x: DNDarray, weights: Optional[DNDarray] = None, minlength: int = 0) -> DNDarray:
    """Occurrences of each non-negative integer (reference statistics.py:235);
    int64 counts, or the sums of ``weights``."""
    sanitize_in(x)
    if not types.heat_type_is_exact(x.dtype):
        raise TypeError(f"input must be integer type, got {x.dtype}")
    flat = x.larray.reshape(-1)
    if flat.dtype == torch.bool:  # numpy counts the False and True entries
        flat = flat.long()
    top = minlength
    if flat.numel():
        low, high = (int(v) for v in torch.stack(torch.aminmax(flat)).tolist())  # one host read
        if low < 0:
            raise ValueError("'list' argument must have no negative elements")
        top = high + 1
    length = builtins.max(minlength, top)
    w = weights.larray.reshape(-1).to(flat.device) if weights is not None else None
    return _replicated(_fast_bincount(flat, length, w), x)


def bucketize(input: DNDarray, boundaries, right: bool = False, out_int32: bool = False, out=None) -> DNDarray:
    """The bucket of each element, torch's rule (reference
    statistics.py:249): ``right=False`` puts v at the first boundary >= v;
    shard by shard."""
    sanitize_in(input)
    b = _as_tensor(boundaries, input)
    shards = [
        torch.bucketize(s, b.to(s.device), right=right, out_int32=out_int32)
        for s in _own_shards(input)
    ]
    ret = _result(shards, input.gshape, input.split, input)
    if out is not None:
        out._replace(ret.shards, ret.gshape, ret.split)
        return out
    return ret


def _own_shards(x: DNDarray) -> List[torch.Tensor]:
    """The shards an elementwise op reads: each one when split, else the
    first."""
    return x.shards if x.split is not None else x.shards[:1]


def _as_tensor(values, ref: DNDarray) -> torch.Tensor:
    """An array argument (a DNDarray, tensor or array-like) as a tensor on
    ``ref``'s first device."""
    if isinstance(values, DNDarray):
        values = values.larray
    if not isinstance(values, torch.Tensor):
        values = torch.as_tensor(np.asarray(values))
    return values.to(ref.comm.home)


def digitize(x: DNDarray, bins, right: bool = False) -> DNDarray:
    """The bin of each element, numpy's rule (reference statistics.py:299):
    bins increasing or decreasing, ``right`` closing the bins on the right;
    shard by shard."""
    sanitize_in(x)
    b = _as_tensor(bins, x)
    if b.ndim != 1:
        raise ValueError("object too deep for desired array")
    steps = torch.diff(b.double())
    increasing = bool((steps >= 0).all())
    if not increasing and not bool((steps <= 0).all()):
        raise ValueError("bins must be monotonically increasing or decreasing")
    shards = []
    for s in _own_shards(x):
        dt = torch.promote_types(s.dtype, b.dtype)
        v, e = s.to(dt), b.to(s.device, dt)
        if increasing:
            shards.append(torch.searchsorted(e, v, right=not right))
        else:
            shards.append(e.numel() - torch.searchsorted(e.flip(0), v, right=not right))
    return _result(shards, x.gshape, x.split, x)


def histc(input: DNDarray, bins: int = 100, min: float = 0.0, max: float = 0.0, out=None) -> DNDarray:
    """Histogram of ``bins`` equal bins over [min, max], torch.histc's
    definition (reference statistics.py:307): the data's range when min
    equals max (the reference takes [min - 1, max + 1] unless both are 0),
    that widened by 1 on each side when it is one value; elements outside
    are not counted. The counts are exact (the reference sums float
    weights, exact only to 2^24)."""
    sanitize_in(input)
    data = input.larray.reshape(-1)
    lo, hi = float(min), float(max)
    if lo == hi and data.numel():  # torch.histc's rule: the data's range
        lo, hi = float(data.min()), float(data.max())
    if lo == hi:
        lo, hi = lo - 1.0, hi + 1.0
    fdata = data if types.heat_type_is_inexact(input.dtype) else data.float()
    idx = torch.floor((fdata - lo) / (hi - lo) * bins).to(torch.int64).clamp(0, bins - 1)
    hist = _masked_counts(idx, (data >= lo) & (data <= hi), bins)
    ret = _replicated(hist.to(input.dtype.torch_type()), input)
    if out is not None:
        out._replace(ret.shards, ret.gshape, ret.split)
        return out
    return ret


def _outer_edges(data: torch.Tensor, range) -> Tuple[float, float]:
    """numpy's outer edges: ``range`` or the data's min and max, each moved
    half a unit out when they are one value."""
    if range is not None:
        lo, hi = (v.item() if isinstance(v, (torch.Tensor, np.generic)) else v for v in range)
    elif data.numel():
        lo, hi = data.min().item(), data.max().item()
    else:
        lo, hi = 0.0, 1.0
    if not (np.isfinite(lo) and np.isfinite(hi)):
        raise ValueError(f"autodetected range of [{lo}, {hi}] is not finite")
    if lo > hi:
        raise ValueError("max must be larger than min in range parameter.")
    if lo == hi:
        lo, hi = lo - 0.5, hi + 0.5
    return lo, hi


def _bin_edges(data: torch.Tensor, bins, range) -> Tuple[torch.Tensor, Optional[Tuple[float, float]]]:
    """numpy's bin edges: the given ones, or ``np.linspace`` of the outer
    edges in the data's float type (float64 for integers), evaluated as
    numpy does, in float64 when ``range`` is given; and the outer edges of
    equal bins (None for given ones)."""
    dtype = data.dtype if data.is_floating_point() else torch.float64
    if not isinstance(bins, (int, np.integer)):
        bins = bins.larray if isinstance(bins, DNDarray) else bins
        bins = bins if isinstance(bins, torch.Tensor) else torch.as_tensor(np.asarray(bins))
        return bins.to(data.device, dtype), None
    lo, hi = _outer_edges(data, range)
    work = torch.float64 if range is not None else dtype
    start = torch.tensor(lo, dtype=work, device=data.device)
    stop = torch.tensor(hi, dtype=work, device=data.device)
    y = torch.arange(bins + 1, dtype=work, device=data.device)
    step = (stop - start) / bins
    y = y / bins * (stop - start) if bool(step == 0) else y * step
    y = y + start
    y[-1] = stop
    return y.to(dtype), (lo, hi)


def histogram(a: DNDarray, bins=10, range=None, normed=None, weights=None, density=None):
    """numpy's histogram (reference statistics.py:354): ``(hist, edges)``;
    int64 counts without weights, counted by ``torch.bincount``, as the
    card has no ``torch.histogram``."""
    sanitize_in(a)
    data = a.larray.reshape(-1)
    edges, outer = _bin_edges(data, bins, range)
    n_bins = edges.numel() - 1
    fdata = data.to(edges.dtype)
    if outer is not None:
        # numpy's index of equal bins: scaled, truncated, then moved by one
        # where a value lies on the other side of its bin's edges
        lo, hi = outer
        first = torch.tensor(lo, dtype=edges.dtype, device=data.device)
        denom = torch.tensor(hi - lo, dtype=torch.float64).to(edges.dtype).to(data.device)
        idx = ((fdata - first) / denom * n_bins).to(torch.int64).clamp(0, n_bins)
        idx = idx - (idx == n_bins).long()
        idx = idx - (fdata < edges[idx]).long()
        idx = idx.clamp(0, n_bins - 1)
        idx = idx + ((fdata >= edges[idx + 1]) & (idx != n_bins - 1)).long()
    else:
        idx = (torch.searchsorted(edges, fdata, right=True) - 1).clamp(0, n_bins - 1)
    valid = (fdata >= edges[0]) & (fdata <= edges[-1])
    if weights is None:
        hist = _masked_counts(idx, valid, n_bins)
    else:
        w = _as_tensor(weights, a).reshape(-1).to(edges.dtype)
        hist = _fast_bincount(idx, n_bins, torch.where(valid, w, 0))
    if density:
        hist = hist.to(edges.dtype) / torch.diff(edges) / hist.sum().to(edges.dtype)
    return _replicated(hist, a), _replicated(edges, a)


# ---------------------------------------------------------------------------
# order statistics (reference statistics.py:477-593)
# ---------------------------------------------------------------------------
_INTERPOLATIONS = ("linear", "lower", "higher", "midpoint", "nearest")


def _as_float(x: DNDarray) -> DNDarray:
    """Integers as the float type heat gives them."""
    if types.heat_type_is_exact(x.dtype):
        return x.astype(types.promote_types(x.dtype, types.float32))
    return x


def _order_stats_bisect(x: DNDarray, ranks: Sequence[int]) -> List[torch.Tensor]:
    """The order statistics of ranks ``ranks`` of the flat split array
    ``x`` by bisection (reference statistics.py:506): each step counts the
    elements at or below the midpoint, a sum over the shards, never a
    gather, and halves the bracket. The reference bisects the values
    themselves, 64 times (100 for float64), and its upper end stalls one
    float above the minimum when that is the statistic; here the bracket
    is the values' order-preserving integer keys (:func:`_sort_keys`), so
    32 steps (64 for float64) always end on the element itself. Each shard
    sorts its own keys once, so that a step counts for every rank with one
    ``searchsorted`` per shard, not a pass over the data (nor a mask of
    every rank); memory stays one copy of the shard. No step reads a value back
    to the host. NaN anywhere gives NaN. Returns one 0-d tensor per rank,
    on the first device."""
    comm = x.comm
    shards = [s.reshape(-1) for s in x.shards]
    keys = [torch.sort(_sort_keys(s))[0] for s in shards]
    lo = comm.allreduce([torch.amin(s) for s in shards], "min")[0]
    hi = comm.allreduce([torch.amax(s) for s in shards], "max")[0]
    has_nan = torch.isnan(lo) | torch.isnan(hi)
    # one bracket per rank, all stepped together; the targets made on the
    # device, not copied from the host
    targets = torch.stack([torch.full((), r + 1, dtype=torch.int64, device=lo.device) for r in ranks])
    los = _sort_keys(lo.reshape(1)).expand(len(ranks)).clone()
    his = _sort_keys(hi.reshape(1)).expand(len(ranks)).clone()
    for _ in range(keys[0].element_size() * 8):
        # floor((los + his) / 2) without overflow
        mid = (los >> 1) + (his >> 1) + (los & his & 1)
        count = comm.allreduce([torch.searchsorted(k, mid.to(k.device), right=True) for k in keys])[0]
        ge = count >= targets
        los, his = torch.where(ge, los, mid + 1), torch.where(ge, mid, his)
    stats = torch.where(has_nan, math.nan, _flip(his).view(lo.dtype))
    return list(stats.unbind())


def _quantile_positions(q, n: int) -> np.ndarray:
    """Positions ``q/100 (n - 1)`` in float64."""
    return np.asarray(q, dtype=np.float64) / 100.0 * (n - 1)


def _interpolate(lo, hi, pos: float, method: str, dtype: torch.dtype):
    """One percentile from its two neighbouring order statistics; ``nearest``
    rounds half to even, as numpy does."""
    frac = pos - math.floor(pos)
    if method == "lower":
        return lo
    if method == "higher":
        return hi
    if method == "nearest":
        return lo if round(pos) <= math.floor(pos) else hi
    if method == "midpoint":
        return ((lo.double() + hi.double()) * 0.5).to(dtype)
    return (lo.double() * (1 - frac) + hi.double() * frac).to(dtype)


def percentile(
    x: DNDarray,
    q,
    axis: Optional[int] = None,
    out=None,
    interpolation: str = "linear",
    keepdims: bool = False,
    keepdim=None,
) -> DNDarray:
    """The q-th percentiles (reference statistics.py:532-593), shaped like
    ``q``, followed by the reduced shape for an ``axis``. Over the whole of
    a split, unpadded array the order statistics come from
    :func:`_order_stats_bisect` and are interpolated in the data's type, as
    the reference does; otherwise from a sort of the logical array (with
    ``torch.quantile``'s 2^24-element limit out of the way), interpolated in
    float64. A slice holding NaN gives NaN."""
    if keepdim is not None:
        keepdims = keepdim
    sanitize_in(x)
    axis = sanitize_axis(x.gshape, axis)
    if interpolation not in _INTERPOLATIONS:
        raise ValueError("interpolation must be 'linear', 'lower', 'higher', 'midpoint', or 'nearest'")
    if isinstance(q, DNDarray):
        q = q.numpy()
    q_values = np.asarray(q, dtype=np.float64)
    if np.any(q_values < 0) or np.any(q_values > 100):
        raise ValueError("Percentiles must be in the range [0, 100]")
    q_shape = np.shape(q)
    x = _as_float(x)
    dtype = x.dtype.torch_type()
    if axis is None and x.split is not None and not x.padded:
        pos = _quantile_positions(q, x.size).reshape(-1)
        ranks = [int(math.floor(p)) for p in pos] + [int(math.ceil(p)) for p in pos]
        stats = _order_stats_bisect(x, ranks)
        m = len(pos)
        values = []
        for i, p in enumerate(pos):
            lo, hi = stats[i], stats[m + i]
            if interpolation == "linear":  # in the data's type, as the reference does
                values.append(lo + (hi - lo) * (p - math.floor(p)))
            elif interpolation == "midpoint":
                values.append((lo + hi) * 0.5)
            else:
                values.append(_interpolate(lo, hi, p, interpolation, dtype))
        result = torch.stack(values).reshape(q_shape + ((1,) * x.ndim if keepdims else ()))
    else:
        result = _sorted_percentile(x.larray, q, axis, interpolation, keepdims, dtype)
    ret = _wrap(result, None, x.device, x.comm)
    if out is not None:
        out._replace([s.to(out.dtype.torch_type()) for s in ret.shards], ret.gshape, ret.split)
        return out
    return ret


def _axes(ndim: int, axis) -> Tuple[int, ...]:
    """The reduced axes of an ``axis`` argument (None, an int or a tuple)."""
    if axis is None:
        return tuple(range(ndim))
    return tuple(axis) if isinstance(axis, tuple) else (axis,)


def _to_last(t: torch.Tensor, axis) -> torch.Tensor:
    """``t`` with the reduced axes moved to the end and flattened into one."""
    if axis is None:
        return t.reshape(-1)
    axes = _axes(t.ndim, axis)
    moved = t.movedim(axes, tuple(range(t.ndim - len(axes), t.ndim)))
    return moved.reshape(tuple(moved.shape[: t.ndim - len(axes)]) + (-1,))


def _kept_shape(shape, axis) -> List[int]:
    axes = _axes(len(shape), axis)
    return [1 if d in axes else s for d, s in enumerate(shape)]


def _sorted_percentile(t: torch.Tensor, q, axis, method: str, keepdims: bool, dtype) -> torch.Tensor:
    """Percentiles from a sort along ``axis`` (of the flattened tensor for
    None; of the named axes flattened together for a tuple): the two order
    statistics of each position gathered by ``narrow``, so nothing is
    copied from the host."""
    shape = t.shape
    work = _to_last(t, axis)
    sv = torch.sort(work, dim=-1)[0]
    n = sv.shape[-1]
    has_nan = torch.isnan(sv.narrow(-1, n - 1, 1)).squeeze(-1) if n and sv.is_floating_point() else None
    values = []
    for p in _quantile_positions(q, n).reshape(-1):
        lo = sv.narrow(-1, int(math.floor(p)), 1).squeeze(-1)
        hi = sv.narrow(-1, int(math.ceil(p)), 1).squeeze(-1)
        v = _interpolate(lo, hi, float(p), method, dtype)
        values.append(v if has_nan is None else torch.where(has_nan, math.nan, v))
    result = torch.stack(values).reshape(np.shape(q) + tuple(values[0].shape))
    if keepdims:
        result = result.reshape(np.shape(q) + tuple(_kept_shape(shape, axis)))
    return result


def median(x: DNDarray, axis: Optional[int] = None, keepdims: bool = False, keepdim=None) -> DNDarray:
    """The median, numpy's mean of the two middle values (torch.median
    gives the lower one) (reference statistics.py:477): by bisection over
    the whole of a split, unpadded array, else from a sort, the midpoint in
    the data's type as the reference computes it."""
    if keepdim is not None:
        keepdims = keepdim
    sanitize_in(x)
    axis = sanitize_axis(x.gshape, axis)
    if axis is None and x.split is not None and not x.padded:
        return percentile(x, 50.0, keepdims=keepdims)
    x = _as_float(x)
    t = x.larray
    work = _to_last(t, axis)
    sv = torch.sort(work, dim=-1)[0]
    n = sv.shape[-1]
    lo = sv.narrow(-1, (n - 1) // 2, 1)
    hi = sv.narrow(-1, n // 2, 1)
    result = ((lo + hi) * 0.5).squeeze(-1)
    if sv.is_floating_point() and n:
        result = torch.where(torch.isnan(sv.narrow(-1, n - 1, 1)).squeeze(-1), math.nan, result)
    if keepdims:
        result = result.reshape(_kept_shape(t.shape, axis))
    split = None
    axes = _axes(t.ndim, axis)
    if x.split is not None and axis is not None and x.split not in axes:
        split = x.split if keepdims else x.split - builtins.sum(a < x.split for a in axes)
    return _wrap(result.contiguous(), split if result.ndim else None, x.device, x.comm)
