"""Arithmetic operations (reference: heat/core/arithmetics.py;
heat_tpu/core/arithmetics.py:64-307).

Every function goes through the engines of :mod:`._operations`. Where torch
differs from the reference for the same operand types, the torch callable
here corrects it: true division and ``copysign`` of integers give the float
type of heat's promotion (``promote_types(t, float32)``), ``floordiv`` and
``mod`` follow Python's sign rule and ``fmod`` C's, an integer division by
zero gives 0 as in numpy, and ``cumsum``/``cumprod`` keep integer types
(bool sums as int64).
"""

from __future__ import annotations

import math
from functools import partial
from typing import Tuple

import torch

from . import types
from ._operations import Reduction
from ._operations import __binary_op as _binary_op
from ._operations import __cum_op as _cum_op
from ._operations import __local_op as _local_op
from ._operations import __reduce_op as _reduce_op
from .communication import _combine, _neutral
from .dndarray import DNDarray, _wrap
from .sanitation import sanitize_in

__all__ = [
    "add",
    "bitwise_and",
    "bitwise_not",
    "bitwise_or",
    "bitwise_xor",
    "copysign",
    "cumprod",
    "cumproduct",
    "cumsum",
    "diff",
    "div",
    "divide",
    "divmod",
    "floordiv",
    "floor_divide",
    "fmod",
    "gcd",
    "hypot",
    "invert",
    "lcm",
    "left_shift",
    "mod",
    "mul",
    "multiply",
    "nan_to_num",
    "nanprod",
    "nansum",
    "neg",
    "negative",
    "pos",
    "positive",
    "pow",
    "power",
    "prod",
    "remainder",
    "right_shift",
    "sub",
    "subtract",
    "sum",
]


#: heat's float type of each integer and bool type, computed once: the
#: fusion recorder's programs run ``_float_of`` under Dynamo on the card,
#: which cannot trace the numpy promotion rules behind ``promote_types``
_FLOAT_OF = {
    t: types.promote_types(t, types.float32).torch_type()
    for t in (torch.bool, torch.uint8, torch.int8, torch.int16, torch.int32, torch.int64)
}


def _float_of(t: torch.Tensor) -> torch.Tensor:
    """An integer or bool tensor as heat's float type for it."""
    if t.dtype.is_floating_point or t.dtype.is_complex:
        return t
    return t.to(_FLOAT_OF[t.dtype])


def _true_divide(a, b):
    return torch.div(_float_of(a), _float_of(b))


def _copysign(a, b):
    return torch.copysign(_float_of(a), _float_of(b))


def _int_of_bool(fn):
    """``fn`` on bool operands in int32, as the reference computes them
    (torch has no bool kernel for it)."""

    def op(a, b):
        if a.dtype == torch.bool:
            a, b = a.int(), b.int()
        return fn(a, b)

    return op


def _by_nonzero(fn):
    """``fn`` for integer operands with numpy's x/0 = 0 (torch raises on
    the CPU); the padding of a shard may divide by zero too."""

    @_int_of_bool
    def op(a, b):
        if a.dtype.is_floating_point or a.dtype.is_complex:
            return fn(a, b)
        zero = b == 0
        return torch.where(zero, 0, fn(a, torch.where(zero, 1, b))).to(a.dtype)

    return op


_floordiv = _by_nonzero(partial(torch.div, rounding_mode="floor"))
_pow = _int_of_bool(torch.pow)
_mod = _by_nonzero(torch.remainder)
_fmod = _by_nonzero(torch.fmod)


def add(t1, t2, out=None, where=None) -> DNDarray:
    """Elementwise addition (reference arithmetics.py:63)."""
    return _binary_op(torch.add, t1, t2, out=out, where=where)


def sub(t1, t2, out=None, where=None) -> DNDarray:
    """Elementwise subtraction (reference arithmetics.py:905)."""
    return _binary_op(torch.sub, t1, t2, out=out, where=where)


subtract = sub


def mul(t1, t2, out=None, where=None) -> DNDarray:
    """Elementwise multiplication (reference arithmetics.py:679)."""
    return _binary_op(torch.mul, t1, t2, out=out, where=where)


multiply = mul


def div(t1, t2, out=None, where=None) -> DNDarray:
    """Elementwise true division (reference arithmetics.py:295)."""
    return _binary_op(_true_divide, t1, t2, out=out, where=where)


divide = div


def divmod(t1, t2):
    """Simultaneous floordiv and mod (reference arithmetics.py:345)."""
    return (floordiv(t1, t2), mod(t1, t2))


def floordiv(t1, t2, out=None, where=None) -> DNDarray:
    """Elementwise floor division (reference arithmetics.py:430)."""
    return _binary_op(_floordiv, t1, t2, out=out, where=where)


floor_divide = floordiv


def fmod(t1, t2, out=None, where=None) -> DNDarray:
    """Elementwise C-style remainder, the sign of the dividend (reference
    arithmetics.py:470)."""
    return _binary_op(_fmod, t1, t2, out=out, where=where)


def mod(t1, t2, out=None, where=None) -> DNDarray:
    """Elementwise Python-style modulo, the sign of the divisor (reference
    arithmetics.py:639)."""
    return _binary_op(_mod, t1, t2, out=out, where=where)


remainder = mod


def pow(t1, t2, out=None, where=None) -> DNDarray:
    """Elementwise power (reference arithmetics.py:759); an integer array to
    a negative integer power raises, as in the reference."""
    if isinstance(t2, int) and t2 < 0 and types.heat_type_is_exact(types.result_type(t1, t2)):
        raise TypeError(f"Integers cannot be raised to negative powers, got {t2}")
    return _binary_op(_pow, t1, t2, out=out, where=where)


power = pow


def neg(a, out=None) -> DNDarray:
    """Elementwise negation (reference arithmetics.py:714)."""
    if isinstance(a, DNDarray) and a.dtype is types.bool:
        raise TypeError("neg does not accept dtype bool")
    return _local_op(torch.neg, a, out=out, no_cast=True)


negative = neg


def pos(a, out=None) -> DNDarray:
    """Elementwise unary plus (reference arithmetics.py:736)."""
    return _local_op(torch.clone, a, out=out, no_cast=True)


positive = pos


def _check_bitwise(*ops):
    for op in ops:
        dt = op.dtype if isinstance(op, DNDarray) else types.heat_type_of(op)
        if not types.heat_type_is_exact(dt):
            raise TypeError("Operation is not supported for float types")


def _check_shift(*ops):
    for op in ops:
        dt = op.dtype if isinstance(op, DNDarray) else types.heat_type_of(op)
        if types.issubdtype(dt, types.bool):
            raise TypeError("Operation is not supported for boolean types")
        if not types.issubdtype(dt, types.integer):
            raise TypeError("Operation is only supported for integer types")


def bitwise_and(t1, t2, out=None, where=None) -> DNDarray:
    """Elementwise bitwise AND (reference arithmetics.py:103)."""
    _check_bitwise(t1, t2)
    return _binary_op(torch.bitwise_and, t1, t2, out=out, where=where)


def bitwise_or(t1, t2, out=None, where=None) -> DNDarray:
    """Elementwise bitwise OR (reference arithmetics.py:141)."""
    _check_bitwise(t1, t2)
    return _binary_op(torch.bitwise_or, t1, t2, out=out, where=where)


def bitwise_xor(t1, t2, out=None, where=None) -> DNDarray:
    """Elementwise bitwise XOR (reference arithmetics.py:179)."""
    _check_bitwise(t1, t2)
    return _binary_op(torch.bitwise_xor, t1, t2, out=out, where=where)


def invert(a, out=None) -> DNDarray:
    """Elementwise bitwise NOT; logical NOT for bool (reference
    arithmetics.py:521)."""
    _check_bitwise(a)
    return _local_op(torch.bitwise_not, a, out=out, no_cast=True)


bitwise_not = invert


def left_shift(t1, t2, out=None, where=None) -> DNDarray:
    """Elementwise left bit-shift, integers only (reference arithmetics.py:558)."""
    _check_shift(t1, t2)
    return _binary_op(torch.bitwise_left_shift, t1, t2, out=out, where=where)


def right_shift(t1, t2, out=None, where=None) -> DNDarray:
    """Elementwise right bit-shift, integers only (reference arithmetics.py:855)."""
    _check_shift(t1, t2)
    return _binary_op(torch.bitwise_right_shift, t1, t2, out=out, where=where)


def copysign(t1, t2, out=None, where=None) -> DNDarray:
    """Magnitude of t1 with the sign of t2 (reference arithmetics.py:219)."""
    dt1 = t1.dtype if isinstance(t1, DNDarray) else types.heat_type_of(t1)
    if types.heat_type_is_complexfloating(dt1):
        raise TypeError("copysign is not defined for complex types")
    return _binary_op(_copysign, t1, t2, out=out, where=where)


# torch's CUDA scan along any dim but the last runs one sequential chain per
# column: cumsum along the 10^7 rows of a 10^7 x 16 table took 3.5 s on an
# H100 (chip_smoke.py, phase 9). A longer axis is scanned in blocks of about √n
# elements: the blocks scan in parallel, then each block is offset by the
# scan of the blocks' totals, as the engine offsets shards.
_LONG_SCAN = 1 << 16


def scan_blocks(n: int) -> Tuple[int, int]:
    """(block length, number of blocks) of a scan over n elements."""
    block = math.isqrt(n - 1) + 1
    return block, -(-n // block)


def _cum(fn, op: str):
    """A cumulative op that keeps integer types (torch widens them to
    int64), sums bool as int64, and scans a long axis in blocks; ``op``
    ("sum" or "prod") combines two of its results."""
    combine = _combine(op)

    def local(t, dim):
        dtype = torch.int64 if t.dtype == torch.bool else t.dtype
        n = t.shape[dim] if t.ndim else 1
        if n <= _LONG_SCAN:
            return fn(t, dim, dtype=dtype)
        block, count = scan_blocks(n)
        x = t.to(dtype).movedim(dim, 0)
        if block * count != n:
            x = torch.cat([x, _neutral(op, x[: block * count - n])])
        x = fn(x.reshape((count, block) + x.shape[1:]), 1, dtype=dtype)
        totals = fn(x[:, -1], 0, dtype=dtype)
        offsets = torch.cat([_neutral(op, totals[:1]), totals[:-1]])
        x = combine(x, offsets.unsqueeze(1))
        return x.reshape((block * count,) + x.shape[2:])[:n].movedim(0, dim)

    return local


_cumsum = _cum(torch.cumsum, "sum")
_cumprod = _cum(torch.cumprod, "prod")


def cumprod(a, axis: int, dtype=None, out=None) -> DNDarray:
    """Cumulative product along axis (reference arithmetics.py:253)."""
    return _cum_op(_cumprod, "prod", a, axis, out=out, dtype=dtype)


cumproduct = cumprod


def cumsum(a, axis: int, dtype=None, out=None) -> DNDarray:
    """Cumulative sum along axis (reference arithmetics.py:274)."""
    return _cum_op(_cumsum, "sum", a, axis, out=out, dtype=dtype)


def diff(a, n: int = 1, axis: int = -1, prepend=None, append=None) -> DNDarray:
    """n-th discrete difference along axis, numpy-style ``prepend`` and
    ``append`` (reference arithmetics.py:293-429). A stencil, so it runs on
    the logical array, never on padding."""
    if n == 0:
        return a
    if n < 0:
        raise ValueError(f"diff requires that n be a positive number, got {n}")
    sanitize_in(a)
    data = a.larray
    ext = {}
    for key, val in (("prepend", prepend), ("append", append)):
        if val is None:
            continue
        val = val.larray if isinstance(val, DNDarray) else torch.as_tensor(val, device=data.device)
        if val.ndim == 0:
            shape = list(data.shape)
            shape[axis] = 1
            val = val.expand(shape)
        ext[key] = val.to(data.device, types.promote_types(val.dtype, a.dtype).torch_type())
    if ext:
        dtype = types.result_type(a, *ext.values()).torch_type()
        data = data.to(dtype)
    result = torch.diff(data, n=n, dim=axis, **ext)
    return _wrap(result, a.split, a.device, a.comm)


def gcd(t1, t2, out=None, where=None) -> DNDarray:
    """Greatest common divisor, integers only (reference arithmetics.py:498)."""
    _check_shift(t1, t2)
    return _binary_op(torch.gcd, t1, t2, out=out, where=where)


def hypot(t1, t2, out=None, where=None) -> DNDarray:
    """sqrt(t1² + t2²), floats only (reference arithmetics.py:514)."""
    for t in (t1, t2):
        dt = t.dtype if isinstance(t, DNDarray) else types.heat_type_of(t)
        if types.heat_type_is_exact(dt):
            raise TypeError("hypot is not supported for integer types")
    return _binary_op(torch.hypot, t1, t2, out=out, where=where)


def lcm(t1, t2, out=None, where=None) -> DNDarray:
    """Least common multiple, integers only (reference arithmetics.py:540)."""
    _check_shift(t1, t2)
    return _binary_op(torch.lcm, t1, t2, out=out, where=where)


def nan_to_num(a, nan=0.0, posinf=None, neginf=None, out=None) -> DNDarray:
    """Replace NaN and infinities by finite numbers (reference arithmetics.py:702)."""
    return _local_op(torch.nan_to_num, a, out=out, no_cast=True, nan=nan, posinf=posinf, neginf=neginf)


def _dim_by_dim(fn):
    """A reduction over a tuple of dims from ``fn(t, dim, keepdim)``, which
    takes one dim (``fn(t)`` reduces all)."""

    def local(t, dims, keepdim):
        if not keepdim and len(dims) in (0, t.ndim):
            return fn(t)
        for d in sorted(dims, reverse=True):
            t = fn(t, d, keepdim=keepdim)
        return t

    return local


def _sum(t, dims, keepdim):
    return torch.sum(t, dim=dims, keepdim=keepdim)


def _nansum(t, dims, keepdim):
    if t.is_complex():  # NaN in either part: the element counts as 0, as in numpy
        return torch.sum(torch.where(torch.isnan(t), 0, t), dim=dims, keepdim=keepdim)
    return torch.nansum(t, dim=dims, keepdim=keepdim)


_prod = _dim_by_dim(torch.prod)


def _nanprod(t, dims, keepdim):
    if t.dtype.is_floating_point:
        t = torch.where(torch.isnan(t), 1, t)
    return _prod(t, dims, keepdim)


SUM = Reduction(_sum, "sum")
PROD = Reduction(_prod, "prod")
NANSUM = Reduction(_nansum, "sum")
NANPROD = Reduction(_nanprod, "prod")


def nanprod(a, axis=None, out=None, keepdims=False) -> DNDarray:
    """Product ignoring NaN (reference arithmetics.py:726)."""
    return _reduce_op(NANPROD, a, axis, out=out, keepdims=keepdims)


def nansum(a, axis=None, out=None, keepdims=False) -> DNDarray:
    """Sum ignoring NaN (reference arithmetics.py:745)."""
    return _reduce_op(NANSUM, a, axis, out=out, keepdims=keepdims)


def prod(a, axis=None, out=None, keepdims=False, keepdim=None) -> DNDarray:
    """Product of elements over axis (reference arithmetics.py:803);
    ``keepdim`` is the reference's torch-style alias of ``keepdims``."""
    return _reduce_op(PROD, a, axis, out=out, keepdims=keepdims if keepdim is None else keepdim)


def sum(a, axis=None, out=None, keepdims=False, keepdim=None) -> DNDarray:
    """Sum of elements over axis (reference arithmetics.py:946); across the
    split axis the shards' partial sums add in shard order. ``keepdim`` is
    the reference's torch-style alias of ``keepdims``."""
    return _reduce_op(SUM, a, axis, out=out, keepdims=keepdims if keepdim is None else keepdim)
