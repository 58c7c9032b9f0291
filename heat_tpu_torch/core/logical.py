"""Logical operations (reference: heat/core/logical.py:38-531,
heat_tpu/core/logical.py). ``all`` and ``any`` are reductions whose
partials combine across the split axis by logical and/or."""

from __future__ import annotations

import torch

from ._operations import Reduction
from ._operations import __binary_op as _binary_op
from ._operations import __local_op as _local_op
from ._operations import __reduce_op as _reduce_op
from .dndarray import DNDarray

__all__ = [
    "all",
    "allclose",
    "any",
    "isclose",
    "isfinite",
    "isinf",
    "isnan",
    "isneginf",
    "isposinf",
    "logical_and",
    "logical_not",
    "logical_or",
    "logical_xor",
    "signbit",
]


def _all(t, dims, keepdim):
    return torch.all(t, dim=dims, keepdim=keepdim).bool()


def _any(t, dims, keepdim):
    return torch.any(t, dim=dims, keepdim=keepdim).bool()


ALL = Reduction(_all, "land")
ANY = Reduction(_any, "lor")


def all(x, axis=None, out=None, keepdims=False, keepdim=None) -> DNDarray:
    """True where every element over axis is truthy (reference logical.py:38)."""
    return _reduce_op(ALL, x, axis, out=out, keepdims=keepdims if keepdim is None else keepdim)


def allclose(x, y, rtol: float = 1e-05, atol: float = 1e-08, equal_nan: bool = False) -> bool:
    """Whether every element pair is close (reference logical.py:96)."""
    return bool(all(isclose(x, y, rtol=rtol, atol=atol, equal_nan=equal_nan)).item())


def any(x, axis=None, out=None, keepdims=False, keepdim=None) -> DNDarray:
    """True where some element over axis is truthy (reference logical.py:145)."""
    return _reduce_op(ANY, x, axis, out=out, keepdims=keepdims if keepdim is None else keepdim)


def isclose(x, y, rtol: float = 1e-05, atol: float = 1e-08, equal_nan: bool = False) -> DNDarray:
    """Elementwise |x - y| <= atol + rtol |y| (reference logical.py:212)."""
    return _binary_op(torch.isclose, x, y, fn_kwargs=dict(rtol=rtol, atol=atol, equal_nan=equal_nan))


def isfinite(x) -> DNDarray:
    """Elementwise finiteness test (reference logical.py:249)."""
    return _local_op(torch.isfinite, x, no_cast=True)


def isinf(x) -> DNDarray:
    """Elementwise infinity test (reference logical.py:275)."""
    return _local_op(torch.isinf, x, no_cast=True)


def isnan(x) -> DNDarray:
    """Elementwise NaN test (reference logical.py:301)."""
    return _local_op(torch.isnan, x, no_cast=True)


def isneginf(x, out=None) -> DNDarray:
    """Elementwise -inf test (reference logical.py:327)."""
    return _local_op(torch.isneginf, x, out=out, no_cast=True)


def isposinf(x, out=None) -> DNDarray:
    """Elementwise +inf test (reference logical.py:353)."""
    return _local_op(torch.isposinf, x, out=out, no_cast=True)


def logical_and(t1, t2) -> DNDarray:
    """Elementwise logical AND (reference logical.py:379)."""
    return _binary_op(torch.logical_and, t1, t2)


def logical_not(t, out=None) -> DNDarray:
    """Elementwise logical NOT (reference logical.py:409)."""
    return _local_op(torch.logical_not, t, out=out, no_cast=True)


def logical_or(t1, t2) -> DNDarray:
    """Elementwise logical OR (reference logical.py:435)."""
    return _binary_op(torch.logical_or, t1, t2)


def logical_xor(t1, t2) -> DNDarray:
    """Elementwise logical XOR (reference logical.py:465)."""
    return _binary_op(torch.logical_xor, t1, t2)


def signbit(x, out=None) -> DNDarray:
    """True where the sign bit is set (reference logical.py:495)."""
    return _local_op(torch.signbit, x, out=out, no_cast=True)
