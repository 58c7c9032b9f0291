"""Exponential and logarithmic functions (reference:
heat/core/exponential.py, heat_tpu/core/exponential.py)."""

from __future__ import annotations

import torch

from ._operations import __binary_op as _binary_op
from ._operations import __local_op as _local_op
from .arithmetics import _float_of
from .dndarray import DNDarray

__all__ = [
    "exp",
    "exp2",
    "expm1",
    "log",
    "log10",
    "log1p",
    "log2",
    "logaddexp",
    "logaddexp2",
    "sqrt",
    "square",
]


def exp(x, out=None) -> DNDarray:
    """Elementwise e**x (reference exponential.py:14)."""
    return _local_op(torch.exp, x, out=out)


def exp2(x, out=None) -> DNDarray:
    """Elementwise 2**x (reference exponential.py:64)."""
    return _local_op(torch.exp2, x, out=out)


def expm1(x, out=None) -> DNDarray:
    """Elementwise e**x - 1 (reference exponential.py:39)."""
    return _local_op(torch.expm1, x, out=out)


def log(x, out=None) -> DNDarray:
    """Natural logarithm (reference exponential.py:89)."""
    return _local_op(torch.log, x, out=out)


def log2(x, out=None) -> DNDarray:
    """Base-2 logarithm (reference exponential.py:142)."""
    return _local_op(torch.log2, x, out=out)


def log10(x, out=None) -> DNDarray:
    """Base-10 logarithm (reference exponential.py:116)."""
    return _local_op(torch.log10, x, out=out)


def log1p(x, out=None) -> DNDarray:
    """log(1 + x) (reference exponential.py:168)."""
    return _local_op(torch.log1p, x, out=out)


def _logaddexp(a, b):
    return torch.logaddexp(_float_of(a), _float_of(b))


def _logaddexp2(a, b):
    return torch.logaddexp2(_float_of(a), _float_of(b))


def logaddexp(x1, x2, out=None) -> DNDarray:
    """log(exp(x1) + exp(x2)) (reference exponential.py:193)."""
    return _binary_op(_logaddexp, x1, x2, out=out)


def logaddexp2(x1, x2, out=None) -> DNDarray:
    """log2(2**x1 + 2**x2) (reference exponential.py:223)."""
    return _binary_op(_logaddexp2, x1, x2, out=out)


def sqrt(x, out=None) -> DNDarray:
    """Elementwise square root (reference exponential.py:253)."""
    return _local_op(torch.sqrt, x, out=out)


def _square(t):
    return torch.square(t.int() if t.dtype == torch.bool else t)


def square(x, out=None) -> DNDarray:
    """Elementwise square, in the input's type; bool squares in int32, as
    in the reference (exponential.py:278)."""
    return _local_op(_square, x, out=out, no_cast=True)
