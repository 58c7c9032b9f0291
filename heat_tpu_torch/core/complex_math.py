"""Complex number operations (reference: heat/core/complex_math.py,
heat_tpu/core/complex_math.py)."""

from __future__ import annotations

import math

import torch

from . import types
from ._operations import __local_op as _local_op
from .arithmetics import _float_of
from .dndarray import DNDarray

__all__ = ["angle", "conj", "conjugate", "imag", "real"]


def _angle(t, deg: bool):
    a = torch.angle(_float_of(t))
    return a * (180.0 / math.pi) if deg else a


def angle(x, deg: bool = False, out=None) -> DNDarray:
    """Argument of the elements, in radians or degrees (reference
    complex_math.py:14)."""
    return _local_op(_angle, x, out=out, no_cast=True, deg=deg)


def conjugate(x, out=None) -> DNDarray:
    """Elementwise complex conjugate (reference complex_math.py:58)."""
    return _local_op(torch.conj_physical, x, out=out, no_cast=True)


conj = conjugate


def _imag(t):
    return torch.imag(t).clone()


def _real(t):
    return torch.real(t).clone()


def imag(x) -> DNDarray:
    """Imaginary part; zeros for a real array (reference complex_math.py:96)."""
    if not types.heat_type_is_complexfloating(x.dtype):
        from . import factories

        return factories.zeros_like(x)
    return _local_op(_imag, x, no_cast=True)


def real(x) -> DNDarray:
    """Real part; the array itself for a real array (reference complex_math.py:124)."""
    if not types.heat_type_is_complexfloating(x.dtype):
        return x
    return _local_op(_real, x, no_cast=True)
