"""Trigonometric and hyperbolic functions (reference:
heat/core/trigonometrics.py, heat_tpu/core/trigonometrics.py)."""

from __future__ import annotations

import torch

from . import types
from ._operations import __binary_op as _binary_op
from ._operations import __local_op as _local_op
from .arithmetics import _float_of
from .dndarray import DNDarray

__all__ = [
    "arccos",
    "acos",
    "arccosh",
    "acosh",
    "arcsin",
    "asin",
    "arcsinh",
    "asinh",
    "arctan",
    "atan",
    "arctan2",
    "atan2",
    "arctanh",
    "atanh",
    "cos",
    "cosh",
    "deg2rad",
    "degrees",
    "rad2deg",
    "radians",
    "sin",
    "sinh",
    "tan",
    "tanh",
]


def arccos(x, out=None) -> DNDarray:
    """Inverse cosine (reference trigonometrics.py:18)."""
    return _local_op(torch.arccos, x, out=out)


acos = arccos


def arccosh(x, out=None) -> DNDarray:
    """Inverse hyperbolic cosine (reference trigonometrics.py:46)."""
    return _local_op(torch.arccosh, x, out=out)


acosh = arccosh


def arcsin(x, out=None) -> DNDarray:
    """Inverse sine (reference trigonometrics.py:74)."""
    return _local_op(torch.arcsin, x, out=out)


asin = arcsin


def arcsinh(x, out=None) -> DNDarray:
    """Inverse hyperbolic sine (reference trigonometrics.py:102)."""
    return _local_op(torch.arcsinh, x, out=out)


asinh = arcsinh


def arctan(x, out=None) -> DNDarray:
    """Inverse tangent (reference trigonometrics.py:130)."""
    return _local_op(torch.arctan, x, out=out)


atan = arctan


def _arctan2(a, b):
    return torch.arctan2(_float_of(a), _float_of(b))


def _float_operand(x):
    """An integer or bool DNDarray as ``promote_types(dtype, float32)``;
    anything else as it is (heat_tpu/core/trigonometrics.py:91-96)."""
    if isinstance(x, DNDarray) and types.heat_type_is_exact(x.dtype):
        return x.astype(types.promote_types(x.dtype, types.float32))
    return x


def arctan2(x1, x2) -> DNDarray:
    """Quadrant-aware arctan(x1/x2) (reference trigonometrics.py:158). Each
    integer operand is cast to its float type first, then the two promote
    together, so (int32, float16) gives float32 and (int64, 2.0) float64."""
    return _binary_op(_arctan2, _float_operand(x1), _float_operand(x2))


atan2 = arctan2


def arctanh(x, out=None) -> DNDarray:
    """Inverse hyperbolic tangent (reference trigonometrics.py:197)."""
    return _local_op(torch.arctanh, x, out=out)


atanh = arctanh


def cos(x, out=None) -> DNDarray:
    """Cosine (reference trigonometrics.py:225)."""
    return _local_op(torch.cos, x, out=out)


def cosh(x, out=None) -> DNDarray:
    """Hyperbolic cosine (reference trigonometrics.py:253)."""
    return _local_op(torch.cosh, x, out=out)


def deg2rad(x, out=None) -> DNDarray:
    """Degrees to radians (reference trigonometrics.py:281)."""
    return _local_op(torch.deg2rad, x, out=out)


radians = deg2rad


def rad2deg(x, out=None) -> DNDarray:
    """Radians to degrees (reference trigonometrics.py:333)."""
    return _local_op(torch.rad2deg, x, out=out)


degrees = rad2deg


def sin(x, out=None) -> DNDarray:
    """Sine (reference trigonometrics.py:385)."""
    return _local_op(torch.sin, x, out=out)


def sinh(x, out=None) -> DNDarray:
    """Hyperbolic sine (reference trigonometrics.py:413)."""
    return _local_op(torch.sinh, x, out=out)


def tan(x, out=None) -> DNDarray:
    """Tangent (reference trigonometrics.py:441)."""
    return _local_op(torch.tan, x, out=out)


def tanh(x, out=None) -> DNDarray:
    """Hyperbolic tangent (reference trigonometrics.py:469)."""
    return _local_op(torch.tanh, x, out=out)
