"""Rounding and sign operations (reference: heat/core/rounding.py,
heat_tpu/core/rounding.py)."""

from __future__ import annotations

import torch

from . import types
from ._operations import __binary_op as _binary_op
from ._operations import __local_op as _local_op
from .dndarray import DNDarray
from .sanitation import sanitize_in

__all__ = ["abs", "absolute", "ceil", "clip", "fabs", "floor", "modf", "round", "sgn", "sign", "trunc"]


def _abs(t):
    return t.clone() if t.dtype == torch.bool else torch.abs(t)


def abs(x, out=None, dtype=None) -> DNDarray:
    """Elementwise absolute value, in the input's type (reference rounding.py:23)."""
    if dtype is not None and not issubclass(types.canonical_heat_type(dtype), types.generic):
        raise TypeError("dtype must be a heat data type")
    res = _local_op(_abs, x, out=out, no_cast=True)
    if dtype is not None and out is None:
        res = res.astype(dtype)
    return res


absolute = abs


def fabs(x, out=None) -> DNDarray:
    """Elementwise absolute value as a float (reference rounding.py:92)."""
    return _local_op(torch.abs, x, out=out)


def ceil(x, out=None) -> DNDarray:
    """Elementwise ceiling (reference rounding.py:59)."""
    return _local_op(torch.ceil, x, out=out)


def _clamp_min(a, b):
    return torch.clamp(a, min=b)


def _clamp_max(a, b):
    return torch.clamp(a, max=b)


def clip(x, min=None, max=None, out=None) -> DNDarray:
    """Clip values to [min, max] (reference rounding.py:118); a bound may be
    a scalar or a DNDarray that broadcasts against ``x``."""
    if min is None and max is None:
        raise ValueError("either min or max must be set")
    sanitize_in(x)
    if not isinstance(min, DNDarray) and not isinstance(max, DNDarray):
        return _local_op(torch.clamp, x, out=out, no_cast=True, min=min, max=max)
    res = x
    if min is not None:
        res = _binary_op(_clamp_min, res, min)
    if max is not None:
        res = _binary_op(_clamp_max, res, max)
    return res if out is None else _local_op(torch.clone, res, out=out, no_cast=True)


def floor(x, out=None) -> DNDarray:
    """Elementwise floor (reference rounding.py:151)."""
    return _local_op(torch.floor, x, out=out)


def _modf_frac(t):
    return torch.where(torch.isinf(t), torch.copysign(torch.zeros_like(t), t), t - torch.trunc(t))


def modf(x, out=None):
    """Fractional and integral parts, both with the sign of x (reference
    rounding.py:177)."""
    if not isinstance(x, DNDarray):
        raise TypeError(f"expected x to be a DNDarray, but was {type(x)}")
    if out is not None and (not isinstance(out, tuple) or len(out) != 2):
        raise TypeError(f"expected out to be None or a tuple of two DNDarrays, but was {type(out)}")
    frac = _local_op(_modf_frac, x, out=None if out is None else out[0])
    whole = _local_op(torch.trunc, x, out=None if out is None else out[1])
    return (frac, whole)


def _round(t, decimals: int):
    if t.is_complex():  # each part on its own, as numpy does
        return torch.complex(torch.round(t.real, decimals=decimals), torch.round(t.imag, decimals=decimals))
    return torch.round(t, decimals=decimals)


def round(x, decimals: int = 0, out=None, dtype=None) -> DNDarray:
    """Round half to even to ``decimals`` places; complex values part by
    part (reference rounding.py:220)."""
    res = _local_op(_round, x, out=out, decimals=decimals)
    if dtype is not None and out is None:
        res = res.astype(dtype)
    return res


def sgn(x, out=None) -> DNDarray:
    """Sign, complex-aware: x/|x| (reference rounding.py:266); bool raises,
    as in heat_tpu and numpy."""
    if x.dtype is types.bool:
        raise TypeError("sign does not accept dtype bool")
    return _local_op(torch.sgn, x, out=out, no_cast=True)


def _sign_of_real(t):
    return torch.sign(t.real).to(t.dtype)


def sign(x, out=None) -> DNDarray:
    """Sign of the elements; of the real part for complex ones (reference
    rounding.py:290)."""
    if types.heat_type_is_complexfloating(x.dtype):
        return _local_op(_sign_of_real, x, out=out, no_cast=True)
    if x.dtype is types.bool:
        raise TypeError("sign does not accept dtype bool")
    return _local_op(torch.sign, x, out=out, no_cast=True)


def trunc(x, out=None) -> DNDarray:
    """Truncate toward zero (reference rounding.py:321)."""
    return _local_op(torch.trunc, x, out=out)
