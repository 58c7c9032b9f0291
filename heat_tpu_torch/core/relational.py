"""Elementwise comparisons (reference: heat/core/relational.py:35-420,
heat_tpu/core/relational.py). The result is bool."""

from __future__ import annotations

import torch

from ._operations import __binary_op as _binary_op
from .dndarray import DNDarray

__all__ = ["eq", "equal", "ge", "greater", "greater_equal", "gt", "le", "less", "less_equal", "lt", "ne", "not_equal"]


def eq(t1, t2, out=None, where=None) -> DNDarray:
    """Elementwise == (reference relational.py:35)."""
    return _binary_op(torch.eq, t1, t2, out=out, where=where)


def equal(t1, t2) -> bool:
    """True if the operands broadcast and all elements are equal (reference
    relational.py:82)."""
    from . import logical

    try:
        res = eq(t1, t2)
    except ValueError:
        return False
    return bool(logical.all(res).item())


def ge(t1, t2, out=None, where=None) -> DNDarray:
    """Elementwise >= (reference relational.py:130)."""
    return _binary_op(torch.ge, t1, t2, out=out, where=where)


greater_equal = ge


def gt(t1, t2, out=None, where=None) -> DNDarray:
    """Elementwise > (reference relational.py:177)."""
    return _binary_op(torch.gt, t1, t2, out=out, where=where)


greater = gt


def le(t1, t2, out=None, where=None) -> DNDarray:
    """Elementwise <= (reference relational.py:225)."""
    return _binary_op(torch.le, t1, t2, out=out, where=where)


less_equal = le


def lt(t1, t2, out=None, where=None) -> DNDarray:
    """Elementwise < (reference relational.py:272)."""
    return _binary_op(torch.lt, t1, t2, out=out, where=where)


less = lt


def ne(t1, t2, out=None, where=None) -> DNDarray:
    """Elementwise != (reference relational.py:320)."""
    return _binary_op(torch.ne, t1, t2, out=out, where=where)


not_equal = ne
