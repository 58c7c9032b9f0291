"""Elementwise comparisons (reference: heat/core/relational.py:35-420,
heat_tpu/core/relational.py). The result is bool; complex values order
lexicographically, as in numpy."""

from __future__ import annotations

import torch

from ._operations import __binary_op as _binary_op
from .dndarray import DNDarray

def _ordered(strict, tie):
    """A comparison of real values by ``tie``; of complex values in numpy's
    lexicographic order: ``strict`` on the real parts, or ``tie`` on the
    imaginary parts where the real parts are equal."""

    def compare(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        if not a.is_complex():
            return tie(a, b)
        return strict(a.real, b.real) | (torch.eq(a.real, b.real) & tie(a.imag, b.imag))

    return compare


_ge, _gt = _ordered(torch.gt, torch.ge), _ordered(torch.gt, torch.gt)
_le, _lt = _ordered(torch.lt, torch.le), _ordered(torch.lt, torch.lt)


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
    return _binary_op(_ge, t1, t2, out=out, where=where)


greater_equal = ge


def gt(t1, t2, out=None, where=None) -> DNDarray:
    """Elementwise > (reference relational.py:177)."""
    return _binary_op(_gt, t1, t2, out=out, where=where)


greater = gt


def le(t1, t2, out=None, where=None) -> DNDarray:
    """Elementwise <= (reference relational.py:225)."""
    return _binary_op(_le, t1, t2, out=out, where=where)


less_equal = le


def lt(t1, t2, out=None, where=None) -> DNDarray:
    """Elementwise < (reference relational.py:272)."""
    return _binary_op(_lt, t1, t2, out=out, where=where)


less = lt


def ne(t1, t2, out=None, where=None) -> DNDarray:
    """Elementwise != (reference relational.py:320)."""
    return _binary_op(torch.ne, t1, t2, out=out, where=where)


not_equal = ne
