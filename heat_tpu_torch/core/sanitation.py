"""Input validation (reference: heat/core/sanitation.py)."""

from __future__ import annotations

from .dndarray import DNDarray

__all__ = ["sanitize_in"]


def sanitize_in(x) -> None:
    """Raise TypeError unless ``x`` is a DNDarray (reference sanitation.py:161)."""
    if not isinstance(x, DNDarray):
        raise TypeError(f"input needs to be a DNDarray, but was {type(x)}")
