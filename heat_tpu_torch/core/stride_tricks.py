"""Shape and axis sanitation (reference: heat/core/stride_tricks.py)."""

from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import numpy as np

__all__ = ["sanitize_axis", "sanitize_shape"]


def sanitize_axis(
    shape: Sequence[int], axis: Optional[Union[int, Sequence[int]]]
) -> Optional[Union[int, Tuple[int, ...]]]:
    """Normalize (possibly negative, possibly tuple) axis arguments against a
    shape; raise for out-of-bounds (reference stride_tricks.py:72-132)."""
    ndim = len(shape)
    if axis is None:
        return None
    if isinstance(axis, (list, tuple, np.ndarray)):
        axes = tuple(sanitize_axis(shape, int(ax)) for ax in axis)
        if len(set(axes)) != len(axes):
            raise ValueError("duplicate value in axis")
        return axes
    if not isinstance(axis, (int, np.integer)):
        raise TypeError(f"axis must be None or int or tuple of ints, got {type(axis)}")
    axis = int(axis)
    if axis < 0:
        axis += ndim
    if ndim == 0 and axis in (0, -1):
        return 0
    if axis < 0 or axis >= max(ndim, 1):
        raise ValueError(f"axis {axis} is out of bounds for {ndim}-dimensional array")
    return axis


def sanitize_shape(shape, lval: int = 0) -> Tuple[int, ...]:
    """Normalize a shape argument to a tuple of non-negative ints
    (reference stride_tricks.py:135-177)."""
    if isinstance(shape, (int, np.integer)):
        shape = (int(shape),)
    try:
        shape = tuple(shape)
    except TypeError:
        raise TypeError("expected sequence object with length >= 0 or a single integer")
    out = []
    for dim in shape:
        if hasattr(dim, "item") and not isinstance(dim, (int, np.integer)):
            dim = dim.item()
        if not isinstance(dim, (int, np.integer)):
            raise TypeError(f"expected int dimension, got {type(dim)}")
        if int(dim) < lval:
            raise ValueError(f"negative dimensions are not allowed, got {dim}")
        out.append(int(dim))
    return tuple(out)
