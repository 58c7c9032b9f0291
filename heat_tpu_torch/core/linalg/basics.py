"""Basic linear algebra (reference: heat/core/linalg/basics.py,
heat_tpu/core/linalg/basics.py)."""

from __future__ import annotations

from typing import Optional, Sequence

from .. import types
from ..dndarray import DNDarray
from ..sanitation import sanitize_in
from ..stride_tricks import sanitize_axis

__all__ = ["transpose"]


def transpose(a: DNDarray, axes: Optional[Sequence[int]] = None) -> DNDarray:
    """Permute the axes, reversed by default; the split axis moves with its
    data, so each shard is permuted where it lies (reference basics.py
    transpose)."""
    sanitize_in(a)
    if axes is None:
        axes = tuple(reversed(range(a.ndim)))
    else:
        axes = sanitize_axis(a.gshape, tuple(axes))
        if len(axes) != a.ndim:
            raise ValueError("axes do not match the dimensions of the array")
    gshape = tuple(a.gshape[i] for i in axes)
    split = None if a.split is None else axes.index(a.split)
    shards = [s.permute(axes) for s in a.shards]
    return DNDarray(shards, gshape, types.canonical_heat_type(shards[0].dtype), split, a.device, a.comm)
