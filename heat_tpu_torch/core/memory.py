"""Memory operations (reference: heat/core/memory.py)."""

from __future__ import annotations

from .dndarray import DNDarray, _distribute

__all__ = ["copy"]


def copy(a: DNDarray) -> DNDarray:
    """Deep copy: every shard cloned (reference memory.py:13)."""
    if not isinstance(a, DNDarray):
        raise TypeError(f"input needs to be a DNDarray, but was {type(a)}")
    if a.split is None:
        shards = _distribute(a.shards[0].clone(), None, a.comm)
    else:
        shards = [s.clone() for s in a.shards]
    return DNDarray(shards, a.gshape, a.dtype, a.split, a.device, a.comm)
