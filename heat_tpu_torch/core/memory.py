"""Memory operations (reference: heat/core/memory.py)."""

from __future__ import annotations

from .dndarray import DNDarray, _distribute

__all__ = ["copy", "sanitize_memory_layout"]


def copy(a: DNDarray) -> DNDarray:
    """Deep copy: every shard cloned (reference memory.py:13)."""
    if not isinstance(a, DNDarray):
        raise TypeError(f"input needs to be a DNDarray, but was {type(a)}")
    if a.split is None:
        shards = _distribute(a.shards[0].clone(), None, a.comm)
    else:
        shards = [s.clone() for s in a.shards]
    return DNDarray(shards, a.gshape, a.dtype, a.split, a.device, a.comm)


def sanitize_memory_layout(x, order: str = "C"):
    """Accept a memory-layout request (reference memory.py:19): shards are
    kept C-contiguous, so 'C' and 'F' leave ``x`` as it is."""
    if order not in ("C", "F"):
        raise ValueError(f"expected order to be 'C' or 'F', but was {order}")
    return x
