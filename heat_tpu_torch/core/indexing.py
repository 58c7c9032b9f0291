"""Index finding (reference: heat/core/indexing.py, heat_tpu/core/indexing.py)."""

from __future__ import annotations

import torch

from . import types
from ._operations import _aligned, _result, _shape
from .dndarray import DNDarray, _wrap
from .sanitation import sanitize_in
from .stride_tricks import broadcast_shapes

__all__ = ["nonzero", "where"]


def nonzero(x: DNDarray) -> DNDarray:
    """Indices of the nonzero elements: (nnz, ndim), or (nnz,) for 1-D,
    split along 0 if ``x`` is split (reference indexing.py:16-90). Its shape
    depends on the data, so it waits for the device."""
    sanitize_in(x)
    result = torch.nonzero(x.larray)
    if x.ndim == 1:
        result = result[:, 0]
    return _wrap(result.contiguous(), 0 if x.split is not None else None, x.device, x.comm)


def where(cond: DNDarray, x=None, y=None) -> DNDarray:
    """``x`` where ``cond`` holds, else ``y``, in their promoted type; with
    neither, :func:`nonzero` (reference indexing.py:91-151). The result is
    split like ``x``, else ``y``, else, when neither is an array, ``cond``."""
    if x is None and y is None:
        return nonzero(cond)
    if x is None or y is None:
        raise TypeError("either both or neither of x and y should be given")
    sanitize_in(cond)
    operands = (x, y) if isinstance(x, DNDarray) or isinstance(y, DNDarray) else (cond,)
    out_shape = broadcast_shapes(*[_shape(t) for t in (cond, x, y)])
    out_split = None
    for t in operands:
        if isinstance(t, DNDarray) and t.split is not None:
            out_split = t.split + len(out_shape) - t.ndim
            break
    dtype = types.result_type(x, y).torch_type()
    c = _aligned(cond, out_shape, out_split, cond.comm, torch.bool)
    a = _aligned(x, out_shape, out_split, cond.comm, dtype)
    b = _aligned(y, out_shape, out_split, cond.comm, dtype)
    shards = [torch.where(*abc) for abc in zip(c, a, b)]
    return _result(shards, out_shape, out_split, cond)
