"""Pairwise distances (reference: heat/spatial/distance.py,
heat_tpu/spatial/distance.py).

So far only the local metrics and ``cdist`` with at most one row-split
operand: the distance matrix is one product of the global operands, split
like ``X``. The two ring schedules for two row-split operands are still to
be ported.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..core import sanitation, types
from ..core.dndarray import DNDarray, _wrap

__all__ = ["cdist"]


def _euclidian(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Direct pairwise Euclidean distance (reference distance.py:16-37)."""
    diff = x[:, None, :] - y[None, :, :]
    return torch.sqrt(torch.sum(diff * diff, dim=-1))


def _sq_euclidian_fast(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Squared pairwise distance by quadratic expansion, |x|² + |y|² − 2x·yᵀ:
    one matrix product. Shared by cdist and the k-clustering assignment."""
    xn = torch.sum(x * x, dim=1, keepdim=True)
    yn = torch.sum(y * y, dim=1, keepdim=True)
    return torch.clamp(xn + yn.T - 2.0 * (x @ y.T), min=0.0)


def _euclidian_fast(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Quadratic-expansion Euclidean distance (reference distance.py:40-60)."""
    return torch.sqrt(_sq_euclidian_fast(x, y))


def cdist(X: DNDarray, Y: Optional[DNDarray] = None, quadratic_expansion: bool = False) -> DNDarray:
    """Pairwise Euclidean distance matrix (reference distance.py:136-175).

    At most one operand may be row-split across more than one device: the
    ring schedule for two split operands (heat_tpu/spatial/distance.py:161-309)
    is not ported yet and raises ``NotImplementedError``."""
    metric = _euclidian_fast if quadratic_expansion else _euclidian
    sanitation.sanitize_in(X)
    if X.ndim != 2:
        raise NotImplementedError(f"X should be 2D, but was {X.ndim}D")
    promoted = types.promote_types(X.dtype, types.float32)
    if Y is None:
        Y = X
    else:
        sanitation.sanitize_in(Y)
        if Y.ndim != 2:
            raise NotImplementedError(f"Y should be 2D, but was {Y.ndim}D")
        if X.shape[1] != Y.shape[1]:
            raise ValueError("inputs must have the same number of features")
        promoted = types.promote_types(promoted, Y.dtype)
    if X.split == 0 and Y.split == 0 and X.comm.size > 1:
        raise NotImplementedError("cdist of two row-split operands needs the ring schedule")
    tdtype = promoted.torch_type()
    xl = X.larray.to(tdtype)
    yl = Y.larray.to(device=xl.device, dtype=tdtype)
    return _wrap(metric(xl, yl), 0 if X.split == 0 else None, X.device, X.comm)
