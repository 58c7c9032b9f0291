"""Graph Laplacians from similarity data (reference: heat/graph/laplacian.py,
heat_tpu/graph/laplacian.py).

The Laplacian is built shard by shard: a row shard of a ``split=0``
similarity holds its diagonal at its global row offset, and the normalized
form's column scaling takes every row's degree, gathered with one
``allgather``. Each shard's Laplacian is written into one copy of its
similarity block.
"""

from __future__ import annotations

from typing import Callable

import torch

from ..core.dndarray import DNDarray

__all__ = ["Laplacian"]


class Laplacian:
    """Graph Laplacian of a similarity matrix (reference laplacian.py:10-141).

    Parameters
    ----------
    similarity : callable(X) -> (n, n) DNDarray
        e.g. ``lambda x: ht.spatial.rbf(x, sigma=1.0)``.
    definition : 'simple' | 'norm_sym'
    mode : 'fully_connected' | 'eNeighbour'
    threshold_key : 'upper' | 'lower'  (for eNeighbour)
    threshold_value : float
    """

    def __init__(
        self,
        similarity: Callable,
        weighted: bool = True,
        definition: str = "norm_sym",
        mode: str = "fully_connected",
        threshold_key: str = "upper",
        threshold_value: float = 1.0,
        neighbours: int = 10,
    ):
        self.similarity_metric = similarity
        self.weighted = weighted
        if definition not in ("simple", "norm_sym"):
            raise NotImplementedError(
                "Only simple and normalized symmetric graph laplacians are supported at the moment"
            )
        if mode not in ("eNeighbour", "fully_connected"):
            raise NotImplementedError(
                "Only eNeighborhood and fully-connected graphs supported at the moment."
            )
        if threshold_key not in ("upper", "lower"):
            raise ValueError(f"threshold_key must be 'upper' or 'lower', got {threshold_key}")
        self.definition = definition
        self.mode = mode
        self.epsilon = (threshold_key, threshold_value)
        self.neighbours = neighbours

    def _adjacency(self, shard: torch.Tensor, rows: int, offset: int) -> torch.Tensor:
        """A copy of a similarity shard whose first ``rows`` rows hold the
        adjacency: thresholded in eNeighbour mode, the self-loops (the
        diagonal at column ``offset``) zero."""
        out = shard.clone()
        a = out[:rows]
        if self.mode == "eNeighbour":
            key, value = self.epsilon
            keep = a < value if key == "upper" else a > value
            if self.weighted:
                a.masked_fill_(~keep, 0.0)
            else:
                a.copy_(keep)
        a.diagonal(offset).fill_(0.0)
        return out

    def construct(self, X: DNDarray) -> DNDarray:
        """Build the Laplacian of X's similarity graph (reference laplacian.py:127-141):
        L = D − A (``simple``) or L_sym = I − D^−1/2 A D^−1/2 with a unit
        diagonal (``norm_sym``, reference laplacian.py:73-99)."""
        S = self.similarity_metric(X)
        if S.split == 0:
            counts, offsets = S.counts_displs()
            shards = S.shards
        else:
            counts, offsets, shards = S.gshape[:1], (0,), S.shards[:1]
        out = [self._adjacency(s, c, o) for s, c, o in zip(shards, counts, offsets)]
        blocks = [s[:c] for s, c in zip(out, counts)]
        degrees = [torch.sum(a, dim=1) for a in blocks]
        if self.definition == "simple":
            for a, o, deg in zip(blocks, offsets, degrees):
                a.neg_().diagonal(o).copy_(deg)
        else:
            scales = [torch.where(deg > 0, 1.0 / torch.sqrt(deg), 0.0) for deg in degrees]
            columns = S.comm.allgather(scales) if S.split == 0 else scales
            for a, o, row, col in zip(blocks, offsets, scales, columns):
                # (−a·dᵢ)·dⱼ: the reference's −a·dᵢ·dⱼ, the negation exact
                a.mul_(-row[:, None]).mul_(col[None, :]).diagonal(o).fill_(1.0)
        if S.split != 0:
            out = [out[0].to(d) for d in S.comm.devices]
        return DNDarray(out, S.gshape, S.dtype, S.split, S.device, S.comm)
