"""Shared scaffolding of the blocked distributed programs: the triangular
solve of :mod:`.solver`, and the determinant and Cholesky factorization of
:mod:`.basics` (heat_tpu/core/linalg/_blocked.py).

Each program sweeps diagonal-owner stages over a split-0 operand's physical
shards, and they share two invariants:

* the stage grid: one diagonal tile per shard of ``ceil(n/p)`` rows, stages
  only where the diagonal has logical rows, stage ``t`` owned by shard ``t``
  (the grid heat_tpu reads from its ``SquareDiagTiles`` decomposition with
  one tile per device);
* each shard's row slab is column-padded to the square physical extent and
  its padding rows (unspecified content in the pad+mask layout) are replaced
  by identity rows, so padding contributes an identity block: zero solution
  rows, a determinant factor of 1, an identity Cholesky block.
"""

from __future__ import annotations

from typing import Tuple

import torch

__all__ = []  # private module


def mirror_triangle(local: torch.Tensor, uplo: str = "L") -> torch.Tensor:
    """Symmetric (Hermitian) completion from ONE triangle, numpy's convention
    for cholesky and eigh: the other triangle is never read."""
    if uplo == "L":
        tri, strict = torch.tril(local), torch.tril(local, -1)
    else:
        tri, strict = torch.triu(local), torch.triu(local, 1)
    return tri + strict.mH


def stage_grid(a) -> Tuple[int, int, int, tuple]:
    """``(p, rows_loc, n_stages, owners)`` of a split-0 (n, n) operand:
    ``rows_loc = ceil(n/p)`` rows per shard, a stage for every shard that
    holds diagonal rows, and ``owners[t]`` the shard owning stage ``t``'s
    diagonal tile."""
    p = a.comm.size
    n = int(a.gshape[0])
    rows_loc = -(-n // p)
    n_stages = -(-n // rows_loc) if n else 0
    return p, rows_loc, n_stages, tuple(range(n_stages))


def sanitize_slab(slab: torch.Tensor, idx: int, rows_loc: int, n: int, n_pad: int, dtype):
    """Column-pad shard ``idx``'s physical ``(rows_loc, n)`` row slab to
    ``(rows_loc, n_pad)`` and replace its padding rows with identity rows.

    Returns ``(slab, rows)``, ``rows`` the slab's global row ids (callers use
    them to zero the padding of a right-hand side)."""
    rows = idx * rows_loc + torch.arange(rows_loc, device=slab.device)
    padded = torch.nn.functional.pad(slab.to(dtype), (0, n_pad - n))
    eye_rows = (rows[:, None] == torch.arange(n_pad, device=slab.device)[None, :]).to(dtype)
    return torch.where((rows >= n)[:, None], eye_rows, padded), rows
