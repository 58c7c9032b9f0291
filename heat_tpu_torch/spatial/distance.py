"""Pairwise distances (reference: heat/spatial/distance.py,
heat_tpu/spatial/distance.py).

Every metric has the signature ``metric(x, y, out=None)`` and writes the
(n, m) block of ``x`` against ``y`` into ``out`` (allocated when None), which
may be a column block of a wider array. The engine :func:`_dist`
preallocates the result and hands each metric its block:

* at most one operand row-split across devices: one block, the global
  operands against each other, split like ``X``;
* both operands row-split on p > 1 devices: a ring over the shard list
  (each process computing the tiles of its own ranks), the symmetric schedule for ``Y`` absent or ``X`` itself (⌈p/2⌉
  rotations, the mirrored tiles delivered as transposes by one
  all-to-all), else the general one (p − 1 rotations).

The exact metrics (``_euclidian``, ``_manhattan``, ``_gaussian``) run kernel
B2 (:mod:`heat_tpu_torch.ops.pairwise`) on CUDA tensors and its plain
version on CPU tensors. The quadratic-expansion metrics are matrix products
(``torch.matmul``, as XLA computed them outside any Pallas kernel),
evaluated in blocks of rows so that no temporary is the size of the result.
"""

from __future__ import annotations

import functools
from typing import Callable, List, Optional

import torch

from ..core import sanitation, types
from ..core.communication import MeshCommunication
from ..core.dndarray import DNDarray, _wrap
from ..ops import pairwise

__all__ = ["cdist", "manhattan", "rbf"]

QUADRATIC_ELEMENTS = 1 << 27
"""Output elements per block of rows of the quadratic expansion: its one
temporary, the block's product x·yᵀ, never holds more."""


# ----------------------------------------------------------------------------
# local metrics (reference distance.py:16-134)
# ----------------------------------------------------------------------------
def _euclidian(x: torch.Tensor, y: torch.Tensor, out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Direct pairwise Euclidean distance (reference distance.py:16-37)."""
    return pairwise.pairwise_kernel(x, y, 2, True, out)


def _sq_euclidian_fast(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Squared pairwise distance by quadratic expansion, |x|² + |y|² − 2x·yᵀ:
    one matrix product. Shared by cdist and the k-clustering assignment."""
    xn = torch.sum(x * x, dim=1, keepdim=True)
    yn = torch.sum(y * y, dim=1, keepdim=True)
    return torch.clamp(xn + yn.T - 2.0 * (x @ y.T), min=0.0)


def _quadratic(x: torch.Tensor, y: torch.Tensor, out: Optional[torch.Tensor], finish) -> torch.Tensor:
    """``finish`` applied in place to :func:`_sq_euclidian_fast`'s
    expression, evaluated into ``out`` in blocks of rows: the same
    arithmetic in the same order, (|x|² + |y|²) − 2·(x·yᵀ) clamped at 0."""
    n, m = x.shape[0], y.shape[0]
    if out is None:
        out = torch.empty((n, m), dtype=x.dtype, device=x.device)
    yn = torch.sum(y * y, dim=1)
    rows = max(1, QUADRATIC_ELEMENTS // max(1, m))
    for r0 in range(0, n, rows):
        xb, block = x[r0 : r0 + rows], out[r0 : r0 + rows]
        torch.add(torch.sum(xb * xb, dim=1, keepdim=True), yn, out=block)
        block.add_(xb @ y.T, alpha=-2.0)
        finish(block.clamp_(min=0.0))
    return out


def _euclidian_fast(x: torch.Tensor, y: torch.Tensor, out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Quadratic-expansion Euclidean distance (reference distance.py:40-60)."""
    return _quadratic(x, y, out, torch.Tensor.sqrt_)


def _manhattan(x: torch.Tensor, y: torch.Tensor, out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Pairwise L1 distance (reference distance.py:95-115)."""
    return pairwise.pairwise_kernel(x, y, 1, False, out)


def _gaussian(
    x: torch.Tensor, y: torch.Tensor, sigma: float = 1.0, out: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """RBF kernel values (reference distance.py:63-92): the squared distance
    of kernel B2, then exp(−d²/(2σ²)) in place."""
    d2 = pairwise.pairwise_kernel(x, y, 2, False, out)
    return d2.div_(-(2.0 * sigma * sigma)).exp_()


def _gaussian_fast(
    x: torch.Tensor, y: torch.Tensor, sigma: float = 1.0, out: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """RBF via quadratic expansion (reference distance.py:118-134)."""
    return _quadratic(x, y, out, lambda b: b.div_(-(2.0 * sigma * sigma)).exp_())


def cdist(X: DNDarray, Y: Optional[DNDarray] = None, quadratic_expansion: bool = False) -> DNDarray:
    """Pairwise distance matrix (reference distance.py:136-175)."""
    metric = _euclidian_fast if quadratic_expansion else _euclidian
    return _dist(X, Y, metric)


def manhattan(X: DNDarray, Y: Optional[DNDarray] = None, expand: bool = False) -> DNDarray:
    """Pairwise L1 distance matrix (reference distance.py:176-207)."""
    return _dist(X, Y, _manhattan)


@functools.lru_cache(maxsize=32)
def _gaussian_metric(sigma: float, fast: bool) -> Callable:
    """One stable metric closure per (sigma, fast) (heat_tpu/spatial/distance.py:83-89)."""
    if fast:
        return lambda x, y, out=None: _gaussian_fast(x, y, sigma, out)
    return lambda x, y, out=None: _gaussian(x, y, sigma, out)


def rbf(
    X: DNDarray,
    Y: Optional[DNDarray] = None,
    sigma: float = 1.0,
    quadratic_expansion: bool = False,
) -> DNDarray:
    """Pairwise RBF kernel matrix (reference distance.py:176-207)."""
    return _dist(X, Y, _gaussian_metric(float(sigma), bool(quadratic_expansion)))


# ----------------------------------------------------------------------------
# the engine (heat_tpu/spatial/distance.py:102-158)
# ----------------------------------------------------------------------------
def _dist(X: DNDarray, Y: Optional[DNDarray], metric: Callable) -> DNDarray:
    """Distance engine (reference distance.py:209-487)."""
    sanitation.sanitize_in(X)
    if X.ndim != 2:
        raise NotImplementedError(f"X should be 2D, but was {X.ndim}D")
    promoted = types.promote_types(X.dtype, types.float32)
    symmetric = Y is None or Y is X
    if symmetric:
        Y = X
    else:
        sanitation.sanitize_in(Y)
        sanitation.sanitize_mesh(X, Y)
        if Y.ndim != 2:
            raise NotImplementedError(f"Y should be 2D, but was {Y.ndim}D")
        if X.shape[1] != Y.shape[1]:
            raise ValueError("inputs must have the same number of features")
        promoted = types.promote_types(promoted, Y.dtype)
    dtype = promoted.torch_type()
    comm = X.comm
    n, m = X.shape[0], Y.shape[0]

    if X.split == 0 and Y.split == 0 and comm.size > 1:
        xs = _ring_operand(X, dtype)
        if symmetric:
            rows = _ring_dist_sym(xs, metric, comm)
        else:
            rows = _ring_dist(xs, _ring_operand(Y, dtype), metric, comm)
        # each shard's row block is already the pad+mask shard of the
        # result: ceil(n/p) rows, the rows past n padding
        return DNDarray([r[:, :m] for r in rows], (n, m), promoted, 0, X.device, comm)

    # one operand replicated (reference distance.py:422-427), or a layout
    # the ring does not cover: one block of the global operands
    xl = X.larray.to(dtype)
    yl = xl if symmetric else Y.larray.to(device=xl.device, dtype=dtype)
    out = metric(xl, yl, torch.empty((n, m), dtype=dtype, device=xl.device))
    return _wrap(out, 0 if X.split == 0 else None, X.device, comm)


def _ring_operand(A: DNDarray, dtype: torch.dtype) -> List[torch.Tensor]:
    """This process's row shards of ``A`` in ``dtype``, the padding rows set
    to zero: the logical rows padded with zeros to a multiple of p
    (heat_tpu/spatial/distance.py:127-148). The shards' own padding has
    unspecified content and never reaches a metric."""
    counts, _ = A.comm.local_counts_displs(A.gshape, 0)
    shards = []
    for s, c in zip(A.shards, counts):
        s = s.to(dtype)
        if c < s.shape[0]:
            s = torch.cat([s[:c], s.new_zeros((s.shape[0] - c, s.shape[1]))])
        shards.append(s)
    return shards


def _sym_schedule(p: int):
    """Rotation schedule of the symmetric ring (heat_tpu/spatial/distance.py:161-169):
    step offsets whose tiles are computed directly; offsets p-i for i in
    the first half arrive as transposes. ``(paired, self_paired)`` —
    ``len(paired) (+1 if self_paired)`` rotations instead of the general
    ring's p-1."""
    paired = list(range(1, (p - 1) // 2 + 1))
    self_paired = p % 2 == 0 and p > 1
    return paired, self_paired


def _ring_dist_sym(xs: List[torch.Tensor], metric: Callable, comm: MeshCommunication) -> List[torch.Tensor]:
    """Symmetric ring (Y ≡ X, heat_tpu/spatial/distance.py:172-263): shard d
    computes its diagonal tile and the tiles (d, d+i) for i = 1..h directly,
    one shift-1 rotation per offset; the tiles (d, d−i) are their mirrors,
    delivered as transposes by one all-to-all; for even p every shard also
    computes offset p/2, its own mirror. ``p·(1 + h + [p even])`` metric
    calls over the mesh; this process computes the tiles of its own ranks
    (``xs``, in rank order) and returns their (mb, mb·p) row blocks."""
    p = comm.size
    ranks = comm.local_ranks
    mb = xs[0].shape[0]
    paired, self_paired = _sym_schedule(p)
    h = len(paired)
    out = [torch.empty((mb, mb * p), dtype=x.dtype, device=x.device) for x in xs]

    def tile(k: int, j: int) -> torch.Tensor:
        return out[k][:, (j % p) * mb : (j % p + 1) * mb]

    for k, d in enumerate(ranks):
        metric(xs[k], xs[k], tile(k, d))
    ys = list(xs)
    for i in paired:
        ys = comm.ppermute(ys, shift=1)  # rank d now holds rank d + i's rows
        for k, d in enumerate(ranks):
            metric(xs[k], ys[k], tile(k, d + i))
    if h:
        # slot j of rank d is column block j of its row block, which holds
        # tile (d, j) where (j - d) % p is in 1..h; the all-to-all hands
        # slot j to rank j, so rank r receives tile (d, r) from every d,
        # whichever process computed it
        slots = [o.view(mb, p, mb).transpose(0, 1) for o in out]
        mirror = comm.alltoall(slots, split_axis=0, concat_axis=0)
        for k, r in enumerate(ranks):
            for d in range(p):
                if 1 <= (r - d) % p <= h:
                    tile(k, d).copy_(mirror[k][d].T)
        del mirror
    if self_paired:
        ys = comm.ppermute(ys, shift=1)  # offset p/2 is its own mirror
        for k, d in enumerate(ranks):
            metric(xs[k], ys[k], tile(k, d + p // 2))
    return out


def _ring_dist(
    xs: List[torch.Tensor], ys: List[torch.Tensor], metric: Callable, comm: MeshCommunication
) -> List[torch.Tensor]:
    """General ring (heat_tpu/spatial/distance.py:266-309): the X shards stay,
    the Y shards rotate by ``ppermute``, rank d writes tile (d, d+i) at
    step i; p − 1 rotations, the last visiting shard folded without being
    sent again. p² metric calls over the mesh; this process computes the
    tiles of its own ranks (``xs``, ``ys`` in rank order) and returns their
    (mbx, mby·p) row blocks."""
    p = comm.size
    mby = ys[0].shape[0]
    out = [torch.empty((x.shape[0], mby * p), dtype=x.dtype, device=x.device) for x in xs]
    for i in range(p):
        if i:
            ys = comm.ppermute(ys, shift=1)  # rank d now holds rank d + i's rows
        for k, d in enumerate(comm.local_ranks):
            j = (d + i) % p
            metric(xs[k], ys[k], out[k][:, j * mby : (j + 1) * mby])
    return out
