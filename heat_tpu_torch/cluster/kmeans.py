"""K-Means clustering (reference: heat/cluster/kmeans.py,
heat_tpu/cluster/kmeans.py).

Lloyd's algorithm runs in chunks of up to 8 iterations, with the
convergence test at chunk boundaries, as in heat_tpu. Two paths:

* the fused path (:mod:`heat_tpu_torch.ops.lloyd`): one pass of the
  hand-written CUDA kernel per iteration for CUDA tensors, its plain version
  for CPU tensors;
* the torch path (:func:`_lloyd_run`), the port of heat_tpu's jnp oracle,
  with the assignment and the update as two matrix products.

Over a mesh whose ranks span processes the fused path runs on this
process's shards (global ranks ``comm.first_rank`` on), its accumulators
summed across processes by the mesh's ``allreduce``; the centers come out
replicated and the labels split like the rows, never gathered.
"""

from __future__ import annotations

from typing import Optional, Union

import torch
import torch.nn.functional as F

from ..core.dndarray import DNDarray, _wrap
from ..ops import lloyd as _lloyd
from ..spatial.distance import _sq_euclidian_fast as _sq_dist
from ._kcluster import _KCluster, _float_dtype

__all__ = ["KMeans"]

CHUNK = 8
"""Iterations per chunk; convergence is tested between chunks."""


def _lloyd_iter(data: torch.Tensor, centers: torch.Tensor, k: int, xsq_sum=None):
    """One Lloyd iteration (heat_tpu/cluster/kmeans.py:51-68): returns
    ``(new_centers, labels, inertia, shift)``, labels against the input
    centers, inertia with Σ|x|²."""
    if xsq_sum is None:
        xsq_sum = torch.sum(data * data)
    # score = d² − |x|² (a row-constant offset): the same argmin
    score = torch.sum(centers * centers, dim=1) - 2.0 * (data @ centers.T)
    labels = torch.argmin(score, dim=1)
    onehot = F.one_hot(labels, k).to(data.dtype)
    counts = torch.sum(onehot, dim=0)
    sums = onehot.T @ data
    new_centers = torch.where(
        counts[:, None] > 0, sums / torch.clamp(counts[:, None], min=1.0), centers
    )
    inertia = torch.clamp(torch.sum(torch.amin(score, dim=1)) + xsq_sum, min=0.0)
    shift = torch.sum((new_centers - centers) ** 2)
    return new_centers, labels, inertia, shift


def _lloyd_run(data: torch.Tensor, centers: torch.Tensor, k: int, n_steps: int):
    """``n_steps`` Lloyd iterations with Σ|x|² computed once
    (heat_tpu/cluster/kmeans.py:27-48)."""
    xsq_sum = torch.sum(data * data)
    labels = inertia = shift = None
    for _ in range(n_steps):
        centers, labels, inertia, shift = _lloyd_iter(data, centers, k, xsq_sum)
    return centers, labels, inertia, shift


class KMeans(_KCluster):
    """K-Means with Lloyd's algorithm (reference kmeans.py:14-139).

    Parameters mirror the reference: n_clusters=8, init='random',
    max_iter=300, tol=1e-4, random_state=None. ``use_fused`` selects the
    fused Lloyd path (:mod:`heat_tpu_torch.ops.lloyd`): ``None`` takes it
    whenever the shape allows (f ≤ 512 features, k ≤ 128 clusters) and the
    torch path otherwise; ``True`` takes it and raises for a shape it does
    not take; ``False`` pins the torch path. A failing kernel raises: there
    is no fallback.
    """

    def __init__(
        self,
        n_clusters: int = 8,
        init: Union[str, DNDarray] = "random",
        max_iter: int = 300,
        tol: float = 1e-4,
        random_state: Optional[int] = None,
        use_fused: Optional[bool] = None,
    ):
        if isinstance(init, str) and init in ("kmeans++", "k-means++"):
            init = "probability_based"
        self.use_fused = use_fused
        super().__init__(
            metric=_sq_dist,
            n_clusters=n_clusters,
            init=init,
            max_iter=max_iter,
            tol=tol,
            random_state=random_state,
        )

    def _fused_mode(self, x: DNDarray) -> Optional[str]:
        """'sharded' (split=0: the kernel runs on each physical shard),
        'single' (on the logical array) or None (the torch path)."""
        if self.use_fused is False:
            return None
        f, k = int(x.shape[1]), self.n_clusters
        if not _lloyd.fused_supported(f, k):
            if self.use_fused:
                raise ValueError(
                    f"KMeans(use_fused=True): the fused Lloyd kernel takes f <= "
                    f"{_lloyd.MAX_FEATURES} and k <= {_lloyd.MAX_CLUSTERS}, got f={f}, k={k}"
                )
            return None
        return "sharded" if x.split == 0 else "single"

    def fit(self, x: DNDarray) -> "KMeans":
        """Cluster ``x`` (n_samples, n_features) (reference kmeans.py:102-139)."""
        if not isinstance(x, DNDarray):
            raise ValueError(f"input needs to be a DNDarray, but was {type(x)}")
        if x.ndim != 2:
            raise ValueError(f"input needs to be 2D, but was {x.ndim}D")
        k = self.n_clusters
        centers = self._initialize_cluster_centers(x)
        mode = self._fused_mode(x)
        fdtype = _float_dtype(x)
        n_global = int(x.shape[0])
        first_rank = x.comm.first_rank
        if mode == "sharded":
            # each shard's pass masks its share of the padding itself
            xs = [_lloyd.stream_operand(s) for s in x.shards]
            xsq = _lloyd.logical_xsq_sum(xs, n_global, x.comm, first_rank)
        elif mode == "single":
            data, xsq = _lloyd.prepare_run_operands(x.larray)
            xs = [data]
        else:
            data = x.larray.to(fdtype)
        centers = centers.to(fdtype)

        # the fused path takes the labels once, after the last chunk, against
        # that chunk's last input centers: the labels a run returns
        labels = inertia = used = None
        done = 0
        while done < self.max_iter:
            chunk = min(CHUNK, self.max_iter - done)
            if mode is None:
                centers, labels, inertia, shift = _lloyd_run(data, centers, k, chunk)
            else:
                centers, used, inertia, shift = _lloyd.run_steps(
                    xs, centers, k, x.comm, n_global, chunk, xsq, first_rank
                )
            done += chunk
            if float(shift) <= self.tol:
                break
        self._n_iter = done
        self._inertia = float(inertia) if inertia is not None else None
        self._cluster_centers = _wrap(centers, None, x.device, x.comm)
        if mode == "sharded" and used is not None:
            self._labels = self._split_labels(xs, used, n_global, x)
            return self
        if mode == "single" and used is not None:
            labels = _lloyd.sharded_labels(xs, used, n_global)
        self._labels = self._wrap_labels(labels, x)
        return self

    @staticmethod
    def _split_labels(xs, used: torch.Tensor, n_global: int, x: DNDarray) -> DNDarray:
        """The labels of this process's rows as the shards of a split=0
        array, each on its shard's device and padded to its shard's rows:
        no gather and no redistribution."""
        from ..core import types

        shards = []
        for r, s in zip(x.comm.local_ranks, xs):
            got = _lloyd.sharded_labels([s], used, n_global, r).to(types.index_dtype())
            shards.append(torch.cat([got, got.new_zeros(s.shape[0] - got.shape[0])]))
        return DNDarray(shards, (n_global,), types.canonical_heat_type(shards[0].dtype), 0, x.device, x.comm)
