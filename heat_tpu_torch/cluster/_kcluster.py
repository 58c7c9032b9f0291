"""Shared k-clustering base (reference: heat/cluster/_kcluster.py,
heat_tpu/cluster/_kcluster.py).

Initialization follows the reference: ``"random"`` picks k random rows,
``"probability_based"`` (kmeans++) samples each next center with probability
proportional to its squared distance from the nearest chosen one
(reference _kcluster.py:142-187), and a DNDarray of k rows is taken as given.
``"batchparallel"`` runs a fixed-shape kmeans++ on each row shard, gathers
the p·k candidates with one ``allgather`` and runs one more kmeans++ over
them (heat_tpu/cluster/_kcluster.py:27-66, :139-178); on a replicated,
padded or single-shard input, or one with fewer than k rows per shard, it
is kmeans++, as in heat_tpu. Over a mesh whose ranks span processes each
process runs the per-shard kmeans++ of its own ranks, seeded by global
rank, and the batch-parallel init never gathers the table; the random and
kmeans++ inits read ``x.larray``, one gather of the whole table.
"""

from __future__ import annotations

from typing import Callable, Optional, Union

import torch

from ..core import random as ht_random
from ..core import types
from ..core.base import BaseEstimator, ClusteringMixin
from ..core.dndarray import DNDarray, _wrap

__all__ = ["_KCluster"]


def _float_dtype(x: DNDarray) -> torch.dtype:
    """The compute dtype of a clustering: at least float32."""
    return types.promote_types(x.dtype, types.float32).torch_type()


def _kmeanspp_fixed(generator: torch.Generator, data: torch.Tensor, k: int, metric) -> torch.Tensor:
    """kmeans++ over one block with no host read (heat_tpu/cluster/_kcluster.py:27-51):
    the (k, f) centers buffer is filled row by row, the rows not yet filled
    masked out of the minimum distance by the step index, each draw made on
    the block's device from ``generator``, each row picked by
    :func:`_draw_index`."""
    n, f = data.shape
    device = data.device
    first = torch.randint(0, n, (), generator=generator, device=device)
    centers = data.new_zeros((k, f))
    centers[0] = data[first]
    steps = torch.arange(k, device=device)
    for i in range(1, k):
        d = metric(data, centers)
        dmin = torch.amin(torch.where(steps[None, :] < i, d, torch.inf), dim=1)
        total = torch.sum(dmin)
        prob = torch.where(total > 0, dmin / torch.clamp(total, min=1e-30), 1.0 / n)
        r = torch.rand((), generator=generator, device=device, dtype=prob.dtype)
        centers[i] = data[_draw_index(prob, r)]
    return centers


DRAW_SCALE = float(2**40)
"""Fixed-point unit of :func:`_draw_index`'s weights."""


def _draw_index(prob: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """Inverse-CDF draw: the first row whose cumulative weight exceeds ``r``
    (uniform in [0, 1)) of the total, the weights ``prob`` taken as int64
    multiples of ``1 / DRAW_SCALE``. An integer cumulative sum is exact, so
    the row does not depend on the order a device's scan adds in: a float
    ``cumsum`` on CUDA varies run to run in its last bits, and so would the
    row picked."""
    weights = torch.floor(prob.double() * DRAW_SCALE).to(torch.int64)
    cum = torch.cumsum(weights, 0)
    target = torch.floor(r.double() * cum[-1].double()).to(torch.int64)
    return torch.clamp(torch.searchsorted(cum, target[None], right=True), 0, prob.shape[0] - 1)[0]


class _KCluster(ClusteringMixin, BaseEstimator):
    """Base class for k-statistics clustering (reference _kcluster.py:13-86).

    Parameters
    ----------
    metric : callable(x, y) -> distances
        Pairwise-distance function on tensors.
    n_clusters, init, max_iter, tol, random_state : see reference.
    """

    def __init__(
        self,
        metric: Callable,
        n_clusters: int,
        init: Union[str, DNDarray],
        max_iter: int,
        tol: float,
        random_state: Optional[int],
    ):
        self.n_clusters = n_clusters
        self.init = init
        self.max_iter = max_iter
        self.tol = tol
        self.random_state = random_state

        self._metric = metric
        self._cluster_centers = None
        self._labels = None
        self._inertia = None
        self._n_iter = None

        if random_state is not None:
            ht_random.seed(random_state)

        if isinstance(init, DNDarray):
            if init.shape[0] != n_clusters:
                raise ValueError(
                    f"passed centroids do not match n_clusters: {init.shape[0]} != {n_clusters}"
                )
            self.init = "precomputed"
            self._precomputed = init
        elif init not in ("random", "probability_based", "kmeans++", "k-means++", "batchparallel"):
            raise ValueError(f"Initialization method {init!r} not supported")

    @property
    def cluster_centers_(self) -> DNDarray:
        return self._cluster_centers

    @property
    def labels_(self) -> DNDarray:
        return self._labels

    @property
    def inertia_(self) -> float:
        return self._inertia

    @property
    def n_iter_(self) -> int:
        return self._n_iter

    def _initialize_cluster_centers(self, x: DNDarray) -> torch.Tensor:
        """Pick the initial centroids (reference _kcluster.py:87-195)."""
        k = self.n_clusters
        n = x.shape[0]
        if (
            self.init == "batchparallel"
            and x.split == 0
            and x.comm.size > 1
            and not x.padded
            and n // x.comm.size >= k
        ):
            return self._batchparallel_init(x, _float_dtype(x), k)
        data = x.larray.to(_float_dtype(x))
        if self.init == "precomputed":
            return self._precomputed.larray.to(device=data.device, dtype=data.dtype)
        if self.init == "random":
            idx = ht_random.randint(0, n, (k,), device=x.device, comm=x.comm).larray
            return data[idx.to(data.device).long()]
        # kmeans++ / probability_based (reference _kcluster.py:142-187)
        idx0 = int(ht_random.randint(0, n, (1,), device=x.device, comm=x.comm).larray[0])
        centers = data[idx0][None, :]
        for _ in range(1, k):
            closest = torch.amin(self._metric(data, centers), dim=1)
            r = ht_random.rand(1, device=x.device, comm=x.comm).larray[0].to(closest.device)
            nxt = _draw_index(closest / torch.clamp(torch.sum(closest), min=1e-30), r)
            centers = torch.cat([centers, data[nxt][None, :]], dim=0)
        return centers

    def _batchparallel_init(self, x: DNDarray, dtype: torch.dtype, k: int) -> torch.Tensor:
        """Batch-parallel init (heat_tpu/cluster/_kcluster.py:162-178): each
        shard runs :func:`_kmeanspp_fixed` over its own rows with a generator
        seeded from one ``ht.random`` draw plus its global rank; one ``allgather``
        brings the p·k candidates together, and one more kmeans++ over them,
        seeded from the draw plus p, picks the k centers."""
        comm = x.comm
        seed = int(ht_random.randint(0, 2**31 - 1, (1,), device=x.device, comm=comm).larray[0])
        local = []
        for r, shard in zip(comm.local_ranks, x.shards):
            gen = torch.Generator(device=shard.device).manual_seed(seed + r)
            local.append(_kmeanspp_fixed(gen, shard.to(dtype), k, self._metric))
        candidates = comm.allgather(local)[0]
        gen = torch.Generator(device=candidates.device).manual_seed(seed + comm.size)
        return _kmeanspp_fixed(gen, candidates, k, self._metric)

    def _assign_to_cluster(self, x: DNDarray) -> DNDarray:
        """Cluster id per sample (reference _kcluster.py:196-209)."""
        data = x.larray.to(_float_dtype(x))
        centers = self._cluster_centers.larray.to(device=data.device, dtype=data.dtype)
        return self._wrap_labels(torch.argmin(self._metric(data, centers), dim=1), x)

    def _wrap_labels(self, labels: torch.Tensor, x: DNDarray) -> DNDarray:
        """Labels over the samples: split like x when x is sample-split,
        else replicated."""
        labels = labels.to(types.index_dtype())
        return _wrap(labels, 0 if x.split == 0 else None, x.device, x.comm)

    def predict(self, x: DNDarray) -> DNDarray:
        """Nearest-centroid labels for new data (reference _kcluster.py:210-254)."""
        if self._cluster_centers is None:
            raise RuntimeError("fit needs to be called before predict")
        if not isinstance(x, DNDarray):
            raise ValueError(f"input needs to be a DNDarray, but was {type(x)}")
        return self._assign_to_cluster(x)
