"""Shared k-clustering base (reference: heat/cluster/_kcluster.py,
heat_tpu/cluster/_kcluster.py).

Initialization follows the reference: ``"random"`` picks k random rows,
``"probability_based"`` (kmeans++) samples each next center with probability
proportional to its squared distance from the nearest chosen one
(reference _kcluster.py:142-187), and a DNDarray of k rows is taken as given.
The batch-parallel init is not ported yet.
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
        elif init not in ("random", "probability_based", "kmeans++", "k-means++"):
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
        data = x.larray.to(_float_dtype(x))
        n = data.shape[0]
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
            cum = torch.cumsum(closest / torch.sum(closest), dim=0)
            r = float(ht_random.rand(1, device=x.device, comm=x.comm).larray[0])
            nxt = min(int(torch.searchsorted(cum, cum.new_tensor([r]))), n - 1)
            centers = torch.cat([centers, data[nxt][None, :]], dim=0)
        return centers

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
