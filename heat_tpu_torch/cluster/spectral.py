"""Spectral clustering (reference: heat/cluster/spectral.py,
heat_tpu/cluster/spectral.py).

RBF or Euclidean similarity (quadratic expansion) → normalized symmetric
Laplacian → Lanczos (:func:`heat_tpu_torch.core.linalg.lanczos`, from
heat_tpu's start vector) → ``torch.linalg.eigh`` of the small tridiagonal T
→ the embedding V·evecs → KMeans on its first ``n_clusters`` columns, which
runs the fused Lloyd kernel on the GPU.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from ..core.base import BaseEstimator, ClusteringMixin
from ..core.dndarray import DNDarray, _wrap
from ..core.linalg import solver
from ..graph import Laplacian
from ..spatial import distance
from .kmeans import KMeans

__all__ = ["Spectral"]


class Spectral(ClusteringMixin, BaseEstimator):
    """Spectral clustering on the graph Laplacian's eigen-embedding
    (reference spectral.py:14-102 for the constructor contract); ``params``
    go to the KMeans of the embedding."""

    def __init__(
        self,
        n_clusters: Optional[int] = None,
        gamma: float = 1.0,
        metric: str = "rbf",
        laplacian: str = "fully_connected",
        threshold: float = 1.0,
        boundary: str = "upper",
        n_lanczos: int = 300,
        assign_labels: str = "kmeans",
        **params,
    ):
        self.n_clusters = n_clusters
        self.gamma = gamma
        self.metric = metric
        self.laplacian = laplacian
        self.threshold = threshold
        self.boundary = boundary
        self.n_lanczos = n_lanczos
        self.assign_labels = assign_labels

        if metric == "rbf":
            sigma = math.sqrt(1.0 / (2.0 * gamma))
            sim = lambda x: distance.rbf(x, sigma=sigma, quadratic_expansion=True)
        elif metric == "euclidean":
            sim = lambda x: distance.cdist(x, quadratic_expansion=True)
        else:
            raise NotImplementedError(f"Metric {metric} is currently not implemented")
        if laplacian == "fully_connected":
            self._laplacian = Laplacian(sim, definition="norm_sym", mode="fully_connected")
        elif laplacian == "eNeighbour":
            self._laplacian = Laplacian(
                sim,
                definition="norm_sym",
                mode="eNeighbour",
                threshold_key=boundary,
                threshold_value=threshold,
            )
        else:
            raise NotImplementedError(f"Laplacian {laplacian} is currently not implemented")
        if assign_labels != "kmeans":
            raise NotImplementedError(
                f"Assignment-method {assign_labels} is currently not implemented"
            )
        self._cluster = KMeans(n_clusters=n_clusters if n_clusters is not None else 8, **params)
        self._labels = None

    @property
    def labels_(self) -> DNDarray:
        return self._labels

    def _spectral_embedding(self, x: DNDarray):
        """T's eigenvalues, ascending, and the Lanczos eigen-embedding of the
        Laplacian, split like ``x`` (reference spectral.py:103-140)."""
        L = self._laplacian.construct(x)
        V, T = solver.lanczos(L, min(self.n_lanczos, L.shape[0]))
        del L
        evals, evecs = torch.linalg.eigh(T.larray)
        return evals, _wrap(V.larray @ evecs, x.split, x.device, x.comm)

    def fit(self, x: DNDarray) -> "Spectral":
        """Embed and cluster (reference spectral.py:141-170); with
        ``n_clusters=None`` the largest gap between consecutive eigenvalues
        of T sets it (reference spectral.py:152-157)."""
        if not isinstance(x, DNDarray):
            raise ValueError(f"input needs to be a DNDarray, but was {type(x)}")
        if x.split is not None and x.split != 0:
            raise NotImplementedError("Not implemented for other splitting-axes")
        eigenvalues, eigenvectors = self._spectral_embedding(x)
        if self.n_clusters is None:
            self.n_clusters = int(np.argmax(np.diff(eigenvalues.cpu().numpy())) + 1)
            self._cluster.n_clusters = self.n_clusters
        components = eigenvectors[:, : self.n_clusters]
        self._cluster.fit(components.balance_())
        self._labels = self._cluster.labels_
        return self

    def predict(self, x: DNDarray) -> DNDarray:
        """Labels of the embedding of ``x`` by the trained KMeans
        (reference spectral.py:171-189)."""
        if not isinstance(x, DNDarray):
            raise ValueError(f"input needs to be a DNDarray, but was {type(x)}")
        _, eigenvectors = self._spectral_embedding(x)
        return self._cluster.predict(eigenvectors[:, : self.n_clusters])
