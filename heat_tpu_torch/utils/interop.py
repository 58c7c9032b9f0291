"""Carry state into the port from numpy arrays: a distributed array, or a
fitted KMeans (for example one fitted by heat_tpu, exported with numpy)."""

from __future__ import annotations

from typing import Mapping, Optional

import numpy as np

from ..cluster.kmeans import KMeans
from ..core import factories
from ..core.communication import MeshCommunication
from ..core.dndarray import DNDarray

__all__ = ["dndarray_from_numpy", "kmeans_from_state"]


def dndarray_from_numpy(
    arr: np.ndarray, split: Optional[int] = None, comm: Optional[MeshCommunication] = None
) -> DNDarray:
    """A DNDarray holding ``arr`` with the given split, on ``comm``'s devices
    (the default mesh if None). The dtype is kept."""
    return factories.array(np.asarray(arr), split=split, comm=comm)


def kmeans_from_state(
    state: Mapping, comm: Optional[MeshCommunication] = None
) -> KMeans:
    """A fitted :class:`KMeans` from its state: ``cluster_centers_`` (k, f)
    and ``labels_`` (n,) arrays, ``inertia_``, ``n_iter_`` and
    ``n_clusters``. Its ``predict`` works at once; the labels are split
    along the samples."""
    k = int(state["n_clusters"])
    centers = np.asarray(state["cluster_centers_"])
    if centers.shape[0] != k:
        raise ValueError(f"cluster_centers_ holds {centers.shape[0]} rows, not n_clusters={k}")
    est = KMeans(n_clusters=k)
    est._cluster_centers = dndarray_from_numpy(centers, None, comm)
    est._labels = dndarray_from_numpy(np.asarray(state["labels_"]).astype(np.int64), 0, comm)
    est._inertia = float(state["inertia_"])
    est._n_iter = int(state["n_iter_"])
    return est
