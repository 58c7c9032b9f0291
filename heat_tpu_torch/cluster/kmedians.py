"""K-Medians clustering (reference: heat/cluster/kmedians.py,
heat_tpu/cluster/kmedians.py).

The loop of KMeans with the component-wise median of each cluster as its
new center. heat_tpu takes ``jnp.nanmedian`` of a NaN-masked copy of the
data per cluster (k·n·f values); here every cluster's column medians come
from sorts instead: each column's order by value is found once per fit,
and each iteration sorts the labels in that order stably, so that every
cluster's values lie in one sorted segment whose offsets come from
``bincount``. An even count takes the mean of its two middle values, as
``jnp.nanmedian`` does ('midpoint'); an empty cluster keeps its center.
The fit runs in chunks of 8 iterations with the convergence test at chunk
ends, as in heat_tpu.
"""

from __future__ import annotations

from typing import List, Optional, Union

import torch

from ..core.dndarray import DNDarray, _wrap
from ..spatial.distance import _sq_euclidian_fast as _sq_dist
from ._kcluster import _KCluster, _float_dtype

__all__ = ["KMedians"]

CHUNK = 8
"""Iterations per chunk; convergence is tested between chunks."""


def _value_orders(data: torch.Tensor) -> List[torch.Tensor]:
    """Each column's row order by value, as int32 where the rows allow."""
    index = torch.int32 if data.shape[0] < 2**31 else torch.int64
    return [torch.sort(data[:, j], stable=True)[1].to(index) for j in range(data.shape[1])]


def _cluster_medians(data: torch.Tensor, labels: torch.Tensor, k: int, orders: List[torch.Tensor]):
    """(k, f) component-wise medians of each cluster's rows and the (k,)
    counts. Column j's rows in value order, stably sorted by label, put
    cluster c's values in sorted order at ``[start_c, start_c + count_c)``;
    its median is the mean of the two middle ones (the same one for an odd
    count). An empty cluster's row is unspecified."""
    n, f = data.shape
    counts = torch.bincount(labels, minlength=k)
    starts = torch.cumsum(counts, 0) - counts
    lo = torch.clamp(starts + torch.clamp(counts - 1, min=0) // 2, max=n - 1)
    hi = torch.clamp(starts + counts // 2, max=n - 1)
    key = labels.to(torch.int16 if k <= 2**15 else labels.dtype)
    medians = data.new_empty((k, f))
    for j, order in enumerate(orders):
        by_label = torch.sort(key[order], stable=True)[1]
        column = data[:, j]
        medians[:, j] = (column[order[by_label[lo]]] + column[order[by_label[hi]]]) * 0.5
    return medians, counts


def _snap_to_members(data: torch.Tensor, labels: torch.Tensor, k: int, medians: torch.Tensor) -> torch.Tensor:
    """(k, f): for each cluster, its member nearest its median in squared
    distance, the lowest row index on a tie (heat_tpu/cluster/kmedoids.py:30-37)."""
    n = data.shape[0]
    d = medians[labels].sub_(data).square_().sum(dim=1)
    best = d.new_full((k,), torch.inf).scatter_reduce(0, labels, d, "amin")
    rows = torch.arange(n, device=data.device)
    first = torch.full((k,), n, dtype=rows.dtype, device=data.device).scatter_reduce(
        0, labels, torch.where(d == best[labels], rows, n), "amin"
    )
    return data[torch.clamp(first, max=n - 1)]


def _assign(data: torch.Tensor, xn: torch.Tensor, centers: torch.Tensor):
    """Labels and inertia against ``centers``: the squared distances of
    :func:`_sq_dist`, (|x|² + |c|²) − 2x·cᵀ clamped at 0, with |x|² (``xn``)
    computed once per fit; the inertia sums their square roots."""
    d2 = xn + torch.sum(centers * centers, dim=1)[None, :]
    d2.sub_(data @ centers.T, alpha=2.0).clamp_(min=0.0)
    labels = torch.argmin(d2, dim=1)
    return labels, torch.sum(torch.sqrt(torch.gather(d2, 1, labels[:, None])))


def _median_step(data, xn, centers, k: int, orders, medoids: bool):
    """One iteration (heat_tpu/cluster/kmedians.py:24-38, kmedoids.py:24-44):
    ``(new_centers, labels, inertia, shift)``, labels against the input
    centers, inertia the sum of the distances to them."""
    labels, inertia = _assign(data, xn, centers)
    medians, counts = _cluster_medians(data, labels, k, orders)
    if medoids:
        medians = _snap_to_members(data, labels, k, medians)
    new_centers = torch.where(counts[:, None] > 0, medians, centers)
    shift = torch.sum((new_centers - centers) ** 2)
    return new_centers, labels, inertia, shift


def _fit(est: _KCluster, x: DNDarray, medoids: bool, converged) -> None:
    """The chunked loop shared by KMedians and KMedoids: up to CHUNK
    iterations between host reads of the shift."""
    if not isinstance(x, DNDarray):
        raise ValueError(f"input needs to be a DNDarray, but was {type(x)}")
    if x.ndim != 2:
        raise ValueError(f"input needs to be 2D, but was {x.ndim}D")
    data = x.larray.to(_float_dtype(x))
    centers = est._initialize_cluster_centers(x).to(data.dtype)
    orders = _value_orders(data)
    xn = torch.sum(data * data, dim=1, keepdim=True)
    labels = inertia = None
    done = 0
    while done < est.max_iter:
        chunk = min(CHUNK, est.max_iter - done)
        for _ in range(chunk):
            centers, labels, inertia, shift = _median_step(data, xn, centers, est.n_clusters, orders, medoids)
        done += chunk
        if converged(float(shift)):
            break
    est._n_iter = done
    est._inertia = float(inertia) if inertia is not None else None
    est._cluster_centers = _wrap(centers, None, x.device, x.comm)
    est._labels = est._wrap_labels(labels, x)


class KMedians(_KCluster):
    """K-Medians clustering (reference kmedians.py:14-139)."""

    def __init__(
        self,
        n_clusters: int = 8,
        init: Union[str, DNDarray] = "random",
        max_iter: int = 300,
        tol: float = 1e-4,
        random_state: Optional[int] = None,
    ):
        if isinstance(init, str) and init in ("kmeans++", "k-means++"):
            init = "probability_based"
        super().__init__(
            metric=_sq_dist,
            n_clusters=n_clusters,
            init=init,
            max_iter=max_iter,
            tol=tol,
            random_state=random_state,
        )

    def fit(self, x: DNDarray) -> "KMedians":
        """Cluster ``x`` (reference kmedians.py:102-139)."""
        _fit(self, x, medoids=False, converged=lambda shift: shift <= self.tol)
        return self
