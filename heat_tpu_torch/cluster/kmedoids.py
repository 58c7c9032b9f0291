"""K-Medoids clustering (reference: heat/cluster/kmedoids.py,
heat_tpu/cluster/kmedoids.py).

The KMedians update, then each center snaps to the cluster member nearest
its median in squared distance, the lowest row index on a tie, so the
centers are rows of the data; the fit stops on a shift of exactly zero.
"""

from __future__ import annotations

from typing import Optional, Union

from ..core.dndarray import DNDarray
from ..spatial.distance import _sq_euclidian_fast as _sq_dist
from ._kcluster import _KCluster
from .kmedians import _fit

__all__ = ["KMedoids"]


class KMedoids(_KCluster):
    """K-Medoids clustering (reference kmedoids.py:14-139)."""

    def __init__(
        self,
        n_clusters: int = 8,
        init: Union[str, DNDarray] = "random",
        max_iter: int = 300,
        random_state: Optional[int] = None,
    ):
        if isinstance(init, str) and init in ("kmeans++", "k-means++"):
            init = "probability_based"
        super().__init__(
            metric=_sq_dist,
            n_clusters=n_clusters,
            init=init,
            max_iter=max_iter,
            tol=0.0,
            random_state=random_state,
        )

    def fit(self, x: DNDarray) -> "KMedoids":
        """Cluster ``x`` (reference kmedoids.py:106-143)."""
        _fit(self, x, medoids=True, converged=lambda shift: shift == 0.0)
        return self
