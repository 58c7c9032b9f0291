"""K-nearest-neighbours classifier (reference:
heat/classification/kneighborsclassifier.py:62-135,
heat_tpu/classification/kneighborsclassifier.py).

cdist to the training set by quadratic expansion → the k smallest
distances per query, the lower training index first on a tie as
``jax.lax.top_k`` takes them → one-hot votes → argmax. ``torch.topk``
promises no order among ties, so a query whose k-th and (k+1)-th distances
are equal takes its k neighbours from a stable sort of its row instead.
"""

from __future__ import annotations

import torch

from ..core import types
from ..core.base import BaseEstimator, ClassificationMixin
from ..core.dndarray import DNDarray, _wrap
from ..spatial import distance

__all__ = ["KNeighborsClassifier"]


def _k_smallest(d: torch.Tensor, k: int) -> torch.Tensor:
    """(m, k) indices of the k smallest entries of each row of ``d``, the
    lower index first among equal values."""
    n = d.shape[1]
    if k >= n:
        return torch.sort(d, dim=1, stable=True)[1][:, :k]
    values, idx = torch.topk(d, k + 1, dim=1, largest=False, sorted=True)
    idx = idx[:, :k]
    ties = torch.nonzero(values[:, k - 1] == values[:, k]).reshape(-1)
    if ties.numel():
        idx[ties] = torch.sort(d[ties], dim=1, stable=True)[1][:, :k]
    return idx


class KNeighborsClassifier(ClassificationMixin, BaseEstimator):
    """KNN classification (reference kneighborsclassifier.py:14-61).

    Parameters
    ----------
    n_neighbors : int
        Number of neighbors considered in the vote.
    """

    def __init__(self, n_neighbors: int = 5):
        self.n_neighbors = n_neighbors
        self.x = None
        self.y = None
        self.classes = None

    def fit(self, x: DNDarray, y: DNDarray) -> "KNeighborsClassifier":
        """Memorize the training set (reference kneighborsclassifier.py:62-88);
        ``y`` holds integer labels (n,) or one-hot rows (n, c)."""
        if not isinstance(x, DNDarray) or not isinstance(y, DNDarray):
            raise TypeError("x and y need to be DNDarrays")
        if x.shape[0] != y.shape[0]:
            raise ValueError("Number of samples and labels needs to be the same")
        self.x = x
        if y.ndim == 1:
            labels = y.larray
            self.classes = torch.unique(labels)
            self.y = (labels[:, None] == self.classes[None, :]).to(torch.float32)
        elif y.ndim == 2:
            self.classes = None
            self.y = y.larray.to(torch.float32)
        else:
            raise ValueError(f"labels need to be 1D or 2D, but were {y.ndim}D")
        return self

    def predict(self, x: DNDarray) -> DNDarray:
        """Label prediction (reference kneighborsclassifier.py:89-135)."""
        if self.x is None:
            raise RuntimeError("fit needs to be called before predict")
        if not isinstance(x, DNDarray):
            raise TypeError("x needs to be a DNDarray")
        d = distance.cdist(x, self.x, quadratic_expansion=True).larray
        idx = _k_smallest(d, self.n_neighbors)
        del d
        votes = self.y.to(idx.device)[idx]  # (m, k, c)
        winner = torch.argmax(torch.sum(votes, dim=1), dim=1)
        if self.classes is not None:
            labels = self.classes.to(winner.device)[winner]
        else:
            labels = winner.to(types.int32.torch_type())
        return _wrap(labels, x.split, x.device, x.comm)
