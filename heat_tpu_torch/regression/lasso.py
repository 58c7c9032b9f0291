"""Lasso regression (reference: heat/regression/lasso.py,
heat_tpu/regression/lasso.py).

Coordinate descent with soft thresholding in float32; column 0 of x is the
unpenalized intercept feature. Two sweeps, as in heat_tpu:

* Gram (covariance) mode, when the (m, m) Gram is at most 2²² elements and
  n >= m: X'X and X'y once per fit (on row shards, one ``allreduce`` each),
  then every sweep updates the m-vector c = X'y − X'X·θ only;
* the incremental-residual sweep otherwise: the residual is refreshed once
  per sweep and updated after each coordinate (on row shards, one
  ``allreduce`` per coordinate).

A sweep is a Python loop of small torch calls per feature, all on the
device; the RMSE stop after each sweep is one host read.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch

from ..core import sanitation
from ..core.base import BaseEstimator, RegressionMixin
from ..core.dndarray import DNDarray, _wrap

__all__ = ["Lasso"]

GRAM_MAX_ELEMENTS = 1 << 22
"""Largest (m, m) Gram that Gram mode keeps (heat_tpu/regression/lasso.py:65)."""


def _soft_threshold(rho: torch.Tensor, lam: float, j: int) -> torch.Tensor:
    """The coordinate's new value: rho for the intercept (j = 0), else
    sign(rho)·max(|rho| − lam, 0)."""
    if j == 0:
        return rho
    return torch.sign(rho) * torch.clamp(torch.abs(rho) - lam, min=0.0)


def _sweep_gram(G: torch.Tensor, cy: torch.Tensor, theta: torch.Tensor, lam: float, n: int) -> torch.Tensor:
    """One sweep in the covariance form (heat_tpu/regression/lasso.py:82-108):
    rho_j = (c_j + θ_j·G_jj)/n with c = X'y − G·θ, and c −= (new − θ_j)·G_j."""
    theta = theta.clone()
    c = cy - G @ theta[:, 0]
    for j in range(G.shape[0]):
        g_j, th_j = G[j], theta[j, 0]
        new = _soft_threshold((c[j] + th_j * g_j[j]) / n, lam, j)
        c = c - (new - th_j) * g_j
        theta[j, 0] = new
    return theta


def _sweep_residual(
    XT: List[torch.Tensor], y: List[torch.Tensor], theta: torch.Tensor, lam: float, n: int, reduce
) -> torch.Tensor:
    """One sweep in the incremental-residual form (heat_tpu/regression/lasso.py:25-57)
    over row blocks ``XT`` (each (m, rows), features in rows) and ``y``:
    rho_j = X_j·(r + θ_j·X_j)/n summed over the blocks by ``reduce``, then
    r −= (new − θ_j)·X_j on each block."""
    theta = theta.clone()
    r = [yb - theta[:, 0].to(xb.device) @ xb for xb, yb in zip(XT, y)]
    for j in range(theta.shape[0]):
        th_j = theta[j, 0]
        partial = [xb[j] @ (rb + th_j.to(xb.device) * xb[j]) for xb, rb in zip(XT, r)]
        new = _soft_threshold(reduce(partial) / n, lam, j)
        delta = new - th_j
        r = [rb - delta.to(xb.device) * xb[j] for xb, rb in zip(XT, r)]
        theta[j, 0] = new
    return theta


class Lasso(RegressionMixin, BaseEstimator):
    """Least absolute shrinkage and selection operator (reference lasso.py:14-89).

    Parameters
    ----------
    lam : float
        L1 penalty strength.
    max_iter : int
    tol : float or None
        RMSE of the change of θ below which the fit stops; None runs
        ``max_iter`` sweeps.
    """

    def __init__(self, lam: float = 0.1, max_iter: int = 100, tol: float = 1e-6):
        self.__lam = lam
        self.max_iter = max_iter
        self.tol = tol
        self.__theta = None
        self.n_iter = None

    @property
    def lam(self) -> float:
        return self.__lam

    @lam.setter
    def lam(self, arg: float):
        self.__lam = arg

    @property
    def coef_(self) -> Optional[DNDarray]:
        return None if self.__theta is None else self.__theta[1:]

    @property
    def intercept_(self) -> Optional[DNDarray]:
        return None if self.__theta is None else self.__theta[0]

    @property
    def theta(self):
        return self.__theta

    @staticmethod
    def _row_blocks(x: DNDarray, y: DNDarray) -> Tuple[List[torch.Tensor], List[torch.Tensor], object]:
        """x's and y's float32 rows per shard and the sum over shards (one
        ``allreduce``) when x is split along the samples over more than one
        shard; else one block each and no collective."""
        comm = x.comm
        if x.split != 0 or comm.size == 1:
            X = x.larray.to(torch.float32)
            return [X], [y.larray.to(device=X.device, dtype=torch.float32).reshape(-1)], lambda parts: parts[0]
        xs = [s.to(torch.float32) for s in x.lshards]
        if y.split == 0 and sanitation.same_mesh(y.comm, comm):
            ys = [s.to(torch.float32).reshape(-1) for s in y.lshards]
        else:
            # this process's ranks' rows of y (every rank's on one process)
            counts, displs = comm.local_counts_displs(x.gshape, 0)
            yl = y.larray.reshape(-1)
            ys = [yl.narrow(0, d, c).to(device=s.device, dtype=torch.float32) for s, c, d in zip(xs, counts, displs)]
        return xs, ys, lambda parts: comm.allreduce(parts)[0]

    def fit(self, x: DNDarray, y: DNDarray) -> "Lasso":
        """Coordinate-descent fit (reference lasso.py:90-141)."""
        if not isinstance(x, DNDarray) or not isinstance(y, DNDarray):
            raise TypeError("x and y must be DNDarrays")
        if x.ndim != 2:
            raise ValueError(f"x needs to be 2D, but was {x.ndim}D")
        if y.ndim > 2:
            raise ValueError(f"y needs to be 1D or 2D, but was {y.ndim}D")
        n, m = x.shape
        xs, ys, reduce = self._row_blocks(x, y)
        lam = float(self.__lam)
        theta = xs[0].new_zeros((m, 1))
        if m * m <= GRAM_MAX_ELEMENTS and n >= m:
            G = reduce([xb.T @ xb for xb in xs])
            cy = reduce([xb.T @ yb for xb, yb in zip(xs, ys)])
            sweep = lambda th: _sweep_gram(G, cy, th, lam, n)
        else:
            XT = [xb.T.contiguous() for xb in xs]
            del xs
            sweep = lambda th: _sweep_residual(XT, ys, th, lam, n, reduce)
        for it in range(self.max_iter):
            theta_old = theta
            theta = sweep(theta)
            # the RMSE stop (reference lasso.py:166-171): one host read
            if self.tol is not None and float(torch.sqrt(torch.mean((theta - theta_old) ** 2))) < self.tol:
                break
        self.n_iter = it + 1
        self.__theta = _wrap(theta, None, x.device, x.comm)
        return self

    def predict(self, x: DNDarray) -> DNDarray:
        """Linear prediction with the learned θ (reference lasso.py:142-176)."""
        if self.__theta is None:
            raise RuntimeError("fit needs to be called before predict")
        X = x.larray.to(torch.float32)
        return _wrap(X @ self.__theta.larray.to(X.device), x.split, x.device, x.comm)
