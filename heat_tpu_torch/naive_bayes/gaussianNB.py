"""Gaussian naive Bayes (reference: heat/naive_bayes/gaussianNB.py,
heat_tpu/naive_bayes/gaussianNB.py).

``partial_fit`` merges each batch's per-class moments into the running ones
with the Chan/Golub/LeVeque formulas; variances are population variances
(ddof 0), weighted ones ``jnp.average``'s. Classification is the joint
log-likelihood per class, normalized with logsumexp. ``theta_``, ``var_``,
``class_count_``, ``class_prior_`` and ``classes_`` are torch tensors, as
heat_tpu keeps them as jax arrays.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from ..core.base import BaseEstimator, ClassificationMixin
from ..core.dndarray import DNDarray, _wrap

__all__ = ["GaussianNB"]


def _tensor(obj, device: torch.device) -> torch.Tensor:
    """A DNDarray's logical tensor, or an array-like as a tensor, on ``device``."""
    if isinstance(obj, DNDarray):
        return obj.larray.to(device)
    return torch.as_tensor(obj, device=device)


class GaussianNB(ClassificationMixin, BaseEstimator):
    """Gaussian naive Bayes classifier (reference gaussianNB.py:17-130).

    Parameters
    ----------
    priors : DNDarray, optional
        Class priors; inferred from data if None.
    var_smoothing : float
        Ridge added to variances for stability, times the largest feature
        variance of the batch.
    """

    def __init__(self, priors: Optional[DNDarray] = None, var_smoothing: float = 1e-9):
        self.priors = priors
        self.var_smoothing = var_smoothing
        self.classes_ = None
        self.theta_ = None
        self.var_ = None
        self.class_count_ = None
        self.class_prior_ = None
        self.epsilon_ = None

    @property
    def sigma_(self):
        """Per-class feature variances, the reference's name for ``var_``
        (reference gaussianNB.py:38)."""
        return self.var_

    @staticmethod
    def _update_mean_variance(n_past, mu, var, X, sample_weight=None):
        """Chan/Golub/LeVeque incremental moment merge, weighted when
        ``sample_weight`` is given (reference gaussianNB.py:200-260)."""
        if X.shape[0] == 0:
            return n_past, mu, var
        if sample_weight is not None:
            w = sample_weight.to(X.dtype)
            w_sum = torch.sum(w)
            n_new = float(w_sum)
            if n_new == 0:
                return n_past, mu, var
            new_mu = torch.sum(X * w[:, None], dim=0) / w_sum
            new_var = torch.sum((X - new_mu) ** 2 * w[:, None], dim=0) / w_sum
        else:
            n_new = X.shape[0]
            new_var, new_mu = torch.var_mean(X, dim=0, correction=0)
        if n_past == 0:
            return n_new, new_mu, new_var
        n_total = n_past + n_new
        total_mu = (n_new * new_mu + n_past * mu) / n_total
        old_ssd = n_past * var
        new_ssd = n_new * new_var
        total_ssd = old_ssd + new_ssd + (n_new * n_past / n_total) * (mu - new_mu) ** 2
        return n_total, total_mu, total_ssd / n_total

    def fit(self, x: DNDarray, y: DNDarray, sample_weight=None) -> "GaussianNB":
        """Fit from scratch (reference gaussianNB.py:131-160)."""
        self.classes_ = None
        self.theta_ = None
        return self.partial_fit(x, y, classes=None, sample_weight=sample_weight)

    def partial_fit(
        self, x: DNDarray, y: DNDarray, classes: Optional[DNDarray] = None, sample_weight=None
    ) -> "GaussianNB":
        """Incremental fit on a batch (reference gaussianNB.py:161-199)."""
        if not isinstance(x, DNDarray) or not isinstance(y, DNDarray):
            raise ValueError("x and y must be DNDarrays")
        if x.ndim != 2:
            raise ValueError(f"expected x to be 2D, got {x.ndim}D")
        xl = x.larray.to(torch.float32)
        yl = y.larray.reshape(-1).to(xl.device)
        if xl.shape[0] != yl.shape[0]:
            raise ValueError(
                f"y.shape[0] must match number of samples {xl.shape[0]}, got {yl.shape[0]}"
            )

        first_call = self.theta_ is None
        if first_call:
            cls = _tensor(classes, xl.device) if classes is not None else torch.unique(yl)
            self.classes_ = cls
            shape = (cls.shape[0], xl.shape[1])
            self.theta_ = xl.new_zeros(shape)
            self.var_ = xl.new_zeros(shape)
            self.class_count_ = xl.new_zeros((cls.shape[0],))
        cls = self.classes_

        # the variance ridge tracks the data scale (reference gaussianNB.py:166-171)
        self.epsilon_ = self.var_smoothing * float(torch.var(xl, dim=0, correction=0).max())
        if not first_call:
            self.var_ = self.var_ - self.epsilon_

        sw = None if sample_weight is None else _tensor(sample_weight, xl.device).reshape(-1)
        theta, var, counts = [], [], []
        for i in range(cls.shape[0]):
            mask = yl == cls[i]
            n_i, mu, v = self._update_mean_variance(
                float(self.class_count_[i]), self.theta_[i], self.var_[i], xl[mask],
                sample_weight=None if sw is None else sw[mask],
            )
            theta.append(mu)
            var.append(v)
            counts.append(float(n_i))
        self.theta_ = torch.stack(theta)
        self.var_ = torch.stack(var) + self.epsilon_
        self.class_count_ = torch.tensor(counts, dtype=torch.float32, device=xl.device)

        if self.priors is not None:
            priors = _tensor(self.priors, xl.device)
            if priors.shape[0] != cls.shape[0]:
                raise ValueError("Number of priors must match number of classes.")
            if abs(float(torch.sum(priors)) - 1.0) > 1e-6:
                raise ValueError("The sum of the priors should be 1.")
            if bool(torch.any(priors < 0)):
                raise ValueError("Priors must be non-negative.")
            self.class_prior_ = priors
        else:
            self.class_prior_ = self.class_count_ / torch.sum(self.class_count_)
        return self

    def _joint_log_likelihood(self, xl: torch.Tensor) -> torch.Tensor:
        """(n, classes) joint log likelihood (reference gaussianNB.py:391-430)."""
        jll = []
        for i in range(self.classes_.shape[0]):
            prior = torch.log(self.class_prior_[i])
            n_ij = -0.5 * torch.sum(torch.log(2.0 * math.pi * self.var_[i]))
            n_ij = n_ij - 0.5 * torch.sum(((xl - self.theta_[i]) ** 2) / self.var_[i], dim=1)
            jll.append(prior + n_ij)
        return torch.stack(jll, dim=1)

    def _features(self, x: DNDarray) -> torch.Tensor:
        self._check_is_fitted()
        return x.larray.to(device=self.theta_.device, dtype=torch.float32)

    def predict(self, x: DNDarray) -> DNDarray:
        """Most probable class per sample (reference gaussianNB.py:431-450)."""
        jll = self._joint_log_likelihood(self._features(x))
        return _wrap(self.classes_[torch.argmax(jll, dim=1)], x.split, x.device, x.comm)

    def predict_log_proba(self, x: DNDarray) -> DNDarray:
        """Normalized log probabilities via logsumexp (reference gaussianNB.py:451-479)."""
        jll = self._joint_log_likelihood(self._features(x))
        return _wrap(jll - torch.logsumexp(jll, dim=1, keepdim=True), x.split, x.device, x.comm)

    def predict_proba(self, x: DNDarray) -> DNDarray:
        """Class probabilities (reference gaussianNB.py:480-500)."""
        lp = self.predict_log_proba(x)
        return _wrap(torch.exp(lp.larray), lp.split, lp.device, lp.comm)

    def _check_is_fitted(self):
        if self.theta_ is None:
            raise RuntimeError("fit needs to be called before predict")
