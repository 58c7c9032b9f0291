"""sklearn-compatible estimator bases (reference: heat/core/base.py:13-258)."""

from __future__ import annotations

import inspect
from typing import Dict, List

__all__ = [
    "BaseEstimator",
    "ClassificationMixin",
    "ClusteringMixin",
    "RegressionMixin",
    "TransformMixin",
    "is_classifier",
    "is_clusterer",
    "is_estimator",
    "is_regressor",
    "is_transformer",
]


class BaseEstimator:
    """Base for all estimators; parameter introspection via __init__ signature
    (reference base.py:13-97)."""

    @classmethod
    def _parameter_names(cls) -> List[str]:
        init = cls.__init__
        if init is object.__init__:
            return []
        sig = inspect.signature(init)
        return [
            name
            for name, p in sig.parameters.items()
            if name != "self" and p.kind not in (p.VAR_POSITIONAL, p.VAR_KEYWORD)
        ]

    def get_params(self, deep: bool = True) -> Dict:
        """Parameter dict of this estimator (reference base.py:29)."""
        params = {}
        for key in self._parameter_names():
            value = getattr(self, key, None)
            if deep and hasattr(value, "get_params"):
                for sub_key, sub_value in value.get_params().items():
                    params[f"{key}__{sub_key}"] = sub_value
            params[key] = value
        return params

    def set_params(self, **params) -> "BaseEstimator":
        """Set estimator parameters, supporting nested `a__b` keys (reference base.py:62)."""
        if not params:
            return self
        valid = self.get_params(deep=True)
        nested = {}
        for key, value in params.items():
            key, delim, sub_key = key.partition("__")
            if key not in valid:
                raise ValueError(f"Invalid parameter {key} for estimator {self}")
            if delim:
                nested.setdefault(key, {})[sub_key] = value
            else:
                setattr(self, key, value)
                valid[key] = value
        for key, sub_params in nested.items():
            valid[key].set_params(**sub_params)
        return self

    def __repr__(self, indent: int = 1) -> str:
        return f"{self.__class__.__name__}({self.get_params(deep=False)})"


class ClassificationMixin:
    """Mixin for classifiers (reference base.py:98-144)."""

    def fit(self, x, y):
        raise NotImplementedError()

    def fit_predict(self, x, y):
        self.fit(x, y)
        return self.predict(x)

    def predict(self, x):
        raise NotImplementedError()


class TransformMixin:
    """Mixin for transformers (reference base.py)."""

    def fit(self, x):
        raise NotImplementedError()

    def fit_transform(self, x):
        return self.fit(x).transform(x)

    def transform(self, x):
        raise NotImplementedError()


class ClusteringMixin:
    """Mixin for clusterers (reference base.py:145-175)."""

    def fit(self, x):
        raise NotImplementedError()

    def fit_predict(self, x):
        self.fit(x)
        return self.predict(x)


class RegressionMixin:
    """Mixin for regressors (reference base.py:176-220)."""

    def fit(self, x, y):
        raise NotImplementedError()

    def fit_predict(self, x, y):
        self.fit(x, y)
        return self.predict(x)

    def predict(self, x):
        raise NotImplementedError()


def is_classifier(estimator) -> bool:
    """True for a classifier (reference base.py:221)."""
    return isinstance(estimator, ClassificationMixin)


def is_estimator(estimator) -> bool:
    """True for an estimator (reference base.py:230)."""
    return isinstance(estimator, BaseEstimator)


def is_regressor(estimator) -> bool:
    """True for a regressor (reference base.py:248)."""
    return isinstance(estimator, RegressionMixin)


def is_transformer(estimator) -> bool:
    """True for a transformer (reference base.py:239)."""
    return isinstance(estimator, TransformMixin)


def is_clusterer(estimator) -> bool:
    """True for a clusterer (reference base.py:245)."""
    return isinstance(estimator, ClusteringMixin)
