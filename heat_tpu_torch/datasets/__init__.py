"""Seeded stand-in datasets (reference: heat/datasets/,
heat_tpu/datasets/__init__.py:88-111).

:func:`iris_like` and :func:`diabetes_like` draw the same numpy values as
heat_tpu's, bit for bit, and wrap them as DNDarrays. The loaders of the real
bundled files (``load_iris``, ``load_diabetes``, ``path``) and
``materialize`` need the port of ``core/io.py`` and are not ported yet.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from ..core import factories

__all__ = ["iris_like", "diabetes_like"]

_IRIS_CENTERS = np.array(
    [
        [5.0, 3.4, 1.5, 0.25],
        [5.9, 2.8, 4.3, 1.3],
        [6.6, 3.0, 5.6, 2.0],
    ],
    dtype=np.float32,
)
_IRIS_STD = np.array([0.35, 0.35, 0.3, 0.2], dtype=np.float32)


def iris_like(split: Optional[int] = None, return_labels: bool = False):
    """A deterministic (150, 4) three-class dataset with iris-like cluster
    geometry, float32, labels int32 (heat_tpu/datasets/__init__.py:88-103)."""
    rng = np.random.default_rng(1234)
    xs, ys = [], []
    for i, c in enumerate(_IRIS_CENTERS):
        xs.append(rng.normal(c, _IRIS_STD, size=(50, 4)).astype(np.float32))
        ys.append(np.full(50, i, dtype=np.int32))
    data = factories.array(np.concatenate(xs), split=split)
    if return_labels:
        return data, factories.array(np.concatenate(ys), split=split)
    return data


def diabetes_like(split: Optional[int] = None):
    """A deterministic (442, 10) standardized float32 regression dataset
    (heat_tpu/datasets/__init__.py:106-111)."""
    rng = np.random.default_rng(5678)
    x = rng.standard_normal((442, 10)).astype(np.float32)
    x = (x - x.mean(0)) / x.std(0)
    return factories.array(x, split=split)
