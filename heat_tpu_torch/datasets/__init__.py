"""Bundled and seeded datasets (reference: heat/datasets/,
heat_tpu/datasets/__init__.py).

* The real bundled files, the Fisher iris measurements (``iris.csv`` with
  ``;`` separators, ``iris.h5``, classic-netCDF3 ``iris.nc``, the labels in
  ``iris_labels.csv``) and the standardized diabetes data (``diabetes.h5``),
  are read in place from the JAX package's data directory,
  ``heat_tpu/datasets/data/``, as plain files: :func:`path`,
  :func:`load_iris`, :func:`load_diabetes`.
* :func:`iris_like` and :func:`diabetes_like` draw the same numpy values as
  heat_tpu's, bit for bit; :func:`materialize` writes them out for I/O
  exercises.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Optional

import numpy as np

from ..core import factories

__all__ = ["diabetes_like", "iris_like", "load_diabetes", "load_iris", "materialize", "path"]

_DATA_DIR = Path(__file__).resolve().parents[2] / "heat_tpu" / "datasets" / "data"


def path(name: str) -> str:
    """Absolute path of a bundled dataset file (``iris.csv``, ``iris.h5``,
    ``iris.nc``, ``iris_labels.csv``, ``diabetes.h5``)."""
    p = _DATA_DIR / name
    if not p.exists():
        available = sorted(os.listdir(_DATA_DIR)) if _DATA_DIR.is_dir() else []
        raise FileNotFoundError(f"no bundled dataset {name!r}; available: {available}")
    return str(p)


def load_iris(split: Optional[int] = None, return_labels: bool = False):
    """The Fisher iris data (150, 4) float32 from ``iris.csv``, and with
    ``return_labels`` its int32 labels, split along the samples when the
    data is (reference heat_tpu/datasets/__init__.py:51-63)."""
    from ..core import io

    data = io.load_csv(path("iris.csv"), sep=";", split=split)
    if not return_labels:
        return data
    y = np.loadtxt(path("iris_labels.csv"), dtype=np.int64)
    return data, factories.array(y.astype(np.int32), split=0 if split == 0 else None)


def load_diabetes(split: Optional[int] = None, return_y: bool = False):
    """The diabetes regression data (442, 11) float32 from ``diabetes.h5``
    (an intercept column included), and with ``return_y`` its targets
    (reference heat_tpu/datasets/__init__.py:66-77)."""
    from ..core import io

    x = io.load_hdf5(path("diabetes.h5"), "x", split=split)
    if not return_y:
        return x
    return x, io.load_hdf5(path("diabetes.h5"), "y", split=0 if split == 0 else None)

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


def materialize(directory: str) -> dict:
    """Write the seeded datasets as ``iris.csv``, ``iris.h5`` and
    ``diabetes.h5`` under ``directory`` (the HDF5 files where h5py imports)
    and return their paths (reference heat_tpu/datasets/__init__.py:114-133)."""
    from ..core import io

    os.makedirs(directory, exist_ok=True)
    paths = {}
    iris = iris_like()
    paths["iris.csv"] = os.path.join(directory, "iris.csv")
    io.save_csv(iris, paths["iris.csv"])
    if io.supports_hdf5():
        paths["iris.h5"] = os.path.join(directory, "iris.h5")
        io.save_hdf5(iris, paths["iris.h5"], "data")
        paths["diabetes.h5"] = os.path.join(directory, "diabetes.h5")
        io.save_hdf5(diabetes_like(), paths["diabetes.h5"], "x")
    return paths
