"""Optimizers (counterpart of heat_tpu/optim).

The JAX package shims optax under torch-style names; the port gives the
same names with optax's arguments and rules (:mod:`.optimizers`), each
returning a factory that a trainer binds to its parameters. Other names
fall back to ``torch.optim``. ``DASO``, ``DataParallelOptimizer`` and
``DetectMetricPlateau`` are the port's own.
"""

import torch.optim as _torch_optim

from . import optimizers, utils
from .dp_optimizer import DASO, DataParallelOptimizer
from .optimizers import LBFGS, SGD, Adadelta, Adagrad, Adam, AdamW, RMSprop
from .utils import DetectMetricPlateau

__all__ = [
    "DASO",
    "DataParallelOptimizer",
    "DetectMetricPlateau",
    "SGD",
    "Adam",
    "AdamW",
    "Adagrad",
    "RMSprop",
    "Adadelta",
    "LBFGS",
    "optimizers",
    "utils",
]


def __getattr__(name):
    # dynamic fallback to torch.optim, as heat_tpu.optim falls back to optax
    try:
        return getattr(_torch_optim, name)
    except AttributeError:
        raise AttributeError(f"module 'heat_tpu_torch.optim' has no attribute {name!r}")
