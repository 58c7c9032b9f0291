"""Functional NN interface (counterpart of heat_tpu/nn/functional.py).

As the reference's ``func_getattr`` forwards to ``torch.nn.functional``
(reference nn/functional.py:1-20), so does the port's:
``heat_tpu_torch.nn.functional.relu``, ``...softmax``, ``...one_hot``.
"""

from __future__ import annotations

import torch.nn.functional as _F

__all__ = ["func_getattr"]


def func_getattr(name: str):
    """Forward ``name`` to ``torch.nn.functional``."""
    try:
        return getattr(_F, name)
    except AttributeError:
        raise AttributeError(f"module 'heat_tpu_torch.nn.functional' has no attribute {name!r}")


def __getattr__(name: str):
    return func_getattr(name)
