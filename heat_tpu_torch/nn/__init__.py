"""Neural network stack (counterpart of heat_tpu/nn).

The JAX package re-exports ``flax.linen`` and adds its own modules; the port
re-exports ``torch.nn`` the same way: ``heat_tpu_torch.nn.Linear``,
``heat_tpu_torch.nn.GELU``... resolve to ``torch.nn``, while the attention
functions, ``MultiHeadAttention``, ``DataParallel``/``DataParallelMultiGPU``
and the models are the port's own, under the JAX package's names. The ring
and Ulysses backends are not ported yet (ROADMAP queue A9b).
"""

from torch import nn as _torch_nn

from . import attention, functional, models
from .attention import (
    MultiHeadAttention,
    dot_product_attention,
    flash_attention,
    ring_attention,
    ulysses_attention,
)
from .data_parallel import DataParallel, DataParallelMultiGPU
from .models import (
    MLP,
    ResNet,
    ResNet18,
    ResNet50,
    SimpleCNN,
    TransformerBlock,
    TransformerLM,
)

__all__ = [
    "DataParallel",
    "DataParallelMultiGPU",
    "MLP",
    "SimpleCNN",
    "ResNet",
    "ResNet18",
    "ResNet50",
    "TransformerBlock",
    "TransformerLM",
    "models",
    "attention",
    "functional",
    "MultiHeadAttention",
    "dot_product_attention",
    "flash_attention",
    "ring_attention",
    "ulysses_attention",
]


def __getattr__(name):
    # dynamic fallback to the backing NN library, as heat_tpu.nn falls back
    # to flax.linen
    try:
        return getattr(_torch_nn, name)
    except AttributeError:
        raise AttributeError(f"module 'heat_tpu_torch.nn' has no attribute {name!r}")
