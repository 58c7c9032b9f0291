"""Layers built as flax builds them: the parameter initializers of
``flax.linen`` (lecun-normal Dense kernels, zero biases, Embed
variance-scaling(1, fan_in, normal), LayerNorm scale 1 and bias 0,
epsilon 1e-6), drawn from an explicit ``torch.Generator`` on the module's
device."""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn
from torch.nn.utils import skip_init

from ..core import devices

TRUNC_STD = 0.87962566103423978
"""Standard deviation of a standard normal truncated to (-2, 2): lecun-normal
divides by it, so the truncated draw keeps the variance 1/fan_in."""


def check_dtype(dtype) -> None:
    """float32 is the ported dtype; flax's bfloat16 cast rules are not."""
    if dtype not in (None, torch.float32):
        raise NotImplementedError(
            f"dtype {dtype} is not ported: heat_tpu_torch.nn runs float32 "
            "(bfloat16 models are ROADMAP queue A9)"
        )


def torch_device(device) -> torch.device:
    """The torch device of a device spec; None is the default device, the
    GPU, which raises without CUDA unless the caller asked for the CPU."""
    return devices.sanitize_device(device).torch_devices()[0]


def generator(gen: Optional[torch.Generator], device: torch.device) -> torch.Generator:
    """``gen``, or a generator on ``device`` seeded with 0."""
    return gen if gen is not None else torch.Generator(device=device).manual_seed(0)


def dense(in_features: int, out_features: int, device, gen: torch.Generator) -> nn.Linear:
    """A Dense layer, ``x @ kernel + bias``: ``nn.Linear`` holds the kernel
    transposed, as (out, in). Kernel lecun-normal (fan_in = in), bias 0."""
    layer = skip_init(nn.Linear, in_features, out_features, device=device)
    std = math.sqrt(1.0 / in_features) / TRUNC_STD
    with torch.no_grad():
        nn.init.trunc_normal_(layer.weight, 0.0, std, -2.0 * std, 2.0 * std, generator=gen)
        layer.bias.zero_()
    return layer


def embed(num_embeddings: int, features: int, device, gen: torch.Generator) -> nn.Embedding:
    """An Embed table, normal with variance 1/features."""
    layer = skip_init(nn.Embedding, num_embeddings, features, device=device)
    with torch.no_grad():
        layer.weight.normal_(0.0, math.sqrt(1.0 / features), generator=gen)
    return layer


def layer_norm(features: int, device) -> nn.LayerNorm:
    """flax's LayerNorm: epsilon 1e-6, scale 1, bias 0."""
    return nn.LayerNorm(features, eps=1e-6, device=device)
