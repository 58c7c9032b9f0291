"""Layers built as flax builds them: the parameter initializers of
``flax.linen`` (lecun-normal Dense and Conv kernels, zero biases, Embed
variance-scaling(1, fan_in, normal), LayerNorm scale 1 and bias 0,
epsilon 1e-6), drawn from an explicit ``torch.Generator`` on the module's
device, and flax's BatchNorm."""

from __future__ import annotations

import math
from typing import Optional, Union

import torch
import torch.nn.functional as F
from torch import nn
from torch.nn.utils import skip_init

from ..core import devices
from . import _lockstep

TRUNC_STD = 0.87962566103423978
"""Standard deviation of a standard normal truncated to (-2, 2): lecun-normal
divides by it, so the truncated draw keeps the variance 1/fan_in."""


def check_dtype(dtype) -> None:
    """float32 is the ported dtype; flax's bfloat16 cast rules are not."""
    if dtype not in (None, torch.float32):
        raise NotImplementedError(
            f"dtype {dtype} is not ported: heat_tpu_torch.nn runs float32 "
            "(bfloat16 models are ROADMAP queue A9b)"
        )


def torch_device(device) -> torch.device:
    """The torch device of a device spec; None is the default device, the
    GPU, which raises without CUDA unless the caller asked for the CPU."""
    return devices.sanitize_device(device).torch_devices()[0]


def generator(gen: Optional[torch.Generator], device: torch.device) -> torch.Generator:
    """``gen``, or a generator on ``device`` seeded with 0."""
    return gen if gen is not None else torch.Generator(device=device).manual_seed(0)


def _lecun_normal(layer: nn.Module, fan_in: int, gen: torch.Generator) -> None:
    """Kernel lecun-normal, truncated at two standard deviations; bias 0."""
    std = math.sqrt(1.0 / fan_in) / TRUNC_STD
    with torch.no_grad():
        nn.init.trunc_normal_(layer.weight, 0.0, std, -2.0 * std, 2.0 * std, generator=gen)
        if layer.bias is not None:
            layer.bias.zero_()


def dense(in_features: int, out_features: int, device, gen: torch.Generator) -> nn.Linear:
    """A Dense layer, ``x @ kernel + bias``: ``nn.Linear`` holds the kernel
    transposed, as (out, in). Kernel lecun-normal (fan_in = in), bias 0."""
    layer = skip_init(nn.Linear, in_features, out_features, device=device)
    _lecun_normal(layer, in_features, gen)
    return layer


class LazyDense(nn.LazyLinear):
    """A Dense layer whose input width waits for its first input, as flax
    infers it; the kernel is drawn then, from ``generator``. It becomes an
    ``nn.Linear`` once drawn."""

    def __init__(self, out_features: int, device, gen: torch.Generator):
        super().__init__(out_features, device=device)
        self.generator = gen

    def reset_parameters(self) -> None:
        if not self.has_uninitialized_params() and self.in_features != 0:
            _lecun_normal(self, self.in_features, self.generator)
            self.generator = None


def conv(
    in_channels: int,
    out_channels: int,
    kernel_size: int,
    stride: int = 1,
    padding: Union[int, str] = "SAME",
    bias: bool = True,
    *,
    device,
    gen: torch.Generator,
) -> nn.Conv2d:
    """flax's Conv on NCHW tensors: the kernel (kh, kw, in, out) held as
    (out, in, kh, kw), lecun-normal with fan_in = kh·kw·in, bias 0.
    ``padding`` is a count per side, or ``"SAME"``, flax's default, which
    pads k // 2 per side for an odd kernel at stride 1 and nothing for a
    1x1 kernel."""
    if padding == "SAME":
        if kernel_size % 2 == 0 or (stride != 1 and kernel_size != 1):
            raise NotImplementedError(
                f"SAME padding of a {kernel_size}x{kernel_size} kernel at stride {stride}"
            )
        padding = kernel_size // 2
    layer = skip_init(
        nn.Conv2d, in_channels, out_channels, kernel_size, stride=stride, padding=padding,
        bias=bias, device=device,
    )
    _lecun_normal(layer, in_channels * kernel_size * kernel_size, gen)
    return layer


class BatchNorm(nn.Module):
    """flax's BatchNorm over the channel axis (dim 1): momentum 0.99,
    epsilon 1e-5, scale 1 (0 with ``zero_scale``, as the last norm of a
    residual block starts) and bias 0.

    ``forward(x, train=False)`` normalizes with the running averages;
    ``train=True`` with the batch's mean and biased variance
    E[x²] − E[x]², which then enter the running averages,
    ``avg = 0.99·avg + 0.01·stat`` (torch's BatchNorm2d keeps momentum
    0.1 and the unbiased variance there). When ``DataParallel`` runs the
    shards of one batch in lockstep, the statistics are the whole batch's,
    reduced over the mesh (:mod:`._lockstep`).
    """

    momentum = 0.99
    eps = 1e-5

    def __init__(self, features: int, device, zero_scale: bool = False):
        super().__init__()
        fill = torch.zeros if zero_scale else torch.ones
        self.weight = nn.Parameter(fill(features, device=device))
        self.bias = nn.Parameter(torch.zeros(features, device=device))
        self.register_buffer("running_mean", torch.zeros(features, device=device))
        self.register_buffer("running_var", torch.ones(features, device=device))

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        if not train:
            return F.batch_norm(
                x, self.running_mean, self.running_var, self.weight, self.bias, False, 0.0, self.eps
            )
        meeting = _lockstep.current()
        if meeting is not None:
            shape = (1, -1) + (1,) * (x.dim() - 2)
            return meeting.normalize(self, x) * self.weight.view(shape) + self.bias.view(shape)
        # torch's batch norm normalizes with the biased variance; at momentum
        # 1 it leaves the batch mean and unbiased variance in the buffers
        n = x.numel() // x.shape[1]
        mean, var = x.new_zeros(x.shape[1]), x.new_zeros(x.shape[1])
        y = F.batch_norm(x, mean, var, self.weight, self.bias, True, 1.0, self.eps)
        self.update_averages(mean, var * ((n - 1) / n))
        return y

    @torch.no_grad()
    def update_averages(self, mean: torch.Tensor, var: torch.Tensor) -> None:
        """Fold one batch's mean and biased variance into the running averages."""
        m = self.momentum
        self.running_mean.mul_(m).add_(mean, alpha=1 - m)
        self.running_var.mul_(m).add_(var, alpha=1 - m)


def embed(num_embeddings: int, features: int, device, gen: torch.Generator) -> nn.Embedding:
    """An Embed table, normal with variance 1/features."""
    layer = skip_init(nn.Embedding, num_embeddings, features, device=device)
    with torch.no_grad():
        layer.weight.normal_(0.0, math.sqrt(1.0 / features), generator=gen)
    return layer


def layer_norm(features: int, device) -> nn.LayerNorm:
    """flax's LayerNorm: epsilon 1e-6, scale 1, bias 0."""
    return nn.LayerNorm(features, eps=1e-6, device=device)
