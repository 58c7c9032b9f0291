"""Layers built as flax builds them: the parameter initializers of
``flax.linen`` (lecun-normal Dense and Conv kernels, zero biases, Embed
variance-scaling(1, fan_in, normal), LayerNorm scale 1 and bias 0,
epsilon 1e-6), drawn from an explicit ``torch.Generator`` on the module's
device, flax's LayerNorm and BatchNorm, and flax's cast rules for a
model's ``dtype``.

The cast rules (flax's ``dtype``/``param_dtype``): parameters stay
float32; a :class:`Dense`, :class:`Conv` or :class:`Embed` casts its input
and its parameters to its ``compute_dtype``, the model's ``dtype``, and
computes in it; :class:`LayerNorm` and :class:`BatchNorm` take their
statistics and normalize in float32 and return their input's dtype, which
inside a model is the model's ``dtype``.
"""

from __future__ import annotations

import functools
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


MODEL_DTYPES = (torch.float32, torch.bfloat16)


def check_dtype(dtype) -> None:
    """A model computes in float32 or bfloat16 (None: its inputs' type)."""
    if dtype is not None and dtype not in MODEL_DTYPES:
        raise NotImplementedError(
            f"dtype {dtype} is not ported: heat_tpu_torch.nn computes in float32 or bfloat16"
        )


def promote(dtype: Optional[torch.dtype], *tensors):
    """flax's ``promote_dtype``: the tensors cast to ``dtype`` or, for None,
    to their promoted type; a None entry (an absent bias) stays None."""
    if dtype is None:
        dtype = functools.reduce(torch.promote_types, (t.dtype for t in tensors if t is not None))
    return [None if t is None else t.to(dtype) for t in tensors]


def torch_device(device) -> torch.device:
    """The torch device of a device spec; None is the default device, the
    GPU, which raises without CUDA unless the caller asked for the CPU."""
    return devices.sanitize_device(device).torch_devices()[0]


def generator(gen: Optional[torch.Generator], device: torch.device) -> torch.Generator:
    """``gen``, or a generator on ``device`` seeded with 0."""
    return gen if gen is not None else torch.Generator(device=device).manual_seed(0)


def lecun_normal_(tensor: torch.Tensor, fan_in: int, gen: torch.Generator) -> torch.Tensor:
    """Fill ``tensor`` lecun-normal: variance 1/fan_in, truncated at two
    standard deviations."""
    std = math.sqrt(1.0 / fan_in) / TRUNC_STD
    with torch.no_grad():
        return nn.init.trunc_normal_(tensor, 0.0, std, -2.0 * std, 2.0 * std, generator=gen)


def _lecun_normal(layer: nn.Module, fan_in: int, gen: torch.Generator) -> None:
    """Kernel lecun-normal; bias 0."""
    lecun_normal_(layer.weight, fan_in, gen)
    if layer.bias is not None:
        with torch.no_grad():
            layer.bias.zero_()


def _dense_forward(layer: nn.Linear, x: torch.Tensor) -> torch.Tensor:
    return F.linear(*promote(layer.compute_dtype, x, layer.weight, layer.bias))


class Dense(nn.Linear):
    """flax's Dense, ``x @ kernel + bias``, with input, kernel and bias cast
    to ``compute_dtype`` (None: their promoted type) and the product
    computed in it. ``nn.Linear`` holds the kernel transposed, as (out, in)."""

    compute_dtype: Optional[torch.dtype] = None
    forward = _dense_forward


def dense(in_features: int, out_features: int, device, gen: torch.Generator,
          dtype: Optional[torch.dtype] = None) -> Dense:
    """A :class:`Dense` computing in ``dtype``: kernel lecun-normal
    (fan_in = in), bias 0."""
    layer = skip_init(Dense, in_features, out_features, device=device)
    _lecun_normal(layer, in_features, gen)
    layer.compute_dtype = dtype
    return layer


class LazyDense(nn.LazyLinear):
    """A :class:`Dense` whose input width waits for its first input, as flax
    infers it; the kernel is drawn then, from ``generator``, and the layer
    becomes a :class:`Dense`."""

    cls_to_become = Dense
    forward = _dense_forward

    def __init__(self, out_features: int, device, gen: torch.Generator, dtype: Optional[torch.dtype] = None):
        super().__init__(out_features, device=device)
        self.generator = gen
        self.compute_dtype = dtype

    def reset_parameters(self) -> None:
        if not self.has_uninitialized_params() and self.in_features != 0:
            _lecun_normal(self, self.in_features, self.generator)
            self.generator = None


class Conv(nn.Conv2d):
    """flax's Conv on NCHW tensors, with input, kernel and bias cast to
    ``compute_dtype`` (None: their promoted type)."""

    compute_dtype: Optional[torch.dtype] = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self._conv_forward(*promote(self.compute_dtype, x, self.weight, self.bias))


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
    dtype: Optional[torch.dtype] = None,
) -> Conv:
    """A :class:`Conv` computing in ``dtype``: the kernel (kh, kw, in, out)
    held as (out, in, kh, kw), lecun-normal with fan_in = kh·kw·in, bias 0.
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
        Conv, in_channels, out_channels, kernel_size, stride=stride, padding=padding,
        bias=bias, device=device,
    )
    _lecun_normal(layer, in_channels * kernel_size * kernel_size, gen)
    layer.compute_dtype = dtype
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
    reduced over the mesh (:mod:`._lockstep`). The statistics, the
    normalization and the running averages are float32 whatever the
    input's type; the output comes back in the input's type (flax's rule
    for a bfloat16 model).
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
        dtype = x.dtype
        x = x.to(torch.promote_types(dtype, torch.float32))
        if not train:
            y = F.batch_norm(
                x, self.running_mean, self.running_var, self.weight, self.bias, False, 0.0, self.eps
            )
            return y.to(dtype)
        meeting = _lockstep.current()
        if meeting is not None:
            shape = (1, -1) + (1,) * (x.dim() - 2)
            y = meeting.normalize(self, x) * self.weight.view(shape) + self.bias.view(shape)
            return y.to(dtype)
        # torch's batch norm normalizes with the biased variance; at momentum
        # 1 it leaves the batch mean and unbiased variance in the buffers
        n = x.numel() // x.shape[1]
        mean, var = x.new_zeros(x.shape[1]), x.new_zeros(x.shape[1])
        y = F.batch_norm(x, mean, var, self.weight, self.bias, True, 1.0, self.eps)
        self.update_averages(mean, var * ((n - 1) / n))
        return y.to(dtype)

    @torch.no_grad()
    def update_averages(self, mean: torch.Tensor, var: torch.Tensor) -> None:
        """Fold one batch's mean and biased variance into the running averages."""
        m = self.momentum
        self.running_mean.mul_(m).add_(mean, alpha=1 - m)
        self.running_var.mul_(m).add_(var, alpha=1 - m)


class Embed(nn.Embedding):
    """flax's Embed: the rows gathered, then cast to ``compute_dtype``."""

    compute_dtype: Optional[torch.dtype] = None

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        return super().forward(ids).to(self.compute_dtype)


def embed(num_embeddings: int, features: int, device, gen: torch.Generator,
          dtype: torch.dtype = torch.float32) -> Embed:
    """An :class:`Embed` table, normal with variance 1/features, whose rows
    come out in ``dtype``."""
    layer = skip_init(Embed, num_embeddings, features, device=device)
    with torch.no_grad():
        layer.weight.normal_(0.0, math.sqrt(1.0 / features), generator=gen)
    layer.compute_dtype = dtype
    return layer


class LayerNorm(nn.LayerNorm):
    """flax's LayerNorm: the statistics and the normalization in float32,
    the output in the input's type."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.layer_norm(
            x.to(torch.promote_types(x.dtype, torch.float32)), self.normalized_shape,
            self.weight, self.bias, self.eps,
        )
        return y.to(x.dtype)


def layer_norm(features: int, device) -> LayerNorm:
    """flax's LayerNorm: epsilon 1e-6, scale 1, bias 0."""
    return LayerNorm(features, eps=1e-6, device=device)
