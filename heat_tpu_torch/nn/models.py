"""Reference network definitions (counterpart of heat_tpu/nn/models.py):
the multilayer perceptron, the small CNN, the CIFAR-style ResNets, the
pre-norm transformer block and the decoder-only language model.

The CNNs take NHWC images, as flax's do, and run their convolutions on the
NCHW view ``x.permute(0, 3, 1, 2)``, whose strides are channels-last: no
copy. ``forward(x, train=...)`` of a model with BatchNorm selects batch
statistics (``train=True``, which update the running averages) or the
running averages.

``dtype`` is flax's: float32 or bfloat16, the type a model computes in.
Its parameters stay float32; its Dense, Conv and Embed layers cast their
inputs and parameters to ``dtype``; its norms take their statistics in
float32 (:mod:`._init`). The heads of ``ResNet`` and ``TransformerLM``
compute in float32, as in flax; ``MLP`` and ``SimpleCNN`` return
``dtype``. Another dtype raises ``NotImplementedError``.
"""

from __future__ import annotations

from functools import partial
from typing import Callable, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from . import _init
from .attention import MultiHeadAttention

__all__ = [
    "MLP",
    "SimpleCNN",
    "BasicBlock",
    "Bottleneck",
    "ResNet",
    "ResNet18",
    "ResNet50",
    "TransformerBlock",
    "TransformerLM",
]


def _setup(dtype, device, generator):
    _init.check_dtype(dtype)
    device = _init.torch_device(device)
    return device, _init.generator(generator, device)


def _nchw(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """The NCHW view of an NHWC batch cast to ``dtype``."""
    return x.to(dtype).permute(0, 3, 1, 2)


class MLP(nn.Module):
    """Multilayer perceptron: the input flattened per sample, Dense layers
    of ``features`` with ReLU between them. ``in_features`` None draws the
    first layer at the first input (flax infers the width the same way)."""

    def __init__(
        self,
        features: Sequence[int] = (128, 10),
        dtype: torch.dtype = torch.float32,
        *,
        in_features: Optional[int] = None,
        device=None,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        device, generator = _setup(dtype, device, generator)
        self.dtype = dtype
        first = (
            _init.LazyDense(features[0], device, generator, dtype)
            if in_features is None
            else _init.dense(in_features, features[0], device, generator, dtype)
        )
        rest = [_init.dense(a, b, device, generator, dtype) for a, b in zip(features[:-1], features[1:])]
        self.layers = nn.ModuleList([first] + rest)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.reshape(x.shape[0], -1).to(self.dtype)
        for layer in self.layers[:-1]:
            x = F.relu(layer(x))
        return self.layers[-1](x)


class SimpleCNN(nn.Module):
    """Two 3x3 convolutions (32, 64; SAME), a 2x2 max-pool, the NHWC feature
    map flattened, Dense 128 and Dense ``num_classes`` (the reference's MNIST
    net). A 3-d input gains a channel axis. ``flat_features``, the width of
    the flattened map (64·⌊H/2⌋·⌊W/2⌋), None draws the first Dense at the
    first input."""

    def __init__(
        self,
        num_classes: int = 10,
        dtype: torch.dtype = torch.float32,
        *,
        in_channels: int = 1,
        flat_features: Optional[int] = None,
        device=None,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        device, generator = _setup(dtype, device, generator)
        self.dtype = dtype
        self.conv1 = _init.conv(in_channels, 32, 3, device=device, gen=generator, dtype=dtype)
        self.conv2 = _init.conv(32, 64, 3, device=device, gen=generator, dtype=dtype)
        self.fc1 = (
            _init.LazyDense(128, device, generator, dtype)
            if flat_features is None
            else _init.dense(flat_features, 128, device, generator, dtype)
        )
        self.fc2 = _init.dense(128, num_classes, device, generator, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.dim() == 3:
            x = x[..., None]
        x = F.relu(self.conv1(_nchw(x, self.dtype)))
        x = F.max_pool2d(F.relu(self.conv2(x)), 2)
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)  # flatten as NHWC
        return self.fc2(F.relu(self.fc1(x)))


def _pair_stride(strides) -> int:
    s = tuple(strides) if isinstance(strides, (tuple, list)) else (strides, strides)
    if s[0] != s[1]:
        raise NotImplementedError(f"unequal strides {s}")
    return int(s[0])


class _ResidualBlock(nn.Module):
    """The convolutions ``convs`` with a BatchNorm after each (ReLU between,
    the last norm starting at scale 0), plus a 1x1 projection of the input
    with its norm where the output's shape differs from the input's."""

    expansion = 1

    def __init__(self, convs, in_channels: int, filters: int, stride: int, dtype, device, generator):
        super().__init__()
        out = filters * self.expansion
        self.convs = nn.ModuleList(convs)
        self.norms = nn.ModuleList(
            _init.BatchNorm(c.out_channels, device, zero_scale=i == len(convs) - 1)
            for i, c in enumerate(convs)
        )
        self.proj = self.proj_norm = None
        if in_channels != out or stride != 1:
            self.proj = _init.conv(in_channels, out, 1, stride, bias=False, device=device, gen=generator,
                                   dtype=dtype)
            self.proj_norm = _init.BatchNorm(out, device)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        y = x
        last = len(self.convs) - 1
        for i, (conv, norm) in enumerate(zip(self.convs, self.norms)):
            y = norm(conv(y), train)
            if i < last:
                y = F.relu(y)
        residual = x if self.proj is None else self.proj_norm(self.proj(x), train)
        return F.relu(y + residual)


class BasicBlock(_ResidualBlock):
    """3x3 + 3x3 residual block (ResNet-18/34) on NCHW tensors."""

    def __init__(self, filters: int, strides=(1, 1), dtype: torch.dtype = torch.float32, *,
                 in_channels: int, device=None, generator: Optional[torch.Generator] = None):
        device, generator = _setup(dtype, device, generator)
        s = _pair_stride(strides)
        conv = partial(_init.conv, bias=False, device=device, gen=generator, dtype=dtype)
        convs = [conv(in_channels, filters, 3, s, padding=1), conv(filters, filters, 3, padding=1)]
        super().__init__(convs, in_channels, filters, s, dtype, device, generator)


class Bottleneck(_ResidualBlock):
    """1x1 - 3x3 - 1x1 bottleneck block (ResNet-50/101/152) on NCHW
    tensors; the output has 4·filters channels."""

    expansion = 4

    def __init__(self, filters: int, strides=(1, 1), dtype: torch.dtype = torch.float32, *,
                 in_channels: int, device=None, generator: Optional[torch.Generator] = None):
        device, generator = _setup(dtype, device, generator)
        s = _pair_stride(strides)
        conv = partial(_init.conv, bias=False, device=device, gen=generator, dtype=dtype)
        convs = [
            conv(in_channels, filters, 1),
            conv(filters, filters, 3, s, padding=1),
            conv(filters, 4 * filters, 1),
        ]
        super().__init__(convs, in_channels, filters, s, dtype, device, generator)


class ResNet(nn.Module):
    """CIFAR-style ResNet on NHWC images: a 3x3 stem (no max-pool),
    ``stage_sizes`` blocks per stage with ``num_filters·2^i`` filters, the
    first block of each later stage at stride 2, a global mean and a float32
    Dense head."""

    def __init__(
        self,
        stage_sizes: Sequence[int],
        block=BasicBlock,
        num_classes: int = 10,
        num_filters: int = 64,
        dtype: torch.dtype = torch.float32,
        *,
        in_channels: int = 3,
        device=None,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        device, generator = _setup(dtype, device, generator)
        self.dtype = dtype
        self.stem = _init.conv(in_channels, num_filters, 3, padding=1, bias=False,
                               device=device, gen=generator, dtype=dtype)
        self.stem_norm = _init.BatchNorm(num_filters, device)
        blocks, channels = [], num_filters
        for i, size in enumerate(stage_sizes):
            for j in range(size):
                strides = (2, 2) if i > 0 and j == 0 else (1, 1)
                blocks.append(block(num_filters * 2**i, strides, dtype, in_channels=channels,
                                    device=device, generator=generator))
                channels = num_filters * 2**i * block.expansion
        self.blocks = nn.ModuleList(blocks)
        self.head = _init.dense(channels, num_classes, device, generator, torch.float32)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        x = F.relu(self.stem_norm(self.stem(_nchw(x, self.dtype)), train))
        for block in self.blocks:
            x = block(x, train)
        return self.head(x.mean(dim=(2, 3)))


def ResNet18(num_classes: int = 10, dtype: torch.dtype = torch.float32, **kwargs) -> ResNet:
    return ResNet((2, 2, 2, 2), BasicBlock, num_classes=num_classes, dtype=dtype, **kwargs)


def ResNet50(num_classes: int = 10, dtype: torch.dtype = torch.float32, **kwargs) -> ResNet:
    return ResNet((3, 4, 6, 3), Bottleneck, num_classes=num_classes, dtype=dtype, **kwargs)


class TransformerBlock(nn.Module):
    """Pre-norm transformer block (attention + MLP, residual both).

    The attention callable is injected (``attention_fn``, default dense), so
    the same module runs the dense oracle or the CUDA kernel
    (``functools.partial(flash_attention, impl="pallas")``).
    """

    def __init__(
        self,
        dim: int,
        heads: int = 4,
        mlp_ratio: int = 4,
        causal: bool = True,
        dtype: torch.dtype = torch.float32,
        attention_fn: Optional[Callable] = None,
        *,
        device=None,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        device, generator = _setup(dtype, device, generator)
        self.norm1 = _init.layer_norm(dim, device)
        self.attn = MultiHeadAttention(
            heads, dim, qkv_features=dim, causal=causal, dtype=dtype, attention_fn=attention_fn,
            device=device, generator=generator,
        )
        self.norm2 = _init.layer_norm(dim, device)
        self.fc1 = _init.dense(dim, mlp_ratio * dim, device, generator, dtype)
        self.fc2 = _init.dense(mlp_ratio * dim, dim, device, generator, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # x: [batch, seq, dim]
        x = x + self.attn(self.norm1(x))
        h = F.gelu(self.fc1(self.norm2(x)), approximate="tanh")  # flax's gelu
        return x + self.fc2(h)


class TransformerLM(nn.Module):
    """Decoder-only language model: token and position embeddings, ``depth``
    blocks, a final LayerNorm and a float32 head to ``vocab`` logits.

    Parameters are initialized as flax initializes them, from ``generator``
    (None: a generator on the device seeded with 0), on ``device`` (None:
    the default device, the GPU unless the caller asked for the CPU).
    """

    def __init__(
        self,
        vocab: int = 256,
        dim: int = 128,
        depth: int = 2,
        heads: int = 4,
        max_len: int = 2048,
        causal: bool = True,
        dtype: torch.dtype = torch.float32,
        attention_fn: Optional[Callable] = None,
        *,
        device=None,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        self.max_len = max_len
        device, generator = _setup(dtype, device, generator)
        self.embed = _init.embed(vocab, dim, device, generator, dtype)
        self.pos_embed = _init.embed(max_len, dim, device, generator, dtype)
        self.blocks = nn.ModuleList(
            TransformerBlock(
                dim, heads=heads, causal=causal, dtype=dtype, attention_fn=attention_fn,
                device=device, generator=generator,
            )
            for _ in range(depth)
        )
        self.norm = _init.layer_norm(dim, device)
        self.head = _init.dense(dim, vocab, device, generator, torch.float32)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:  # tokens: [batch, seq] int
        seq = tokens.shape[1]
        if seq > self.max_len:
            raise ValueError(f"sequence length {seq} exceeds max_len {self.max_len}")
        x = self.embed(tokens) + self.pos_embed(torch.arange(seq, device=tokens.device))[None]
        for block in self.blocks:
            x = block(x)
        return self.head(self.norm(x))
