"""Reference network definitions (counterpart of heat_tpu/nn/models.py):
the pre-norm transformer block and the decoder-only language model.

``MLP``, ``SimpleCNN`` and the ResNets are not ported yet (ROADMAP queue
A9). The models run float32; a ``dtype`` other than float32 raises
``NotImplementedError``.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn.functional as F
from torch import nn

from . import _init
from .attention import MultiHeadAttention

__all__ = ["TransformerBlock", "TransformerLM"]


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
        _init.check_dtype(dtype)
        device = _init.torch_device(device)
        generator = _init.generator(generator, device)
        self.norm1 = _init.layer_norm(dim, device)
        self.attn = MultiHeadAttention(
            heads, dim, qkv_features=dim, causal=causal, attention_fn=attention_fn,
            device=device, generator=generator,
        )
        self.norm2 = _init.layer_norm(dim, device)
        self.fc1 = _init.dense(dim, mlp_ratio * dim, device, generator)
        self.fc2 = _init.dense(mlp_ratio * dim, dim, device, generator)

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
        _init.check_dtype(dtype)
        self.max_len = max_len
        device = _init.torch_device(device)
        generator = _init.generator(generator, device)
        self.embed = _init.embed(vocab, dim, device, generator)
        self.pos_embed = _init.embed(max_len, dim, device, generator)
        self.blocks = nn.ModuleList(
            TransformerBlock(
                dim, heads=heads, causal=causal, attention_fn=attention_fn,
                device=device, generator=generator,
            )
            for _ in range(depth)
        )
        self.norm = _init.layer_norm(dim, device)
        self.head = _init.dense(dim, vocab, device, generator)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:  # tokens: [batch, seq] int
        seq = tokens.shape[1]
        if seq > self.max_len:
            raise ValueError(f"sequence length {seq} exceeds max_len {self.max_len}")
        x = self.embed(tokens) + self.pos_embed(torch.arange(seq, device=tokens.device))[None]
        for block in self.blocks:
            x = block(x)
        return self.head(self.norm(x))
