"""Flash-attention forward: the wrapper of the CUDA kernel ``csrc/flash.cu``
and its plain PyTorch version.

The kernel replaces heat_tpu/ops/flash.py::_attn_kernel. It takes q
[B, S, H, D] and k, v [B, SK, H, D] where they lie, with their row
strides, and writes the output as [B, S, H, D]: the TPU kernel's
transpose to [B·H, S, D] and its padding to 128 lanes and to whole tiles
have no use on the GPU. The kernel picks its own tiles from D, so the TPU
tile arguments ``block_q`` and ``block_k`` are not carried over.

It is bound by operations: 4·B·H·S·SK·D flops, half of that when causal,
against the bytes of q, k, v and the output read or written once. The
kernel has two designs, chosen by D alone (:func:`kernel_design`): for
D ≤ 128 the tensor cores, float32 products as three TF32 products of split
operands (:func:`tf32_split`) on wgmma and bfloat16 products in bfloat16 on
mma.sync; for 128 < D ≤ 512 the CUDA cores in float32.

:func:`flash_attention_kernel` launches the kernel for CUDA tensors and
runs :func:`flash_attention_plain` for CPU tensors; it never falls back
from one to the other. ``LAUNCHES`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from . import _build

__all__ = [
    "LAUNCHES",
    "attention_kernel_supported",
    "flash_attention_kernel",
    "flash_attention_plain",
    "kernel_design",
    "tf32_split",
]

MAX_HEAD_DIM = 512
MMA_MAX_HEAD_DIM = 128
"""The largest D of the tensor-core design (``csrc/flash.cu``'s dispatch)."""
NEG_INF = -1e30
"""The masked score. It is finite, so a row with no live key has the
finite max -1e30, which the zeroing guard (p = 0 while the max is at most
-1e30/2) turns into an output of 0 instead of NaN (heat_tpu/ops/flash.py:39)."""

LAUNCHES = 0
"""Launches of the CUDA kernel in this process; only the launch adds to it."""

PLAIN_ROWS = 1024
"""Query rows per block of the plain version, so that it never holds more
than B·H·PLAIN_ROWS·SK scores."""


def attention_kernel_supported(seq_len: int, head_dim: int) -> bool:
    """CUDA present and the head fits the kernel: ``head_dim ≤ 512``. The
    sequence length does not limit the kernel (counterpart of
    ``pallas_attention_supported``)."""
    return torch.cuda.is_available() and 1 <= head_dim <= MAX_HEAD_DIM


def kernel_design(head_dim: int, dtype: torch.dtype) -> str:
    """The design of ``csrc/flash.cu`` that a launch with this head dim and
    input dtype runs, as the kernel's dispatch chooses it by D alone:
    ``"wgmma_3xtf32"`` (tensor cores through wgmma, float32 as three TF32
    products; every dtype but bfloat16 is computed in float32),
    ``"mma_bf16"`` (tensor cores through mma.sync, bfloat16 operands) up to
    D = 128, ``"cuda_cores"`` (float32 FMA) above it."""
    if not 1 <= head_dim <= MAX_HEAD_DIM:
        raise ValueError(f"head_dim {head_dim} outside the kernel's 1 <= D <= {MAX_HEAD_DIM}")
    if head_dim > MMA_MAX_HEAD_DIM:
        return "cuda_cores"
    return "mma_bf16" if _compute_dtype(dtype) == torch.bfloat16 else "wgmma_3xtf32"


def tf32_split(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``x`` (float32) as ``big + small``, the operands of the kernel's
    three-term TF32 products: ``big`` is x rounded to 10 mantissa bits, to
    nearest with ties away from zero (``cvt.rna.tf32.f32``), and ``small``
    is ``x - big`` (exact in float32) rounded the same way, so
    ``|big + small - x| <= 2^-22 |x|``. Infinities and NaNs are their own
    ``big``."""
    if x.dtype != torch.float32:
        raise TypeError(f"tf32_split takes float32, got {x.dtype}")

    def rna(t: torch.Tensor) -> torch.Tensor:
        bits = t.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
        rounded = (bits + 0x1000) & 0xFFFFE000  # half of the 13 dropped bits, then drop them
        rounded = torch.where(rounded >= 2**31, rounded - 2**32, rounded)
        return torch.where(torch.isfinite(t), rounded.to(torch.int32).view(torch.float32), t)

    big = rna(x)
    return big, rna(x - big)


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if q.ndim != 4 or k.ndim != 4 or k.shape != v.shape:
        raise ValueError(
            f"need q [B, S, H, D] and k, v of one shape [B, SK, H, D], got "
            f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}"
        )
    B, _, H, D = q.shape
    if (k.shape[0], k.shape[2], k.shape[3]) != (B, H, D):
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} differ in B, H or D")
    if not 1 <= D <= MAX_HEAD_DIM:
        raise ValueError(f"head_dim {D} outside the kernel's 1 <= D <= {MAX_HEAD_DIM}")
    for t in (q, k, v):
        if not t.is_floating_point():
            raise TypeError(f"attention needs floating-point inputs, got {t.dtype}")
    if not q.device == k.device == v.device:
        raise ValueError(f"q, k, v on {q.device}, {k.device}, {v.device}")


def _compute_dtype(dtype: torch.dtype) -> torch.dtype:
    """bfloat16 stays bfloat16 on both products; every other float is
    computed in float32 (heat_tpu/ops/flash.py:91)."""
    return torch.bfloat16 if dtype == torch.bfloat16 else torch.float32


def flash_attention_kernel(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = False,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Attention forward on [B, S, H, D] inputs (k, v may have another
    sequence length), the counterpart of ``flash_attention_tpu``.

    The scale (default ``1/sqrt(D)``) is folded into q in float32 before the
    first product; k and v are cast to q's compute dtype; the output has
    q's dtype. A CUDA tensor goes to the kernel, a CPU tensor to
    :func:`flash_attention_plain`; another device raises.
    """
    _check(q, k, v)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"no attention kernel for device {q.device}")
    return _launch(q, k, v, causal, scale)


def _library():
    lib = _build.library("flash")
    if not getattr(lib, "_typed", False):
        lib.flash_attention.argtypes = (
            [ctypes.c_void_p] * 4
            + [ctypes.c_int] * 5
            + [ctypes.c_longlong] * 9
            + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        )
        lib.flash_attention.restype = ctypes.c_int
        lib._typed = True
    return lib


def _operand(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``x`` in the compute dtype with a contiguous last dimension; no copy
    when it already is one."""
    x = x.to(dtype)
    return x if x.stride(-1) == 1 else x.contiguous()


def _launch(q, k, v, causal: bool, scale: Optional[float]) -> torch.Tensor:
    global LAUNCHES
    lib = _library()
    B, S, H, D = q.shape
    sk = k.shape[1]
    cd = _compute_dtype(q.dtype)
    qc, kc, vc = (_operand(t, cd) for t in (q, k, v))
    out = torch.empty((B, S, H, D), dtype=cd, device=q.device)
    if out.numel():
        strides = [s for t in (qc, kc, vc) for s in t.stride()[:3]]
        with torch.cuda.device(q.device):
            err = lib.flash_attention(
                qc.data_ptr(), kc.data_ptr(), vc.data_ptr(), out.data_ptr(),
                B, H, S, sk, D, *strides,
                score_scale(scale, D), int(bool(causal)), int(cd == torch.bfloat16),
                torch.cuda.current_stream(q.device).cuda_stream,
            )
        if err:
            raise RuntimeError(f"attention kernel launch failed: CUDA error {err}")
        LAUNCHES += 1
    return out if q.dtype == cd else out.to(q.dtype)


def score_scale(scale: Optional[float], head_dim: int) -> float:
    """The score scale: ``scale``, or ``1/sqrt(head_dim)`` when it is None."""
    return 1.0 / math.sqrt(head_dim) if scale is None else float(scale)


def flash_attention_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = False,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """The plain PyTorch version of :func:`flash_attention_kernel`: the
    kernel's numerics (scale folded into q, bfloat16 rounding of q and of p
    before p·V, the -1e30 mask, fully masked rows as 0) with one softmax
    over all keys instead of a tiled one. Any device."""
    _check(q, k, v)
    B, S, H, D = q.shape
    sk = k.shape[1]
    cd = _compute_dtype(q.dtype)
    qs = (q.float() * score_scale(scale, D)).to(cd).float()
    ks, vs = (t.to(cd).float() for t in (k, v))
    out = torch.zeros((B, S, H, D), dtype=torch.float32, device=q.device)
    k_ids = torch.arange(sk, device=q.device)
    for r0 in range(0, S if sk else 0, PLAIN_ROWS):
        r1 = min(r0 + PLAIN_ROWS, S)
        s = torch.einsum("bqhd,bkhd->bhqk", qs[:, r0:r1], ks)
        if causal:
            q_ids = torch.arange(r0, r1, device=q.device)
            s = s.masked_fill(q_ids[:, None] < k_ids[None, :], NEG_INF)
        m = s.amax(dim=-1, keepdim=True)
        p = torch.where(m > NEG_INF / 2, torch.exp(s - m), 0.0)
        l = p.sum(dim=-1, keepdim=True)
        if cd == torch.bfloat16:
            p = p.bfloat16().float()
        o = torch.einsum("bhqk,bkhd->bhqd", p, vs) / torch.where(l > 0, l, 1.0)
        out[:, r0:r1] = o.transpose(1, 2)
    return out.to(q.dtype)
