"""Attention: dense, blockwise (flash-style), the hand-written kernel, and
the sequence-parallel ring and Ulysses schedules (counterpart of
heat_tpu/nn/attention.py).

* :func:`dot_product_attention` — dense softmax attention, the oracle.
* :func:`flash_attention` — blockwise online-softmax attention: a loop over
  key tiles (``impl="scan"``), or the CUDA kernel of
  :mod:`heat_tpu_torch.ops.flash` (``impl="pallas"``, the name the JAX
  package gives its hand-written kernel, kept so callers port unchanged).
* :func:`ring_attention` — sequence parallelism over a mesh: the sequence
  is cut into one block per shard, each shard keeps its Q block while the
  K/V blocks rotate around the ring by ``MeshCommunication.ppermute``, and
  each visiting block is folded into the shard's online-softmax state.
  Attention memory per shard is O(S/p) keys at a time.
* :func:`ulysses_attention` — two ``MeshCommunication.alltoall`` exchanges
  turn sequence shards into head shards and back around local attention.
* :class:`MultiHeadAttention` — projections around a pluggable backend.

The schedules run on the verbs of the mesh: on a one-process mesh they are
torch operations, which autograd differentiates as it does any torch code;
over a mesh whose ranks span processes each process runs its own ranks'
blocks, and the verbs' autograd functions (``communication.permute``,
``all_to_all``, ``take_blocks``, ``join_blocks``) carry the gradients
across, equal bit for bit to the one-process mesh's.

All functions take [batch, seq, heads, head_dim] tensors and accumulate the
softmax in float32 whatever the input dtype.
"""

from __future__ import annotations

import math
from functools import partial
from typing import Callable, List, Optional

import torch
from torch import nn

from ..core import communication
from ..core.communication import MeshCommunication, sanitize_comm
from ..ops import flash as _flash
from . import _init

__all__ = [
    "dot_product_attention",
    "flash_attention",
    "ring_attention",
    "ulysses_attention",
    "MultiHeadAttention",
]


def _acc_dtype(dtype: torch.dtype) -> torch.dtype:
    """float32 accumulation, widened to float64 only if the inputs already are."""
    return torch.promote_types(dtype, torch.float32)


def _causal_keep(q_idx0: int, sq: int, k_idx0: int, sk: int, device) -> torch.Tensor:
    """[1, sq, 1, sk] mask, True where query q_idx0+i may see key k_idx0+j."""
    q_ids = q_idx0 + torch.arange(sq, device=device)
    k_ids = k_idx0 + torch.arange(sk, device=device)
    return (q_ids[:, None] >= k_ids[None, :])[None, :, None, :]


def dot_product_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = False,
    scale: Optional[float] = None,
    mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Dense softmax attention (the oracle the other paths are tested against).

    Parameters
    ----------
    q, k, v : torch.Tensor
        [batch, seq, heads, head_dim] (k/v may have a different seq length).
    causal : bool
        Lower-triangular masking (query i attends to keys ≤ i).
    scale : float, optional
        Score scale; default ``1/sqrt(head_dim)``.
    mask : torch.Tensor, optional
        Boolean, broadcastable to [batch, q_len, heads, k_len]; True = keep.
    """
    acc = _acc_dtype(q.dtype)
    scale = _flash.score_scale(scale, q.shape[-1])
    s = torch.einsum("bqhd,bkhd->bqhk", q, k).to(acc) * scale
    if causal:
        s = s.masked_fill(~_causal_keep(0, q.shape[1], 0, k.shape[1], s.device), -math.inf)
    if mask is not None:
        s = s.masked_fill(~mask, -math.inf)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bqhk,bkhd->bqhd", p.to(v.dtype), v)


def _tile_update(q, k_blk, v_blk, m, l, o, q_idx0, k_idx0, causal, scale):
    """Fold one K/V tile into the online-softmax state (m, l, o).

    m: [B, sq, H] running max (f32); l: [B, sq, H] running sum; o: [B, sq, H, D]
    unnormalized output. q_idx0/k_idx0 are the global sequence offsets of the
    tiles, so causal masking is correct wherever the tile sits.
    """
    acc = m.dtype
    s = torch.einsum("bqhd,bkhd->bqhk", q, k_blk).to(acc) * scale
    if causal:
        keep = _causal_keep(q_idx0, q.shape[1], k_idx0, k_blk.shape[1], s.device)
        s = s.masked_fill(~keep, -math.inf)
    m_new = torch.maximum(m, s.amax(dim=-1))
    # A fully masked history has m_new = -inf; shift by 0 there so exp() is 0,
    # not NaN (the final division is guarded the same way).
    m_safe = torch.where(torch.isneginf(m_new), torch.zeros((), dtype=acc, device=m.device), m_new)
    p = torch.exp(s - m_safe[..., None])
    alpha = torch.exp(m - m_safe)  # m = -inf -> 0: no prior mass
    l_new = alpha * l + p.sum(dim=-1)
    o_new = alpha[..., None] * o + torch.einsum("bqhk,bkhd->bqhd", p, v_blk.to(acc))
    return m_new, l_new, o_new


def _finalize(l, o, dtype):
    denom = torch.where(l > 0, l, torch.ones((), dtype=l.dtype, device=l.device))
    return (o / denom[..., None]).to(dtype)


BACKWARD_RANGE = "flash_attention backward (scan)"
"""The profiler range around :class:`_FlashPallasDiff`'s backward."""


class _FlashPallasDiff(torch.autograd.Function):
    """The kernel's forward with the gradient of the scan path: the backward
    recomputes :func:`flash_attention` ``impl="scan"`` from the saved inputs,
    the same O(seq) memory class as the forward (counterpart of
    ``_flash_pallas_diff``)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale):
        ctx.save_for_backward(q, k, v)
        ctx.causal, ctx.scale = causal, scale
        return _flash.flash_attention_kernel(q, k, v, causal=causal, scale=scale)

    @staticmethod
    def backward(ctx, g):
        inputs = [t.detach().requires_grad_() for t in ctx.saved_tensors]
        # a named range, so that a profile of a training step can tell the
        # scan path's recompute and backward from the rest of the step
        with torch.profiler.record_function(BACKWARD_RANGE), torch.enable_grad():
            out = flash_attention(*inputs, causal=ctx.causal, scale=ctx.scale, impl="scan")
            grads = torch.autograd.grad(out, inputs, g)
        return (*grads, None, None)


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = False,
    scale: Optional[float] = None,
    block_size: int = 512,
    impl: str = "auto",
) -> torch.Tensor:
    """Blockwise online-softmax attention (flash-style).

    Memory is O(q_len·heads·head_dim) instead of O(q_len·k_len·heads).

    ``impl`` selects the backend:

    * ``'scan'`` — a loop over key tiles of ``block_size``; runs everywhere,
      differentiable by autograd.
    * ``'pallas'`` — the hand-written CUDA kernel
      (:func:`heat_tpu_torch.ops.flash.flash_attention_kernel`) for CUDA
      tensors, its plain version for CPU tensors; the kernel skips the
      key tiles past the diagonal when causal. Differentiable: the backward
      re-runs the scan path. ``block_size`` does not apply; the kernel picks
      its own tiles.
    * ``'auto'`` — ``'scan'``, as in the JAX package.
    """
    if impl not in ("auto", "scan", "pallas"):
        raise ValueError(f"unknown flash impl {impl!r}")
    if impl == "pallas":
        return _FlashPallasDiff.apply(q, k, v, causal, scale)
    acc = _acc_dtype(q.dtype)
    scale = _flash.score_scale(scale, q.shape[-1])
    B, sq, H, D = q.shape
    sk = k.shape[1]
    m = torch.full((B, sq, H), -math.inf, dtype=acc, device=q.device)
    l = torch.zeros((B, sq, H), dtype=acc, device=q.device)
    o = torch.zeros((B, sq, H, D), dtype=acc, device=q.device)
    # the last tile is ragged: its keys are simply absent, where the JAX
    # package pads them and masks them out
    for k0 in range(0, sk, block_size):
        k1 = min(k0 + block_size, sk)
        m, l, o = _tile_update(q, k[:, k0:k1], v[:, k0:k1], m, l, o, 0, k0, causal, scale)
    return _finalize(l, o, q.dtype)


def _seq_sizes(S: int, comm: MeshCommunication) -> List[int]:
    """One equal block of the sequence per shard (both schedules require S
    divisible by the mesh size)."""
    return [S // comm.size] * comm.size


def _split_seq(x: torch.Tensor, comm: MeshCommunication) -> List[torch.Tensor]:
    """x's sequence (dim 1) cut into one equal block per shard of ``comm``:
    this process's ranks' blocks, each on its shard's device (every process
    holds x whole; across processes the gradient's blocks are gathered back
    in the backward, ``communication.take_blocks``)."""
    return communication.take_blocks(comm, x, _seq_sizes(x.shape[1], comm), 1,
                                     list(zip(comm.local_ranks, comm.local_devices)), range(comm.size))


def _gather_seq(shards: List[torch.Tensor], comm: MeshCommunication, device: torch.device) -> torch.Tensor:
    """This process's ranks' blocks joined along the sequence into the whole
    value on ``device``, in every process (``communication.join_blocks``)."""
    S = sum(s.shape[1] for s in shards) * comm.size // len(shards)
    return communication.join_blocks(comm, shards, comm.local_ranks, _seq_sizes(S, comm), 1, range(comm.size),
                                     device)


def ring_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = False,
    scale: Optional[float] = None,
    comm: Optional[MeshCommunication] = None,
) -> torch.Tensor:
    """Ring-parallel attention over the mesh's sequence axis.

    q, k and v are [B, S, H, D]; S is cut into ``comm.size`` blocks, block r
    on shard r. Each shard keeps its Q block while the K/V blocks rotate
    around the ring (``ppermute``, shard j sends to j − 1: the reference's
    systolic cdist schedule), folding one block per step into its
    online-softmax state with the block's global offset for the causal
    mask. Returns the output blocks concatenated along S on q's device, in
    q's dtype (the state is float32).
    """
    comm = sanitize_comm(comm)
    S = q.shape[1]
    if S % comm.size:
        raise ValueError(f"ring_attention requires seq {S} divisible by mesh size {comm.size}")
    scale = _flash.score_scale(scale, q.shape[-1])
    out = _ring_shards(*(_split_seq(t, comm) for t in (q, k, v)), causal, scale, comm)
    return _gather_seq(out, comm, q.device)


def _ring_shards(qs, ks, vs, causal: bool, scale: float, comm: MeshCommunication) -> List[torch.Tensor]:
    """The ring on sequence shards: one output block per shard of this
    process, on its device."""
    p = comm.size
    B, sq, H, D = qs[0].shape
    acc = _acc_dtype(qs[0].dtype)
    state = [
        (
            torch.full((B, sq, H), -math.inf, dtype=acc, device=d),
            torch.zeros((B, sq, H), dtype=acc, device=d),
            torch.zeros((B, sq, H, D), dtype=acc, device=d),
        )
        for d in comm.local_devices
    ]
    perm = [(j, (j - 1) % p) for j in range(p)]
    for i in range(p):
        # shard r holds the K/V block of shard (r + i) % p
        state = [
            _tile_update(qs[j], ks[j], vs[j], *state[j], r * sq, ((r + i) % p) * sq, causal, scale)
            for j, r in enumerate(comm.local_ranks)
        ]
        if i < p - 1:  # p - 1 rotations: the last block's is never issued
            ks, vs = communication.permute(comm, ks, perm), communication.permute(comm, vs, perm)
    return [_finalize(l, o, qs[0].dtype) for _, l, o in state]


def ulysses_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = False,
    scale: Optional[float] = None,
    comm: Optional[MeshCommunication] = None,
    block_size: int = 0,
) -> torch.Tensor:
    """All-to-all (Ulysses) sequence-parallel attention.

    The sequence blocks [B, S/p, H, D] of the mesh's shards become head
    groups [B, S, H/p, D] through one ``alltoall`` each for q, k and v;
    every shard runs full-sequence attention on its heads, dense or, with
    ``block_size > 0``, the blockwise :func:`flash_attention` (O(S) memory);
    one ``alltoall`` switches the output back. Requires heads and seq
    divisible by the mesh size. Returns [B, S, H, D] on q's device.
    """
    comm = sanitize_comm(comm)
    p = comm.size
    H = q.shape[2]
    if H % p:
        raise ValueError(f"ulysses_attention requires heads {H} divisible by mesh size {p}")
    if q.shape[1] % p:
        raise ValueError(f"seq {q.shape[1]} not divisible by mesh size {p}")
    scale = _flash.score_scale(scale, q.shape[-1])
    local = partial(flash_attention, block_size=block_size) if block_size else dot_product_attention
    # [B, S/p, H, D] -> [B, S, H/p, D]: split heads, gather sequence
    qh, kh, vh = (communication.all_to_all(comm, _split_seq(t, comm), 2, 1) for t in (q, k, v))
    oh = [local(a, b, c, causal=causal, scale=scale) for a, b, c in zip(qh, kh, vh)]
    return _gather_seq(communication.all_to_all(comm, oh, 1, 2), comm, q.device)


_BACKENDS = {
    "dense": dot_product_attention,
    "flash": flash_attention,
    "ring": ring_attention,
    "ulysses": ulysses_attention,
}


def _resolve_backend(name: str) -> Callable:
    try:
        return _BACKENDS[name]
    except KeyError:
        raise ValueError(f"unknown attention backend {name!r}; one of {sorted(_BACKENDS)}")


class MultiHeadAttention(nn.Module):
    """Multi-head self-attention with a pluggable backend.

    ``backend`` selects among 'dense', 'flash', 'ring', 'ulysses';
    ``attention_fn``, a callable ``(q, k, v, causal=...) -> out``, overrides
    it; ``forward(x, comm)`` hands ``comm`` to the ring and Ulysses
    backends. The q, k and v projections map ``in_features`` to (heads,
    head_dim) with a bias (flax's DenseGeneral), the out projection maps
    them back, each computing in ``dtype`` (None: the input's type promoted
    with the float32 parameters).
    flax infers ``in_features`` from the first input; a torch module takes it
    up front. Parameters are initialized as flax does (lecun-normal kernels,
    zero biases) from ``generator``, on ``device`` (None: the default
    device, the GPU unless the caller asked for the CPU).
    """

    def __init__(
        self,
        num_heads: int,
        in_features: int,
        qkv_features: Optional[int] = None,
        causal: bool = False,
        backend: str = "dense",
        dtype: Optional[torch.dtype] = None,
        attention_fn: Optional[Callable] = None,
        *,
        device=None,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        _init.check_dtype(dtype)
        features = qkv_features or in_features
        if features % num_heads:
            raise ValueError("qkv_features must be divisible by num_heads")
        self.num_heads = num_heads
        self.head_dim = features // num_heads
        self.causal = causal
        self.backend = backend
        self.attention_fn = attention_fn
        device = _init.torch_device(device)
        generator = _init.generator(generator, device)
        self.query = _init.dense(in_features, features, device, generator, dtype)
        self.key = _init.dense(in_features, features, device, generator, dtype)
        self.value = _init.dense(in_features, features, device, generator, dtype)
        self.out = _init.dense(features, in_features, device, generator, dtype)

    def forward(self, x: torch.Tensor, comm=None) -> torch.Tensor:
        heads = (self.num_heads, self.head_dim)
        q = self.query(x).unflatten(-1, heads)
        k = self.key(x).unflatten(-1, heads)
        v = self.value(x).unflatten(-1, heads)
        kwargs = {"causal": self.causal}
        if self.attention_fn is not None:
            attn = self.attention_fn  # comm, scale etc. bound by the caller
        else:
            attn = _resolve_backend(self.backend)
            if self.backend in ("ring", "ulysses"):
                kwargs["comm"] = comm
        o = attn(q, k, v, **kwargs)
        return self.out(o.flatten(-2))
