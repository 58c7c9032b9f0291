"""Hand-written CUDA kernels and their wrappers (counterpart of heat_tpu/ops).

- :mod:`~heat_tpu_torch.ops.flash` — flash-attention forward with causal
  tile skipping (consumed by ``nn.attention`` with ``impl="pallas"``).
- :mod:`~heat_tpu_torch.ops.lloyd` — single-pass fused Lloyd iteration for
  k-means.
- :mod:`~heat_tpu_torch.ops.pairwise` — exact L1/L2 distance matrix with
  the feature axis reduced in the tile (consumed by ``spatial.distance``).
"""

from . import flash, lloyd, pairwise
from .flash import flash_attention_kernel
from .lloyd import fused_lloyd_iter, fused_lloyd_iter_sharded, fused_lloyd_run
from .pairwise import pairwise_distance

__all__ = [
    "flash",
    "lloyd",
    "pairwise",
    "flash_attention_kernel",
    "fused_lloyd_iter",
    "fused_lloyd_iter_sharded",
    "fused_lloyd_run",
    "pairwise_distance",
]
