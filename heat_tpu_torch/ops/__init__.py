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
from .pairwise import pairwise_distance

__all__ = ["flash", "lloyd", "pairwise", "flash_attention_kernel", "pairwise_distance"]
