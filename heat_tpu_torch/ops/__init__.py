"""Hand-written CUDA kernels and their wrappers (counterpart of heat_tpu/ops).

- :mod:`~heat_tpu_torch.ops.flash` — flash-attention forward with causal
  tile skipping (consumed by ``nn.attention`` with ``impl="pallas"``).
- :mod:`~heat_tpu_torch.ops.lloyd` — single-pass fused Lloyd iteration for
  k-means.
"""

from . import flash, lloyd
from .flash import flash_attention_kernel

__all__ = ["flash", "lloyd", "flash_attention_kernel"]
