"""Hand-written CUDA kernels and their wrappers (counterpart of heat_tpu/ops)."""

from . import lloyd
