"""heat_tpu_torch — the PyTorch/CUDA port of heat_tpu.

The same distributed n-dimensional array with a single ``split`` axis and
the same estimators, on torch tensors, with the kernels hand-written in CUDA
for NVIDIA Hopper. Arrays live on the GPU unless the caller asks for the CPU
(``use_device("cpu")``). The JAX package ``heat_tpu`` is the reference it is
tested against.
"""

from .core import *
from .core import random
from . import cluster, nn, ops, spatial, utils
from .core import base, communication, constants, devices, factories, sanitation, stride_tricks, types
