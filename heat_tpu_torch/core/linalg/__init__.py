"""Linear algebra (reference: heat/core/linalg). Only ``transpose`` is
ported so far; matmul, QR, the solvers and SVD are queue A7."""

from .basics import *
