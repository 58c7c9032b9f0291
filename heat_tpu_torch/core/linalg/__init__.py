"""Distributed linear algebra (reference: heat/core/linalg,
heat_tpu/core/linalg): matmul over every split, the distributed QR
(CholeskyQR2, TSQR, panel QR), the blocked triangular solve, Cholesky and
determinant, the solvers and the QR-based SVD."""

from .basics import *
from .qr import *
from .solver import *
from .svd import *
