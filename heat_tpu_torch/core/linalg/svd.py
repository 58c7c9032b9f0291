"""SVD, least squares and the pseudo-inverse (heat_tpu/core/linalg/svd.py),
built on the distributed QR: a tall operand's TSQR or panel QR reduces it to
an (n, n) core, whose SVD is one replicated ``torch.linalg.svd``, and the
tall factor is ``Q U_core``, a split-preserving matmul; ``lstsq`` is the same
QR and one triangular solve.
"""

from __future__ import annotations

import collections
from typing import Optional

import torch

from ..dndarray import DNDarray
from ..sanitation import sanitize_in
from . import basics
from .qr import qr
from .solver import solve_triangular

__all__ = ["svd", "lstsq", "pinv"]

SVD = collections.namedtuple("SVD", "U, S, Vh")


def svd(a: DNDarray, full_matrices: bool = True, compute_uv: bool = True):
    """Singular value decomposition ``a = U diag(S) Vh`` (heat_tpu/core/linalg/svd.py:36).

    ``full_matrices=True``, numpy's default, is computed for a replicated
    operand only; a split operand raises ``NotImplementedError`` there,
    since its distributed construction gives the reduced form. Reduced form:
    a split-0 tall operand gives a split-0 U and replicated S and Vh, a
    split-1 wide one the mirror image. Without ``compute_uv`` only S."""
    sanitize_in(a)
    if a.ndim != 2:
        raise ValueError(f"svd requires a 2-D operand, got {a.ndim}-D")
    if full_matrices and compute_uv:
        if a.split is not None:
            raise NotImplementedError(
                "full_matrices=True (the numpy-compatible default) is only "
                "supported for replicated operands; a split operand's "
                "distributed construction produces the reduced form — pass "
                "full_matrices=False explicitly"
            )
        u, s, vh = torch.linalg.svd(a.larray.to(basics._float_for(a)), full_matrices=True)
        return SVD(*(basics._wrap_like(t, None, a) for t in (u, s, vh)))
    m, n = a.gshape
    if m < n:
        # wide: the tall transpose, factors swapped
        res = svd(basics.transpose(a), full_matrices=False, compute_uv=compute_uv)
        if not compute_uv:
            return res
        return SVD(basics.transpose(res.Vh), res.S, basics.transpose(res.U))
    q, r = qr(a)
    u_r, s, vh = torch.linalg.svd(r.larray, full_matrices=False)
    s_arr = basics._wrap_like(s, None, a)
    if not compute_uv:
        return s_arr
    u = basics.matmul(q, basics._wrap_like(u_r, None, a))  # keeps Q's split
    return SVD(u, s_arr, basics._wrap_like(vh, None, a))


def lstsq(a: DNDarray, b: DNDarray, rcond: Optional[float] = None) -> DNDarray:
    """Least-squares solution of ``a x = b`` for a full-rank tall ``a``
    (heat_tpu/core/linalg/svd.py:89): ``x = R⁻¹ Qᵀ b``. ``rcond`` is
    accepted as None only (full rank assumed)."""
    sanitize_in(a)
    sanitize_in(b)
    if a.ndim != 2:
        raise ValueError(f"lstsq requires a 2-D coefficient matrix, got {a.ndim}-D")
    if rcond is not None:
        raise NotImplementedError("rcond cutoffs are not supported (full rank assumed)")
    m, n = a.gshape
    if m < n:
        raise ValueError(f"lstsq requires m >= n, got shape {(m, n)}")
    if b.ndim not in (1, 2) or b.gshape[0] != m:
        raise ValueError(f"b must have leading dimension {m}, got {tuple(b.gshape)}")
    q, r = qr(a)
    rhs = basics.matmul(basics.transpose(q), b)
    if b.ndim == 1:
        return solve_triangular(r, rhs.reshape((n, 1)), lower=False).reshape((n,))
    return solve_triangular(r, rhs, lower=False)


def pinv(a: DNDarray, rcond: float = 1e-15) -> DNDarray:
    """Moore–Penrose pseudo-inverse from :func:`svd` (heat_tpu/core/linalg/svd.py:119):
    singular values below ``rcond max(S)`` give 0 in the reciprocal. A
    split-0 tall operand gives a split-1 (n, m) result."""
    sanitize_in(a)
    if a.ndim != 2:
        raise ValueError(f"pinv requires a 2-D operand, got {a.ndim}-D")
    u, s, vh = svd(a, full_matrices=False)
    sl = s.larray
    keep = sl > rcond * sl.max()
    s_inv = basics._wrap_like(torch.where(keep, 1.0 / torch.where(keep, sl, 1.0), 0.0), None, a)
    # A⁺ = V S⁺ Uᵀ: Vh's rows scaled, then one split-preserving matmul
    return basics.matmul(basics.transpose(vh) * s_inv, basics.transpose(u))
