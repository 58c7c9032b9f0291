"""Solvers (reference: heat/core/linalg/solver.py,
heat_tpu/core/linalg/solver.py).

``solve_triangular`` on a split operand is the blocked substitution of the
reference (heat_tpu/core/linalg/solver.py:97-180): stage by stage the owner
of the diagonal tile solves it against its right-hand side, one
``allreduce`` of the solved block replicates it, and every shard folds the
tile column out of its right-hand side. ``cg`` and ``lanczos`` keep their
loops on the device: a converged ``cg`` iteration and a ``lanczos``
breakdown are masked with ``torch.where``, never tested on the host.
``solve`` is the panel QR and the blocked solve; ``eigh``/``eigvalsh`` are
replicated, with the explicit warning for a distributed operand.
"""

from __future__ import annotations

import collections
from typing import Optional

import numpy as np
import torch

from .. import factories, fusion, telemetry, types
from ..communication import _declare, _declared
from ..dndarray import DNDarray, _distribute
from ..sanitation import sanitize_in, warn_replicated
from ._blocked import sanitize_slab, stage_grid
from .basics import _from_owner, _wrap_like, matmul, norm, transpose

__all__ = ["cg", "eigh", "eigvalsh", "lanczos", "solve", "solve_triangular"]


def cg(A: DNDarray, b: DNDarray, x0: DNDarray, out: Optional[DNDarray] = None) -> DNDarray:
    """Conjugate gradients for a symmetric positive definite ``A``
    (reference solver.py:13-65), ``len(b)`` iterations at most. The
    reference stops once ``‖r‖ < 1e-10``; here the iterations after that
    are masked on the device, so the loop never waits for the host."""
    if not isinstance(A, DNDarray) or not isinstance(b, DNDarray) or not isinstance(x0, DNDarray):
        raise TypeError(f"A, b and x0 need to be of type DNDarray, but were {type(A)}, {type(b)}, {type(x0)}")
    if A.ndim != 2:
        raise RuntimeError("A needs to be a 2D matrix")
    if b.ndim != 1:
        raise RuntimeError("b needs to be a 1D vector")
    if x0.ndim != 1:
        raise RuntimeError("c needs to be a 1D vector")
    dtype = types.result_type(A, b, x0).torch_type()
    if fusion.collectives_active() and telemetry._MODE:
        # recording declines the sweep by name (see _cg_body)
        telemetry.record_unfused("op", "cg_unrolled_loop")
    ret = _wrap_like(_cg_body(A.larray, b.larray, x0.larray, dtype=dtype), None, x0)
    ret.resplit_(x0.split)
    if out is not None:
        out._replace(ret.shards, ret.gshape, ret.split)
        return out
    return ret


def _cg_body(Al: torch.Tensor, bl: torch.Tensor, x0l: torch.Tensor, *, dtype) -> torch.Tensor:
    """The CG sweep over the global views: ``len(b)`` iterations, those
    after convergence masked. A fused program would unroll the loop into
    ``n`` copies of its body (Dynamo inlines a Python loop), so ``cg``
    declines to record it, with the unfused reason ``cg_unrolled_loop``,
    and forces its operands (the reference records its ``while_loop`` as
    one node)."""
    Al, x = Al.to(dtype), x0l.to(dtype)
    r = bl.to(dtype) - Al @ x
    rs = r @ r
    p = r
    for _ in range(bl.shape[0]):
        active = torch.sqrt(rs) >= 1e-10
        Ap = Al @ p
        alpha = torch.where(active, rs / (p @ Ap), 0)
        x = x + alpha * p
        r = r - alpha * Ap
        rs_new = r @ r
        p = torch.where(active, r + (rs_new / rs) * p, p)
        rs = torch.where(active, rs_new, rs)
    return x



def solve_triangular(A: DNDarray, b: DNDarray, lower: bool = False) -> DNDarray:
    """Solve ``A x = b`` for a triangular ``A`` (heat_tpu/core/linalg/solver.py:254).

    Replicated ``A``: one ``torch.linalg.solve_triangular``. Split ``A``
    (split 1 resplit to 0 first): the blocked substitution over the stage
    grid of :func:`._blocked.stage_grid`; each stage moves one solved
    ``(ceil(n/p), k)`` block, never the operand. The result is split like
    ``b``. A pending ``A`` or ``b`` stays pending: the schedule records
    one node of their chain (``fusion.defer_apply``)."""
    if not isinstance(A, DNDarray) or not isinstance(b, DNDarray):
        raise TypeError("A and b must be DNDarrays")
    if A.ndim != 2 or A.gshape[0] != A.gshape[1]:
        raise ValueError("A must be a square 2-D matrix")
    if b.gshape[0] != A.gshape[0]:
        raise ValueError("b's leading dimension must match A")
    dtype = types.promote_types(types.promote_types(A.dtype, b.dtype), types.float32)
    tdt = dtype.torch_type()
    blocked = A.split is not None and A.comm.size > 1
    if blocked and A.split == 1:
        from ..manipulations import resplit

        A = resplit(A, 0)
    comm = A.comm
    if blocked:
        # declared: one allreduce of one solved block per stage (heat_tpu solver.py:322-333)
        _, rows_loc, n_stages, _ = stage_grid(A)
        k = 1 if b.ndim == 1 else b.gshape[1]
        _declare("allreduce", tdt, (rows_loc * k * tdt.itemsize, n_stages))
    out_split = 0 if blocked else None
    # heat_tpu/core/linalg/solver.py:190-248
    node = fusion.defer_apply(comm, _tri_solve_kernel, (A, b), out_split=out_split, lower=lower, tdt=tdt)
    if node is not None:
        out = fusion.wrap_node(node, b.gshape, out_split, b)
    else:
        with _declared():
            shards = _tri_solve_kernel(A, b, comm=comm, lower=lower, tdt=tdt)
        if not blocked:
            shards = _distribute(shards[0], None, comm)
        out = DNDarray(shards, tuple(b.gshape), dtype, out_split, b.device, b.comm)
    if b.split != out_split:
        out.resplit_(b.split)
    return out


def _tri_solve_kernel(A, b, *, comm, lower: bool, tdt: torch.dtype):
    """The shards of ``A x = b`` (DNDarrays, or shard views in a fused
    program): one ``torch.linalg.solve_triangular`` of the global views for
    a replicated ``A`` (one tensor), else the blocked substitution over the
    stage grid of a split-0 ``A`` (the split-0 shards of this process's
    ranks). A split-0 ``b`` gives each rank its own rows, any other ``b`` is
    read whole."""
    vector_rhs = b.ndim == 1
    n = A.gshape[0]
    if A.split is None or comm.size == 1:
        bl = b.larray.to(tdt)
        x = torch.linalg.solve_triangular(A.larray.to(tdt), bl[:, None] if vector_rhs else bl, upper=not lower)
        return [x[:, 0] if vector_rhs else x]
    p, rows_loc, n_stages, owners = stage_grid(A)
    n_pad = p * rows_loc
    ranks = comm.local_ranks
    if b.split == 0:
        parts = [t.to(tdt) for t in b.lshards]
    else:
        bl = b.larray.to(tdt)
        counts, displs = comm.local_counts_displs((n,), 0)
        parts = [bl[o:o + c] for c, o in zip(counts, displs)]
    slabs, rhs = [], []
    for r, s, part, d in zip(ranks, A.shards, parts, comm.local_devices):
        slab, rows = sanitize_slab(s, r, rows_loc, n, n_pad, tdt)
        slabs.append(slab)
        part = part[:, None] if vector_rhs else part
        # padding rows are identity rows against a zero right-hand side
        if part.shape[0] < rows_loc:
            part = torch.cat([part, part.new_zeros((rows_loc - part.shape[0], part.shape[1]))])
        rhs.append(part.to(d))
    k = rhs[0].shape[1]
    x_own = [torch.zeros((rows_loc, k), dtype=tdt, device=d) for d in comm.local_devices]
    for i in range(n_stages):
        t = i if lower else n_stages - 1 - i
        start, owner = t * rows_loc, owners[t]
        tiles = [w[:, start:start + rows_loc] for w in slabs]
        cand = None
        if owner in ranks:
            cand = torch.linalg.solve_triangular(tiles[owner - ranks.start], rhs[owner - ranks.start], upper=not lower)
        block = _from_owner(comm, owner, cand, (rows_loc, k), tdt)
        if owner in ranks:
            x_own[owner - ranks.start] = block[owner - ranks.start]
        rhs = [r - tile @ blk for r, tile, blk in zip(rhs, tiles, block)]
    return [x[:, 0] for x in x_own] if vector_rhs else x_own


def solve(a: DNDarray, b: DNDarray) -> DNDarray:
    """Solve ``a x = b`` for a square full-rank ``a`` (``numpy.linalg.solve``,
    ``LinAlgError`` on a singular operand; heat_tpu/core/linalg/solver.py:347).

    A distributed operand goes split 1 (a square split-0 operand has no
    gather-free TSQR), through the panel QR, ``Qᴴ b`` and the blocked
    triangular solve; a replicated one through ``torch.linalg.solve_ex``.
    The singularity test is the one host read."""
    from .qr import qr

    if not isinstance(a, DNDarray) or not isinstance(b, DNDarray):
        raise TypeError("a and b must be DNDarrays")
    if a.ndim != 2 or a.gshape[0] != a.gshape[1]:
        raise ValueError("a must be a square 2-D matrix")
    if b.ndim not in (1, 2) or b.gshape[0] != a.gshape[0]:
        raise ValueError(f"b must have leading dimension {a.gshape[0]}, got {tuple(b.gshape)}")
    if a.split is None or a.comm.size == 1:
        dtype = types.promote_types(types.promote_types(a.dtype, b.dtype), types.float32).torch_type()
        x, info = torch.linalg.solve_ex(a.larray.to(dtype), b.larray.to(dtype))
        if bool(info != 0) or not bool(torch.isfinite(x).all()):
            raise np.linalg.LinAlgError("solve: matrix is singular")
        out = _wrap_like(x, None, b)
        out.resplit_(b.split)
        return out
    if a.split == 0:
        from ..manipulations import resplit

        a = resplit(a, 1)
    q, r = qr(a)
    qh = transpose(q)
    if types.heat_type_is_complexfloating(qh.dtype):
        from ..complex_math import conjugate

        qh = conjugate(qh)  # Qᴴ, the unitary inverse
    rhs = matmul(qh, b)
    vector_rhs = b.ndim == 1
    if vector_rhs:
        rhs = rhs.reshape((a.gshape[0], 1))
    x = solve_triangular(r, rhs, lower=False)
    if vector_rhs:
        x = x.reshape((a.gshape[0],))
    if not bool(torch.isfinite(x.larray).all()):
        raise np.linalg.LinAlgError("solve: matrix is singular")
    return x


EighResult = collections.namedtuple("EighResult", "eigenvalues, eigenvectors")


def _eigh_prep(a: DNDarray, UPLO: str, op: str) -> torch.Tensor:
    """Validation, the explicit replication warning and numpy's one-triangle
    mirroring, shared by eigh and eigvalsh."""
    from ._blocked import mirror_triangle

    sanitize_in(a)
    if a.ndim != 2 or a.gshape[0] != a.gshape[1]:
        raise ValueError(f"{op} requires a square 2-D matrix")
    if UPLO not in ("L", "U"):
        raise ValueError(f"UPLO must be 'L' or 'U', got {UPLO!r}")
    if a.is_distributed():
        warn_replicated(
            op, "no gather-free distributed symmetric eigensolver exists "
            "(tridiagonalization is sequential panel work); use lanczos for "
            "the dominant spectrum of large operands"
        )
    dtype = types.promote_types(a.dtype, types.float32).torch_type()
    return mirror_triangle(a.larray.to(dtype), UPLO)


def eigh(a: DNDarray, UPLO: str = "L") -> EighResult:
    """Eigenvalues (ascending) and eigenvectors of a symmetric or Hermitian
    matrix, from its ``UPLO`` triangle (``numpy.linalg.eigh``); replicated."""
    w, v = torch.linalg.eigh(_eigh_prep(a, UPLO, "eigh"))
    return EighResult(_wrap_like(w, None, a), _wrap_like(v, None, a))


def eigvalsh(a: DNDarray, UPLO: str = "L") -> DNDarray:
    """Eigenvalues of a symmetric or Hermitian matrix (``numpy.linalg.eigvalsh``)."""
    return _wrap_like(torch.linalg.eigvalsh(_eigh_prep(a, UPLO, "eigvalsh")), None, a)


def lanczos(
    A: DNDarray,
    m: int,
    v0: Optional[DNDarray] = None,
    V_out: Optional[DNDarray] = None,
    T_out: Optional[DNDarray] = None,
):
    """Lanczos tridiagonalization with full reorthogonalization (reference
    solver.py:68-184). Returns ``(V, T)``: V (n, m) split like ``A``, T the
    (m, m) tridiagonal matrix. The default ``v0`` is
    ``numpy.random.default_rng(0).standard_normal(n)`` in float32, normalized,
    as in heat_tpu, so both packages start from the same vector. On a
    breakdown (``β <= 1e-10``) a normal vector from a torch generator seeded
    0 restarts the recurrence, masked on the device."""
    if not isinstance(A, DNDarray):
        raise TypeError(f"A needs to be of type DNDarray, but was {type(A)}")
    if not isinstance(m, int):
        raise TypeError(f"m must be int, but was {type(m)}")
    if A.ndim != 2:
        raise RuntimeError("A needs to be a 2D matrix")
    n = A.gshape[0]
    if v0 is None:
        rng = np.random.default_rng(0)
        v0 = factories.array(
            rng.standard_normal(n).astype(np.float32), split=A.split, device=A.device, comm=A.comm
        )
        v0 = v0 / norm(v0)
    elif v0.split != A.split:
        v0 = factories.array(v0, split=A.split, copy=True)
    vr = v0.larray
    dtype = vr.dtype
    Al = A.larray.to(dtype)
    generator = torch.Generator(device=vr.device).manual_seed(0)
    V = vr.new_zeros((m, n))
    T = vr.new_zeros((m, m))
    w = Al @ vr
    alpha = w @ vr
    w = w - alpha * vr
    V[0] = vr
    T[0, 0] = alpha
    for i in range(1, m):
        beta = torch.linalg.vector_norm(w)
        restart = torch.randn(n, generator=generator, device=vr.device, dtype=dtype)
        cand = torch.where(beta > 1e-10, w / torch.clamp(beta, min=1e-30), restart)
        # full reorthogonalization against the basis so far
        vr = cand - V[:i].mT @ (V[:i] @ cand)
        nrm = torch.linalg.vector_norm(vr)
        vr = torch.where(nrm > 1e-12, vr / torch.clamp(nrm, min=1e-30), cand)
        w2 = Al @ vr
        alpha = w2 @ vr
        w = w2 - alpha * vr - beta * V[i - 1]
        T[i - 1, i] = beta
        T[i, i - 1] = beta
        T[i, i] = alpha
        V[i] = vr
    Vd = _wrap_like(V.mT.contiguous(), A.split, A)
    Td = _wrap_like(T, None, A)
    if V_out is not None:
        V_out._replace(Vd.shards, Vd.gshape, Vd.split)
        Vd = V_out
    if T_out is not None:
        T_out._replace(Td.shards, Td.gshape, Td.split)
        Td = T_out
    return Vd, Td
