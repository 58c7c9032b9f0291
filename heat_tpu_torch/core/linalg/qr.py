"""QR decomposition (reference: heat/core/linalg/qr.py,
heat_tpu/core/linalg/qr.py), with the reference's dispatch, branch for
branch:

* ``method="auto"`` on a tall-skinny operand (``m >= 2n``, ``n² <= 2²²``,
  split != 1) tries **CholeskyQR2**: the Gram matrix xᴴx of each shard's
  valid rows, combined by one ``allreduce`` in shard order, its upper
  Cholesky factor R, R⁻¹ by one small triangular solve against I, Q as one
  GEMM ``x R⁻¹``, all of that twice. One host read, the probe (both factors
  finite and ``‖Q₁ᴴQ₁ − I‖_F < 0.5``), decides whether the result stands;
  else ``auto`` falls back to Householder and ``method="cholqr2"`` raises.
* **TSQR** for split 0, p > 1 and ``ceil(m/p) >= n``: a local
  ``torch.linalg.qr`` per shard (padding rows zeroed, so they give zero Q
  rows), one ``allgather`` of the p (n, n) R factors, a QR of the stack, and
  the local product ``Q₁ Q₂-block``.
* **panel QR** for split 1, p > 1, m >= n: panel by panel, the owner
  factors its (updated) panel, the Q panel is broadcast, and every later
  panel takes a two-pass block Gram-Schmidt (CGS2) update. Q and R come out
  split 1.
* otherwise one replicated ``torch.linalg.qr``, with a
  :class:`~heat_tpu_torch.core.sanitation.ReplicationWarning` for a
  distributed operand above 2²² elements.

The distributed schedules declare their collectives to telemetry with the
JAX package's op names, bytes and multiplicities and fire one fault site
each (heat_tpu/core/linalg/qr.py:215-228, 300-320, 365-381, 455-473): two
Gram ``allreduce``s for CholeskyQR2, one ``allgather`` of the p R factors
for TSQR, a Q and an R ``bcast`` per panel for the panel QR (the port's
panel R block stays with its owner, so it runs p ``bcast``s of the 2p it
declares).

Integer and half-precision inputs factor in float32. ``_METHODS`` counts
the schedule each call ran ("cholqr2", "tsqr", "panel", "householder"), as
``ops.*.LAUNCHES`` count kernel launches.
"""

from __future__ import annotations

import collections
from typing import Optional, Tuple

import torch

from .. import fusion, telemetry, types
from ..communication import _declare, _declared
from ..dndarray import DNDarray, _distribute
from ..sanitation import sanitize_in, warn_replicated
from .basics import _wrap_like

__all__ = ["qr"]

QR = collections.namedtuple("QR", "Q, R")

# above this many elements a distributed operand that no gather-free
# schedule covers warns before it is factored replicated
_REPLICATED_MAX_ELEMENTS = 1 << 22

_METHODS = collections.Counter()

_T_COLLECTIVE = telemetry.force_trigger("collective")

# rows per GEMM of a CholeskyQR2 Gram matrix, the partial Grams added in
# order. The float32 error of one GEMM grows with its reduction length, and
# Q's orthogonality with it: chip_smoke.py's phase 10 holds the chunked Gram
# against one GEMM over all 10^7 rows (PERF.md has the numbers)
_GRAM_ROWS = 1 << 16

_CHOLQR2_BREAKDOWN_MSG = (
    "cholqr2 broke down (non-finite Cholesky of the Gram matrix, or "
    "first-pass orthogonality error ‖Q1ᴴQ1 − I‖ >= 0.5): the operand "
    "is rank-deficient or too ill-conditioned (cond ≳ 1/√ε) for the "
    "squared-condition first pass — use method='tsqr'"
)


def qr(
    a: DNDarray,
    tiles_per_proc: int = 1,
    calc_q: bool = True,
    overwrite_a: bool = False,
    method: str = "auto",
) -> QR:
    """Reduced QR decomposition of a 2-D DNDarray (reference qr.py:17-179).

    ``method``: ``"auto"`` (default), ``"tsqr"`` (Householder, always
    stable) or ``"cholqr2"`` (all GEMMs; its squared-condition first pass is
    safe for ``cond(A) ≲ 1/√ε``, ~3e3 in float32). ``tiles_per_proc`` and
    ``overwrite_a`` are accepted for API parity: no schedule here has a tile
    count, and none changes its input. With ``calc_q=False`` Q is None and
    the last formation GEMM is skipped.
    """
    sanitize_in(a)
    if a.ndim != 2:
        raise ValueError(f"qr requires a 2-D array, got {a.ndim}-D")
    if method not in ("tsqr", "cholqr2", "auto"):
        raise ValueError(f"unknown qr method {method!r}: expected 'tsqr', 'cholqr2' or 'auto'")
    if not types.heat_type_is_inexact(a.dtype) or a.dtype in (types.bfloat16, types.float16):
        a = a.astype(types.promote_types(a.dtype, types.float32))

    m, n = a.gshape
    comm = a.comm
    p = comm.size
    if method == "auto" and m >= 2 * n and n * n <= _REPLICATED_MAX_ELEMENTS and a.split != 1:
        q, r, ok = _cholqr2(a, calc_q)
        if bool(ok):  # the one host read
            _METHODS["cholqr2"] += 1
            return QR(q, r)
    elif method == "cholqr2":
        if m < n:
            raise ValueError(f"cholqr2 requires a tall operand (m >= n), got {a.gshape}")
        q, r, ok = _cholqr2(a, calc_q)
        if not bool(ok):
            raise ValueError(_CHOLQR2_BREAKDOWN_MSG)
        _METHODS["cholqr2"] += 1
        return QR(q, r)

    if a.split == 0 and p > 1 and m >= n and -(-m // p) >= n:
        q, r = _tsqr(a, calc_q)
        _METHODS["tsqr"] += 1
    elif a.split == 1 and p > 1 and m >= n:
        q, r = _panel_qr_split1(a)
        _METHODS["panel"] += 1
    else:
        if a.is_distributed() and a.size > _REPLICATED_MAX_ELEMENTS:
            warn_replicated(
                "qr",
                f"no gather-free distributed schedule for shape {a.gshape} "
                f"split={a.split} (short-wide, or row blocks narrower than "
                "n); consider resplit or a transpose formulation",
            )
        q_t, r_t = torch.linalg.qr(a.larray, mode="reduced")
        q = _wrap_like(q_t, a.split, a)
        r = _wrap_like(r_t, 1 if a.split == 1 else None, a)
        _METHODS["householder"] += 1
    return QR(q if calc_q else None, r)


def _cholqr2(a: DNDarray, calc_q: bool):
    """Two CholeskyQR passes over the row shards of ``a``; returns
    ``(Q or None, R, ok)``, ``ok`` a 0-d bool tensor on the first device
    (heat_tpu/core/linalg/qr.py:485-583). A replicated or split-1 operand
    runs as one shard, its global view.

    The passes record one multi-output node of ``a``'s chain (Q, R and
    ``ok``; ``fusion.defer_multi``, heat_tpu/core/linalg/qr.py:236-262):
    forcing ``ok`` for the caller's one host read runs the Gram combines in
    the chain's program and lands Q and R in the same dispatch."""
    comm = a.comm
    n = a.gshape[1]
    if a.split == 0 and comm.size > 1:
        _declare("allreduce", a.dtype.torch_type(), (n * n * a.dtype.torch_type().itemsize, 2))
    nodes = fusion.defer_multi(_cholqr2_kernel, (a,), comm=comm, calc_q=calc_q)
    if nodes is not None:
        q = fusion.wrap_node(nodes[0], a.gshape, a.split, a) if calc_q else None
        r = fusion.wrap_node(nodes[-2], (n, n), None, a)
        with _T_COLLECTIVE:
            ok = fusion.force(nodes[-1], comm)[0]
        return q, r, ok
    with _declared():
        outs = _cholqr2_kernel(a, comm=comm, calc_q=calc_q)
    r = _as_array(outs[-2], (n, n), None, a)
    q = _as_array(outs[0], a.gshape, a.split, a) if calc_q else None
    return q, r, outs[-1][0]


def _as_array(shards, gshape, split, ref: DNDarray) -> DNDarray:
    """A kernel's result shards as a DNDarray of ``ref``'s type and mesh
    (one tensor for a replicated result)."""
    if split is None:
        shards = _distribute(shards[0], None, ref.comm)
    return DNDarray(shards, gshape, ref.dtype, split, ref.device, ref.comm)


def _cholqr2_kernel(a, *, comm, calc_q: bool):
    """The CholeskyQR2 passes over ``a`` (a DNDarray, or a shard view in a
    fused program): ``([Q shards], [R], [ok])``, without Q for ``calc_q``
    false. The Gram matrices sum each shard's valid rows (never its
    padding) in shard order; the small (n, n) Cholesky factor and its
    inverse are computed once, on the first device, and placed on the
    others; the tall work is two GEMMs per pass (one without ``calc_q``)."""
    n = a.gshape[1]
    if a.split == 0:
        x, counts = a.shards, comm.counts_displs_shape(a.gshape, 0)[0]
    else:
        x, counts = [a.larray], (a.gshape[0],)
    eye = torch.eye(n, dtype=x[0].dtype, device=comm.devices[0])

    def gram(rows):
        g = None
        for i in range(0, rows.shape[0], _GRAM_ROWS):
            chunk = rows[i:i + _GRAM_ROWS]
            g = chunk.mH @ chunk if g is None else g.addmm_(chunk.mH, chunk)
        return rows.new_zeros((n, n)) if g is None else g

    def gram_chol(shards):
        partials = [gram(s[:c]) for s, c in zip(shards, counts)]
        g = comm.allreduce(partials)[0] if len(partials) > 1 else partials[0]
        chol, info = torch.linalg.cholesky_ex(g)
        return chol.mH, info, g  # the upper factor

    def form_q(shards, r):
        # R⁻¹ by one (n, n) solve against I, then Q as one GEMM per shard
        r_inv = torch.linalg.solve_triangular(r, eye, upper=True)
        return [s @ w for s, w in zip(shards, _distribute(r_inv, None, comm))]

    r1, info1, _ = gram_chol(x)
    q1 = form_q(x, r1)
    r2, info2, g2 = gram_chol(q1)
    ok = (info1 == 0) & (info2 == 0) & _cholqr2_probe_ok(r1, r2, g2, eye)
    r = [r2 @ r1]
    if not calc_q:
        return r, [ok]
    q2 = form_q(q1, r2)
    if a.split != 0:
        q2 = [q2[0]] if a.split is None else _distribute(q2[0], a.split, comm)
    return q2, r, [ok]


def _tsqr(a: DNDarray, calc_q: bool) -> Tuple[Optional[DNDarray], DNDarray]:
    """Tall-skinny QR over the row shards (heat_tpu/core/linalg/qr.py:357-392):

    1. a local QR of each (block, n) shard, its padding rows zeroed;
    2. one ``allgather`` of the p (n, n) R factors;
    3. a QR of the (p n, n) stack, once, on the first device;
    4. the local product ``Q₁ Q₂[d n:(d + 1) n]`` on each shard.

    A zero row of a shard gives a zero row of Q₁, so the padding rows of Q
    are zero. Returns Q split 0 (None without ``calc_q``) and R replicated.
    A pending ``a`` stays pending: the schedule records one multi-output
    node of its chain (``fusion.defer_apply``, heat_tpu/core/linalg/qr.py:
    283-325)."""
    comm = a.comm
    m, n = a.gshape
    _declare("allgather", a.dtype.torch_type(), (comm.size * n * n * a.dtype.torch_type().itemsize, 1))
    nodes = fusion.defer_apply(comm, _tsqr_kernel, (a,), out_split=(0, None) if calc_q else (None,), calc_q=calc_q)
    if nodes is not None:
        q = fusion.wrap_node(nodes[0], (m, n), 0, a) if calc_q else None
        return q, fusion.wrap_node(nodes[-1], (n, n), None, a)
    with _declared():
        outs = _tsqr_kernel(a, comm=comm, calc_q=calc_q)
    r_arr = _as_array(outs[-1], (n, n), None, a)
    return (_as_array(outs[0], (m, n), 0, a) if calc_q else None), r_arr


def _tsqr_kernel(a, *, comm, calc_q: bool):
    """The TSQR schedule over the shards of ``a`` (a DNDarray, or a shard
    view in a fused program): ``([Q shards], [R])``, without Q for
    ``calc_q`` false."""
    n = a.gshape[1]
    counts = a.counts_displs()[0]
    q1s, r1s = [], []
    for s, c in zip(a.shards, counts):
        if c < s.shape[0]:
            s = torch.cat([s[:c], s.new_zeros((s.shape[0] - c, n))])
        q1, r1 = torch.linalg.qr(s, mode="reduced")
        q1s.append(q1)
        r1s.append(r1)
    stack = comm.allgather(r1s, dim=0)[0]
    q2, r = torch.linalg.qr(stack, mode="reduced")
    if not calc_q:
        return ([r],)
    blocks = _distribute(q2, None, comm)
    return [q1 @ b[d * n:(d + 1) * n] for d, (q1, b) in enumerate(zip(q1s, blocks))], [r]


def _panel_qr_split1(a: DNDarray) -> Tuple[DNDarray, DNDarray]:
    """Column-split blocked panel QR (heat_tpu/core/linalg/qr.py:395-482).

    Panel by panel: the owner factors its already orthogonalized (m, c)
    panel into its own Q and R blocks, one ``bcast`` gives the Q panel to
    the others, and every later panel takes a CGS2 update against it. The padding
    columns, a suffix of the last panel, are zeroed first; their Q and R
    columns are padding of the results. Q (m, n) and R (n, n) come out split
    1, R's shards cut to its n logical rows."""
    comm = a.comm
    m, n = a.gshape
    p = comm.size
    counts = a.counts_displs()[0]
    c = a.shards[0].shape[1]
    cur = []
    for s, cnt in zip(a.shards, counts):
        cur.append(s if cnt == c else torch.cat([s[:, :cnt], s.new_zeros((m, c - cnt))], dim=1))
    q_loc = [None] * p
    r_loc = [s.new_zeros((p * c, c)) for s in cur]
    itemsize = cur[0].element_size()
    _declare("bcast", cur[0].dtype, (m * c * itemsize, p), (c * c * itemsize, p))
    for d in range(p):
        q_own, r_own = torch.linalg.qr(cur[d], mode="reduced")
        with _declared():
            qd = comm.bcast([q_own] * p, root=d)
        q_loc[d] = q_own
        r_loc[d][d * c:(d + 1) * c] = r_own
        for i in range(d + 1, p):
            qdh = qd[i].mH
            coef1 = qdh @ cur[i]
            upd = cur[i] - qd[i] @ coef1
            coef2 = qdh @ upd
            cur[i] = upd - qd[i] @ coef2
            r_loc[i][d * c:(d + 1) * c] = coef1 + coef2
    dtype = types.canonical_heat_type(q_loc[0].dtype)
    q = DNDarray(q_loc, (m, n), dtype, 1, a.device, comm)
    r = DNDarray([t[:n] for t in r_loc], (n, n), dtype, 1, a.device, comm)
    return q, r


def _cholqr2_probe_ok(r1, r2, g2, eye) -> torch.Tensor:
    """The breakdown and conditioning probe (heat_tpu/core/linalg/qr.py:572-583):
    both Cholesky factors finite and the first pass's orthogonality error
    ``‖Q₁ᴴQ₁ − I‖_F < 0.5``. The second pass restores orthonormality while
    the spectral norm of that error is below 1; the Frobenius norm bounds
    the spectral norm from above, so 0.5 implies it with margin."""
    ok = torch.isfinite(r1).all() & torch.isfinite(r2).all()
    return ok & (torch.linalg.matrix_norm(g2 - eye) < 0.5)
