"""Basic linear algebra (reference: heat/core/linalg/basics.py,
heat_tpu/core/linalg/basics.py).

``matmul`` runs the reference's case table over the shards: a row-split left
operand multiplies each of its shards by the gathered (k, n) right factor; a
column-split right operand is multiplied shard by shard; a split contraction
axis gives local partial products and one ``allreduce`` in shard order; two
column-split operands gather the left factor once. Ragged operands go
through the logical shards (``lshards``), so padding never enters a
contraction. Cholesky and the determinant run the blocked stage programs of
:mod:`._blocked`; the remaining functions compute on the logical global
tensor, as the reference does with one XLA call. Nothing here reads a value
back to the host except where numpy's contract needs it: ``trace`` of a 2-D
operand returns a Python scalar, and ``cholesky`` and ``det`` test their
result once to raise ``LinAlgError`` or take the replicated fallback.
"""

from __future__ import annotations

import collections
from typing import List, Optional, Sequence, Union

import numpy as np
import torch

from .. import factories, fusion, resilience, types
from ..dndarray import DNDarray, _distribute, _wrap
from ..sanitation import sanitize_in, warn_replicated
from ..stride_tricks import sanitize_axis

__all__ = [
    "cholesky",
    "cross",
    "det",
    "dot",
    "einsum",
    "matrix_rank",
    "slogdet",
    "inv",
    "matmul",
    "matrix_norm",
    "norm",
    "outer",
    "projection",
    "trace",
    "transpose",
    "tril",
    "triu",
    "vdot",
    "vecdot",
    "vector_norm",
]


def _wrap_like(result: torch.Tensor, split: Optional[int], ref: DNDarray) -> DNDarray:
    """A logical global tensor as a DNDarray on ``ref``'s mesh, split along
    ``split`` where the result has that axis."""
    if split is not None and (result.ndim == 0 or split >= result.ndim):
        split = None
    return _wrap(result, split, ref.device, ref.comm)


def _float_for(a: DNDarray) -> torch.dtype:
    """Compute type of the factorizations: integers and the half floats in
    ``promote_types(dtype, float32)`` (no half-precision LAPACK kernels, as
    in XLA), float32/float64/complex as they are."""
    if types.heat_type_is_inexact(a.dtype) and a.dtype not in (types.bfloat16, types.float16):
        return a.dtype.torch_type()
    return types.promote_types(a.dtype, types.float32).torch_type()


def _gathered(x: DNDarray, dtype: torch.dtype) -> List[torch.Tensor]:
    """The whole of ``x`` on every device: its own copies when replicated,
    else one ``allgather`` of its logical shards."""
    if x.split is None:
        return [s.to(dtype) for s in x.shards]
    return x.comm.allgather([s.to(dtype) for s in x.lshards], dim=x.split)


def _blocks(x: DNDarray, axis: int) -> List[torch.Tensor]:
    """A replicated ``x`` cut along ``axis`` into the blocks a split operand
    of that length would hold, each from the device's own copy."""
    counts, displs = x.comm.counts_displs_shape(x.gshape, axis)
    return [s.narrow(axis, d, c) for s, d, c in zip(x.shards, displs, counts)]


def matmul(a: DNDarray, b: DNDarray, allow_resplit: bool = False) -> DNDarray:
    """Matrix product of two DNDarrays (reference basics.py:424-1050).

    Two 2-D operands follow the reference's case table
    (heat_tpu/core/linalg/basics.py:63-88):

    ======================  =========================================  =====
    operands                communication                              split
    ======================  =========================================  =====
    ``a.split == 0``        the (k, n) factor gathered when split      0
    ``b.split == 1``, a rep none: each shard of b multiplied in place  1
    contraction split       local partials, one allreduce              None
    ``split1 x split1``     one allgather of the left factor           1
    ======================  =========================================  =====

    Batched and 1-D operands take one ``torch.matmul`` of the global views
    with the reference's split bookkeeping (basics.py:132-149).
    ``allow_resplit`` is accepted for API parity.
    """
    sanitize_in(a)
    sanitize_in(b)
    if a.ndim == 1 and b.ndim == 1:
        return dot(a, b)
    if _both_bool(a, b):
        return _nonzero(matmul(a.astype(types.int64), b.astype(types.int64)))
    dtype = types.promote_types(a.dtype, b.dtype)
    tdt = dtype.torch_type()
    if a.ndim == 2 and b.ndim == 2:
        if resilience._ARMED and not a.padded and not b.padded:
            # the fault fires before any path computes (heat_tpu basics.py:108-112)
            resilience.check("collective.matmul")
        return _matmul_2d(a, b, dtype, tdt)
    result = torch.matmul(a.larray.to(tdt), b.larray.to(tdt))
    split: Optional[int] = None
    if a.ndim >= 2 and a.split is not None and a.split <= a.ndim - 2:
        # row or batch split carries through
        split = a.split if result.ndim == a.ndim else None
    if split is None and b.ndim >= 2 and b.split == b.ndim - 1:
        split = result.ndim - 1
    return _wrap_like(result, split, a)


def _matmul_2d(a: DNDarray, b: DNDarray, dtype, tdt: torch.dtype) -> DNDarray:
    if a.gshape[1] != b.gshape[0]:
        raise ValueError(f"matmul: shapes {a.gshape} and {b.gshape} are not aligned")
    # pending operands stay pending: the case table records one node
    # (heat_tpu/core/linalg/basics.py:117)
    ret = fusion.defer_matmul(a, b, _matmul_kernel, tdt=tdt)
    if ret is not None:
        return ret
    comm = a.comm
    out_split = 0 if a.split == 0 else 1 if b.split == 1 else None
    shards = _matmul_kernel(a, b, comm=comm, tdt=tdt)
    if out_split is None:
        shards = _distribute(shards[0], None, comm)
    return DNDarray(shards, (a.gshape[0], b.gshape[1]), dtype, out_split, a.device, comm)


def _matmul_kernel(a, b, *, comm, tdt: torch.dtype) -> List[torch.Tensor]:
    """The shards of a 2-D ``a @ b`` by the case table (``a`` and ``b``
    DNDarrays, or shard views inside a fused program): split 0 for a
    split-0 ``a``, split 1 for a split-1 ``b``, else one replicated
    tensor."""
    out_split = 0 if a.split == 0 else 1 if b.split == 1 else None
    if not comm.is_distributed() or (a.split is None and b.split is None):
        result = torch.matmul(a.larray.to(tdt), b.larray.to(tdt))
        return [result] if out_split is None else _distribute(result, out_split, comm)
    if a.split == 0:
        # row shards times the gathered (k, n) factor; the padding rows
        # of a only reach the padding rows of the product
        shards = [torch.matmul(s.to(tdt), w) for s, w in zip(a.shards, _gathered(b, tdt))]
    elif b.split == 1:
        # a replicated (no communication) or split 1 (one allgather of a)
        shards = [torch.matmul(w, s.to(tdt)) for w, s in zip(_gathered(a, tdt), b.shards)]
    else:
        # the contraction axis is split: (1, None), (None, 0), (1, 0)
        a_parts = a.lshards if a.split == 1 else _blocks(a, 1)
        b_parts = b.lshards if b.split == 0 else _blocks(b, 0)
        partials = [torch.matmul(x.to(tdt), y.to(tdt)) for x, y in zip(a_parts, b_parts)]
        shards = comm.allreduce(partials)[:1]
    return shards


def _both_bool(a: DNDarray, b: DNDarray) -> bool:
    return a.dtype is types.bool and b.dtype is types.bool


def _nonzero(x: DNDarray) -> DNDarray:
    """A product of bool operands computed in integers, as numpy's bool
    result: true where the count of true terms is not 0."""
    return DNDarray([s != 0 for s in x.shards], x.gshape, types.bool, x.split, x.device, x.comm)


def dot(a: DNDarray, b: DNDarray, out: Optional[DNDarray] = None) -> Union[DNDarray, float]:
    """Dot product (reference basics.py:246-309): for two vectors the local
    dots of their shards and one ``allreduce``, otherwise matmul."""
    if isinstance(a, DNDarray) and isinstance(b, DNDarray) and a.ndim == 1 and b.ndim == 1:
        ret = _nonzero(_inner(a.astype(types.int64), b.astype(types.int64))) if _both_bool(a, b) else _inner(a, b)
    elif a.ndim <= 2 and b.ndim <= 2:
        ret = matmul(a, b)
    else:
        raise NotImplementedError("ht.dot not implemented for N-D dot M-D arrays")
    if out is not None:
        out._replace(ret.shards, ret.gshape, ret.split)
        return out
    return ret


def _inner(a: DNDarray, b: DNDarray) -> DNDarray:
    if a.gshape != b.gshape:
        raise ValueError(f"dot: shapes {a.gshape} and {b.gshape} are not aligned")
    dtype = types.promote_types(a.dtype, b.dtype)
    tdt = dtype.torch_type()
    if not a.comm.is_distributed() or (a.split is None and b.split is None):
        return _wrap_like(torch.dot(a.larray.to(tdt), b.larray.to(tdt)), None, a)
    a_parts = a.lshards if a.split == 0 else _blocks(a, 0)
    b_parts = b.lshards if b.split == 0 else _blocks(b, 0)
    partials = [torch.dot(x.to(tdt), y.to(tdt)) for x, y in zip(a_parts, b_parts)]
    return DNDarray(a.comm.allreduce(partials), (), dtype, None, a.device, a.comm)


def vdot(x1: DNDarray, x2: DNDarray) -> DNDarray:
    """Dot product of the flattened inputs, the first conjugated (reference
    basics.py:2236)."""
    if _both_bool(x1, x2):
        return _nonzero(vdot(x1.astype(types.int64), x2.astype(types.int64)))
    tdt = types.promote_types(x1.dtype, x2.dtype).torch_type()
    return _wrap_like(torch.vdot(x1.larray.reshape(-1).to(tdt), x2.larray.reshape(-1).to(tdt)), None, x1)


def vecdot(
    x1: DNDarray, x2: DNDarray, axis: Optional[int] = None, keepdims: bool = False, keepdim=None
) -> DNDarray:
    """Vector dot product along an axis, the first operand conjugated
    (reference basics.py:2301): the elementwise and reduction engines, so
    the split follows theirs. ``keepdim`` is the torch-style alias."""
    from .. import arithmetics, complex_math

    if keepdim is not None:
        keepdims = keepdim
    for i, operand in enumerate((x1, x2)):
        if (operand.ndim if isinstance(operand, DNDarray) else np.ndim(operand)) == 0:
            # numpy's gufunc error: the core dimension (n) is missing
            raise ValueError(
                f"vecdot: Input operand {i} does not have enough dimensions (has 0, gufunc core with "
                "signature (n),(n)->() requires 1)"
            )
    if axis is None:
        axis = -1
    first = complex_math.conjugate(x1) if types.heat_type_is_complexfloating(x1.dtype) else x1
    return arithmetics.sum(arithmetics.mul(first, x2), axis=axis, keepdims=keepdims)


def einsum(subscripts: str, *operands, optimize: Union[bool, str] = "optimal", out=None) -> DNDarray:
    """Einstein summation over the subscripts-string form of ``numpy.einsum``
    (heat_tpu/core/linalg/basics.py:201): one ``torch.einsum`` over the
    global views. The output split follows the first split operand's split
    label into the output subscripts (replicated when it is contracted, or
    with an ellipsis). ``optimize`` is accepted for source compatibility."""
    if out is not None:
        raise NotImplementedError("einsum does not support out= buffers")
    if not isinstance(subscripts, str):
        raise TypeError(
            "einsum requires the subscripts string as the first argument "
            "(the interleaved operand/sublist form is not supported)"
        )
    ref = next((op for op in operands if isinstance(op, DNDarray)), None)
    if ref is None:
        raise TypeError("einsum requires at least one DNDarray operand")
    dtype = types.result_type(*operands).torch_type()
    device = ref.comm.devices[0]
    tensors = [
        op.larray.to(dtype) if isinstance(op, DNDarray) else torch.as_tensor(np.asarray(op), device=device).to(dtype)
        for op in operands
    ]
    result = torch.einsum(subscripts, *tensors)
    split: Optional[int] = None
    spec = subscripts.replace(" ", "")
    if "..." not in spec:
        if "->" in spec:
            in_spec, out_spec = spec.split("->")
        else:
            in_spec = spec
            labels = in_spec.replace(",", "")
            # numpy's implicit output: the labels that occur once, sorted
            out_spec = "".join(sorted(c for c in set(labels) if labels.count(c) == 1))
        in_specs = in_spec.split(",")
        if len(in_specs) == len(operands):
            for op, labels in zip(operands, in_specs):
                if isinstance(op, DNDarray) and op.split is not None and op.split < len(labels):
                    label = labels[op.split]
                    if label in out_spec:
                        split = out_spec.index(label)
                        break
    return _wrap_like(result, split, ref)


def cross(
    x1: DNDarray, x2: DNDarray, axisa: int = -1, axisb: int = -1, axisc: int = -1, axis: int = -1
) -> DNDarray:
    """Cross product of 3-vectors (reference basics.py:46-159). As in
    heat_tpu, ``axis`` (default -1) overrides ``axisa``/``axisb``/``axisc``."""
    if axis is not None:
        axisa = axisb = axisc = axis
    tdt = types.promote_types(x1.dtype, x2.dtype).torch_type()
    a = torch.movedim(x1.larray.to(tdt), axisa, -1)
    b = torch.movedim(x2.larray.to(tdt), axisb, -1)
    if a.shape[-1] != 3 or b.shape[-1] != 3:
        raise ValueError("incompatible dimensions for cross product (dimension must be 3)")
    a, b = torch.broadcast_tensors(a, b)
    result = torch.movedim(torch.linalg.cross(a, b, dim=-1), -1, axisc)
    split = x1.split if result.ndim == x1.ndim else None
    return _wrap_like(result, split, x1)


# ---------------------------------------------------------------------------
# the blocked stage programs: Cholesky and the determinant
# ---------------------------------------------------------------------------
def _row_slabs(af: DNDarray, dtype):
    """The stage grid of a split-0 square operand and its sanitized slabs."""
    from ._blocked import sanitize_slab, stage_grid

    n = int(af.gshape[0])
    p, rows_loc, n_stages, owners = stage_grid(af)
    n_pad = p * rows_loc
    slabs = [sanitize_slab(s, i, rows_loc, n, n_pad, dtype)[0] for i, s in enumerate(af.shards)]
    return slabs, rows_loc, n_stages, owners


def _cholesky_blocked(af: DNDarray, dtype) -> List[torch.Tensor]:
    """Right-looking blocked Cholesky over the row shards (the program of
    heat_tpu/core/linalg/basics.py:348-420): stage ``t``'s owner factors
    its updated diagonal tile, one ``allreduce`` replicates ``L_tt``, every
    shard forms its panel block ``C = W[:, t] L_tt^-T`` (zero above the
    owner), one ``allgather`` assembles the block column, and the trailing
    update ``W -= C colᵀ`` is local. Returns the L slabs, one per shard,
    and the number of stages whose tile was not positive definite (a 0-d
    tensor on the owner of the last stage)."""
    comm = af.comm
    slabs, rows_loc, n_stages, owners = _row_slabs(af, dtype)
    L = [torch.zeros_like(w) for w in slabs]
    failed = torch.zeros((), dtype=torch.int32, device=comm.devices[0])
    for t in range(n_stages):
        start, owner = t * rows_loc, owners[t]
        tiles = [w[:, start:start + rows_loc] for w in slabs]
        # numpy reads only the lower triangle of the diagonal tile
        own = tiles[owner]
        ltt_own, info = torch.linalg.cholesky_ex(torch.tril(own) + torch.tril(own, -1).mT)
        failed = failed.to(info.device) + (info != 0)
        ltt = comm.allreduce([ltt_own if i == owner else torch.zeros_like(ltt_own).to(d) for i, d in enumerate(comm.devices)])
        panels = []
        for i, (tile, lt) in enumerate(zip(tiles, ltt)):
            if i < owner:
                panels.append(torch.zeros_like(tile))
            elif i == owner:
                panels.append(lt)
            else:
                panels.append(torch.linalg.solve_triangular(lt.mT, tile, upper=True, left=False))
        col = comm.allgather(panels, dim=0)
        for i in range(len(slabs)):
            L[i][:, start:start + rows_loc] = panels[i]
            slabs[i] = slabs[i] - panels[i] @ col[i].mT
    return L, failed


def cholesky(a: DNDarray) -> DNDarray:
    """Lower Cholesky factor of a symmetric positive definite matrix,
    ``a = L Lᵀ`` (heat_tpu/core/linalg/basics.py:424). As numpy, only the
    lower triangle is read and a matrix that is not positive definite raises
    ``numpy.linalg.LinAlgError``. A distributed real operand runs the blocked
    program (:func:`_cholesky_blocked`, split 1 resplit to 0 first); a
    replicated one ``torch.linalg.cholesky``."""
    from ._blocked import mirror_triangle

    sanitize_in(a)
    if a.ndim != 2 or a.gshape[0] != a.gshape[1]:
        raise ValueError("cholesky requires a square 2-D matrix")
    dtype = _float_for(a)
    distributed = a.is_distributed()
    if distributed and dtype.is_complex:
        warn_replicated(
            "cholesky", "the blocked program's panel solve is real-only; "
            "computing the Hermitian factorization on the gathered operand"
        )
    if distributed and not dtype.is_complex:
        from ..manipulations import resplit

        af = resplit(a, 0) if a.split == 1 else a
        n = a.gshape[0]
        slabs, failed = _cholesky_blocked(af, dtype)
        L = torch.cat([s.to(af.comm.devices[0]) for s in slabs])[:n, :n]
    else:
        L, failed = torch.linalg.cholesky_ex(mirror_triangle(a.larray.to(dtype), "L"))
    # numpy's exception contract: one host read
    if bool(failed != 0) or not bool(torch.isfinite(torch.diagonal(L)).all()):
        raise np.linalg.LinAlgError("cholesky: matrix is not positive definite")
    return _wrap_like(L, a.split, a)


def _slogdet_blocked(af: DNDarray, dtype):
    """Blocked forward elimination over the row shards (the program of
    heat_tpu/core/linalg/basics.py:273-346): stage ``i``'s owner takes
    sign and log|det| of its diagonal tile (pivoting within the tile) and
    ``D⁻¹ W_owner``, one ``allreduce`` replicates that block, and every
    other shard folds the block column out of its rows. Returns
    ``(sign, logabs)`` on the first device; a singular non-final tile
    shows as a non-finite ``logabs``."""
    comm = af.comm
    slabs, rows_loc, n_stages, owners = _row_slabs(af, dtype)
    first = comm.devices[0]
    neg = torch.zeros((), dtype=dtype, device=first)
    zero = torch.zeros((), dtype=dtype, device=first)
    logabs = torch.zeros((), dtype=dtype, device=first)
    for i in range(n_stages):
        start, owner = i * rows_loc, owners[i]
        tile = slabs[owner][:, start:start + rows_loc]
        s, la = torch.linalg.slogdet(tile)
        neg = neg + (s < 0).to(dtype).to(first)
        zero = zero + (s == 0).to(dtype).to(first)
        logabs = logabs + la.to(first)
        block_own = torch.linalg.solve_ex(tile, slabs[owner])[0]
        block = comm.allreduce([block_own if j == owner else torch.zeros_like(block_own).to(d) for j, d in enumerate(comm.devices)])
        for j in range(len(slabs)):
            if j != owner:
                slabs[j] = slabs[j] - slabs[j][:, start:start + rows_loc] @ block[j]
    sign = torch.where(torch.remainder(neg, 2) > 0.5, -1.0, 1.0).to(dtype)
    sign = torch.where(zero > 0, torch.zeros_like(sign), sign)
    return sign, logabs


def _slogdet_core(a: DNDarray, op: str):
    """The blocked elimination's ``(sign, logabs)`` where a distributed real
    path exists, else None (the caller takes the replicated kernel). A
    complex split operand, or a singular non-final diagonal tile, warns and
    falls back; the latter costs the one host read of this function."""
    sanitize_in(a)
    if a.ndim < 2 or a.gshape[-1] != a.gshape[-2]:
        raise ValueError("Last two dimensions of the array must be square")
    if not (a.ndim == 2 and a.is_distributed()):
        return None
    dtype = _float_for(a)
    if dtype.is_complex:
        warn_replicated(
            op, "complex determinants have no sign-parity encoding in the "
            "blocked-elimination program; computing on the gathered operand"
        )
        return None
    from ..manipulations import resplit

    sign, logabs = _slogdet_blocked(resplit(a, 0) if a.split == 1 else a, dtype)
    if bool(torch.isfinite(logabs) | ((sign == 0) & (logabs == -torch.inf))):
        return sign, logabs
    warn_replicated(
        op, "a diagonal tile was singular under blocked elimination "
        "(no cross-tile pivoting); falling back to the replicated LU kernel"
    )
    return None


def det(a: DNDarray) -> DNDarray:
    """Determinant (reference basics.py:160-245): the blocked elimination for
    a distributed 2-D operand, ``torch.linalg.det`` otherwise."""
    core = _slogdet_core(a, "det")
    if core is not None:
        sign, logabs = core
        return _wrap_like(sign * torch.exp(logabs), None, a)
    return _wrap_like(torch.linalg.det(a.larray.to(_float_for(a))), None, a)


SlogdetResult = collections.namedtuple("SlogdetResult", "sign, logabsdet")


def slogdet(a: DNDarray) -> "SlogdetResult":
    """Sign and log|det| (``numpy.linalg.slogdet``), from the same blocked
    elimination as :func:`det` for a distributed 2-D operand."""
    core = _slogdet_core(a, "slogdet")
    if core is None:
        core = torch.linalg.slogdet(a.larray.to(_float_for(a)))
    sign, logabs = core
    return SlogdetResult(_wrap_like(sign, None, a), _wrap_like(logabs, None, a))


def matrix_rank(a: DNDarray, tol=None, hermitian: bool = False, rtol=None) -> DNDarray:
    """Rank of a 2-D operand from its singular values (numpy's contract for
    one matrix: ``tol = max(m, n) eps max(S)`` by default, ``rtol`` scales
    ``max(S)``). The singular values come from :func:`~.svd.svd`, the
    eigenvalues of :func:`~.solver.eigvalsh` with ``hermitian``."""
    sanitize_in(a)
    if a.ndim != 2:
        raise ValueError(
            "matrix_rank requires a 2-D operand (numpy's stacked ndim>2 form "
            "is not supported)"
        )
    if tol is not None and rtol is not None:
        raise ValueError("tol and rtol cannot both be given")
    if hermitian:
        from .solver import eigvalsh

        s = eigvalsh(a).larray.abs()
    else:
        from .svd import svd

        s = svd(a, compute_uv=False).larray
    if tol is None and rtol is not None:
        tol = rtol * s.max()
    elif tol is None:
        tol = max(a.gshape) * torch.finfo(s.dtype).eps * s.max()
    return _wrap_like((s > tol).sum().to(torch.int64), None, a)


def inv(a: DNDarray) -> DNDarray:
    """Matrix inverse (reference basics.py:312-421). A distributed 2-D
    operand inverts through the distributed factorizations, ``A = QR`` and
    ``A⁻¹ = R⁻¹ Qᵀ`` by the blocked triangular solve; others take
    ``torch.linalg.inv_ex``, which, like XLA's kernel, does not raise on a
    singular operand."""
    sanitize_in(a)
    if a.ndim < 2 or a.gshape[-1] != a.gshape[-2]:
        raise ValueError("Last two dimensions of the array must be square")
    dtype = _float_for(a)
    if a.ndim == 2 and a.is_distributed():
        from .qr import qr
        from .solver import solve_triangular

        af = a if types.heat_type_is_inexact(a.dtype) else a.astype(types.promote_types(a.dtype, types.float32))
        q, r = qr(af)
        qt = transpose(q, (1, 0))
        if r.split is None:
            # R replicated: one local solve against the global Qᵀ
            x = torch.linalg.solve_triangular(r.larray.to(dtype), qt.larray.to(dtype), upper=True)
            return _wrap_like(x, a.split, a)
        out = solve_triangular(r, qt, lower=False)
        if out.split != a.split:
            out.resplit_(a.split)
        return out
    return _wrap_like(torch.linalg.inv_ex(a.larray.to(dtype))[0], a.split, a)


def matrix_norm(x: DNDarray, axis=None, keepdims: bool = False, ord=None) -> DNDarray:
    """Matrix norm over a pair of axes (reference basics.py:1095-1224):
    ``None``/'fro', 'nuc', ±1, ±2, ±inf."""
    sanitize_in(x)
    if axis is None:
        if x.ndim != 2:
            raise ValueError("dimensions do not match, axis must be given for ndim != 2")
        axis = (0, 1)
    if not (isinstance(axis, tuple) and len(axis) == 2):
        raise TypeError(f"axis must be a 2-tuple, got {axis}")
    row_axis, col_axis = (sanitize_axis(x.gshape, ax) for ax in axis)
    if ord not in (None, "fro", "nuc", 1, -1, 2, -2, np.inf, -np.inf):
        raise ValueError(f"Invalid norm order {ord} for matrices")
    result = torch.linalg.matrix_norm(
        x.larray.to(_float_for(x)), "fro" if ord is None else ord, dim=(row_axis, col_axis), keepdim=keepdims
    )
    out_split = None
    if x.split is not None and x.split not in (row_axis, col_axis):
        out_split = x.split if keepdims else x.split - sum(1 for ax in (row_axis, col_axis) if ax < x.split)
    return _wrap_like(result, out_split, x)


def vector_norm(x: DNDarray, axis=None, keepdims: bool = False, ord=None) -> DNDarray:
    """Vector norm over an axis (reference basics.py:1225-1330), numpy's
    ``linalg.norm`` semantics: with ``ord`` and no axis, over all axes."""
    sanitize_in(x)
    if axis is None and ord is not None and x.ndim > 1:
        axis = tuple(range(x.ndim))
    dim = axis if axis is None or isinstance(axis, int) else tuple(axis)
    result = torch.linalg.norm(x.larray.to(_float_for(x)), ord=ord, dim=dim, keepdim=keepdims)
    out_split = None
    if x.split is not None and axis is not None:
        axes = (axis,) if isinstance(axis, int) else tuple(axis)
        axes = tuple(sanitize_axis(x.gshape, ax) for ax in axes)
        if x.split not in axes:
            out_split = x.split if keepdims else x.split - sum(1 for ax in axes if ax < x.split)
    return _wrap_like(result, out_split, x)


def norm(x: DNDarray, axis=None, keepdims: bool = False, ord=None) -> DNDarray:
    """Matrix or vector norm (reference basics.py:1331-1371): Frobenius over
    everything by default, a matrix norm over a pair of axes."""
    if axis is None and ord is None:
        return vector_norm(x, axis=None, keepdims=keepdims, ord=None)
    if axis is None:
        axis = (0, 1) if x.ndim == 2 else None
    if isinstance(axis, tuple) and len(axis) == 2:
        return matrix_norm(x, axis=axis, keepdims=keepdims, ord=ord)
    return vector_norm(x, axis=axis, keepdims=keepdims, ord=ord)


def outer(a: DNDarray, b: DNDarray, out: Optional[DNDarray] = None, split: Optional[int] = None) -> DNDarray:
    """Outer product of two vectors (reference basics.py:1372-1604); split
    along 0 when ``a`` is split, else 1 when ``b`` is, unless given."""
    sanitize_in(a)
    sanitize_in(b)
    tdt = types.promote_types(a.dtype, b.dtype).torch_type()
    result = torch.outer(a.larray.reshape(-1).to(tdt), b.larray.reshape(-1).to(tdt))
    if split is None:
        split = 0 if a.split is not None else (1 if b.split is not None else None)
    ret = _wrap_like(result, split, a)
    if out is not None:
        out._replace([s.to(out.dtype.torch_type()) for s in ret.shards], ret.gshape, ret.split)
        return out
    return ret


def projection(a: DNDarray, b: DNDarray) -> DNDarray:
    """Projection of vector ``a`` onto vector ``b`` (reference basics.py:1605-1628)."""
    if a.ndim != 1 or b.ndim != 1:
        raise RuntimeError(f"a, b must be vectors of length 1, but were {a.ndim}, {b.ndim}")
    return (dot(a, b) / dot(b, b)) * b


def trace(a, offset: int = 0, axis1: int = 0, axis2: int = 1, dtype=None, out: Optional[DNDarray] = None):
    """Sum along a diagonal (reference basics.py:1629-1965). As in heat, a
    2-D operand gives a Python scalar, and rejects ``out``."""
    if not isinstance(a, DNDarray):
        a = factories.array(a)
    if a.ndim < 2:
        raise ValueError(f"x must be at least two-dimensional, but was {a.ndim}-dimensional")
    axis1 = sanitize_axis(a.gshape, axis1)
    axis2 = sanitize_axis(a.gshape, axis2)
    if axis1 == axis2:
        raise ValueError(f"axis1 and axis2 cannot be the same, but were {axis1}, {axis2}")
    result = torch.diagonal(a.larray, offset, axis1, axis2).sum(-1)
    if dtype is not None:
        result = result.to(types.canonical_heat_type(dtype).torch_type())
    ret = _wrap_like(result, None, a)
    if a.ndim == 2:
        if out is not None:
            raise ValueError("`out` is not applicable if result is a scalar / input `a` is 2-dimensional")
        return ret.item()
    if out is not None:
        out._replace(ret.shards, ret.gshape, ret.split)
        return out
    return ret


def transpose(a: DNDarray, axes: Optional[Sequence[int]] = None) -> DNDarray:
    """Permute the axes, reversed by default; the split axis moves with its
    data, so each shard is permuted where it lies (reference basics.py
    transpose)."""
    sanitize_in(a)
    if axes is None:
        axes = tuple(reversed(range(a.ndim)))
    else:
        axes = sanitize_axis(a.gshape, tuple(axes))
        if len(axes) != a.ndim:
            raise ValueError("axes do not match the dimensions of the array")
    gshape = tuple(a.gshape[i] for i in axes)
    split = None if a.split is None else axes.index(a.split)
    shards = [s.permute(axes) for s in a.shards]
    return DNDarray(shards, gshape, types.canonical_heat_type(shards[0].dtype), split, a.device, a.comm)


def tril(m: DNDarray, k: int = 0) -> DNDarray:
    """Lower triangle of the last two axes (reference basics.py:2121-2177);
    a vector is expanded to (n, n) first."""
    return _tri(m, k, torch.tril)


def triu(m: DNDarray, k: int = 0) -> DNDarray:
    """Upper triangle of the last two axes (reference basics.py:2178-2235)."""
    return _tri(m, k, torch.triu)


def _tri(m: DNDarray, k: int, fn) -> DNDarray:
    """``fn`` shard by shard: a shard of a row split starts its diagonal
    ``k`` rows later, one of a column split as many columns earlier."""
    sanitize_in(m)
    if m.ndim == 1:
        n = m.gshape[0]
        return _wrap_like(fn(m.larray.expand(n, n), k), 0 if m.split is not None else None, m)
    if m.split is None:
        return _wrap_like(fn(m.larray, k), None, m)
    block = m.shards[0].shape[m.split]
    if m.split == m.ndim - 2:
        shards = [fn(s, k + i * block) for i, s in enumerate(m.shards)]
    elif m.split == m.ndim - 1:
        shards = [fn(s, k - i * block) for i, s in enumerate(m.shards)]
    else:
        shards = [fn(s, k) for s in m.shards]
    return DNDarray(shards, m.gshape, m.dtype, m.split, m.device, m.comm)
