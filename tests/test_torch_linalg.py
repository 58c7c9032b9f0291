"""heat_tpu_torch.linalg (basics, _blocked, solver, svd) against heat_tpu and
numpy on the CPU mesh (HEAT_TPU_TEST_DEVICES shards, 8 by default): matmul
at all nine split pairs with its collectives, dot, vdot, vecdot, outer,
projection, cross, einsum, trace, tril/triu, the norms, det, slogdet, inv,
matrix_rank, cholesky, solve_triangular, solve, cg, eigh, eigvalsh, lanczos,
svd, lstsq and pinv. QR is in test_torch_qr.py. Cases from test_linalg.py,
test_linalg_depth.py, test_svd_lstsq.py, test_solve_det_fuzz.py and
test_matmul_schedule.py (its eager pins, the reference's recorder off).

Tolerances: float64 results 1e-10 relative and absolute (the same products
and factorizations with their sums in other orders, on operands of
condition number below 1e2); float32 1e-4 (the same, and lanczos's
recurrence over 12 steps); exact for splits, shapes, types and the counts
of collectives.
"""

import warnings

import numpy as np
import pytest
import torch

import heat_tpu as ref
import heat_tpu_torch as ht
from heat_tpu_torch.core import fusion
from heat_tpu_torch.core.linalg import _blocked
from heat_tpu_torch.core.sanitation import ReplicationWarning
from test_torch_parity import P, check, check_layout, on_cpu  # noqa: F401

F64 = dict(rtol=1e-10, atol=1e-10)
F32 = dict(rtol=1e-4, atol=1e-4)
SPLITS = [None, 0, 1]


def _rng(seed=0):
    return np.random.default_rng(seed)


def _both(values, split=None):
    return ref.array(values, split=split), ht.array(values, split=split)


def _poison(x: "ht.DNDarray") -> None:
    """NaN into the padding of the port's shards: a padded row or column
    that entered a contraction would show in the logical result."""
    if x.split is not None and x.padded and x.dtype in (ht.float32, ht.float64):
        for s, c in zip(x.shards, x.counts_displs()[0]):
            s.narrow(x.split, c, s.shape[x.split] - c).fill_(float("nan"))


@pytest.fixture
def collectives(monkeypatch):
    """Counts of the collectives the default CPU mesh runs, and the bytes
    put into them: its verbs, and those of the fused programs that run a
    schedule recorded on it (not the record-time runs on meta tensors)."""
    comm = ht.get_comm()
    calls, volume = {}, {}
    for verb in ("allgather", "allreduce", "bcast"):
        original = getattr(comm, verb)

        def note(shards, _verb=verb):
            calls[_verb] = calls.get(_verb, 0) + 1
            volume[_verb] = volume.get(_verb, 0) + sum(s.numel() * s.element_size() for s in shards)

        def counted(shards, *args, _note=note, _original=original, **kwargs):
            _note(shards)
            return _original(shards, *args, **kwargs)

        def in_program(self, shards, *args, _note=note, _original=getattr(fusion._ProgramComm, verb), **kwargs):
            if shards[0].device.type != "meta":
                _note(shards)
            return _original(self, shards, *args, **kwargs)

        monkeypatch.setattr(comm, verb, counted)
        monkeypatch.setattr(fusion._ProgramComm, verb, in_program)
    return calls, volume


# ---------------------------------------------------------------------------
# matmul and the products
# ---------------------------------------------------------------------------
@pytest.mark.parametrize(
    "shape,dtype,tolerance",
    [((13, 11, 7), "float64", F64), ((2 * P, 3 * P, P), "float64", F64), ((13, 11, 7), "float32", F32)],
    ids=["ragged", "even", "ragged-float32"],
)
@pytest.mark.parametrize("sb", SPLITS)
@pytest.mark.parametrize("sa", SPLITS)
def test_matmul_split_pairs(sa, sb, shape, dtype, tolerance, collectives):
    m, k, n = shape
    a_np = _rng(1).standard_normal((m, k)).astype(dtype)
    b_np = _rng(2).standard_normal((k, n)).astype(dtype)
    (ra, a), (rb, b) = _both(a_np, sa), _both(b_np, sb)
    _poison(a)
    _poison(b)
    calls, volume = collectives
    calls.clear()
    volume.clear()
    mine = a @ b
    check(mine, ref.matmul(ra, rb), a_np @ b_np, **tolerance)
    # the reference's case table: split of C, and the communication
    expected_split = 0 if sa == 0 else (1 if sb == 1 else None)
    assert mine.split == expected_split
    if P == 1 or (sa is None and sb is None) or (sa == 0 and sb is None) or (sa is None and sb == 1):
        assert calls == {}
    elif sa == 0:  # the (k, n) factor gathered, never the row-split operand
        assert calls == {"allgather": 1} and volume["allgather"] == b_np.nbytes
    elif sa == 1 and sb == 1:  # one allgather of the left factor
        assert calls == {"allgather": 1} and volume["allgather"] == a_np.nbytes
    else:  # the contraction axis split: partials and one allreduce
        assert calls == {"allreduce": 1} and volume["allreduce"] == P * m * n * a_np.itemsize


def test_ragged_matmul_avoids_padded_contraction():
    # tests/test_matmul_schedule.py::test_ragged_matmul_avoids_padded_contraction,
    # held to numpy: ragged contraction dims go through the logical shards
    m, k, n = 2 * P + 1, 3 * P + 1, P + 2
    a_np, b_np = _rng(1).standard_normal((m, k)), _rng(3).standard_normal((k, n))
    for sa in (0, 1):
        for sb in (0, 1):
            a, b = ht.array(a_np, split=sa), ht.array(b_np, split=sb)
            _poison(a)
            _poison(b)
            np.testing.assert_allclose((a @ b).numpy(), a_np @ b_np, rtol=1e-10)


@pytest.mark.parametrize(
    "a_shape,b_shape,sa,sb",
    [((7,), (7, 5), 0, None), ((7,), (7, 5), None, 1), ((6, 7), (7,), 0, None), ((6, 7), (7,), 1, 0),
     ((3, 6, 4), (3, 4, 5), 0, None), ((3, 6, 4), (3, 4, 5), 1, None), ((3, 6, 4), (4, 5), None, 1)],
)
def test_matmul_vector_and_batched(a_shape, b_shape, sa, sb):
    a_np, b_np = _rng(4).standard_normal(a_shape), _rng(5).standard_normal(b_shape)
    (ra, a), (rb, b) = _both(a_np, sa), _both(b_np, sb)
    check(ht.matmul(a, b), ref.matmul(ra, rb), a_np @ b_np, **F64)


def test_matmul_integer_and_rmatmul():
    a_np = _rng(6).integers(-5, 5, (9, 4)).astype(np.int64)
    b_np = _rng(7).integers(-5, 5, (4, 3)).astype(np.int64)
    (ra, a), (rb, b) = _both(a_np, 0), _both(b_np, None)
    check(a @ b, ra @ rb, a_np @ b_np, rtol=0, atol=0)
    np.testing.assert_array_equal(ht.array(b_np).__rmatmul__(a_np).numpy(), a_np @ b_np)


@pytest.mark.parametrize("sb", [None, 0])
@pytest.mark.parametrize("sa", [None, 0])
def test_dot_vdot_vecdot_projection(sa, sb):
    x_np, y_np = _rng(8).standard_normal(13), _rng(9).standard_normal(13)
    (rx, x), (ry, y) = _both(x_np, sa), _both(y_np, sb)
    check(ht.dot(x, y), ref.dot(rx, ry), np.dot(x_np, y_np), **F64)
    check(ht.vdot(x, y), ref.vdot(rx, ry), np.vdot(x_np, y_np), **F64)
    check(ht.vecdot(x, y), ref.vecdot(rx, ry), np.dot(x_np, y_np), **F64)
    check(ht.projection(x, y), ref.projection(rx, ry), np.dot(x_np, y_np) / np.dot(y_np, y_np) * y_np, **F64)
    m_np = _rng(10).standard_normal((13, 6))
    rm, m = _both(m_np, sa)
    check(ht.dot(ht.transpose(m), y), ref.dot(ref.transpose(rm), ry), m_np.T @ y_np, **F64)
    out = ht.zeros((), dtype=ht.float64)
    assert ht.dot(x, y, out=out) is out
    np.testing.assert_allclose(out.numpy(), np.dot(x_np, y_np), **F64)


@pytest.mark.parametrize("split", SPLITS)
@pytest.mark.parametrize("axis", [0, 1, -1])
def test_vecdot_matrix_and_complex(axis, split):
    a_np = _rng(11).standard_normal((7, 5)) + 1j * _rng(12).standard_normal((7, 5))
    b_np = _rng(13).standard_normal((7, 5))
    (ra, a), (rb, b) = _both(a_np, split), _both(b_np, split)
    expected = np.sum(np.conj(a_np) * b_np, axis=axis)
    check(ht.vecdot(a, b, axis=axis), ref.vecdot(ra, rb, axis=axis), expected, **F64)
    check(ht.vecdot(a, b, axis=axis, keepdims=True), ref.vecdot(ra, rb, axis=axis, keepdims=True),
          np.expand_dims(expected, axis), **F64)


@pytest.mark.parametrize("sb", [None, 0])
@pytest.mark.parametrize("sa", [None, 0])
def test_outer(sa, sb):
    x_np, y_np = _rng(14).standard_normal(9), _rng(15).standard_normal(5)
    (rx, x), (ry, y) = _both(x_np, sa), _both(y_np, sb)
    check(ht.outer(x, y), ref.outer(rx, ry), np.outer(x_np, y_np), **F64)
    check(ht.outer(x, y, split=1), ref.outer(rx, ry, split=1), np.outer(x_np, y_np), **F64)
    out = ht.zeros((9, 5), dtype=ht.float64)
    assert ht.outer(x, y, out=out) is out
    np.testing.assert_allclose(out.numpy(), np.outer(x_np, y_np), **F64)


@pytest.mark.parametrize("split", [None, 0, 1])
def test_cross(split):
    a_np, b_np = _rng(16).standard_normal((8, 3)), _rng(17).standard_normal((8, 3))
    (ra, a), (rb, b) = _both(a_np, split), _both(b_np, split)
    check(ht.cross(a, b), ref.cross(ra, rb), np.cross(a_np, b_np), **F64)
    t_np, w_np = _rng(18).standard_normal((3, 6)), _rng(19).standard_normal((3, 6))
    (rt, t), (rw, w) = _both(t_np, split), _both(w_np, split)
    check(ht.cross(t, w, axis=0), ref.cross(rt, rw, axis=0), np.cross(t_np, w_np, axis=0), **F64)
    with pytest.raises(ValueError):
        ht.cross(ht.array(np.ones((4, 2))), ht.array(np.ones((4, 2))))


@pytest.mark.parametrize(
    "subscripts,shapes,splits",
    [("ij,jk->ik", [(6, 4), (4, 5)], [0, None]), ("ij,jk->ik", [(6, 4), (4, 5)], [1, 0]),
     ("ij,jk", [(6, 4), (4, 5)], [None, 1]), ("bij,bjk->bik", [(3, 6, 4), (3, 4, 5)], [0, None]),
     ("ii->i", [(5, 5)], [0]), ("ij->", [(6, 4)], [1]), ("...ij,...jk->...ik", [(3, 6, 4), (3, 4, 5)], [0, None])],
)
def test_einsum(subscripts, shapes, splits):
    arrays = [_rng(20 + i).standard_normal(s) for i, s in enumerate(shapes)]
    mine = ht.einsum(subscripts, *(ht.array(x, split=s) for x, s in zip(arrays, splits)))
    theirs = ref.einsum(subscripts, *(ref.array(x, split=s) for x, s in zip(arrays, splits)))
    check(mine, theirs, np.einsum(subscripts, *arrays), **F64)


def test_einsum_mixed_operands_and_validation():
    x_np, w = _rng(27).standard_normal((6, 4)), _rng(28).standard_normal(4)
    check(ht.einsum("ij,j->i", ht.array(x_np, split=0), w), ref.einsum("ij,j->i", ref.array(x_np, split=0), w),
          x_np @ w, **F64)
    with pytest.raises(TypeError):
        ht.einsum("ij->i", x_np)
    with pytest.raises(NotImplementedError):
        ht.einsum("ij->i", ht.array(x_np), out=ht.zeros(6))


# ---------------------------------------------------------------------------
# trace, triangles, norms
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("split", SPLITS)
@pytest.mark.parametrize("shape", [(7, 5), (6, 6)])
def test_trace_tril_triu(shape, split):
    x_np = _rng(30).standard_normal(shape)
    rx, x = _both(x_np, split)
    for offset in (-2, 0, 1):
        assert ht.trace(x, offset) == pytest.approx(ref.trace(rx, offset), rel=1e-12)
        assert ht.trace(x, offset) == pytest.approx(np.trace(x_np, offset), rel=1e-12)
    for k in (-3, -1, 0, 2):
        check(ht.tril(x, k), ref.tril(rx, k), np.tril(x_np, k), rtol=0, atol=0)
        check(ht.triu(x, k), ref.triu(rx, k), np.triu(x_np, k), rtol=0, atol=0)
    with pytest.raises(ValueError):
        ht.trace(x, out=ht.zeros(1))


@pytest.mark.parametrize("split", [None, 0, 1, 2])
def test_trace_and_triangles_of_3d(split):
    x_np = _rng(31).standard_normal((4, 5, 6))
    rx, x = _both(x_np, split)
    check(ht.trace(x, axis1=1, axis2=2), ref.trace(rx, axis1=1, axis2=2), np.trace(x_np, axis1=1, axis2=2), **F64)
    check(ht.tril(x, 1), ref.tril(rx, 1), np.tril(x_np, 1), rtol=0, atol=0)
    check(ht.triu(x, -1), ref.triu(rx, -1), np.triu(x_np, -1), rtol=0, atol=0)


@pytest.mark.parametrize("split", [None, 0])
def test_tril_triu_expand_a_vector(split):
    v_np = _rng(32).standard_normal(6)
    rv, v = _both(v_np, split)
    check(ht.tril(v), ref.tril(rv), np.tril(np.broadcast_to(v_np, (6, 6))), rtol=0, atol=0)
    check(ht.triu(v, 1), ref.triu(rv, 1), np.triu(np.broadcast_to(v_np, (6, 6)), 1), rtol=0, atol=0)


@pytest.mark.parametrize("split", SPLITS)
@pytest.mark.parametrize("ord", [None, "fro", "nuc", 1, -1, 2, -2, np.inf, -np.inf])
def test_matrix_norm(ord, split):
    x_np = _rng(33).standard_normal((7, 5))
    rx, x = _both(x_np, split)
    check(ht.linalg.matrix_norm(x, ord=ord), ref.linalg.matrix_norm(rx, ord=ord), np.linalg.norm(x_np, ord=ord), **F64)
    check(ht.norm(x, ord=ord), ref.norm(rx, ord=ord), np.linalg.norm(x_np, ord=ord), **F64)
    if ord in (None, "fro", 1, np.inf):
        check(ht.linalg.matrix_norm(x, ord=ord, keepdims=True), ref.linalg.matrix_norm(rx, ord=ord, keepdims=True),
              np.linalg.norm(x_np, ord=ord, keepdims=True), **F64)


@pytest.mark.parametrize("split", SPLITS)
@pytest.mark.parametrize("ord", [None, 1, 2, 3, 0, np.inf, -np.inf])
@pytest.mark.parametrize("axis", [0, 1])
def test_vector_norm(axis, ord, split):
    x_np = _rng(34).standard_normal((7, 5))
    rx, x = _both(x_np, split)
    expected = np.linalg.norm(x_np, ord=ord, axis=axis)
    check(ht.linalg.vector_norm(x, axis=axis, ord=ord), ref.linalg.vector_norm(rx, axis=axis, ord=ord), expected, **F64)
    check(ht.norm(x, axis=axis, ord=ord), ref.norm(rx, axis=axis, ord=ord), expected, **F64)


@pytest.mark.parametrize("split", [None, 0])
def test_norm_defaults(split):
    x_np = _rng(35).standard_normal((4, 5, 3))
    rx, x = _both(x_np, split)
    check(ht.norm(x), ref.norm(rx), np.linalg.norm(x_np), **F64)
    check(ht.norm(x, axis=(1, 2)), ref.norm(rx, axis=(1, 2)), np.linalg.norm(x_np, axis=(1, 2)), **F64)
    check(ht.linalg.vector_norm(ht.array(np.arange(5), split=split)), ref.linalg.vector_norm(ref.array(np.arange(5), split=split)),
          np.linalg.norm(np.arange(5)), rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------------------
# det, slogdet, inv, matrix_rank, cholesky
# ---------------------------------------------------------------------------
def _well_conditioned(n, seed, complex_=False):
    x = _rng(seed).standard_normal((n, n)) + n * np.eye(n)
    if complex_:
        x = x + 1j * _rng(seed + 1).standard_normal((n, n))
    return x


def _spd(n, seed):
    b = _rng(seed).standard_normal((n, n))
    return b @ b.T + n * np.eye(n)


@pytest.mark.parametrize("split", SPLITS)
@pytest.mark.parametrize("n", [5, 2 * P + 1])
def test_det_slogdet_inv(n, split):
    x_np = _well_conditioned(n, 40 + n)
    x_np[[0, 1]] = x_np[[1, 0]]  # a negative determinant
    rx, x = _both(x_np, split)
    check(ht.linalg.det(x), ref.linalg.det(rx), np.linalg.det(x_np), **F64)
    sign, logabs = np.linalg.slogdet(x_np)
    check(tuple(ht.linalg.slogdet(x)), tuple(ref.linalg.slogdet(rx)), (sign, logabs), **F64)
    check(ht.linalg.inv(x), ref.linalg.inv(rx), np.linalg.inv(x_np), **F64)


def test_det_singular_tile_falls_back_with_warning():
    n = 16
    x_np = np.roll(np.eye(n), -2, axis=1)  # the leading diagonal tile is zero
    if P == 1:
        assert float(ht.linalg.det(ht.array(x_np, split=0))) == pytest.approx(np.linalg.det(x_np))
        return
    with pytest.warns(ReplicationWarning):
        got = float(ht.linalg.det(ht.array(x_np, split=0)))
    assert got == pytest.approx(np.linalg.det(x_np), rel=1e-12)


def test_det_batched_complex_and_large_scale():
    b_np = _rng(45).standard_normal((3, 4, 4))
    rb, b = _both(b_np, 0)
    check(ht.linalg.det(b), ref.linalg.det(rb), np.linalg.det(b_np), **F64)
    c_np = _well_conditioned(6, 46, complex_=True)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", ReplicationWarning)
        check(ht.linalg.det(ht.array(c_np, split=0)), ref.linalg.det(ref.array(c_np, split=0)), np.linalg.det(c_np), **F64)
    big = 1e3 * np.eye(200)  # det overflows float64, slogdet does not
    sign, logabs = ht.linalg.slogdet(ht.array(big, split=0))
    assert float(sign) == 1.0 and float(logabs) == pytest.approx(200 * np.log(1e3), rel=1e-12)


@pytest.mark.parametrize("split", SPLITS)
def test_matrix_rank(split):
    full = _rng(47).standard_normal((9, 5))
    deficient = full[:, :3] @ _rng(48).standard_normal((3, 5))
    for x_np in (full, deficient):
        rx, x = _both(x_np, split)
        check(ht.linalg.matrix_rank(x), ref.linalg.matrix_rank(rx), np.linalg.matrix_rank(x_np), rtol=0, atol=0)
    sym = deficient.T @ deficient
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", ReplicationWarning)
        assert int(ht.linalg.matrix_rank(ht.array(sym, split=split), hermitian=True)) == 3
        assert int(ht.linalg.matrix_rank(ht.array(full, split=split), rtol=0.5)) == np.linalg.matrix_rank(full, rtol=0.5)


@pytest.mark.parametrize("split", SPLITS)
@pytest.mark.parametrize("n", [4, 2 * P + 1, 17])
def test_cholesky_reads_the_lower_triangle(n, split):
    a_np = _spd(n, 50 + n)
    stored = np.tril(a_np) + np.triu(_rng(51).standard_normal((n, n)), 1)  # garbage above
    rx, x = _both(stored, split)
    check(ht.linalg.cholesky(x), ref.linalg.cholesky(rx), np.linalg.cholesky(a_np), **F64)


@pytest.mark.parametrize("split", SPLITS)
def test_cholesky_not_positive_definite_raises(split):
    bad = np.diag([1.0, -1.0, 2.0, 3.0, 1.0])
    with pytest.raises(np.linalg.LinAlgError):
        ref.linalg.cholesky(ref.array(bad, split=split))
    with pytest.raises(np.linalg.LinAlgError):
        ht.linalg.cholesky(ht.array(bad, split=split))


def test_cholesky_complex_warns_when_distributed():
    b = _rng(52).standard_normal((5, 5)) + 1j * _rng(53).standard_normal((5, 5))
    a_np = b @ b.conj().T + 5 * np.eye(5)
    if P > 1:
        with pytest.warns(ReplicationWarning):
            got = ht.linalg.cholesky(ht.array(a_np, split=0))
    else:
        got = ht.linalg.cholesky(ht.array(a_np, split=0))
    np.testing.assert_allclose(got.numpy(), np.linalg.cholesky(a_np), **F64)


def test_factorizations_promote_integer_and_half():
    a_np = np.array([[4, 1, 0], [1, 3, 1], [0, 1, 2]])
    for dtype in ("int32", "int64", "float16", "bfloat16"):
        mine = ht.linalg.cholesky(ht.array(a_np, dtype=getattr(ht, dtype), split=0))
        theirs = ref.linalg.cholesky(ref.array(a_np, dtype=getattr(ref, dtype), split=0))
        assert mine.dtype.__name__ == theirs.dtype.__name__
        np.testing.assert_allclose(mine.numpy(), np.linalg.cholesky(a_np), rtol=1e-6)
        np.testing.assert_allclose(ht.linalg.inv(ht.array(a_np, dtype=getattr(ht, dtype))).numpy(), np.linalg.inv(a_np), rtol=1e-5)


# ---------------------------------------------------------------------------
# the blocked scaffolding
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("n", [1, 2, 3, 5, 7, 8, 10, 13, 16, 17, 33])
def test_stage_grid_matches_the_reference(n):
    from heat_tpu.core.linalg._blocked import stage_grid

    rx, x = _both(np.eye(n), 0)
    assert _blocked.stage_grid(x) == stage_grid(rx)


def test_mirror_triangle_and_sanitize_slab():
    from heat_tpu.core.linalg import _blocked as ref_blocked

    a_np = _rng(54).standard_normal((5, 5)) + 1j * _rng(55).standard_normal((5, 5))
    for uplo in ("L", "U"):
        np.testing.assert_array_equal(
            _blocked.mirror_triangle(torch.from_numpy(a_np), uplo).numpy(),
            np.asarray(ref_blocked.mirror_triangle(a_np, uplo)),
        )
    slab = _rng(56).standard_normal((3, 7))
    for idx in (0, 2):
        mine, rows = _blocked.sanitize_slab(torch.from_numpy(slab), idx, 3, 7, 9, torch.float64)
        theirs, ref_rows = ref_blocked.sanitize_slab(slab, idx, 3, 7, 9, np.float64)
        np.testing.assert_array_equal(mine.numpy(), np.asarray(theirs))
        np.testing.assert_array_equal(rows.numpy(), np.asarray(ref_rows))


# ---------------------------------------------------------------------------
# solvers
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("lower", [False, True])
@pytest.mark.parametrize("sa", [None, 0, 1])
def test_solve_triangular_sweep(sa, lower, collectives):
    # tests/test_solve_det_fuzz.py::test_solve_sweep, held to numpy too
    rng = _rng(100 + P)
    for n in sorted({3, P + 1, 2 * P, 3 * P + 2}):
        base = rng.standard_normal((n, n)) + (n + 3) * np.eye(n)
        t_np = np.tril(base) if lower else np.triu(base)
        b_np = rng.standard_normal((n, 3))
        calls, _ = collectives
        calls.clear()
        mine = ht.linalg.solve_triangular(ht.array(t_np, split=sa), ht.array(b_np, split=0), lower=lower)
        theirs = ref.linalg.solve_triangular(ref.array(t_np, split=sa), ref.array(b_np, split=0), lower=lower)
        check(mine, theirs, np.linalg.solve(t_np, b_np), **F64)
        if sa is not None and P > 1:  # one allreduce of one solved block per stage
            assert calls.get("allreduce") == _blocked.stage_grid(ht.array(t_np, split=0))[2]


@pytest.mark.parametrize("split", [None, 0, 1])
def test_solve_triangular_vector_float32_and_complex(split):
    n = 3 * P + 1
    t_np = (np.triu(_rng(60).standard_normal((n, n))) + (n + 2) * np.eye(n)).astype(np.float32)
    b_np = _rng(61).standard_normal(n).astype(np.float32)
    (rt, t), (rb, b) = _both(t_np, split), _both(b_np, 0)
    check(ht.linalg.solve_triangular(t, b), ref.linalg.solve_triangular(rt, rb), np.linalg.solve(t_np, b_np), **F32)
    c_np = np.tril(_rng(62).standard_normal((n, n)) + 1j * _rng(63).standard_normal((n, n))) + n * np.eye(n)
    cb_np = _rng(64).standard_normal((n, 2)) + 0j
    (rc, c), (rcb, cb) = _both(c_np, split), _both(cb_np, None)
    check(ht.linalg.solve_triangular(c, cb, lower=True), ref.linalg.solve_triangular(rc, rcb, lower=True),
          np.linalg.solve(c_np, cb_np), **F64)


@pytest.mark.parametrize("sb", [None, 0])
@pytest.mark.parametrize("sa", [None, 0, 1])
def test_solve_matches_numpy(sa, sb):
    n = 2 * P + 3
    a_np = _well_conditioned(n, 65)
    for b_np in (_rng(66).standard_normal(n), _rng(67).standard_normal((n, 3))):
        (ra, a), (rb, b) = _both(a_np, sa), _both(b_np, sb)
        mine, theirs = ht.linalg.solve(a, b), ref.linalg.solve(ra, rb)
        np.testing.assert_allclose(mine.numpy(), theirs.numpy(), **F64)
        np.testing.assert_allclose(mine.numpy(), np.linalg.solve(a_np, b_np), **F64)
        assert mine.gshape == tuple(theirs.shape)


@pytest.mark.parametrize("split", [None, 0, 1])
def test_solve_singular_raises_and_validates(split):
    singular = np.zeros((6, 6))
    with pytest.raises(np.linalg.LinAlgError):
        ht.linalg.solve(ht.array(singular, split=split), ht.ones(6, dtype=ht.float64))
    with pytest.raises(ValueError):
        ht.linalg.solve(ht.ones((3, 4), split=split), ht.ones(3))
    with pytest.raises(TypeError):
        ht.linalg.solve(singular, ht.ones(6))


def test_solve_split0_stays_distributed():
    # a square split-0 operand reshards to the panel path, never a gather
    n = 4 * P
    a_np = _well_conditioned(n, 84)
    b_np = _rng(85).standard_normal(n)
    with warnings.catch_warnings():
        warnings.simplefilter("error", ReplicationWarning)
        got = ht.linalg.solve(ht.array(a_np, split=0), ht.array(b_np, split=0))
    np.testing.assert_allclose(a_np @ got.numpy(), b_np, **F64)


def test_solve_complex_distributed():
    n = 2 * P + 2
    a_np = _well_conditioned(n, 68, complex_=True)
    b_np = _rng(70).standard_normal(n) + 1j * _rng(71).standard_normal(n)
    got = ht.linalg.solve(ht.array(a_np, split=1), ht.array(b_np))
    np.testing.assert_allclose(got.numpy(), np.linalg.solve(a_np, b_np), **F64)


@pytest.mark.parametrize("split", [None, 0])
def test_cg(split):
    # tests/test_linalg.py::test_cg, in float64 so the two packages agree
    b = _rng(5).random((10, 10))
    spd = b @ b.T + 10 * np.eye(10)
    rhs = _rng(72).random(10)
    (rA, A), (rr, r) = _both(spd, split), _both(rhs, None)
    mine = ht.linalg.cg(A, r, ht.zeros(10, dtype=ht.float64, split=split))
    theirs = ref.linalg.cg(rA, rr, ref.zeros(10, dtype=ref.float64, split=split))
    check(mine, theirs, np.linalg.solve(spd, rhs), **F64)
    out = ht.zeros(10, dtype=ht.float64)
    assert ht.linalg.cg(A, r, ht.zeros(10, dtype=ht.float64), out=out) is out
    with pytest.raises(TypeError):
        ht.linalg.cg(spd, rhs, None)
    with pytest.raises(RuntimeError):
        ht.linalg.cg(ht.arange(4), ht.arange(4), ht.arange(4))


@pytest.mark.parametrize("split", [None, 0, 1])
@pytest.mark.parametrize("uplo", ["L", "U"])
def test_eigh_eigvalsh(uplo, split):
    a_np = _spd(7, 73)
    stored = np.tril(a_np) if uplo == "L" else np.triu(a_np)  # one triangle
    rx, x = _both(stored, split)
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        w, v = ht.linalg.eigh(x, UPLO=uplo)
        wv = ht.linalg.eigvalsh(x, UPLO=uplo)
    assert any(issubclass(s.category, ReplicationWarning) for s in seen) == x.is_distributed()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", ReplicationWarning)
        rw, _ = ref.linalg.eigh(rx, UPLO=uplo)
        check(w, rw, np.linalg.eigvalsh(a_np), **F64)
        check(wv, ref.linalg.eigvalsh(rx, UPLO=uplo), np.linalg.eigvalsh(a_np), **F64)
    vn = v.numpy()
    np.testing.assert_allclose(a_np @ vn, vn * w.numpy(), **F64)


@pytest.mark.parametrize("split", [None, 0])
def test_lanczos_with_the_default_v0(split):
    # tests/test_linalg.py::test_lanczos: the same default v0 in both packages
    b = _rng(6).random((12, 12)).astype(np.float32)
    a_np = (b + b.T) / 2
    rx, x = _both(a_np, split)
    V, T = ht.linalg.lanczos(x, 8)
    rV, rT = ref.linalg.lanczos(rx, 8)
    check(V, rV, **F32)
    check(T, rT, **F32)
    np.testing.assert_allclose(V.numpy().T @ a_np @ V.numpy(), T.numpy(), atol=1e-4)
    V_out, T_out = ht.zeros((12, 8)), ht.zeros((8, 8))
    got = ht.linalg.lanczos(x, 8, V_out=V_out, T_out=T_out)
    assert got[0] is V_out and got[1] is T_out
    np.testing.assert_array_equal(V_out.numpy(), V.numpy())
    with pytest.raises(TypeError):
        ht.linalg.lanczos(a_np, 4)
    with pytest.raises(RuntimeError):
        ht.linalg.lanczos(ht.arange(4), 2)


# ---------------------------------------------------------------------------
# svd, lstsq, pinv
# ---------------------------------------------------------------------------
def _check_svd(res, a_np, u_split):
    u, s, vh = (t.numpy() for t in res)
    np.testing.assert_allclose(s, np.linalg.svd(a_np, compute_uv=False), **F64)
    np.testing.assert_allclose((u * s) @ vh, a_np, **F64)
    np.testing.assert_allclose(u.T @ u, np.eye(u.shape[1]), **F64)
    assert res.U.split == u_split and res.S.split is None
    check_layout(res.U)


@pytest.mark.parametrize("split", SPLITS)
@pytest.mark.parametrize("shape", [(4 * P + 3, 5), (5, 4 * P + 3)], ids=["tall", "wide"])
def test_svd_reduced(shape, split):
    a_np = _rng(80).standard_normal(shape)
    rx, x = _both(a_np, split)
    res, theirs = ht.linalg.svd(x, full_matrices=False), ref.linalg.svd(rx, full_matrices=False)
    _check_svd(res, a_np, theirs.U.split)
    check(res.S, theirs.S, **F64)
    check(ht.linalg.svd(x, compute_uv=False), ref.linalg.svd(rx, compute_uv=False), **F64)


def test_svd_full_matrices_replicated_only():
    a_np = _rng(81).standard_normal((7, 4))
    u, s, vh = ht.linalg.svd(ht.array(a_np))
    assert u.gshape == (7, 7) and vh.gshape == (4, 4)
    np.testing.assert_allclose((u.numpy()[:, :4] * s.numpy()) @ vh.numpy(), a_np, **F64)
    with pytest.raises(NotImplementedError):
        ht.linalg.svd(ht.array(a_np, split=0))
    with pytest.raises(ValueError):
        ht.linalg.svd(ht.zeros((2, 2, 2)))


@pytest.mark.parametrize("split", SPLITS)
def test_lstsq(split):
    a_np = _rng(82).standard_normal((3 * P + 7, 4))
    for b_np in (_rng(83).standard_normal(3 * P + 7), _rng(84).standard_normal((3 * P + 7, 2))):
        (ra, a), (rb, b) = _both(a_np, split), _both(b_np, 0)
        mine, theirs = ht.linalg.lstsq(a, b), ref.linalg.lstsq(ra, rb)
        expected = np.linalg.lstsq(a_np, b_np, rcond=None)[0]
        np.testing.assert_allclose(mine.numpy(), theirs.numpy(), **F64)
        np.testing.assert_allclose(mine.numpy(), expected, **F64)
    with pytest.raises(ValueError):
        ht.linalg.lstsq(ht.array(a_np.T), ht.ones(4))
    with pytest.raises(NotImplementedError):
        ht.linalg.lstsq(ht.array(a_np), ht.ones(a_np.shape[0]), rcond=1e-3)


@pytest.mark.parametrize("split", SPLITS)
@pytest.mark.parametrize("shape", [(2 * P + 5, 4), (4, 2 * P + 5)])
def test_pinv(shape, split):
    a_np = _rng(85).standard_normal(shape)
    rx, x = _both(a_np, split)
    check(ht.linalg.pinv(x), ref.linalg.pinv(rx), np.linalg.pinv(a_np), **F64)


def test_rank_deficient_pinv_cutoff():
    a_np = _rng(86).standard_normal((9, 2)) @ _rng(87).standard_normal((2, 4))
    np.testing.assert_allclose(ht.linalg.pinv(ht.array(a_np, split=0), rcond=1e-10).numpy(),
                               np.linalg.pinv(a_np, rcond=1e-10), rtol=1e-8, atol=1e-8)


# ---------------------------------------------------------------------------
# fault C10 of ROADMAP queue C: bool products as numpy gives them (exact), on
# explicit meshes of 3 and 5 shards and against the reference
# ---------------------------------------------------------------------------
def _mesh(p):
    from heat_tpu_torch.core.communication import MeshCommunication

    return MeshCommunication([torch.device("cpu")] * p)


@pytest.mark.parametrize("p", [3, 5])
@pytest.mark.parametrize("sa,sb", [(None, None), (0, None), (None, 1), (1, 0), (1, 1), (0, 0)])
def test_matmul_of_bool_is_bool(sa, sb, p):
    rng = np.random.default_rng(20261017)
    a, b = rng.random((7, 5)) < 0.3, rng.random((5, 4)) < 0.3
    mine = ht.matmul(ht.array(a, split=sa, comm=_mesh(p)), ht.array(b, split=sb, comm=_mesh(p)))
    theirs = ref.matmul(ref.array(a, split=sa), ref.array(b, split=sb))
    assert mine.dtype is ht.bool and theirs.dtype is ref.bool
    np.testing.assert_array_equal(mine.numpy(), a @ b)
    np.testing.assert_array_equal(mine.numpy(), theirs.numpy())
    check_layout(mine)


@pytest.mark.parametrize("p", [3, 5])
@pytest.mark.parametrize("split", [None, 0])
@pytest.mark.parametrize("name", ["dot", "vdot"])
def test_dot_and_vdot_of_bool_are_bool(name, split, p):
    rng = np.random.default_rng(20261017)
    for v, w in ((rng.random(11) < 0.5, rng.random(11) < 0.5), (np.zeros(11, bool), rng.random(11) < 0.5)):
        mine = getattr(ht, name)(ht.array(v, split=split, comm=_mesh(p)), ht.array(w, split=split, comm=_mesh(p)))
        assert mine.dtype is ht.bool
        assert mine.item() == getattr(np, name)(v, w)
        assert mine.item() == getattr(ref, name)(ref.array(v, split=split), ref.array(w, split=split)).item()


# ---------------------------------------------------------------------------
# fault C16 of ROADMAP queue C: vecdot with a 0-d operand raises numpy's
# ValueError, on explicit meshes of 3 and 5 shards
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("p", [3, 5])
@pytest.mark.parametrize("split", [None, 0])
def test_vecdot_with_a_scalar_operand_raises_value_error(split, p):
    x_np = np.array([1.0, 2.0, 3.0, 4.0], np.float32)
    x = ht.array(x_np, split=split, comm=_mesh(p))
    for args, np_args in (((x, 2), (x_np, 2)), ((2, x), (2, x_np)), ((x, ht.array(2.0, comm=_mesh(p))), (x_np, np.float32(2.0)))):
        with pytest.raises(ValueError):
            np.vecdot(*np_args)
        with pytest.raises(ValueError):
            ht.vecdot(*args)
    np.testing.assert_allclose(ht.vecdot(x, x).numpy(), np.vecdot(x_np, x_np), rtol=1e-6)
