"""heat_tpu_torch.linalg.qr against heat_tpu and numpy on the CPU mesh
(HEAT_TPU_TEST_DEVICES shards, 8 by default): every branch of the dispatch
(CholeskyQR2, the probe's fallback, TSQR, the split-1 panel QR, the
replicated Householder QR), ``calc_q=False``, integer and half inputs, the
probe's decision against the reference's on the same input, its unit cases,
the collectives of each schedule and the explicit replication warning.
Cases from test_qr_depth.py and test_linalg.py.

Householder implementations may choose other signs, so Q and R are compared
as Q diag(s) and diag(s) R with s = sign(diag R). Tolerances: float64 1e-10
(operands of condition number below 1e2, or 1e12 on the probe's input where
only the factorization's properties are held), float32 1e-4.
"""

import importlib
import math
import warnings

import numpy as np
import pytest
import torch

import heat_tpu as ref
import heat_tpu_torch as ht
from heat_tpu_torch.core import fusion
from heat_tpu_torch.core.sanitation import ReplicationWarning
from test_torch_parity import P, check_layout, on_cpu  # noqa: F401

qr_module = importlib.import_module("heat_tpu_torch.core.linalg.qr")
ref_qr_module = importlib.import_module("heat_tpu.core.linalg.qr")

F64 = dict(rtol=1e-10, atol=1e-10)
F32 = dict(rtol=1e-4, atol=1e-4)

TALL = (16 * P + 1, 6)  # ragged rows at p > 1, ceil(m/p) >= n at every mesh
SQUARE = (2 * P + 3, 2 * P + 3)
WIDE = (4, 2 * P + 7)


def _tall(shape=TALL, seed=0, cond=None, dtype=np.float64):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal(shape)
    if cond is not None:  # U diag(logspace) Vᵀ from orthonormal factors
        u = np.linalg.qr(a)[0]
        v = np.linalg.qr(rng.standard_normal((shape[1], shape[1])))[0]
        a = (u * np.logspace(0, -math.log10(cond), shape[1])) @ v.T
    return a.astype(dtype)


def _signed(q, r):
    """Q diag(s) and diag(s) R, s = sign(diag R) (1 where it is 0)."""
    r = np.asarray(r)
    s = np.sign(np.diagonal(r)).copy()
    s[s == 0] = 1
    return (None if q is None else np.asarray(q)[:, : s.size] * s), s[:, None] * r[: s.size]


def _numpy(x):
    return np.asarray(x.numpy())


def _poison(x: "ht.DNDarray") -> "ht.DNDarray":
    """NaN into the padding of the port's shards: a padded row or column
    that entered a Gram matrix or a local QR would show in the result."""
    if x.split is not None and x.padded:
        for s, c in zip(x.shards, x.counts_displs()[0]):
            s.narrow(x.split, c, s.shape[x.split] - c).fill_(float("nan"))
    return x


def _expected_branch(shape, split, method, well_conditioned=True):
    """The schedule heat_tpu's dispatch (qr.py:91-211) picks."""
    m, n = shape
    if method == "auto" and m >= 2 * n and n * n <= 1 << 22 and split != 1 and well_conditioned:
        return "cholqr2"
    if method == "cholqr2":
        return "cholqr2"
    if split == 0 and P > 1 and m >= n and -(-m // P) >= n:
        return "tsqr"
    if split == 1 and P > 1 and m >= n:
        return "panel"
    return "householder"


@pytest.fixture
def collectives(monkeypatch):
    """Counts of the collectives the default CPU mesh runs and the bytes put
    into them: its verbs, and those of the fused programs that run a
    schedule recorded on it (not the record-time runs on meta tensors)."""
    comm = ht.get_comm()
    calls, volume = {}, {}
    for verb in ("allgather", "allreduce", "bcast"):
        original = getattr(comm, verb)

        def note(shards, args, kwargs, _verb=verb):
            calls[_verb] = calls.get(_verb, 0) + 1
            sent = shards[kwargs.get("root", args[0] if args else 0):][:1] if _verb == "bcast" else shards
            volume[_verb] = volume.get(_verb, 0) + sum(s.numel() * s.element_size() for s in sent)

        def counted(shards, *args, _note=note, _original=original, **kwargs):
            _note(shards, args, kwargs)
            return _original(shards, *args, **kwargs)

        def in_program(self, shards, *args, _note=note, _original=getattr(fusion._ProgramComm, verb), **kwargs):
            if shards[0].device.type != "meta":
                _note(shards, args, kwargs)
            return _original(self, shards, *args, **kwargs)

        monkeypatch.setattr(comm, verb, counted)
        monkeypatch.setattr(fusion._ProgramComm, verb, in_program)
    return calls, volume


CASES = [
    ("tall", TALL, 0, "auto"),
    ("tall", TALL, None, "auto"),
    ("tall", TALL, 1, "auto"),
    ("tall", TALL, 0, "tsqr"),
    ("tall", TALL, None, "tsqr"),
    ("tall", TALL, 1, "tsqr"),
    ("tall", TALL, 0, "cholqr2"),
    ("tall", TALL, 1, "cholqr2"),
    ("even", (8 * P, 4), 0, "tsqr"),
    ("square", SQUARE, 0, "auto"),
    ("square", SQUARE, 1, "auto"),
    ("square", SQUARE, None, "auto"),
    ("wide", WIDE, 0, "auto"),
    ("wide", WIDE, 1, "auto"),
]


@pytest.mark.parametrize("label,shape,split,method", CASES, ids=[f"{c[0]}-{c[2]}-{c[3]}" for c in CASES])
def test_qr_branches_match_the_reference(label, shape, split, method):
    a_np = _tall(shape, seed=len(label) + (split or 0))
    mine_in, theirs_in = _poison(ht.array(a_np, split=split)), ref.array(a_np, split=split)
    qr_module._METHODS.clear()
    q, r = ht.linalg.qr(mine_in, method=method)
    assert dict(qr_module._METHODS) == {_expected_branch(shape, split, method): 1}
    rq, rr = ref.linalg.qr(theirs_in, method=method)
    assert (q.split, r.split) == (rq.split, rr.split)
    assert (q.gshape, r.gshape) == (tuple(rq.shape), tuple(rr.shape))
    assert q.dtype.__name__ == rq.dtype.__name__ == "float64"
    check_layout(q)
    check_layout(r)
    mine, theirs = _signed(_numpy(q), _numpy(r)), _signed(_numpy(rq), _numpy(rr))
    expected = _signed(*np.linalg.qr(a_np))
    for got, other, exact in zip(mine, theirs, expected):
        np.testing.assert_allclose(got, other, **F64)
        np.testing.assert_allclose(got, exact, **F64)
    np.testing.assert_allclose(_numpy(q) @ _numpy(r), a_np, **F64)


@pytest.mark.parametrize("split,method", [(0, "auto"), (None, "auto"), (0, "tsqr"), (1, "auto"), (1, "cholqr2")])
def test_calc_q_false_gives_the_same_r(split, method):
    a_np = _tall(seed=3)
    x = _poison(ht.array(a_np, split=split))
    q_none, r_only = ht.linalg.qr(x, calc_q=False, method=method)
    _, r = ht.linalg.qr(x, method=method)
    assert q_none is None
    assert torch.equal(r_only.larray, r.larray) and r_only.split == r.split
    theirs = ref.linalg.qr(ref.array(a_np, split=split), calc_q=False, method=method)
    assert theirs.Q is None
    np.testing.assert_allclose(_signed(None, _numpy(r_only))[1], _signed(None, _numpy(theirs.R))[1], **F64)


@pytest.mark.parametrize("split", [None, 0, 1])
@pytest.mark.parametrize("dtype", ["int32", "int64", "float16", "bfloat16"])
def test_integer_and_half_inputs_promote(dtype, split):
    # promote_types(dtype, float32): float64 for int64, float32 otherwise
    a_np = np.random.default_rng(4).integers(-4, 5, TALL).astype(np.float32)
    q, r = ht.linalg.qr(ht.array(a_np, dtype=getattr(ht, dtype), split=split))
    rq, rr = ref.linalg.qr(ref.array(a_np, dtype=getattr(ref, dtype), split=split))
    expected = "float64" if dtype == "int64" else "float32"
    assert q.dtype.__name__ == rq.dtype.__name__ == r.dtype.__name__ == rr.dtype.__name__ == expected
    for got, other in zip(_signed(_numpy(q), _numpy(r)), _signed(_numpy(rq), _numpy(rr))):
        np.testing.assert_allclose(got, other, **F32)
    np.testing.assert_allclose(_numpy(q) @ _numpy(r), a_np, **F32)


@pytest.mark.parametrize(
    "dtype,cond,ok", [(np.float64, 1e1, True), (np.float64, 1e12, False), (np.float32, 1e1, True), (np.float32, 1e5, False)]
)
@pytest.mark.parametrize("split", [None, 0])
def test_probe_decides_as_the_reference(split, dtype, cond, ok):
    a_np = _tall(seed=5, cond=cond, dtype=dtype)
    x = _poison(ht.array(a_np, split=split))
    mine = bool(qr_module._cholqr2(x, True)[2])
    theirs = bool(ref_qr_module._cholqr2_kernel(ref.array(a_np, split=split).larray, calc_q=True)[2])
    assert mine == theirs == ok


@pytest.mark.parametrize("split", [None, 0])
def test_auto_falls_back_on_the_probe_and_cholqr2_raises(split):
    a_np = _tall(seed=6, cond=1e12)
    x = _poison(ht.array(a_np, split=split))
    qr_module._METHODS.clear()
    q, r = ht.linalg.qr(x)
    assert dict(qr_module._METHODS) == {_expected_branch(TALL, split, "auto", well_conditioned=False): 1}
    qn, rn = _numpy(q), _numpy(r)
    # Householder quality on cond 1e12: backward stable and orthonormal
    np.testing.assert_allclose(qn @ rn, a_np, rtol=0, atol=1e-12)
    np.testing.assert_allclose(qn.T @ qn, np.eye(TALL[1]), rtol=0, atol=1e-12)
    rq, rr = ref.linalg.qr(ref.array(a_np, split=split))
    np.testing.assert_allclose(_numpy(rq) @ _numpy(rr), qn @ rn, rtol=0, atol=1e-12)
    with pytest.raises(ValueError, match="cholqr2 broke down"):
        ht.linalg.qr(x, method="cholqr2")
    with pytest.raises(ValueError):
        ref.linalg.qr(ref.array(a_np, split=split), method="cholqr2")
    with pytest.raises(ValueError, match="tall"):
        ht.linalg.qr(ht.array(_tall(WIDE), split=split), method="cholqr2")


def test_probe_rejects_finite_but_degraded_orthogonality():
    # test_qr_depth.py::test_probe_rejects_finite_but_degraded_orthogonality
    probe = qr_module._cholqr2_probe_ok
    n = 4
    eye = torch.eye(n)
    r_ok = torch.triu(torch.ones(n, n))
    assert bool(probe(r_ok, r_ok, eye + 1e-6, eye))
    g_bad = eye.clone()
    g_bad[0, 1] = 0.6
    assert not bool(probe(r_ok, r_ok, g_bad, eye))
    r_nan = r_ok.clone()
    r_nan[0, 0] = float("nan")
    assert not bool(probe(r_nan, r_ok, eye, eye))
    assert not bool(probe(r_ok, r_nan, eye, eye))


@pytest.mark.parametrize("method", ["tsqr", "cholqr2", "panel"])
def test_schedules_move_what_the_reference_moves(method, collectives):
    # tsqr: one allgather of the p (n, n) R factors, never the operand;
    # cholqr2: one allreduce of an (n, n) Gram per pass; the panel QR: one
    # (m, c) Q panel broadcast per panel
    m, n = TALL
    split = 1 if method == "panel" else 0
    x = _poison(ht.array(_tall(seed=7), split=split))
    calls, volume = collectives
    calls.clear()
    volume.clear()
    q, r = ht.linalg.qr(x, method="auto" if method == "panel" else method)
    r.numpy()  # a recorded schedule runs at the read
    if P == 1:
        assert calls == {}
    elif method == "tsqr":
        assert calls == {"allgather": 1} and volume["allgather"] == P * n * n * 8
        pad = x.shards[0].shape[0] * P - m
        counts = x.counts_displs()[0]
        for s, c in zip(q.shards, counts):  # zero Q rows where the padding was
            assert bool((s[c:] == 0).all())
        assert pad >= 0
    elif method == "cholqr2":
        assert calls == {"allreduce": 2} and volume["allreduce"] == 2 * P * n * n * 8
    else:
        c = x.shards[0].shape[1]
        assert calls == {"bcast": P} and volume["bcast"] == P * m * c * 8


@pytest.mark.parametrize("split", [0, 1])
def test_replicated_fallback_warns_above_its_size(split, monkeypatch):
    a_np = np.random.default_rng(2).standard_normal((P, 3 * P))
    monkeypatch.setattr(qr_module, "_REPLICATED_MAX_ELEMENTS", 10)
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        q, r = ht.linalg.qr(ht.array(a_np, split=split))
    warned = any(issubclass(w.category, ReplicationWarning) for w in seen)
    assert warned == (P > 1 and a_np.size > 10)
    np.testing.assert_allclose(_numpy(q) @ _numpy(r), a_np, **F64)


@pytest.mark.parametrize("split", [None, 0, 1])
def test_complex_operands_are_unitary(split):
    rng = np.random.default_rng(8)
    for shape in (TALL, (3 * P + 2, 2 * P + 1)):
        a_np = rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
        q, r = ht.linalg.qr(ht.array(a_np, split=split))
        qn, rn = _numpy(q), _numpy(r)
        assert q.dtype.__name__ == "complex128"
        np.testing.assert_allclose(qn @ rn, a_np, **F64)
        np.testing.assert_allclose(qn.conj().T @ qn, np.eye(shape[1]), **F64)
        assert np.allclose(np.tril(rn, -1), 0)


def test_validation_and_method_binding():
    x = ht.array(_tall(), split=0)
    with pytest.raises(ValueError):
        ht.linalg.qr(x, method="householder")
    with pytest.raises(ValueError):
        ht.linalg.qr(ht.ones(5))
    with pytest.raises(TypeError):
        ht.linalg.qr(_tall())
    q, r = x.qr()
    np.testing.assert_allclose(_numpy(q) @ _numpy(r), _tall(), **F64)
