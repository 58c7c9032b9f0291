"""heat_tpu_torch.core.fusion, the eager fusion recorder, against heat_tpu's
with its collective nodes off (tests/test_eager_chain.py: TestFusionCache
and TestEagerChainLayout; tests/test_fused_collectives.py::
TestEscapeHatches). CPU only. The collective nodes and the batching have
their own file, test_torch_fused_collectives.py.

The same numpy inputs, made from a seed, go through both packages on
meshes of 1, 3 and 5 shards, each with its recorder on and under
``fusion.collectives_disabled()`` (the reference's batching branch calls
``jax.core.trace_state_clean()``, which this jax lacks):

* the counts are held exactly: dispatches per engine (fused and eager),
  the reasons of the ops that did not defer, the forcing points with their
  chain depths and compiles, the program builds of a warm loop (none), the
  retrace warning after ``HEAT_TPU_TELEMETRY_RETRACE_WARN`` layouts of one
  op family, the keys of ``cache_stats()``;
* values: against heat_tpu at the parity harness's tolerance (float32
  reductions 1e-5 relative: the sums run in other orders); against the
  port's own recorder turned off bit for bit, since on the CPU a program is
  its plain GraphModule, the eager engines' ops in their order.
"""

from __future__ import annotations

import os
import subprocess
import sys
import tempfile
import warnings

import jax
import numpy as np
import pytest
import torch

import heat_tpu as ref
import heat_tpu_torch as ht
from heat_tpu.core import telemetry as ref_tel
from heat_tpu.core.communication import MeshCommunication as RefMesh
from heat_tpu_torch.core import fusion
from heat_tpu_torch.core import telemetry as tel
from heat_tpu_torch.core.communication import MeshCommunication
from test_torch_parity import REDUCTION, on_cpu  # noqa: F401

MESHES = [1, 3, 5]
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def recorders(on_cpu):  # noqa: F811 - the harness's fixture, first
    """Both recorders on without their collective nodes, clean caches,
    telemetry at mode 1; restored after."""
    was = ref.fusion.set_enabled(True), ref.fusion.set_collectives_enabled(False), fusion.set_enabled(True)
    mine_collectives = fusion.set_collectives_enabled(False)
    modes = tel.set_mode(1), ref_tel.set_mode(1)
    ref.fusion.clear_cache()
    fusion.clear_cache()
    tel.reset()
    ref_tel.reset()
    yield
    ref.fusion.set_enabled(was[0])
    ref.fusion.set_collectives_enabled(was[1])
    fusion.set_enabled(was[2])
    fusion.set_collectives_enabled(mine_collectives)
    tel.set_mode(modes[0])
    ref_tel.set_mode(modes[1])
    ref.fusion.clear_cache()
    fusion.clear_cache()
    tel.reset()
    ref_tel.reset()


def _pair(p):
    """(port mesh, reference mesh) of p shards (capped at the JAX CPU mesh)."""
    p = min(p, len(jax.devices()))
    return MeshCommunication([torch.device("cpu")] * p), RefMesh(jax.devices()[:p])


def _rows(p: int) -> int:
    """A split length that is ragged over p > 1 shards."""
    return 4 * p + 1 if p > 1 else 5


def _fusion(pkg):
    """A package's recorder module."""
    return fusion if pkg is ht else ref.fusion


def _data(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _ten_op_chain(pkg, a, b):
    """The representative 10-op pipeline (9 elementwise ops, 1 reduction)."""
    c = (a + b) * 2.0
    c = pkg.exp(c)
    c = c - b
    d = pkg.abs(c)
    e = d + a
    f = pkg.sqrt(pkg.abs(e))
    g = f / (d + 1.0)
    h = g * b
    return pkg.sum(h)


def _script(pkg, comm, p):
    """Binary, local, reduce and cum ops, casts, an ``out=`` buffer and a
    broadcast of a replicated row, forced at ``numpy()``, indexing and
    ``print``. Returns the values read."""
    n = _rows(p)
    a = pkg.array(_data((n, 4), 0), split=0, comm=comm)
    b = pkg.array(_data((n, 4), 1), split=0, comm=comm)
    d = pkg.exp(a * 2.0 + b) - b
    e = pkg.sqrt(pkg.abs(d))
    outs = [
        pkg.sum(e), pkg.sum(e, axis=0), pkg.sum(e, axis=1), pkg.mean(e), pkg.var(e, axis=0), pkg.std(e),
        pkg.cumsum(e, axis=0), pkg.cumprod(e, axis=1), e.astype(pkg.float64), pkg.max(e, axis=0), pkg.min(e),
        a + pkg.array(_data((4,), 2), comm=comm), (a * 3) + 1,
    ]
    pkg.add(a, b, out=pkg.zeros_like(a))
    values = [o.numpy() for o in outs]
    str(d)
    e[1]
    return values


# ---------------------------------------------------------------------------
# counts, exactly
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("p", MESHES)
def test_dispatches_unfused_reasons_and_forcing_points_match_heat_tpu(p):
    mine, theirs = _pair(p)
    got = _script(ht, mine, mine.size)
    want = _script(ref, theirs, mine.size)
    ragged = mine.size > 1  # then the replicated row's broadcast is a padded one
    assert tel.dispatches() == ref_tel.dispatches()
    assert tel.dispatches()["binary"] == {"fused": 5, "eager": 2} if ragged else {"fused": 6, "eager": 1}
    reasons = {"out=": 1, "padded_broadcast": 1} if ragged else {"out=": 1}
    assert tel.unfused_reasons() == ref_tel.unfused_reasons() == {"binary": reasons}
    assert tel.forcing_points() == ref_tel.forcing_points()
    assert set(tel.forcing_points()) == {"larray", "print", "indexing"}
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, **REDUCTION["float32"])


@pytest.mark.parametrize("p", MESHES)
def test_the_eager_leg_counts_fusion_off_as_heat_tpu(p):
    mine, theirs = _pair(p)
    with fusion.disabled(), ref.fusion.disabled():
        _script(ht, mine, mine.size)
        _script(ref, theirs, mine.size)
    assert tel.dispatches() == ref_tel.dispatches()
    assert all(rec["fused"] == 0 for rec in tel.dispatches().values())
    assert tel.unfused_reasons() == ref_tel.unfused_reasons()
    assert tel.unfused_reasons()["binary"] == {"fusion_off": 6, "out=": 1}  # checked before the layout
    assert tel.forcing_points() == ref_tel.forcing_points() == {}


@pytest.mark.parametrize("p", MESHES)
def test_ten_op_chain_compiles_once_per_signature(p):
    mine, theirs = _pair(p)
    n = 8 * mine.size
    for pkg, comm, stats in ((ht, mine, fusion.cache_stats), (ref, theirs, ref.fusion.cache_stats)):
        a, b = (pkg.array(_data((n, 4), s), split=0, comm=comm) for s in (0, 100))
        total = _ten_op_chain(pkg, a, b)
        assert _fusion(pkg).is_deferred(total)
        float(total.larray)
        compiles = stats()["compiles"]
        for seed in range(1, 4):
            a, b = (pkg.array(_data((n, 4), seed + s), split=0, comm=comm) for s in (0, 100))
            float(_ten_op_chain(pkg, a, b).larray)
        assert stats()["compiles"] == compiles == 1
    assert fusion.cache_stats()["hits"] == ref.fusion.cache_stats()["hits"] == 3
    assert tel.forcing_points() == ref_tel.forcing_points()
    assert set(fusion.cache_stats()) == set(ref.fusion.cache_stats())


@pytest.mark.parametrize("p", MESHES)
def test_the_retrace_warning_fires_after_the_same_number_of_layouts(p, monkeypatch):
    mine, theirs = _pair(p)
    for t in (tel, ref_tel):
        monkeypatch.setattr(t, "_RETRACE_WARN_AFTER", 3)
    for pkg, comm, t in ((ht, mine, tel), (ref, theirs, ref_tel)):
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            for rows in range(1, 5):
                x = pkg.array(_data((rows * mine.size, 2), rows), split=0, comm=comm)
                (pkg.exp(x) + 1.0).numpy()
        fired = [w for w in caught if issubclass(w.category, t.RetraceWarning)]
        assert len(fired) == 1, [str(w.message) for w in caught]
    assert sorted(tel.retraces().values(), key=str) == sorted(ref_tel.retraces().values(), key=str)
    (rec,) = tel.retraces().values()
    assert rec == {"misses": 4, "distinct_shapes": 3, "warned": True}


@pytest.mark.parametrize("p", MESHES)
def test_k_reductions_stay_one_chain_and_cost_one_sync_each_read(p):
    mine, theirs = _pair(p)
    n = 8 * mine.size
    a_np = _data((n,), 11)
    for pkg, comm, t in ((ht, mine, tel), (ref, theirs, ref_tel)):
        a = pkg.array(a_np, split=0, comm=comm)
        combo = pkg.mean(a) + pkg.std(a) + pkg.sum(a * a)
        assert _fusion(pkg).is_deferred(combo)
        np.testing.assert_allclose(
            float(combo.larray), a_np.mean() + a_np.std() + (a_np * a_np).sum(), rtol=1e-4
        )
        t.reset()
        m, v, s = pkg.mean(a), pkg.var(a), pkg.std(a)
        float(m.item()), float(v.item()), float(s.item())
        stats = t.async_forcing()
        assert stats["multi_root_batches"] == 0 and stats["dispatches"] == 3
        assert stats["blocking_syncs"] == {"item": 3}


# ---------------------------------------------------------------------------
# values and layout
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("p", MESHES)
def test_fused_results_equal_the_eager_engines_bit_for_bit(p):
    mine, _ = _pair(p)
    fused = _script(ht, mine, mine.size)
    assert fusion.cache_stats()["compiles"] > 0
    with fusion.disabled():
        eager = _script(ht, mine, mine.size)
    for f, e in zip(fused, eager):
        assert f.dtype == e.dtype and np.array_equal(f, e, equal_nan=True)


@pytest.mark.parametrize("p", MESHES)
def test_ragged_chain_keeps_padding_in_padding_and_matches_heat_tpu(p):
    mine, theirs = _pair(p)
    p = mine.size
    n = _rows(p)
    a_np, b_np = _data((n, 5), 7), _data((n, 5), 8)

    def chain(pkg, a, b):
        c = pkg.exp((a + b) * 0.5) - b
        d = pkg.sqrt(pkg.abs(c)) + 1.0
        return d, pkg.sum(d, axis=0), pkg.sum(d, axis=1)

    d_f, cross_f, keep_f = chain(ht, ht.array(a_np, split=0, comm=mine), ht.array(b_np, split=0, comm=mine))
    assert fusion.is_deferred(d_f) and fusion.is_deferred(cross_f)
    block = -(-n // p)
    assert tuple(d_f.parray.shape) == (block * p, 5)  # the physical rows, padding kept
    assert all(tuple(s.shape) == (block, 5) for s in d_f.shards)
    with fusion.disabled():
        d_e, cross_e, keep_e = chain(ht, ht.array(a_np, split=0, comm=mine), ht.array(b_np, split=0, comm=mine))
        assert not fusion.is_deferred(d_e)
    for f, e in ((d_f, d_e), (cross_f, cross_e), (keep_f, keep_e)):
        assert np.array_equal(f.numpy(), e.numpy()) and f.split == e.split
    rd, rc, rk = chain(ref, ref.array(a_np, split=0, comm=theirs), ref.array(b_np, split=0, comm=theirs))
    for f, r in ((d_f, rd), (cross_f, rc), (keep_f, rk)):
        np.testing.assert_allclose(f.numpy(), r.numpy(), **REDUCTION["float32"])
        assert f.split == r.split


@pytest.mark.parametrize("p", MESHES)
def test_a_split_reduction_on_shards_equals_one_shard(p):
    mine, _ = _pair(p)
    one = MeshCommunication([torch.device("cpu")])
    x_np = _data((_rows(mine.size), 6), 3)
    got = ht.sum(ht.abs(ht.array(x_np, split=0, comm=mine) * 2.0 - 1.0), axis=1)
    want = ht.sum(ht.abs(ht.array(x_np, split=0, comm=one) * 2.0 - 1.0), axis=1)
    assert np.array_equal(got.numpy(), want.numpy())


@pytest.mark.parametrize("p", MESHES)
def test_broadcasts_casts_and_scans_match_the_eager_engines(p):
    mine, _ = _pair(p)
    n = 4 * mine.size

    def run():
        a = ht.array(_data((n, 4), 20), split=0, comm=mine)
        rows = ht.array(_data((1, 4), 21), split=0, comm=mine)
        whole = ht.array(_data((n, 4), 22), comm=mine)
        cols = ht.array(_data((n, 4), 23), split=1, comm=mine)
        ints = ht.array(np.arange(n * 4, dtype=np.int32).reshape(n, 4), split=0, comm=mine)
        outs = [
            a + ht.array(_data((4,), 24), comm=mine),  # a replicated row, whole to every shard
            a * rows,  # a one-row split operand, gathered
            whole - a,  # a replicated operand cut into blocks
            cols * 2.0 + 1.0,  # split along axis 1
            ht.exp(ints),  # the local engine's promotion
            ht.sum(ints, axis=0) + 1,
            ht.cumsum(a, axis=0, dtype=ht.float64),
            ht.cumsum(cols, axis=1),
            (a > 0.0).astype(ht.float32) * a,
            ht.mean(whole, axis=0),
        ]
        return [o.numpy() for o in outs]

    fused = run()
    with fusion.disabled():
        eager = run()
    for f, e in zip(fused, eager):
        assert f.dtype == e.dtype and np.array_equal(f, e)


def _leaves_of(sig) -> list:
    """CPU tensors for a signature's leaves, of their shapes, strides and
    dtypes, with values in [0.5, 2)."""
    gen = torch.Generator().manual_seed(46)
    flat = []
    for e in sig:
        if e[0] == "L":
            for _ in range(e[1]):
                t = torch.empty_strided(e[2], e[5], dtype=e[3])
                if t.dtype.is_floating_point or t.dtype.is_complex:
                    t.copy_(torch.rand(e[2], generator=gen) * 1.5 + 0.5)
                else:
                    t.fill_(True if t.dtype == torch.bool else 3)
                flat.append(t)
    return flat


@pytest.mark.parametrize("p", [1, 3])
def test_every_recorded_program_traces_whole_under_dynamo(p):
    """On the card each program runs through ``torch.compile(fullgraph=
    True)``, where a graph break degrades it: Dynamo's tracing, with its
    eager backend (no Inductor), runs here on the programs of the engines'
    ops and of the collective nodes (reshards, schedules over the shard
    list, matmul, multi-output nodes, batched roots), and gives the plain
    module's result bit for bit."""
    import torch._dynamo

    mine, _ = _pair(p)
    n = _rows(mine.size)
    _script(ht, mine, mine.size)
    x = ht.array(_data((n, 4), 47), split=0, comm=mine)
    xi = ht.array(np.arange(n * 4, dtype=np.int32).reshape(n, 4) % 7 + 1, split=0, comm=mine)
    xb = xi > 3
    outs = [
        ht.mean(x), ht.mean(x, axis=0), ht.var(x, axis=0), ht.var(x, axis=1), ht.std(x), ht.mean(xi, axis=0),
        xi / xi, ht.copysign(xi, x), ht.logaddexp(xi, xi), ht.angle(xi), ht.prod(x, axis=0),
        ht.cumprod(x, axis=0), ht.all(xb, axis=0), ht.any(xb), ht.maximum(x, x * 2.0), ht.clip(x, 0.0, 1.0),
        ht.round(x, 2), ht.floordiv(xi, 2), ht.mod(xi, 3),
    ]
    assert all(fusion.is_deferred(o) for o in outs)
    for o in outs:
        o.shards
    prev = fusion.set_collectives_enabled(True)
    try:
        # the collective nodes: a reshard, schedules over the shard list
        # (argmax, the halo exchange and the convolution, TSQR, the blocked
        # solve), a matmul, a multi-output node (CholQR2) and a batch of
        # live roots (the three moments)
        y = x * 2.0
        y.resplit_(1)
        sq = ht.array(np.triu(_data((n, n), 51)) + n * np.eye(n, dtype=np.float32), split=0, comm=mine) * 1.0
        sig_in = ht.array(_data((6 * mine.size + 1,), 52), split=0, comm=mine) * 1.0
        collective = [
            y, ht.resplit(x * 3.0, None), ht.argmax(x * 1.0, axis=0), ht.argmin(x * 1.0, axis=1),
            ht.matmul(x * 1.0, ht.array(_data((4, 3), 53), split=1, comm=mine)),
            ht.matmul(ht.resplit(x * 1.0, 1), ht.array(_data((4, 2), 54), split=0, comm=mine)),
            ht.linalg.solve_triangular(sq, ht.array(_data((n,), 55), split=0, comm=mine)),
            ht.convolve(sig_in, ht.array(_data((3,), 56), comm=mine)),
        ]
        if mine.size > 1:
            collective.append(ht.linalg.qr(ht.array(_data((8 * mine.size, 3), 57), split=0, comm=mine) * 1.0, method="tsqr")[0])
        assert all(fusion.is_deferred(o) for o in collective)
        for o in collective:
            o.shards
        ht.linalg.qr(ht.array(_data((8 * mine.size, 3), 58), split=0, comm=mine) * 1.0, method="cholqr2")
        m, v = ht.mean(x * 1.0), ht.var(x * 1.0)
        m.item()
        assert not fusion.is_deferred(v)
    finally:
        fusion.set_collectives_enabled(prev)
    programs = list(fusion._PROGRAMS.items())
    assert len(programs) >= len(outs) + len(collective) + 2
    families = {f for sig, _ in programs for f in fusion._family(sig)}
    expected = {"_gather_op", "_blocks_op", "apply:_arg_kernel", "apply:_matmul_kernel", "apply:_tri_solve_kernel", "_pick_op"}
    if mine.size > 1:
        expected |= {"apply:_halo_kernel", "apply:_convolve_kernel", "apply:_tsqr_kernel"}
    else:
        expected.add("apply:_convolve_whole_kernel")
    assert expected <= families, families
    assert any(len(sig[-1][1]) > 1 for sig, _ in programs)  # a batched program of several roots
    for sig, prog in programs:
        flat = _leaves_of(sig)
        got = torch.compile(prog.gm, fullgraph=True, dynamic=False, backend="eager")(*flat)
        want = prog.gm(*flat)
        assert all(torch.equal(g, w) for g, w in zip(got, want)), "/".join(fusion._family(sig))
    torch._dynamo.reset()


def test_an_op_a_dtype_does_not_support_raises_at_the_call():
    z = ht.array(_data((6, 2), 48).astype(np.complex64), split=0)
    with pytest.raises(RuntimeError):
        ht.floor(z)
    assert tel.unfused_reasons() == {"local": {"record_failed:NotImplementedError": 1}}
    assert fusion.is_deferred(ht.abs(z))


def test_small_operands_on_a_card_stay_eager_and_a_pending_chain_is_joined(monkeypatch):
    """The card's rule, with the CPU's tensors taken for a card's: ops whose
    operands are concrete and small together run eagerly with the reason
    ``small_on_card``; once a chain is pending, ops join it at any size."""
    monkeypatch.setattr(fusion, "_on_card", lambda t: True)
    monkeypatch.setattr(fusion, "_EAGER_BELOW_BYTES", 6 * 2 * 4 + 1)  # one 6 x 2 float32 array
    a_np = _data((6, 2), 49)
    x = ht.array(a_np, split=0, comm=MeshCommunication([torch.device("cpu")]))
    y = ht.exp(x) * 2.0  # 48 bytes: eager
    assert not fusion.is_deferred(y)
    assert tel.unfused_reasons() == {"local": {"small_on_card": 1}, "binary": {"small_on_card": 1}}
    z = ht.sum(x + y)  # 96 bytes together: recorded, and the sum joins the chain
    assert fusion.is_deferred(z)
    assert tel.unfused_reasons()["binary"] == {"small_on_card": 1}
    monkeypatch.undo()  # forced on the CPU: its plain module, no Inductor build
    with fusion.disabled():
        want = ht.sum(x + ht.exp(x) * 2.0)
    assert np.array_equal(z.numpy(), want.numpy())


def test_a_program_of_one_op_has_nothing_to_fuse():
    x = ht.array(_data((6, 2), 50), split=0, comm=MeshCommunication([torch.device("cpu")] * 3))
    one, two = ht.sum(x, axis=0), ht.exp(x) + 1.0  # a split reduction: un-pad views and one op
    progs = [fusion._Program(fusion._signature(y._payload)[0]) for y in (one, two)]
    assert [p.fuses for p in progs] == [False, True]


def test_a_padded_broadcast_runs_eagerly_with_its_reason():
    mine, theirs = _pair(3)
    for pkg, comm in ((ht, mine), (ref, theirs)):
        a = pkg.array(_data((7, 4), 30), split=0, comm=comm)
        b = pkg.array(_data((7, 1), 31), comm=comm)
        (a + b).numpy()
    expected = {"binary": {"padded_broadcast": 1}} if mine.size > 1 else {}  # 7 rows pad over 3 shards
    assert tel.unfused_reasons() == ref_tel.unfused_reasons() == expected


@pytest.mark.parametrize("p", MESHES)
def test_every_forcing_point_materializes_the_chain(p):
    mine, _ = _pair(p)
    n = 4 * mine.size
    a_np = _data((n, 3), 9)
    expect = np.exp(a_np * 0.25) + 1.0

    def chain():
        return ht.exp(ht.array(a_np, split=0, comm=mine) * 0.25) + 1.0

    x = chain()
    assert fusion.is_deferred(x)
    assert "DNDarray" in str(x)
    assert not fusion.is_deferred(x)
    np.testing.assert_allclose(x.numpy(), expect, rtol=1e-6)
    x = chain()
    row = x[1]
    assert not fusion.is_deferred(x)
    np.testing.assert_allclose(row.numpy(), expect[1], rtol=1e-6)
    x = chain()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "chain.npy")
        ht.save_npy(x, path)
        assert not fusion.is_deferred(x)
        np.testing.assert_allclose(np.load(path), expect, rtol=1e-6)
    x = chain()
    x.resplit_(1)  # a collective: it forces the chain
    assert not fusion.is_deferred(x) and x.split == 1
    np.testing.assert_allclose(x.numpy(), expect, rtol=1e-6)
    x = chain()
    y = x.astype(ht.float64)  # a cast of a pending chain records a node
    assert fusion.is_deferred(x) and fusion.is_deferred(y)
    np.testing.assert_allclose(y.numpy(), expect.astype(np.float64), rtol=1e-6)
    assert {"print", "indexing", "io", "collective", "larray"} <= set(tel.forcing_points())


def test_forcing_points_of_the_io_and_collective_seams_match_heat_tpu():
    mine, theirs = _pair(3)
    for pkg, comm in ((ht, mine), (ref, theirs)):
        x = pkg.exp(pkg.array(_data((12, 3), 12), split=0, comm=comm) * 0.5)
        with tempfile.TemporaryDirectory() as tmp:
            pkg.save_npy(x, os.path.join(tmp, "x.npy"))
        y = pkg.abs(pkg.array(_data((12, 3), 13), split=0, comm=comm)) + 1.0
        y.resplit_(1)
    assert tel.forcing_points() == ref_tel.forcing_points()
    assert set(tel.forcing_points()) == {"io", "collective"}


def _writes_after_pending_ops(pkg, comm, split, n):
    """Chains recorded on ``x``, then ``x`` written by ``__setitem__`` and
    ``fill_diagonal``: the chains read ``x`` as it was when they were
    recorded. Returns every value read."""
    x = pkg.array(_data((n, n), 40), split=split, comm=comm)
    y = x + 1.0
    s = pkg.sum(x * x, axis=0)
    x[0] = 5.0
    w = x * 2.0
    x.fill_diagonal(-1.0)
    x[1:3, 1] = pkg.array(_data((2,), 41), comm=comm)
    return [v.numpy() for v in (y, s, w, x)]


@pytest.mark.parametrize("split", [None, 0])
@pytest.mark.parametrize("p", MESHES)
def test_a_write_after_a_pending_op_is_not_seen_by_it(p, split):
    mine, theirs = _pair(p)
    n = _rows(mine.size)
    got = _writes_after_pending_ops(ht, mine, split, n)
    want = _writes_after_pending_ops(ref, theirs, split, n)
    with fusion.disabled():
        eager = _writes_after_pending_ops(ht, mine, split, n)
    for g, w, e in zip(got, want, eager):
        np.testing.assert_allclose(g, w, **REDUCTION["float32"])
        assert np.array_equal(g, e)
    x0 = _data((n, n), 40)
    assert np.array_equal(got[0], x0 + np.float32(1.0))  # y: the values before the writes


def test_a_write_forces_only_the_chains_that_read_its_storage():
    x = ht.array(_data((4, 3), 42), split=None)
    z = ht.array(_data((4, 3), 43), split=None)
    y, u = ht.exp(x), ht.exp(z)
    tel.reset()
    x[0, 0] = 1.0
    assert not fusion.is_deferred(y) and fusion.is_deferred(u)
    assert tel.forcing_points()["indexing"]["count"] == 1
    z.fill_diagonal(0.0)
    assert not fusion.is_deferred(u)
    np.testing.assert_array_equal(u.numpy(), torch.exp(torch.from_numpy(_data((4, 3), 43))).numpy())


def test_a_write_that_bypasses_the_array_refuses_the_chain():
    x_np = _data((4, 3), 44)
    x = ht.array(x_np, split=None, comm=MeshCommunication([torch.device("cpu")]))
    y = x + 1.0
    x.larray[0, 0] = 100.0  # a torch view of the shard: the array does not see the write
    with pytest.raises(fusion.ChainInputWrittenError):
        y.numpy()
    assert fusion.is_deferred(y)
    z = x + 1.0  # recorded after the write: it reads the new value
    assert z.numpy()[0, 0] == 101.0


def test_a_deep_chain_forces_its_children_past_max_chain(monkeypatch):
    monkeypatch.setattr(fusion, "_MAX_CHAIN", 4)
    x_np = _data((6, 2), 5)
    x = ht.array(x_np, split=0)
    y = x
    for _ in range(10):
        y = y + 1.0
    assert fusion.is_deferred(y) and y._payload.depth <= 4
    np.testing.assert_allclose(y.numpy(), x_np + 10.0, rtol=1e-6)
    assert fusion.cache_stats()["forces"] > 1


def test_the_program_is_a_graphmodule_of_the_engines_ops():
    x = ht.array(_data((6, 2), 6), split=0, comm=MeshCommunication([torch.device("cpu")] * 3))
    y = ht.sum(ht.exp(x) * 2.0, axis=0)
    sig, leaves, _ = fusion._signature(y._payload)
    gm = fusion._build(sig)
    assert isinstance(gm, torch.fx.GraphModule)
    targets = [n.target.__name__ for n in gm.graph.nodes if n.op == "call_function"]
    assert targets.count("exp") == 3 and targets.count("mul") == 3  # one call per shard
    assert "across_op" in targets
    (got,) = gm(*fusion._flat(leaves))
    assert torch.equal(got, y.larray)


def test_escape_hatches():
    with fusion.disabled():
        assert not fusion.active()
        a_np = _data((10,), 10)
        m = ht.mean(ht.array(a_np, split=0) * 0.5)
        assert not fusion.is_deferred(m)
        np.testing.assert_allclose(float(m), (a_np * 0.5).mean(), rtol=1e-5)
    assert fusion.active()
    code = "import heat_tpu_torch as ht; import sys; sys.exit(0 if not ht.core.fusion.active() else 1)"
    env = dict(os.environ, HEAT_TPU_FUSION="0")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_clear_cache_zeroes_every_counter_and_the_registry():
    x = ht.exp(ht.array(_data((6, 2), 7), split=0))
    assert fusion._live_root_keys()
    x.numpy()
    fusion.clear_cache()
    stats = fusion.cache_stats()
    assert stats["compiles"] == stats["forces"] == stats["size"] == 0 and stats["program_keys"] == []
    assert fusion._live_root_keys() == []


def test_changing_the_default_mesh_clears_the_cache():
    ht.use_comm(MeshCommunication([torch.device("cpu")] * 2))
    ht.exp(ht.array(_data((4,), 8), split=0)).numpy()
    assert fusion.cache_stats()["compiles"] == 1
    ht.use_comm(MeshCommunication([torch.device("cpu")] * 2))  # the same devices: kept
    assert fusion.cache_stats()["compiles"] == 1
    ht.use_comm(MeshCommunication([torch.device("cpu")] * 3))
    assert fusion.cache_stats()["compiles"] == 0


def test_dynamos_settings_change_only_inside_a_programs_first_call():
    import torch._dynamo

    cfg = torch._dynamo.config
    flag = "fail_on_recompile_limit_hit" if hasattr(cfg, "fail_on_recompile_limit_hit") else "fail_on_cache_limit_hit"
    before = cfg.suppress_errors, getattr(cfg, flag)
    cfg.suppress_errors = True  # a user's own setting
    try:
        with fusion._strict_dynamo():
            assert cfg.suppress_errors is False and getattr(cfg, flag) is True
        assert cfg.suppress_errors is True and getattr(cfg, flag) == before[1]
        ht.exp(ht.array(_data((6, 2), 45), split=0)).numpy()
        assert cfg.suppress_errors is True and getattr(cfg, flag) == before[1]
    finally:
        cfg.suppress_errors = before[0]
