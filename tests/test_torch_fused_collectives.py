"""heat_tpu_torch.core.fusion's collective half: collective nodes and the
batching of live roots, against heat_tpu's recorder (tests/
test_fused_collectives.py, and test_eager_chain.py's
test_forcing_points_flush and test_k_reductions_one_chain). CPU only.

The reference's batching branch calls ``jax.core.trace_state_clean()``,
which this jax lacks, so heat_tpu runs under
``fusion.collectives_disabled()`` here. Values are held three ways, on
meshes of 1, 3 and 5 shards with ragged sizes:

* against the port with its collective nodes off, bit for bit (on the CPU
  a program is its plain GraphModule, the eager schedules' ops in their
  order), shards and padding included;
* against heat_tpu at the parity harness's tolerance (float32 reductions
  1e-5 relative);
* against numpy.

The counts are the reference's asserts, cited by line of
tests/test_fused_collectives.py: dispatches, roots, multi-root batches,
``fused_collectives`` kinds, builds of a warm loop. One kept divergence
changes a count: every host read of the port is a blocking sync (ROADMAP,
"Host reads are blocking syncs"), so three reads of batched moments are
three syncs where the reference counts at most one.
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
from heat_tpu.core import resilience as ref_res
from heat_tpu.core import telemetry as ref_tel
from heat_tpu.core.communication import MeshCommunication as RefMesh
from heat_tpu_torch.core import fusion, resilience
from heat_tpu_torch.core import telemetry as tel
from heat_tpu_torch.core.communication import MeshCommunication
from test_torch_parity import REDUCTION, on_cpu  # noqa: F401

MESHES = [1, 3, 5]
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
F32 = REDUCTION["float32"]


@pytest.fixture(autouse=True)
def recorders(on_cpu):  # noqa: F811 - the harness's fixture, first
    """The port's recorder with its collective nodes on (the default);
    heat_tpu's recorder without them; clean caches, telemetry at mode 1,
    ambient faults suspended on both sides; restored after."""
    was = ref.fusion.set_enabled(True), ref.fusion.set_collectives_enabled(False)
    mine = fusion.set_enabled(True), fusion.set_collectives_enabled(True)
    modes = tel.set_mode(1), ref_tel.set_mode(1)
    suspend = resilience.suspended(), ref_res.suspended()
    for s in suspend:
        s.__enter__()
    for f, t in ((fusion, tel), (ref.fusion, ref_tel)):
        f.clear_cache()
        t.reset()
    yield
    for s in suspend:
        s.__exit__(None, None, None)
    ref.fusion.set_enabled(was[0])
    ref.fusion.set_collectives_enabled(was[1])
    fusion.set_enabled(mine[0])
    fusion.set_collectives_enabled(mine[1])
    tel.set_mode(modes[0])
    ref_tel.set_mode(modes[1])
    for f, t in ((fusion, tel), (ref.fusion, ref_tel)):
        f.clear_cache()
        t.reset()


def _pair(p):
    """(port mesh, reference mesh) of p shards (capped at the JAX CPU mesh)."""
    p = min(p, len(jax.devices()))
    return MeshCommunication([torch.device("cpu")] * p), RefMesh(jax.devices()[:p])


def _data(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _rows(p: int, per: int = 4) -> int:
    """A split length that is ragged over p > 1 shards."""
    return per * p + 1 if p > 1 else per + 1


def _snapshot(x):
    """Value, split and physical shards (padding included) of an array."""
    return x.numpy(), x.split, [s.clone() for s in x.shards]


def _assert_same(got, want):
    """Bit-equal values, the same split and bit-equal physical shards."""
    gv, gs, gsh = got
    wv, ws, wsh = want
    assert gv.dtype == wv.dtype and np.array_equal(gv, wv, equal_nan=True)
    assert gs == ws
    assert len(gsh) == len(wsh) and all(torch.equal(a, b) for a, b in zip(gsh, wsh))


def _both_legs(run):
    """``run()`` with the collective nodes on (the results asserted pending
    before any read), then off; returns the two legs' snapshots."""
    outs = run()
    for o in outs:
        assert fusion.is_deferred(o), o
    on = [_snapshot(o) for o in outs]
    with fusion.collectives_disabled():
        off = [_snapshot(o) for o in run()]
    for g, w in zip(on, off):
        _assert_same(g, w)
    return on


# ---------------------------------------------------------------------------
# TestReductionChain (tests/test_fused_collectives.py:58-152)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("p", MESHES)
def test_mean_var_std_one_dispatch_one_sync(p):
    mine, theirs = _pair(p)
    n = 8 * mine.size
    a_np = _data((n,), 0)
    a = ht.array(a_np, split=0, comm=mine)
    tel.reset()
    m, v, s = ht.mean(a), ht.var(a), ht.std(a)
    assert all(fusion.is_deferred(x) for x in (m, v, s))
    if mine.size > 1:
        assert tel.fused_collectives().get("reduce.psum", 0) >= 3  # :74-77
    mv, vv, sv = float(m), float(v), float(s)
    stats = tel.async_forcing()
    assert stats["dispatches"] == 1  # :79
    assert stats["roots_dispatched"] == 3  # :80
    assert stats["multi_root_batches"] == 1  # :81
    assert stats["blocking_total"] == 3  # :82 is <= 1: the port counts every host read
    np.testing.assert_allclose(mv, a_np.mean(), rtol=1e-5)
    np.testing.assert_allclose(vv, a_np.var(), rtol=1e-4)
    np.testing.assert_allclose(sv, a_np.std(), rtol=1e-4)
    r = ref.array(a_np, split=0, comm=theirs)
    for got, want in zip((mv, vv, sv), (ref.mean(r), ref.var(r), ref.std(r))):
        np.testing.assert_allclose(got, float(want), **F32)
    with fusion.collectives_disabled():
        b = ht.array(a_np, split=0, comm=mine)
        assert [float(ht.mean(b)), float(ht.var(b)), float(ht.std(b))] == [mv, vv, sv]


@pytest.mark.parametrize("p", [3, 5])
def test_hlo_crosscheck_psums_inside_program(p):
    mine, _ = _pair(p)
    a = ht.array(_data((8 * mine.size,), 1), split=0, comm=mine)
    s = ht.std(a)
    assert fusion.is_deferred(s)
    assert tel.fused_collectives().get("reduce.psum", 0) >= 1  # :100
    counts = tel.hlo_collective_counts(fusion.program_hlo(s))
    assert counts.get("all-reduce", 0) + counts.get("reduce-scatter", 0) >= 1, counts  # :103-105
    assert fusion.is_deferred(s)  # :107: reading the program text forces nothing


@pytest.mark.parametrize("p", MESHES)
def test_chain_program_is_cached(p):
    mine, _ = _pair(p)
    n = 8 * mine.size

    def run(seed):
        a = ht.array(_data((n,), seed), split=0, comm=mine)
        m, v, s = ht.mean(a), ht.var(a), ht.std(a)
        return float(m) + float(v) + float(s)

    run(0)
    before = fusion.cache_stats()["compiles"]
    for seed in range(1, 4):
        run(seed)
    assert fusion.cache_stats()["compiles"] == before  # :124


@pytest.mark.parametrize("p", MESHES)
def test_zero_steady_state_retrace_reduce_then_elementwise_loop(p):
    mine, _ = _pair(p)
    x = ht.array(_data((8 * mine.size,), 2), split=0, comm=mine)

    def step(x):
        m = ht.mean(x)
        y = (x - m) * 0.5
        return float(ht.sum(y))

    step(x)
    step(x)
    before = fusion.cache_stats()["compiles"]
    for _ in range(5):
        step(x)
    assert fusion.cache_stats()["compiles"] == before  # :145


# ---------------------------------------------------------------------------
# TestBitwiseVsEager (tests/test_fused_collectives.py:155-188)
# ---------------------------------------------------------------------------
def _chain(pkg, x):
    y = pkg.exp(x * 0.5)
    m = pkg.mean(y, axis=0)
    return (m + 1.0) * 2.0


@pytest.mark.parametrize("p", MESHES)
def test_reduction_chain_matches_eager(p):
    mine, theirs = _pair(p)
    for n in (8 * mine.size, 8 * mine.size + 3):
        a_np = _data((n, 5), n)
        fused = _chain(ht, ht.array(a_np, split=0, comm=mine))
        assert fusion.is_deferred(fused)
        fused_np = fused.numpy()
        with fusion.disabled():
            eager = _chain(ht, ht.array(a_np, split=0, comm=mine))
            assert not fusion.is_deferred(eager)
            # the reference holds 1e-6 (XLA fuses the exp into the sum); the
            # port's CPU program runs the eager ops in their order
            assert np.array_equal(fused_np, eager.numpy())
        np.testing.assert_allclose(fused_np, _chain(ref, ref.array(a_np, split=0, comm=theirs)).numpy(), **F32)


@pytest.mark.parametrize("p", MESHES)
def test_collectives_off_leg_bitwise(p):
    mine, _ = _pair(p)
    a_np = _data((8 * mine.size + 3, 4), 5)
    fused_np = _chain(ht, ht.array(a_np, split=0, comm=mine)).numpy()
    with fusion.collectives_disabled():
        off_np = _chain(ht, ht.array(a_np, split=0, comm=mine)).numpy()
    assert np.array_equal(fused_np, off_np)  # :188


# ---------------------------------------------------------------------------
# TestDeferredReshard (tests/test_fused_collectives.py:191-245)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("p", MESHES)
def test_resplit_inplace_stays_recorded(p):
    mine, theirs = _pair(p)
    for n in (8 * mine.size, 8 * mine.size + 3):
        a_np = _data((n, 6), n)

        def run():
            x = ht.array(a_np, split=0, comm=mine) * 2.0 + 1.0
            assert fusion.is_deferred(x)
            x.resplit_(1)
            return [x]

        ((value, split, _),) = _both_legs(run)
        assert split == 1
        assert tel.fused_collectives().get("reshard", 0) >= 1  # :205
        np.testing.assert_array_equal(value, a_np * 2.0 + 1.0)
        r = ref.array(a_np, split=0, comm=theirs) * 2.0 + 1.0
        r.resplit_(1)
        np.testing.assert_allclose(value, r.numpy(), **F32)


@pytest.mark.parametrize("p", MESHES)
def test_resplit_outofplace_pending_chain(p):
    mine, theirs = _pair(p)
    a_np = _data((8 * mine.size + 3, 4), 9)
    x = ht.sqrt(ht.abs(ht.array(a_np, split=0, comm=mine))) + 0.25
    out = ht.resplit(x, 1)
    assert fusion.is_deferred(out) and out.split == 1  # :217-218
    assert fusion.is_deferred(x) and x.split == 0  # :219-220: the source untouched
    expect = np.sqrt(np.abs(a_np)) + np.float32(0.25)
    np.testing.assert_array_equal(out.numpy(), expect)
    np.testing.assert_array_equal(x.numpy(), expect)
    theirs_out = ref.resplit(ref.sqrt(ref.abs(ref.array(a_np, split=0, comm=theirs))) + 0.25, 1)
    np.testing.assert_allclose(out.numpy(), theirs_out.numpy(), **F32)


@pytest.mark.parametrize("p", MESHES)
@pytest.mark.parametrize("start,target", [(0, 1), (0, None), (None, 0), (1, 0), (None, 1)])
def test_resplit_matches_collectives_off(p, start, target):
    mine, _ = _pair(p)
    a_np = _data((8 * mine.size + 3, 2 * mine.size + 1), 11)

    def run():
        x = ht.array(a_np, split=start, comm=mine) * 3.0
        x.resplit_(target)
        y = ht.resplit(ht.abs(x) + 1.0, start)
        return [x, y]

    _both_legs(run)


# ---------------------------------------------------------------------------
# TestDeferredApply (tests/test_fused_collectives.py:248-276), the split-axis
# argmax/argmin schedule at every mesh
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("p", MESHES)
def test_argmax_records_apply_node(p):
    mine, theirs = _pair(p)
    a_np = _data((8 * mine.size,), 3)
    y = ht.array(a_np, split=0, comm=mine) * 3.0
    idx = ht.argmax(y, axis=0)
    assert fusion.is_deferred(idx)  # :260
    assert any(k.startswith("apply:") for k in tel.fused_collectives()), tel.fused_collectives()  # :261-264
    assert int(idx) == int(np.argmax(a_np * 3.0)) == int(ref.argmax(ref.array(a_np, split=0, comm=theirs) * 3.0, axis=0))


@pytest.mark.parametrize("p", MESHES)
@pytest.mark.parametrize("axis", [None, 0, 1])
@pytest.mark.parametrize("split", [None, 0, 1])
def test_argreduce_bitwise_vs_eager_dispatch(p, axis, split):
    mine, theirs = _pair(p)
    a_np = _data((_rows(mine.size), 3 * mine.size + 2), 4)
    a_np[1, 1] = a_np.max() + 1.0  # a tie's first index and the global maximum
    a_np[2, 1] = a_np[1, 1]

    def run():
        x = ht.array(a_np, split=split, comm=mine) + 0.5
        return [ht.argmax(x, axis=axis), ht.argmin(x, axis=axis)]

    on = _both_legs(run)
    for (value, _, _), fn in zip(on, ("argmax", "argmin")):
        np.testing.assert_array_equal(value, getattr(np, fn)(a_np + np.float32(0.5), axis=axis))
        theirs_v = getattr(ref, fn)(ref.array(a_np, split=split, comm=theirs) + 0.5, axis=axis)
        np.testing.assert_array_equal(value, np.asarray(theirs_v.numpy()))


# ---------------------------------------------------------------------------
# TestFaultSitesStillFire (tests/test_fused_collectives.py:279-345)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("p", MESHES)
def test_reshard_fault_fires_before_metadata_mutates(p):
    mine, _ = _pair(p)
    x = ht.array(np.ones((4 * mine.size, 3), np.float32), split=0, comm=mine) * 2.0
    assert fusion.is_deferred(x)
    with resilience.inject("collective.reshard", times=1):
        with pytest.raises(resilience.FaultInjected):
            x.resplit_(1)
    assert x.split == 0 and fusion.is_deferred(x)  # :290-291
    x.resplit_(1)
    assert x.split == 1
    np.testing.assert_array_equal(x.numpy(), np.full((4 * mine.size, 3), 2.0, np.float32))


@pytest.mark.parametrize("p", MESHES)
def test_outofplace_resplit_fault_fires_at_record_time(p):
    mine, _ = _pair(p)
    x = ht.array(np.ones((4 * mine.size, 3), np.float32), split=0, comm=mine) * 2.0
    with resilience.inject("collective.reshard", times=1):
        with pytest.raises(resilience.FaultInjected):
            ht.resplit(x, 1)
    assert x.split == 0 and fusion.is_deferred(x)  # :307-308
    assert ht.resplit(x, 1).split == 1


@pytest.mark.parametrize("p", MESHES)
@pytest.mark.parametrize("site,call", [
    ("collective.apply", lambda y: ht.argmax(y, axis=0)),
    ("collective.matmul", lambda y: ht.matmul(y, ht.ones((1, 2), comm=y.comm))),
    ("collective.halo", lambda y: y.get_halo(1)),
])
def test_apply_fault_fires_at_record_time(p, site, call):
    mine, _ = _pair(p)
    n = 8 * mine.size
    y = ht.array(np.arange(n, dtype=np.float32).reshape(n, 1), split=0, comm=mine) * 2.0
    if site == "collective.halo" and mine.size == 1:
        with resilience.inject(site, times=1):
            call(y)  # one shard exchanges no halo: the site does not fire
        assert y.halos is None
    else:
        with resilience.inject(site, times=1):
            with pytest.raises(resilience.FaultInjected):
                call(y)
    assert fusion.is_deferred(y)  # the fault fired before anything was recorded or forced
    assert int(ht.argmax(y, axis=0)) == n - 1  # :321: clean recovery


@pytest.mark.parametrize("p", MESHES)
def test_degraded_force_replays_collective_chain(p):
    mine, _ = _pair(p)
    a_np = _data((8 * mine.size + 3, 2), 6)

    def run():
        x = ht.array(a_np, split=0, comm=mine) * 2.0
        x.resplit_(1)
        return [ht.mean(x, axis=0), ht.argmax(x, axis=0), x]

    outs = run()
    with resilience.inject("fusion.compile", times=1):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", resilience.DegradedDispatchWarning)
            got = [_snapshot(o) for o in outs]
    assert fusion.cache_stats()["degraded"] == 1
    with fusion.collectives_disabled():
        want = [_snapshot(o) for o in run()]
    for g, w in zip(got, want):
        _assert_same(g, w)  # the op-by-op replay is the eager result, bit for bit
    np.testing.assert_allclose(got[0][0], (a_np * 2.0).mean(axis=0), rtol=1e-5)  # :340


# ---------------------------------------------------------------------------
# TestBatchingBoundaries (tests/test_fused_collectives.py:348-395)
# ---------------------------------------------------------------------------
def test_no_batching_while_torch_traces(monkeypatch):
    """A force that runs while torch traces (Dynamo inlining it) takes no
    other root into its program: the root would come back as a value of
    the caller's graph (the reference's test_no_batching_into_enclosing_trace,
    with ``torch.compiler.is_compiling`` in place of jax's trace state)."""
    mine, _ = _pair(3)
    a = ht.array(_data((12,), 30), split=0, comm=mine)
    held = ht.mean(a)
    pending = ht.exp(a * 0.5)
    monkeypatch.setattr(torch.compiler, "is_compiling", lambda: True)
    pending.numpy()
    assert fusion.is_deferred(held)  # :369: not batched
    monkeypatch.undo()
    tel.reset()
    other = ht.exp(a * 0.25)
    other.numpy()
    assert not fusion.is_deferred(held)  # outside a trace it rides along
    assert tel.async_forcing()["multi_root_batches"] == 1
    np.testing.assert_allclose(float(held), a.numpy().mean(), rtol=1e-5)


def test_no_batching_across_comms():
    mine, _ = _pair(3)
    a = ht.array(_data((12,), 31), split=0, comm=mine)
    sub = MeshCommunication([torch.device("cpu")])
    b = ht.array(np.arange(4, dtype=np.float32), split=0, comm=sub) * 2.0
    assert fusion.is_deferred(b)
    float(ht.mean(a))
    assert fusion.is_deferred(b)  # :392: not dragged across meshes
    np.testing.assert_allclose(b.numpy(), np.arange(4, dtype=np.float32) * 2.0)


def test_a_large_root_keeps_its_own_dispatch_and_the_batch_is_capped(monkeypatch):
    mine, _ = _pair(3)
    big = ht.exp(ht.array(_data((3000, 2), 32), split=0, comm=mine))  # 24 kB > 16 kB
    small = [ht.exp(ht.array(_data((3,), s), split=0, comm=mine)) for s in range(5)]
    monkeypatch.setattr(fusion, "_BATCH_MAX", 3)
    tel.reset()
    small[0].numpy()
    assert fusion.is_deferred(big)
    assert [fusion.is_deferred(s) for s in small] == [False, False, False, True, True]
    assert tel.async_forcing()["roots_dispatched"] == 3


@pytest.mark.parametrize("p", MESHES)
def test_a_root_written_around_its_array_stays_out_of_the_batch(p):
    """A live root whose input was written in place through a torch view of
    its shards is left out of another root's batch: the read of an array
    that reads nothing written succeeds, equal to the collectives-off leg,
    and the written root stays pending and raises at its own read."""
    mine, _ = _pair(p)
    a_np, w_np = _data((_rows(mine.size), 3), 26), _data((4, 3), 27)

    def run():
        w = ht.array(w_np, split=None, comm=mine)
        written = w * 2.0
        a = ht.sum(ht.array(a_np, split=0, comm=mine) * 2.0, axis=0)
        return w, written, a

    w, written, a = run()
    assert fusion.is_deferred(written) and fusion.is_deferred(a)
    w.larray[0, 0] = 100.0  # the array does not see this write
    tel.reset()
    got = _snapshot(a)
    assert tel.async_forcing()["roots_dispatched"] == 1
    assert fusion.is_deferred(written)
    with pytest.raises(fusion.ChainInputWrittenError):
        written.numpy()
    with fusion.collectives_disabled():
        _assert_same(got, _snapshot(run()[2]))
    np.testing.assert_allclose(got[0], (a_np * 2.0).sum(axis=0), **F32)


# ---------------------------------------------------------------------------
# TestEscapeHatches (tests/test_fused_collectives.py:398-420)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("p", MESHES)
def test_collectives_off_pays_one_sync_per_read(p):
    mine, _ = _pair(p)
    a = ht.array(_data((8 * mine.size,), 8), split=0, comm=mine)
    with fusion.collectives_disabled():
        tel.reset()
        m, v, s = ht.mean(a), ht.var(a), ht.std(a)
        float(m), float(v), float(s)
        stats = tel.async_forcing()
    assert stats["multi_root_batches"] == 0  # :407
    assert stats["dispatches"] == 3
    assert stats["blocking_total"] == 3  # :408


@pytest.mark.parametrize("p", MESHES)
def test_fusion_off_is_fully_eager(p):
    mine, _ = _pair(p)
    a_np = _data((8 * mine.size,), 10)
    with fusion.disabled():
        assert not fusion.collectives_active()  # :414
        m = ht.mean(ht.array(a_np, split=0, comm=mine) * 0.5)
        assert not fusion.is_deferred(m)
        np.testing.assert_allclose(float(m), (a_np * 0.5).mean(), rtol=1e-5)


def test_the_collectives_switch_is_read_from_the_environment():
    code = (
        "import heat_tpu_torch as ht; f = ht.core.fusion; import sys; "
        "sys.exit(0 if (f.active() and not f.collectives_active(), f._BATCH_MAX, f._BATCH_BYTES) == (True, 4, 99) else 1)"
    )
    env = dict(os.environ, HEAT_TPU_FUSION_COLLECTIVES="0", HEAT_TPU_FUSION_BATCH="4", HEAT_TPU_FUSION_BATCH_BYTES="99")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert fusion.collectives_active() and fusion._BATCH_MAX == 16 and fusion._BATCH_BYTES == 16384


# ---------------------------------------------------------------------------
# tests/test_eager_chain.py:172-231, with resplit_ deferred
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("p", MESHES)
def test_forcing_points_flush(p):
    mine, _ = _pair(p)
    n = 4 * mine.size
    a_np = _data((n, 3), 9)
    expect = np.exp(a_np * np.float32(0.25)) + np.float32(1.0)

    def chain():
        return ht.exp(ht.array(a_np, split=0, comm=mine) * 0.25) + 1.0

    x = chain()
    assert fusion.is_deferred(x) and "DNDarray" in str(x) and not fusion.is_deferred(x)
    np.testing.assert_allclose(x.numpy(), expect, rtol=1e-5)
    x = chain()
    row = x[1]
    assert not fusion.is_deferred(x)
    np.testing.assert_allclose(row.numpy(), expect[1], rtol=1e-5)
    x = chain()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "chain.npy")
        ht.save_npy(x, path)
        assert not fusion.is_deferred(x)
        np.testing.assert_allclose(np.load(path), expect, rtol=1e-5)
    x = chain()
    x.resplit_(1)
    assert fusion.is_deferred(x) and x.split == 1  # a node, with the collectives on
    np.testing.assert_allclose(x.numpy(), expect, rtol=1e-5)
    x = chain()
    with fusion.collectives_disabled():
        x.resplit_(1)
        assert not fusion.is_deferred(x)
    np.testing.assert_allclose(x.numpy(), expect, rtol=1e-5)


@pytest.mark.parametrize("p", MESHES)
def test_k_reductions_one_chain(p):
    mine, theirs = _pair(p)
    a_np = _data((8 * mine.size,), 11)
    a = ht.array(a_np, split=0, comm=mine)
    combo = ht.mean(a) + ht.std(a) + ht.sum(a * a)
    assert fusion.is_deferred(combo)
    got = float(combo.larray)
    np.testing.assert_allclose(got, a_np.mean() + a_np.std() + (a_np * a_np).sum(), rtol=1e-4)
    r = ref.array(a_np, split=0, comm=theirs)
    np.testing.assert_allclose(got, float((ref.mean(r) + ref.std(r) + ref.sum(r * r)).larray), **F32)


# ---------------------------------------------------------------------------
# each call site: deferred against the collectives-off leg, bit for bit,
# against heat_tpu with its collectives off and against numpy
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("p", MESHES)
def test_get_halo_of_a_pending_chain_is_a_node(p):
    mine, theirs = _pair(p)
    n = _rows(mine.size, 5)
    a_np = _data((n, 2), 12)
    x = ht.array(a_np, split=0, comm=mine) * 2.0
    x.get_halo(2)
    if mine.size == 1:
        assert x.halos is None
        return
    assert fusion.is_deferred(x) and tel.fused_collectives() == {"apply:_halo_kernel": 1}
    got = x.array_with_halos
    with fusion.collectives_disabled():
        y = ht.array(a_np, split=0, comm=mine) * 2.0
        y.get_halo(2)
        assert not fusion.is_deferred(y)
        want = y.array_with_halos
        assert all(torch.equal(g, w) for hg, hw in zip(x.halos, y.halos) for g, w in zip(hg, hw))
    assert torch.equal(got, want)
    r = ref.array(a_np, split=0, comm=theirs) * 2.0
    r.get_halo(2)
    if not r.padded:
        np.testing.assert_allclose(got.numpy(), np.asarray(r.array_with_halos), **F32)


@pytest.mark.parametrize("p", MESHES)
@pytest.mark.parametrize("mode", ["full", "same", "valid"])
def test_convolve_over_the_deferred_halo(p, mode):
    mine, theirs = _pair(p)
    n = 6 * mine.size + 1
    a_np, v_np = _data((n,), 13), _data((5,), 14)

    def run():
        return [ht.convolve(ht.array(a_np, split=0, comm=mine) * 2.0, ht.array(v_np, comm=mine), mode=mode)]

    ((value, split, _),) = _both_legs(run)
    assert split == 0
    np.testing.assert_allclose(value, np.convolve(a_np * 2.0, v_np, mode=mode), rtol=1e-5, atol=1e-5)
    theirs_v = ref.convolve(ref.array(a_np, split=0, comm=theirs) * 2.0, ref.array(v_np, comm=theirs), mode=mode)
    np.testing.assert_allclose(value, theirs_v.numpy(), **F32)


@pytest.mark.parametrize("p", MESHES)
@pytest.mark.parametrize("sa", [None, 0, 1])
@pytest.mark.parametrize("sb", [None, 0, 1])
def test_matmul_of_every_split_pair(p, sa, sb):
    mine, theirs = _pair(p)
    m, k, n = _rows(mine.size), 2 * mine.size + 1, 3 * mine.size - 1 if mine.size > 1 else 3
    a_np, b_np = _data((m, k), 15), _data((k, n), 16)

    def run():
        a = ht.array(a_np, split=sa, comm=mine) * 1.5
        b = ht.array(b_np, split=sb, comm=mine) + 0.25
        return [ht.matmul(a, b)]

    ((value, split, _),) = _both_legs(run)
    assert split == (0 if sa == 0 else 1 if sb == 1 else None)  # the case table
    assert tel.fused_collectives().get("matmul") == 1
    expect = (a_np.astype(np.float64) * 1.5) @ (b_np.astype(np.float64) + 0.25)
    np.testing.assert_allclose(value, expect, rtol=1e-5, atol=1e-5)
    theirs_v = ref.matmul(ref.array(a_np, split=sa, comm=theirs) * 1.5, ref.array(b_np, split=sb, comm=theirs) + 0.25)
    np.testing.assert_allclose(value, theirs_v.numpy(), **F32)


@pytest.mark.parametrize("p", MESHES)
@pytest.mark.parametrize("method", ["cholqr2", "tsqr"])
def test_qr_of_a_pending_column_scale(p, method):
    mine, theirs = _pair(p)
    m, n = 8 * mine.size + 3, 4
    a_np = _data((m, n), 17)
    scale = np.linspace(0.5, 2.0, n, dtype=np.float32)
    qr = ht.linalg.qr

    def run():
        x = ht.array(a_np, split=0, comm=mine) * ht.array(scale, comm=mine)
        q, r = qr(x, method=method)
        if method == "tsqr":  # TSQR on more than one shard, else Householder
            assert all(fusion.is_deferred(t) for t in (q, r)) == (mine.size > 1 and fusion.collectives_active())
        return [q, r]

    outs = run()
    on = [_snapshot(o) for o in outs]
    with fusion.collectives_disabled():
        off = [_snapshot(o) for o in run()]
    for g, w in zip(on, off):
        _assert_same(g, w)
    (q, _, _), (r, _, _) = on
    want = a_np * scale
    np.testing.assert_allclose(q @ r, want, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(q.T @ q, np.eye(n), atol=1e-5)
    rq, rr = ref.linalg.qr(ref.array(a_np, split=0, comm=theirs) * ref.array(scale, comm=theirs), method=method)
    np.testing.assert_allclose(np.abs(r), np.abs(np.asarray(rr.numpy())), rtol=1e-4, atol=1e-4)
    kinds = tel.fused_collectives()
    if method == "cholqr2":
        assert kinds.get("multi:_cholqr2_kernel") == 1
    elif mine.size > 1:
        assert kinds.get("apply:_tsqr_kernel") == 1


@pytest.mark.parametrize("p", MESHES)
def test_cholqr2_reads_ok_once_and_lands_q_and_r_with_it(p):
    mine, _ = _pair(p)
    x = ht.array(_data((8 * mine.size + 3, 4), 18), split=0, comm=mine) * 2.0
    tel.reset()
    q, r = ht.linalg.qr(x, method="cholqr2")
    assert not fusion.is_deferred(q) and not fusion.is_deferred(r)  # in the dispatch that read ok
    stats = tel.async_forcing()
    assert stats["dispatches"] == 1 and stats["roots_dispatched"] == 3  # ok, Q and R (heat_tpu qr.py:246-262)


@pytest.mark.parametrize("p", MESHES)
@pytest.mark.parametrize("sa", [None, 0, 1])
@pytest.mark.parametrize("rhs", ["vector", "matrix"])
def test_solve_triangular_of_a_pending_chain(p, sa, rhs):
    mine, theirs = _pair(p)
    n = _rows(mine.size, 3)
    t_np = np.triu(_data((n, n), 19)) + n * np.eye(n, dtype=np.float32)
    b_np = _data((n,) if rhs == "vector" else (n, 2), 20)

    def run():
        t = ht.array(t_np, split=sa, comm=mine) * 1.0
        b = ht.array(b_np, split=0, comm=mine) + 0.0
        return [ht.linalg.solve_triangular(t, b)]

    ((value, split, _),) = _both_legs(run)
    assert split == 0
    np.testing.assert_allclose(value, np.linalg.solve(t_np.astype(np.float64), b_np), rtol=1e-4, atol=1e-5)
    theirs_v = ref.linalg.solve_triangular(ref.array(t_np, split=sa, comm=theirs), ref.array(b_np, split=0, comm=theirs))
    np.testing.assert_allclose(value, theirs_v.numpy(), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("p", MESHES)
def test_cg_is_declined_with_its_reason(p):
    """Kept divergence: the port's CG is a loop of ``n`` masked iterations,
    which a program would unroll, so recording declines it by name and the
    sweep runs eagerly on the forced operands."""
    mine, theirs = _pair(p)
    n = 7
    m_np = _data((n, n), 21)
    a_np = m_np @ m_np.T + n * np.eye(n, dtype=np.float32)
    b_np = _data((n,), 22)

    def run():
        a = ht.array(a_np, split=0, comm=mine) * 1.0
        return ht.linalg.cg(a, ht.array(b_np, comm=mine), ht.zeros((n,), comm=mine))

    x = run()
    assert not fusion.is_deferred(x)
    assert tel.unfused_reasons()["op"] == {"cg_unrolled_loop": 1}
    with fusion.collectives_disabled():
        assert np.array_equal(x.numpy(), run().numpy())
    np.testing.assert_allclose(x.numpy(), np.linalg.solve(a_np.astype(np.float64), b_np), rtol=1e-4, atol=1e-4)
    theirs_v = ref.linalg.cg(ref.array(a_np, split=0, comm=theirs), ref.array(b_np, comm=theirs), ref.zeros((n,), comm=theirs))
    np.testing.assert_allclose(x.numpy(), theirs_v.numpy(), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("p", MESHES)
def test_a_chain_through_resplits_stays_one_program(p):
    """z-score, ``resplit_(1)``, a column reduction, ``resplit_(0)``: pending
    throughout and one dispatch at the read (chip_smoke.py phase 19's
    chain at a small size)."""
    mine, _ = _pair(p)
    # rows a multiple of p: a ragged z-score is a padded broadcast, which
    # runs eagerly by the engines' rule
    a_np = _data((6 * mine.size, 2 * mine.size + 1), 23)

    def run():
        x = ht.array(a_np, split=0, comm=mine)
        z = (x - ht.mean(x, axis=0)) / ht.std(x, axis=0)
        z.resplit_(1)
        s = ht.sum(z * z, axis=0)
        z.resplit_(0)
        return [z, s]

    tel.reset()
    _both_legs(run)
    assert tel.fused_collectives()["reshard"] == 2


def test_report_carries_the_fused_collectives():
    mine, _ = _pair(3)
    x = ht.array(_data((13, 2), 25), split=0, comm=mine) * 2.0
    x.resplit_(1)
    ht.argmax(x, axis=1)
    assert tel.report()["fused_collectives"] == {"reshard": 1, "apply:_arg_kernel": 1}
    with fusion.collectives_disabled():
        tel.reset()
        y = ht.array(_data((13, 2), 25), split=0, comm=mine) * 2.0
        y.resplit_(1)
        assert tel.report()["fused_collectives"] == {} and tel.forcing_points()["collective"]["count"] == 1


def test_the_drain_never_batches_a_node_of_the_gated_chain():
    """The memory gate's ``drain`` policy forces the other live roots while
    the gated program waits; their batches must not take a node of the
    gated program (``_DRAIN_EXCLUDE``), or it would dispatch twice."""
    from heat_tpu_torch.core import memledger as ml

    mine, _ = _pair(3)
    big = ht.ones((4096 * 3, 8), split=0, comm=mine) * 2.0  # 384 kB: never batched
    a_np = _data((13, 3), 26)
    x = ht.exp(ht.array(a_np, split=0, comm=mine) * 0.5) + 1.0
    m, s = ht.mean(x), ht.sum(x)  # small roots: the gated program batches m with s
    prev = ml.set_budget(1, "drain")
    try:
        with pytest.warns(ml.MemoryBudgetWarning):  # still over after the drain
            got = float(s.item())
    finally:
        ml.set_budget(*prev)
    assert ml.gate_stats()["drained_roots"] >= 1 and not fusion.is_deferred(big)
    stats = tel.async_forcing()
    assert stats["roots_dispatched"] == 3 and stats["multi_root_batches"] == 1  # big alone, then s with m
    assert all(rec["dispatches"] == 1 for rec in fusion.programs().values())
    expect = np.exp(a_np.astype(np.float64) * 0.5) + 1.0
    np.testing.assert_allclose(got, expect.sum(), rtol=1e-5)
    np.testing.assert_allclose(float(m), expect.mean(), rtol=1e-5)
