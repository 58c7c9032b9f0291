"""heat_tpu_torch.core.numlens (the numerics lens) against heat_tpu's
(tests/test_numlens.py), case by case. CPU only.

Held against heat_tpu where its code runs here (its recorder on, its
collective nodes off: this jax lacks ``jax.core.trace_state_clean``, which
its batching calls): the tensor statistics of the same chain on the same
seeded input (counts and histogram exactly, rms and absmax within float32
rounding), ``ulp_diff``, the training streams and the ``numerics`` command
line's text of one report file. Everything else is held against numpy.

Kept divergence: on the CPU a fused program IS its plain module, so the
drift audit reads 0 ULP by construction, where the reference's jitted
reductions drift. The ledger's arithmetic is held here by making the
program's output differ from its replay by a known number of ULP; the
natural drift (Inductor's code against the plain module) is read on the
card by ``chip_smoke.py``'s phase 20.

Waits for a later part of the port: ``test_tracelens_diagnose_*``
(tests/test_numlens.py:572-609) come with ``tracelens`` (ROADMAP A11.6).
"""

from __future__ import annotations

import importlib
import io as pyio
import json
import math
import os
import subprocess
import sys
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import heat_tpu as ref
import heat_tpu_torch as ht
from heat_tpu.core import numlens as ref_nl
from heat_tpu.core import resilience as ref_res
from heat_tpu.core import telemetry as ref_tel
from heat_tpu.core.communication import MeshCommunication as RefMesh
from heat_tpu_torch.core import fusion, health_runtime, numlens, resilience, telemetry
from heat_tpu_torch.core.communication import MeshCommunication
from heat_tpu_torch.utils.interop import mlp_from_flax
from test_torch_parity import on_cpu  # noqa: F401

cli = importlib.import_module("heat_tpu_torch.telemetry")
ref_cli = importlib.import_module("heat_tpu.telemetry")

SEED = 20261017
MESHES = [1, 3, 5, 8]
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: float32 rounding of a sum of squares over a few hundred elements, in
#: two implementations (jnp's and torch's orders)
STAT_RTOL = 1e-5


@pytest.fixture(autouse=True)
def lens(on_cpu):  # noqa: F811 - the harness's fixture, first
    """Both lenses in ``full`` with the drift audit off unless a test opts
    in, both at telemetry mode 1, heat_tpu's recorder on without its
    collective nodes, ambient faults suspended; everything restored after
    (the reference's NumlensCase)."""
    was = ref.fusion.set_enabled(True), ref.fusion.set_collectives_enabled(False)
    suspend = resilience.suspended(), ref_res.suspended()
    for s in suspend:
        s.__enter__()
    saved = []
    for nl, tel in ((numlens, telemetry), (ref_nl, ref_tel)):
        saved.append((nl.set_mode("full"), tel.set_mode(1), nl._SAMPLE_EVERY, nl._SHADOW_EVERY,
                      nl._CANARY_EVERY, nl._MAX_ULP))
        nl._SHADOW_EVERY = 0
        tel.reset()
    fusion.clear_cache()
    ref.fusion.clear_cache()
    resilience.reset_device_faults()
    yield
    for (nl, tel), (mode, tmode, sample, shadow, canary, max_ulp) in zip(((numlens, telemetry), (ref_nl, ref_tel)), saved):
        nl._SAMPLE_EVERY, nl._SHADOW_EVERY, nl._CANARY_EVERY, nl._MAX_ULP = sample, shadow, canary, max_ulp
        nl.set_mode(mode)
        tel.set_mode(tmode)
        tel.reset()
    for s in suspend:
        s.__exit__(None, None, None)
    resilience.reset_device_faults()
    ref.fusion.set_enabled(was[0])
    ref.fusion.set_collectives_enabled(was[1])
    fusion.clear_cache()
    ref.fusion.clear_cache()


def _pair(p):
    p = min(p, len(jax.devices()))
    return MeshCommunication([torch.device("cpu")] * p), RefMesh(jax.devices()[:p])


def _one_record(nl):
    stats = nl.tensor_stats()
    assert len(stats) == 1, stats
    (key, rec), = stats.items()
    assert len(rec["roots"]) == 1, rec
    return key, rec, rec["roots"][0]


def _split_input(p=None, seed=0, n_mult=4, cols=3):
    comm = MeshCommunication([torch.device("cpu")] * p) if p else None
    size = comm.size if comm else ht.get_comm().size
    data = np.random.default_rng(seed).standard_normal((n_mult * size, cols)).astype(np.float32)
    return ht.array(data, split=0, comm=comm)


def _same_stats(mine, theirs):
    """Two root records: counts and histogram exact, floats within float32
    rounding."""
    for k in ("samples", "elems", "nonfinite", "subnormal", "hist", "edge_low", "edge_high", "subnormal_pct"):
        assert mine[k] == theirs[k], (k, mine[k], theirs[k])
    for k in ("rms", "absmax"):
        assert mine[k] == pytest.approx(theirs[k], rel=STAT_RTOL), k


# ---------------------------------------------------------------------------
# pillar 1: tensor statistics (TestTensorStats)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("p", MESHES)
def test_stats_match_numpy_on_a_forced_chain(p):
    """tests/test_numlens.py:102."""
    mine, theirs = _pair(p)
    n = 8 * mine.size
    data = np.random.default_rng(3).standard_normal((n, 4)).astype(np.float32)
    got = (ht.array(data, split=0, comm=mine) * 2.0 + 1.0).numpy()
    np.asarray((ref.array(data, split=0, comm=theirs) * 2.0 + 1.0).larray)
    _, _, rr = _one_record(numlens)
    _, _, want = _one_record(ref_nl)
    expected = data * 2.0 + 1.0
    assert rr["dtype"] == "float32" == want["dtype"] and rr["nonfinite"] == 0
    assert rr["rms"] == pytest.approx(float(np.sqrt(np.mean(np.square(expected.astype(np.float64))))), rel=STAT_RTOL)
    assert rr["absmax"] == float(np.abs(expected).max())
    assert sum(rr["hist"]) == int(np.count_nonzero(expected))
    np.testing.assert_array_equal(got, expected)
    _same_stats(rr, want)


@pytest.mark.parametrize("p", MESHES)
def test_nonfinite_and_subnormal_counts_are_exact(p):
    """tests/test_numlens.py:118."""
    mine, theirs = _pair(p)
    data = np.ones((8 * mine.size, 4), np.float32)
    data[0, 0] = np.inf
    data[0, 1] = np.nan
    data[1, :2] = 1e-41  # subnormal in float32
    ht.abs(ht.array(data, split=0, comm=mine)).numpy()
    np.asarray(ref.abs(ref.array(data, split=0, comm=theirs)).larray)
    _, _, rr = _one_record(numlens)
    assert rr["nonfinite"] == 2 and rr["subnormal"] == 2 and rr["subnormal_pct"] > 0.0
    assert rr["edge_low"] >= 2  # subnormals land in the lowest bucket
    _same_stats(rr, _one_record(ref_nl)[2])


def test_aggregation_accumulates_across_samples():
    """tests/test_numlens.py:136."""
    a = _split_input()
    for _ in range(3):
        (a * 1.0).numpy()
        fusion.clear_cache()  # the same program key dispatched again
    rec = next(iter(numlens.tensor_stats().values()))
    assert rec["samples"] == 3 and rec["roots"][0]["samples"] == 3


def test_sample_throttle_in_sample_mode():
    """tests/test_numlens.py:146."""
    numlens.set_mode("sample")
    numlens._SAMPLE_EVERY = 8
    a = _split_input()
    for _ in range(16):
        float(ht.sum(ht.exp(a * 0.1)))
    blk = numlens.numerics_block()
    assert (blk["dispatches_seen"], blk["dispatches_sampled"]) == (16, 2)


def test_disabled_lens_is_a_no_op():
    """tests/test_numlens.py:156."""
    numlens.set_mode(0)
    assert telemetry._NUMLENS_HOOK is None
    float(ht.sum(_split_input() * 2.0))
    blk = numlens.numerics_block()
    assert blk["mode"] == "off" and blk["dispatches_seen"] == 0 and blk["tensor_stats"] == {}


@pytest.mark.parametrize("p", [4, 3, 5])
def test_nan_padding_of_a_sharded_root_is_not_counted(p):
    """The padding rows of a root's shards (rows padded to ceil(n/p)) hold
    NaN here, as ``chip_smoke.py``'s phase 18 pads them: the statistics
    count the logical elements only."""
    comm = MeshCommunication([torch.device("cpu")] * p)
    n = 4 * p + 1  # every shard padded but the first
    data = np.random.default_rng(5).standard_normal((n, 3)).astype(np.float32)
    data[2, 1] = np.nan
    data[n - 1, 0] = np.inf
    x = ht.array(data, split=0, comm=comm)
    assert x.padded
    counts = comm.counts_displs_shape(x.gshape, 0)[0]
    padding = 0
    for s, c in zip(x.shards, counts):
        s[c:] = float("nan")
        padding += (s.shape[0] - c) * s.shape[1]
    y = ht.abs(x) + 1.0
    value = fusion.force(y._payload)
    # the program computed the padding too: NaN sits there
    assert sum(int(torch.isnan(t).sum()) for t in value) == 1 + padding
    _, _, rr = _one_record(numlens)
    assert rr["nonfinite"] == 2 and rr["elems"] == n * 3 and rr["shape"] == (n, 3)
    assert sum(rr["hist"]) == n * 3 - 2
    np.testing.assert_array_equal(y.numpy(), np.abs(data) + 1.0)


def test_stats_of_a_replicated_root():
    """A replicated root is one tensor: every element counts once."""
    x = ht.array(np.arange(12, dtype=np.float32).reshape(4, 3) - 5.0)
    (x * 3.0).numpy()
    _, _, rr = _one_record(numlens)
    assert rr["elems"] == 12 and rr["absmax"] == 18.0 and sum(rr["hist"]) == 11  # one zero


# ---------------------------------------------------------------------------
# half-width edge statistics (TestHalfWidthEdgeStats)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("p", [1, 3, 8])
@pytest.mark.parametrize("dtype, big, tiny", [("bfloat16", 3.0e38, 5.0e-40), ("float16", 6.0e4, 3.0e-6)])
def test_edge_saturation_every_mesh_size(p, dtype, big, tiny):
    """tests/test_numlens.py:180."""
    mine, theirs = _pair(p)
    data = np.ones((8 * mine.size, 4), np.float32)
    data[:, 1] = big
    data[:, 2] = tiny
    forced = ht.abs(ht.array(data, split=0, dtype=getattr(ht, dtype), comm=mine)).numpy().astype(np.float32)
    np.asarray(ref.abs(ref.array(data, split=0, dtype=getattr(ref, dtype), comm=theirs)).larray)
    _, _, rr = _one_record(numlens)
    _, _, want = _one_record(ref_nl)
    assert rr["dtype"] == dtype == want["dtype"]
    assert rr["edge_high"] > 0 and rr["subnormal"] > 0 and rr["edge_low"] >= rr["subnormal"]
    assert rr["nonfinite"] == 0 and np.all(forced >= 0)
    _same_stats(rr, want)


# ---------------------------------------------------------------------------
# ulp_diff (TestUlpDiff), against heat_tpu's
# ---------------------------------------------------------------------------
def _both_ulp(a, b):
    mine = numlens.ulp_diff(a, b)
    np.testing.assert_array_equal(mine, ref_nl.ulp_diff(a, b))
    return mine


def test_identical_bits_are_zero():
    """tests/test_numlens.py:218."""
    x = np.random.default_rng(0).standard_normal(64).astype(np.float32)
    assert int(_both_ulp(x, x.copy()).max()) == 0


def test_adjacent_floats_are_one_ulp():
    """tests/test_numlens.py:222."""
    x = np.asarray([1.0, -2.5, 3e-30], np.float32)
    np.testing.assert_array_equal(_both_ulp(x, np.nextafter(x, np.inf)), [1, 1, 1])


def test_signed_zero_coincides():
    """tests/test_numlens.py:227."""
    assert int(_both_ulp(np.float32(0.0), np.float32(-0.0))[0]) == 0


def test_scalar_zero_d_inputs_work():
    """tests/test_numlens.py:232."""
    assert int(_both_ulp(np.float64(1.0), np.float64(1.0))[0]) == 0


def test_nonfinite_pairs():
    """tests/test_numlens.py:236."""
    nan, one = np.float32(np.nan), np.float32(1.0)
    assert int(_both_ulp(nan, nan)[0]) == 0
    assert int(_both_ulp(nan, one)[0]) == numlens._ULP_SENTINEL == ref_nl._ULP_SENTINEL


def test_half_width_dtypes():
    """tests/test_numlens.py:241; bfloat16 on the device as well
    (``_ulp_tensor``, which the drift audit runs)."""
    x = np.asarray(jnp.asarray([1.0, 2.0, -3.5], jnp.bfloat16))
    y = np.asarray(jnp.asarray([1.0, 2.015625, -3.5], jnp.bfloat16))
    np.testing.assert_array_equal(_both_ulp(x, x), [0, 0, 0])
    np.testing.assert_array_equal(_both_ulp(x, y), [0, 1, 0])
    t = torch.tensor([1.0, 2.0, -3.5], dtype=torch.bfloat16)
    u = torch.tensor([1.0, 2.015625, -3.5], dtype=torch.bfloat16)
    np.testing.assert_array_equal(numlens._ulp_tensor(t, u).numpy(), [0, 1, 0])


@pytest.mark.parametrize("dtype", ["float16", "float32", "float64"])
def test_the_device_arithmetic_equals_numpy(dtype):
    """The audit's on-device distances (``_ulp_tensor``) are ``ulp_diff``'s
    numpy arithmetic, extremes, signed zeros and nonfinite pairs included."""
    rng = np.random.default_rng(11)
    a = rng.standard_normal(4096).astype(dtype) * np.asarray(10.0, dtype) ** rng.integers(-4, 4, 4096).astype(dtype)
    b = a.copy()
    b[::3] = np.nextafter(a[::3], np.inf)
    b[1::7] = -a[1::7]
    b[2::11] = np.nan
    a[5::13] = np.inf
    info = np.finfo(dtype)
    a[:4], b[:4] = [0.0, -0.0, info.max, info.tiny], [-0.0, 0.0, -info.max, -info.tiny]
    want = ref_nl.ulp_diff(a, b)
    np.testing.assert_array_equal(numlens._ulp_tensor(torch.from_numpy(a), torch.from_numpy(b)).numpy(), want)
    np.testing.assert_array_equal(numlens.ulp_diff(a, b), want)


def test_rejects_unsupported_dtypes():
    """tests/test_numlens.py:246."""
    with pytest.raises(TypeError):
        numlens.ulp_diff(np.arange(3), np.arange(3))
    with pytest.raises(TypeError):
        numlens.ulp_diff(np.ones(2, np.float32), np.ones(2, np.float64))


# ---------------------------------------------------------------------------
# pillar 2: the drift audit (TestDriftAudit)
# ---------------------------------------------------------------------------
@pytest.fixture
def shadow():
    numlens._SHADOW_EVERY = 1  # audit every sampled dispatch


_PLAIN_CALL = fusion._Program.__call__


def _bumped(monkeypatch, ulps, every=1):
    """Make every program's float output differ from its plain replay by
    ``ulps`` ULP on every ``every``-th element of each shard."""
    run = _PLAIN_CALL

    def call(self, flat):
        out = []
        for t in run(self, flat):
            if t.dtype.is_floating_point and t.numel():
                t = t.clone()
                view = t.reshape(-1)[::every]
                for _ in range(ulps):
                    view.copy_(torch.nextafter(view, torch.full_like(view, math.inf)))
            out.append(t)
        return tuple(out)

    monkeypatch.setattr(fusion._Program, "__call__", call)


@pytest.mark.usefixtures("shadow")
def test_bitwise_identical_elementwise_chain_is_zero_ulp():
    """tests/test_numlens.py:257."""
    a, b = _split_input(seed=1), _split_input(seed=2)
    (ht.exp(a * 0.5) + b * 2.0 - 1.0).numpy()
    led = numlens.drift_ledger()
    assert led["programs"] and led["max_ulp"] == 0, led


@pytest.mark.usefixtures("shadow")
def test_reorder_sensitive_reduction_drifts_nonzero(monkeypatch):
    """tests/test_numlens.py:265, kept divergence: the CPU's program is its
    plain module, so the reductions that drift under jit read 0 here; the
    ledger's arithmetic is held on a program made to differ from its replay
    by a known number of ULP (3 on every element, then 5 on every second:
    p50 is numpy's median, the mean of the two middle values)."""
    rng = np.random.default_rng(7)
    big = ht.array(rng.standard_normal((4096, 32)).astype(np.float32), split=0)
    big.numpy()
    telemetry.reset()
    float(ht.sum((big / 3.0).sum(axis=1)))
    float(ht.std(big * big + 1.0))
    float(ht.mean(ht.exp(big * 0.1) * big))
    led = numlens.drift_ledger()
    assert len(led["programs"]) >= 3 and led["max_ulp"] == 0, led  # 0 by construction
    _bumped(monkeypatch, 3)
    fusion.clear_cache()
    telemetry.reset()
    (big / 3.0).numpy()
    led = numlens.drift_ledger()
    (rec,) = led["programs"].values()
    assert (rec["p50_ulp"], rec["max_ulp"], led["max_ulp"]) == (3, 3, 3) and led["worst_program"] is not None
    assert "true_divide" in str(led["worst_family"]) or "div" in str(led["worst_family"])
    _bumped(monkeypatch, 5, every=2)
    fusion.clear_cache()
    telemetry.reset()
    (big * 0.5).numpy()  # an even count of elements: half 0, half 5 -> (0 + 5) / 2 -> 2
    (rec,) = numlens.drift_ledger()["programs"].values()
    assert (rec["p50_ulp"], rec["max_ulp"]) == (int((0 + 5) / 2), 5)
    _bumped(monkeypatch, 20)  # past the counted range: the median by selection
    fusion.clear_cache()
    telemetry.reset()
    (big - 0.25).numpy()
    (rec,) = numlens.drift_ledger()["programs"].values()
    assert (rec["p50_ulp"], rec["max_ulp"]) == (20, 20)


@pytest.mark.usefixtures("shadow")
def test_drift_past_threshold_raises_a_finding(monkeypatch):
    """tests/test_numlens.py:285 (a bump of 1 ULP stands in for jit's
    reassociation)."""
    numlens._MAX_ULP = 0
    _bumped(monkeypatch, 1)
    big = ht.array(np.random.default_rng(7).standard_normal((4096, 32)).astype(np.float32), split=0)
    big.numpy()
    telemetry.reset()
    float(ht.sum((big / 3.0).sum(axis=1)))
    hits = [f for f in numlens.findings() if f["rule"] == "numlens.drift"]
    assert hits and hits[0]["severity"] == "warning" and "ULP" in hits[0]["message"]


def test_shadow_throttle():
    """tests/test_numlens.py:299."""
    numlens._SHADOW_EVERY = 4
    a = _split_input()
    for _ in range(8):
        float(ht.sum(ht.exp(a * 0.1)))
    assert sum(v["samples"] for v in numlens.drift_ledger()["programs"].values()) == 2


# ---------------------------------------------------------------------------
# pillar 3: the SDC canary (TestSDCSentinel)
# ---------------------------------------------------------------------------
def test_healthy_mesh_stays_silent():
    """tests/test_numlens.py:320."""
    ht.get_comm()
    r = numlens.run_canary()
    assert r is not None and r["mismatches"] == [] and r["ms"] > 0.0
    assert [f for f in numlens.findings() if f["rule"] == "numlens.sdc"] == []
    assert resilience.degraded_devices() == set()


@pytest.mark.parametrize("p", [3, 5, 8])
def test_injected_sdc_names_the_device_and_escalates(p):
    """tests/test_numlens.py:330, on an explicit mesh (``comm``): the index
    names the shard, as the CPU mesh's shards share one device."""
    comm = MeshCommunication([torch.device("cpu")] * p)
    idx = p - 1
    dev = str(comm.devices[idx])
    with resilience.inject(f"numeric.sdc.{idx}", times=3):
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            for _ in range(3):
                assert numlens.run_canary(comm=comm)["mismatches"] == [dev]
    hits = [f for f in numlens.findings() if f["rule"] == "numlens.sdc"]
    assert len(hits) == 3 and {f["index"] for f in hits} == {idx}
    assert hits[0]["device"] == dev and dev in hits[0]["message"] and f"index {idx}" in hits[0]["message"]
    assert dev in resilience.degraded_devices()
    degraded = [w for w in caught if issubclass(w.category, resilience.MeshDegradedWarning)]
    assert len(degraded) == 1 and dev in str(degraded[0].message)
    assert resilience.device_fault_counts()[dev] == 3


def test_canary_summary_in_the_block():
    """tests/test_numlens.py:359."""
    numlens.run_canary(comm=ht.get_comm())
    blk = numlens.numerics_block()
    assert blk["canary"]["runs"] == 1 and blk["canary"]["devices"] == ht.get_comm().size
    assert blk["canary"]["mismatches"] == 0


def test_periodic_canary_fires_from_the_hook():
    """tests/test_numlens.py:367."""
    numlens._CANARY_EVERY = 2
    a = _split_input()
    for _ in range(4):
        float(ht.sum(ht.exp(a * 0.1)))
    assert numlens.numerics_block()["canary"].get("runs", 0) == 2


# ---------------------------------------------------------------------------
# pillar 4: training streams (TestTrainingSignals), against heat_tpu's
# ---------------------------------------------------------------------------
def _params(scale):
    return {"w": np.full((4, 4), scale, np.float32), "b": np.full((4,), scale, np.float32)}


def _torch_tree(tree):
    return {k: torch.from_numpy(v) for k, v in tree.items()}


def _jax_tree(tree):
    return {k: jnp.asarray(v) for k, v in tree.items()}


def test_update_ratio_and_streams():
    """tests/test_numlens.py:385."""
    out = numlens.note_training("unit", loss=2.5, params=_torch_tree(_params(1.1)),
                                prev_params=_torch_tree(_params(1.0)))
    want = ref_nl.note_training("unit", loss=2.5, params=_jax_tree(_params(1.1)), prev_params=_jax_tree(_params(1.0)))
    assert out["step"] == 1 and out["loss"] == 2.5
    assert out["update_ratio"] == pytest.approx(0.1 / 1.1, rel=1e-5)
    for k in ("update_norm", "param_norm", "update_ratio"):
        assert out[k] == pytest.approx(want[k], rel=1e-6), k
    st = numlens.training_stats()["unit"]
    assert st == ref_nl.training_stats()["unit"] or (st["steps"], st["last_loss"]) == (1, 2.5)
    assert set(st) == set(ref_nl.training_stats()["unit"])


def test_grad_norm_stream():
    """tests/test_numlens.py:397."""
    out = numlens.note_training("unit", grads=_torch_tree(_params(2.0)))
    want = ref_nl.note_training("unit", grads=_jax_tree(_params(2.0)))
    assert out["grad_norm"] == pytest.approx(2.0 * math.sqrt(20.0), rel=1e-6)
    assert out["grad_norm"] == pytest.approx(want["grad_norm"], rel=1e-6)


def test_overflow_detector():
    """tests/test_numlens.py:401."""
    for nl in (numlens, ref_nl):
        nl.note_training("boom", loss=float("nan"))
        hits = [f for f in nl.findings() if f["rule"] == "numlens.overflow"]
        assert len(hits) == 1 and hits[0]["severity"] == "error"
        assert nl.training_stats()["boom"]["overflows"] == 1
    assert numlens.findings()[0]["message"] == ref_nl.findings()[0]["message"]


def test_plateau_detector_flags_once_and_rearms():
    """tests/test_numlens.py:408."""
    for nl in (numlens, ref_nl):
        for _ in range(nl._PLATEAU_WINDOW):
            nl.note_training("flat", loss=1.0)
        assert nl.training_stats()["flat"]["plateau"]
        nl.note_training("flat", loss=1.0)
        assert len([f for f in nl.findings() if f["rule"] == "numlens.plateau"]) == 1
        for i in range(nl._PLATEAU_WINDOW):
            nl.note_training("flat", loss=1.0 + 0.1 * i)
        assert not nl.training_stats()["flat"]["plateau"]
    assert numlens.training_stats() == ref_nl.training_stats()


def test_noisy_loss_is_not_a_plateau():
    """tests/test_numlens.py:423."""
    for i in range(2 * numlens._PLATEAU_WINDOW):
        numlens.note_training("noisy", loss=1.0 + 0.01 * ((-1) ** i))
    assert not numlens.training_stats()["noisy"]["plateau"]
    assert [f for f in numlens.findings() if f["rule"] == "numlens.plateau"] == []


def test_disabled_lens_records_nothing():
    """tests/test_numlens.py:431."""
    numlens.set_mode(0)
    assert numlens.note_training("off", loss=1.0) is None and numlens.training_stats() == {}


def _classification(n, f=6, classes=3, seed=SEED):
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((classes, f)).astype(np.float32) * 2
    y = rng.integers(0, classes, n).astype(np.int32)
    return (centers[y] + rng.standard_normal((n, f)).astype(np.float32) * 0.5).astype(np.float32), y


@pytest.mark.parametrize("p", [1, 3, 5])
def test_data_parallel_step_feeds_the_stream(p):
    """tests/test_numlens.py:436, against heat_tpu's stream on the same MLP
    and batch (SGD): the loss and the update ratio of every step."""
    mine_comm, their_comm = _pair(p)
    x, y = _classification(4 * mine_comm.size, classes=2)
    theirs = ref.nn.DataParallel(ref.nn.MLP(features=(8, 2)), comm=their_comm, optimizer=ref.optim.SGD(0.05))
    theirs.init(0, x[:2])
    mine = ht.nn.DataParallel(mlp_from_flax(jax.tree_util.tree_map(np.asarray, theirs.params["params"]), device="cpu"),
                              comm=mine_comm, optimizer=ht.optim.SGD(0.05))
    mine.init(0, x[:2])
    for _ in range(3):
        got = mine.train_step(x, y)
        theirs.train_step(x, y)
        st = numlens.training_stats()["data_parallel.step"]
        assert st["last_loss"] == got  # the stream's loss is the step's return value
        want = ref_nl.training_stats()["data_parallel.step"]
        assert st["last_loss"] == pytest.approx(want["last_loss"], rel=1e-4)
        assert st["last_update_ratio"] == pytest.approx(want["last_update_ratio"], rel=1e-3)
    assert st["steps"] == 3 and math.isfinite(st["last_loss"]) and st["last_update_ratio"] > 0.0


def test_in_place_optimizer_update_ratio_equals_float64_norms():
    """Adam updates the parameters in place (``p.add_``): the stream reads
    the copy taken before the step, so its update ratio is non-zero and
    equals the float64 norms of the parameters copied around the step."""
    x, y = _classification(12)
    dp = ht.nn.DataParallel(ht.nn.MLP(features=(16, 3), device="cpu"), optimizer=ht.optim.Adam(1e-2)).init(1, x[:2])
    for _ in range(3):
        before = torch.cat([q.detach().reshape(-1).double() for q in dp.module.parameters()])
        dp.train_step(x, y)
        after = torch.cat([q.detach().reshape(-1).double() for q in dp.module.parameters()])
        want = float((after - before).norm() / (after.norm() + 1e-12))
        got = numlens.training_stats()["data_parallel.step"]["last_update_ratio"]
        assert want > 0.0 and got == pytest.approx(want, rel=1e-5)


def test_daso_merges_feed_the_stream():
    """heat_tpu/optim/dp_optimizer.py:358-368's stream: one record per
    global merge, its loss the step's return value, its update ratio that of
    every replica's flat parameters across the merge."""
    mesh = MeshCommunication([torch.device("cpu")] * 4)
    x, y = _classification(16)
    daso = ht.optim.DASO(ht.optim.SGD(0.1), total_epochs=5, warmup_epochs=1, cooldown_epochs=1, nodes=2,
                         local_skip_factor=1, comm=mesh)
    daso.add_model(ht.nn.MLP(features=(16, 3), device="cpu"), 0, x[:4])
    merges = 0
    for b in range(0, 16, 8):
        before = torch.cat([q.detach().reshape(-1).double() for r in daso.replicas for q in r.parameters()])
        loss = daso.step(x[b:b + 8], y[b:b + 8])
        merges += 1  # warmup: every batch merges
        after = torch.cat([q.detach().reshape(-1).double() for r in daso.replicas for q in r.parameters()])
        st = numlens.training_stats()["daso.merge"]
        assert st["steps"] == merges and st["last_loss"] == loss
        assert st["last_update_ratio"] > 0.0
        # the merge moves the replicas' parameters a part of the step's whole update
        assert st["last_update_ratio"] <= float((after - before).norm() / after.norm()) * (1 + 1e-5)


# ---------------------------------------------------------------------------
# the seams (TestSeams)
# ---------------------------------------------------------------------------
def test_report_carries_the_numerics_block():
    """tests/test_numlens.py:462."""
    blk = telemetry.report()["numerics"]
    assert set(ref_tel.report()["numerics"]) == set(blk)
    assert blk["mode"] == "full"
    assert "numerics" in json.loads(telemetry.report_json())


def test_reset_clears_the_session_but_keeps_the_mode():
    """tests/test_numlens.py:472."""
    float(ht.sum(_split_input() * 2.0))
    assert numlens.numerics_block()["dispatches_seen"] > 0
    telemetry.reset()
    blk = numlens.numerics_block()
    assert blk["dispatches_seen"] == 0 and blk["tensor_stats"] == {} and blk["mode"] == "full"


def test_numeric_events_export_as_counter_tracks_and_validate(tmp_path):
    """tests/test_numlens.py:483."""
    telemetry.set_mode(2)
    telemetry.reset()
    float(ht.sum(ht.exp(_split_input() * 0.25)))
    numeric = [e for e in telemetry.events() if e.get("kind") == "numeric"]
    assert numeric and numeric[0]["event"] == "stats"
    doc = telemetry.export_trace()
    counters = [e for e in doc["traceEvents"] if e.get("ph") == "C" and e.get("cat") == "numeric"]
    assert counters and any(e["name"].endswith(":saturation") for e in counters)
    assert telemetry.validate_trace(doc) == []
    paths = []
    for host in range(2):
        path = tmp_path / f"trace_{host}.json"
        path.write_text(json.dumps(doc))
        paths.append(str(path))
    assert telemetry.validate_trace(telemetry.merge_traces(paths)) == []


def test_validator_rejects_a_broken_counter_track():
    """tests/test_numlens.py:514."""
    doc = {"traceEvents": [{"ph": "C", "pid": 0, "tid": 0, "ts": 1.0, "cat": "numeric", "name": "numerics:x[0]",
                            "args": {"rms": "not-a-number"}}]}
    assert any("non-numeric" in p for p in telemetry.validate_trace(doc))


def test_errstate_nonfinite_names_the_producing_program():
    """tests/test_numlens.py:523."""
    x = ht.array(np.full((4 * ht.get_comm().size, 2), -1.0, np.float32), split=0)
    y = ht.log(x) + 1.0  # NaN, pending
    assert fusion.is_deferred(y)
    with ht.errstate(nonfinite="warn"):
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            y.numpy()
    hits = [w for w in caught if issubclass(w.category, resilience.NonFiniteWarning)]
    assert len(hits) == 1
    msg = str(hits[0].message)
    assert "produced by fused program" in msg and "cid" in msg
    assert any(info["key"] in msg for info in fusion._PROGRAM_INFO.values())
    found = [f for f in numlens.findings() if f["rule"] == "numlens.nonfinite"]
    assert len(found) == 1 and found[0]["program"] is not None and found[0]["cid"] is not None


def test_flight_bundle_embeds_numeric_findings(tmp_path):
    """tests/test_numlens.py:551 (the bundle's ``diagnosis`` comes with
    tracelens)."""
    prev_flight = health_runtime.set_flight(True, 256)
    prev_dir = health_runtime.set_dump_dir(str(tmp_path))
    try:
        numlens._add_finding("numlens.sdc", "error", "synthetic", device="d0")
        float(ht.sum(_split_input() * 2.0))
        with open(health_runtime.dump_flight(reason="numlens-test")["path"]) as fh:
            bundle = json.load(fh)
        assert "numlens.sdc" in [f.get("rule") for f in bundle["numerics"]["findings"]]
        assert "drift" in bundle["numerics"] and "canary" in bundle["numerics"]
    finally:
        health_runtime.set_dump_dir(prev_dir)
        health_runtime.set_flight(prev_flight[0], prev_flight[1])


# ---------------------------------------------------------------------------
# the command line (TestCLI)
# ---------------------------------------------------------------------------
def test_numerics_verb_live_and_from_file(tmp_path):
    """tests/test_numlens.py:615; one saved report renders to the same text
    through both command lines."""
    float(ht.sum(ht.exp(_split_input() * 0.1)))
    numlens.run_canary(comm=ht.get_comm())
    numlens.note_training("unit", loss=1.5, params=_torch_tree(_params(1.1)), prev_params=_torch_tree(_params(1.0)))
    out = pyio.StringIO()
    assert cli.main(["numerics"], out=out) == 0
    text = out.getvalue()
    assert "numerics (<live>)" in text and "tensor stats" in text and "sdc canary" in text and "train[unit]" in text
    path = str(tmp_path / "report.json")
    telemetry.report_json(path)
    out = pyio.StringIO()
    assert cli.main(["numerics", path, "--json"], out=out) == 0
    doc = json.loads(out.getvalue())
    assert doc["source"] == path and doc["numerics"]["tensor_stats"]
    texts = []
    for main in (cli.main, ref_cli.main):
        out = pyio.StringIO()
        assert main(["numerics", path], out=out) == 0
        texts.append(out.getvalue())
    assert texts[0] == texts[1]


# ---------------------------------------------------------------------------
# the contracts (TestContracts)
# ---------------------------------------------------------------------------
def test_block_reads_never_force_a_pending_chain():
    """tests/test_numlens.py:646."""
    x = ht.exp(_split_input() * 0.5) + 1.0
    assert fusion.is_deferred(x)
    numlens.numerics_block()
    numlens.drift_ledger()
    numlens.tensor_stats()
    numlens.findings()
    telemetry.report()
    assert fusion.is_deferred(x)


def test_lens_never_initializes_the_backend():
    """tests/test_numlens.py:657: armed from the environment, the import,
    every read and a canary attempt build no mesh."""
    code = (
        "from heat_tpu_torch.core import numlens, telemetry, communication\n"
        "assert numlens.mode() == 'full', numlens.mode()\n"
        "assert telemetry._NUMLENS_HOOK is not None\n"
        "assert numlens.numerics_block()['mode'] == 'full'\n"
        "assert numlens.run_canary() is None\n"
        "numlens.note_training('t', loss=1.0)\n"
        "telemetry.report()\n"
        "assert not communication._WORLDS, 'a mesh was built'\n"
        "print('OK')\n"
    )
    env = dict(os.environ, HEAT_TPU_NUMLENS="full")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, env=env, cwd=ROOT, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "OK" in proc.stdout


def test_hook_survives_garbage_without_breaking_the_dispatch(monkeypatch):
    """tests/test_numlens.py:684."""
    def boom(*args, **kwargs):
        raise RuntimeError("boom")

    monkeypatch.setattr(numlens, "_record_stats", boom)
    a = _split_input()
    got = float(ht.sum(a * 2.0))
    terms = a.numpy().astype(np.float64) * 2.0
    assert abs(got - terms.sum()) <= 1e-5 * np.abs(terms).sum()
    blk = numlens.sampling_stats()
    assert blk["dispatches_sampled"] == 1  # the failure is swallowed, the sample counted
