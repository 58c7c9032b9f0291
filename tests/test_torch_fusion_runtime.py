"""The fusion recorder's seams into the runtime layers, against heat_tpu's
with its collective nodes off: the memory gate, the budget and OOM
forensics (tests/test_memory_obs.py), guarded forcing and the errstate
policy at the force (tests/test_resilience.py), the dispatch guard, the
histograms and the auto-dumps (tests/test_health_runtime.py), and the
telemetry blocks with the command line (tests/test_telemetry.py). CPU only.

Held exactly, the port against heat_tpu on the same script: the gate's
counters and ``MemoryBudgetExceeded`` under ``raise`` with the chain still
pending, ``is_oom``'s classification, the degradation and quarantine
counts after an injected ``fusion.compile`` fault, and the command line's
text for the fusion blocks of one report file. A degraded result equals
the port's fusion-off result bit for bit.
"""

from __future__ import annotations

import importlib
import io as pyio
import json
import os
import time
import warnings

import jax
import numpy as np
import pytest
import torch

import heat_tpu as ref
import heat_tpu_torch as ht
from heat_tpu.core import health_runtime as ref_hr
from heat_tpu.core import memledger as ref_ml
from heat_tpu.core import resilience as ref_res
from heat_tpu.core import telemetry as ref_tel
from heat_tpu.core.communication import MeshCommunication as RefMesh
from heat_tpu_torch.core import fusion
from heat_tpu_torch.core import health_runtime as hr
from heat_tpu_torch.core import memledger as ml
from heat_tpu_torch.core import resilience as res
from heat_tpu_torch.core import telemetry as tel
from heat_tpu_torch.core.communication import MeshCommunication
from test_torch_parity import on_cpu  # noqa: F401

cli = importlib.import_module("heat_tpu_torch.telemetry")
ref_cli = importlib.import_module("heat_tpu.telemetry")

MESHES = [1, 3, 5]
#: (package, recorder, ledger, resilience, telemetry, health) of each side
PORT = (ht, fusion, ml, res, tel, hr)
REF = (ref, ref.fusion, ref_ml, ref_res, ref_tel, ref_hr)


@pytest.fixture(autouse=True)
def runtime(on_cpu, tmp_path):  # noqa: F811 - the harness's fixture, first
    """Both recorders on (heat_tpu's without its collective nodes), the
    gates disarmed, ambient faults suspended, clean counters, dumps into a
    temporary directory; restored after."""
    was = ref.fusion.set_enabled(True), ref.fusion.set_collectives_enabled(False), fusion.set_enabled(True)
    mine_collectives = fusion.set_collectives_enabled(False)
    budgets = ml.set_budget(None), ref_ml.set_budget(None)
    modes = tel.set_mode(1), ref_tel.set_mode(1)
    dirs = hr.set_dump_dir(str(tmp_path)), ref_hr.set_dump_dir(str(tmp_path))
    suspend = res.suspended(), ref_res.suspended()
    for s in suspend:
        s.__enter__()
    for pkg, fus, led, _, t, _ in (PORT, REF):
        fus.clear_cache()
        t.reset()
        led.reset()
    yield str(tmp_path)
    for s in suspend:
        s.__exit__(None, None, None)
    ml.set_budget(*budgets[0])
    ref_ml.set_budget(*budgets[1])
    hr.set_dump_dir(dirs[0])
    ref_hr.set_dump_dir(dirs[1])
    ref.fusion.set_enabled(was[0])
    ref.fusion.set_collectives_enabled(was[1])
    fusion.set_collectives_enabled(mine_collectives)
    fusion.set_enabled(was[2])
    tel.set_mode(modes[0])
    ref_tel.set_mode(modes[1])
    for pkg, fus, led, _, t, _ in (PORT, REF):
        fus.clear_cache()
        t.reset()
        led.reset()


def _comm(side, p):
    p = min(p, len(jax.devices()))
    return MeshCommunication([torch.device("cpu")] * p) if side is PORT else RefMesh(jax.devices()[:p])


def _data(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _input(side, p, seed, rows=4):
    comm = _comm(side, p)
    return side[0].array(_data((rows * comm.size + 1, 3), seed), split=0, comm=comm)


def _chain(side, p, seed=1):
    a = _input(side, p, seed)
    return a, side[0].sqrt(side[0].abs(a * 1.5 + 2.0)) - 0.5


def _gate(led) -> dict:
    """The gate's counters, the admission hold's included."""
    return led.gate_stats()


def _expect(a):
    return float(np.sum(np.sqrt(np.abs(a.numpy().astype(np.float64) * 1.5 + 2.0)) - 0.5))


# ---------------------------------------------------------------------------
# the headroom gate (test_memory_obs.py::TestLedgerAttribution)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("p", MESHES)
def test_warn_policy_warns_once_per_program_key_as_heat_tpu(p):
    stats = []
    for side in (PORT, REF):
        pkg, fus, led = side[:3]
        a, x = _chain(side, p)
        led.set_budget(1, "warn")
        with pytest.warns(led.MemoryBudgetWarning):
            got = float(x.sum().item())
        assert got == pytest.approx(_expect(a), rel=1e-5)
        _, x2 = _chain(side, p, 2)  # the same program key, warned already
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            x2.sum().item()
        assert not [w for w in caught if issubclass(w.category, led.MemoryBudgetWarning)]
        stats.append(_gate(led))
    assert stats[0] == stats[1]
    assert stats[0]["warned"] == 1 and stats[0]["exceeded"] == 2


@pytest.mark.parametrize("p", MESHES)
def test_raise_policy_leaves_the_chain_pending_as_heat_tpu(p):
    stats = []
    for side in (PORT, REF):
        pkg, fus, led = side[:3]
        a, x = _chain(side, p, 4)
        led.set_budget(1, "raise")
        with pytest.raises(led.MemoryBudgetExceeded):
            float(x.sum().item())
        assert fus.is_deferred(x), "the refused dispatch consumed the chain"
        stats.append(_gate(led))
        led.set_budget(None)
        assert float(x.sum().item()) == pytest.approx(_expect(a), rel=1e-5)
        assert fus.cache_stats()["degraded"] == 0
    assert stats[0] == stats[1] and stats[0]["raised"] == 1


def test_drain_forces_the_other_roots_and_never_redispatches_the_gated_chain():
    big = ht.ones((4096 * 3, 8), split=0, comm=_comm(PORT, 3)) * 2.0
    assert fusion.is_deferred(big)
    a = _input(PORT, 3, 20)
    x = ht.exp(a * 0.5) + 1.0
    ml.set_budget(1, "drain")
    with pytest.warns(ml.MemoryBudgetWarning):  # still over after the drain
        got = float(x.sum().item())
    assert got == pytest.approx(float(np.sum(np.exp(a.numpy().astype(np.float64) * 0.5) + 1.0)), rel=1e-5)
    stats = ml.gate_stats()
    assert stats["drains"] >= 1 and stats["drained_roots"] >= 1
    assert not fusion.is_deferred(big), "the drain left the root pending"
    for rec in fusion.programs().values():
        assert rec["dispatches"] == 1 and rec["roots"] == 1, rec
    assert tel.async_forcing()["blocking_syncs"]["drain"] == stats["drained_roots"]


def test_a_generous_budget_admits():
    _, x = _chain(PORT, 3, 6)
    ml.set_budget(0.99, "warn")  # of the host's memory without CUDA
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        x.sum().item()
    assert not [w for w in caught if issubclass(w.category, ml.MemoryBudgetWarning)]
    assert ml.gate_stats()["allowed"] >= 1 and ml.budget_info()["budget_bytes"] > 0


def test_parse_budget_and_the_knob_as_heat_tpu():
    for led in (ml, ref_ml):
        assert led.parse_budget("512MiB") == 512 * (1 << 20)
        assert led.parse_budget("2kb") == 2000 and led.parse_budget("2G") == 2 << 30
        assert led.parse_budget(4096) == 4096 and led.parse_budget("0.5") == 0.5
        assert led.parse_budget("off") is None and led.parse_budget(None) is None and led.parse_budget("0") is None
        with pytest.warns(UserWarning):
            assert led._parse_env_budget("zz.bogus") is None
        assert led._parse_env_budget("1MiB") == 1 << 20
        led.set_budget("1GiB", "drain")
        info = led.budget_info()
        assert info["budget_bytes"] == 1 << 30 and info["policy"] == "drain" and "checks" in info
        with pytest.raises(ValueError):
            led.set_budget(1, "panic")
    assert set(ml.budget_info()) == set(ref_ml.budget_info())


def test_gate_decisions_land_on_the_timeline():
    tel.set_mode(2)
    ml.set_budget(1, "warn")
    a = _input(PORT, 3, 14)
    with warnings.catch_warnings(record=True):
        warnings.simplefilter("always")
        float((a + 0.5).sum().item())
    gates = [e for e in tel.events() if e["kind"] == "memory_gate"]
    assert gates and gates[0]["over"] and gates[0]["policy"] == "warn"
    assert tel.validate_trace(tel.export_trace()) == []


# ---------------------------------------------------------------------------
# OOM forensics (test_memory_obs.py::TestOOMForensics)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("p", MESHES)
def test_an_injected_exhaustion_writes_the_forensic_and_degrades_bit_for_bit(p):
    a = _input(PORT, p, 7)
    with fusion.disabled():
        expect = (ht.exp(a * 0.25) + 1.0).sum().item()
    x = ht.exp(a * 0.25) + 1.0
    with res.inject("memory.exhausted", times=1):
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            got = x.sum().item()
    kinds = {w.category for w in caught}
    assert ml.MemoryExhaustedWarning in kinds and res.DegradedDispatchWarning in kinds
    assert got == expect
    report = ml.last_oom()
    assert report["program"] and "memory.exhausted" in report["error"]
    assert report["by_owner"] and isinstance(report["top_buffers"], list)
    assert report["static_peak_bytes"] > 0
    assert "by owner" in str(next(w.message for w in caught if w.category is ml.MemoryExhaustedWarning))
    assert sum(tel.degraded_counts().values()) == 1
    assert set(report) == {
        "error", "program", "family", "static_peak_bytes", "live_total_bytes", "by_owner", "top_buffers",
        "recent_dispatches", "watermark_bytes", "budget",
    }


def test_the_forensic_carries_the_recent_dispatches_in_verbose_mode():
    tel.set_mode(2)
    a = _input(PORT, 3, 8)
    float((a + 1.0).sum().item())
    y = ht.log(ht.abs(a) + 2.0)
    with res.inject("memory.exhausted", times=1):
        with warnings.catch_warnings(record=True):
            warnings.simplefilter("always")
            y.sum().item()
    report = ml.last_oom()
    assert report["recent_dispatches"] and "program" in report["recent_dispatches"][-1]
    assert tel.report()["memory"]["last_oom"]["program"] == report["program"]


def test_is_oom_classifies_as_heat_tpu():
    cases = [
        MemoryError("boom"), RuntimeError("RESOURCE_EXHAUSTED: out of memory"),
        RuntimeError("Out of memory allocating 1GB"), ValueError("shape mismatch"),
        RuntimeError("deadline exceeded"), res.FaultInjected("injected fault at memory.exhausted"),
    ]
    assert [ml.is_oom(e) for e in cases] == [ref_ml.is_oom(e) for e in cases] == [True, True, True, False, False, True]
    assert ml.is_oom(torch.cuda.OutOfMemoryError("CUDA out of memory. Tried to allocate 2.00 GiB"))


# ---------------------------------------------------------------------------
# static peaks and costs (test_memory_obs.py::TestStaticPeaks)
# ---------------------------------------------------------------------------
def test_program_costs_carry_the_static_peak_from_the_node_shapes():
    a = _input(PORT, 3, 10)
    float((ht.sqrt(ht.abs(a)) + 3.0).sum().item())
    costs = fusion.program_costs()
    (cost,) = costs.values()
    mem = cost["memory"]
    assert mem["peak_bytes"] == mem["argument_bytes"] + mem["output_bytes"] + mem["temp_bytes"] > 0
    # leaves: p shards of ceil((4p + 1) / p) x 3 float32 and the scalar, a
    # float64 0-d tensor
    shards = a.comm.size
    assert mem["argument_bytes"] == cost["operand_bytes"] == shards * -(-a.gshape[0] // shards) * 3 * 4 + 8
    assert mem["output_bytes"] == cost["result_bytes"] == 4
    assert cost["flops"] > 0 and cost["family"] and cost["dispatches"] == 1
    assert fusion.programs()[next(iter(costs))]["cost"]["memory"] == mem
    block = tel.report()["programs"]
    assert block["cost_errors"] == 0 and block["top"][0]["cost"]["memory"] == mem


def test_a_failed_cost_estimate_warns_once_and_counts():
    keys, warned = set(fusion._COST_ERROR_KEYS), fusion._COST_ERROR_WARNED
    fusion._COST_ERROR_KEYS.clear()
    fusion._COST_ERROR_WARNED = False
    try:
        with pytest.warns(fusion.ProgramCostWarning):
            fusion._note_cost_error("k1", {"error": "boom"})
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            fusion._note_cost_error("k2", {"error": "boom2"})
        assert not [w for w in caught if issubclass(w.category, fusion.ProgramCostWarning)]
        assert fusion.cost_error_count() == 2
        fusion._note_cost_error("k1", {"flops": 1.0})
        assert fusion.cost_error_count() == 1
    finally:
        fusion._COST_ERROR_KEYS.clear()
        fusion._COST_ERROR_KEYS.update(keys)
        fusion._COST_ERROR_WARNED = warned


# ---------------------------------------------------------------------------
# guarded forcing (test_resilience.py, the fusion sites)
# ---------------------------------------------------------------------------
def _nine_op_chain(pkg, a, b):
    c = (a + b) * 2.0
    c = pkg.exp(c)
    c = c - b
    d = pkg.abs(c)
    e = d + a
    f = pkg.sqrt(pkg.abs(e))
    g = f / (d + 1.0)
    return g * b


@pytest.mark.parametrize("p", MESHES)
def test_an_injected_compile_fault_degrades_bit_for_bit_then_quarantines_as_heat_tpu(p):
    counts = []
    for side in (PORT, REF):
        pkg, fus, _, rs, t, _ = side
        comm = _comm(side, p)
        a_np, b_np = _data((8 * comm.size, 4), 0), _data((8 * comm.size, 4), 1)
        with fus.disabled():
            eh = _nine_op_chain(pkg, pkg.array(a_np, split=0, comm=comm), pkg.array(b_np, split=0, comm=comm))
            expected, expected_sum = eh.numpy(), float(pkg.sum(eh).numpy())
        fus.clear_cache()
        t.reset()
        a, b = pkg.array(a_np, split=0, comm=comm), pkg.array(b_np, split=0, comm=comm)
        h = _nine_op_chain(pkg, a, b)
        s = pkg.sum(h)
        assert fus.is_deferred(s)
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            with rs.inject("fusion.compile", times=1):
                got_sum = float(s.numpy())
                got = h.numpy()
        if side is PORT:  # the port's replay is its eager engines' ops
            assert np.array_equal(got, expected) and got_sum == expected_sum
        else:
            np.testing.assert_allclose(got, expected, rtol=1e-6)
        assert sum(issubclass(w.category, rs.DegradedDispatchWarning) for w in caught) == 1
        s2 = pkg.sum(_nine_op_chain(pkg, pkg.array(a_np, split=0, comm=comm), pkg.array(b_np, split=0, comm=comm)))
        with rs.inject("fusion.compile", times=1) as spec:
            float(s2.numpy())
        assert spec.fired == 0, "the quarantine skips the compile"
        stats = fus.cache_stats()
        counts.append((sum(t.degraded_counts().values()), stats["degraded"], stats["quarantined"],
                       stats["quarantine_hits"], [rec["stages"] for rec in t.degraded().values()]))
    assert counts[0] == counts[1] == (1, 1, 1, 1, [{"compile": 1}])


def test_an_execute_fault_on_a_cached_program_degrades_to_the_eager_result():
    comm = _comm(PORT, 3)
    a_np, b_np = _data((24, 4), 3), _data((24, 4), 4)
    with fusion.disabled():
        expected = ht.sum(_nine_op_chain(ht, ht.array(a_np, split=0, comm=comm), ht.array(b_np, split=0, comm=comm))).item()
    a, b = ht.array(a_np, split=0, comm=comm), ht.array(b_np, split=0, comm=comm)
    assert ht.sum(_nine_op_chain(ht, a, b)).item() == expected  # builds and caches the program
    s2 = ht.sum(_nine_op_chain(ht, a, b))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", res.DegradedDispatchWarning)
        with res.inject("fusion.execute", times=1):
            got = s2.item()
    assert got == expected
    (rec,) = tel.degraded().values()
    assert rec["stages"] == {"execute": 1} and "FaultInjected" in rec["last_error"]


def test_clear_cache_and_clear_quarantine_lift_the_quarantine():
    comm = _comm(PORT, 3)
    a_np, b_np = _data((12, 2), 5), _data((12, 2), 6)
    s = ht.sum(ht.array(a_np, split=0, comm=comm) * 2.0 + ht.array(b_np, split=0, comm=comm))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", res.DegradedDispatchWarning)
        with res.inject("fusion.compile", times=1):
            s.item()
    assert fusion.cache_stats()["quarantined"] == 1
    fusion.clear_quarantine()
    assert fusion.cache_stats()["quarantined"] == 0 and fusion.cache_stats()["degraded"] == 1
    fusion.clear_cache()
    s2 = ht.sum(ht.array(a_np, split=0, comm=comm) * 2.0 + ht.array(b_np, split=0, comm=comm))
    s2.item()
    stats = fusion.cache_stats()
    assert stats["compiles"] == 1 and stats["degraded"] == 0


def test_the_record_policy_falls_back_or_propagates():
    def bad(t):
        raise TypeError("operands rejected")

    def oom(t):
        raise MemoryError("host OOM while recording")

    x = ht.array(np.ones(6, np.float32), split=0, comm=_comm(PORT, 3))
    assert fusion.defer_local(bad, x, None, {}) is None
    assert tel.unfused_reasons() == {"local": {"record_failed:TypeError": 1}}
    with pytest.raises(MemoryError):
        fusion.defer_local(oom, x, None, {})
    with res.inject("fusion.record", times=1):
        y = ht.exp(x)  # the eager engine runs the op
    assert not fusion.is_deferred(y) and tel.unfused_reasons()["local"]["record_failed:FaultInjected"] == 1


@pytest.mark.parametrize("p", MESHES)
def test_errstate_applies_at_the_force_with_the_chain_left_pending(p):
    a = ht.array(np.full(4 * p + 1, -1.0, np.float32), split=0, comm=_comm(PORT, p))
    y = ht.log(a) + 1.0
    with ht.errstate(nonfinite="raise"):
        assert fusion.is_deferred(y)  # no check at the op: nothing ran
        with pytest.raises(res.NonFiniteError, match="fused program"):
            y.numpy()
    assert isinstance(y._payload, fusion.LazyArray)  # the raise left the wrapper unforced
    assert np.isnan(y.numpy()).all()
    # the padding is never checked: log(0) of a padding row would be -inf
    z = ht.log(ht.abs(ht.array(np.arange(1, 4 * p + 2, dtype=np.float32), split=0, comm=_comm(PORT, p))))
    with ht.errstate(nonfinite="raise"):
        z.numpy()
    with fusion.disabled(), ht.errstate(nonfinite="raise"), pytest.raises(res.NonFiniteError):
        ht.log(a)  # the eager engines check at the op


def test_a_degraded_force_is_still_checked():
    y = ht.log(ht.array(np.full(6, -1.0, np.float32), split=0, comm=_comm(PORT, 3))) * 2.0
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", res.DegradedDispatchWarning)
        with res.inject("fusion.compile", times=1), ht.errstate(nonfinite="raise"):
            with pytest.raises(res.NonFiniteError):
                y.larray
    assert fusion.cache_stats()["degraded"] == 1


# ---------------------------------------------------------------------------
# health (test_health_runtime.py)
# ---------------------------------------------------------------------------
def _bundles(tmp, reason):
    return sorted(
        os.path.join(tmp, name) for name in os.listdir(tmp) if f"_{reason}_" in name and not name.endswith(".trace.json")
    )


def test_an_injected_oom_auto_dumps_a_bundle_naming_the_program(runtime):
    a = _input(PORT, 3, 7)
    x = ht.exp(a * 0.25) + 1.0
    with res.inject("memory.exhausted", times=1):
        with warnings.catch_warnings(record=True):
            warnings.simplefilter("always")
            x.sum().item()
    (path,) = _bundles(runtime, "oom")
    with open(path) as fh:
        bundle = json.load(fh)
    assert bundle["reason"] == "oom" and bundle["trace_problems"] == []
    oom = bundle["memory"]["last_oom"]
    assert oom["program"] and oom["program"] in bundle["programs"]["program_keys"]
    assert _bundles(runtime, "degrade"), "the degrade seam dumps too"


def test_a_degraded_program_auto_dumps():
    a = _input(PORT, 3, 5)
    y = ht.log(ht.abs(a) + 2.0)
    with res.inject("fusion.compile", times=1):
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            y.sum().item()
    assert res.DegradedDispatchWarning in {w.category for w in caught}
    with open(hr.last_dump()["path"]) as fh:
        assert json.load(fh)["reason"] == "degrade"


def _await_stall(deadline_s=3.0):
    end = time.monotonic() + deadline_s
    while time.monotonic() < end:
        stall = hr.last_stall()
        if stall is not None:
            return stall
        time.sleep(0.02)
    return None


def test_a_stall_at_the_dispatch_names_the_program_and_the_pending_roots():
    hr.set_watchdog(deadline_ms=80, policy="warn", enabled=True)
    try:
        a = _input(PORT, 3, 3)
        other = ht.exp(a) * 3.0  # a pending root the diagnosis lists  # noqa: F841
        with res.inject("watchdog.stall:dispatch", times=1):
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                (a * 2.0 + 1.0).sum().item()
                stall = _await_stall()
    finally:
        hr.set_watchdog(deadline_ms=30000, policy="warn", enabled=True)
    assert stall is not None and stall["site"] == "dispatch"
    assert stall["program"] in fusion.cache_stats()["program_keys"] and stall["cids"]
    assert other._payload.cid in [r["cid"] for r in stall["pending_roots"]]
    assert any(str(stall["program"]) in str(w.message) for w in caught if w.category is res.StallWarning)


def test_the_raise_policy_raises_and_the_chain_recovers():
    hr.set_watchdog(deadline_ms=80, policy="raise", enabled=True)
    a = _input(PORT, 3, 4)
    try:
        with res.inject("watchdog.stall:dispatch", times=1):
            with warnings.catch_warnings(record=True):
                warnings.simplefilter("always")
                with pytest.raises(res.StallError):
                    (a + 3.0).sum().item()
    finally:
        hr.set_watchdog(deadline_ms=30000, policy="warn", enabled=True)
    assert fusion.cache_stats()["degraded"] == 0  # a policy signal, never degraded
    assert (a + 3.0).sum().item() == pytest.approx(float(np.sum(a.numpy().astype(np.float64) + 3.0)), rel=1e-5)


def test_the_dispatch_and_compile_tables_fill_per_program():
    for i in range(4):
        (_input(PORT, 3, i) * 2.0 + 1.0).sum().item()
    health = tel.report()["health"]
    keys = set(fusion.cache_stats()["program_keys"])
    for table in ("dispatch", "compile"):
        assert health[table]["*"]["count"] >= 1
        programs = [k for k in health[table] if k != "*"]
        assert programs and set(programs) <= keys
        for key in programs:
            assert {"p50_s", "p90_s", "p99_s"} <= set(health[table][key])
    assert health["compile"]["*"]["count"] == 1 and health["dispatch"]["*"]["count"] == 4
    prev = hr.set_slo(dispatch_ms=0.0, compile_ms=1e9)
    try:
        (_input(PORT, 3, 9) * 2.0 + 1.0).sum().item()
        slo = hr.health_block()["slo"]
        assert slo["dispatch"]["breaches_total"] >= 1 and slo["compile"]["breaches_total"] == 0
    finally:
        hr.set_slo(**{f"{m}_ms": None if v is None else v * 1e3 for m, v in prev.items()})


def test_health_and_telemetry_reads_never_force_a_chain():
    a = _input(PORT, 3, 9)
    pending = a * 0.5 + 2.0
    hr.flight_stats(), hr.health_block(global_view=True), tel.report(), ml.budget_info(), fusion.program_costs()
    assert fusion.is_deferred(pending)
    np.testing.assert_array_equal(pending.numpy(), a.numpy() * np.float32(0.5) + np.float32(2.0))


# ---------------------------------------------------------------------------
# telemetry and the command line (test_telemetry.py, the fusion blocks)
# ---------------------------------------------------------------------------
def _fusion_script(pkg, t, comm):
    x = pkg.array(_data((6 * comm.size + 1, 3), 21), split=0, comm=comm)
    with t.span("fit"):
        y = pkg.exp(x * 0.5) + 1.0
        float(pkg.sum(y).item())
        str(y)
    pkg.add(x, x, out=pkg.zeros_like(x))
    return y


@pytest.mark.parametrize("p", MESHES)
def test_the_report_carries_the_fusion_blocks_as_heat_tpu(p):
    for side in (PORT, REF):
        _fusion_script(side[0], side[4], _comm(side, p))
    mine, theirs = tel.report(), ref_tel.report()
    for key in ("forcing_points", "unfused_reasons", "dispatches"):
        assert mine[key] == theirs[key], key
    assert [rec["misses"] for rec in mine["retraces"].values()] == [rec["misses"] for rec in theirs["retraces"].values()]
    assert mine["degraded"] == theirs["degraded"] == {}
    assert set(mine["fusion_cache"]) == set(theirs["fusion_cache"])
    for key in ("compiles", "hits", "forces", "degraded", "size"):
        assert mine["fusion_cache"][key] == theirs["fusion_cache"][key], key
    assert set(mine["programs"]) == set(theirs["programs"]) == {"cached", "cost_errors", "top"}
    assert [r["dispatches"] for r in mine["programs"]["top"]] == [r["dispatches"] for r in theirs["programs"]["top"]]
    assert mine["spans"]["fit"]["forces"] == theirs["spans"]["fit"]["forces"] == 2
    assert mine["spans"]["fit"]["retraces"] == theirs["spans"]["fit"]["retraces"] == 2
    a, b = mine["async_forcing"], theirs["async_forcing"]
    assert (a["dispatches"], a["roots_dispatched"], a["multi_root_batches"]) == (b["dispatches"], b["roots_dispatched"], b["multi_root_batches"])


def test_scopes_archive_the_fusion_blocks():
    with tel.scope("job"):
        _fusion_script(ht, tel, _comm(PORT, 3))
    doc = tel.scope_reports()["job"]
    assert doc["forcing_points"] and doc["retraces"] and doc["async_forcing"]["dispatches"] == 2
    assert doc["unfused_reasons"] == {"binary": {"out=": 1}}


def test_the_trace_pairs_each_dispatch_with_its_sync_and_validates(tmp_path):
    tel.set_mode(2)
    x = _input(PORT, 3, 22)
    y = ht.exp(x) * 2.0
    cid = y._payload.cid
    y.numpy()
    (disp, sync), = tel.async_pairs()
    assert disp["cid"] == sync["cid"] == cid and disp["program"] in fusion.cache_stats()["program_keys"]
    path = str(tmp_path / "trace.json")
    doc = tel.export_trace(path)
    assert tel.validate_trace(path) == [] and ref_tel.validate_trace(path) == []
    pairs = [e for e in doc["traceEvents"] if e["ph"] in ("b", "e")]
    assert [(e["ph"], e["id"]) for e in pairs] == [("b", str(cid)), ("e", str(cid))]
    names = {e["name"] for e in doc["traceEvents"]}
    assert {"record:exp", "force:larray", "dispatch"} <= names
    assert any(n.startswith("compile:") for n in names)


def test_the_command_line_shows_the_fusion_blocks_of_one_report_as_heat_tpu(tmp_path):
    ml.set_budget(1, "warn")
    a = _input(PORT, 3, 23)
    with warnings.catch_warnings(record=True):
        warnings.simplefilter("always")
        (ht.exp(a) + 1.0).sum().item()
        with res.inject("memory.exhausted", times=1):
            (ht.log(ht.abs(a) + 1.0)).sum().item()
    fusion.program_costs()
    path = str(tmp_path / "report.json")
    tel.report_json(path)
    for cmd in (["show", path], ["memory", path]):
        texts = []
        for c in (cli, ref_cli):
            out = pyio.StringIO()
            assert c.main(cmd, out=out) == 0
            texts.append(out.getvalue())
        assert texts[0] == texts[1], cmd
    out = pyio.StringIO()
    cli.main(["show", path], out=out)
    text = out.getvalue()
    assert "forcing points:" in text and "top programs (of" in text and "degraded:" in text
    out = pyio.StringIO()
    cli.main(["memory", path], out=out)
    text = out.getvalue()
    assert "budget:" in text and "LAST OOM: program" in text and "per-program static peaks" in text
