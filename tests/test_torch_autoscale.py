"""heat_tpu_torch.core.autoscale (``ht.autoscale``) and its seams against
heat_tpu's (tests/test_autoscale.py), case by case. CPU only.

The controller's state machine is held to heat_tpu's directly: both
packages' ``Controller.tick(now=...)`` run over one synthetic timeline of
observations, ``_observe`` patched alike, and give the same decisions and
snapshots, the shrinks and recoveries included (heat_tpu's recorder off,
its batching stops on ``jax.core.trace_state_clean`` in this jax). So do
the knobs, ``health_runtime.breach_fraction`` and ``reset_guards`` on the
same samples and guards, and the session tiers. The cases that force
chains through shedding (the shed refusals and the overload loop) run on
the port alone, held to numpy and to the counts the reference case
asserts, citing it.

A kept divergence: a recovery re-forms the mesh the controller first
shrank, its baseline. Where that is the default mesh (the CPU mesh here)
it holds the devices of heat_tpu's ``reform(None)``; on a card the baseline is the mesh the
tenants ran on (four shards of ``cuda:0``), which ``reform(None)`` (one
``cuda:0``) is not.
"""

from __future__ import annotations

import os
import subprocess
import sys
import threading
import time
import warnings

import jax
import numpy as np
import pytest
import torch

import heat_tpu as ref
import heat_tpu_torch as ht
from heat_tpu.core import autoscale as ref_as
from heat_tpu.core import communication as ref_comm
from heat_tpu.core import health_runtime as ref_hr
from heat_tpu.core import opsplane as ref_op
from heat_tpu.core import resilience as ref_res
from heat_tpu.core import serving as ref_sv
from heat_tpu.core import telemetry as ref_tel
from heat_tpu_torch.core import (
    autoscale, communication, fusion, health_runtime, opsplane, resilience, serving, telemetry,
)
from test_torch_parity import P, on_cpu  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEED = 20261018
_BURN_KEYS = ("target", "fast_s", "slow_s", "threshold", "min_samples")
PAIRS = (
    ("mine", autoscale, serving, opsplane, health_runtime, telemetry),
    ("theirs", ref_as, ref_sv, ref_op, ref_hr, ref_tel),
)


@pytest.fixture(autouse=True)
def clean(on_cpu):  # noqa: F811 - the harness's fixture, first
    """Clean controller, serving and burn state in both packages, exact
    under the fault mix (the reference's ``AutoscaleCase``,
    tests/test_autoscale.py:47-77); the mesh restored after. Both
    recorders start with no live root: a reform drains every live root of
    its process, a pending chain an earlier test left alive included."""
    suspends = [resilience.suspended(), ref_res.suspended()]
    for s in suspends:
        s.__enter__()
    fusion.clear_cache()
    ref.fusion.clear_cache()
    saved = []
    for _, asc, sv, op, hr, tel in PAIRS:
        tel.reset()  # cascades: the controller disarmed, the ops plane reset
        saved.append((hr.set_slo(sync_ms=None, dispatch_ms=None, compile_ms=None), op.set_burn()))
        sv.set_admission(None)
        sv.shed(())
    try:
        yield
    finally:
        for (_, asc, sv, op, hr, tel), (slo, burn) in zip(PAIRS, saved):
            asc.disarm(restore=True)
            sv.shed(())
            op.set_burn(**{k: burn[k] for k in _BURN_KEYS})
            hr.set_slo(**{f"{m}_ms": None if slo[m] is None else slo[m] * 1e3 for m in ("sync", "dispatch", "compile")})
            sv.set_admission(None)
            tel.reset()
        if ref_comm.get_comm().size != len(jax.devices()):
            ref_comm.reform()
        ht.use_comm(None)
        communication.reform()
        for s in reversed(suspends):
            s.__exit__(None, None, None)


def _client_input(seed=0):
    n = 4 * ht.get_comm().size
    return ht.array(np.random.default_rng(seed).standard_normal(n).astype(np.float32), split=0)


def _near64(got, a, scale):
    """A float32 sum against float64, within 1e-5 of the terms' magnitudes."""
    terms = a.numpy().astype(np.float64) * scale
    return abs(got - float(terms.sum())) <= 1e-5 * float(np.abs(terms).sum())


def _arm_burn(op=opsplane, hr=health_runtime):
    """tests/test_autoscale.py:78: a 1 ms dispatch SLO and a 1 s fast window."""
    hr.set_slo(dispatch_ms=1.0)
    op.set_burn(target=0.9, fast_s=1.0, slow_s=4.0, threshold=1.0, min_samples=4)


def _ignite(n=16, op=opsplane, hr=health_runtime):
    """tests/test_autoscale.py:86: n synthetic 50 ms breaches, sampled."""
    for _ in range(n):
        hr._slo_observe("dispatch", 0.05)
    op.sample()


def _world() -> int:
    return communication._built_comm().size


# ---------------------------------------------------------------------------
# session tiers (TestTiers), both packages
# ---------------------------------------------------------------------------
def test_default_tier_is_interactive():
    """tests/test_autoscale.py:97."""
    for _, _, sv, *_ in PAIRS:
        s = sv.Session("plain")
        assert (s.tier, s.deadline_ms) == ("interactive", None)


def test_preemptible_aliases_to_batch():
    """tests/test_autoscale.py:102."""
    assert [sv.Session("spot", tier="preemptible").tier for _, _, sv, *_ in PAIRS] == ["batch", "batch"]


def test_unknown_tier_rejected():
    """tests/test_autoscale.py:106."""
    messages = []
    for _, _, sv, *_ in PAIRS:
        with pytest.raises(ValueError) as err:
            sv.Session("typo", tier="bulk")
        messages.append(str(err.value))
    assert "bulk" in messages[0] and messages[0] == messages[1]


@pytest.mark.parametrize("deadline", [0, -5])
def test_deadline_must_be_positive(deadline):
    """tests/test_autoscale.py:111."""
    for _, _, sv, *_ in PAIRS:
        with pytest.raises(ValueError):
            sv.Session("late", deadline_ms=deadline)


def test_report_carries_tier_and_deadline():
    """tests/test_autoscale.py:117."""
    docs = []
    for _, _, sv, *_ in PAIRS:
        with sv.Session("doc", tier="batch", deadline_ms=250) as s:
            docs.append((s.report()["tier"], s.report()["deadline_ms"]))
    assert docs == [("batch", 250.0)] * 2


def test_shed_rejects_unknown_tier():
    """tests/test_autoscale.py:123."""
    for _, _, sv, *_ in PAIRS:
        with pytest.raises(ValueError):
            sv.shed(("bulk",))
        assert sv.shed_state()["tiers"] == []


def test_shed_state_and_sessions_block_surface_the_flip():
    """tests/test_autoscale.py:128."""
    for _, _, sv, *_ in PAIRS:
        prev = sv.shed(("preemptible",))
        try:
            assert prev == frozenset() and sv.shed_state()["tiers"] == ["batch"]
            assert sv.sessions_block()["admission"]["shed_tiers"] == ["batch"]
        finally:
            sv.shed(())
        assert sv.shed_state()["tiers"] == []


def test_readyz_reflects_active_shedding():
    """tests/test_autoscale.py:139."""
    for _, _, sv, op, *_ in PAIRS:
        assert op.ready_status()["checks"]["shedding"]
        sv.shed(("batch",))
        try:
            doc = op.ready_status()
            assert not doc["checks"]["shedding"] and doc["status"] == "unready"
        finally:
            sv.shed(())
        assert op.ready_status()["checks"]["shedding"]


# ---------------------------------------------------------------------------
# shed containment (TestShedContainment), the port alone
# ---------------------------------------------------------------------------
def test_shed_error_is_typed_and_counted():
    """tests/test_autoscale.py:154: a ShedError is an AdmissionError; the
    chain stays pending; 1 refusal on the session, the module and the
    gauge."""
    serving.shed(("batch",))
    try:
        with serving.Session("bg", tier="batch") as sess:
            a = _client_input(1)
            pending = ht.sum(a * 2.0)
            with pytest.raises(serving.AdmissionError) as err:
                float(pending)
            assert isinstance(err.value, serving.ShedError) and fusion.is_deferred(pending)
            assert sess.stats["shed"] == 1 and serving.shed_state()["refusals"] == 1
    finally:
        serving.shed(())
    assert _near64(float(pending), a, 2.0)  # dispatched once shedding lifted
    opsplane.sample()
    assert "heat_tpu_autoscale_shed_refusals_total 1" in opsplane.render()


def test_interactive_never_gated_while_batch_sheds():
    """tests/test_autoscale.py:177."""
    serving.shed(("batch",))
    try:
        with serving.Session("fg", tier="interactive", deadline_ms=50):
            a = _client_input(2)
            assert _near64(float(ht.sum(a * 3.0)), a, 3.0)
    finally:
        serving.shed(())


# ---------------------------------------------------------------------------
# the controller (TestControllerDecisions), ticked with poll()
# ---------------------------------------------------------------------------
def _arm_inert(**over):
    """tests/test_autoscale.py:195: a daemon cadence far out, so every
    decision comes from an explicit poll(); the shrink far out unless
    overridden."""
    cfg = dict(interval_s=60.0, cooldown_s=0.3, shrink_after_s=3600.0, max_actions=4, min_devices=1, shrink_n=1)
    cfg.update(over)
    return autoscale.arm(**cfg)


def test_burn_edge_sheds_then_sustained_clear_recovers():
    """tests/test_autoscale.py:206."""
    _arm_burn()
    ctl = _arm_inert(cooldown_s=0.3)
    _ignite()
    assert autoscale.poll() == "shed_on"
    assert ctl.state == "shedding" and serving.shed_state()["tiers"] == ["batch"]
    assert ctl.burn_edges >= 1  # on_burn woke the loop
    _ignite(4)
    autoscale.poll()
    assert ctl.decisions["shed_on"] == 1
    time.sleep(1.1)
    opsplane.sample()
    autoscale.poll()
    assert ctl.state == "shedding" and ctl.decisions["shed_off"] == 0
    time.sleep(0.35)
    assert autoscale.poll() in ("shed_off", "recover")
    assert ctl.state == "ok" and serving.shed_state()["tiers"] == []
    assert (ctl.decisions["shed_on"], ctl.decisions["shed_off"]) == (1, 1)


def test_burn_reriring_during_cooldown_restarts_it():
    """tests/test_autoscale.py:234."""
    _arm_burn()
    ctl = _arm_inert(cooldown_s=0.5)
    _ignite()
    assert autoscale.poll() == "shed_on"
    time.sleep(1.1)
    opsplane.sample()
    autoscale.poll()
    _ignite()
    autoscale.poll()
    time.sleep(1.1)
    opsplane.sample()
    autoscale.poll()
    assert ctl.state == "shedding", "the cooldown survived a burn re-rise"
    assert ctl.decisions["shed_on"] == 1


def test_min_devices_floor_blocks_the_shrink():
    """tests/test_autoscale.py:254."""
    a = _client_input(3)
    float(ht.sum(a * 2.0))
    world = _world()
    _arm_burn()
    ctl = _arm_inert(min_devices=world, shrink_after_s=0.0)
    _ignite()
    assert autoscale.poll() == "shed_on"
    assert autoscale.poll() is None
    assert ctl.decisions["shrink"] == 0 and ctl.mesh_actions == 0 and _world() == world


def test_max_actions_budget_bounds_mesh_moves():
    """tests/test_autoscale.py:270."""
    a = _client_input(4)
    float(ht.sum(a * 2.0))
    world = _world()
    if world < 2:
        pytest.skip("needs a multi-device mesh to shrink")
    _arm_burn()
    ctl = _arm_inert(max_actions=0, shrink_after_s=0.0)
    _ignite()
    assert autoscale.poll() == "shed_on"
    assert autoscale.poll() is None
    assert (ctl.decisions["shrink"], ctl.decisions["bound"]) == (0, 1)
    assert autoscale.poll() is None
    assert ctl.decisions["bound"] == 1 and _world() == world


def test_disarm_lifts_shedding_and_unsubscribes():
    """tests/test_autoscale.py:286."""
    _arm_burn()
    ctl = _arm_inert()
    assert ctl._on_burn in opsplane._BURN_CALLBACKS
    _ignite()
    assert autoscale.poll() == "shed_on"
    autoscale.disarm()
    assert not autoscale.armed() and serving.shed_state()["tiers"] == []
    assert autoscale.poll() is None
    assert ctl._on_burn not in opsplane._BURN_CALLBACKS


def test_stats_feed_report_and_metrics():
    """tests/test_autoscale.py:295."""
    ctl = _arm_inert()
    st = autoscale.stats()
    assert st["armed"] and st["state"] == "ok"
    assert telemetry._AUTOSCALE_HOOK is autoscale.stats
    assert telemetry.report()["autoscale"]["state"] == "ok"
    opsplane.sample()
    text = opsplane.render()
    assert "heat_tpu_autoscale_armed 1" in text and "heat_tpu_autoscale_shedding 0" in text
    assert ctl.snapshot()["decisions"]["errors"] == 0


@pytest.mark.parametrize("env", [
    {},
    {"HEAT_TPU_AUTOSCALE_COOLDOWN_S": "not-a-number"},
    {"HEAT_TPU_AUTOSCALE_INTERVAL_S": "0.001", "HEAT_TPU_AUTOSCALE_MAX_ACTIONS": "2"},
    {"HEAT_TPU_AUTOSCALE_MIN_DEVICES": "0", "HEAT_TPU_AUTOSCALE_SHRINK": "3", "HEAT_TPU_AUTOSCALE_SHRINK_AFTER_S": "1.5"},
    {"HEAT_TPU_AUTOSCALE_SHED_TIERS": "preemptible,interactive"},
    {"HEAT_TPU_AUTOSCALE_SHED_TIERS": "bulk"},
    {"HEAT_TPU_AUTOSCALE_SHED_TIERS": " , "},
])
def test_env_knobs_warn_and_keep_defaults(env, monkeypatch):
    """tests/test_autoscale.py:309, and every ``HEAT_TPU_AUTOSCALE_*`` knob:
    both packages read the same configuration and warn alike."""
    for name in [n for n in os.environ if n.startswith("HEAT_TPU_AUTOSCALE_")]:
        monkeypatch.delenv(name)
    for name, value in env.items():
        monkeypatch.setenv(name, value)
    got = []
    for _, asc, *_ in PAIRS:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            got.append((asc._defaults(), [str(w.message) for w in caught]))
    assert got[0] == got[1]
    if "HEAT_TPU_AUTOSCALE_COOLDOWN_S" in env:
        assert got[0][0]["cooldown_s"] == 30.0
        assert any("HEAT_TPU_AUTOSCALE_COOLDOWN_S" in m for m in got[0][1])


@pytest.mark.parametrize("kwargs", [dict(interval_s=0), dict(min_devices=0), dict(shed_tiers=("bulk",))])
def test_invalid_controller_config_rejected(kwargs):
    """tests/test_autoscale.py:327."""
    messages = []
    for _, asc, *_ in PAIRS:
        with pytest.raises(ValueError) as err:
            asc.Controller(**kwargs)
        messages.append(str(err.value))
    assert messages[0] == messages[1]


# ---------------------------------------------------------------------------
# the controller against heat_tpu's over one timeline
# ---------------------------------------------------------------------------
BURN = {"burn": ["dispatch/*"], "breach": {"dispatch": 1.0}, "tokens": None}
CLEAR = {"burn": [], "breach": {"dispatch": 0.0}, "tokens": None}
#: (now, observation): shed, hold, shrink, a burn inside the cooldown, the
#: recovery, a second cycle, then the budget's ``bound``
TIMELINE = [
    (0.0, BURN), (1.0, BURN), (2.5, BURN), (3.0, CLEAR), (3.2, BURN), (4.0, CLEAR), (4.5, CLEAR), (5.1, CLEAR),
    (5.2, CLEAR), (6.0, BURN), (6.5, BURN), (9.0, BURN), (10.0, BURN), (11.0, CLEAR), (12.5, CLEAR), (13.0, BURN),
    (16.0, BURN), (17.0, BURN), (18.0, CLEAR), (19.5, CLEAR),
]


def _snapshot(ctl):
    doc = ctl.snapshot()
    if doc["last_decision"] is not None:
        doc["last_decision"] = {k: v for k, v in doc["last_decision"].items() if k != "ts"}
    return doc


def test_tick_sequence_equals_heat_tpus(monkeypatch):
    """Both packages' controllers over the same observations: the same
    action, state and snapshot at every tick, the shrinks, recoveries and
    the ``bound`` of a spent budget included; the meshes move alike."""
    ht.get_comm()
    ref.get_comm()
    runs = {}
    for name, asc, sv, op, hr, tel in PAIRS:
        ctl = asc.Controller(interval_s=60.0, cooldown_s=1.0, shrink_after_s=2.0, max_actions=3, min_devices=1,
                             shrink_n=1)
        obs = {}
        monkeypatch.setattr(ctl, "_observe", lambda obs=obs: dict(obs["now"]))
        seq = []
        for now, o in TIMELINE:
            obs["now"] = o
            action = ctl.tick(now=now)
            mesh = communication._built_comm().size if name == "mine" else len(ref_comm.MESH_WORLD.devices)
            seq.append((now, action, ctl.state, mesh, _snapshot(ctl)))
        runs[name] = seq
        sv.shed(())
    assert runs["mine"] == runs["theirs"]
    actions = [a for _, a, *_ in runs["mine"] if a]
    if P > 1:
        assert actions == ["shed_on", "shrink", "recover", "shed_on", "shrink", "recover", "shed_on", "shed_off"]
        assert runs["mine"][-1][-1]["decisions"]["bound"] == 1
    else:
        assert actions == ["shed_on", "shed_off", "shed_on", "shed_off", "shed_on", "shed_off"]


def test_recovery_returns_to_the_baseline_mesh():
    """The kept divergence: the recovery re-forms the mesh first shrunk.
    Its baseline here is a mesh of P + 1 ranks, not the default mesh of P,
    and the recovery goes back to P + 1; a baseline that is the default
    mesh is re-formed on that mesh's devices, heat_tpu's ``reform(None)``."""
    ht.get_comm()
    baseline = communication.reform([torch.device("cpu")] * (P + 1))
    ctl = autoscale.Controller(interval_s=60.0, cooldown_s=0.05, shrink_after_s=0.0, min_devices=1, shrink_n=1)
    obs = {"now": BURN}
    ctl._observe = lambda: dict(obs["now"])
    assert ctl.tick(now=0.0) == "shed_on" and ctl.tick(now=0.1) == "shrink"
    assert _world() == P and ctl.snapshot()["mesh"] == {"devices": P, "baseline": P + 1}
    obs["now"] = CLEAR
    assert ctl.tick(now=0.2) is None and ctl.tick(now=0.3) == "recover"
    assert _world() == P + 1 and communication.get_comm().devices == baseline.devices
    serving.shed(())
    if P < 2:
        return  # a default mesh of one rank cannot shrink
    # a baseline that is the default mesh: recovered onto its devices
    default = communication.reform()
    ctl = autoscale.Controller(interval_s=60.0, cooldown_s=0.05, shrink_after_s=0.0, min_devices=1, shrink_n=1)
    ctl._observe = lambda: dict(obs["now"])
    obs["now"] = BURN
    assert ctl.tick(now=1.0) == "shed_on" and ctl.tick(now=1.1) == "shrink"
    assert _world() == P - 1 and ctl.snapshot()["mesh"]["baseline"] == P
    obs["now"] = CLEAR
    assert ctl.tick(now=1.2) is None and ctl.tick(now=1.3) == "recover"
    assert communication.get_comm().devices == default.devices == communication._world("cpu").devices
    serving.shed(())


# ---------------------------------------------------------------------------
# the health layer's reads, against heat_tpu's on the same samples
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("metric, window_s, tenant", [
    ("dispatch", None, None), ("dispatch", 5.0, None), ("dispatch", None, "a"), ("dispatch", 5.0, "b"),
    ("dispatch", 0.5, None), ("sync", None, None), ("compile", None, "a"), ("dispatch", None, "nobody"),
])
def test_breach_fraction_equals_heat_tpus(metric, window_s, tenant):
    """``breach_fraction`` (heat_tpu/core/health_runtime.py:556-584) of the
    same samples, their ages, tenants and limits, in both packages."""
    rng = np.random.default_rng(SEED)
    now = time.perf_counter()
    samples = [(now - float(age), float(v), who) for age, v, who in zip(
        rng.uniform(0.0, 10.0, 300), rng.exponential(0.002, 300), rng.choice(["a", "b", None], 300))]
    got = []
    for _, _, _, _, hr, _ in PAIRS:
        hr.set_slo(dispatch_ms=1.0, sync_ms=3.0, compile_ms=None)
        for m in hr._SLO_SAMPLES:
            hr._SLO_SAMPLES[m].clear()
            hr._SLO_SAMPLES[m].extend(samples)
        got.append(hr.breach_fraction(metric, window_s=window_s, tenant=tenant))
    want = None
    limit = {"dispatch": 1e-3, "sync": 3e-3}.get(metric)
    if limit is not None:
        window = 300.0 if window_s is None else window_s
        kept = [v for ts, v, who in samples if now - ts <= window and (tenant is None or who == tenant)]
        want = sum(v > limit for v in kept) / len(kept) if kept else None
    assert got[0] == got[1]
    if want is None:
        assert got[0] is None
    else:
        assert got[0] == pytest.approx(want, abs=2 / len(samples))  # a sample may age across the window meanwhile


def test_reset_guards_equals_heat_tpus():
    """``reset_guards`` (heat_tpu/core/health_runtime.py:772-786): the same
    count of armed guards dropped, none left, and the guards' owners leave
    without a StallError."""
    counts = []
    for _, _, _, _, hr, _ in PAIRS:
        guards = [hr.watch(f"test:guard{i}", deadline_ms=60_000) for i in range(3)]
        for g in guards:
            g.__enter__()
        counts.append((hr.reset_guards(), len(hr._WD_GUARDS), hr.reset_guards()))
        for g in guards:
            g.__exit__(None, None, None)
    assert counts[0] == counts[1] == (3, 0, 0)


# ---------------------------------------------------------------------------
# the overload loop (TestOverloadAcceptance), the port alone
# ---------------------------------------------------------------------------
def test_injected_overload_sheds_shrinks_cools_down_recovers():
    """tests/test_autoscale.py:343: shed, shrink (with ranks to spare), the
    cooldown and the recovery to the whole mesh, with 0 failed interactive
    requests across 8 mixed-tier tenants, at least 1 shed refusal, and
    exactly shed_on 1, shed_off 1, shrink 1, recover 1 (0 and 0 on one
    rank), errors 0."""
    warm = _client_input(5)
    float(ht.sum(warm * 2.0))
    world = _world()
    _arm_burn()
    ctl = autoscale.arm(interval_s=60.0, cooldown_s=0.3, shrink_after_s=0.0, max_actions=4, min_devices=1, shrink_n=1)
    prev_mode = telemetry.set_mode(2)
    interactive_errors, shed_hits, wrong = [], [], []
    try:
        _ignite()
        assert autoscale.poll() == "shed_on"
        if world > 1:
            assert autoscale.poll() == "shrink"
            assert _world() == world - 1 and ctl.snapshot()["mesh"]["baseline"] == world
        barrier = threading.Barrier(8)

        def interactive(k):
            try:
                barrier.wait(timeout=10)
                with serving.Session(f"fg-{k}", tier="interactive", deadline_ms=100.0):
                    a = _client_input(10 + k)
                    for j in range(3):
                        if not _near64(float(ht.sum(a * float(j + 2))), a, float(j + 2)):
                            wrong.append(k)
            except Exception as exc:  # noqa: BLE001 - the count is zero
                interactive_errors.append(exc)

        def batch(k):
            barrier.wait(timeout=10)
            with serving.Session(f"bg-{k}", tier="batch"):
                a = _client_input(20 + k)
                for j in range(3):
                    try:
                        float(ht.sum(a * float(j + 2)))
                    except serving.ShedError:
                        shed_hits.append(k)

        threads = [threading.Thread(target=interactive, args=(k,)) for k in range(4)]
        threads += [threading.Thread(target=batch, args=(k,)) for k in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert interactive_errors == [] and wrong == []
        assert len(shed_hits) >= 1 and serving.shed_state()["refusals"] >= 1
        time.sleep(1.1)
        opsplane.sample()
        autoscale.poll()
        assert ctl.state == ("shrunk" if world > 1 else "shedding")
        time.sleep(0.35)
        assert autoscale.poll() == ("recover" if world > 1 else "shed_off")
        assert ctl.state == "ok" and _world() == world and serving.shed_state()["tiers"] == []
        with serving.Session("bg-after", tier="batch"):
            b = _client_input(30)
            assert _near64(float(ht.sum(b * 7.0)), b, 7.0)
        d = ctl.snapshot()["decisions"]
        assert (d["shed_on"], d["shed_off"], d["shrink"], d["recover"], d["errors"]) == (
            1, 1, int(world > 1), int(world > 1), 0)
        assert ctl.mesh_actions <= 4
        kinds = [e["kind"] for e in telemetry._GLOBAL.events if str(e["kind"]).startswith("autoscale_")]
        assert "autoscale_shed_on" in kinds and ("autoscale_shed_off" if world == 1 else "autoscale_recover") in kinds
        opsplane.sample()
        assert 'heat_tpu_autoscale_decisions_total{action="shed_on"} 1' in opsplane.render()
    finally:
        telemetry.set_mode(prev_mode)


# ---------------------------------------------------------------------------
# the hooks and the arming from the environment
# ---------------------------------------------------------------------------
def test_telemetry_reset_disarms_the_controller_and_keeps_the_mesh():
    """``telemetry.reset()`` cascades into ``autoscale.reset()``
    (heat_tpu/core/telemetry.py:573-577): disarmed, its report block
    ``disarmed``, shedding lifted, the mesh where it was."""
    _arm_burn()
    ctl = _arm_inert(shrink_after_s=0.0)
    _ignite()
    assert autoscale.poll() == "shed_on"
    shrunk = autoscale.poll() == "shrink"
    size = _world()
    telemetry.reset()
    assert not autoscale.armed() and autoscale._CONTROLLER is None and ctl._thread is None
    assert telemetry.report()["autoscale"]["state"] == "disarmed"
    assert serving.shed_state()["tiers"] == [] and _world() == size == P - int(shrunk)


def test_environment_arms_the_controller_at_import():
    """``HEAT_TPU_AUTOSCALE=1`` arms the controller with the package, with
    the ``HEAT_TPU_AUTOSCALE_*`` knobs; a malformed knob warns and keeps
    its default."""
    code = ("import warnings, json; warnings.simplefilter('always'); import heat_tpu_torch as ht; "
            "st = ht.autoscale.status(); print(json.dumps([ht.autoscale.armed(), st['state'], st['config']]))")
    env = dict(os.environ, HEAT_TPU_AUTOSCALE="1", HEAT_TPU_AUTOSCALE_COOLDOWN_S="5",
               HEAT_TPU_AUTOSCALE_MAX_ACTIONS="many", PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True, text=True, timeout=120, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    armed, state, config = __import__("json").loads(out.stdout.strip().splitlines()[-1])
    assert armed and state == "ok"
    assert (config["cooldown_s"], config["max_actions"], config["interval_s"]) == (5.0, 4, 1.0)
    assert "HEAT_TPU_AUTOSCALE_MAX_ACTIONS" in out.stderr
