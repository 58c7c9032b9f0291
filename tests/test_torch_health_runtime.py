"""heat_tpu_torch.core.health_runtime (``ht.flight``) against heat_tpu's
(tests/test_health_runtime.py). CPU only.

Both packages get the same inputs, made from a seed with numpy, and are held
to each other exactly where the math is the same:

* the histograms' buckets and p50/p90/p99 for the same stream of waits;
* the flight ring's cap and drops for the same stream of events;
* the watchdog's diagnosis of a stall injected at ``sync:numpy`` (site,
  policy, deadline, program, cids), under the three policies;
* the SLO gauges' breach counts for the same waits and limit;
* the health verb of both command lines, from the same file.

Times are never compared. The port counts every host read as a blocking
sync and the reference only a pending chain's, so the port's ``sync``
histograms fill where the reference's stay empty: a kept divergence with
its own test.
"""

from __future__ import annotations

import importlib
import io as pyio
import json
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
from heat_tpu.core import health_runtime as ref_hr
from heat_tpu.core import memledger as ref_ml
from heat_tpu.core import resilience as ref_res
from heat_tpu.core import telemetry as ref_tel
from heat_tpu.core.communication import MeshCommunication as RefMesh
from heat_tpu_torch.core import health_runtime as hr
from heat_tpu_torch.core import resilience as res
from heat_tpu_torch.core import telemetry as tel
from heat_tpu_torch.core.communication import MeshCommunication
from test_torch_parity import eager_engines, on_cpu  # noqa: F401

# every test here holds the eager engines' accounting against heat_tpu's
pytestmark = pytest.mark.usefixtures("eager_engines")

cli = importlib.import_module("heat_tpu_torch.telemetry")
ref_cli = importlib.import_module("heat_tpu.telemetry")

SEED = 20261017
MESHES = [1, 3, 5]
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: (port module, its telemetry, its resilience; reference's)
PACKAGES = ((hr, tel, res), (ref_hr, ref_tel, ref_res))


@pytest.fixture(autouse=True)
def clean_health(tmp_path):
    """Both packages at mode 1 with a 256-event ring, the watchdog off,
    dumps under tmp_path; the settings restored afterwards."""
    prev_budget = ref_ml.set_budget(None)
    saved = []
    for mod, t, _ in PACKAGES:
        saved.append((t.set_mode(1), mod.set_flight(True, 256), mod.set_watchdog(enabled=False),
                      mod.set_dump_dir(str(tmp_path)), dict(mod._SLO_LIMITS)))
        t.reset()
    yield
    for (mod, t, _), (mode, flight, wd, dump_dir, slo) in zip(PACKAGES, saved):
        mod.set_watchdog(wd[0], policy=wd[1], enabled=wd[2])
        mod.set_flight(flight[0], flight[1])
        mod.set_dump_dir(dump_dir)
        mod._SLO_LIMITS.update(slo)
        t.set_mode(mode)
        t.reset()
    ref_ml.set_budget(prev_budget[0], prev_budget[1])


def _pair(p):
    p = min(p, len(jax.devices()))
    return MeshCommunication([torch.device("cpu")] * p), RefMesh(jax.devices()[:p])


def _arrays(p, seed=SEED, shape=(10, 3)):
    mine, theirs = _pair(p)
    v = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return v, ht.array(v, split=0, comm=mine), ref.array(v, split=0, comm=theirs)


# ---------------------------------------------------------------------------
# the flight ring (TestFlightRing)
# ---------------------------------------------------------------------------
def test_ring_records_at_mode1_while_verbose_timeline_stays_empty():
    x = ht.array(np.ones((10, 3), np.float32), split=0, comm=MeshCommunication([torch.device("cpu")] * 3))
    x.numpy()
    ht.sum(x, axis=0)
    kinds = [ev["kind"] for ev in hr.flight_events()]
    assert "blocking_sync" in kinds and "collective" in kinds
    assert tel.events() == [] and len(tel._GLOBAL.events) == 0
    sync = next(ev for ev in hr.flight_events() if ev["kind"] == "blocking_sync")
    assert sync["where"] == "numpy" and sync["dur"] >= 0.0  # the ring shares the closed token


@pytest.mark.parametrize("cap, n", [(16, 24), (16, 16), (64, 200), (100, 7)])
def test_ring_cap_and_drops_match_the_reference(cap, n):
    for mod, t, _ in PACKAGES:
        mod.set_flight(True, cap)
        t.reset()
        for i in range(n):
            t.record_event("io", op=f"e{i}")
    mine, theirs = hr.flight_stats(), ref_hr.flight_stats()
    assert {k: mine[k] for k in ("events", "cap", "dropped")} == {k: theirs[k] for k in ("events", "cap", "dropped")}
    assert mine["dropped"] == max(0, n - cap)
    assert [ev["op"] for ev in hr.flight_events()] == [ev["op"] for ev in ref_hr.flight_events()]


def test_disabled_recorder_is_a_noop():
    hr.set_flight(False)
    assert tel._FLIGHT_HOOK is None
    _, x, _ = _arrays(3)
    x.numpy()
    assert hr.flight_events() == []
    assert hr.auto_dump("oom") is None


def test_resizing_keeps_the_newest_events():
    for i in range(10):
        tel.record_event("io", op=f"e{i}")
    assert hr.set_flight(events=4) == (True, 256)
    assert [ev["op"] for ev in hr.flight_events()] == ["e6", "e7", "e8", "e9"]


def test_env_knobs_configure_a_fresh_interpreter():
    code = (
        "from heat_tpu_torch.core import health_runtime as hr, memledger as ml, telemetry\n"
        "assert hr._ENABLED is False and telemetry._FLIGHT_HOOK is None\n"
        "assert hr._RING_CAP == 64, hr._RING_CAP\n"
        "assert hr._DUMP_DIR == 'flight_dumps' and hr._DUMP_EVERY_S == 5.0\n"
        "assert hr._WD_ENABLED and hr._WD_DEADLINE_S == 0.25 and hr._WD_POLICY == 'raise'\n"
        "assert hr._SLO_LIMITS['sync'] == 0.0125 and hr._SLO_WINDOW_S == 30.0\n"
        "assert ml._ENABLED is False and ml._SAMPLE_EVERY_S == 0.005\n"
        "print('OK')\n"
    )
    env = dict(os.environ, HEAT_TPU_FLIGHT="0", HEAT_TPU_FLIGHT_EVENTS="64", HEAT_TPU_FLIGHT_DIR="flight_dumps",
               HEAT_TPU_FLIGHT_DUMP_EVERY_S="5", HEAT_TPU_WATCHDOG="1", HEAT_TPU_WATCHDOG_MS="250",
               HEAT_TPU_WATCHDOG_POLICY="raise", HEAT_TPU_SLO_SYNC_MS="12.5", HEAT_TPU_SLO_WINDOW_S="30",
               HEAT_TPU_MEMORY_LEDGER="0", HEAT_TPU_MEMORY_SAMPLE_MS="5")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, env=env, cwd=ROOT, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "OK" in proc.stdout


# ---------------------------------------------------------------------------
# dumps (TestFlightDump)
# ---------------------------------------------------------------------------
def test_manual_dumps_validate_in_both_packages(tmp_path):
    _, x, y = _arrays(3)
    for mod, t, _ in PACKAGES:
        t.set_mode(2)
    x.numpy(), str(x), ht.sum(x, axis=0)
    y.numpy(), str(y)
    dumps = [mod.dump_flight(str(tmp_path / name), reason="manual") for (mod, _, _), name in zip(PACKAGES, ("port", "ref"))]
    for dump in dumps:
        assert dump["problems"] == []
        assert tel.validate_trace(dump["trace_path"]) == [] and ref_tel.validate_trace(dump["trace_path"]) == []
    with open(dumps[0]["path"]) as fh:
        bundle = json.load(fh)
    with open(dumps[1]["path"]) as fh:
        ref_bundle = json.load(fh)
    # the reference's keys less the diagnosis, which comes with tracelens
    assert set(bundle) == set(ref_bundle) - {"diagnosis"}
    assert set(bundle["numerics"]) == set(ref_bundle["numerics"]) == {"findings", "drift", "canary"}
    assert bundle["reason"] == "manual" and bundle["trace_problems"] == [] and bundle["events"] > 0
    assert set(bundle["memory"]) == set(ref_bundle["memory"]) == {"watermark", "budget", "last_oom"}
    assert set(bundle["programs"]) == set(ref_bundle["programs"])
    assert set(bundle["health"]) == set(ref_bundle["health"])
    assert hr.flight_stats()["dumps"] == 1 and hr.last_dump()["path"] == dumps[0]["path"]


def test_dump_to_a_given_path(tmp_path):
    tel.record_event("io", op="x")
    dump = hr.dump_flight(str(tmp_path / "mine.json"))
    assert dump["path"] == str(tmp_path / "mine.json") and dump["trace_path"] == str(tmp_path / "mine.trace.json")
    assert os.path.exists(dump["path"]) and os.path.exists(dump["trace_path"])


def test_auto_dump_throttles_per_reason():
    for mod, t, _ in PACKAGES:
        t.record_event("io", op="x")
        assert mod.auto_dump("degrade") is not None
        assert mod.auto_dump("degrade") is None, "throttled"
        assert mod.auto_dump("oom") is not None, "per-reason throttle"
        t.set_mode(0)
        assert mod.auto_dump("telemetry_off") is None


# ---------------------------------------------------------------------------
# the watchdog (TestWatchdog)
# ---------------------------------------------------------------------------
def _await_stall(mod, timeout=5.0):
    end = time.monotonic() + timeout
    while time.monotonic() < end:
        stall = mod.last_stall()
        if stall is not None:
            return stall
        time.sleep(0.01)
    return None


DIAGNOSIS_KEYS = ("site", "policy", "deadline_s", "program", "cid", "cids")


@pytest.mark.parametrize("p", MESHES)
def test_injected_stall_at_numpy_trips_in_both_packages(p):
    v, x, y = _arrays(p, SEED + p)
    diagnoses = []
    for (mod, _, resil), arr in zip(PACKAGES, (x, y)):
        mod.set_watchdog(deadline_ms=80, policy="warn", enabled=True)
        with resil.inject("watchdog.stall:sync:numpy", times=1):
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                got = arr.numpy()
                stall = _await_stall(mod)
        assert stall is not None, f"{mod.__name__} missed the injected stall"
        assert np.array_equal(got, v)
        assert any(w.category is resil.StallWarning and "sync:numpy" in str(w.message) for w in caught)
        assert stall["waited_s"] >= 0.08 and mod.watchdog_stats()["trips"] == 1
        assert isinstance(stall["stack"], list) and stall["stack"]
        diagnoses.append({k: stall[k] for k in DIAGNOSIS_KEYS})
    assert diagnoses[0] == diagnoses[1]
    assert diagnoses[0]["site"] == "sync:numpy" and diagnoses[0]["policy"] == "warn"


def test_raise_policy_raises_stall_error_and_the_next_read_returns_the_values():
    v, x, y = _arrays(3, SEED + 1)
    for (mod, _, resil), arr in zip(PACKAGES, (x, y)):
        mod.set_watchdog(deadline_ms=80, policy="raise", enabled=True)
        with resil.inject("watchdog.stall:sync:numpy", times=1):
            with warnings.catch_warnings(record=True):
                warnings.simplefilter("always")
                with pytest.raises(resil.StallError, match="sync:numpy"):
                    arr.numpy()
        assert np.array_equal(arr.numpy(), v)
        assert mod.last_stall()["policy"] == "raise"


def test_dump_policy_writes_a_stall_bundle():
    _, x, _ = _arrays(3, SEED + 2)
    hr.set_watchdog(deadline_ms=80, policy="dump", enabled=True)
    with res.inject("watchdog.stall:sync:numpy", times=1):
        with warnings.catch_warnings(record=True):
            warnings.simplefilter("always")
            x.numpy()
            assert _await_stall(hr) is not None
    end = time.monotonic() + 5.0
    while time.monotonic() < end and hr.last_dump() is None:
        time.sleep(0.01)
    dump = hr.last_dump()
    assert dump is not None and dump["problems"] == []
    with open(dump["path"]) as fh:
        bundle = json.load(fh)
    assert bundle["reason"] == "stall"
    assert bundle["stalls"][-1]["site"] == "sync:numpy"
    assert "stall" in {ev["kind"] for ev in hr.flight_events()}


def test_item_and_print_are_guarded():
    _, x, _ = _arrays(3)
    hr.set_watchdog(deadline_ms=80, policy="warn", enabled=True)
    for site, read in (("sync:item", lambda: ht.sum(x).item()), ("sync:print", lambda: str(x))):
        hr.reset()
        with res.inject("watchdog.stall:" + site, times=1):
            with warnings.catch_warnings(record=True):
                warnings.simplefilter("always")
                read()
                stall = _await_stall(hr)
        assert stall is not None and stall["site"] == site


def test_no_false_trip_on_a_healthy_read():
    _, x, y = _arrays(3)
    for (mod, _, _), arr in zip(PACKAGES, (x, y)):
        mod.set_watchdog(deadline_ms=30000, policy="warn", enabled=True)
        for _ in range(3):
            arr.numpy()
        assert mod.last_stall() is None
        stats = mod.watchdog_stats()
        assert stats["trips"] == 0 and stats["arms"] >= 3 and stats["armed"] == 0


def test_disarmed_watchdog_arms_nothing():
    _, x, _ = _arrays(3)
    x.numpy()
    assert hr.watch("sync:numpy") is hr._NULL_GUARD
    assert hr.watchdog_stats()["arms"] == 0
    with hr.watch("explicit", deadline_ms=1000):  # an explicit deadline arms anyway
        pass
    assert hr.watchdog_stats()["arms"] == 1


def test_set_watchdog_rejects_unknown_policy():
    for mod, _, _ in PACKAGES:
        with pytest.raises(ValueError):
            mod.set_watchdog(policy="panic")
    prev = hr.set_watchdog(deadline_ms=500, policy="dump")
    assert hr.set_watchdog(*prev) == (500.0, "dump", prev[2])
    hr.set_watchdog(deadline_ms=500, policy="dump")
    assert hr.watchdog_stats()["deadline_ms"] == 500.0 and hr.watchdog_stats()["policy"] == "dump"


def test_the_watchdog_thread_is_a_daemon():
    hr.set_watchdog(deadline_ms=1000, enabled=True)
    with hr.watch("probe"):
        pass
    assert hr._WD_THREAD is not None and hr._WD_THREAD.daemon and hr._WD_THREAD.is_alive()


# ---------------------------------------------------------------------------
# the histograms (TestHistograms)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("seed, sigma, n", [(42, 1.5, 4000), (7, 0.3, 500), (3, 3.0, 100), (11, 1.0, 1)])
def test_histogram_buckets_and_percentiles_match_the_reference(seed, sigma, n):
    samples = np.random.default_rng(seed).lognormal(mean=-7.0, sigma=sigma, size=n)
    samples[: n // 10] = 0.0  # waits under the floor
    mine, theirs = hr._Hist(), ref_hr._Hist()
    for v in samples:
        mine.observe(float(v))
        theirs.observe(float(v))
    assert mine.buckets == theirs.buckets
    for q in (1, 50, 90, 99, 100):
        assert mine.percentile(q) == theirs.percentile(q)
    assert mine.snapshot() == theirs.snapshot()
    assert mine.snapshot()["count"] == n


def test_observed_waits_render_the_same_tables():
    waits = np.random.default_rng(SEED).lognormal(mean=-6.0, sigma=1.0, size=300)
    for mod, _, _ in PACKAGES:
        for i, w in enumerate(waits):
            mod._on_sync_end(("numpy", "item", "print")[i % 3], None, float(w))
    mine, theirs = hr.health_block(), ref_hr.health_block()
    assert mine["sync"] == theirs["sync"]
    assert mine["dispatch"] == theirs["dispatch"] == {"*": {"count": 0}}
    assert mine["compile"] == theirs["compile"] == {"*": {"count": 0}}
    assert set(mine) == set(theirs)


def test_host_reads_fill_the_sync_histograms():
    """Kept divergence: every host read of the port is a blocking sync; the
    reference counts only a pending chain's (its recorder is off here)."""
    _, x, y = _arrays(3)
    for arr in (x, y):
        arr.numpy()
        ht.sum(x).item() if arr is x else ref.sum(y).item()
        str(arr)
    sync = hr.health_block()["sync"]
    assert {k: r["count"] for k, r in sync.items()} == {"*": 3, "numpy": 1, "item": 1, "print": 1}
    assert ref_hr.health_block()["sync"] == {"*": {"count": 0}}
    rec = sync["numpy"]
    assert rec["p50_s"] <= rec["p90_s"] <= rec["p99_s"] <= rec["max_s"]


def test_scope_isolates_and_rolls_up():
    _, x, _ = _arrays(3)
    x.numpy()  # outside the scope
    with tel.scope("inner"):
        assert hr.health_block()["sync"]["*"]["count"] == 0, "a scope's view starts empty"
        x.numpy()
        x.numpy()
        inner = hr.health_block()["sync"]["*"]["count"]
    assert inner == 2
    assert hr.health_block(global_view=True)["sync"]["*"]["count"] == 3
    assert hr._H_SCOPES["inner"].overall["sync"].count == 2


def test_reset_clears_session_keeps_config():
    hr.set_flight(True, 32)
    hr.set_slo(sync_ms=5000.0)
    _, x, _ = _arrays(3)
    x.numpy()
    assert hr.flight_events()
    tel.reset()  # cascades into the health layer
    assert hr.flight_events() == []
    block = hr.health_block(global_view=True)
    assert block["sync"] == {"*": {"count": 0}}
    assert block["watchdog"]["trips"] == 0 and block["slo"]["sync"]["recent"] == 0
    assert hr.flight_stats()["cap"] == 32 and block["slo"]["sync"]["limit_ms"] == 5000.0


# ---------------------------------------------------------------------------
# the SLO gauges (TestSLO)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("limit_ms", [0.5, 2.0, 50.0])
def test_breach_counts_match_the_reference(limit_ms):
    waits = np.random.default_rng(SEED).lognormal(mean=-6.5, sigma=1.2, size=200)
    for mod, _, _ in PACKAGES:
        mod.set_slo(sync_ms=limit_ms)
        for w in waits:
            mod._on_sync_end("numpy", None, float(w))
    mine, theirs = hr.health_block()["slo"], ref_hr.health_block()["slo"]
    want = int(np.sum(waits > limit_ms / 1e3))
    assert mine["sync"]["breaches_total"] == theirs["sync"]["breaches_total"] == want
    assert mine["sync"] == theirs["sync"]
    assert mine["sync"]["window_breaches"] == want and mine["sync"]["ok_ratio"] == round(1 - want / 200, 4)
    breaches = [ev for ev in hr.flight_events() if ev["kind"] == "slo_breach"]
    assert len(breaches) == min(want, 256)


def test_healthy_reads_keep_the_slo():
    hr.set_slo(sync_ms=60000.0)
    _, x, _ = _arrays(3)
    x.numpy()
    slo = hr.health_block()["slo"]["sync"]
    assert slo["window_breaches"] == 0 and slo["ok_ratio"] == 1.0 and slo["recent"] == 1
    assert hr.set_slo(sync_ms=None)["sync"] == 60.0
    assert hr.health_block()["slo"]["sync"]["limit_ms"] is None


# ---------------------------------------------------------------------------
# the report, the command line and the contract
# ---------------------------------------------------------------------------
def test_report_health_block_has_the_references_shape():
    _, x, _ = _arrays(3)
    x.numpy()
    mine, theirs = tel.report()["health"], ref_tel.report()["health"]
    assert set(mine) == set(theirs)
    for key in ("flight", "watchdog", "slo"):
        assert set(mine[key]) == set(theirs[key]), key
    assert mine["sync"]["numpy"]["count"] == 1


def _run(module, argv):
    out = pyio.StringIO()
    assert module.main(argv, out=out) == 0
    return out.getvalue()


@pytest.mark.parametrize("source", ["report", "dump", "stall_dump"])
def test_health_verb_prints_the_references_text(source, tmp_path):
    _, x, _ = _arrays(3)
    hr.set_slo(sync_ms=0.0001)
    x.numpy(), str(x)
    if source == "report":
        path = str(tmp_path / "report.json")
        tel.report_json(path)
    elif source == "dump":
        path = hr.dump_flight(reason="manual")["path"]
    else:
        hr.set_watchdog(deadline_ms=80, policy="dump", enabled=True)
        with res.inject("watchdog.stall:sync:numpy", times=1):
            with warnings.catch_warnings(record=True):
                warnings.simplefilter("always")
                x.numpy()
                assert _await_stall(hr) is not None
        end = time.monotonic() + 5.0
        while time.monotonic() < end and hr.last_dump() is None:
            time.sleep(0.01)
        path = hr.last_dump()["path"]
    text = _run(cli, ["health", path])
    assert text == _run(ref_cli, ["health", path])
    assert "flight:" in text and "watchdog:" in text and "blocking-sync host wait" in text and "SLO sync" in text
    if source == "stall_dump":
        assert "STALL: sync:numpy" in text


def test_health_verb_live_json():
    _, x, _ = _arrays(3)
    x.numpy()
    doc = json.loads(_run(cli, ["health", "--json"]))
    assert doc["source"] == "<live>"
    assert doc["health"]["sync"]["*"]["count"] >= 1 and "watchdog" in doc["health"]
    assert "watchdog:" in _run(cli, ["health"])


def test_health_layer_never_initializes_cuda():
    code = (
        "import torch\n"
        "from heat_tpu_torch.core import health_runtime as hr, telemetry\n"
        "hr.set_watchdog(deadline_ms=1000, policy='warn', enabled=True)\n"
        "hr.set_slo(sync_ms=5.0)\n"
        "with hr.watch('probe'):\n"
        "    pass\n"
        "hr.flight_stats(); hr.health_block(global_view=True); hr.watchdog_stats(); hr.stalls()\n"
        "telemetry.report(); hr.dump_flight(reason='probe')\n"
        "assert not torch.cuda.is_initialized(), 'CUDA was initialized'\n"
        "print('OK')\n"
    )
    env = dict(os.environ, HEAT_TPU_FLIGHT="1", HEAT_TPU_TELEMETRY="1")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, env=env, cwd=ROOT, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "OK" in proc.stdout


def test_the_ring_takes_appends_from_other_threads():
    hr.set_flight(True, 64)

    def emit(k):
        for i in range(200):
            tel.record_event("io", op=f"{k}:{i}")

    threads = [threading.Thread(target=emit, args=(k,)) for k in range(4)]
    for t in threads:
        t.start()
    while any(t.is_alive() for t in threads):
        hr.flight_events()  # a read while the others append
    for t in threads:
        t.join()
    stats = hr.flight_stats()
    assert stats["events"] == 64 and stats["dropped"] == 800 - 64
