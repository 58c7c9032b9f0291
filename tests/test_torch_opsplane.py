"""heat_tpu_torch.core.opsplane (the live ops plane) against heat_tpu's
(tests/test_opsplane.py), case by case. CPU only.

``render`` and ``validate_exposition`` are pure functions of their input:
both packages get the same sample lists and expositions and are held equal,
and the port's ``SCHEMA`` equals the reference's and
``doc/metrics_schema.json`` name for name. The registry, the burn alerts,
the server and the command line run on the port's own gauges: their cases
copy the counts and states the reference case asserts, citing it, because
the reference's live serving cases stop here on
``jax.core.trace_state_clean`` (its batching). The elastic, autoscale and
multi-process families read ``telemetry``'s hook slots, which
``core/elastic.py``, ``core/autoscale.py`` and ``core/multihost.py`` fill
at import; a hook installed by hand is read.
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
import urllib.error
import urllib.request

import numpy as np
import pytest

import heat_tpu_torch as ht
from heat_tpu.core import opsplane as ref_op
from heat_tpu.core import telemetry as ref_tel
from heat_tpu_torch.core import communication, fusion, health_runtime, opsplane, resilience, serving, telemetry
from test_torch_parity import on_cpu  # noqa: F401

cli = importlib.import_module("heat_tpu_torch.telemetry")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEED = 20261018
_BURN_KEYS = ("target", "fast_s", "slow_s", "threshold", "min_samples")


def _get(port, route, timeout=10.0):
    """One GET against the local ops server: (status, body)."""
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{route}", timeout=timeout) as resp:
            return resp.status, resp.read().decode()
    except urllib.error.HTTPError as exc:
        return exc.code, exc.read().decode()


def _counted(route, n=1, timeout=5.0):
    """Wait for the server to count ``n`` scrapes of ``route``: it counts
    after the response is sent, so a client can read first."""
    t0 = time.perf_counter()
    while opsplane.status()["scrapes"].get(route, 0) < n and time.perf_counter() - t0 < timeout:
        time.sleep(0.005)
    return opsplane.status()["scrapes"].get(route, 0)


@pytest.fixture(autouse=True)
def ops_case(on_cpu):  # noqa: F811 - the harness's fixture, first
    """Clean ops, serving and telemetry state, no SLO, ambient faults
    suspended (the reference's OpsCase); restored after."""
    suspend = resilience.suspended()
    suspend.__enter__()
    fusion.clear_cache()
    telemetry.reset()
    opsplane.reset()
    prev_slo = health_runtime.set_slo(sync_ms=None, dispatch_ms=None, compile_ms=None)
    prev_burn = opsplane.set_burn()
    serving.set_admission(None)
    yield
    opsplane.shutdown()
    opsplane.set_burn(**{k: prev_burn[k] for k in _BURN_KEYS})
    health_runtime.set_slo(**{f"{m}_ms": None if v is None else v * 1e3 for m, v in prev_slo.items()})
    serving.set_admission(None)
    telemetry.reset()
    serving.reset()
    suspend.__exit__(None, None, None)


def _small(scale):
    """A read of a small recorded chain."""
    return float(ht.sum(ht.array(np.ones(8, dtype=np.float32), split=0) * scale))


# ---------------------------------------------------------------------------
# the registry and the committed schema (TestSchema)
# ---------------------------------------------------------------------------
def test_committed_schema_matches_registry():
    """tests/test_opsplane.py:95: doc/metrics_schema.json is the exporter's
    contract, and the port's is the reference's, name for name and in
    order."""
    with open(os.path.join(ROOT, "doc", "metrics_schema.json")) as fh:
        committed = json.load(fh)
    assert committed == opsplane.schema() == ref_op.schema()
    assert list(opsplane.SCHEMA.items()) == list(ref_op.SCHEMA.items())
    assert all(name.startswith("heat_tpu_") for name in opsplane.SCHEMA)


def test_collect_emits_only_schemad_names_and_labels():
    """tests/test_opsplane.py:109."""
    with serving.Session("schema-tenant"):
        assert _small(2.0) == 16.0
    samples = opsplane.collect()
    assert len(samples) > 20
    for name, labels, value in samples:
        assert name in opsplane.SCHEMA, f"unschema'd metric {name}"
        assert set(labels) == set(opsplane.SCHEMA[name][2]), name
        assert isinstance(value, float)
    tenants = {labels["tenant"] for name, labels, _ in samples if name == "heat_tpu_session_dispatches_total"}
    assert tenants == {"schema-tenant"}


def test_series_accumulate_and_reset_clears():
    """tests/test_opsplane.py:123."""
    prev = opsplane.set_burn()
    opsplane.sample()
    opsplane.sample()
    pts = opsplane.series("heat_tpu_up", {})
    assert len(pts) >= 2 and all(v == 1.0 for _, v in pts)
    assert opsplane.series("heat_tpu_ops_samples_total", {})[-1][1] >= 1.0
    opsplane.reset()
    assert opsplane.series("heat_tpu_up", {}) == []
    assert opsplane.set_burn()["target"] == prev["target"], "configuration survives a reset"


def test_series_ambiguity_and_cap(monkeypatch):
    """``series`` with several label sets raises without ``labels``; past
    the registry's cap new series are dropped and counted."""
    monkeypatch.setattr(opsplane, "_SERIES_CAP", 3)
    opsplane.sample()
    assert opsplane.status()["series"] == 3
    assert opsplane.status()["stats"]["series_dropped"] > 0
    opsplane.reset()
    monkeypatch.undo()
    with serving.Session("a"), serving.Session("b"):
        _small(3.0)
    opsplane.sample()
    with pytest.raises(ValueError):
        opsplane.series("heat_tpu_session_dispatches_total")
    assert opsplane.series("heat_tpu_session_dispatches_total", {"tenant": "zzz"}) == []


# ---------------------------------------------------------------------------
# the text exposition (TestExposition)
# ---------------------------------------------------------------------------
def test_render_is_parser_valid():
    """tests/test_opsplane.py:140; the reference's validator agrees."""
    with serving.Session("expo"):
        _small(1.0)
    opsplane.sample()
    text = opsplane.render()
    assert opsplane.validate_exposition(text) == [] == ref_op.validate_exposition(text)
    assert "# HELP heat_tpu_up" in text
    assert "# TYPE heat_tpu_session_dispatches_total counter" in text
    assert 'tenant="expo"' in text


def test_latency_histogram_is_native():
    """tests/test_opsplane.py:150."""
    with telemetry.enabled():
        _small(3.0)
    text = opsplane.render()
    assert "# TYPE heat_tpu_latency_seconds histogram" in text
    assert 'heat_tpu_latency_seconds_bucket{le="+Inf",metric="dispatch"}' in text
    assert 'heat_tpu_latency_seconds_count{metric="dispatch"}' in text
    assert opsplane.validate_exposition(text) == []
    key = fusion.cache_stats()["program_keys"][0]
    assert f'heat_tpu_latency_count_total{{key="{key}",metric="dispatch"}} 1' in text


def test_label_values_escape():
    """tests/test_opsplane.py:160."""
    samples = [("heat_tpu_session_dispatches_total", {"tenant": 'a"b\\c\nd'}, 1.0)]
    text = opsplane.render(samples)
    assert opsplane.validate_exposition(text) == []
    assert 'tenant="a\\"b\\\\c\\nd"' in text
    assert text == ref_op.render(samples)


def test_duplicate_samples_dropped():
    """tests/test_opsplane.py:167."""
    samples = [("heat_tpu_session_dispatches_total", {"tenant": "x"}, 1.0),
               ("heat_tpu_session_dispatches_total", {"tenant": "x"}, 2.0)]
    text = opsplane.render(samples)
    assert text.count('tenant="x"') == 1 and " 1\n" in text
    assert text == ref_op.render(samples)


def test_validator_catches_malformations():
    """tests/test_opsplane.py:177; the same problems as the reference's."""
    bad = (
        "# TYPE heat_tpu_x counter\n"
        "heat_tpu_x 1\n"
        "heat_tpu_x 2\n"
        "heat_tpu_orphan 3\n"
        "# HELP heat_tpu_h hist\n"
        "# TYPE heat_tpu_h histogram\n"
        "heat_tpu_h 4\n"
        "heat_tpu_x{bad labels} nope\n"
    )
    problems = opsplane.validate_exposition(bad)
    joined = "\n".join(problems)
    for needle in ("no preceding HELP", "duplicate sample", "no TYPE declaration", "_bucket/_sum/_count",
                   "malformed labels"):
        assert needle in joined
    assert problems == ref_op.validate_exposition(bad)


def _random_samples(rng, n=60):
    """Samples of seeded names, label values (quotes, backslashes, newlines)
    and values (integers, fractions, infinities, an unschema'd name)."""
    names = list(opsplane.SCHEMA) + ["heat_tpu_not_in_schema"]
    out = []
    for _ in range(n):
        name = names[int(rng.integers(0, len(names)))]
        labels = {}
        for label in (opsplane.SCHEMA[name][2] if name in opsplane.SCHEMA else ["x"]):
            labels[label] = "".join(rng.choice(list('ab"\\\n 1.'), size=int(rng.integers(0, 5))))
        roll = int(rng.integers(0, 4))
        value = (float(rng.integers(0, 1000)), float(rng.normal()), float("inf"), 1e16)[roll]
        out.append((name, labels, value))
    return out


@pytest.mark.parametrize("seed", range(6))
def test_render_and_validation_equal_the_references(seed):
    """The same seeded sample lists render to the same text in both
    packages (no latency observed in either), and every rendering, cut at a
    seeded line, validates to the same problems."""
    ref_tel.reset()
    samples = _random_samples(np.random.default_rng(SEED + seed))
    text = opsplane.render(samples)
    assert text == ref_op.render(samples)
    assert opsplane.validate_exposition(text) == [] == ref_op.validate_exposition(text)
    lines = text.splitlines()
    cut = "\n".join(lines[: int(np.random.default_rng(seed).integers(1, len(lines)))][::-1])
    assert opsplane.validate_exposition(cut) == ref_op.validate_exposition(cut)


# ---------------------------------------------------------------------------
# burn-rate alerting (TestBurn)
# ---------------------------------------------------------------------------
def test_injected_fault_flips_fast_window_alert_and_healthz():
    """tests/test_opsplane.py:201: the alert fires within the fast window
    (event, finding, gauge), /healthz degrades, and the alert clears once
    the window drains."""
    health_runtime.set_slo(dispatch_ms=1.0)
    opsplane.set_burn(target=0.9, fast_s=1.0, slow_s=4.0, threshold=1.0, min_samples=4)
    with telemetry.enabled(2):
        for _ in range(16):
            health_runtime._slo_observe("dispatch", 0.05)
        opsplane.sample()
        events = [e for e in telemetry._GLOBAL.events if e["kind"] == "slo_burn"]
    assert len(events) == 1 and events[0]["metric"] == "dispatch" and events[0]["tenant"] == "*"
    findings = opsplane.burn_findings()
    assert len(findings) == 1 and findings[0]["fast_burn"] >= 1.0
    doc = opsplane.health_status()
    assert doc["status"] == "degraded" and not doc["checks"]["slo_burn"]
    assert 'heat_tpu_slo_burn_alert{metric="dispatch",tenant="*"} 1' in opsplane.render()
    time.sleep(1.1)
    with telemetry.enabled(2):
        opsplane.sample()
        clears = [e for e in telemetry._GLOBAL.events if e["kind"] == "slo_burn_clear"]
    assert len(clears) == 1
    assert opsplane.health_status()["status"] == "ok"
    assert 'heat_tpu_slo_burn_alert{metric="dispatch",tenant="*"} 0' in opsplane.render()


def test_per_tenant_rows_from_tagged_samples(monkeypatch):
    """tests/test_opsplane.py:245."""
    health_runtime.set_slo(dispatch_ms=1.0)
    opsplane.set_burn(target=0.9, fast_s=2.0, slow_s=4.0, threshold=1.0, min_samples=4)
    monkeypatch.setattr(health_runtime, "_TENANT_HOOK", lambda: "tenant-a")
    for _ in range(8):
        health_runtime._slo_observe("dispatch", 0.05)
    monkeypatch.setattr(health_runtime, "_TENANT_HOOK", lambda: "tenant-b")
    for _ in range(8):
        health_runtime._slo_observe("dispatch", 0.0001)
    monkeypatch.undo()
    opsplane.sample()
    alerts = opsplane.burn_report()["alerts"]
    assert alerts["dispatch/tenant-a"]["active"] and alerts["dispatch/*"]["active"]
    assert not alerts["dispatch/tenant-b"]["active"]


def test_session_latency_samples_carry_tenant():
    """tests/test_opsplane.py:266."""
    assert health_runtime._TENANT_HOOK is serving._current_session_name
    with telemetry.enabled(), serving.Session("tagged"):
        assert _small(5.0) == 40.0
    tenants = {s[2] for s in health_runtime._SLO_SAMPLES["dispatch"] if len(s) > 2}
    assert "tagged" in tenants


def test_no_slo_configured_no_alerts():
    """tests/test_opsplane.py:280."""
    for _ in range(32):
        health_runtime._slo_observe("dispatch", 10.0)
    opsplane.sample()
    assert opsplane.burn_report()["alerts"] == {}
    assert opsplane.health_status()["status"] == "ok"


# ---------------------------------------------------------------------------
# burn subscriptions (TestOnBurn)
# ---------------------------------------------------------------------------
def _ignite():
    health_runtime.set_slo(dispatch_ms=1.0)
    opsplane.set_burn(target=0.9, fast_s=1.0, slow_s=4.0, threshold=1.0, min_samples=4)
    for _ in range(16):
        health_runtime._slo_observe("dispatch", 0.05)


def test_rising_and_falling_edges_dispatch_and_are_logged():
    """tests/test_opsplane.py:301."""
    calls = []

    def watcher(metric, tenant, rising, snapshot):
        opsplane.burn_report()  # deadlocks if callbacks ran under the lock
        calls.append((metric, tenant, rising, snapshot["active"]))

    unsub = opsplane.on_burn(watcher)
    try:
        with telemetry.enabled(2):
            _ignite()
            opsplane.sample()
            assert calls == [("dispatch", "*", True, True)]
            time.sleep(1.1)
            opsplane.sample()
            assert calls[-1] == ("dispatch", "*", False, False)
            logged = [e for e in telemetry._GLOBAL.events if e["kind"] == "burn_callback"]
        assert len(logged) == 2 and logged[0]["callback"] == "watcher"
        assert logged[0]["rising"] and not logged[1]["rising"]
    finally:
        unsub()
    n = len(calls)
    _ignite()
    opsplane.sample()
    assert len(calls) == n


def test_raising_subscriber_contained_and_counted():
    """tests/test_opsplane.py:335."""
    seen = []

    def broken(*args):
        raise RuntimeError("subscriber bug")

    unsub_a = opsplane.on_burn(broken)
    unsub_b = opsplane.on_burn(lambda m, t, rising, s: seen.append(rising))
    try:
        _ignite()
        opsplane.sample()
        assert seen == [True]
        assert opsplane.status()["stats"]["callback_errors"] >= 1
    finally:
        unsub_a()
        unsub_b()


def test_on_burn_rejects_non_callable():
    """tests/test_opsplane.py:357."""
    with pytest.raises(TypeError):
        opsplane.on_burn("not a callback")


def test_unsubscribe_is_idempotent():
    """tests/test_opsplane.py:361."""
    unsub = opsplane.on_burn(lambda *a: None)
    unsub()
    unsub()


def test_set_burn_rejects_a_target_outside_the_unit_interval():
    """The objective is a fraction below 1: ``set_burn`` refuses others and
    clamps the windows and the threshold, as the reference."""
    for bad in (1.0, -0.1):
        with pytest.raises(ValueError):
            opsplane.set_burn(target=bad)
    opsplane.set_burn(fast_s=0.0, threshold=-3.0, min_samples=0)
    ref_prev = ref_op.set_burn(fast_s=0.0, threshold=-3.0, min_samples=0)
    try:
        assert opsplane.set_burn() == ref_op.set_burn()
    finally:
        ref_op.set_burn(**{k: ref_prev[k] for k in _BURN_KEYS})


# ---------------------------------------------------------------------------
# the ops server (TestServer)
# ---------------------------------------------------------------------------
def test_endpoints_roundtrip():
    """tests/test_opsplane.py:371."""
    port = opsplane.serve(port=0)
    code, text = _get(port, "/metrics")
    assert code == 200 and opsplane.validate_exposition(text) == []
    code, body = _get(port, "/healthz")
    assert code == 200 and json.loads(body)["status"] == "ok"
    code, body = _get(port, "/readyz")
    doc = json.loads(body)
    if communication._built_comm() is not None:
        assert (code, doc["status"]) == (200, "ok")
    else:
        assert (code, doc["status"]) == (503, "unready") and not doc["checks"]["mesh"]
    code, body = _get(port, "/debug/report")
    assert code == 200 and {"health", "numerics", "memory", "burn"} <= set(json.loads(body))
    code, body = _get(port, "/debug/numerics")
    assert code == 200 and "mode" in json.loads(body)
    assert _get(port, "/debug/burn")[0] == 200
    assert _get(port, "/nope")[0] == 404
    assert _counted("/metrics") == 1 and _counted("/nope", 0) == 0


def test_readyz_follows_the_mesh_and_admission():
    """/readyz: unready before the mesh exists or while the global bucket
    projects no token, ready otherwise."""
    communication._WORLDS.pop("cpu", None)
    assert not opsplane.ready_status()["checks"]["mesh"]
    ht.get_comm()
    assert opsplane.ready_status()["status"] == "ok"
    serving.set_admission(1e-6, burst=1)
    serving._GLOBAL_BUCKET.tokens = 0.0
    doc = opsplane.ready_status()
    assert doc["status"] == "unready" and not doc["checks"]["admission"]


def test_debug_trace_and_flight(tmp_path):
    """tests/test_opsplane.py:399; the analysis is the port's analyzer on
    the live export."""
    with telemetry.enabled(2):
        _small(7.0)
        port = opsplane.serve(port=0)
        code, body = _get(port, "/debug/trace")
        assert code == 200 and "traceEvents" in json.loads(body)
        code, body = _get(port, "/debug/trace?analyze=1")
        assert code == 200
        doc = json.loads(body)
        assert doc["schema"] == 1 and doc["source"] == "doc" and len(doc["chains"]) == 1
        prev = health_runtime.set_dump_dir(str(tmp_path))
        try:
            code, body = _get(port, "/debug/flight")
        finally:
            health_runtime.set_dump_dir(prev)
        assert code == 200
        doc = json.loads(body)
        assert os.path.exists(doc["path"]) and os.path.exists(doc["trace_path"])


def test_scrape_never_forces_a_pending_chain():
    """tests/test_opsplane.py:419; every route, and no dispatch event."""
    a = ht.array(np.ones(16, dtype=np.float32), split=0)
    with telemetry.enabled(2):
        pending = a * 3.0 + 1.0
        port = opsplane.serve(port=0)
        for route in ("/metrics", "/healthz", "/readyz", "/debug/report", "/debug/trace?analyze=1",
                      "/debug/numerics", "/debug/burn"):
            assert _get(port, route)[0] in (200, 409), route
        assert fusion.is_deferred(pending), "an ops scrape forced a pending chain"
        assert not [e for e in telemetry.events() if e["kind"] == "dispatch"]
    assert float(ht.sum(pending)) == pytest.approx(16 * 4.0)


def test_scrapes_answer_while_a_force_holds_the_lock():
    """A scrape never takes ``fusion._FORCE_LOCK``: with another thread
    holding it, every route still answers."""
    port = opsplane.serve(port=0)
    held, release = threading.Event(), threading.Event()

    def holder():
        with fusion._FORCE_LOCK:
            held.set()
            release.wait(30)

    t = threading.Thread(target=holder)
    t.start()
    try:
        held.wait(10)
        for route in ("/metrics", "/healthz", "/readyz", "/debug/report", "/debug/numerics"):
            assert _get(port, route, timeout=5.0)[0] in (200, 503), route
    finally:
        release.set()
        t.join()


def test_rearm_replaces_server_and_shutdown_disarms():
    """tests/test_opsplane.py:432."""
    port1 = opsplane.serve(port=0)
    port2 = opsplane.serve(port=0)
    assert _get(port2, "/healthz")[0] == 200
    assert opsplane.status()["armed"] and opsplane.status()["port"] == port2
    opsplane.shutdown()
    assert not opsplane.status()["armed"]
    with pytest.raises(OSError):
        urllib.request.urlopen(f"http://127.0.0.1:{port2}/healthz", timeout=2)
    assert port1 is not None
    with pytest.raises(ValueError):
        opsplane.serve()  # no port and no HEAT_TPU_OPS_PORT


def test_telemetry_reset_clears_series_and_alerts_but_keeps_server():
    """``telemetry.reset()`` cascades into ``opsplane.reset()`` (reference
    telemetry.py:566-570): series, alerts, findings and scrape counts clear;
    the burn settings and an armed server stay."""
    port = opsplane.serve(port=0)
    _ignite()
    opsplane.sample()
    _get(port, "/metrics")
    assert opsplane.burn_findings() and opsplane.status()["series"] and _counted("/metrics") == 1
    telemetry.reset()
    st = opsplane.status()
    assert opsplane.burn_findings() == [] and opsplane.burn_report()["alerts"] == {}
    assert st["series"] == 0 and st["scrapes"] == {} and st["stats"]["samples"] == 0
    assert st["armed"] and st["port"] == port and st["burn"]["config"]["fast_s"] == 1.0
    assert _get(port, "/healthz")[0] == 200


# ---------------------------------------------------------------------------
# concurrent scrapes during eight threaded sessions (TestConcurrentScrapes)
# ---------------------------------------------------------------------------
ROUNDS = 25


def _chain(arr, k):
    return ht.sum(arr * k + 1.0)


def _input(seed):
    n = (512 // ht.get_comm().size) * ht.get_comm().size
    return ht.array(np.random.default_rng(seed).normal(size=(n,)).astype(np.float32), split=0)


def test_metrics_under_load_and_per_tenant_billing_parity():
    """tests/test_opsplane.py:462: eight sessions on eight threads while a
    scraper reads /metrics, /healthz and /debug/report; every scrape valid,
    counters never fall between scrapes, and the per-tenant dispatch
    counters equal each session's billing exactly."""
    for k in range(1, 9):  # every batch size, so steady state never builds
        outs = [_chain(_input(30 + j), 1.0 + j * 0.25) for j in range(k)]
        for o in outs:
            float(o)
    port = opsplane.serve(port=0)
    barrier = threading.Barrier(9)
    stop = threading.Event()
    errors, sessions, values = [], {}, {}
    stats = {"n": 0, "bad": 0, "fell": 0}
    last = {}

    def client(idx):
        try:
            name = f"ops-client{idx}"
            with serving.Session(name) as sess:
                sessions[name] = sess
                arr = _input(40 + idx)
                barrier.wait(timeout=30)
                values[name] = [float(_chain(arr, 1.0 + i * 0.25)) for i in range(ROUNDS)]
        except Exception as exc:  # noqa: BLE001 - raised below
            errors.append(exc)

    def scraper():
        try:
            barrier.wait(timeout=30)
            while not stop.is_set():
                for route in ("/metrics", "/healthz", "/debug/report"):
                    code, text = _get(port, route)
                    stats["n"] += 1
                    if code not in (200, 503):
                        stats["bad"] += 1
                    if route == "/metrics":
                        if opsplane.validate_exposition(text):
                            stats["bad"] += 1
                        for line in text.splitlines():
                            if line.startswith("heat_tpu_session_dispatches_total"):
                                key, value = line.rsplit(" ", 1)
                                stats["fell"] += float(value) < last.get(key, 0.0)
                                last[key] = float(value)
        except Exception as exc:  # noqa: BLE001 - raised below
            errors.append(exc)

    threads = [threading.Thread(target=client, args=(i,)) for i in range(8)]
    scr = threading.Thread(target=scraper)
    for t in threads + [scr]:
        t.start()
    for t in threads:
        t.join(timeout=120)
    stop.set()
    scr.join(timeout=60)
    assert errors == []
    assert stats["n"] > 0 and stats["bad"] == 0 and stats["fell"] == 0, stats
    for idx in range(8):
        x = _input(40 + idx).numpy().astype(np.float64)
        want = [float(np.sum(x * (1.0 + i * 0.25) + 1.0)) for i in range(ROUNDS)]
        np.testing.assert_allclose(values[f"ops-client{idx}"], want, rtol=1e-5, atol=1e-3)
    by_tenant = {labels["tenant"]: value for name, labels, value in opsplane.collect()
                 if name == "heat_tpu_session_dispatches_total"}
    for name, sess in sessions.items():
        billed = sess.report()["stats"]["dispatches"]
        assert billed > 0 and by_tenant.get(name) == float(billed), (name, by_tenant.get(name), billed)


# ---------------------------------------------------------------------------
# fresh processes: arming from the environment (TestSubprocessPins)
# ---------------------------------------------------------------------------
def _run(script, extra_env):
    env = dict(os.environ, PYTHONPATH=ROOT)
    for knob in ("HEAT_TPU_FUSION", "HEAT_TPU_FAULTS", "HEAT_TPU_NUMLENS", "HEAT_TPU_MEMORY_BUDGET",
                 "HEAT_TPU_TELEMETRY", "HEAT_TPU_OPS_PORT", "HEAT_TPU_METRICS"):
        env.pop(knob, None)
    env.update(extra_env)
    return subprocess.run([sys.executable, "-c", script], env=env, capture_output=True, text=True, timeout=240,
                          cwd=ROOT)


def test_env_port_arms_server_and_scrapes_never_initialize():
    """tests/test_opsplane.py:548: HEAT_TPU_OPS_PORT arms the plane with
    the import, and scrapes of /metrics and /healthz build no mesh and
    leave CUDA uninitialized."""
    script = (
        "import json, urllib.request, torch\n"
        "import heat_tpu_torch as ht\n"
        "from heat_tpu_torch.core import communication, opsplane\n"
        "st = opsplane.status()\n"
        "assert st['armed'] and st['sampling'], st\n"
        "port = st['port']\n"
        "for route in ('/metrics', '/healthz'):\n"
        "    with urllib.request.urlopen(f'http://127.0.0.1:{port}{route}') as r:\n"
        "        assert r.status == 200, (route, r.status)\n"
        "        r.read()\n"
        "assert not communication._WORLDS and not torch.cuda.is_initialized(), 'a scrape initialized'\n"
        "print('PINNED ' + json.dumps({'port': port}))\n"
    )
    proc = _run(script, {"HEAT_TPU_OPS_PORT": "0"})
    assert proc.returncode == 0, f"{proc.stdout}\n{proc.stderr}"
    assert "PINNED" in proc.stdout


def test_malformed_port_warns_and_disarms():
    """tests/test_opsplane.py:569; a malformed burn knob warns and keeps
    its default too."""
    script = (
        "import warnings\n"
        "with warnings.catch_warnings(record=True) as w:\n"
        "    warnings.simplefilter('always')\n"
        "    import heat_tpu_torch as ht\n"
        "    from heat_tpu_torch.core import opsplane\n"
        "assert not opsplane.status()['armed']\n"
        "msgs = [str(x.message) for x in w]\n"
        "assert any('HEAT_TPU_OPS_PORT' in m for m in msgs), msgs\n"
        "assert any('HEAT_TPU_SLO_BURN' in m for m in msgs), msgs\n"
        "assert opsplane.set_burn()['threshold'] == 2.0\n"
        "print('DISARMED')\n"
    )
    proc = _run(script, {"HEAT_TPU_OPS_PORT": "not-a-port", "HEAT_TPU_SLO_BURN": "fast"})
    assert proc.returncode == 0, f"{proc.stdout}\n{proc.stderr}"
    assert "DISARMED" in proc.stdout


# ---------------------------------------------------------------------------
# the JSON-lines metrics sink (TestMetricsSinkSchema)
# ---------------------------------------------------------------------------
#: the reference's pinned key set of a sink line's report
#: (tests/test_opsplane.py:593)
LINE_KEYS = {
    "enabled", "mode", "collectives", "collective_counts", "fused_collectives", "async_forcing",
    "forcing_points", "dispatches", "unfused_reasons", "retraces", "degraded", "nonfinite", "io_retries",
    "checkpoint", "faults", "jit_compiles", "spans", "timeline", "scopes", "memory", "health", "numerics",
    "fusion_cache", "programs", "timers", "serving", "elastic", "autoscale", "multihost",
}


def _sink_lines(path):
    with open(path) as fh:
        return [json.loads(ln) for ln in fh if ln.strip()]


def test_sink_line_carries_every_block_with_no_sessions(tmp_path):
    """tests/test_opsplane.py:602: every block is a real dict, the elastic
    block the supervisor's counters and the autoscale block the
    controller's snapshot (tests/test_opsplane.py:626-627), the multihost
    block ``core/multihost.py``'s."""
    assert serving._ACTIVE == 0
    path = str(tmp_path / "metrics.jsonl")
    sink = telemetry.set_metrics_sink(path, interval=0)
    try:
        assert sink.flush("test")
    finally:
        telemetry.set_metrics_sink(None)
    lines = _sink_lines(path)
    assert len(lines) == 1 and set(lines[0]) == {"ts", "event", "report"} and lines[0]["event"] == "test"
    rep = lines[0]["report"]
    assert set(rep) == LINE_KEYS
    assert "sessions" in rep["serving"] and "slo" in rep["health"] and "mode" in rep["numerics"]
    assert "reforms" in rep["elastic"] and "state" in rep["autoscale"]
    assert rep["multihost"]["world"] == 1 and rep["multihost"]["peers_lost"] == []


def test_sink_line_schema_identical_with_traffic(tmp_path):
    """tests/test_opsplane.py:629."""
    path = str(tmp_path / "metrics.jsonl")
    sink = telemetry.set_metrics_sink(path, interval=0)
    try:
        with serving.Session("sinky"):
            _small(1.0)
            assert sink.flush("busy")
        assert sink.flush("idle")
    finally:
        telemetry.set_metrics_sink(None)
    lines = _sink_lines(path)
    assert len(lines) == 2 and all(set(line["report"]) == LINE_KEYS for line in lines)
    assert "sinky" in [s["name"] for s in lines[0]["report"]["serving"]["sessions"]]


def test_hook_slots_feed_the_report_and_the_exposition(monkeypatch):
    """The elastic, autoscale and multi-process slots (reference
    telemetry.py:258-276 and :1588-1600) hold ``elastic.stats``,
    ``autoscale.stats`` and ``multihost.report_stats``, installed at import
    as the reference's: live blocks with the reference's keys and their
    gauges; a hook's snapshot becomes its report block and its gauges, as
    the reference's collectors read them."""
    from heat_tpu.core import autoscale as ref_as
    from heat_tpu.core import elastic as ref_el
    from heat_tpu.core import multihost as ref_mh
    from heat_tpu_torch.core import autoscale, elastic, multihost

    rep = telemetry.report()
    for name, mine, theirs in (("elastic", elastic.stats, ref_el.stats), ("autoscale", autoscale.stats, ref_as.stats),
                               ("multihost", multihost.report_stats, ref_mh.report_stats)):
        assert getattr(telemetry, f"_{name.upper()}_HOOK") is mine and getattr(ref_tel, f"_{name.upper()}_HOOK") is theirs
        assert set(rep[name]) == set(theirs())
    assert "reforms" in rep["elastic"] and rep["autoscale"]["state"] == "disarmed"
    assert rep["multihost"]["peers_lost"] == []
    families = {n for n, _, _ in opsplane.collect()}
    assert {"heat_tpu_elastic_total", "heat_tpu_elastic_downtime_ms_total", "heat_tpu_autoscale_armed",
            "heat_tpu_autoscale_shed_refusals_total"} <= families
    live = {n: v for n, _, v in opsplane.collect() if n.startswith(("heat_tpu_peer", "heat_tpu_barrier"))}
    assert live["heat_tpu_peers_expected"] == 1.0 and live["heat_tpu_peers_lost"] == 0.0
    elastic = {"preemptions": 1, "reforms": 2, "downtime_ms": 30.0}
    autoscale = {"armed": True, "shedding": False, "mesh": {"devices": 4, "baseline": 8}, "decisions": {"shed": 3},
                 "shed_refusals": 5, "state": "steady"}
    multihost = {"world": 2, "peers_lost": [1], "heartbeats": 7, "heartbeat_errors": 0, "barriers": 4,
                 "barrier_timeouts": 1, "abandoned_alive": 0}
    for name, doc in (("_ELASTIC_HOOK", elastic), ("_AUTOSCALE_HOOK", autoscale), ("_MULTIHOST_HOOK", multihost)):
        monkeypatch.setattr(telemetry, name, lambda doc=doc: dict(doc))
        monkeypatch.setattr(ref_tel, name, lambda doc=doc: dict(doc))
    rep = telemetry.report()
    assert (rep["elastic"], rep["autoscale"], rep["multihost"]) == (elastic, autoscale, multihost)
    hooked = ("elastic", "autoscale", "peers", "peer", "barrier", "barriers")
    mine = sorted((n, sorted(l.items()), v) for n, l, v in opsplane.collect()
                  if n.split("_")[2] in hooked)
    theirs = sorted((n, sorted(l.items()), v) for n, l, v in ref_op.collect()
                    if n.split("_")[2] in hooked)
    assert mine == theirs and len(mine) == 16
    assert not opsplane.ready_status()["checks"]["peers"]


# ---------------------------------------------------------------------------
# the command line's ops verb (TestCliOps)
# ---------------------------------------------------------------------------
def test_check_and_scrape_against_live_server():
    """tests/test_opsplane.py:653."""
    _small(2.0)
    port = opsplane.serve(port=0)
    out = pyio.StringIO()
    assert cli.main(["ops", "check", "--port", str(port)], out=out) == 0, out.getvalue()
    assert "OK: /metrics parses" in out.getvalue() and "OK: /healthz answers 200" in out.getvalue()
    out = pyio.StringIO()
    assert cli.main(["ops", "scrape", "--port", str(port), "--path", "/healthz"], out=out) == 0
    assert json.loads(out.getvalue())["status"] == "ok"
    out = pyio.StringIO()
    assert cli.main(["ops", "scrape", "--url", f"http://127.0.0.1:{port}/", "--path", "/nope"], out=out) == 1


def test_check_exits_one_while_healthz_degrades():
    """``ops check`` during a burn alert: /metrics still validates, and the
    503 of /healthz fails the check."""
    port = opsplane.serve(port=0)
    _ignite()
    opsplane.sample()
    out = pyio.StringIO()
    assert cli.main(["ops", "check", "--port", str(port)], out=out) == 1
    assert "OK: /metrics parses" in out.getvalue() and "FAIL: /healthz answered 503" in out.getvalue()


def test_check_unreachable_endpoint_fails():
    """tests/test_opsplane.py:670."""
    out = pyio.StringIO()
    assert cli.main(["ops", "check", "--port", "1", "--timeout", "2"], out=out) == 1
    assert "ERROR" in out.getvalue()
