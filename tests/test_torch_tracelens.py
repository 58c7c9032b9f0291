"""heat_tpu_torch.core.tracelens (the trace analyzer) against heat_tpu's
(tests/test_tracelens.py), case by case. CPU only.

The analyzer is a pure function of its input, and heat_tpu's runs here on
an event list, a Chrome document or a file. So both analyzers get the same
input (hand-built event streams, seeded adversarial soups, the port's own
live timeline, its exported and merged files) and their ``analyze``,
``diff``, ``render`` and ``diagnose`` results are held equal key for key.
The two fix hints that name XLA in the reference name the port's program
build instead (``_PORT_HINTS``): that is the one difference allowed.

The reference's live-workload cases stop here on
``jax.core.trace_state_clean``; their port runs the port's recorder on the
CPU mesh and is held to the counts and bounds the reference case asserts,
citing it. The process's first force pays the recorder's start (~2 s of
meta kernels and FX on the CPU, outside any event): the module's warm-up
pays it before any window, as a serving process is warm.

Kept divergence on the card, read by ``chip_smoke.py``'s phase 21: an
operand under ``fusion._EAGER_BELOW_BYTES`` runs eagerly with no
``dispatch`` event, and ``KMeans``' Lloyd launches come from
``ops/lloyd.py``, not the recorder, so reads of their results are
``sync_wait``.
"""

from __future__ import annotations

import importlib
import io as pyio
import json
import os
import subprocess
import sys
import warnings

import numpy as np
import pytest

import heat_tpu_torch as ht
from heat_tpu.core import telemetry as ref_tel
from heat_tpu.core import tracelens as ref_tl
from heat_tpu_torch.core import fusion, health_runtime, resilience, telemetry, tracelens
from test_torch_parity import on_cpu  # noqa: F401

cli = importlib.import_module("heat_tpu_torch.telemetry")
ref_cli = importlib.import_module("heat_tpu.telemetry")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_BLOCKING = tracelens._BLOCKING_BUCKETS
#: the reference's fix hints that name XLA, and the port's
_PORT_HINTS = (
    ("every miss pays a fresh XLA compile", "every miss pays a fresh program build"),
    ("or fuse the op between the reshards so XLA plans one collective",
     "or record the op between the reshards into one program so that one collective moves the data"),
)


def _ported(doc):
    """The reference's output with its XLA hints in the port's words."""
    text = json.dumps(doc)  # the keys' order kept: render breaks ties by it
    for theirs, mine in _PORT_HINTS:
        text = text.replace(theirs, mine)
    return json.loads(text)


def _same(mine, theirs):
    assert json.loads(json.dumps(mine)) == _ported(theirs)


def _both(source, **kwargs):
    """One input through both analyzers, held equal; the port's result."""
    mine = tracelens.analyze(source, **kwargs)
    _same(mine, ref_tl.analyze(source, **kwargs))
    return mine


@pytest.fixture(scope="module", autouse=True)
def warm_recorder():
    """The process's first force, outside every window."""
    ht.use_device("cpu")
    float(ht.std(ht.array(np.ones((4 * ht.get_comm().size, 3), dtype=np.float32), split=0)))
    ht.use_device(None)


@pytest.fixture(autouse=True)
def verbose(on_cpu):  # noqa: F811 - the harness's fixture, first
    """Verbose telemetry and clean caches, ambient faults suspended (the
    reference's TracelensCase)."""
    suspend = resilience.suspended()
    suspend.__enter__()
    prev = telemetry.set_mode("verbose")
    fusion.clear_cache()
    telemetry.reset()
    yield
    telemetry.set_mode(prev)
    telemetry.reset()
    suspend.__exit__(None, None, None)


def _split_input(seed=0, n_mult=4):
    n = n_mult * ht.get_comm().size
    return ht.array(np.random.default_rng(seed).standard_normal((n, 3)).astype(np.float32), split=0)


def _reduction_chain(seed=0):
    """The k-means-shaped chain of the reference (mean, var, std, each
    read) through the port's recorder; its values against float64."""
    a = _split_input(seed)
    m, v, s = ht.mean(a), ht.var(a), ht.std(a)
    got = float(m) + float(v) + float(s)
    x = a.numpy().astype(np.float64)
    assert got == pytest.approx(x.mean() + x.var() + x.std(), rel=1e-5)
    assert telemetry.events(), "the recorder recorded no event"
    return got


def _bucket_sum(analysis):
    return sum(rec["s"] for rec in analysis["attribution"]["overall"].values())


# ---------------------------------------------------------------------------
# time attribution (TestAttribution)
# ---------------------------------------------------------------------------
def test_reduction_chain_attribution_covers_95_pct():
    """tests/test_tracelens.py:84: unattributed <= 5% of the window, buckets
    and remainder sum to the window; the reference's analyzer gives the same
    document on the port's timeline."""
    _reduction_chain()
    _reduction_chain(seed=1)
    ana = tracelens.analyze()
    assert ana["source"] == "live" and ana["window_s"] > 0.0
    assert ana["attribution"]["unattributed_pct"] <= 5.0, ana["attribution"]
    assert _bucket_sum(ana) + ana["attribution"]["unattributed_s"] == pytest.approx(ana["window_s"], abs=1e-5)
    for bucket, rec in ana["attribution"]["overall"].items():
        assert bucket in tracelens._BUCKET_PRIORITY and rec["s"] >= 0.0
    from_list = _both(telemetry.events())
    assert dict(from_list, source="live") == ana


def test_clean_workload_yields_no_findings():
    """tests/test_tracelens.py:101: the warm reduction chain analyzes with no
    warning or error finding."""
    _reduction_chain()
    ana = _both(telemetry.events())
    assert [f for f in ana["findings"] if f["severity"] != "info"] == [], ana["findings"]


def test_chains_confirm_one_dispatch_one_sync():
    """tests/test_tracelens.py:112: each fused chain is one dispatch and at
    most one blocking sync. The first read batches the three live roots
    into one program (the collective nodes on), so the window holds one
    chain of three roots whose read joins one sync."""
    _reduction_chain()
    ana = tracelens.analyze()
    assert [(c["dispatches"], c["syncs"], c["roots"], c["compiled"]) for c in ana["chains"]] == [(1, 1, 3, True)], \
        ana["chains"]


def test_per_program_attribution_keys_are_cache_keys():
    """tests/test_tracelens.py:124; the port's keys are its cache's."""
    _reduction_chain()
    per_prog = tracelens.analyze()["attribution"]["per_program"]
    assert set(per_prog) == set(fusion.cache_stats()["program_keys"])
    for rec in per_prog.values():
        assert rec["dispatches"] == 1 and rec["syncs"] == 1
        assert sum(rec[b] for b in _BLOCKING) >= 0.0 and rec["compile"] > 0.0


def test_exported_file_analyzes_like_live(tmp_path):
    """tests/test_tracelens.py:135; the reference's analyzer reads the
    port's exported file to the same document."""
    _reduction_chain()
    live = tracelens.analyze()
    path = str(tmp_path / "trace.json")
    telemetry.export_trace(path)
    from_file = _both(path)
    assert from_file["source"] == path and from_file["attribution"]["unattributed_pct"] <= 5.0

    def top(ana):
        overall = ana["attribution"]["overall"]
        return max(overall, key=lambda b: overall[b]["s"])

    assert top(live) == top(from_file)
    _both(telemetry.export_trace(path=None))  # the document itself


def test_analyze_requires_events():
    """tests/test_tracelens.py:152."""
    with pytest.raises(ValueError):
        tracelens.analyze()
    for analyze in (tracelens.analyze, ref_tl.analyze):
        with pytest.raises(ValueError):
            analyze([])


# ---------------------------------------------------------------------------
# the critical path (TestCriticalPath)
# ---------------------------------------------------------------------------
def test_path_is_ordered_blocking_and_bounded_by_window():
    """tests/test_tracelens.py:161."""
    _reduction_chain()
    ana = tracelens.analyze()
    crit = ana["critical_path"]
    assert 0.0 < crit["total_s"] <= ana["window_s"] + 1e-6
    assert 0.0 <= crit["sync_pct"] <= 100.0
    for step in crit["steps"]:
        assert step["bucket"] in _BLOCKING and step["dur_s"] >= 0.0
    assert not crit["truncated"]
    assert sum(s["dur_s"] for s in crit["steps"]) == pytest.approx(crit["total_s"], abs=1e-4)


def test_dp_picks_longest_chain_over_overlapping_segments():
    """tests/test_tracelens.py:177."""
    segments = [
        {"start": 0.0, "end": 10.0, "bucket": "compile", "program": None, "cid": 1},
        {"start": 9.0, "end": 10.5, "bucket": "sync_wait", "program": None, "cid": 2},
        {"start": 10.6, "end": 11.0, "bucket": "device_execute", "program": None, "cid": 3},
    ]
    crit = tracelens._critical_path(segments)
    assert crit["total_s"] == pytest.approx(10.4, abs=1e-6)
    assert [s["cid"] for s in crit["steps"]] == [1, 3]
    assert crit == ref_tl._critical_path(segments)


@pytest.mark.parametrize("n", [5, 70])
def test_serial_segments_all_land_on_the_path(n):
    """tests/test_tracelens.py:190; 70 segments pass the 64-step cap."""
    segments = [
        {"start": float(i), "end": i + 0.5, "bucket": "device_execute", "program": "p", "cid": i} for i in range(n)
    ]
    crit = tracelens._critical_path(segments)
    assert crit["total_s"] == pytest.approx(0.5 * n, abs=1e-6)
    assert len(crit["steps"]) == min(n, 64) and crit["truncated"] == max(0, n - 64)
    assert crit["sync_pct"] == 100.0
    assert crit == ref_tl._critical_path(segments)


# ---------------------------------------------------------------------------
# cross-host stragglers (TestStragglerAttribution)
# ---------------------------------------------------------------------------
_STRAGGLER_WORKER = r"""
import contextlib, sys, time
import torch
from heat_tpu_torch.core import communication, resilience, telemetry

out_path, slow = sys.argv[1], sys.argv[2] == "slow"
telemetry.set_mode("verbose")
telemetry.reset()
ctx = resilience.inject("trace.hostdelay", times=None) if slow else contextlib.nullcontext()
with ctx:
    for _ in range(12):
        telemetry.record_collective("allreduce", axis="x", nbytes=1024, dtype="float32")
        time.sleep(0.002)
telemetry.export_trace(out_path)
assert not communication._WORLDS and not torch.cuda.is_initialized(), "the worker built a mesh"
"""


def _run_hosts(td, n_hosts, slow_host):
    """One simulated host per process, each recording the same collective
    sequence; ``slow_host`` runs with ``trace.hostdelay`` armed, so each
    record sleeps HEAT_TPU_TRACE_DELAY_MS (as tests/test_tracelens.py:225)."""
    env = dict(os.environ, HEAT_TPU_TRACE_DELAY_MS="15", PYTHONPATH=ROOT)
    env.pop("HEAT_TPU_FAULTS", None)
    paths, procs = [], []
    for h in range(n_hosts):
        path = os.path.join(td, f"host{h}.json")
        paths.append(path)
        procs.append(subprocess.Popen(
            [sys.executable, "-c", _STRAGGLER_WORKER, path, "slow" if h == slow_host else "fast"],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env, cwd=ROOT,
        ))
        # on few cores co-scheduled workers' imports show up as lag on the
        # fast hosts: at most min(4, cores) at a time
        if len(procs) >= max(1, min(4, os.cpu_count() or 1)):
            p = procs.pop(0)
            p.wait()
            assert p.returncode == 0, p.stderr.read()
    for p in procs:
        p.wait()
        assert p.returncode == 0, p.stderr.read()
    return paths


def test_injected_delay_names_the_straggling_host(tmp_path):
    """tests/test_tracelens.py:255: a one-host delay fault gives one
    ``tracelens.straggler`` finding naming that host on the merged trace
    (hosts = the mesh size, 3 to 8); the healthy hosts alone name none.
    The merged file analyzes to the same document in both packages."""
    n_hosts = max(3, min(ht.get_comm().size, 8))
    slow = n_hosts // 2
    paths = _run_hosts(str(tmp_path), n_hosts, slow)
    merged = str(tmp_path / "merged.json")
    telemetry.merge_traces(paths, merged)
    ana = _both(merged)
    assert ana["hosts"] == n_hosts
    strag = ana["stragglers"]
    assert strag["straggler"] == slow, strag
    assert strag["matched_collectives"] >= 12
    worst = strag["lag_ms"][str(slow)]
    assert all(worst > lag for pid, lag in strag["lag_ms"].items() if pid != str(slow))
    findings = [f for f in ana["findings"] if f["rule"] == "tracelens.straggler"]
    assert len(findings) == 1 and findings[0]["host"] == slow and findings[0]["severity"] == "warning"
    healthy = str(tmp_path / "healthy.json")
    telemetry.merge_traces([p for h, p in enumerate(paths) if h != slow], healthy)
    ana2 = _both(healthy, straggler_ms=120.0)
    assert ana2["stragglers"]["straggler"] is None, ana2["stragglers"]
    assert [f for f in ana2["findings"] if f["rule"] == "tracelens.straggler"] == []


def test_host_delay_sleeps_only_while_armed(monkeypatch):
    """The ``trace.hostdelay`` seam (reference telemetry.py:796-822): each
    collective record sleeps HEAT_TPU_TRACE_DELAY_MS while the site is
    armed, fused collectives too, and not at all otherwise."""
    slept = []
    monkeypatch.setattr(telemetry.time, "sleep", slept.append)
    telemetry.record_collective("allreduce", axis="x", nbytes=8)
    assert slept == []
    with resilience.inject("trace.hostdelay", times=None):
        telemetry.record_collective("allreduce", axis="x", nbytes=8)
        telemetry.record_fused_collective("reshard", cid=1, detail="split=0")
    telemetry.record_fused_collective("reshard", cid=2, detail="split=1")
    assert slept == [telemetry._TRACE_DELAY_S] * 2
    prev = telemetry.set_mode(0)
    try:
        with resilience.inject("trace.hostdelay", times=None):
            telemetry.record_collective("allreduce")
    finally:
        telemetry.set_mode(prev)
    assert len(slept) == 2, "telemetry off records nothing and sleeps nothing"


def test_single_host_has_no_straggler_block():
    """tests/test_tracelens.py:296."""
    _reduction_chain()
    ana = tracelens.analyze()
    assert ana["stragglers"]["hosts"] == 1 and ana["stragglers"]["straggler"] is None


def test_clock_offset_is_removed_before_lag():
    """tests/test_tracelens.py:302."""
    def host(base):
        return [{"kind": "collective", "ts": base + 0.01 * k, "op": "allreduce"} for k in range(8)]

    doc = {0: host(0.0), 1: host(123.456)}
    strag = tracelens._stragglers(doc, straggler_s=0.005)
    assert strag["straggler"] is None, strag
    assert strag["offsets_ms"]["1"] == pytest.approx(123456.0, abs=1.0)
    assert max(strag["lag_ms"].values()) < 1.0
    assert strag == ref_tl._stragglers(doc, straggler_s=0.005)


# ---------------------------------------------------------------------------
# the detectors, on hand-built streams (TestDetectors)
# ---------------------------------------------------------------------------
def _hits(ana, rule):
    return [f for f in ana["findings"] if f["rule"] == rule]


def test_sync_storm_inside_a_span():
    """tests/test_tracelens.py:321."""
    evs = [{"kind": "span_begin", "ts": 0.0, "name": "loop"}]
    evs += [{"kind": "blocking_sync", "ts": 0.01 * (i + 1), "where": "item", "dur": 0.001} for i in range(30)]
    evs.append({"kind": "span_end", "ts": 0.5, "name": "loop", "dur": 0.5})
    hits = _hits(_both(evs, sync_storm_k=8), "tracelens.sync_storm")
    assert len(hits) == 1 and hits[0]["data"] == {"span": "loop", "syncs": 30}


def test_sync_storm_rolling_window_without_spans():
    """tests/test_tracelens.py:333."""
    evs = [{"kind": "blocking_sync", "ts": 0.005 * i, "where": "item", "dur": 0.001} for i in range(30)]
    assert len(_hits(_both(evs, sync_storm_k=8), "tracelens.sync_storm")) == 1


def test_retrace_storm_per_family():
    """tests/test_tracelens.py:342."""
    evs = [{"kind": "compile", "ts": 0.01 * i, "family": "exp|add", "cid": i} for i in range(6)]
    evs.append({"kind": "compile", "ts": 0.9, "family": "stable", "cid": 99})
    hits = _hits(_both(evs, retrace_k=4), "tracelens.retrace_storm")
    assert len(hits) == 1 and hits[0]["data"] == {"family": "exp|add", "compiles": 6}
    assert "program build" in hits[0]["hint"]


def test_reshard_pingpong_on_alternating_targets():
    """tests/test_tracelens.py:354."""
    evs = [
        {"kind": "fused_collective", "ts": 0.1 * (i + 1), "op": "reshard", "cid": i + 1, "detail": d}
        for i, d in enumerate(("split=0", "split=1", "split=0"))
    ]
    hits = _hits(_both(evs), "tracelens.reshard_pingpong")
    assert len(hits) == 1 and hits[0]["data"]["targets"] == ["split=0", "split=1", "split=0"]


def test_monotone_reshards_are_clean():
    """tests/test_tracelens.py:368."""
    evs = [
        {"kind": "fused_collective", "ts": 0.1 * i, "op": "reshard", "cid": i, "detail": f"split={i}"}
        for i in range(4)
    ]
    assert _hits(_both(evs), "tracelens.reshard_pingpong") == []


def test_device_idle_gap():
    """tests/test_tracelens.py:380."""
    evs = [{"kind": "collective", "ts": 0.0, "op": "allreduce"}, {"kind": "collective", "ts": 1.0, "op": "allreduce"}]
    hits = _hits(_both(evs), "tracelens.device_idle")
    assert len(hits) == 1 and hits[0]["severity"] == "warning" and hits[0]["data"]["host_gap_pct"] >= 99.0


def test_real_reshards_carry_detail():
    """tests/test_tracelens.py:393: a resplit of a pending chain records a
    reshard node whose ``detail`` names its target; 0 -> 1 -> 0 -> 1 of a
    pending chain is the ping-pong the detector names, in both analyzers."""
    if ht.get_comm().size < 2:
        pytest.skip("a resplit is shard-trivial on one device")
    a = _split_input()
    b = ht.resplit(a * 2.0, None)
    assert float(ht.sum(b)) == pytest.approx(2.0 * float(a.numpy().astype(np.float64).sum()), rel=1e-5, abs=1e-4)
    details = [e.get("detail") for e in telemetry.events() if e["kind"] == "fused_collective" and e["op"] == "reshard"]
    assert "replicated" in details, telemetry.events()
    telemetry.reset()
    x = _split_input(seed=2, n_mult=6) * 1.5
    for split in (1, 0, 1):
        x = ht.resplit(x + 0.0, split)
    np.testing.assert_allclose(x.numpy(), _split_input(seed=2, n_mult=6).numpy() * 1.5, rtol=1e-6)
    hits = _hits(_both(telemetry.events()), "tracelens.reshard_pingpong")
    assert len(hits) == 1 and hits[0]["data"]["targets"] == ["split=1", "split=0", "split=1"], hits


# ---------------------------------------------------------------------------
# dropped events (TestDroppedEvents)
# ---------------------------------------------------------------------------
@pytest.fixture
def overflow(monkeypatch):
    """A timeline capped at 8 events that saw 20."""
    def run(cap=8, extra=12):
        monkeypatch.setattr(telemetry, "_EVENT_CAP", cap)
        telemetry.reset()  # the deques at the patched cap
        for i in range(cap + extra):
            telemetry.record_event("probe", index=i)
    yield run
    monkeypatch.undo()
    telemetry.reset()


def test_analyze_refuses_truncated_window(overflow):
    """tests/test_tracelens.py:426."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", telemetry.TimelineDroppedWarning)
        overflow()
    with pytest.raises(tracelens.TraceIncompleteError):
        tracelens.analyze()


def test_allow_partial_analyzes_with_loud_caveat(overflow):
    """tests/test_tracelens.py:433."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", telemetry.TimelineDroppedWarning)
        overflow()
    ana = tracelens.analyze(allow_partial=True)
    assert ana["partial"] and ana["events_dropped"] == 12
    partial = _hits(ana, "tracelens.partial")
    assert len(partial) == 1 and partial[0]["severity"] == "info"
    assert "PARTIAL" in tracelens.render(ana)


def test_first_eviction_warns_once(overflow):
    """tests/test_tracelens.py:445."""
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        overflow()
    dropped = [w for w in caught if issubclass(w.category, telemetry.TimelineDroppedWarning)]
    assert len(dropped) == 1 and "HEAT_TPU_TELEMETRY_EVENTS" in str(dropped[0].message)
    with warnings.catch_warnings(record=True) as caught2:
        warnings.simplefilter("always")
        telemetry.record_event("probe", index=-1)
    assert [w for w in caught2 if issubclass(w.category, telemetry.TimelineDroppedWarning)] == []


def test_export_carries_dropped_count_and_file_is_refused(overflow, tmp_path):
    """tests/test_tracelens.py:462; both analyzers refuse the port's file."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", telemetry.TimelineDroppedWarning)
        overflow()
    path = str(tmp_path / "trace.json")
    assert telemetry.export_trace(path)["otherData"]["events_dropped"] == 12
    for analyze, error in ((tracelens.analyze, tracelens.TraceIncompleteError),
                           (ref_tl.analyze, ref_tl.TraceIncompleteError)):
        with pytest.raises(error):
            analyze(path)
    assert _both(path, allow_partial=True)["partial"]


def test_merge_sums_dropped_counts(overflow, tmp_path):
    """tests/test_tracelens.py:474."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", telemetry.TimelineDroppedWarning)
        overflow()
    p1, p2 = str(tmp_path / "a.json"), str(tmp_path / "b.json")
    telemetry.export_trace(p1)
    telemetry.export_trace(p2)
    assert telemetry.merge_traces([p1, p2])["otherData"]["events_dropped"] == 24


def test_clean_window_never_warns():
    """tests/test_tracelens.py:485."""
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        _reduction_chain()
    assert [w for w in caught if issubclass(w.category, telemetry.TimelineDroppedWarning)] == []


# ---------------------------------------------------------------------------
# the joins on adversarial streams (TestPairingRobustness)
# ---------------------------------------------------------------------------
def test_async_pairs_duplicate_cids_last_dispatch_wins():
    """tests/test_tracelens.py:499."""
    d1 = {"kind": "dispatch", "ts": 0.1, "cid": 7, "cids": [7], "roots": 1}
    d2 = {"kind": "dispatch", "ts": 0.2, "cid": 7, "cids": [7], "roots": 1}
    s = {"kind": "blocking_sync", "ts": 0.3, "cid": 7, "dur": 0.01}
    pairs = telemetry.async_pairs([d1, d2, s])
    assert len(pairs) == 1 and pairs[0][0] is d2


def test_async_pairs_orphans_drop_out():
    """tests/test_tracelens.py:507."""
    evs = [
        {"kind": "dispatch", "ts": 0.1, "cid": 1, "cids": [1], "roots": 1},
        {"kind": "blocking_sync", "ts": 0.2, "cid": 99, "dur": 0.01},
        {"kind": "blocking_sync", "ts": 0.3},
    ]
    assert telemetry.async_pairs(evs) == [] == ref_tel.async_pairs(evs)


def _random_soup(rng, n=40):
    """tests/test_tracelens.py:515: shuffled order, orphan syncs, duplicate
    cids, unstamped durations, unmatched span begins, NaN stamps."""
    evs = []
    for _ in range(n):
        roll = rng.integers(0, 8)
        ts = float(rng.uniform(0, 1.0))
        cid = int(rng.integers(1, 6))
        if roll == 0:
            evs.append({"kind": "dispatch", "ts": ts, "cid": cid, "cids": [cid, cid + 1], "roots": 2,
                        "program": f"p{cid}"})
        elif roll == 1:
            ev = {"kind": "blocking_sync", "ts": ts, "cid": cid, "where": "item"}
            if rng.integers(0, 2):
                ev["dur"] = float(rng.uniform(0, 0.05))
            evs.append(ev)
        elif roll == 2:
            evs.append({"kind": "compile", "ts": ts, "cid": cid, "family": f"f{cid % 2}", "program": f"p{cid}"})
        elif roll == 3:
            evs.append({"kind": "span_begin", "ts": ts, "name": "loop"})
        elif roll == 4:
            evs.append({"kind": "span_end", "ts": ts, "name": "loop", "dur": 0.1})
        elif roll == 5:
            evs.append({"kind": "collective", "ts": ts, "op": "allreduce"})
        elif roll == 6:
            evs.append({"kind": "blocking_sync", "ts": float("nan"), "cid": cid})
        else:
            evs.append({"kind": "fused_collective", "ts": ts, "op": "reshard", "cid": cid,
                        "detail": f"split={int(rng.integers(0, 2))}"})
    rng.shuffle(evs)
    return evs


@pytest.mark.parametrize("seed", range(20))
def test_analyze_invariants_hold_on_adversarial_streams(seed):
    """tests/test_tracelens.py:548, one case per seed: the accounting stays
    closed whatever the soup, and both analyzers give the same document,
    render and diagnosis."""
    evs = _random_soup(np.random.default_rng(seed))
    ana = _both(evs)
    window = ana["window_s"]
    assert window >= 0.0
    for rec in ana["attribution"]["overall"].values():
        assert rec["s"] >= -1e-9
    assert ana["attribution"]["unattributed_s"] >= -1e-9
    assert _bucket_sum(ana) + ana["attribution"]["unattributed_s"] == pytest.approx(window, abs=1e-5)
    assert ana["critical_path"]["total_s"] <= window + 1e-6
    json.dumps(ana)
    assert tracelens.render(ana) == ref_tl.render(_ported(ref_tl.analyze(evs)))
    _same(tracelens.diagnose(evs), ref_tl.diagnose(evs))


def test_sync_without_dispatch_is_sync_wait_not_device():
    """tests/test_tracelens.py:573."""
    overall = _both([{"kind": "blocking_sync", "ts": 0.1, "cid": 5, "dur": 0.2, "where": "drain"}])[
        "attribution"]["overall"]
    assert "sync_wait" in overall and "device_execute" not in overall


def test_dispatch_without_sync_is_not_provably_idle():
    """tests/test_tracelens.py:581."""
    ana = _both([
        {"kind": "dispatch", "ts": 0.0, "cid": 1, "cids": [1], "roots": 1},
        {"kind": "collective", "ts": 1.0, "op": "allreduce"},
    ])
    overall = ana["attribution"]["overall"]
    assert "host_async" in overall and "host_gap" not in overall
    assert _hits(ana, "tracelens.device_idle") == []


# ---------------------------------------------------------------------------
# the command line (TestCLI)
# ---------------------------------------------------------------------------
def _export(tmp_path, name="trace.json"):
    _reduction_chain()
    path = str(tmp_path / name)
    telemetry.export_trace(path)
    return path


def _run(main, argv):
    out = pyio.StringIO()
    return main(argv, out=out), out.getvalue()


def test_analyze_clean_trace_exits_zero(tmp_path):
    """tests/test_tracelens.py:611; the text equals the reference command
    line's on the same file."""
    path = _export(tmp_path)
    rc, text = _run(cli.main, ["analyze", path])
    assert rc == 0, text
    assert "time attribution:" in text and "critical path" in text
    assert (rc, text) == _run(ref_cli.main, ["analyze", path])


def test_analyze_json_is_machine_checkable(tmp_path):
    """tests/test_tracelens.py:621."""
    path = _export(tmp_path)
    rc, text = _run(cli.main, ["analyze", path, "--json"])
    doc = json.loads(text)
    assert rc == 0 and doc["attribution"]["unattributed_pct"] <= 5.0
    assert doc["findings"] == [] and "critical_path" in doc
    assert doc == json.loads(_run(ref_cli.main, ["analyze", path, "--json"])[1])


def test_against_self_is_clean_and_regression_gates(tmp_path):
    """tests/test_tracelens.py:632."""
    path = _export(tmp_path)
    rc, text = _run(cli.main, ["analyze", path, "--against", path])
    assert rc == 0, text
    evs = [{"kind": "span_begin", "ts": 0.0, "name": "loop"}]
    evs += [{"kind": "blocking_sync", "ts": 0.01 * (i + 1), "where": "item", "dur": 0.001} for i in range(40)]
    evs.append({"kind": "span_end", "ts": 0.9, "name": "loop", "dur": 0.9})
    bad = str(tmp_path / "bad.json")
    with open(bad, "w") as fh:
        json.dump({"traceEvents": telemetry.trace_events(evs, pid=0), "otherData": {"events_dropped": 0}}, fh)
    rc, text = _run(cli.main, ["analyze", bad, "--against", path])
    assert rc == 1 and "sync_storm" in text and "REGRESSION" in text
    assert _run(ref_cli.main, ["analyze", bad, "--against", path])[0] == 1


def test_against_accepts_saved_analysis(tmp_path):
    """tests/test_tracelens.py:656."""
    path = _export(tmp_path)
    saved = str(tmp_path / "analysis.json")
    with open(saved, "w") as fh:
        fh.write(_run(cli.main, ["analyze", path, "--json"])[1])
    rc, text = _run(cli.main, ["analyze", path, "--against", saved])
    assert rc == 0, text
    assert tracelens.load_analysis(saved) == json.loads(open(saved).read())


def test_malformed_input_exits_two(tmp_path):
    """tests/test_tracelens.py:668."""
    bad = tmp_path / "bad.json"
    bad.write_text("{not json")
    rc, text = _run(cli.main, ["analyze", str(bad)])
    assert rc == 2 and "ERROR" in text
    notrace = tmp_path / "notatrace.json"
    notrace.write_text(json.dumps({"hello": 1}))
    assert _run(cli.main, ["analyze", str(notrace)])[0] == 2
    assert _run(cli.main, ["analyze", str(tmp_path / "missing.json")])[0] == 2


def test_truncated_trace_refused_unless_allow_partial(tmp_path):
    """tests/test_tracelens.py:682."""
    doc = {
        "traceEvents": [
            {"ph": "i", "s": "t", "cat": "collective", "name": "allreduce", "pid": 0, "tid": 0, "ts": t, "args": {}}
            for t in (0.0, 1000.0)
        ],
        "otherData": {"events_dropped": 3},
    }
    path = tmp_path / "truncated.json"
    path.write_text(json.dumps(doc))
    rc, text = _run(cli.main, ["analyze", str(path)])
    assert rc == 2 and "REFUSED" in text
    rc, text = _run(cli.main, ["analyze", str(path), "--allow-partial"])
    assert rc == 0 and "PARTIAL" in text, text


def test_analyze_subprocess_never_initializes_cuda(tmp_path):
    """``python -m heat_tpu_torch.telemetry analyze <file> --json`` as a
    user runs it (chip_smoke.py phase 21 runs it on the card): the buckets
    and findings of the in-process analysis, and CUDA untouched."""
    path = _export(tmp_path)
    code = ("import runpy, sys, torch; sys.argv = ['telemetry', 'analyze', sys.argv[1], '--json']\n"
            "try:\n    runpy.run_module('heat_tpu_torch.telemetry', run_name='__main__')\n"
            "except SystemExit as exc:\n    rc = exc.code\n"
            "assert not torch.cuda.is_initialized()\nsys.exit(rc)\n")
    proc = subprocess.run([sys.executable, "-c", code, path], cwd=ROOT, capture_output=True, text=True, timeout=120,
                          env=dict(os.environ, PYTHONPATH=ROOT))
    assert proc.returncode == 0, proc.stderr
    doc = json.loads(proc.stdout)
    assert doc == json.loads(json.dumps(tracelens.analyze(path)))


# ---------------------------------------------------------------------------
# the flight recorder (TestFlightDiagnosis)
# ---------------------------------------------------------------------------
def test_dump_bundle_embeds_one_page_diagnosis(tmp_path):
    """tests/test_tracelens.py:709; the diagnosis is the reference's
    ``diagnose`` of the same ring."""
    prev = health_runtime.set_flight(True, 256)
    try:
        telemetry.reset()
        _reduction_chain()
        ring = health_runtime.flight_events()
        dump = health_runtime.dump_flight(str(tmp_path / "bundle.json"), reason="test")
        with open(dump["path"]) as fh:
            diag = json.load(fh)["diagnosis"]
    finally:
        health_runtime.set_flight(*prev)
    assert isinstance(diag, dict) and "error" not in diag, diag
    assert "trace window" in diag["text"] and "attribution" in diag and isinstance(diag["findings"], list)
    assert "unattributed_pct" in diag
    _same(diag, ref_tl.diagnose(ring))


def test_diagnose_never_raises_on_garbage():
    """tests/test_tracelens.py:729."""
    assert "error" in tracelens.diagnose([])
    assert isinstance(tracelens.diagnose([{"kind": "collective"}]), dict)
    _same(tracelens.diagnose([{"kind": "collective", "ts": 0.0}]), ref_tl.diagnose([{"kind": "collective", "ts": 0.0}]))


# ---------------------------------------------------------------------------
# post-hoc purity (TestAnalyzerPurity)
# ---------------------------------------------------------------------------
def test_analyze_never_forces_a_pending_chain():
    """tests/test_tracelens.py:740."""
    _reduction_chain()
    a = _split_input()
    x = ht.exp(a * 0.5) + 1.0
    assert fusion.is_deferred(x)
    n = len(telemetry.events())
    tracelens.render(tracelens.analyze())
    tracelens.diagnose(telemetry.events())
    assert fusion.is_deferred(x), "analyze forced the chain"
    assert len(telemetry.events()) == n, "analyze recorded an event"


def test_analyzer_never_initializes_cuda():
    """tests/test_tracelens.py:748: analyze, render and diff over synthetic
    events in a fresh process build no mesh and leave CUDA uninitialized."""
    code = (
        "import torch\n"
        "from heat_tpu_torch.core import communication, tracelens\n"
        "evs = [\n"
        "    {'kind': 'dispatch', 'ts': 0.0, 'cid': 1, 'cids': [1], 'roots': 1, 'program': 'p1'},\n"
        "    {'kind': 'compile', 'ts': 0.01, 'cid': 1, 'program': 'p1'},\n"
        "    {'kind': 'blocking_sync', 'ts': 0.0, 'cid': 1, 'dur': 0.1, 'where': 'item'},\n"
        "]\n"
        "ana = tracelens.analyze(evs)\n"
        "tracelens.render(ana)\n"
        "tracelens.diff(ana, ana)\n"
        "assert not communication._WORLDS and not torch.cuda.is_initialized()\n"
        "print('OK')\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, cwd=ROOT, timeout=120,
                          env=dict(os.environ, PYTHONPATH=ROOT))
    assert proc.returncode == 0, proc.stderr
    assert "OK" in proc.stdout


# ---------------------------------------------------------------------------
# diff (TestDiff)
# ---------------------------------------------------------------------------
def test_self_diff_is_clean():
    """tests/test_tracelens.py:781."""
    _reduction_chain()
    ana = tracelens.analyze()
    delta = tracelens.diff(ana, ana)
    assert delta["ok"] and delta["new_findings"] == [] and delta["bucket_shifts_pts"] == {}
    assert delta == ref_tl.diff(ana, ana)


def test_unattributed_growth_is_a_regression():
    """tests/test_tracelens.py:789."""
    _reduction_chain()
    ana = tracelens.analyze()
    worse = json.loads(json.dumps(ana))
    worse["attribution"]["unattributed_pct"] = ana["attribution"]["unattributed_pct"] + 10.0
    delta = tracelens.diff(ana, worse)
    assert not delta["ok"] and any("unattributed" in r for r in delta["regressions"])
    assert delta == ref_tl.diff(ana, worse)


def test_critical_path_growth_is_a_regression():
    """tests/test_tracelens.py:802."""
    _reduction_chain()
    ana = tracelens.analyze()
    worse = json.loads(json.dumps(ana))
    worse["critical_path"]["total_s"] = ana["critical_path"]["total_s"] * 3.0
    delta = tracelens.diff(ana, worse)
    assert not delta["ok"] and delta["critical_path_growth_pct"] > 100.0
    assert delta == ref_tl.diff(ana, worse)


def test_knobs_and_finding_schema_equal_the_references():
    """The detector defaults read the reference's knobs, and a finding's
    dictionary is the reference's."""
    for name in ("_SYNC_STORM_K", "_SYNC_STORM_WINDOW_S", "_RETRACE_STORM_K", "_IDLE_GAP_MS", "_IDLE_GAP_PCT",
                 "_STRAGGLER_MS", "_MIN_MATCHED_COLLECTIVES", "_MAX_PATH_STEPS", "_BUCKET_PRIORITY",
                 "_BLOCKING_BUCKETS", "SCHEMA", "_NUMERIC_DRIFT_ULP", "_DIFF_UNATTRIBUTED_PTS",
                 "_DIFF_PATH_GROWTH_PCT"):
        assert getattr(tracelens, name) == getattr(ref_tl, name), name
    kw = dict(rule="r", severity="info", message="m", hint="h", host=3, data={"k": 1})
    assert tracelens.Finding(**kw).as_dict() == ref_tl.Finding(**kw).as_dict()
    assert tracelens.Finding("r", "info", "m").as_dict() == ref_tl.Finding("r", "info", "m").as_dict()
