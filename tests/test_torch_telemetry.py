"""heat_tpu_torch.core.telemetry and its command line against heat_tpu's
(tests/test_telemetry.py). CPU only.

Both packages run the same calls at meshes 1, 3 and 5 with their telemetry
on. Counts and bytes are integers and are compared exactly:

* the declared linear-algebra schedules (CholeskyQR2, TSQR, the panel QR,
  the blocked substitution) give the same ``collectives()``: count, bytes,
  axes and dtypes;
* spans and scopes give the same paths, calls and collective counts;
* ``report()`` has the reference's keys less the blocks of the modules
  the port does not have yet;
* each package's exported trace passes the other package's
  ``validate_trace``, and the command lines print the same text.

The port's verbs record what the port does on every call, held to the
counting mesh of tests/torch_counting.py; where heat_tpu records nothing
(a reduction or a resplit that XLA runs inside the program) the difference
is a kept divergence with its own test.
"""

from __future__ import annotations

import importlib
import io as pyio
import json
import os
import subprocess
import sys
import tempfile
import time
import warnings

import jax
import numpy as np
import pytest
import torch

import heat_tpu as ref
import heat_tpu_torch as ht
from heat_tpu.core import telemetry as ref_tel
from heat_tpu.core.communication import MeshCommunication as RefMesh
from heat_tpu_torch.core import telemetry as tel
from heat_tpu_torch.core.communication import MeshCommunication
from test_torch_parity import eager_engines, on_cpu  # noqa: F401

# every test here holds the eager engines' accounting against heat_tpu's
pytestmark = pytest.mark.usefixtures("eager_engines")
from torch_counting import CountingMesh

# the command-line modules (the packages' ``telemetry`` attribute is the core module)
cli = importlib.import_module("heat_tpu_torch.telemetry")
ref_cli = importlib.import_module("heat_tpu.telemetry")

MESHES = [1, 3, 5]
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: report() blocks of the fusion recorder; the serving block is there once
#: the serving layer has sessions, in either package
FUSION_BLOCKS = {"fusion_cache", "programs", "forcing_points", "unfused_reasons", "retraces", "degraded"}
SESSION_BLOCKS = {"serving"}


@pytest.fixture(autouse=True)
def telemetry_on():
    """Both packages at mode 1 with clean counters; restored after."""
    was = tel.set_mode(1), ref_tel.set_mode(1)
    tel.reset()
    ref_tel.reset()
    yield
    tel.set_mode(was[0])
    ref_tel.set_mode(was[1])
    tel.reset()
    ref_tel.reset()


def _mesh(p):
    return MeshCommunication([torch.device("cpu")] * p)


def _ref_mesh(p):
    """The reference's mesh of p shards (capped at the JAX CPU mesh's size)."""
    return RefMesh(jax.devices()[:p])


class _Counting(CountingMesh):
    """The shared counting mesh, also counting the prefix verbs."""

    def exscan(self, shards, op="sum", neutral=None):
        self.calls["exscan"] += 1
        return super().exscan(shards, op, neutral)

    def scan(self, shards, op="sum"):
        self.calls["scan"] += 1
        return super().scan(shards, op)


def _counting(p):
    return _Counting([torch.device("cpu")] * p)


def _pair(p):
    """(port mesh, reference mesh) of the same number of shards: p, capped
    at the JAX CPU mesh's size."""
    p = min(p, len(jax.devices()))
    return _mesh(p), _ref_mesh(p)


# ---------------------------------------------------------------------------
# the declared schedules (test_telemetry.py::TestCollectiveAccounting)
# ---------------------------------------------------------------------------
def _linalg_case(pkg, comm, case, p):
    rng = np.random.default_rng(7)
    if case in ("tsqr", "cholqr2"):
        a = rng.standard_normal((16 * p + 3, 4)).astype(np.float32)
        x = pkg.array(a, split=0, comm=comm)
        pkg.linalg.qr(x, method="tsqr" if case == "tsqr" else "auto")
    elif case == "panel":
        a = rng.standard_normal((3 * p + 6, 3 * p + 1)).astype(np.float32)
        pkg.linalg.qr(pkg.array(a, split=1, comm=comm))
    else:
        n = 8 * p + 2
        lower = case != "solve_triangular_upper"
        t = (np.tril if lower else np.triu)(rng.standard_normal((n, n))) + 4 * np.eye(n)
        rhs = rng.standard_normal(n) if case == "solve_triangular_lower" else rng.standard_normal((n, 3))
        a_split = 1 if case == "solve_triangular_split1" else 0
        pkg.linalg.solve_triangular(
            pkg.array(t.astype(np.float32), split=a_split, comm=comm),
            pkg.array(rhs.astype(np.float32), split=0, comm=comm),
            lower=lower,
        )


@pytest.mark.parametrize("p", MESHES)
@pytest.mark.parametrize(
    "case", ["tsqr", "cholqr2", "panel", "solve_triangular_lower", "solve_triangular_upper", "solve_triangular_split1"]
)
def test_declared_linalg_schedules_match_heat_tpu(case, p):
    """Exact: the same ops, counts, bytes, axes and dtypes."""
    mine, theirs = _pair(p)
    p = mine.size
    _linalg_case(ht, mine, case, p)
    _linalg_case(ref, theirs, case, p)
    assert tel.collectives() == ref_tel.collectives()
    if p > 1:
        assert tel.collective_counts(), case


@pytest.mark.parametrize("p", [3, 5])
def test_a_declared_schedule_records_its_verbs_once(p):
    """A schedule's own verbs run silently: the panel QR declares 2p bcasts
    (a Q and an R panel each) where its verbs run p, and the blocked
    substitution one allreduce per stage."""
    comm = _counting(p)
    rng = np.random.default_rng(1)
    ht.linalg.qr(ht.array(rng.standard_normal((3 * p + 4, 3 * p)).astype(np.float32), split=1, comm=comm))
    assert comm.calls == {"bcast": p}
    assert tel.collective_counts() == {"bcast": 2 * p}


# ---------------------------------------------------------------------------
# the verbs record what the port does (held to the counting mesh)
# ---------------------------------------------------------------------------
def _verb_calls(x):
    y = ht.ones((x.gshape[1], 2), split=None, comm=x.comm)
    return [
        lambda: ht.sum(x, axis=0),
        lambda: ht.cumsum(x, axis=0),
        lambda: ht.matmul(x, y),
        lambda: ht.matmul(ht.array(x.numpy().T, split=1, comm=x.comm), x),
        lambda: x.get_halo(1),
        lambda: ht.spatial.cdist(x, x),
        lambda: ht.unique(x.flatten()) if x.split == 0 else None,
        lambda: ht.linalg.dot(ht.arange(10, split=0, comm=x.comm), ht.arange(10, split=0, comm=x.comm)),
    ]


@pytest.mark.parametrize("p", MESHES)
@pytest.mark.parametrize("call", range(8))
def test_verbs_count_as_the_counting_mesh_does(call, p):
    comm = _counting(p)
    x = ht.array(np.random.default_rng(2).standard_normal((11, 4)).astype(np.float32), split=0, comm=comm)
    comm.calls.clear()
    tel.reset()
    _verb_calls(x)[call]()
    assert tel.collective_counts() == dict(comm.calls)
    for rec in tel.collectives().values():
        assert rec["axes"] == {"split": rec["count"]}


@pytest.mark.parametrize("p", [3, 5])
def test_a_verb_records_one_participants_bytes(p):
    """The reference's in-kernel rule: an allreduce of (1, 4) float32
    partials moves 16 bytes per participant."""
    x = ht.array(np.ones((11, 4), np.float32), split=0, comm=_mesh(p))
    ht.sum(x, axis=0)
    assert tel.collectives() == {"allreduce": {"count": 1, "bytes": 16, "axes": {"split": 1}, "dtypes": {"float32": 1}}}
    x.get_halo(2)
    rec = tel.collectives()["ppermute"]
    assert rec["count"] == 2 and rec["bytes"] == 2 * 2 * 4 * 4


@pytest.mark.parametrize("p", MESHES)
def test_reductions_and_resplits_diverge_from_heat_tpu_as_kept(p):
    """Kept divergence: heat_tpu's eager ``sum`` over the split axis and its
    ``resplit`` record nothing (XLA combines inside the program); the port's
    ``sum`` runs one allreduce on a distributed array and records it. A
    resplit records nothing in either package."""
    mine, theirs = _pair(p)
    p = mine.size
    v = np.arange(44, dtype=np.float32).reshape(11, 4)
    x, y = ht.array(v, split=0, comm=mine), ref.array(v, split=0, comm=theirs)
    ht.sum(x, axis=0)
    ref.sum(y, axis=0)
    assert ref_tel.collective_counts() == {}
    assert tel.collective_counts() == ({"allreduce": 1} if p > 1 else {})
    tel.reset()
    x.resplit(1)
    y.resplit(1)
    assert tel.collective_counts() == ref_tel.collective_counts() == {}


@pytest.mark.parametrize("p", [3, 5])
def test_a_mixed_split_binary_op_records_its_reshard_as_heat_tpu_does(p):
    mine, theirs = _pair(p)
    v = np.arange(20, dtype=np.float32).reshape(5, 4)
    ht.array(v, split=0, comm=mine) + ht.array(v, split=1, comm=mine)
    ref.array(v, split=0, comm=theirs) + ref.array(v, split=1, comm=theirs)
    assert tel.collectives()["reshard"]["count"] == ref_tel.collectives()["reshard"]["count"] == 1
    assert tel.collectives()["reshard"]["bytes"] == ref_tel.collectives()["reshard"]["bytes"] == v.nbytes


# ---------------------------------------------------------------------------
# engines, host reads, the disabled path
# ---------------------------------------------------------------------------
def _ten_op_chain(pkg, a, b):
    """The reference's 10-op pipeline (9 elementwise, 1 reduction)."""
    c = (a + b) * 2.0
    c = pkg.exp(c)
    c = c - b
    d = pkg.abs(c)
    e = d + a
    f = pkg.sqrt(pkg.abs(e))
    g = f / (d + 1.0)
    h = g * b
    return pkg.sum(h)


@pytest.mark.parametrize("p", MESHES)
def test_engines_count_their_dispatches_as_heat_tpus_eager_engines(p):
    mine, theirs = _pair(p)
    v = np.ones((8, 4), np.float32)
    a, b = ht.array(v, split=0, comm=mine), ref.array(v, split=0, comm=theirs)
    _ten_op_chain(ht, a, a)
    ht.cumsum(a, axis=1)
    _ten_op_chain(ref, b, b)
    ref.cumsum(b, axis=1)
    d = tel.dispatches()
    assert d == {k: v for k, v in ref_tel.dispatches().items()}
    assert d["binary"] == {"fused": 0, "eager": 7} and d["cum"] == {"fused": 0, "eager": 1}


def test_host_reads_are_blocking_syncs_with_their_wait():
    x = ht.array(np.arange(6.0), split=0, comm=_mesh(3))
    ht.sum(x).item()
    x.numpy()
    str(x)
    blk = tel.async_forcing()
    assert blk["blocking_syncs"] == {"item": 1, "numpy": 1, "print": 1}
    assert {k: v["count"] for k, v in blk["sync_wait"].items()} == {"item": 1, "numpy": 1, "print": 1}


def test_disabled_records_nothing():
    tel.set_mode(0)
    x = ht.array(np.ones((8, 4), np.float32), split=0, comm=_mesh(3))
    _ten_op_chain(ht, x, x).item()
    str(x)
    with tel.span("noop") as path, tel.scope("s") as spath:
        assert path is None and spath is None
    rep = tel.report()
    assert not rep["enabled"]
    for key in ("collective_counts", "dispatches", "spans", "scopes", "faults"):
        assert rep[key] == {}, key
    assert rep["async_forcing"]["blocking_total"] == 0


@pytest.mark.parametrize("value", [0, 1, 2, True, False, "", "0", "off", "on", "1", "verbose", "debug", "yes", 7, -1])
def test_modes_parse_as_heat_tpus(value):
    assert tel._parse_mode(value) == ref_tel._parse_mode(value)
    tel.set_mode(value)
    ref_tel.set_mode(value)
    assert (tel.active(), tel.verbose()) == (ref_tel.active(), ref_tel.verbose())


# ---------------------------------------------------------------------------
# spans, scopes, the report (TestSpans, TestReport)
# ---------------------------------------------------------------------------
def _span_script(pkg, t, comm, p):
    rng = np.random.default_rng(3)
    a = pkg.array(rng.standard_normal((16 * p, 4)).astype(np.float32), split=0, comm=comm)
    n = 8 * p
    tri = pkg.array((np.tril(rng.standard_normal((n, n))) + 4 * np.eye(n)).astype(np.float32), split=0, comm=comm)
    rhs = pkg.array(rng.standard_normal(n).astype(np.float32), split=0, comm=comm)
    with t.scope("job"):
        for _ in range(2):
            with t.span("fit"):
                pkg.linalg.qr(a, method="tsqr")
                with t.span("iter"):
                    pkg.linalg.solve_triangular(tri, rhs, lower=True)
        with t.scope("inner"), t.span("solve"):
            pkg.linalg.solve_triangular(tri, rhs, lower=True)
    with t.scope("job"):
        pass


def _span_view(t):
    return {path: (rec["calls"], rec["collectives"]) for path, rec in t.spans().items()}


def _scope_view(t):
    return {
        path: (rec["calls"], rec["collective_counts"], sorted(rec["spans"]), {k: v["calls"] for k, v in rec["spans"].items()})
        for path, rec in t.scope_reports().items()
    }


@pytest.mark.parametrize("p", MESHES)
def test_spans_and_scopes_match_heat_tpu(p):
    mine, theirs = _pair(p)
    _span_script(ht, tel, mine, p)
    _span_script(ref, ref_tel, theirs, p)
    assert _span_view(tel) == _span_view(ref_tel)
    assert set(_span_view(tel)) == {"fit", "fit/iter", "solve"}
    assert _scope_view(tel) == _scope_view(ref_tel)
    assert set(tel.scope_reports()) == {"job", "job/inner"}
    assert tel.scope_reports()["job"]["calls"] == 2
    # each span mirrors its host time into the timer registry
    timers = ht.utils.profiling.report()
    assert timers["span:fit"]["calls"] == 2 and timers["span:fit/iter"]["calls"] == 2


def test_report_has_the_references_keys_less_the_later_blocks():
    mine, theirs = _pair(3)
    _span_script(ht, tel, mine, 3)
    _span_script(ref, ref_tel, theirs, 3)
    for mode in (1, 2):
        tel.set_mode(mode)
        ref_tel.set_mode(mode)
        assert set(tel.report()) - SESSION_BLOCKS == set(ref_tel.report()) - SESSION_BLOCKS
        for path, doc in tel.scope_reports().items():
            assert set(doc) == set(ref_tel.scope_reports()[path]) - SESSION_BLOCKS


def test_report_json_round_trips_and_is_deterministic():
    x = ht.array(np.ones((9, 2), np.float32), split=0, comm=_mesh(3))
    with tel.span("s"):
        ht.sum(x, axis=0)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "telemetry.json")
        text = tel.report_json(path)
        with open(path) as fh:
            assert json.load(fh) == json.loads(text)  # one report's file against its own text
    doc = json.loads(text)
    assert doc["collective_counts"] == {"allreduce": 1}

    def stable(d):
        # the timers and the OS-sampled host memory (resident set size) move
        # between two reports; every other block is deterministic
        memory = {k: v for k, v in d["memory"].items() if k != "host"}
        return {**d, "timers": None, "memory": memory}

    assert stable(json.loads(tel.report_json())) == stable(doc)
    assert tel._jsonable({("a", 1): {1, 2}, "t": (1, np.float32(2.5))}) == ref_tel._jsonable({("a", 1): {1, 2}, "t": (1, np.float32(2.5))})


def test_report_leaves_cuda_uninitialized():
    rep = tel.report()
    assert rep["memory"]["device"] == {}
    assert set(rep["memory"]["host"]) <= {"rss_bytes", "peak_rss_bytes", "total_bytes"}
    assert not torch.cuda.is_initialized()


def test_the_event_cap_drops_the_oldest_visibly(monkeypatch):
    for t in (tel, ref_tel):
        monkeypatch.setattr(t, "_EVENT_CAP", 4)
        t.set_mode(2)
        t.reset()
        with pytest.warns(t.TimelineDroppedWarning):
            for i in range(6):
                t.record_event("io", op=f"e{i}")
        assert [e["op"] for e in t.events()] == ["e2", "e3", "e4", "e5"]
        assert t.report()["timeline"] == {"events": 4, "events_dropped": 2, "cap": 4}


def test_counters_of_the_resilience_and_checkpoint_seams_match():
    for t in (tel, ref_tel):
        t.record_fault("io.write", "io.*")
        t.record_io_retry("io.write")
        t.record_nonfinite("eager")
        t.record_checkpoint("save", 1)
        t.record_degraded(("add", "mul"), "compile", "boom")
        t.record_force("print", 3, compiled=True)
        t.record_retrace(("add",), (1,))
        t.record_compile("apply:k")
        t.record_unfused("binary", "out=")
        t.record_fused_collective("reduce.psum")
        t.record_async_dispatch(2, cid=1, cids=(1, 2), program="p0")
    mine, theirs = tel.report(), ref_tel.report()
    for key in ("faults", "io_retries", "nonfinite", "checkpoint", "jit_compiles", "forcing_points",
                "unfused_reasons", "retraces", "degraded", "async_forcing"):
        assert mine[key] == theirs[key], key
    # the fused-collective entry point takes the reference's arguments
    assert FUSION_BLOCKS <= set(mine)
    assert mine["fused_collectives"] == theirs["fused_collectives"] == {"reduce.psum": 1}


# ---------------------------------------------------------------------------
# the trace timeline (TestTraceExport)
# ---------------------------------------------------------------------------
def _traced(pkg, t, comm, path):
    t.set_mode(2)
    t.reset()
    p = comm.size
    x = pkg.array(np.arange(18 * p, dtype=np.float32).reshape(6 * p, 3), split=0, comm=comm)
    with t.span("fit"), t.span("iter"):
        pkg.sum(x, axis=0)
        pkg.linalg.qr(x, method="tsqr")
    t.record_event("checkpoint_phase", phase="save_begin", step=1)
    t.record_io_retry("io.write")
    token = t.record_blocking_sync("item", cid=7)
    t.record_async_dispatch(1, cid=7, cids=(7,), program="p")
    t.end_blocking_sync(token)
    return t.export_trace(path)


@pytest.mark.parametrize("p", MESHES)
def test_each_packages_trace_passes_the_others_validator(p, tmp_path):
    mine, theirs = _pair(p)
    p = mine.size
    a, b = str(tmp_path / "port.json"), str(tmp_path / "ref.json")
    doc = _traced(ht, tel, mine, a)
    _traced(ref, ref_tel, theirs, b)
    for path in (a, b):
        assert tel.validate_trace(path) == [] and ref_tel.validate_trace(path) == []
        assert tel.validate_trace(path, cross_host=True) == ref_tel.validate_trace(path, cross_host=True) == []
    names = [e["name"] for e in doc["traceEvents"] if e["ph"] == "B"]
    assert names == ["fit", "fit/iter"]
    assert any(e["ph"] == "X" for e in doc["traceEvents"])
    # both pair the async dispatch with the sync that waited on it (b/e, by cid)
    for events in (doc["traceEvents"], ref_tel.export_trace()["traceEvents"]):
        assert [(e["ph"], e["id"]) for e in events if e["ph"] in ("b", "e")] == [("b", "7"), ("e", "7")]
    if p > 1:
        assert [e["name"] for e in doc["traceEvents"] if e.get("cat") == "collective"] == ["allreduce", "allgather"]


def test_validate_trace_finds_what_the_reference_finds():
    bad = [
        {"traceEvents": [{"ph": "i", "pid": 0}]},
        {"traceEvents": [{"ph": "b", "pid": 0, "ts": 1.0}]},
        {"traceEvents": [{"ph": "b", "pid": 0, "ts": 1.0, "id": "1"}]},
        {"traceEvents": [{"ph": "e", "pid": 0, "ts": 1.0, "id": "1"}]},
        {"traceEvents": [{"ph": "C", "pid": 0, "ts": 1.0, "args": {"x": "y"}}]},
        {"traceEvents": ["x", {"ts": 0}]},
        {"nothing": 1},
    ]
    for doc in bad:
        assert tel.validate_trace(doc) == ref_tel.validate_trace(doc) != []


def test_merge_traces_of_two_port_traces(tmp_path):
    paths = []
    for i, p in enumerate((3, 5)):
        path = str(tmp_path / f"h{i}.json")
        _traced(ht, tel, _mesh(p), path)
        paths.append(path)
    out = str(tmp_path / "merged.json")
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        merged = tel.merge_traces(paths, out, check_parity=True)
    assert sorted({e["pid"] for e in merged["traceEvents"]}) == [0, 1]
    assert tel.validate_trace(out) == []
    assert merged["otherData"]["merged_from"] == 2
    assert min(e["ts"] for e in merged["traceEvents"] if e["pid"] == 1 and "ts" in e) == 0.0
    assert not [w for w in caught if "parity" in str(w.message)]
    # a row missing a collective fails parity, as in the reference
    doc = json.load(open(out))
    doc["traceEvents"] = [e for e in doc["traceEvents"] if not (e["pid"] == 1 and e.get("name") == "allgather")]
    assert tel.trace_collective_parity(doc) == ref_tel.trace_collective_parity(doc) != []


def test_hlo_parsers_on_the_reference_suites_strings():
    hlo = "\n".join([
        "ENTRY main {",
        "  %p0 = f32[8]{0} parameter(0)",
        "  %all-reduce.1 = f32[8]{0} all-reduce(f32[8]{0} %p0), to_apply=%add",
        "  %ag = f32[64]{0} all-gather(f32[8]{0} %all-reduce.1), dimensions={0}",
        "  %ars = f32[8]{0} all-reduce-start(f32[8]{0} %p0), to_apply=%add",
        "  %ard = f32[8]{0} all-reduce-done(f32[8]{0} %ars)",
        "  %a2a = f32[8]{0} all-to-all(f32[8]{0} %p0), dimensions={0}",
        "  %rs = f32[1]{0} reduce-scatter(f32[8]{0} %p0), dimensions={0}",
        "  ROOT %cp = f32[8]{0} collective-permute(f32[8]{0} %ag), source_target_pairs={{0,1}}",
        "}",
    ])
    counts = tel.hlo_collective_counts(hlo)
    assert counts == {"all-reduce": 2, "all-gather": 1, "collective-permute": 1, "all-to-all": 1, "reduce-scatter": 1}
    assert counts == ref_tel.hlo_collective_counts(hlo)
    assert tel.hlo_collectives(hlo) == ref_tel.hlo_collectives(hlo)
    for budget in (dict(counts), {"all-reduce": 1}, {}):
        assert tel.collective_budget_excess(counts, budget) == ref_tel.collective_budget_excess(counts, budget)
    assert tel.collective_budget_excess(counts, dict(counts)) == {}


# ---------------------------------------------------------------------------
# the command line (heat_tpu/telemetry.py)
# ---------------------------------------------------------------------------
def _reports(tmp_path):
    """Two report files of the reference and two of the port."""
    files = {}
    for name, pkg, t, comm in (("ref", ref, ref_tel, _ref_mesh(3)), ("port", ht, tel, _mesh(3))):
        t.reset()
        x = pkg.array(np.ones((9, 2), np.float32), split=0, comm=comm)
        with t.scope("s"), t.span("fit"):
            pkg.linalg.qr(x, method="tsqr")
        t.report_json(str(tmp_path / f"{name}_a.json"))
        t.record_io_retry("io.write")
        t.record_checkpoint("save", 2)
        t.record_nonfinite("eager")
        t.report_json(str(tmp_path / f"{name}_b.json"))
        files[name] = (str(tmp_path / f"{name}_a.json"), str(tmp_path / f"{name}_b.json"))
    return files


def _run(main, argv):
    out = pyio.StringIO()
    rc = main(argv, out=out)
    return rc, out.getvalue()


def test_the_command_lines_print_the_same(tmp_path):
    files = _reports(tmp_path)
    trace = str(tmp_path / "t.json")
    _traced(ht, tel, _mesh(3), trace)
    broken = str(tmp_path / "broken.json")
    with open(broken, "w") as fh:
        json.dump({"traceEvents": [{"ph": "b", "pid": 0, "ts": 1.0, "id": "x"}]}, fh)
    for name in ("ref", "port"):
        a, b = files[name]
        for argv in (["show", a], ["show", b], ["show", "--raw", b], ["diff", a, b], ["diff", a, a]):
            assert _run(cli.main, argv) == _run(ref_cli.main, argv), argv
    for argv in (["validate-trace", trace], ["validate-trace", "--cross-host", trace], ["validate-trace", broken]):
        assert _run(cli.main, argv) == _run(ref_cli.main, argv), argv
    rc, text = _run(cli.main, ["show", files["port"][1]])
    assert rc == 0 and "io_retries" in text and "spans:" in text
    assert _run(cli.main, ["validate-trace", broken])[0] == 1


def test_the_command_line_runs_as_a_module(tmp_path):
    files = _reports(tmp_path)
    proc = subprocess.run(
        [sys.executable, "-m", "heat_tpu_torch.telemetry", "show", files["port"][0]],
        capture_output=True, text=True, cwd=ROOT, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout == _run(ref_cli.main, ["show", files["port"][0]])[1]
    assert cli.report is tel.report  # the proxy


def test_the_metrics_sink_writes_json_lines(tmp_path):
    path = str(tmp_path / "metrics.jsonl")
    script = (
        "import numpy as np, heat_tpu_torch as ht\n"
        "ht.use_device('cpu')\n"
        "x = ht.array(np.ones((6, 2), np.float32), split=0)\n"
        "ht.sum(x, axis=0)\n"
        "ht.telemetry._SINK.flush('mid')\n"
    )
    # the eager engines, whose sum records its allreduce at the op
    env = dict(os.environ, HEAT_TPU_METRICS=path, HEAT_TPU_TELEMETRY="1", HEAT_TPU_TEST_DEVICES="3", HEAT_TPU_FUSION="0")
    proc = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True, cwd=ROOT, env=env, timeout=120)
    assert proc.returncode == 0, proc.stderr
    lines = [json.loads(line) for line in open(path)]
    assert [line["event"] for line in lines] == ["mid", "exit"]
    assert lines[-1]["report"]["collective_counts"] == {"allreduce": 1}
    assert "events" not in lines[-1]["report"]


# ---------------------------------------------------------------------------
# the overhead guard (TestOverheadGuard)
# ---------------------------------------------------------------------------
def _rate(a, b, reps=8, trials=5):
    float(_ten_op_chain(ht, a, b).larray)
    best = float("inf")
    for _ in range(trials):
        start = time.perf_counter()
        for _ in range(reps):
            float(_ten_op_chain(ht, a, b).larray)
        best = min(best, time.perf_counter() - start)
    return 10.0 * reps / best


def test_mode_one_keeps_nine_tenths_of_the_dispatch_rate():
    """The reference's guard: enabled rate >= 0.9x the disabled rate, the
    two legs alternated and compared within each round."""
    comm = _mesh(3)
    rng = np.random.default_rng(0)
    a = ht.array(rng.standard_normal((24, 4)).astype(np.float32), split=0, comm=comm)
    b = ht.array(rng.standard_normal((24, 4)).astype(np.float32), split=0, comm=comm)
    ratio = 0.0
    for round_ in range(5):
        tel.set_mode(0)
        off = _rate(a, b)
        tel.set_mode(1)
        on = _rate(a, b)
        ratio = max(ratio, on / off)
        if round_ >= 1 and ratio >= 0.9:
            break
    assert ratio >= 0.9, f"telemetry overhead too high (ratio {ratio:.3f})"


def test_a_scope_on_another_thread_keeps_to_its_thread():
    """The record seams skip the thread-local read while no scope is open
    anywhere; once one is open on another thread, that thread's records
    reach its scope and this thread's reach the global state alone, and a
    thread never touched before records with no setup of its own."""
    import threading

    tel.reset()
    entered, done = threading.Event(), threading.Event()
    seen = {}

    def worker():
        with tel.scope("worker"):
            tel.record_dispatch("binary", fused=True)
            entered.set()
            done.wait(10)
            seen["worker"] = tel.dispatches()

    with tel.enabled():
        assert tel._states() is tel._GLOBAL_ONLY
        thread = threading.Thread(target=worker)
        thread.start()
        assert entered.wait(10)
        tel.record_dispatch("local", fused=False)
        assert len(tel._states()) == 1 and tel.dispatches() == {
            "binary": {"fused": 1, "eager": 0}, "local": {"fused": 0, "eager": 1}}
        done.set()
        thread.join(10)
        fresh = {}
        other = threading.Thread(target=lambda: fresh.update(trigger=tel.current_trigger(), cur=tel._cur()))
        other.start()
        other.join(10)
    assert seen["worker"] == {"binary": {"fused": 1, "eager": 0}}
    assert fresh == {"trigger": "parray", "cur": tel._GLOBAL}
    assert tel.scope_reports()["worker"]["dispatches"] == {"binary": {"fused": 1, "eager": 0}}
    assert not tel._ACTIVE_SCOPE_STATES
    tel.reset()


def test_the_overhead_script_prints_its_rounds_and_seams(capsys):
    from heat_tpu_torch.scripts import telemetry_overhead

    assert telemetry_overhead.main(["--device", "cpu", "--rows", "24", "--cols", "4", "--rounds", "2",
                                    "--reps", "2", "--trials", "1", "--seam-calls", "10"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["shape"] == [24, 4] and len(out["rounds"]) == 2
    assert all(r["off"] > 0 and r["on"] > 0 and r["verbose"] > 0 for r in out["rounds"])
    assert out["best_round_on_off"] == max(r["on_off"] for r in out["rounds"])
    assert set(out["seam_ns"]) == {"record_dispatch", "record_force", "record_async_dispatch",
                                   "record_fused_collective", "blocking_sync", "note_dispatch", "memory_note"}
    assert tel._MODE == 0
