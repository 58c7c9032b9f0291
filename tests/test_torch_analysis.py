"""heat_tpu_torch.analysis (the lint H001-H005, the program audit, the CLI)
against heat_tpu.analysis (tests/test_analysis.py), case by case. CPU only.

The lint is pure: each fixture goes through the reference's analyzer as it
is and through the port's with ``heat_tpu`` renamed ``heat_tpu_torch``, and
the findings are held equal, ``(rule, line, severity, suppressed)`` finding
for finding, beside the reference case's own assertions.

The reference's live audit cases stop here on ``jax.core.trace_state_clean``
(its recorder's batching). Their port runs the port's recorder on CPU meshes
of 3, 5 and 8 shards and is held to what the reference case asserts, citing
it. One kept divergence in what a collective count means: the port counts
a program's collective nodes (``fusion._COLLECTIVE_OPS``: a reduction
across the split axis is one ``all-reduce``, a gather one ``all-gather``),
where the reference counts XLA's collective instructions in the partitioned
program, so a family's budget names the port's nodes.
"""

from __future__ import annotations

import io
import json
import os
import re
import warnings
from pathlib import Path

import numpy as np
import pytest
import torch

import heat_tpu_torch as ht
from heat_tpu.analysis import engine as ref_engine
from heat_tpu.analysis import rule_table as ref_rule_table
from heat_tpu_torch import analysis
from heat_tpu_torch.analysis import engine
from heat_tpu_torch.analysis.__main__ import main
from heat_tpu_torch.core import fusion, telemetry
from heat_tpu_torch.core.communication import MeshCommunication

ROOT = Path(__file__).resolve().parents[1]
#: the meshes of the live audit cases
MESHES = (3, 5, 8)


def ported(src: str) -> str:
    """A reference fixture as the port's: its package renamed."""
    return re.sub(r"\bheat_tpu\b", "heat_tpu_torch", src)


def rules_of(findings, *, active_only: bool = True):
    return [f.rule for f in findings if not (active_only and (f.suppressed or f.baselined))]


def _key(findings):
    return [(f.rule, f.line, f.severity, f.suppressed) for f in findings]


def lint(src: str, **kwargs):
    """The port's findings on the renamed fixture, held equal to the
    reference's on the fixture as written."""
    mine = engine.lint_source(ported(src), "fixture.py", **kwargs)
    assert _key(mine) == _key(ref_engine.lint_source(src, "fixture.py", **kwargs))
    return mine


@pytest.fixture(autouse=True)
def on_cpu():
    ht.use_device("cpu")
    yield
    ht.use_device(None)


# ---------------------------------------------------------------------------
# H001-H005, one true positive and one true negative each (TestH00x)
# ---------------------------------------------------------------------------
H001_DIVERGENT = {
    "collective_under_process_index_branch": ("""
from heat_tpu.core import multihost

def save(x, comm):
    if multihost.process_index() == 0:
        comm.allreduce(x)  # only host 0 joins: deadlock
""", ["H001"]),
    "forcing_under_io_owner_early_exit": ("""
from heat_tpu.core import multihost

def publish(x):
    owner = multihost.io_owner()
    if not owner:
        return
    data = x.numpy()  # owner-only force of a possibly collective program
""", ["H001"]),
    "wallclock_and_unseeded_rng_branches": ("""
import random
import time

def step(comm, x):
    if time.time() % 2 > 1:
        comm.bcast(x)
    if random.random() < 0.5:
        comm.allgather(x)
""", ["H001", "H001"]),
    "io_owner_gating_pure_file_io": ("""
import os
from heat_tpu.core import multihost

def save(tmp, path, x, comm):
    gathered = comm.allgather(x)  # every host participates
    if multihost.io_owner():
        os.replace(tmp, path)  # pure file I/O may be owner-only
""", []),
    "seeded_rng_branch": ("""
import numpy as np

def step(comm, x):
    rng = np.random.default_rng(0)  # seeded: identical on every host
    if rng.random() < 0.5:
        comm.allreduce(x)
""", []),
}


@pytest.mark.parametrize("case", sorted(H001_DIVERGENT))
def test_h001_divergence(case):
    """tests/test_analysis.py:34-93."""
    src, expected = H001_DIVERGENT[case]
    findings = lint(src, rules="H001")
    assert rules_of(findings) == expected
    if case == "collective_under_process_index_branch":
        assert "deadlock" in findings[0].message


H002_LOOP_SYNC = {
    "item_and_float_in_loop": ("""
import heat_tpu as ht

def train(a):
    total = 0.0
    for _ in range(100):
        x = ht.mean(a * 2)
        total += float(x)      # blocking sync per iteration
        x.item()               # and another
    return total
""", ["H002", "H002"]),
    "print_of_heat_value_in_while": ("""
import heat_tpu as ht

def run(a):
    err = ht.mean(a)
    while float(err) > 1e-3:
        err = ht.mean(a * 0.5)
        print(err)
""", ["H002", "H002"]),
    "read_after_loop": ("""
import heat_tpu as ht

def train(a):
    for _ in range(100):
        a = a * 2 + 1          # stays recorded: async forcing pipelines it
    return float(ht.mean(a))   # one sync, after the loop
""", []),
    "plain_python_floats_in_loop": ("""
import heat_tpu as ht

def parse(lines):
    rows = []
    for line in lines:
        rows.append([float(v) for v in line.split(",")])  # host-side text
        print("progress")  # constant string
    return rows
""", []),
}


@pytest.mark.parametrize("case", sorted(H002_LOOP_SYNC))
def test_h002_loop_sync(case):
    """tests/test_analysis.py:96-153: the taint roots are the port's
    package imports."""
    src, expected = H002_LOOP_SYNC[case]
    assert rules_of(lint(src, rules="H002")) == expected


def test_h002_taint_roots_are_the_ports_package_not_the_references():
    """The rule tracks values of ``heat_tpu_torch``: in the port's analyzer
    the reference's package is just another import."""
    src = H002_LOOP_SYNC["item_and_float_in_loop"][0]
    assert rules_of(engine.lint_source(src, "fixture.py", rules="H002")) == []
    assert rules_of(engine.lint_source(src.replace("import heat_tpu as ht", "from heat_tpu_torch import mean\nimport heat_tpu_torch as ht"), "f.py", rules="H002")) == ["H002", "H002"]


H003_EXCEPT = {
    "swallowing_seam_failure": ("""
def load(path):
    try:
        fh = open(path)
        return fh.read()
    except Exception:
        return None
""", ["H003"]),
    "bare_except_at_collective_seam": ("""
def reduce(comm, x):
    try:
        return comm.allreduce(x)
    except:
        return x
""", ["H003"]),
    "routed_through_resilience_policy": ("""
from heat_tpu.core import resilience

def record_op(fusion, op, args):
    try:
        return fusion.record(op, args)
    except Exception as exc:
        if not resilience.record_recoverable(exc):
            raise
        return None
""", []),
    "narrowed_type_and_non_seam_try": ("""
def probe(path):
    try:
        fh = open(path)
    except (OSError, ValueError):
        return None   # narrowed: fine
    try:
        return int("3")   # no seam call in the try body
    except Exception:
        return 0
""", []),
}


@pytest.mark.parametrize("case", sorted(H003_EXCEPT))
def test_h003_bare_except(case):
    """tests/test_analysis.py:156-206."""
    src, expected = H003_EXCEPT[case]
    assert rules_of(lint(src, rules="H003")) == expected


@pytest.mark.parametrize("call", ["_distribute(t, 0, comm)", "x.redistribute_()", "communication.reform(devices)"])
def test_h003_sees_the_ports_placement_seams(call):
    """The port's placement calls are seams beside jax's three names
    (``rules._SHARDING_SEAM``): a swallowed failure of one flags."""
    src = f"def place(t, x, comm, devices, communication):\n    try:\n        return {call}\n    except Exception:\n        return None\n"
    assert rules_of(engine.lint_source(src, "fixture.py", rules="H003")) == ["H003"]


H004_KEYS = {
    "lambda_into_comm_apply": ("""
def argmax(comm, x):
    return comm.apply(lambda xs: xs.argmax(), x, in_splits=[0], out_splits=None)
""", ["H004"]),
    "nested_def_into_fusion_record": ("""
from heat_tpu.core import fusion

def op(a, b):
    def body(x, y):
        return x + y
    return fusion.record(body, (a, b))
""", ["H004"]),
    "module_level_kernel_and_cached_factory": ("""
import functools
from heat_tpu.core import fusion

def kern(xs):
    return xs.sum()

@functools.lru_cache(maxsize=64)
def make_kernel(k):
    def kernel(xs):
        return xs[:k]
    return kernel

def run(comm, x, k):
    comm.apply(kern, x, in_splits=[0], out_splits=None)     # stable identity
    kernel = make_kernel(k)                                  # cached factory
    return comm.apply(kernel, x, in_splits=[0], out_splits=None)
""", []),
}


@pytest.mark.parametrize("case", sorted(H004_KEYS))
def test_h004_unstable_keys(case):
    """tests/test_analysis.py:209-243."""
    src, expected = H004_KEYS[case]
    assert rules_of(lint(src, rules="H004")) == expected


H005_SITES = {
    "declared_schedule_without_check": ("""
from heat_tpu.core import telemetry

def tsqr(comm, phys):
    telemetry.record_collective("allgather", comm.axis_name, 128, "float32")
    return run_kernel(phys)
""", ["H005"]),
    "guarded_schedule": ("""
from heat_tpu.core import resilience, telemetry

def tsqr(comm, phys):
    if resilience._ARMED:
        resilience.check("collective.allgather")
    telemetry.record_collective("allgather", comm.axis_name, 128, "float32")
    return run_kernel(phys)
""", []),
}


@pytest.mark.parametrize("case", sorted(H005_SITES))
def test_h005_missing_fault_site(case):
    """tests/test_analysis.py:246-266."""
    src, expected = H005_SITES[case]
    assert rules_of(lint(src, rules="H005")) == expected


# ---------------------------------------------------------------------------
# suppressions and the baseline (TestSuppressionsAndBaseline)
# ---------------------------------------------------------------------------
SUPPRESSED = """
import heat_tpu as ht

def a(arr):
    for _ in range(10):
        float(ht.mean(arr))  # heat-lint: disable=H002 -- convergence check

def b(arr):
    for _ in range(10):
        # heat-lint: disable=H002 -- justified on the line above
        float(ht.mean(arr))

def c(arr):
    for _ in range(10):
        float(ht.mean(arr))
"""


def test_same_line_and_line_above_suppressions():
    findings = lint(SUPPRESSED, rules="H002")
    assert len(findings) == 3
    assert [f.suppressed for f in findings] == [True, True, False]
    assert rules_of(findings) == ["H002"]


def test_disable_all_wildcard():
    src = "def f(c, x):\n    try:\n        return c.allreduce(x)\n    except Exception:  # heat-lint: disable=all\n        return x\n"
    findings = lint(src)
    assert findings and all(f.suppressed for f in findings)


def test_baseline_round_trip(tmp_path):
    findings = lint(SUPPRESSED, rules="H002")
    path = tmp_path / "baseline.json"
    doc = engine.write_baseline(str(path), findings)
    assert len(doc["entries"]) == 1  # only the UNSUPPRESSED finding
    loaded = engine.load_baseline(str(path))
    assert loaded["fingerprints"] == doc["fingerprints"]
    again = engine.lint_source(ported(SUPPRESSED), "fixture.py", rules="H002")
    engine.apply_baseline(again, loaded)
    assert rules_of(again) == [] and engine.summarize(again)["baselined"] == 1
    # the flagged line names no package: its fingerprint is the reference's
    ref_doc = ref_engine.write_baseline(str(tmp_path / "ref.json"), ref_engine.lint_source(SUPPRESSED, "fixture.py", rules="H002"))
    assert doc["fingerprints"] == ref_doc["fingerprints"]


def test_baseline_fails_only_on_new_findings(tmp_path):
    findings = lint(SUPPRESSED, rules="H002")
    path = str(tmp_path / "baseline.json")
    engine.write_baseline(path, findings)
    grown = SUPPRESSED + "\n\ndef d(arr):\n    for _ in range(10):\n        float(ht.std(arr))\n"
    regressed = lint(grown, rules="H002")
    engine.apply_baseline(regressed, engine.load_baseline(path))
    assert rules_of(regressed) == ["H002"]  # only the NEW one


def test_fingerprints_survive_line_shifts():
    findings = lint(SUPPRESSED, rules="H002")
    shifted = lint("# a new header comment\n" + SUPPRESSED, rules="H002")
    assert sorted(f.fingerprint() for f in findings) == sorted(f.fingerprint() for f in shifted)


def test_the_port_has_its_own_baseline_file_and_needs_none():
    """tests/test_analysis.py:334 loads the reference's committed baseline;
    the port lints clean, commits none, and never reads the reference's."""
    from heat_tpu_torch.analysis import __main__ as cli

    assert cli.DEFAULT_BASELINE != "heat-lint-baseline.json"
    assert not (ROOT / cli.DEFAULT_BASELINE).exists()
    doc = engine.load_baseline(str(ROOT / "heat-lint-baseline.json"))
    assert doc["version"] == engine.BASELINE_VERSION


# ---------------------------------------------------------------------------
# the lint CLI (TestLintCLI) and the port's own tree
# ---------------------------------------------------------------------------
def test_lint_repo_paths_exit_zero():
    """tests/test_analysis.py:342: the package lints with 0 unsuppressed
    findings (every suppression carries its reason on the line)."""
    buf = io.StringIO()
    assert main(["lint", str(ROOT / "heat_tpu_torch")], out=buf) == 0, buf.getvalue()
    assert "0 finding(s)" in buf.getvalue()
    findings = analysis.lint_paths([str(ROOT / "heat_tpu_torch")])
    assert engine.summarize(findings)["active"] == 0
    for f in findings:
        lines = (ROOT / f.path).read_text().splitlines() if not os.path.isabs(f.path) else Path(f.path).read_text().splitlines()
        said = " ".join(lines[max(0, f.line - 2):f.line])
        assert re.search(r"heat-lint: disable=\S+ (—|--) \S", said), (f.path, f.line)


def test_lint_json_format_and_failure_exit(tmp_path):
    bad = tmp_path / "bad.py"
    bad.write_text("import heat_tpu_torch as ht\ndef f(a):\n    for _ in range(3):\n        float(ht.mean(a))\n")
    buf = io.StringIO()
    assert main(["lint", str(bad), "--format", "json"], out=buf) == 1
    doc = json.loads(buf.getvalue())
    assert doc["summary"]["active"] == 1 and doc["findings"][0]["rule"] == "H002"


def test_rules_subcommand_lists_all_rules():
    buf = io.StringIO()
    assert main(["rules"], out=buf) == 0
    for rid in ("H001", "H002", "H003", "H004", "H005"):
        assert rid in buf.getvalue()


def test_unknown_rule_id_is_a_usage_error():
    assert main(["lint", "--rules", "H999", "tests"], out=io.StringIO()) == 2


def test_default_paths_are_the_ports_tree():
    from heat_tpu_torch.analysis import __main__ as cli

    assert cli.DEFAULT_PATHS == ["heat_tpu_torch"]


# ---------------------------------------------------------------------------
# the program audit (TestProgramAudit, TestAuditCLI): the reference's cases
# stop on trace_state_clean here; the port's hold what they assert
# ---------------------------------------------------------------------------
@pytest.fixture
def clean_cache():
    fusion.clear_cache()
    telemetry.reset()
    yield
    fusion.clear_cache()


def _mesh(p):
    return MeshCommunication([torch.device("cpu")] * p)


def _linspace(rows, p):
    return np.linspace(0.0, 1.0, rows * p * 64, dtype=np.float32).reshape(rows * p, 64)


def test_clean_bench_workloads_have_zero_findings(clean_cache):
    """tests/test_analysis.py:384: the warmed bench cache audits clean, at
    the tests' mesh."""
    cached = analysis.warm_bench_cache()
    assert cached >= 1
    findings = analysis.audit_programs()
    assert findings == [], [f.as_dict() for f in findings]


@pytest.mark.parametrize("p", MESHES)
def test_deliberately_replicated_program_flags_blowup(clean_cache, p):
    """tests/test_analysis.py:390: a split input resharded to replicated
    mid-chain is an error at ``factor = max(2.0, 0.6·p)``, its ratio at
    least 2, its program a cached key."""
    a = ht.array(_linspace(256, p), split=0, comm=_mesh(p))
    z = ht.resplit(a * 2.0 + 1.0, None) - 3.0
    float(z.sum())
    findings = analysis.audit_programs(factor=max(2.0, p * 0.6), min_bytes=1 << 16)
    assert "replication" in [f.kind for f in findings], [f.as_dict() for f in findings]
    blow = next(f for f in findings if f.kind == "replication")
    assert blow.severity == "error" and blow.detail["ratio"] >= 2.0
    assert blow.detail["mesh_size"] == p
    assert blow.program in fusion.cache_stats()["program_keys"]


@pytest.mark.parametrize("p", MESHES)
def test_healthy_split_chain_stays_clean(clean_cache, p):
    """tests/test_analysis.py:411."""
    a = ht.array(_linspace(256, p), split=0, comm=_mesh(p))
    y = ht.sqrt(ht.abs(a * 3.0 - 1.0))
    float(y.mean())
    assert [f.kind for f in analysis.audit_programs(min_bytes=1 << 16)] == []
    (rec,) = fusion.program_audit_info().values()
    assert rec["mesh_size"] == p and rec["split_leaves"] >= 1
    ratio = rec["cost"]["bytes_accessed"] / (rec["replicated_cost"]["bytes_accessed"] / p)
    assert 0.9 <= ratio <= 1.1, ratio


@pytest.mark.parametrize("p", MESHES)
def test_budget_violation_reports(clean_cache, p):
    """tests/test_analysis.py:424: a ``*sum*`` budget of 0 all-reduces flags
    the sum's program; one admitting it is clean."""
    a = ht.array(np.ones((64 * p, 8), np.float32), split=0, comm=_mesh(p))
    float(ht.sum(a))  # one all-reduce node inside the program
    findings = analysis.audit_programs(budgets={"*sum*": {"collectives": {"all-reduce": 0}}})
    assert any(f.kind == "budget" for f in findings), [f.as_dict() for f in findings]
    assert fusion.cache_stats()["program_keys"]
    ok = {"*sum*": {"collectives": {"all-reduce": 1, "all-gather": 2}}}
    assert [f.kind for f in analysis.audit_programs(budgets=ok)] == []


@pytest.mark.parametrize("p", MESHES)
def test_wire_and_peak_budgets(clean_cache, p):
    """The budget file's other keys: ``wire_bytes`` over each collective
    node's result on one rank, ``peak_bytes`` and ``--peak-budget`` over the
    static peak (the reference's ``wire_bytes`` and ``peak_bytes`` entries,
    heat_tpu/analysis/audit.py:286-325)."""
    a = ht.array(_linspace(64, p), split=0, comm=_mesh(p))
    z = ht.resplit(a + 1.0, None)
    float(z.sum())
    (rec,) = fusion.program_audit_info().values()
    assert rec["cost"]["collectives"] == {"all-gather": 1}
    whole = 64 * p * 64 * 4
    assert rec["cost"]["collective_bytes"] == {"all-gather": whole}
    def kinds(**kwargs):  # the chain is also a replication blowup: left out here
        return [f.kind for f in analysis.audit_programs(**kwargs) if f.kind != "replication"]

    assert kinds(budgets={"*gather*": {"wire_bytes": whole - 1}}) == ["budget"]
    assert kinds(budgets={"*gather*": {"wire_bytes": whole}}) == []
    peak = rec["cost"]["memory"]["peak_bytes"]
    assert kinds(peak_budget=peak - 1) == ["memory"]
    assert kinds(peak_budget=peak) == []
    assert kinds(budgets={"*gather*": {"peak_bytes": peak - 1}}) == ["budget"]


def test_audit_never_forces_a_pending_chain(clean_cache):
    """tests/test_analysis.py:443: and builds nothing."""
    a = ht.array(np.ones((8 * 3, 4), np.float32), split=0, comm=_mesh(3))
    float((a * 5.0).sum())
    pending = a * 2.0 + 1.0
    compiles = fusion.cache_stats()["compiles"]
    analysis.audit_programs()
    assert fusion.is_deferred(pending)
    assert fusion.cache_stats()["compiles"] == compiles
    np.testing.assert_array_equal(pending.numpy(), np.full((24, 4), 3.0, np.float32))


@pytest.mark.parametrize("p", MESHES)
def test_program_audit_info_shape(clean_cache, p):
    """tests/test_analysis.py:449: every record has the reference's keys,
    and a split program's replicated cost is at least its sharded one."""
    a = ht.array(_linspace(192, p), split=0, comm=_mesh(p))
    float(ht.sqrt(ht.abs(a * 1.5 + 2.0)).sum())
    float(ht.mean(a)) + float(ht.std(a))
    info = fusion.program_audit_info()
    assert len(info) >= 1
    for key, rec in info.items():
        assert {"family", "dispatches", "mesh_size", "split_leaves", "leaves", "cost", "replicated_cost"} <= set(rec)
        assert isinstance(rec["leaves"], list)
        for leaf in rec["leaves"]:
            assert {"shape", "dtype", "nbytes", "replicated"} <= set(leaf)
        if rec["cost"].get("bytes_accessed") is not None and rec["split_leaves"]:
            assert rec["replicated_cost"]["bytes_accessed"] >= rec["cost"]["bytes_accessed"]
            assert rec["cost"]["collectives"], rec["family"]
    assert set(info) == set(fusion.cache_stats()["program_keys"])


def test_split_sum_counts_its_collective_under_program_hlos_names(clean_cache):
    """``cost["collectives"]`` counts a program's collective nodes under the
    names ``telemetry.hlo_collective_counts`` reads in ``program_hlo``."""
    a = ht.array(np.ones((64 * 3, 8), np.float32), split=0, comm=_mesh(3))
    s = ht.sum(a * 2.0)
    counts = telemetry.hlo_collective_counts(fusion.program_hlo(s))
    float(s)
    (rec,) = fusion.program_audit_info().values()
    assert rec["cost"]["collectives"] == counts == {"all-reduce": 1}


@pytest.mark.parametrize("p", (3, 5))
def test_c22_repeated_collective_nodes_each_count(clean_cache, p):
    """C22: FX names an op's second and later nodes ``<name>_1``, ... in a
    program's text; ``telemetry.hlo_collective_counts`` counted only the
    first of each kind there (one all-gather and one scatter for three
    resplits). It counts each node, as the audit's cost does."""
    x = ht.array(np.ones((40, 16), np.float32), split=0, comm=_mesh(p))
    z = x * 1.0
    for split in (1, 0, 1):
        z = ht.resplit(z, split)
    s = ht.sum(z) + ht.sum(z * 2.0)
    want = {"all-gather": 3, "scatter": 3, "all-reduce": 2}
    assert telemetry.hlo_collective_counts(fusion.program_hlo(s)) == want
    float(s)
    (rec,) = fusion.program_audit_info().values()
    assert rec["cost"]["collectives"] == want
    # a reshard between axes gathers the whole array onto the first device
    # and cuts it again: the audit's replication check sees that
    assert [f.kind for f in analysis.audit_programs(min_bytes=1 << 10)] == ["replication"]


def test_costs_are_memoized_and_cleared(clean_cache):
    a = ht.array(np.ones((64 * 3, 8), np.float32), split=0, comm=_mesh(3))
    float(ht.sum(a))
    first = fusion.program_audit_info()
    key = next(iter(first))
    assert key in fusion._COSTS and key in fusion._REPL_COSTS
    assert fusion.program_audit_info() == first
    assert fusion.program_audit_info(refresh=True) == first
    fusion.clear_cache()
    assert not fusion._COSTS and not fusion._REPL_COSTS and fusion.program_audit_info() == {}


def test_audit_cli_over_warm_cache(clean_cache):
    """tests/test_analysis.py:469."""
    analysis.warm_bench_cache(rounds=1)
    buf = io.StringIO()
    assert main(["audit"], out=buf) == 0, buf.getvalue()
    assert "0 finding(s)" in buf.getvalue()


def test_audit_cli_says_when_nothing_is_cached(clean_cache):
    buf = io.StringIO()
    assert main(["audit"], out=buf) == 0
    assert "0 cached program(s)" in buf.getvalue() and "nothing was audited" in buf.getvalue()


@pytest.mark.parametrize("p", MESHES)
def test_audit_cli_json_with_budget_file(clean_cache, tmp_path, p):
    """tests/test_analysis.py:482."""
    a = ht.array(np.ones((64 * p, 8), np.float32), split=0, comm=_mesh(p))
    float(ht.sum(a))
    budget = tmp_path / "budget.json"
    budget.write_text(json.dumps({"*sum*": {"collectives": {}}}))
    buf = io.StringIO()
    rc = main(["audit", "--budget", str(budget), "--format", "json"], out=buf)
    doc = json.loads(buf.getvalue())
    assert doc["audited"] >= 1
    assert rc == 1 and any(f["kind"] == "budget" for f in doc["findings"])


def test_audit_cli_peak_budget_goes_through_the_memory_ledgers_parser(clean_cache):
    a = ht.array(np.ones((64 * 3, 8), np.float32), split=0, comm=_mesh(3))
    float(ht.sum(a * 2.0))
    assert main(["audit", "--peak-budget", "1KiB"], out=io.StringIO()) == 1
    assert main(["audit", "--peak-budget", "1GiB"], out=io.StringIO()) == 0
    assert main(["audit", "--peak-budget", "0.5"], out=io.StringIO()) == 2  # a fraction is no byte count
    assert main(["audit", "--peak-budget", "lots"], out=io.StringIO()) == 2


# ---------------------------------------------------------------------------
# cross-host collective parity of exported traces (TestCrossHostParity)
# ---------------------------------------------------------------------------
def _host_trace(pid, drop_last=False):
    evs = [{"ph": "M", "name": "process_name", "pid": pid, "tid": 0, "args": {"name": f"host {pid}"}}]
    colls = [("reduce.psum", 1), ("fused:reshard", 2)]
    if drop_last:
        colls = colls[:1]
    for name, cid in colls:
        evs.append({"ph": "i", "s": "t", "cat": "collective", "name": name, "pid": pid, "tid": 0, "ts": 1.0,
                    "args": {"cid": cid}})
    return {"traceEvents": evs, "displayTimeUnit": "ms"}


def test_equal_hosts_pass_and_merge_stays_valid(tmp_path):
    paths = []
    for i in range(3):
        path = tmp_path / f"h{i}.json"
        path.write_text(json.dumps(_host_trace(0)))
        paths.append(str(path))
    merged = telemetry.merge_traces(paths, check_parity=True)
    assert "collective_parity" not in merged["otherData"]
    assert telemetry.validate_trace(merged, cross_host=True) == []


def test_missing_collective_on_one_host_is_reported(tmp_path):
    pa, pb = tmp_path / "a.json", tmp_path / "b.json"
    pa.write_text(json.dumps(_host_trace(0)))
    pb.write_text(json.dumps(_host_trace(0, drop_last=True)))
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        merged = telemetry.merge_traces([str(pa), str(pb)], check_parity=True)
    problems = merged["otherData"].get("collective_parity")
    assert problems and "cid 2" in problems[0]
    assert any("H001" in str(w.message) for w in caught)
    assert telemetry.validate_trace(merged, cross_host=True)
    assert telemetry.validate_trace(merged) == []


@pytest.mark.parametrize("p", MESHES)
def test_real_exported_trace_passes_parity(tmp_path, p):
    """tests/test_analysis.py:561: a trace the port exported from a split
    mean passes the cross-host check."""
    prev = telemetry.set_mode("verbose")
    try:
        telemetry.reset()
        a = ht.array(np.ones((8 * p, 3), np.float32), split=0, comm=_mesh(p))
        float(ht.mean(a))
        path = str(tmp_path / "trace.json")
        telemetry.export_trace(path)
        assert telemetry.validate_trace(path, cross_host=True) == []
    finally:
        telemetry.set_mode(prev)
        telemetry.reset()


def test_cli_cross_host_flag(tmp_path):
    import importlib

    cli = importlib.import_module("heat_tpu_torch.telemetry")
    pa, pb = tmp_path / "a.json", tmp_path / "b.json"
    pa.write_text(json.dumps(_host_trace(0)))
    pb.write_text(json.dumps(_host_trace(0, drop_last=True)))
    merged_path = str(tmp_path / "m.json")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        telemetry.merge_traces([str(pa), str(pb)], path=merged_path, check_parity=True)
    assert cli.main(["validate-trace", merged_path], out=io.StringIO()) == 0
    buf = io.StringIO()
    assert cli.main(["validate-trace", "--cross-host", merged_path], out=buf) == 1
    assert "diverged" in buf.getvalue()


# ---------------------------------------------------------------------------
# engine edges (TestEngineEdges)
# ---------------------------------------------------------------------------
def test_syntax_error_reports_h000():
    findings = lint("def broken(:\n")
    assert [f.rule for f in findings] == ["H000"] and findings[0].severity == "error"


def test_rule_table_is_complete():
    table = analysis.rule_table()
    assert [r["id"] for r in table] == [r["id"] for r in ref_rule_table()] == ["H001", "H002", "H003", "H004", "H005"]
    for rec in table:
        assert rec["rationale"] and rec["hint"]
        assert "XLA" not in rec["rationale"] + rec["hint"]


def test_render_findings_mentions_suppressed_count():
    src = "import heat_tpu as ht\nfor _ in range(2):\n    float(ht.ones(2).sum())  # heat-lint: disable=H002 -- fixture\n"
    assert "1 suppressed" in engine.render_findings(lint(src, rules="H002"))
