"""heat_tpu_torch.analysis's distribution-flow verifier (the lattice, S101-S105,
loop widening, the cost model and budgets, the CLI, the baseline namespaces,
the never-initializes and never-forces pins, the drift check) against
heat_tpu.analysis's (tests/test_analysis_dataflow.py), case by case. CPU
only.

The verifier is pure: each fixture goes through the reference's verifier as
written and through the port's with ``heat_tpu`` renamed ``heat_tpu_torch``,
and the findings (``(rule, line, severity, suppressed)``) and the cost
ledger (``stats``) are held equal, beside the reference case's own
assertions.

The reference's live cases (a pending chain left pending, the explicit
reshard's telemetry and fault site, the drift check) stop here on
``jax.core.trace_state_clean``. Their port runs on CPU meshes of 3, 5 and 8
shards and is held to what the reference case asserts, citing it.
"""

from __future__ import annotations

import io
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import heat_tpu_torch as ht
from heat_tpu.analysis import dataflow as ref_dataflow
from heat_tpu.analysis import engine as ref_engine
from heat_tpu_torch.analysis import callgraph, dataflow, engine, lattice
from heat_tpu_torch.analysis.__main__ import main
from heat_tpu_torch.analysis.lattice import TOP, UNKNOWN, AbstractArray, Scalar
from heat_tpu_torch.core import fusion, resilience, telemetry
from heat_tpu_torch.core.communication import MeshCommunication

ROOT = Path(__file__).resolve().parents[1]
MESHES = (3, 5, 8)


def ported(src: str) -> str:
    return re.sub(r"\bheat_tpu\b", "heat_tpu_torch", src)


def rules_of(findings, *, active_only: bool = True):
    return [f.rule for f in findings if not (active_only and (f.suppressed or f.baselined))]


def _key(findings):
    return [(f.rule, f.line, f.severity, f.suppressed) for f in findings]


def verify_both(src, mesh_size=8, **kwargs):
    """The port's (findings, stats) on the renamed fixture, held equal to
    the reference's on the fixture as written."""
    mine = dataflow.verify_source(ported(src), "fixture.py", mesh_size=mesh_size, **kwargs)
    theirs = ref_dataflow.verify_source(src, "fixture.py", mesh_size=mesh_size, **kwargs)
    assert _key(mine[0]) == _key(theirs[0])
    assert json.loads(json.dumps(mine[1])) == json.loads(json.dumps(theirs[1]))
    return mine


def verify(src, **kwargs):
    return verify_both(src, **kwargs)[0]


@pytest.fixture(autouse=True)
def on_cpu():
    ht.use_device("cpu")
    yield
    ht.use_device(None)


@pytest.fixture(params=MESHES)
def mesh(request):
    """The default mesh re-made with ``p`` CPU shards for one case."""
    ht.use_comm(MeshCommunication([torch.device("cpu")] * request.param))
    fusion.clear_cache()
    try:
        yield request.param
    finally:
        ht.use_comm(None)
        fusion.clear_cache()


# ---------------------------------------------------------------------------
# the lattice (TestLattice)
# ---------------------------------------------------------------------------
def test_split_join_tops_out_on_disagreement():
    a = AbstractArray(rank=2, split=0, shape=(8, 4), dtype="float32")
    b = AbstractArray(rank=2, split=1, shape=(8, 4), dtype="float32")
    j = lattice.join(a, b)
    assert j.split is TOP and j.shape == (8, 4)
    j2 = lattice.join(a, a.with_(shape=(8, 6)))
    assert j2.split == 0 and j2.shape == (8, None)


def test_join_of_incompatible_kinds_is_unknown():
    assert lattice.join(AbstractArray(rank=1), Scalar()) is UNKNOWN


def test_divergence_joins_sticky():
    j = lattice.join(Scalar(divergent=True, via_call=True), Scalar())
    assert j.divergent and j.via_call


def test_logical_bytes():
    a = AbstractArray(rank=2, split=0, shape=(8, 4), dtype="float64")
    assert lattice.logical_bytes(a) == 8 * 4 * 8
    assert lattice.logical_bytes(a.with_(shape=(8, None))) is None


def test_bcast_shape():
    assert lattice.bcast_shape((8, 1), (4,)) == (8, 4)
    assert lattice.bcast_shape((8, None), (8, 4)) == (8, None)
    assert lattice.bcast_shape(None, (3,)) is None


# ---------------------------------------------------------------------------
# S101-S104 and loop widening: (fixture, expected rules, expected lines)
# ---------------------------------------------------------------------------
FIXTURES = {
    # TestS101ImplicitReshard
    "s101_mixed_split_binary_op": ("""
import heat_tpu as ht
a = ht.ones((512, 64), split=0)
b = ht.ones((512, 64), split=1)
c = a + b
""", ["S101"], None),
    "s101_hazard_only_visible_through_helper_call": ("""
import heat_tpu as ht

def combine(u, v):
    return u * v

a = ht.ones((128, 8), split=0)
b = ht.ones((128, 8), split=1)
c = combine(a, b)
""", ["S101"], [5]),
    "s101_where_with_mixed_splits": ("""
import heat_tpu as ht
cond = ht.ones((64, 64), split=0)
x = ht.ones((64, 64), split=0)
y = ht.ones((64, 64), split=1)
z = ht.where(cond, x, y)
""", ["S101"], None),
    "s101_same_split_and_replicated_operands": ("""
import heat_tpu as ht
a = ht.ones((64, 64), split=0)
b = ht.ones((64, 64), split=0)
r = ht.ones((64, 64))
c = a + b
d = a + r
e = a * 2.0
""", [], None),
    "s101_broadcast_offset_alignment": ("""
import heat_tpu as ht
a = ht.ones((64, 32), split=1)
b = ht.ones((32,), split=0)
c = a + b
""", [], None),
    "s101_explicit_resplit_fix": ("""
import heat_tpu as ht
a = ht.ones((512, 64), split=0)
b = ht.ones((512, 64), split=1)
b = ht.resplit(b, 0)
c = a + b
""", [], None),
    # TestS102LoopSyncThroughCall
    "s102_blocking_helper_called_in_loop": ("""
import heat_tpu as ht

def loss(x):
    return float(x.sum())

a = ht.ones((256, 8), split=0)
for i in range(10):
    l = loss(a)
""", ["S102"], [9]),
    "s102_annotated_param_seeds_the_array": ("""
import heat_tpu as ht
from heat_tpu.core.dndarray import DNDarray

def loss(x: DNDarray):
    return float(x.sum())

def train(x: DNDarray):
    out = 0.0
    while out < 100.0:
        out = out + loss(x)
    return out
""", ["S102"], None),
    "s102_call_outside_loop_and_nonblocking_helper": ("""
import heat_tpu as ht

def loss(x):
    return float(x.sum())

def step(x):
    return x * 2.0

a = ht.ones((256, 8), split=0)
l = loss(a)
for i in range(10):
    a = step(a)
""", [], None),
    "s102_two_levels_deep": ("""
import heat_tpu as ht

def inner(x):
    return float(x.mean())

def outer(x):
    return inner(x) + 1.0

a = ht.ones((64,), split=0)
for i in range(3):
    v = outer(a)
""", ["S102"], [12]),
    "s102_blocking_helper_in_while_test": ("""
import heat_tpu as ht
from heat_tpu.core.dndarray import DNDarray

def loss(x: DNDarray):
    return float(x.sum())

def train(x: DNDarray):
    while loss(x) > 0.1:
        x = x * 0.5
    return x
""", ["S102"], [9]),
    # TestS103SplitDowngrade
    "s103_resplit_to_none_of_sharded_value": ("""
import heat_tpu as ht
a = ht.ones((1024, 16), split=0)
b = ht.resplit(a, None)
""", ["S103"], None),
    "s103_inplace_resplit_default_axis": ("""
import heat_tpu as ht
a = ht.ones((1024, 16), split=1)
a.resplit_()
""", ["S103"], None),
    "s103_axis_change_and_replicated_source": ("""
import heat_tpu as ht
a = ht.ones((1024, 16), split=0)
b = ht.resplit(a, 1)
r = ht.ones((8, 8))
c = ht.resplit(r, None)
""", [], None),
    # TestS104InterproceduralDivergence
    "s104_collective_in_helper_under_divergent_branch": ("""
from heat_tpu.core import multihost

def helper(x, comm):
    comm.allreduce(x)

def bad(x, comm):
    if multihost.process_index() == 0:
        helper(x, comm)
""", ["S104"], [9]),
    "s104_divergence_via_callee_return": ("""
from heat_tpu.core import multihost

def is_owner():
    return multihost.process_index() == 0

def bad(x):
    if is_owner():
        y = x.numpy()
""", ["S104"], [9]),
    "s104_early_exit_divergence_through_helper": ("""
from heat_tpu.core import multihost

def sync_all(x, comm):
    comm.allreduce(x)

def publish(x, comm):
    owner = multihost.io_owner()
    if not owner:
        return
    sync_all(x, comm)
""", ["S104"], None),
    "s104_local_divergence_with_local_collective": ("""
from heat_tpu.core import multihost

def bad(x, comm):
    if multihost.process_index() == 0:
        comm.allreduce(x)
""", [], None),
    "s104_helper_call_on_uniform_path": ("""
def helper(x, comm):
    comm.allreduce(x)

def good(x, comm):
    helper(x, comm)
""", [], None),
    # TestLoopWidening
    "loop_split_churn_widens_to_top": ("""
import heat_tpu as ht
a = ht.ones((64, 64), split=0)
x = ht.ones((64, 64), split=0)
for i in range(4):
    x = ht.resplit(x, 1)
    x = x + 1.0
y = a + x
""", [], None),
    "loop_stable_keeps_concrete_state": ("""
import heat_tpu as ht
a = ht.ones((64, 64), split=0)
x = ht.ones((64, 64), split=1)
for i in range(4):
    x = x * 2.0
y = a + x
""", ["S101"], None),
    "loop_nested_loops_terminate": ("""
import heat_tpu as ht
x = ht.ones((32, 32), split=0)
for i in range(3):
    for j in range(3):
        x = x + 1.0
    while x is not None:
        x = x * 0.5
""", [], None),
    # TestInterproceduralMachinery
    "interproc_qr_tuple_unpack_carries_layouts": ("""
import heat_tpu as ht
a = ht.ones((512, 16), split=0)
b = ht.ones((512, 16), split=1)
q, r = ht.linalg.qr(a)
bad = q + b
""", ["S101"], None),
    "interproc_estimator_instance_attrs_flow_through_methods": ("""
import heat_tpu as ht

class Model:
    def __init__(self):
        self.w = ht.ones((64, 8), split=1)

    def apply(self, x):
        return x * self.w

m = Model()
x = ht.ones((64, 8), split=0)
y = m.apply(x)
""", ["S101"], None),
    "interproc_recursion_is_detected_not_looped": ("""
import heat_tpu as ht

def ping(x, n):
    if n <= 0:
        return x
    return pong(x, n - 1)

def pong(x, n):
    return ping(x * 2.0, n)

a = ht.ones((16,), split=0)
b = ping(a, 3)
""", [], None),
    # TestCostModelAndBudgets: negative split spellings
    "negative_split_same_axis": ("""
import heat_tpu as ht
a = ht.ones((4, 8), split=-1)
b = ht.ones((4, 8), split=1)
c = a + b
""", [], None),
    "negative_split_other_axis": ("""
import heat_tpu as ht
a = ht.ones((4, 8), split=-1)
b = ht.ones((4, 8), split=0)
c = a + b
""", ["S101"], None),
}


@pytest.mark.parametrize("case", sorted(FIXTURES))
def test_semantic_rules_match_the_reference(case):
    """tests/test_analysis_dataflow.py:71-498 and :547-577, :625-643: each
    fixture's findings and cost ledger equal the reference's, and the
    reference case's rules and lines hold."""
    src, expected, lines = FIXTURES[case]
    findings = verify(src)
    assert rules_of(findings) == expected
    if lines is not None:
        assert [f.line for f in findings if not f.suppressed] == lines
    if case == "s101_mixed_split_binary_op":
        assert "131072" in findings[0].message and "resharded implicitly" in findings[0].message
    if case == "s103_resplit_to_none_of_sharded_value":
        assert "65536" in findings[0].message


def test_s101_suppression_same_line_and_line_above():
    findings = verify("""
import heat_tpu as ht
a = ht.ones((64, 64), split=0)
b = ht.ones((64, 64), split=1)
c = a + b  # heat-lint: disable=S101 -- intended implicit reshard
# heat-lint: disable=S101 -- second site, also intended
d = b + a
""")
    assert rules_of(findings) == [] and sum(1 for f in findings if f.suppressed) == 2


def test_s104_local_divergence_is_h001s_job():
    src = """
from heat_tpu.core import multihost

def bad(x, comm):
    if multihost.process_index() == 0:
        comm.allreduce(x)
"""
    lint = engine.lint_source(ported(src), "fixture.py", rules="H001")
    assert _key(lint) == _key(ref_engine.lint_source(src, "fixture.py", rules="H001"))
    assert rules_of(lint) == ["H001"]


def test_axis_change_still_prices_the_reshard():
    _, stats = verify_both("""
import heat_tpu as ht
a = ht.ones((1024, 16), split=0)
b = ht.resplit(a, 1)
""")
    assert stats["regions"]["fixture.py::<module>"]["cost"].get("reshard") == 1024 * 16 * 4


def test_callgraph_sccs_order_callees_first():
    graph = callgraph.build_from_sources({"m.py": "def a():\n    return b()\n\ndef b():\n    return c()\n\ndef c():\n    return 1\n"})
    order = [fn.name for scc in graph.sccs() for fn in scc]
    assert order.index("c") < order.index("b") < order.index("a")


def test_callgraph_resolves_the_ports_reexports():
    """``ht.cluster.KMeans`` resolves to the class in the port's tree, through
    the package re-export."""
    graph = callgraph.build([str(ROOT / "heat_tpu_torch" / "cluster")])
    hit = graph.resolve_dotted("heat_tpu_torch.cluster.KMeans")
    assert hit is not None and hit.name == "KMeans"
    assert hit.module.dotted == "heat_tpu_torch.cluster.kmeans"
    assert callgraph.module_dotted("/x/tests/test_a.py") == "tests.test_a"


# ---------------------------------------------------------------------------
# the cost model and budgets (TestCostModelAndBudgets)
# ---------------------------------------------------------------------------
def test_static_workload_formulas_at_mesh_8():
    """tests/test_analysis_dataflow.py:502."""
    assert dataflow.static_workload_bytes("qr_cholqr2", 8) == {"allreduce": 2048}
    assert dataflow.static_workload_bytes("qr_tsqr", 8) == {"allgather": 4608}
    assert dataflow.static_workload_bytes("solve_triangular", 8) == {"allreduce": 1280}


@pytest.mark.parametrize("p", (1, 3, 5, 8))
def test_drift_workloads_are_the_references_in_the_ports_words(p):
    for name in dataflow.DRIFT_WORKLOADS:
        assert dataflow.workload_source(name, p) == ported(ref_dataflow.workload_source(name, p))
        assert "import heat_tpu_torch as ht" in dataflow.workload_source(name, p)
        assert dataflow.static_workload_bytes(name, p) == ref_dataflow.static_workload_bytes(name, p)


def test_single_device_mesh_prices_zero():
    for name in dataflow.DRIFT_WORKLOADS:
        assert dataflow.static_workload_bytes(name, 1) == {}


def test_budget_violation_reports_s105():
    findings, _ = verify_both("""
import heat_tpu as ht

def gather_all(x):
    return ht.resplit(x, None)  # heat-lint: disable=S103 -- fixture

a = ht.ones((4096, 64), split=0)
b = gather_all(a)
""", budgets={"*gather_all": 1024})
    s105 = [f for f in findings if f.rule == "S105"]
    assert len(s105) == 1 and "gather_all" in s105[0].message and "1024" in s105[0].message


def test_budget_respected_is_clean():
    findings, _ = verify_both("import heat_tpu as ht\na = ht.ones((8, 8), split=0)\nb = a + a\n", budgets={"*": 10 * 1024 * 1024})
    assert [f for f in findings if f.rule == "S105"] == []


def test_negative_split_resplit_is_no_move():
    _, stats = verify_both("import heat_tpu as ht\na = ht.ones((4, 8), split=-2)\nb = ht.resplit(a, 0)\n")
    assert stats["regions"] == {}


def test_branch_arms_take_costlier_path_not_sum():
    _, stats = verify_both("""
import heat_tpu as ht

def f(flag):
    x = ht.ones((1024, 512), split=0)
    if flag:
        y = ht.resplit(x, 1)
    else:
        y = ht.resplit(x, 1)
    return y

f(True)
""")
    assert stats["regions"]["fixture.py::f"]["bytes"] == 1024 * 512 * 4


def test_loop_fixpoint_prices_one_interpretation():
    _, stats = verify_both("""
import heat_tpu as ht

def f():
    x = ht.ones((1024, 512), split=0)
    for i in range(4):
        y = x.sum()
    return x

f()
""")
    assert stats["regions"]["fixture.py::f"]["cost"].get("reduce.psum") == 4


def test_total_bytes_counts_callees_exactly_once():
    _, stats = verify_both("""
import heat_tpu as ht

def gram(x):
    return ht.resplit(x, None)  # heat-lint: disable=S103 -- fixture

a = ht.ones((128, 64), split=0)
g = gram(a)
""")
    assert stats["total_bytes"] == 128 * 64 * 4


def test_drift_entry_incomparable_is_strict_json():
    entry = dataflow._drift_entry({"allreduce": 2048}, {})
    assert entry["ratio"] is None and not entry["within_bound"]
    assert "Infinity" not in json.dumps(entry)


def test_parse_budget_arg():
    assert dataflow.parse_budget_arg("*fit=2MiB") == ("*fit", 2 << 20)
    assert dataflow.parse_budget_arg("x=4096") == ("x", 4096)
    for bad in ("no-equals", "x=2furlongs"):
        with pytest.raises(ValueError):
            dataflow.parse_budget_arg(bad)


def test_rule_table_matches_the_references():
    mine, theirs = dataflow.rule_table(), ref_dataflow.rule_table()
    assert [(r["id"], r["severity"], r["title"]) for r in mine] == [(r["id"], r["severity"], r["title"]) for r in theirs]
    for rec in mine:
        assert "XLA" not in rec["rationale"] + rec["hint"]


# ---------------------------------------------------------------------------
# the CLI (TestVerifyCLI) and the port's tree
# ---------------------------------------------------------------------------
def _fixture(tmp_path, body):
    path = tmp_path / "fix.py"
    path.write_text(body)
    return str(path)


def test_dirty_fixture_exits_1_clean_exits_0(tmp_path):
    dirty = _fixture(tmp_path, "import heat_tpu_torch as ht\na = ht.ones((64, 4), split=0)\nb = ht.ones((64, 4), split=1)\nc = a + b\n")
    buf = io.StringIO()
    assert main(["verify", dirty], out=buf) == 1 and "S101" in buf.getvalue()
    clean = tmp_path / "clean.py"
    clean.write_text("import heat_tpu_torch as ht\na = ht.ones((64, 4), split=0)\nb = a + a\n")
    assert main(["verify", str(clean)], out=io.StringIO()) == 0


def test_json_format_parses_with_stats(tmp_path):
    dirty = _fixture(tmp_path, "import heat_tpu_torch as ht\na = ht.ones((64, 4), split=0)\nb = ht.resplit(a, None)\n")
    buf = io.StringIO()
    assert main(["verify", dirty, "--json"], out=buf) == 1
    doc = json.loads(buf.getvalue())
    assert doc["findings"][0]["rule"] == "S103" and doc["summary"]["active"] == 1
    assert "regions" in doc["stats"] and doc["stats"]["mesh_size"] == 8


def test_budget_flag_and_bad_budget_usage_error(tmp_path):
    dirty = _fixture(tmp_path, "import heat_tpu_torch as ht\na = ht.ones((4096, 64), split=0)\n"
                               "b = ht.resplit(a, None)  # heat-lint: disable=S103 -- fixture\n")
    buf = io.StringIO()
    assert main(["verify", dirty, "--budget", "*=1KiB"], out=buf) == 1 and "S105" in buf.getvalue()
    assert main(["verify", dirty, "--budget", "broken"], out=io.StringIO()) == 2


def test_unknown_rule_is_usage_error():
    assert main(["verify", "--rules", "S999", "tests"], out=io.StringIO()) == 2


def test_rules_verb_lists_both_passes():
    buf = io.StringIO()
    assert main(["rules"], out=buf) == 0
    for rid in ("H001", "H005", "S101", "S102", "S103", "S104", "S105"):
        assert rid in buf.getvalue()


def test_repo_estimators_verify_clean():
    """tests/test_analysis_dataflow.py:749, over the port's estimators."""
    buf = io.StringIO()
    rc = main(["verify", str(ROOT / "heat_tpu_torch" / "cluster"), str(ROOT / "heat_tpu_torch" / "regression")], out=buf)
    assert rc == 0, buf.getvalue()


def test_the_port_verifies_clean():
    """The whole package: 0 unsuppressed findings from ``verify_paths``."""
    findings, stats = dataflow.verify_paths([str(ROOT / "heat_tpu_torch")])
    assert engine.summarize(findings)["active"] == 0, [f.as_dict() for f in findings if not f.suppressed]
    assert stats["modules"] > 100


# ---------------------------------------------------------------------------
# baseline namespaces (TestBaselineNamespaces)
# ---------------------------------------------------------------------------
MIXED = "import heat_tpu as ht\na = ht.ones((8, 8), split=0)\nb = ht.ones((8, 8), split=1)\nc = a + b\n"


def test_verify_write_preserves_h_entries(tmp_path):
    path = str(tmp_path / "base.json")
    h_doc = {"version": 1, "fingerprints": {"feedc0ffee000000": 1},
             "entries": [{"rule": "H002", "path": "x.py", "line": 3, "source": "float(x)", "fingerprint": "feedc0ffee000000"}]}
    Path(path).write_text(json.dumps(h_doc))
    doc = engine.write_baseline(path, verify(MIXED), namespaces=("S",))
    assert sorted(e["rule"] for e in doc["entries"]) == ["H002", "S101"]
    assert "feedc0ffee000000" in doc["fingerprints"]
    doc2 = engine.write_baseline(path, [], namespaces=("S",))
    assert [e["rule"] for e in doc2["entries"]] == ["H002"]


def test_lint_write_preserves_s_entries(tmp_path):
    path = str(tmp_path / "base.json")
    engine.write_baseline(path, verify(MIXED), namespaces=("S",))
    doc = engine.write_baseline(path, engine.lint_source("import time\n", "y.py"), namespaces=("H",))
    assert [e["rule"] for e in doc["entries"]] == ["S101"]


def test_verify_baseline_absorbs_known_findings(tmp_path):
    path = str(tmp_path / "base.json")
    engine.write_baseline(path, verify(MIXED), namespaces=("S",))
    fresh = verify(MIXED)
    engine.apply_baseline(fresh, engine.load_baseline(path))
    assert rules_of(fresh) == [] and all(f.baselined for f in fresh)


def test_fingerprints_survive_line_shifts():
    shifted = "import heat_tpu as ht\n# a comment pushes lines down\n" + MIXED[len("import heat_tpu as ht\n"):]
    f1, f2 = verify(MIXED), verify(shifted)
    assert [x.fingerprint() for x in f1] == [x.fingerprint() for x in f2]
    assert [x.line for x in f1] != [x.line for x in f2]


# ---------------------------------------------------------------------------
# never initializes, never forces (TestNeverInitializesOrForces)
# ---------------------------------------------------------------------------
def test_verify_never_forces_a_pending_chain(mesh):
    """tests/test_analysis_dataflow.py:850."""
    a = ht.array(np.ones((8 * mesh, 4), np.float32), split=0)
    pending = a * 2.0 + 1.0
    dataflow.verify_source("import heat_tpu_torch as ht\nx = ht.ones((8, 8), split=0)\ny = x + x\n", "fixture.py")
    assert fusion.is_deferred(pending)
    np.testing.assert_array_equal(pending.numpy(), np.full((8 * mesh, 4), 3.0, np.float32))


def test_verify_never_initializes_the_backend():
    """tests/test_analysis_dataflow.py:861: a fresh interpreter runs a whole
    verify (budgets included) and builds no mesh, touches no card and loads
    neither jax nor heat_tpu."""
    code = (
        "import sys, torch\n"
        "from heat_tpu_torch.analysis import dataflow\n"
        "src = 'import heat_tpu_torch as ht\\n'\n"
        "src += 'a = ht.ones((64, 8), split=0)\\n'\n"
        "src += 'b = ht.ones((64, 8), split=1)\\n'\n"
        "src += 'c = a + b\\n'\n"
        "f, stats = dataflow.verify_source(src, 'fix.py', budgets={'*': 1})\n"
        "assert any(x.rule == 'S101' for x in f), f\n"
        "from heat_tpu_torch.core import communication\n"
        "assert communication._built_comm() is None and not communication._WORLDS, 'a mesh was built'\n"
        "assert not torch.cuda.is_initialized()\n"
        "assert not {'jax', 'heat_tpu'} & set(sys.modules)\n"
        "print('OK')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, cwd=ROOT, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "OK" in out.stdout


# ---------------------------------------------------------------------------
# the runtime half of S101 (TestRuntimeExplicitReshard)
# ---------------------------------------------------------------------------
def _operands(p):
    rng = np.random.default_rng(3)
    a_np = rng.standard_normal((8 * p, 8)).astype(np.float32)
    b_np = rng.standard_normal(a_np.shape).astype(np.float32)
    return a_np, b_np, ht.array(a_np, split=0), ht.array(b_np, split=1)


def _reshard_delta(before):
    rec = telemetry.collectives().get("reshard", {"count": 0, "bytes": 0})
    return rec["count"] - before.get("count", 0), rec["bytes"] - before.get("bytes", 0)


def test_mixed_split_binary_matches_oracle_and_keeps_dominance(mesh):
    """tests/test_analysis_dataflow.py:903."""
    a_np, b_np, a, b = _operands(mesh)
    c = a + b
    assert c.split == 0
    np.testing.assert_array_equal(c.numpy(), a_np + b_np)
    d = b * a
    assert d.split == 1
    np.testing.assert_array_equal(d.numpy(), b_np * a_np)


def test_reshard_records_telemetry_bytes(mesh):
    """tests/test_analysis_dataflow.py:921."""
    _, b_np, a, b = _operands(mesh)
    with telemetry.enabled():
        before = dict(telemetry.collectives().get("reshard", {}))
        (a - b).larray
        count, nbytes = _reshard_delta(before)
    assert count == 1 and nbytes == b_np.size * 4


def test_reshard_fault_site_fires(mesh):
    """tests/test_analysis_dataflow.py:933."""
    _, _, a, b = _operands(mesh)
    with resilience.inject("collective.reshard", exc=RuntimeError, times=1):
        with pytest.raises(RuntimeError):
            _ = a + b


def test_same_split_and_broadcast_pay_no_reshard(mesh):
    """tests/test_analysis_dataflow.py:941."""
    _, b_np, a, _ = _operands(mesh)
    a2 = ht.array(b_np, split=0)
    row = ht.array(b_np[:1], split=1)
    with telemetry.enabled():
        before = dict(telemetry.collectives().get("reshard", {}))
        (a + a2).larray
        (a + row).larray
        count, _ = _reshard_delta(before)
    assert count == 0


# ---------------------------------------------------------------------------
# the drift check (TestDriftCheck)
# ---------------------------------------------------------------------------
def test_static_within_bound_of_observed_at_live_mesh(mesh):
    """tests/test_analysis_dataflow.py:955: every workload's static bytes
    within DRIFT_FACTOR (2x) of the port's ``telemetry.collectives()``; the
    port's declared schedules record the reference's names and bytes, so
    here the two sides are equal."""
    report = dataflow.drift_report()
    assert report["mesh_size"] == mesh
    assert len(report["workloads"]) >= 2
    for name, rec in report["workloads"].items():
        assert rec["within_bound"], f"{name}: static {rec['static_total']} vs observed {rec['observed_total']} (ratio {rec['ratio']})"
        assert rec["ratio"] <= dataflow.DRIFT_FACTOR
        assert rec["observed_total"] > 0


def test_compare_observed_round_trip(mesh, tmp_path):
    """tests/test_analysis_dataflow.py:970."""
    path = tmp_path / "obs.json"
    path.write_text(json.dumps(dataflow.drift_report()))
    diff = dataflow.compare_observed(json.loads(path.read_text()))
    assert diff["mesh_size"] == mesh
    assert all(rec["within_bound"] for rec in diff["workloads"].values())


def test_cli_observed_diff(mesh, tmp_path):
    """tests/test_analysis_dataflow.py:984: a clean report passes, one cooked
    to drift 10x fails the run."""
    report = dataflow.drift_report()
    path = tmp_path / "obs.json"
    path.write_text(json.dumps(report))
    fixture = _fixture(tmp_path, "import heat_tpu_torch as ht\na = ht.ones((8, 8), split=0)\n")
    buf = io.StringIO()
    assert main(["verify", fixture, "--observed", str(path)], out=buf) == 0, buf.getvalue()
    assert "drift" in buf.getvalue()
    for rec in report["workloads"].values():
        for op in list(rec["observed"]):
            rec["observed"][op] *= 10
        rec.pop("static", None)
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps(report))
    assert main(["verify", fixture, "--observed", str(bad)], out=io.StringIO()) == 1


def test_save_observed_runs_on_the_cpu_mesh_it_asks_for(tmp_path):
    """``verify --save-observed FILE --devices N`` runs the workloads on a
    CPU mesh of N shards (``HEAT_TPU_TEST_DEVICES``), in a fresh process as
    a user runs it."""
    out = tmp_path / "obs.json"
    proc = subprocess.run(
        [sys.executable, "-m", "heat_tpu_torch.analysis", "verify", "--save-observed", str(out), "--devices", "3"],
        capture_output=True, text=True, cwd=ROOT, timeout=300,
        env={k: v for k, v in os.environ.items() if k != "HEAT_TPU_TEST_DEVICES"},
    )
    assert proc.returncode == 0, proc.stderr
    report = json.loads(out.read_text())
    assert report["mesh_size"] == 3
    assert all(rec["within_bound"] for rec in report["workloads"].values())
