"""SPMD hazard analyzer: AST lint (H001-H005), program audit and the
distribution-flow verifier (S101-S105), over the port's own tree.

Heat's SPMD model — every rank runs the same script, one ``split`` axis
expresses distribution, forcing is asynchronous — turns whole bug classes
structural: a collective under host-divergent control flow deadlocks the
mesh, an implicit blocking sync in a loop destroys the async-forcing
pipeline, a reshard to replicated puts O(n) on every rank. None of these
fail a unit test; they hang or run out of memory at scale. This subsystem
catches them statically, in three passes:

* **Pass 1 — the lint** (:mod:`heat_tpu_torch.analysis.rules`): a custom
  AST rule engine over Python source with SPMD-specific rules H001-H005,
  inline ``# heat-lint: disable=HXXX`` suppressions and a fingerprint
  baseline (:mod:`heat_tpu_torch.analysis.engine`). Pure standard library.
* **Pass 2 — the audit** (:mod:`heat_tpu_torch.analysis.audit`): every
  program the fusion recorder cached is costed from its signature on meta
  tensors (``fusion.program_audit_info``; nothing is built or run) and
  checked for replication blowups, collective-parity divergence across
  program variants, declared bytes-on-wire budgets and static peaks.
* **Pass 3 — the distribution-flow verifier**
  (:mod:`heat_tpu_torch.analysis.dataflow`): an interprocedural abstract
  interpreter over the ``(rank, split, device-set, pending|forced)``
  lattice (:mod:`heat_tpu_torch.analysis.lattice`), driven by a
  cross-module call graph (:mod:`heat_tpu_torch.analysis.callgraph`) with
  loop widening and memoized per-function summaries. Rules S101-S105 catch
  the *semantic* hazards the syntactic lint cannot: reshards under
  ``__binary_op``'s split dominance, blocking syncs and divergence hidden
  behind helper calls, split downgrades, and static bytes-on-wire budget
  violations — with a cost model drift-checked against telemetry's
  observed collective bytes. Pure standard library, like the lint.

``python -m heat_tpu_torch.analysis`` is the CLI (``lint`` / ``audit`` /
``verify`` / ``rules``).
"""

from .dataflow import drift_report, verify_paths, verify_source
from .engine import (
    Finding,
    LintError,
    apply_baseline,
    baseline_entries,
    lint_paths,
    lint_source,
    load_baseline,
    render_findings,
    summarize,
    write_baseline,
)
from .rules import RULES, rule_table

__all__ = [
    "AuditFinding",
    "Finding",
    "LintError",
    "RULES",
    "apply_baseline",
    "audit_programs",
    "baseline_entries",
    "drift_report",
    "lint_paths",
    "lint_source",
    "load_baseline",
    "render_findings",
    "rule_table",
    "summarize",
    "verify_paths",
    "verify_source",
    "warm_bench_cache",
    "write_baseline",
]


def __getattr__(name):
    # the audit half imports the port's runtime lazily: importing
    # `heat_tpu_torch.analysis` (and the lint) touches no device
    if name in ("AuditFinding", "audit_programs", "warm_bench_cache", "render_audit"):
        from . import audit as _audit

        return getattr(_audit, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
