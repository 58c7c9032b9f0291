"""Pass 2 — the program auditor.

The AST lint (:mod:`heat_tpu_torch.analysis.rules`) catches hazards visible
in the *source*; this pass audits the *programs*: every program in the
fusion recorder's cache is costed from its recorded signature by
``fusion.program_audit_info`` (the GraphModule run on meta tensors, the
machinery ``fusion.program_costs`` memoizes: no live operand, nothing
forced, built or executed) and checked for the hazards only the program
can show:

* **Replication blowups** — a program with a split input whose per-rank
  bytes accessed is ≥ k× the sharded lower bound. The lower bound is
  computed, not guessed: the SAME signature is costed a second time with
  every leaf whole on every rank, and that cost divided by the mesh size is
  what perfect sharding would pay per rank — so chain depth (intermediate
  reads and writes inflate both costs equally) cancels out. A reshard to
  replicated partway through a chain puts the whole array on every rank
  from there on and shows up as a ratio growing with p; a healthy sharded
  chain sits at ≈ 1.
* **Collective parity across variants** — program variants of one op family
  with the same leaf-layout pattern and mesh must hold the same per-type
  collective counts; a variant that grew or lost a collective is the
  program-side signature of host divergence (the same hazard H001 flags in
  source, visible here even when the divergent branch lives in code the
  lint cannot see).
* **Bytes-on-wire budgets** — declared per-family budgets (collective
  counts and/or total on-wire bytes, each collective node's result on one
  rank, ``cost["collective_bytes"]``) are diffed via
  ``telemetry.collective_budget_excess``.
* **Static memory peaks** — each program's static peak from its node
  shapes (leaves + outputs + the intermediates live at the worst point of
  the op order, ``cost["memory"]``) checked against a global
  ``--peak-budget`` ceiling and/or per-family ``"peak_bytes"`` budget
  entries: the static form of the runtime ``HEAT_TPU_MEMORY_BUDGET``
  admission gate (``core/memledger.py``), catching the program that would
  be refused at dispatch before anything runs it.

The audit sees what the recorder cached. On a card, a chain whose operands
hold fewer than ``fusion._EAGER_BELOW_BYTES`` runs eagerly and records no
program, so there it reads the programs that real-sized work built.

This module imports the port's runtime lazily — ``heat_tpu_torch.analysis``
stays importable (and the lint usable) without touching a device.
"""

from __future__ import annotations

import fnmatch
from dataclasses import dataclass
from typing import Dict, List, Optional

__all__ = [
    "AuditFinding",
    "audit_programs",
    "render_audit",
    "warm_bench_cache",
]

#: flag when per-rank bytes-accessed is at least this multiple of the
#: sharded lower bound (replicated-cost / mesh size). A healthy sharded
#: chain sits near 1.0; full replication grows with the mesh size.
DEFAULT_FACTOR = 2.0
#: ignore programs below this replicated-cost size: tiny programs are
#: constant-dominated and their ratios are noise, not layout decisions.
#: 256 KiB sits above scalar/constant noise while keeping the bench-warmed
#: programs INSIDE the audit — a floor above them would make the
#: replication check vacuous
DEFAULT_MIN_BYTES = 1 << 18


@dataclass
class AuditFinding:
    """One program-level diagnostic, ``Finding``-shaped for the CLI."""

    kind: str  # "replication" | "collective_parity" | "budget"
    severity: str
    program: str  # the program key (fusion.cache_stats()["program_keys"])
    family: str
    message: str
    detail: dict

    @property
    def location(self) -> str:
        return f"<program:{self.program}>"

    def as_dict(self) -> dict:
        return {
            "kind": self.kind,
            "severity": self.severity,
            "program": self.program,
            "family": self.family,
            "message": self.message,
            "detail": self.detail,
        }


def _program_wire_bytes(cost: dict) -> Optional[int]:
    """Total bytes on the wire of a program: each collective node's result
    on one rank (``fusion._estimate_cost``'s ``collective_bytes``)."""
    per_kind = cost.get("collective_bytes")
    if per_kind is None:
        return None
    return sum(per_kind.values())


# ----------------------------------------------------------------------
# the audit
# ----------------------------------------------------------------------
def _layout_key(rec: dict) -> tuple:
    """The leaf-layout pattern of one program: per-leaf (ndim, replicated)
    plus the mesh size — shapes deliberately excluded, so size-variants of
    one family land in the same parity group."""
    return (
        rec["mesh_size"],
        tuple((len(leaf["shape"]), leaf["replicated"]) for leaf in rec["leaves"]),
    )


def audit_programs(
    factor: float = DEFAULT_FACTOR,
    min_bytes: int = DEFAULT_MIN_BYTES,
    budgets: Optional[Dict[str, dict]] = None,
    top: Optional[int] = None,
    peak_budget: Optional[int] = None,
) -> List[AuditFinding]:
    """Audit every cached sharded program (see the module docstring for the
    three checks). ``budgets`` maps an op-family glob to
    ``{"collectives": {type: max_count}, "wire_bytes": max_total,
    "peak_bytes": max_static_peak}`` (every key optional); ``peak_budget``
    applies one static-memory-peak ceiling (from the node shapes, per
    rank) to EVERY program — the static form of the runtime admission gate
    (``HEAT_TPU_MEMORY_BUDGET``), catching a program that would blow the
    budget before anything dispatches it. Returns findings ranked
    errors-first. Static only: nothing is built or executed, no live array
    is touched."""
    from heat_tpu_torch.core import fusion, telemetry

    info = fusion.program_audit_info(top=top)
    findings: List[AuditFinding] = []

    # static memory peaks vs the global ceiling
    if peak_budget is not None:
        for key, rec in info.items():
            mem = rec["cost"].get("memory") or {}
            peak = mem.get("peak_bytes")
            if peak is None or peak <= peak_budget:
                continue
            findings.append(
                AuditFinding(
                    kind="memory",
                    severity="error",
                    program=key,
                    family=rec["family"],
                    message=(
                        f"static memory peak {int(peak)} B exceeds the "
                        f"{int(peak_budget)} B budget (arguments "
                        f"{mem.get('argument_bytes')} + outputs "
                        f"{mem.get('output_bytes')} + temps "
                        f"{mem.get('temp_bytes')} per rank) — this program "
                        "would be refused (or OOM) at dispatch under "
                        "HEAT_TPU_MEMORY_BUDGET of the same size"
                    ),
                    detail={
                        "peak_bytes": int(peak),
                        "budget": int(peak_budget),
                        "memory": dict(mem),
                        "dispatches": rec["dispatches"],
                    },
                )
            )

    # replication blowups
    for key, rec in info.items():
        if not rec["split_leaves"] or rec["mesh_size"] <= 1:
            continue  # nothing is split: there is no sharding to drop
        cost, rcost = rec["cost"], rec["replicated_cost"]
        accessed = cost.get("bytes_accessed")
        repl_accessed = rcost.get("bytes_accessed")
        if accessed is None or not repl_accessed or repl_accessed < min_bytes:
            continue
        p = rec["mesh_size"]
        bound = repl_accessed / p
        ratio = accessed / bound if bound else 0.0
        if ratio >= factor:
            findings.append(
                AuditFinding(
                    kind="replication",
                    severity="error",
                    program=key,
                    family=rec["family"],
                    message=(
                        f"replication blowup: per-rank bytes-accessed "
                        f"{int(accessed)} is {ratio:.1f}x the sharded lower bound "
                        f"{int(bound)} (mesh {p}) — a split input is being "
                        "materialized on every rank; a reshard to replicated "
                        "snuck into the chain"
                    ),
                    detail={
                        "bytes_accessed": accessed,
                        "sharded_lower_bound": bound,
                        "ratio": round(ratio, 2),
                        "mesh_size": p,
                        "dispatches": rec["dispatches"],
                    },
                )
            )

    # collective parity across variants of one family
    groups: Dict[tuple, list] = {}
    for key, rec in info.items():
        if "error" in rec["cost"]:
            continue  # no cost to compare
        groups.setdefault((rec["family"],) + _layout_key(rec), []).append((key, rec))
    for (family, mesh_size, _layout), members in groups.items():
        if len(members) < 2:
            continue
        by_counts: Dict[tuple, list] = {}
        for key, rec in members:
            counts = tuple(sorted(rec["cost"].get("collectives", {}).items()))
            by_counts.setdefault(counts, []).append(key)
        if len(by_counts) > 1:
            variants = {
                ",".join(keys): dict(counts) for counts, keys in by_counts.items()
            }
            findings.append(
                AuditFinding(
                    kind="collective_parity",
                    severity="error",
                    program=next(iter(by_counts.values()))[0],
                    family=family,
                    message=(
                        f"collective-count mismatch across {len(members)} variants of "
                        f"one program family at mesh {mesh_size}: {variants} — the "
                        "program-side signature of host divergence (one variant "
                        "schedules collectives its siblings never join)"
                    ),
                    detail={"mesh_size": mesh_size, "variants": variants},
                )
            )

    # declared budgets
    for pattern, budget in (budgets or {}).items():
        for key, rec in info.items():
            if not fnmatch.fnmatch(rec["family"], pattern):
                continue
            counts = rec["cost"].get("collectives", {})
            allowed = budget.get("collectives")
            if allowed is not None:
                excess = telemetry.collective_budget_excess(counts, allowed)
                if excess:
                    findings.append(
                        AuditFinding(
                            kind="budget",
                            severity="error",
                            program=key,
                            family=rec["family"],
                            message=(
                                f"collective budget exceeded for family pattern "
                                f"{pattern!r}: {excess}"
                            ),
                            detail={"counts": counts, "budget": allowed, "excess": excess},
                        )
                    )
            max_peak = budget.get("peak_bytes")
            if max_peak is not None:
                peak = (rec["cost"].get("memory") or {}).get("peak_bytes")
                if peak is not None and peak > max_peak:
                    findings.append(
                        AuditFinding(
                            kind="budget",
                            severity="error",
                            program=key,
                            family=rec["family"],
                            message=(
                                f"static memory peak budget exceeded for family "
                                f"pattern {pattern!r}: {int(peak)} > {int(max_peak)} "
                                "bytes per rank (static peak from the node shapes)"
                            ),
                            detail={"peak_bytes": int(peak), "budget": int(max_peak)},
                        )
                    )
            max_wire = budget.get("wire_bytes")
            if max_wire is not None:
                wire = _program_wire_bytes(rec["cost"])
                if wire is not None and wire > max_wire:
                    findings.append(
                        AuditFinding(
                            kind="budget",
                            severity="error",
                            program=key,
                            family=rec["family"],
                            message=(
                                f"bytes-on-wire budget exceeded for family pattern "
                                f"{pattern!r}: {wire} > {int(max_wire)} estimated from "
                                "the program's collective nodes' results"
                            ),
                            detail={"wire_bytes": wire, "budget": max_wire},
                        )
                    )

    findings.sort(key=lambda f: (f.severity != "error", f.kind, f.family))
    return findings


def render_audit(findings: List[AuditFinding], audited: int) -> str:
    out = []
    for f in findings:
        out.append(f"{f.location}: {f.kind} {f.severity}: [{f.family}] {f.message}")
    out.append(
        f"heat-audit: {len(findings)} finding(s) over {audited} cached program(s)"
    )
    if not audited:
        out.append(
            "heat-audit: no program is cached, so nothing was audited (on a card, chains whose operands "
            "hold fewer than fusion._EAGER_BELOW_BYTES run eagerly and record none)"
        )
    return "\n".join(out)


# ----------------------------------------------------------------------
# cache warming: the bench-shaped workloads
# ----------------------------------------------------------------------
def warm_bench_cache(rounds: int = 2) -> int:
    """Populate the program cache with the reference bench workloads'
    program shapes (eager chain, moments, reduction chain), so a standalone
    ``python -m heat_tpu_torch.analysis audit --warm bench --devices N``
    audits a representative cache. Returns the number of cached programs
    afterwards. Deterministic data; a handful of dispatches. The sizes are
    the reference's: on a card these operands stay under
    ``fusion._EAGER_BELOW_BYTES``, run eagerly and leave nothing cached."""
    import numpy as np

    import heat_tpu_torch as ht
    from heat_tpu_torch.core import fusion

    p = ht.get_comm().size
    # sized so every warmed program's replicated bytes-accessed clears
    # DEFAULT_MIN_BYTES at any test mesh — the audit must actually look at
    # these programs, not skip them under the small-program floor
    rows = 192 * max(p, 4)
    base = (
        np.linspace(-2.0, 3.0, rows * 64, dtype=np.float32).reshape(rows, 64) + 0.25
    )
    a = ht.array(base, split=0)
    for _ in range(max(1, rounds)):
        # the eager-chain bench's elementwise body
        x = ht.sqrt(ht.abs(a * 1.5 + 2.0)) - 0.5
        # heat-lint: disable=H002 — warming MUST force each round (that is the point)
        float(x.sum())
        # the moments bench: two reductions recorded, one sync
        m = ht.mean(a)
        s = ht.std(a)
        # heat-lint: disable=H002 — warming MUST force each round (that is the point)
        float(m) + float(s)
        # the reduction-chain bench: reduce feeding an elementwise consumer
        y = (a - ht.mean(a)) / (ht.std(a) + 1e-6)
        # heat-lint: disable=H002 — warming MUST force each round (that is the point)
        float(y.max())
    return len(fusion.cache_stats()["program_keys"])
