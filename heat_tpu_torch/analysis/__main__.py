"""``python -m heat_tpu_torch.analysis`` — the SPMD hazard analyzer CLI.

.. code-block:: console

    $ python -m heat_tpu_torch.analysis lint heat_tpu_torch
    $ python -m heat_tpu_torch.analysis lint --write-baseline FILE heat_tpu_torch
    $ python -m heat_tpu_torch.analysis audit --warm bench --devices 8
    $ python -m heat_tpu_torch.analysis verify heat_tpu_torch
    $ python -m heat_tpu_torch.analysis verify --budget '*KMeans.fit=64MiB' --json
    $ python -m heat_tpu_torch.analysis verify --save-observed obs.json --devices 8
    $ python -m heat_tpu_torch.analysis verify --observed obs.json
    $ python -m heat_tpu_torch.analysis rules

``lint`` and ``verify`` are pure static analysis (they touch no device and
run anywhere — ``verify`` is the interprocedural split/sharding abstract
interpreter, rules S101-S105, with ``--budget GLOB=BYTES`` static cost
ceilings); ``audit`` costs the recorder's cached programs, so it brings up
the mesh, on the card unless ``--devices N`` asks for a CPU mesh of N
shards (``HEAT_TPU_TEST_DEVICES=N``, ``ht.use_device("cpu")``) as the tests
run. ``verify --save-observed`` is the one verify mode that computes: it
runs the drift workloads live so a later fully-static ``--observed`` diff
can pin the cost model against telemetry's bytes.

Exit codes: 0 = clean (or only suppressed/baselined findings), 1 = active
findings, 2 = usage/environment error.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import List, Optional

#: the port's own baseline file (none is committed: the port lints and
#: verifies clean); the reference's ``heat-lint-baseline.json`` is its own
DEFAULT_BASELINE = "heat-tpu-torch-lint-baseline.json"
DEFAULT_PATHS = ["heat_tpu_torch"]


def _cmd_lint(args, out) -> int:
    from . import engine

    paths = args.paths or DEFAULT_PATHS
    try:
        findings = engine.lint_paths(paths, rules=args.rules)
    except engine.LintError as exc:
        print(f"heat-lint: {exc}", file=out)
        return 2
    if args.write_baseline is not None:
        path = args.write_baseline or DEFAULT_BASELINE
        # namespace-scoped: the lint owns H-rule entries; the dataflow
        # verifier's S-rule entries in the shared file survive untouched
        doc = engine.write_baseline(path, findings, namespaces=("H",))
        print(
            f"heat-lint: baseline with {len(doc['entries'])} finding(s) written to {path}",
            file=out,
        )
        return 0
    if args.baseline is not None:
        try:
            baseline = engine.load_baseline(args.baseline or DEFAULT_BASELINE)
        except engine.LintError as exc:
            print(f"heat-lint: {exc}", file=out)
            return 2
        engine.apply_baseline(findings, baseline)
    if args.format == "json":
        print(
            json.dumps(
                {
                    "findings": [f.as_dict() for f in findings],
                    "summary": engine.summarize(findings),
                },
                indent=1,
            ),
            file=out,
        )
    else:
        print(engine.render_findings(findings, show_suppressed=args.show_suppressed), file=out)
    return 1 if engine.summarize(findings)["active"] else 0


def _force_mesh(devices: int) -> None:
    """Run on a CPU mesh of ``devices`` shards, as the tests do
    (``HEAT_TPU_TEST_DEVICES``), before the default mesh is built."""
    os.environ["HEAT_TPU_TEST_DEVICES"] = str(devices)
    import heat_tpu_torch as ht

    ht.use_device("cpu")


def _cmd_audit(args, out) -> int:
    if args.devices:
        _force_mesh(args.devices)
    from . import audit as audit_mod

    budgets = None
    if args.budget:
        try:
            with open(args.budget) as fh:
                budgets = json.load(fh)
        except (OSError, json.JSONDecodeError) as exc:
            print(f"heat-audit: cannot read budget file {args.budget!r}: {exc}", file=out)
            return 2
    if args.warm == "bench":
        t0 = time.perf_counter()
        cached = audit_mod.warm_bench_cache()
        print(
            f"heat-audit: warmed {cached} program(s) with the bench workloads "
            f"in {time.perf_counter() - t0:.1f}s",
            file=out,
        )
    from heat_tpu_torch.core import fusion

    peak_budget = None
    if args.peak_budget is not None:
        from heat_tpu_torch.core import memledger

        try:
            peak_budget = memledger.parse_budget(args.peak_budget)
        except ValueError as exc:
            print(f"heat-audit: bad --peak-budget {args.peak_budget!r}: {exc}", file=out)
            return 2
        if not isinstance(peak_budget, int):
            print(
                f"heat-audit: --peak-budget must be absolute bytes "
                f"(got {args.peak_budget!r})",
                file=out,
            )
            return 2
    audited = len(fusion.cache_stats()["program_keys"])
    findings = audit_mod.audit_programs(
        factor=args.factor,
        min_bytes=args.min_bytes,
        budgets=budgets,
        top=args.top,
        peak_budget=peak_budget,
    )
    if args.format == "json":
        print(
            json.dumps({"findings": [f.as_dict() for f in findings], "audited": audited}, indent=1),
            file=out,
        )
    else:
        print(audit_mod.render_audit(findings, audited), file=out)
    return 1 if findings else 0


def _cmd_rules(args, out) -> int:
    from . import dataflow
    from .rules import rule_table

    print("— pass 1: AST lint (`lint`) —", file=out)
    for rec in rule_table():
        print(f"{rec['id']}  [{rec['severity']:<7}] {rec['title']}", file=out)
        print(f"      why:  {rec['rationale']}", file=out)
        print(f"      fix:  {rec['hint']}", file=out)
    print("— pass 3: distribution-flow verifier (`verify`) —", file=out)
    for rec in dataflow.rule_table():
        print(f"{rec['id']}  [{rec['severity']:<7}] {rec['title']}", file=out)
        print(f"      why:  {rec['rationale']}", file=out)
        print(f"      fix:  {rec['hint']}", file=out)
    return 0


def _cmd_verify(args, out) -> int:
    from . import dataflow, engine

    budgets = {}
    for spec in args.budget or []:
        try:
            glob, ceiling = dataflow.parse_budget_arg(spec)
        except ValueError as exc:
            print(f"heat-verify: {exc}", file=out)
            return 2
        budgets[glob] = ceiling

    if args.save_observed:
        # live telemetry capture of the drift workloads (the only verify
        # path that computes) — the saved report later feeds the
        # fully-static `--observed` diff
        if args.devices:
            _force_mesh(args.devices)
        rep = dataflow.drift_report()
        with open(args.save_observed, "w") as fh:
            json.dump(rep, fh, indent=1, sort_keys=True)
            fh.write("\n")
        print(
            f"heat-verify: observed collective bytes for "
            f"{len(rep['workloads'])} workload(s) at mesh "
            f"{rep['mesh_size']} written to {args.save_observed}",
            file=out,
        )
        return 0

    paths = args.paths or DEFAULT_PATHS
    try:
        findings, stats = dataflow.verify_paths(
            paths,
            mesh_size=args.mesh_size,
            rules=args.rules,
            budgets=budgets or None,
        )
    except engine.LintError as exc:
        print(f"heat-verify: {exc}", file=out)
        return 2

    if args.write_baseline is not None:
        path = args.write_baseline or DEFAULT_BASELINE
        # namespace-scoped: verify owns S-rule entries; the lint's H-rule
        # entries in the shared file survive untouched
        doc = engine.write_baseline(path, findings, namespaces=("S",))
        n = sum(1 for e in doc["entries"] if str(e.get("rule", "")).startswith("S"))
        print(
            f"heat-verify: baseline with {n} S-rule finding(s) written to {path}",
            file=out,
        )
        return 0
    if args.baseline is not None:
        try:
            baseline = engine.load_baseline(args.baseline or DEFAULT_BASELINE)
        except engine.LintError as exc:
            print(f"heat-verify: {exc}", file=out)
            return 2
        engine.apply_baseline(findings, baseline)

    drift = None
    drift_ok = True
    if args.observed:
        try:
            with open(args.observed) as fh:
                report = json.load(fh)
        except (OSError, json.JSONDecodeError) as exc:
            print(f"heat-verify: cannot read observed report {args.observed!r}: {exc}", file=out)
            return 2
        drift = dataflow.compare_observed(report)
        drift_ok = all(
            rec.get("within_bound", False) for rec in drift["workloads"].values()
        ) and bool(drift["workloads"])

    if args.format == "json":
        print(
            json.dumps(
                {
                    "findings": [f.as_dict() for f in findings],
                    "summary": engine.summarize(findings),
                    "stats": stats,
                    "drift": drift,
                },
                indent=1,
            ),
            file=out,
        )
    else:
        print(
            engine.render_findings(
                findings, show_suppressed=args.show_suppressed, prog="heat-verify"
            ),
            file=out,
        )
        top = sorted(
            stats["regions"].items(), key=lambda kv: -kv[1]["bytes"]
        )[: args.top_regions]
        if top:
            print("costliest regions (static bytes-on-wire lower bound):", file=out)
            for name, rec in top:
                ops = ", ".join(
                    f"{op}={b}" for op, b in sorted(rec["cost"].items())
                )
                print(f"  {rec['bytes']:>12} B  {name}  ({ops})", file=out)
        if drift is not None:
            print(
                f"static-vs-observed drift at mesh {drift['mesh_size']} "
                f"(bound: {dataflow.DRIFT_FACTOR}x):",
                file=out,
            )
            for name, rec in sorted(drift["workloads"].items()):
                mark = "ok" if rec.get("within_bound") else "DRIFT"
                print(
                    f"  {name}: static {rec['static_total']} B vs observed "
                    f"{rec['observed_total']} B (ratio {rec.get('ratio')}, "
                    f"{rec.get('drift_pct')}%) {mark}",
                    file=out,
                )
    if not drift_ok:
        return 1
    return 1 if engine.summarize(findings)["active"] else 0


def main(argv: Optional[List[str]] = None, out=None) -> int:
    out = out if out is not None else sys.stdout
    parser = argparse.ArgumentParser(
        prog="python -m heat_tpu_torch.analysis",
        description="SPMD hazard analyzer: AST lint (H001-H005), program audit, distribution-flow verifier.",
    )
    sub = parser.add_subparsers(dest="cmd", required=True)

    p_lint = sub.add_parser("lint", help="lint Python sources for SPMD hazards")
    p_lint.add_argument("paths", nargs="*", help=f"files/dirs (default: {' '.join(DEFAULT_PATHS)})")
    p_lint.add_argument(
        "--baseline",
        nargs="?",
        const=DEFAULT_BASELINE,
        default=None,
        metavar="FILE",
        help=f"fail only on findings NOT in this baseline (default file: {DEFAULT_BASELINE})",
    )
    p_lint.add_argument(
        "--write-baseline",
        nargs="?",
        const=DEFAULT_BASELINE,
        default=None,
        metavar="FILE",
        help="write the current findings as the new baseline and exit 0",
    )
    p_lint.add_argument("--rules", help="comma list of rule ids to run (default: all)")
    p_lint.add_argument("--format", choices=("text", "json"), default="text")
    p_lint.add_argument(
        "--show-suppressed", action="store_true", help="also print suppressed/baselined findings"
    )

    p_audit = sub.add_parser("audit", help="audit the recorder's cached programs")
    p_audit.add_argument(
        "--devices", type=int, default=0, help="run on a CPU mesh of N shards instead of the card"
    )
    p_audit.add_argument(
        "--warm",
        choices=("none", "bench"),
        default="none",
        help="'bench' warms the cache with the bench-shaped workloads first",
    )
    p_audit.add_argument(
        "--factor",
        type=float,
        default=None,
        help="replication-blowup threshold: per-host bytes-accessed >= FACTOR x sharded lower bound",
    )
    p_audit.add_argument(
        "--min-bytes", type=int, default=None, help="ignore programs smaller than this"
    )
    p_audit.add_argument("--budget", metavar="FILE", help="JSON family-glob -> collective/wire-bytes/peak-bytes budgets")
    p_audit.add_argument(
        "--peak-budget",
        metavar="BYTES",
        default=None,
        help="flag any program whose static memory peak (from its node shapes, "
        "per rank) exceeds this — accepts KiB/MiB/GiB suffixes, the static form "
        "of HEAT_TPU_MEMORY_BUDGET",
    )
    p_audit.add_argument("--top", type=int, default=None, help="audit only the top-N programs by dispatches")
    p_audit.add_argument("--format", choices=("text", "json"), default="text")

    p_verify = sub.add_parser(
        "verify",
        help="distribution-flow verifier: interprocedural split/sharding "
        "abstract interpretation (S101-S105) + static cost budgets",
    )
    p_verify.add_argument(
        "paths", nargs="*", help=f"files/dirs (default: {' '.join(DEFAULT_PATHS)})"
    )
    p_verify.add_argument(
        "--baseline",
        nargs="?",
        const=DEFAULT_BASELINE,
        default=None,
        metavar="FILE",
        help=f"fail only on findings NOT in this baseline (default file: {DEFAULT_BASELINE}; "
        "shared with the lint — namespaces are disjoint)",
    )
    p_verify.add_argument(
        "--write-baseline",
        nargs="?",
        const=DEFAULT_BASELINE,
        default=None,
        metavar="FILE",
        help="write the current S-rule findings into the baseline (H-rule entries preserved) and exit 0",
    )
    p_verify.add_argument(
        "--budget",
        action="append",
        metavar="GLOB=BYTES",
        help="static cost budget: fail when a region matching GLOB (function "
        "qualname, e.g. '*KMeans.fit') exceeds BYTES on the wire "
        "(KiB/MiB/GiB suffixes ok); repeatable",
    )
    p_verify.add_argument(
        "--mesh-size",
        type=int,
        default=None,
        help="mesh size the cost formulas assume (default: 8)",
    )
    p_verify.add_argument(
        "--observed",
        metavar="FILE",
        help="diff the static byte estimates against a saved telemetry report "
        "(produced by --save-observed); fails when any workload drifts past "
        "the 2x bound",
    )
    p_verify.add_argument(
        "--save-observed",
        metavar="FILE",
        help="run the drift workloads live under telemetry (on the card unless "
        "--devices) and save the observed collective bytes, then exit",
    )
    p_verify.add_argument(
        "--devices", type=int, default=0, help="with --save-observed: run on a CPU mesh of N shards instead of the card"
    )
    p_verify.add_argument("--rules", help="comma list of S-rule ids to run (default: all)")
    p_verify.add_argument(
        "--top-regions", type=int, default=5, help="text mode: show the N costliest regions"
    )
    p_verify.add_argument("--format", choices=("text", "json"), default="text")
    p_verify.add_argument(
        "--json", dest="format", action="store_const", const="json", help="alias for --format json"
    )
    p_verify.add_argument(
        "--show-suppressed", action="store_true", help="also print suppressed/baselined findings"
    )

    sub.add_parser("rules", help="print both passes' rule tables")

    args = parser.parse_args(argv)
    if args.cmd == "lint":
        return _cmd_lint(args, out)
    if args.cmd == "audit":
        from . import audit as audit_mod

        if args.factor is None:
            args.factor = audit_mod.DEFAULT_FACTOR
        if args.min_bytes is None:
            args.min_bytes = audit_mod.DEFAULT_MIN_BYTES
        return _cmd_audit(args, out)
    if args.cmd == "verify":
        if args.mesh_size is None:
            from .dataflow import DEFAULT_MESH_SIZE

            args.mesh_size = DEFAULT_MESH_SIZE
        return _cmd_verify(args, out)
    if args.cmd == "rules":
        return _cmd_rules(args, out)
    return 2  # pragma: no cover - argparse enforces the subcommands


if __name__ == "__main__":  # pragma: no cover - exercised via subprocess in CI
    sys.exit(main())
