"""The heat-lint rule engine: findings, suppressions, baselines, file walking.

Pure standard-library AST analysis — importing this module never touches a
device or initializes a mesh, so ``python -m heat_tpu_torch.analysis lint``
runs on a login node with no accelerator attached. The SPMD-specific
rules themselves live in :mod:`heat_tpu_torch.analysis.rules`; this module owns the
mechanics every rule shares:

* :class:`Finding` — one ``file:line`` diagnostic with rule id, severity,
  message and a fix hint.
* **Suppressions** — ``# heat-lint: disable=H002`` (comma-list, or ``all``)
  on the flagged line or on a standalone comment line directly above it.
  Suppressed findings are kept (``suppressed=True``) so reports can show
  what was waived, but they never fail a lint run.
* **Baselines** — a committed JSON file of fingerprinted known findings
  (:func:`write_baseline` / :func:`load_baseline` / :func:`apply_baseline`).
  Fingerprints hash (rule, path, source-line text) rather than line numbers,
  so unrelated edits above a known finding do not churn the baseline; a lint
  run against a baseline fails only on NEW findings.
"""

from __future__ import annotations

import ast
import hashlib
import json
import os
import re
from dataclasses import dataclass
from typing import Dict, Iterable, List, Sequence

__all__ = [
    "Finding",
    "LintError",
    "apply_baseline",
    "baseline_entries",
    "lint_paths",
    "lint_source",
    "load_baseline",
    "render_findings",
    "summarize",
    "write_baseline",
]

BASELINE_VERSION = 1


class LintError(RuntimeError):
    """A lint run could not complete (unreadable path, malformed baseline)."""


@dataclass
class Finding:
    """One diagnostic: ``path:line`` + rule id, severity, message, fix hint."""

    rule: str
    path: str
    line: int
    col: int
    severity: str  # "error" | "warning" | "info"
    message: str
    hint: str = ""
    source: str = ""  # the stripped source line (fingerprint input)
    suppressed: bool = False
    baselined: bool = False

    @property
    def location(self) -> str:
        return f"{self.path}:{self.line}"

    def fingerprint(self) -> str:
        """Stable identity for baseline matching: rule + path + the source
        line's text (NOT its number — edits above a known finding must not
        churn the committed baseline)."""
        raw = "|".join((self.rule, _posix(self.path), self.source))
        return hashlib.sha1(raw.encode()).hexdigest()[:16]

    def as_dict(self) -> dict:
        return {
            "rule": self.rule,
            "path": _posix(self.path),
            "line": self.line,
            "col": self.col,
            "severity": self.severity,
            "message": self.message,
            "hint": self.hint,
            "source": self.source,
            "suppressed": self.suppressed,
            "baselined": self.baselined,
            "fingerprint": self.fingerprint(),
        }


def _posix(path: str) -> str:
    return path.replace(os.sep, "/")


# ----------------------------------------------------------------------
# suppressions: # heat-lint: disable=H001[,H002] | disable=all
# ----------------------------------------------------------------------
_SUPPRESS_RE = re.compile(r"#\s*heat-lint:\s*disable=([A-Za-z0-9_,\s]+)")


def _suppressions(lines: Sequence[str]) -> Dict[int, set]:
    """1-based line -> set of suppressed rule ids ("all" wildcards)."""
    out: Dict[int, set] = {}
    for i, line in enumerate(lines, start=1):
        m = _SUPPRESS_RE.search(line)
        if m:
            out[i] = {r.strip() for r in m.group(1).split(",") if r.strip()}
    return out


def _is_suppressed(finding: Finding, sup: Dict[int, set], lines: Sequence[str]) -> bool:
    for ln in (finding.line, finding.line - 1):
        rules = sup.get(ln)
        if not rules:
            continue
        if ln == finding.line - 1:
            # a suppression one line up only applies from a standalone
            # comment line (otherwise it belongs to that line's own finding)
            text = lines[ln - 1].strip() if 0 < ln <= len(lines) else ""
            if not text.startswith("#"):
                continue
        if "all" in rules or finding.rule in rules:
            return True
    return False


# ----------------------------------------------------------------------
# linting
# ----------------------------------------------------------------------
def _resolve_rules(rules=None) -> list:
    from . import rules as rules_mod

    table = rules_mod.RULES
    if rules is None:
        return list(table)
    wanted = {r.strip().upper() for r in rules} if not isinstance(rules, str) else {
        r.strip().upper() for r in rules.split(",") if r.strip()
    }
    unknown = wanted - {r.id for r in table}
    if unknown:
        raise LintError(f"unknown rule id(s): {sorted(unknown)}")
    return [r for r in table if r.id in wanted]


def lint_source(src: str, path: str = "<string>", rules=None) -> List[Finding]:
    """Lint one Python source string. Returns every finding, with
    ``suppressed`` already resolved from ``# heat-lint: disable=`` comments;
    callers filter on it (the CLI fails only on active findings)."""
    from .rules import ModuleContext

    lines = src.splitlines()
    try:
        tree = ast.parse(src, filename=path)
    except SyntaxError as exc:
        return [
            Finding(
                rule="H000",
                path=path,
                line=int(exc.lineno or 1),
                col=int(exc.offset or 0),
                severity="error",
                message=f"file does not parse: {exc.msg}",
                hint="heat-lint analyzes the AST; fix the syntax error first",
                source=(lines[exc.lineno - 1].strip() if exc.lineno and exc.lineno <= len(lines) else ""),
            )
        ]
    ctx = ModuleContext(tree=tree, lines=lines, path=path)
    findings: List[Finding] = []
    for rule in _resolve_rules(rules):
        for line, col, message in rule.run(ctx):
            findings.append(
                Finding(
                    rule=rule.id,
                    path=path,
                    line=line,
                    col=col,
                    severity=rule.severity,
                    message=message,
                    hint=rule.hint,
                    source=(lines[line - 1].strip() if 0 < line <= len(lines) else ""),
                )
            )
    sup = _suppressions(lines)
    if sup:
        for f in findings:
            f.suppressed = _is_suppressed(f, sup, lines)
    findings.sort(key=lambda f: (f.line, f.col, f.rule))
    return findings


def _iter_py_files(paths: Iterable[str]) -> List[str]:
    out: List[str] = []
    for p in paths:
        if os.path.isfile(p):
            out.append(p)
        elif os.path.isdir(p):
            for root, dirs, files in os.walk(p):
                dirs[:] = sorted(
                    d for d in dirs if d != "__pycache__" and not d.startswith(".")
                )
                for name in sorted(files):
                    if name.endswith(".py"):
                        out.append(os.path.join(root, name))
        else:
            raise LintError(f"no such file or directory: {p!r}")
    return out


def lint_paths(paths: Iterable[str], rules=None) -> List[Finding]:
    """Lint every ``.py`` file under ``paths`` (files or directories;
    ``__pycache__`` and dot-directories are skipped). Findings are sorted by
    (path, line)."""
    findings: List[Finding] = []
    for fname in _iter_py_files(paths):
        with open(fname, "r", encoding="utf-8", errors="replace") as fh:
            src = fh.read()
        findings.extend(lint_source(src, path=_posix(fname), rules=rules))
    findings.sort(key=lambda f: (f.path, f.line, f.col, f.rule))
    return findings


# ----------------------------------------------------------------------
# baselines
# ----------------------------------------------------------------------
def baseline_entries(findings: Iterable[Finding]) -> dict:
    """The committed-baseline document for a set of findings: fingerprint
    counts for matching plus a human-reviewable entry list. Suppressed
    findings are excluded — an inline suppression already records the waiver
    next to the code it waives."""
    fps: Dict[str, int] = {}
    entries = []
    for f in findings:
        if f.suppressed:
            continue
        fps[f.fingerprint()] = fps.get(f.fingerprint(), 0) + 1
        entries.append(
            {
                "rule": f.rule,
                "path": _posix(f.path),
                "line": f.line,
                "source": f.source,
                "fingerprint": f.fingerprint(),
            }
        )
    return {"version": BASELINE_VERSION, "fingerprints": fps, "entries": entries}


def write_baseline(path: str, findings: Iterable[Finding], namespaces=None) -> dict:
    """Write ``findings`` as the committed baseline. With ``namespaces``
    (a tuple of rule-id prefixes, e.g. ``("S",)``), the write is scoped to
    those namespaces: entries of OTHER namespaces already committed at
    ``path`` are preserved verbatim, so the lint pass rewriting its H-rule
    baseline never invalidates the dataflow pass's S-rule fingerprints and
    vice versa (the two passes share one baseline file)."""
    doc = baseline_entries(findings)
    if namespaces is not None:
        prefixes = tuple(namespaces)
        doc["entries"] = [e for e in doc["entries"] if e["rule"].startswith(prefixes)]
        try:
            old = load_baseline(path)
        except LintError:
            old = None
        if old is not None:
            kept = [
                e
                for e in old.get("entries", [])
                if isinstance(e, dict) and not str(e.get("rule", "")).startswith(prefixes)
            ]
            doc["entries"] = kept + doc["entries"]
        fps: Dict[str, int] = {}
        for e in doc["entries"]:
            fp = e.get("fingerprint")
            if fp:
                fps[fp] = fps.get(fp, 0) + 1
        doc["fingerprints"] = fps
        doc["entries"].sort(key=lambda e: (e.get("path", ""), e.get("line", 0), e.get("rule", "")))
    with open(path, "w") as fh:
        json.dump(doc, fh, indent=1, sort_keys=True)
        fh.write("\n")
    return doc


def load_baseline(path: str) -> dict:
    try:
        with open(path) as fh:
            doc = json.load(fh)
    except FileNotFoundError:
        raise LintError(f"baseline file not found: {path!r} (run --write-baseline first)")
    except json.JSONDecodeError as exc:
        raise LintError(f"baseline file {path!r} is not valid JSON: {exc}")
    if not isinstance(doc, dict) or not isinstance(doc.get("fingerprints"), dict):
        raise LintError(f"baseline file {path!r} missing its fingerprints map")
    return doc


def apply_baseline(findings: Iterable[Finding], baseline: dict) -> None:
    """Mark findings present in ``baseline`` as ``baselined`` (multiset
    semantics: N identical fingerprints in the baseline absorb at most N
    findings, so a duplicated regression still surfaces)."""
    budget = dict(baseline.get("fingerprints", {}))
    for f in findings:
        if f.suppressed:
            continue
        fp = f.fingerprint()
        if budget.get(fp, 0) > 0:
            budget[fp] -= 1
            f.baselined = True


# ----------------------------------------------------------------------
# reporting
# ----------------------------------------------------------------------
def summarize(findings: Sequence[Finding]) -> dict:
    active = [f for f in findings if not f.suppressed and not f.baselined]
    return {
        "total": len(findings),
        "active": len(active),
        "errors": sum(1 for f in active if f.severity == "error"),
        "warnings": sum(1 for f in active if f.severity == "warning"),
        "suppressed": sum(1 for f in findings if f.suppressed),
        "baselined": sum(1 for f in findings if f.baselined),
        "files": len({f.path for f in active}),
    }


def render_findings(
    findings: Sequence[Finding],
    show_suppressed: bool = False,
    hints: bool = True,
    prog: str = "heat-lint",
) -> str:
    """Human-readable report: one ``path:line: RULE severity: message`` block
    per active finding (suppressed/baselined shown only on request), ending
    with a one-line summary."""
    out: List[str] = []
    for f in findings:
        if (f.suppressed or f.baselined) and not show_suppressed:
            continue
        tag = " [suppressed]" if f.suppressed else (" [baseline]" if f.baselined else "")
        out.append(f"{f.location}: {f.rule} {f.severity}: {f.message}{tag}")
        if f.source:
            out.append(f"    {f.source}")
        if hints and f.hint:
            out.append(f"    hint: {f.hint}")
    s = summarize(findings)
    out.append(
        f"{prog}: {s['active']} finding(s) ({s['errors']} error(s), "
        f"{s['warnings']} warning(s)) in {s['files']} file(s); "
        f"{s['suppressed']} suppressed, {s['baselined']} baselined"
    )
    return "\n".join(out)
