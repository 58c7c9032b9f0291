"""The distribution-flow verifier: an interprocedural abstract interpreter.

The lint (H001–H005) is intraprocedural and syntactic; the expensive bug
class it cannot see is *semantic*. Heat's single-integer ``split`` makes
distribution statically decidable (HeAT, arxiv 2007.13552), and the
split-changing operations are where the collective cost lives (arxiv
2112.01075 prices every split→split change): mixed-split operands silently
resharded inside ``__binary_op``'s split-dominance rule
(``heat_tpu_torch/core/_operations.py``: the engine's ``_aligned`` gathers
a broadcast operand whole and cuts it into the result's blocks), forcing points hidden behind helper
boundaries, estimator loops whose on-wire bytes nobody can bound before
running. This module interprets Python ASTs over the
:mod:`~heat_tpu_torch.analysis.lattice` domain — ``(rank, split ∈ {None, 0..k,
⊤}, device-set, pending|forced)`` — interprocedurally via the
:mod:`~heat_tpu_torch.analysis.callgraph`, with loop widening and memoized
per-function summaries, and reports four semantic rules through the
existing :class:`~heat_tpu_torch.analysis.engine.Finding` machinery:

========  ============================================================
S101      implicit reshard: a binary/``where``/``out=`` op whose
          inferred operand splits are *concrete and different* — split
          dominance makes the engine reshard the non-dominant side invisibly
          (no ``collective.reshard`` fault site, no telemetry bytes,
          no fusion ``defer_reshard`` node), reported with a static
          bytes-moved estimate.
S102      interprocedural blocking-sync-in-loop: a loop calls a helper
          whose summary (transitively) blocks on the device — H002's
          hazard carried through call summaries.
S103      split-downgrade: an explicit resplit to ``None`` of a value
          whose inferred split is a concrete axis — the array
          materializes O(n) on every host where a sharded layout was
          available.
S104      interprocedural divergence: lockstep two-abstract-host
          reasoning extending H001 across function boundaries — a
          divergent branch calls a helper that reaches a collective/
          forcing point, or the divergence itself came out of a
          callee's return value.
S105      static collective-cost budget exceeded: a region's
          bytes-on-wire lower bound (the op-table cost model over the
          lattice state) breaks a declared ``--budget GLOB=BYTES``.
========  ============================================================

The cost model's byte conventions deliberately match telemetry's
logical-payload accounting (``record_collective_operand`` and the linalg
declared schedules), so the **drift check** can diff static estimates
against ``telemetry.collectives()`` observed bytes on the same workloads
(:data:`DRIFT_WORKLOADS`) — the model cannot silently rot.

Pure standard library at import time; only the drift *runner*
(:func:`observed_workload_bytes`) imports the port's runtime, lazily.
"""

from __future__ import annotations

import ast
import fnmatch
import re
from dataclasses import dataclass, field, replace
from typing import Dict, List, Optional, Sequence, Tuple

from . import callgraph as cg
from . import lattice as lat
from .engine import Finding, _is_suppressed, _posix, _suppressions
from .lattice import TOP, UNKNOWN, AbstractArray, Const, Instance, Scalar, VTuple
from .rules import (
    Rule,
    _divergent_call,
    _is_collective_call,
    dotted_name,
    last_name,
)

__all__ = [
    "DRIFT_WORKLOADS",
    "RULES",
    "drift_report",
    "observed_workload_bytes",
    "parse_budget_arg",
    "rule_table",
    "static_workload_bytes",
    "verify_paths",
    "verify_source",
    "workload_source",
]

DEFAULT_MESH_SIZE = 8
#: loop bodies re-interpret until the widened env is stable, at most this
MAX_LOOP_ITERS = 3
#: distinct abstract calling contexts memoized per function before falling
#: back to the context-insensitive (all-UNKNOWN) summary
MAX_CONTEXTS = 8
#: interpretation depth cap (recursion guard for un-memoized instance calls)
MAX_CALL_DEPTH = 40
#: the acceptance bound for the static-vs-observed drift check: estimates
#: must sit within this factor of telemetry-observed bytes
DRIFT_FACTOR = 2.0

#: collective op types whose *observed* bytes telemetry records (the verbs +
#: declared linalg schedules); the drift check compares exactly these
OBSERVED_OPS = ("allreduce", "allgather", "alltoall", "ppermute", "bcast", "exscan", "scan")


# ----------------------------------------------------------------------
# the semantic rule registry (metadata; detection lives in the interpreter)
# ----------------------------------------------------------------------
RULES: List[Rule] = [
    Rule(
        id="S101",
        severity="error",
        title="implicit reshard at a mixed-split operation",
        rationale=(
            "split dominance (core/_operations.py __binary_op) distributes a "
            "binary result along the first operand's split and reshards the "
            "other side during the op: identical-shape combinations now ride "
            "the explicit resplit seam (fault site + telemetry bytes + "
            "fusion node), broadcasted ones the engine's _aligned gathers whole "
            "and cuts into the result's blocks invisibly — and "
            "either way the bytes move, silently from the SOURCE's point of "
            "view, on every single call"
        ),
        hint=(
            "make the reshard explicit: `b = ht.resplit(b, a.split)` (a "
            "recorded DAG node with its fault site and telemetry bytes) "
            "before the op, or suppress with `# heat-lint: disable=S101` + "
            "a justification that the implicit reshard is intended"
        ),
    ),
    Rule(
        id="S102",
        severity="warning",
        title="blocking sync in a loop through a helper call",
        rationale=(
            "H002 sees `.item()`/`float()` in the loop body; it cannot see a "
            "helper whose *summary* blocks. Each iteration still fences the "
            "async-forcing pipeline — the hazard just moved behind a "
            "function boundary"
        ),
        hint=(
            "hoist the host read out of the loop, return the recorded (un-"
            "forced) value from the helper, or suppress with "
            "`# heat-lint: disable=S102` + why the per-iteration read is "
            "the point (convergence checks)"
        ),
    ),
    Rule(
        id="S103",
        severity="warning",
        title="split downgrade to replicated",
        rationale=(
            "a resplit to None of a value whose inferred split is a concrete "
            "axis materializes the full array on every host (an allgather "
            "and O(n) per-host memory) on a path where a sharded layout was "
            "available — the replication blowup the program auditor sees in "
            "recorded programs, caught here at the source"
        ),
        hint=(
            "keep the sharded layout and resplit only the (small) final "
            "result, or suppress with `# heat-lint: disable=S103` + why the "
            "gather is intended (small arrays, host export)"
        ),
    ),
    Rule(
        id="S104",
        severity="error",
        title="interprocedural host-divergent collective",
        rationale=(
            "lockstep two-abstract-host execution: on a branch whose "
            "condition differs across hosts, one abstract host calls a "
            "helper that reaches a collective/forcing point and the other "
            "never does — the mesh deadlocks. H001 sees this only when both "
            "the divergence and the collective are in one function; this "
            "rule carries both through call summaries"
        ),
        hint=(
            "hoist the helper call out of the divergent branch (compute on "
            "all hosts, gate only pure file I/O on io_owner()), or derive "
            "the branch from data every host shares"
        ),
    ),
    Rule(
        id="S105",
        severity="error",
        title="static collective-cost budget exceeded",
        rationale=(
            "the per-region cost model (op table x lattice state) lower-"
            "bounds bytes-on-wire before anything runs; a region over its "
            "declared --budget GLOB=BYTES ceiling ships a collective bill "
            "nobody signed off on"
        ),
        hint=(
            "cut the reshards/gathers the verify report itemizes for the "
            "region, or raise the budget deliberately in the CI invocation"
        ),
    ),
]


def rule_table() -> List[dict]:
    """The dataflow pass's rule registry, documentation-ready (the CLI
    ``rules`` verb prints it below the lint pass's table)."""
    return [
        {
            "id": r.id,
            "severity": r.severity,
            "title": r.title,
            "rationale": r.rationale,
            "hint": r.hint,
        }
        for r in RULES
    ]


_RULE_BY_ID = {r.id: r for r in RULES}


# ----------------------------------------------------------------------
# small shared helpers
# ----------------------------------------------------------------------
_DTYPE_NAMES = set(lat._ITEMSIZE)


def _dtype_from_node(node: Optional[ast.AST]) -> Optional[str]:
    """``ht.float64`` / ``types.float32`` kwarg ASTs -> dtype name."""
    if node is None:
        return None
    name = last_name(node)
    if name in _DTYPE_NAMES:
        return name
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value if node.value in _DTYPE_NAMES else None
    return None


_DTYPE_ORDER = [
    "bool", "uint8", "int8", "int16", "uint16", "int32", "uint32", "int64",
    "uint64", "bfloat16", "float16", "float32", "float64", "complex64",
    "complex128",
]


def _promote(d1: Optional[str], d2: Optional[str]) -> Optional[str]:
    if d1 is None or d2 is None:
        return d1 or d2
    if d1 not in _DTYPE_ORDER or d2 not in _DTYPE_ORDER:
        return None
    return max(d1, d2, key=_DTYPE_ORDER.index)


def _const_int(v) -> Optional[int]:
    if isinstance(v, Const) and isinstance(v.value, int) and not isinstance(v.value, bool):
        return v.value
    return None


def _const_shape(v) -> Optional[Tuple[int, ...]]:
    """A shape argument's statically-known dims, or None."""
    if isinstance(v, Const):
        if isinstance(v.value, int) and not isinstance(v.value, bool):
            return (v.value,)
        if isinstance(v.value, (tuple, list)) and all(
            isinstance(d, int) and not isinstance(d, bool) for d in v.value
        ):
            return tuple(v.value)
    if isinstance(v, VTuple):
        dims = [_const_int(i) for i in v.items]
        if all(d is not None for d in dims):
            return tuple(dims)
    return None


def _norm_split(split: lat.Split, rank: Optional[int]) -> lat.Split:
    """Normalize a negative split axis against a known rank (the runtime's
    sanitize_axis does the same): ``split=-1`` on a rank-2 array IS axis 1,
    and two spellings of one axis must not read as disagreement. Unknown
    rank keeps the raw value; out-of-range goes to ⊤ (the runtime would
    raise — not this pass's finding)."""
    if isinstance(split, int) and rank:
        if -rank <= split < rank:
            return split % rank
        return TOP
    return split


def _split_arg(v, present: bool) -> lat.Split:
    """A ``split=`` argument value -> the split sub-lattice (absent/None
    defaults to replicated, which is every factory's default)."""
    if not present:
        return None
    if isinstance(v, Const):
        if v.value is None:
            return None
        if isinstance(v.value, int) and not isinstance(v.value, bool):
            return v.value
    return TOP


def _terminates(stmts: Sequence[ast.stmt]) -> bool:
    return bool(stmts) and isinstance(
        stmts[-1], (ast.Return, ast.Raise, ast.Continue, ast.Break)
    )


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


# ----------------------------------------------------------------------
# interpretation state
# ----------------------------------------------------------------------
def _costlier_path(base: Dict[str, int], a: Dict[str, int], b: Dict[str, int]) -> Dict[str, int]:
    """Of two cost states that share the prefix ``base``, keep the one whose
    delta over ``base`` moves more total bytes — mutually-exclusive paths
    (if/else arms, except handlers) must never SUM into the region bound."""
    base_total = sum(base.values())
    return dict(a) if sum(a.values()) - base_total >= sum(b.values()) - base_total else dict(b)


@dataclass(frozen=True)
class Ctx:
    """Block context: divergence taint (S104's "which abstract host gets
    here") with provenance, and loop depth (S102's trigger)."""

    divergent: Optional[str] = None  # why, or None
    via_call: bool = False  # the divergence crossed a function boundary
    loop_depth: int = 0

    def taint(self, why: str, via_call: bool) -> "Ctx":
        if self.divergent is not None:
            return self if not via_call or self.via_call else replace(self, via_call=True)
        return replace(self, divergent=why, via_call=via_call)

    def in_loop(self) -> "Ctx":
        return replace(self, loop_depth=self.loop_depth + 1)


@dataclass
class Frame:
    """One function (or module) body under interpretation."""

    module: cg.ModuleInfo
    fninfo: Optional[cg.FunctionInfo]
    env: Dict[str, object] = field(default_factory=dict)
    self_val: Optional[Instance] = None
    rets: List[object] = field(default_factory=list)
    blocking: bool = False
    collective: bool = False
    cost: Dict[str, int] = field(default_factory=dict)

    def add_cost(self, op: str, nbytes: Optional[int]) -> None:
        if nbytes:
            self.cost[op] = self.cost.get(op, 0) + int(nbytes)

    def merge_cost(self, other: Dict[str, int]) -> None:
        for op, b in other.items():
            self.cost[op] = self.cost.get(op, 0) + b

    @property
    def region(self) -> str:
        if self.fninfo is not None:
            return self.fninfo.qualname
        return f"{self.module.path}::<module>"


@dataclass
class Summary:
    """A function's effect summary under one abstract calling context."""

    ret: object = UNKNOWN
    blocking: bool = False
    collective: bool = False
    divergent_ret: bool = False
    cost: Dict[str, int] = field(default_factory=dict)


def _value_key(v) -> object:
    if isinstance(v, AbstractArray):
        return ("A", v.rank, repr(v.split), v.shape, v.dtype, v.pending)
    if isinstance(v, Const):
        try:
            hash(v.value)
            return ("C", v.value)
        except TypeError:
            return ("C", repr(v.value)[:64])
    if isinstance(v, Scalar):
        return ("S", v.divergent, v.via_call)
    if isinstance(v, Instance):
        return ("I", v.cls)
    if isinstance(v, VTuple):
        return ("T",) + tuple(_value_key(i) for i in v.items[:8])
    return "?"


# ----------------------------------------------------------------------
# the heat API op tables
# ----------------------------------------------------------------------
_FACTORIES = {
    "empty", "zeros", "ones", "full", "array", "asarray",
    "empty_like", "zeros_like", "ones_like", "full_like",
    "arange", "linspace", "logspace", "eye",
    # heat_tpu_torch.core.random
    "rand", "randn", "standard_normal", "normal", "random", "uniform",
    "randint", "randperm", "permutation",
}
_UNARY_ELEMENTWISE = {
    "abs", "absolute", "sqrt", "rsqrt", "exp", "exp2", "expm1", "log", "log2",
    "log10", "log1p", "sin", "cos", "tan", "sinh", "cosh", "tanh", "arcsin",
    "arccos", "arctan", "arcsinh", "arccosh", "arctanh", "floor", "ceil",
    "trunc", "round", "rint", "sign", "square", "negative", "positive",
    "reciprocal", "isnan", "isinf", "isfinite", "logical_not", "invert",
    "conjugate", "conj", "real", "imag", "angle", "erf", "erfinv", "sigmoid",
    "clip", "fabs", "modf", "frexp", "nan_to_num", "copy",
}
_BINARY_ELEMENTWISE = {
    "add", "subtract", "sub", "multiply", "mul", "divide", "div",
    "true_divide", "floor_divide", "mod", "remainder", "fmod", "pow",
    "power", "arctan2", "hypot", "minimum", "maximum", "logaddexp",
    "logaddexp2", "logical_and", "logical_or", "logical_xor", "bitwise_and",
    "bitwise_or", "bitwise_xor", "left_shift", "right_shift", "gcd", "lcm",
    "copysign", "nextafter", "equal", "not_equal", "greater",
    "greater_equal", "less", "less_equal", "isclose",
}
_REDUCTIONS = {
    "sum", "prod", "mean", "average", "std", "var", "min", "max", "amin",
    "amax", "argmin", "argmax", "all", "any", "median", "nansum", "nanmean",
    "count_nonzero", "norm",
}
_CUM_OPS = {"cumsum", "cumprod"}
#: array methods that block on the device (host reads of pending chains)
_BLOCKING_METHODS = {"item", "numpy", "tolist", "__float__", "__int__"}
_SYNC_BUILTINS = {"float", "int", "bool", "complex"}


# ----------------------------------------------------------------------
# the analyzer
# ----------------------------------------------------------------------
class Analyzer:
    def __init__(self, graph: cg.CallGraph, mesh_size: int = DEFAULT_MESH_SIZE):
        self.graph = graph
        self.p = max(1, int(mesh_size))
        self.summaries: Dict[tuple, Summary] = {}
        self.context_count: Dict[str, int] = {}
        self.active: set = set()
        self.call_depth = 0
        self.findings: Dict[tuple, Finding] = {}
        #: region qualname -> {"path", "line", "cost": {op: bytes}, "bytes"}
        self.regions: Dict[str, dict] = {}

    # -- findings --------------------------------------------------------
    def emit(self, rule_id: str, node: ast.AST, fr: Frame, message: str) -> None:
        key = (rule_id, fr.module.path, node.lineno, node.col_offset)
        if key in self.findings:
            return
        rule = _RULE_BY_ID[rule_id]
        lines = fr.module.lines
        self.findings[key] = Finding(
            rule=rule_id,
            path=fr.module.path,
            line=node.lineno,
            col=node.col_offset,
            severity=rule.severity,
            message=message,
            hint=rule.hint,
            source=(
                lines[node.lineno - 1].strip()
                if 0 < node.lineno <= len(lines)
                else ""
            ),
        )

    # -- entry points ----------------------------------------------------
    def analyze_module(self, mod: cg.ModuleInfo) -> None:
        fr = Frame(module=mod, fninfo=None)
        self.exec_block(mod.tree.body, fr, Ctx())
        self._record_region(fr, mod.tree)

    def analyze_function(self, fn: cg.FunctionInfo) -> None:
        """Default-context analysis: parameters UNKNOWN (methods get a fresh
        Instance for ``self``), so intra-function hazards surface even when
        no analyzed caller reaches the function."""
        args = []
        node = fn.node
        params = node.args.posonlyargs + node.args.args
        if fn.cls and params and params[0].arg == "self":
            args.append(Instance(fn.cls))
        summary = self.call_function(fn, args, {}, None, None, Ctx())
        rec = self.regions.get(fn.qualname)
        if rec is None or sum(summary.cost.values()) > rec["bytes"]:
            self.regions[fn.qualname] = {
                "path": fn.module.path,
                "line": fn.node.lineno,
                "cost": dict(summary.cost),
                "bytes": sum(summary.cost.values()),
            }

    def _record_region(self, fr: Frame, node) -> None:
        rec = self.regions.get(fr.region)
        total = sum(fr.cost.values())
        if rec is None or total > rec["bytes"]:
            self.regions[fr.region] = {
                "path": fr.module.path,
                "line": getattr(node, "lineno", 1),
                "cost": dict(fr.cost),
                "bytes": total,
            }

    # -- function calls --------------------------------------------------
    def call_function(
        self,
        fn: cg.FunctionInfo,
        args: List[object],
        kwargs: Dict[str, object],
        node: Optional[ast.Call],
        caller: Optional[Frame],
        ctx: Ctx,
    ) -> Summary:
        """Interpret (or recall) ``fn`` under the given abstract arguments,
        then apply the interprocedural rules at the call site."""
        summary = self._summarize(fn, args, kwargs)
        if caller is not None and node is not None:
            caller.blocking |= summary.blocking
            caller.collective |= summary.collective
            caller.merge_cost(summary.cost)
            if ctx.loop_depth and summary.blocking:
                self.emit(
                    "S102",
                    node,
                    caller,
                    f"`{fn.name}` blocks on the device (its summary reaches a "
                    "host read of a pending chain) and is called inside a "
                    "loop: every iteration fences the async-forcing pipeline "
                    "— H002's hazard, hidden behind this call boundary",
                )
            if ctx.divergent is not None and (summary.collective or summary.blocking):
                what = "a collective" if summary.collective else "a forcing point"
                self.emit(
                    "S104",
                    node,
                    caller,
                    f"on the host-divergent path ({ctx.divergent}), one "
                    f"abstract host calls `{fn.name}` — which reaches {what} "
                    "— and the other never does: the hosts that skip this "
                    "call never join, the mesh deadlocks (H001 across the "
                    "function boundary)",
                )
        ret = summary.ret
        if summary.divergent_ret:
            ret = Scalar(divergent=True, via_call=True)
        return replace(summary, ret=ret)

    def _bind_params(
        self, fn: cg.FunctionInfo, args: List[object], kwargs: Dict[str, object]
    ) -> Dict[str, object]:
        node = fn.node
        a = node.args
        env: Dict[str, object] = {}

        def seed(p: ast.arg) -> object:
            # a `x: DNDarray` annotation seeds an array of unknown layout —
            # enough for the effect rules (S102/S104) even when no analyzed
            # caller supplies a concrete lattice state
            if p.annotation is not None and last_name(p.annotation) == "DNDarray":
                return AbstractArray(rank=None, split=TOP)
            return UNKNOWN

        params = [p.arg for p in a.posonlyargs + a.args]
        for i, p in enumerate(a.posonlyargs + a.args):
            env[p.arg] = args[i] if i < len(args) and args[i] is not UNKNOWN else seed(p)
        if a.vararg is not None:
            env[a.vararg.arg] = UNKNOWN
        for p in a.kwonlyargs:
            env[p.arg] = UNKNOWN
        if a.kwarg is not None:
            env[a.kwarg.arg] = UNKNOWN
        # defaults for missing trailing positionals (literals only)
        defaults = a.defaults
        if defaults:
            for i, d in enumerate(defaults):
                name = params[len(params) - len(defaults) + i]
                if env.get(name) is UNKNOWN and isinstance(d, ast.Constant):
                    env[name] = Const(d.value)
        for name, v in kwargs.items():
            if name in env or name in [p.arg for p in a.kwonlyargs]:
                env[name] = v
        return env

    def _summarize(
        self, fn: cg.FunctionInfo, args: List[object], kwargs: Dict[str, object]
    ) -> Summary:
        has_instance = any(isinstance(v, Instance) for v in args) or any(
            isinstance(v, Instance) for v in kwargs.values()
        )
        key = None
        if not has_instance:
            argkey = tuple(_value_key(v) for v in args) + tuple(
                sorted((k, _value_key(v)) for k, v in kwargs.items())
            )
            if self.context_count.get(fn.qualname, 0) >= MAX_CONTEXTS:
                argkey = "ctx-cap"
                args, kwargs = [], {}
            key = (fn.qualname, argkey)
            hit = self.summaries.get(key)
            if hit is not None:
                return hit
        if fn.qualname in self.active or self.call_depth >= MAX_CALL_DEPTH:
            return Summary()  # recursion/depth: conservative, effect-free
        self.active.add(fn.qualname)
        self.call_depth += 1
        try:
            fr = Frame(module=fn.module, fninfo=fn, env=self._bind_params(fn, args, kwargs))
            if args and isinstance(args[0], Instance):
                fr.self_val = args[0]
            self.exec_block(fn.node.body, fr, Ctx())
            ret: object = Const(None)
            if fr.rets:
                ret = fr.rets[0]
                for r in fr.rets[1:]:
                    ret = lat.join(ret, r)
            summary = Summary(
                ret=ret,
                blocking=fr.blocking,
                collective=fr.collective,
                divergent_ret=any(lat.is_divergent(r) for r in fr.rets),
                cost=dict(fr.cost),
            )
        finally:
            self.active.discard(fn.qualname)
            self.call_depth -= 1
        if key is not None:
            self.summaries[key] = summary
            self.context_count[fn.qualname] = self.context_count.get(fn.qualname, 0) + 1
        # the region ledger keeps each function's COSTLIEST analyzed context
        # (budgets bound the worst statically-seen call pattern)
        rec = self.regions.get(fn.qualname)
        total = sum(summary.cost.values())
        if rec is None or total > rec["bytes"]:
            self.regions[fn.qualname] = {
                "path": fn.module.path,
                "line": fn.node.lineno,
                "cost": dict(summary.cost),
                "bytes": total,
            }
        return summary

    def instantiate(
        self,
        ci: cg.ClassInfo,
        args: List[object],
        kwargs: Dict[str, object],
        node: Optional[ast.Call],
        caller: Optional[Frame],
        ctx: Ctx,
    ) -> Instance:
        inst = Instance(ci.name)
        init = self.graph.resolve_method(ci.name, "__init__")
        if init is not None:
            self.call_function(init, [inst] + list(args), kwargs, node, caller, ctx)
        return inst

    # -- statements ------------------------------------------------------
    def exec_block(self, stmts: Sequence[ast.stmt], fr: Frame, ctx: Ctx) -> None:
        for stmt in stmts:
            self.exec_stmt(stmt, fr, ctx)
            if isinstance(stmt, ast.If) and _terminates(stmt.body):
                test_v = self._peek_divergence(stmt.test, fr)
                if test_v is not None:
                    # `if divergent: return` — everything after runs on the
                    # OTHER abstract host only
                    ctx = ctx.taint(f"early exit on line {stmt.lineno}", test_v)

    def _peek_divergence(self, test: ast.AST, fr: Frame) -> Optional[bool]:
        """Whether ``test`` is host-divergent under the current env, without
        re-emitting effects (env lookups + divergent-call syntax only).
        Returns via_call or None."""
        via = None
        for sub in ast.walk(test):
            if isinstance(sub, ast.Call) and _divergent_call(sub):
                via = via or False
            elif isinstance(sub, ast.Name):
                v = fr.env.get(sub.id)
                if lat.is_divergent(v):
                    via = via or bool(getattr(v, "via_call", False))
        return via

    def exec_stmt(self, stmt: ast.stmt, fr: Frame, ctx: Ctx) -> None:
        if isinstance(stmt, ast.Assign):
            v = self.eval_expr(stmt.value, fr, ctx)
            for t in stmt.targets:
                self.bind_target(t, v, fr)
        elif isinstance(stmt, ast.AnnAssign):
            if stmt.value is not None:
                self.bind_target(stmt.target, self.eval_expr(stmt.value, fr, ctx), fr)
        elif isinstance(stmt, ast.AugAssign):
            cur = (
                fr.env.get(stmt.target.id, UNKNOWN)
                if isinstance(stmt.target, ast.Name)
                else UNKNOWN
            )
            v = self.binary_transfer(
                [cur, self.eval_expr(stmt.value, fr, ctx)], stmt, fr, ctx
            )
            self.bind_target(stmt.target, v, fr)
        elif isinstance(stmt, ast.Return):
            v = self.eval_expr(stmt.value, fr, ctx) if stmt.value is not None else Const(None)
            fr.rets.append(v)
        elif isinstance(stmt, ast.Expr):
            self.eval_expr(stmt.value, fr, ctx)
        elif isinstance(stmt, ast.If):
            test_v = self.eval_expr(stmt.test, fr, ctx)
            branch_ctx = ctx
            if lat.is_divergent(test_v):
                branch_ctx = ctx.taint(
                    f"branch on line {stmt.lineno}'s host-divergent test",
                    bool(getattr(test_v, "via_call", False)),
                )
            env_before = dict(fr.env)
            cost_before = dict(fr.cost)
            self.exec_block(stmt.body, fr, branch_ctx)
            env_body, cost_body = fr.env, fr.cost
            fr.env = dict(env_before)
            fr.cost = dict(cost_before)
            self.exec_block(stmt.orelse, fr, branch_ctx)
            fr.env = lat.join_env(env_body, fr.env)
            # the arms are mutually exclusive: the region's bound takes the
            # COSTLIER path, never the sum of both
            fr.cost = _costlier_path(cost_before, cost_body, fr.cost)
        elif isinstance(stmt, (ast.While, ast.For, ast.AsyncFor)):
            self.exec_loop(stmt, fr, ctx)
        elif isinstance(stmt, (ast.With, ast.AsyncWith)):
            for item in stmt.items:
                v = self.eval_expr(item.context_expr, fr, ctx)
                if item.optional_vars is not None:
                    self.bind_target(item.optional_vars, v, fr)
            self.exec_block(stmt.body, fr, ctx)
        elif isinstance(stmt, ast.Try):
            env_before = dict(fr.env)
            self.exec_block(stmt.body, fr, ctx)
            merged = fr.env
            cost_body_only = dict(fr.cost)
            best_cost = cost_body_only
            for handler in stmt.handlers:
                fr.env = lat.join_env(env_before, dict(merged))
                fr.cost = dict(cost_body_only)
                if handler.name:
                    fr.env[handler.name] = UNKNOWN
                self.exec_block(handler.body, fr, ctx)
                merged = lat.join_env(merged, fr.env)
                # exceptional arms are mutually exclusive: keep the
                # costliest single arm, never the sum across handlers
                best_cost = _costlier_path(cost_body_only, best_cost, fr.cost)
            fr.env = merged
            fr.cost = dict(best_cost)
            self.exec_block(stmt.orelse, fr, ctx)
            self.exec_block(stmt.finalbody, fr, ctx)
        elif isinstance(stmt, ast.Raise):
            if stmt.exc is not None:
                self.eval_expr(stmt.exc, fr, ctx)
        elif isinstance(stmt, ast.Assert):
            self.eval_expr(stmt.test, fr, ctx)
        elif isinstance(stmt, ast.Delete):
            for t in stmt.targets:
                if isinstance(t, ast.Name):
                    fr.env.pop(t.id, None)
        elif isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            fr.env[stmt.name] = UNKNOWN  # nested defs: their own units
        # Import/Pass/Break/Continue/Global/Nonlocal: no dataflow

    def exec_loop(self, stmt, fr: Frame, ctx: Ctx) -> None:
        """Loop bodies re-interpret to a fixpoint under join. Every
        sub-lattice is flat, so join IS the widening: a binding that
        changes across iterations reaches its top (split → ⊤, dim →
        unknown, kind → UNKNOWN) after one join and the state stabilizes
        within two or three passes (MAX_LOOP_ITERS is the hard cap)."""
        loop_ctx = ctx.in_loop()
        iter_elem = None
        if not isinstance(stmt, ast.While):
            # the iterable expression evaluates ONCE at runtime, outside the
            # iteration context
            iter_v = self.eval_expr(stmt.iter, fr, ctx)
            iter_elem = self._iter_element(iter_v)
        pre = dict(fr.env)
        cost_entry = dict(fr.cost)
        for i in range(MAX_LOOP_ITERS):
            fr.env = dict(pre)
            # the cost model prices ONE interpretation of the body: fixpoint
            # re-runs must not multiply the region bound
            fr.cost = dict(cost_entry)
            body_ctx = loop_ctx
            if isinstance(stmt, ast.While):
                # the test re-evaluates every iteration — a blocking helper
                # in it is exactly the per-iteration fence (H002 counts
                # While tests; so does S102)
                test_v = self.eval_expr(stmt.test, fr, loop_ctx)
                if lat.is_divergent(test_v):
                    body_ctx = loop_ctx.taint(
                        f"while-test on line {stmt.lineno} is host-divergent",
                        bool(getattr(test_v, "via_call", False)),
                    )
            if iter_elem is not None:
                self.bind_target(stmt.target, iter_elem, fr)
            self.exec_block(stmt.body, fr, body_ctx)
            post = fr.env
            new: Dict[str, object] = {}
            for name in set(pre) | set(post):
                if name in pre and name in post:
                    new[name] = lat.join(pre[name], post[name])
                else:
                    new[name] = post.get(name, pre.get(name))
            if new == pre:
                break
            pre = new
        fr.env = pre
        self.exec_block(stmt.orelse, fr, ctx)

    @staticmethod
    def _iter_element(v) -> object:
        if isinstance(v, VTuple):
            if not v.items:
                return UNKNOWN
            elem = v.items[0]
            for i in v.items[1:]:
                elem = lat.join(elem, i)
            return elem
        if isinstance(v, Const) and isinstance(v.value, (tuple, list)):
            vals = [Const(x) for x in v.value]
            return Analyzer._iter_element(VTuple(tuple(vals)))
        if isinstance(v, AbstractArray):
            if v.rank is not None and v.rank > 1:
                return AbstractArray(rank=v.rank - 1, split=TOP, pending=v.pending)
            return UNKNOWN
        return UNKNOWN

    def bind_target(self, target: ast.AST, value, fr: Frame) -> None:
        if isinstance(target, ast.Name):
            fr.env[target.id] = value
        elif isinstance(target, (ast.Tuple, ast.List)):
            items = None
            if isinstance(value, VTuple) and len(value.items) == len(target.elts):
                items = value.items
            for i, elt in enumerate(target.elts):
                self.bind_target(elt, items[i] if items else UNKNOWN, fr)
        elif isinstance(target, ast.Starred):
            self.bind_target(target.value, UNKNOWN, fr)
        elif isinstance(target, ast.Attribute):
            obj = self.eval_expr(target.value, fr, Ctx())
            if isinstance(obj, Instance):
                prev = obj.attrs.get(target.attr)
                obj.attrs[target.attr] = (
                    value if prev is None else lat.join(prev, value)
                )
        # Subscript targets: no tracked store

    # -- expressions -----------------------------------------------------
    def eval_expr(self, node: ast.AST, fr: Frame, ctx: Ctx):
        if node is None:
            return UNKNOWN
        if isinstance(node, ast.Constant):
            return Const(node.value)
        if isinstance(node, ast.Name):
            if node.id in fr.env:
                return fr.env[node.id]
            if node.id == "self" and fr.self_val is not None:
                return fr.self_val
            return UNKNOWN
        if isinstance(node, (ast.Tuple, ast.List)):
            return VTuple(tuple(self.eval_expr(e, fr, ctx) for e in node.elts))
        if isinstance(node, ast.BinOp):
            left = self.eval_expr(node.left, fr, ctx)
            right = self.eval_expr(node.right, fr, ctx)
            if isinstance(node.op, ast.MatMult):
                return self.matmul_transfer([left, right], node, fr, ctx)
            return self.binary_transfer([left, right], node, fr, ctx)
        if isinstance(node, ast.UnaryOp):
            v = self.eval_expr(node.operand, fr, ctx)
            if isinstance(v, AbstractArray):
                return v.with_(pending=True)
            if isinstance(v, Const) and isinstance(node.op, ast.USub) and isinstance(
                v.value, (int, float)
            ):
                return Const(-v.value)
            if lat.is_divergent(v):
                return Scalar(divergent=True, via_call=getattr(v, "via_call", False))
            return Scalar() if isinstance(v, (Const, Scalar)) else UNKNOWN
        if isinstance(node, ast.BoolOp):
            vals = [self.eval_expr(v, fr, ctx) for v in node.values]
            if any(lat.is_divergent(v) for v in vals):
                return Scalar(
                    divergent=True,
                    via_call=any(getattr(v, "via_call", False) for v in vals),
                )
            return Scalar()
        if isinstance(node, ast.Compare):
            vals = [self.eval_expr(node.left, fr, ctx)] + [
                self.eval_expr(c, fr, ctx) for c in node.comparators
            ]
            if len(vals) == 2 and any(isinstance(v, AbstractArray) for v in vals):
                return self.binary_transfer(vals, node, fr, ctx)
            if any(lat.is_divergent(v) for v in vals):
                return Scalar(
                    divergent=True,
                    via_call=any(getattr(v, "via_call", False) for v in vals),
                )
            return Scalar()
        if isinstance(node, ast.Call):
            return self.eval_call(node, fr, ctx)
        if isinstance(node, ast.Attribute):
            return self.eval_attribute(node, fr, ctx)
        if isinstance(node, ast.Subscript):
            base = self.eval_expr(node.value, fr, ctx)
            idx = self.eval_expr(node.slice, fr, ctx)
            if isinstance(base, VTuple):
                i = _const_int(idx)
                if i is not None and -len(base.items) <= i < len(base.items):
                    return base.items[i]
                return UNKNOWN
            if isinstance(base, Const) and isinstance(base.value, (tuple, list)):
                i = _const_int(idx)
                if i is not None and -len(base.value) <= i < len(base.value):
                    return Const(base.value[i])
                return UNKNOWN
            if isinstance(base, AbstractArray):
                # indexing reads (and therefore forces) the payload; the
                # sliced layout is not tracked
                return AbstractArray(rank=None, split=TOP, pending=base.pending)
            return UNKNOWN
        if isinstance(node, ast.IfExp):
            self.eval_expr(node.test, fr, ctx)
            return lat.join(
                self.eval_expr(node.body, fr, ctx), self.eval_expr(node.orelse, fr, ctx)
            )
        if isinstance(node, ast.NamedExpr):
            v = self.eval_expr(node.value, fr, ctx)
            self.bind_target(node.target, v, fr)
            return v
        if isinstance(node, ast.Starred):
            return self.eval_expr(node.value, fr, ctx)
        if isinstance(node, ast.JoinedStr):
            for v in node.values:
                if isinstance(v, ast.FormattedValue):
                    self.eval_expr(v.value, fr, ctx)
            return Scalar()
        if isinstance(node, (ast.ListComp, ast.SetComp, ast.GeneratorExp, ast.DictComp)):
            child = dict(fr.env)
            try:
                for gen in node.generators:
                    self.eval_expr(gen.iter, fr, ctx)
                    self.bind_target(gen.target, UNKNOWN, fr)
                if isinstance(node, ast.DictComp):
                    self.eval_expr(node.key, fr, ctx)
                    self.eval_expr(node.value, fr, ctx)
                else:
                    self.eval_expr(node.elt, fr, ctx)
            finally:
                fr.env = child
            return UNKNOWN
        if isinstance(node, ast.Lambda):
            return UNKNOWN
        if isinstance(node, ast.Dict):
            for k, v in zip(node.keys, node.values):
                if k is not None:
                    self.eval_expr(k, fr, ctx)
                self.eval_expr(v, fr, ctx)
            return UNKNOWN
        if isinstance(node, ast.Slice):
            return UNKNOWN
        return UNKNOWN

    # -- attributes ------------------------------------------------------
    def eval_attribute(self, node: ast.Attribute, fr: Frame, ctx: Ctx):
        v = self.eval_expr(node.value, fr, ctx)
        attr = node.attr
        if isinstance(v, AbstractArray):
            if attr == "T":
                return self._transpose(v)
            if attr == "shape":
                return Const(v.shape) if v.shape is not None and all(
                    d is not None for d in v.shape
                ) else UNKNOWN
            if attr == "split":
                if v.split is TOP:
                    return UNKNOWN
                return Const(v.split)
            if attr == "ndim":
                return Const(v.rank) if v.rank is not None else UNKNOWN
            if attr in ("larray", "parray"):
                # payload access forces the chain (dispatch); under a
                # divergence that crossed a function boundary this is the
                # hazard H001 cannot see
                if ctx.divergent is not None and ctx.via_call:
                    self.emit(
                        "S104",
                        node,
                        fr,
                        f"`.{attr}` forces (and dispatches a possibly "
                        f"collective-bearing program) on a path divergent "
                        f"through a callee's return value ({ctx.divergent}) "
                        "— only some hosts dispatch: mesh deadlock",
                    )
                return v.with_(pending=False)
            if attr in ("comm", "device", "dtype"):
                return Scalar()
            return UNKNOWN
        if isinstance(v, Instance):
            return v.attrs.get(attr, UNKNOWN)
        if isinstance(v, Scalar) and v.divergent:
            return Scalar(divergent=True, via_call=v.via_call)
        return UNKNOWN

    @staticmethod
    def _transpose(v: AbstractArray) -> AbstractArray:
        if v.rank == 2:
            split = v.split
            if isinstance(split, int):
                split = 1 - split
            shape = tuple(reversed(v.shape)) if v.shape is not None else None
            return v.with_(split=split, shape=shape, pending=True)
        return AbstractArray(rank=v.rank, split=TOP, dtype=v.dtype)

    # -- calls -----------------------------------------------------------
    def eval_call(self, node: ast.Call, fr: Frame, ctx: Ctx):
        args = [self.eval_expr(a, fr, ctx) for a in node.args if not isinstance(a, ast.Starred)]
        for a in node.args:
            if isinstance(a, ast.Starred):
                self.eval_expr(a.value, fr, ctx)
        kwargs: Dict[str, object] = {}
        for kw in node.keywords:
            v = self.eval_expr(kw.value, fr, ctx)
            if kw.arg is not None:
                kwargs[kw.arg] = v
        func = node.func

        # host-divergent sources (process identity, wall clock, unseeded RNG)
        if _divergent_call(node):
            return Scalar(divergent=True)

        # builtins: blocking casts, print, structural helpers
        if isinstance(func, ast.Name):
            name = func.id
            if name in _SYNC_BUILTINS:
                if any(isinstance(a, AbstractArray) for a in args):
                    self._blocking(node, fr, ctx, f"`{name}()` host read")
                return Scalar()
            if name == "print":
                if any(isinstance(a, AbstractArray) for a in args):
                    self._blocking(node, fr, ctx, "`print` host read")
                return Const(None)
            if name == "len":
                if args and isinstance(args[0], VTuple):
                    return Const(len(args[0].items))
                if args and isinstance(args[0], Const) and isinstance(
                    args[0].value, (tuple, list, str)
                ):
                    return Const(len(args[0].value))
                return Scalar()
            if name in ("range", "enumerate", "zip", "sorted", "reversed", "list", "tuple"):
                return UNKNOWN
            if name in ("abs", "min", "max", "sum") and args and isinstance(
                args[0], AbstractArray
            ):
                # the numpy-protocol builtins force a host read on heat arrays
                self._blocking(node, fr, ctx, f"`{name}()` host read")
                return Scalar()
            target = self.graph.resolve_name(fr.module, name)
            if isinstance(target, cg.FunctionInfo):
                return self.call_function(target, args, kwargs, node, fr, ctx).ret
            if isinstance(target, cg.ClassInfo):
                return self.instantiate(target, args, kwargs, node, fr, ctx)
            return UNKNOWN

        if not isinstance(func, ast.Attribute):
            return UNKNOWN

        # heat-alias-dotted calls: `ht.mean(...)`, `ht.linalg.qr(...)`
        dotted = dotted_name(func)
        root = dotted.split(".")[0] if dotted else ""
        src = fr.module.imports.get(root)
        if src is not None and src.split(".")[0] == "heat_tpu_torch":
            api_tail = dotted[len(root) + 1:]  # "linalg.qr" / "mean"
            result = self.heat_api(api_tail, args, kwargs, node, fr, ctx)
            if result is not NotImplemented:
                return result
            # not in the op table: try the analyzed source (estimator
            # classes, dataset helpers, example mains)
            full = src + ("." + api_tail if api_tail else "")
            target = self.graph.resolve_dotted(full)
            if isinstance(target, cg.FunctionInfo):
                return self.call_function(target, args, kwargs, node, fr, ctx).ret
            if isinstance(target, cg.ClassInfo):
                return self.instantiate(target, args, kwargs, node, fr, ctx)
            return UNKNOWN

        # receiver-value dispatch
        recv = self.eval_expr(func.value, fr, ctx)
        if isinstance(recv, AbstractArray):
            return self.array_method(recv, func, args, kwargs, node, fr, ctx)
        if isinstance(recv, Instance):
            target = self.graph.resolve_method(recv.cls, func.attr)
            if target is not None:
                return self.call_function(
                    target, [recv] + args, kwargs, node, fr, ctx
                ).ret
            return UNKNOWN

        # syntactic collectives on unknown receivers (comm.allreduce(...))
        if _is_collective_call(node):
            fr.collective = True
            nbytes = None
            for a in args:
                nbytes = lat.logical_bytes(a) if isinstance(a, AbstractArray) else nbytes
                if nbytes:
                    break
            op = last_name(func)
            fr.add_cost(op if op else "collective", nbytes)
            if ctx.divergent is not None and ctx.via_call:
                self.emit(
                    "S104",
                    node,
                    fr,
                    f"collective `{dotted or op}` runs on a path divergent "
                    f"through a callee's return value ({ctx.divergent}): "
                    "hosts that skip this branch never join — mesh deadlock "
                    "(H001 cannot see divergence born in a callee)",
                )
            return UNKNOWN
        if func.attr in ("item", "numpy"):
            # syntactic parity with H001's forcing-method detection: even on
            # an untracked receiver, a force under divergence that crossed a
            # function boundary is the hazard the lint cannot see (blocking
            # is NOT recorded here — S102 stays value-based, like H002's
            # heat-taint requirement)
            if ctx.divergent is not None and ctx.via_call:
                self.emit(
                    "S104",
                    node,
                    fr,
                    f"`.{func.attr}()` forces (and dispatches a possibly "
                    f"collective-bearing program) on a path divergent "
                    f"through a callee's return value ({ctx.divergent}) — "
                    "only some hosts dispatch: mesh deadlock",
                )
            return UNKNOWN
        # module-dotted call into another analyzed (non-heat) module:
        # `import helpers; helpers.step(x)`
        if src is not None and isinstance(func.value, ast.Name):
            target = self.graph.resolve_dotted(f"{src}.{func.attr}")
            if isinstance(target, cg.FunctionInfo):
                return self.call_function(target, args, kwargs, node, fr, ctx).ret
            if isinstance(target, cg.ClassInfo):
                return self.instantiate(target, args, kwargs, node, fr, ctx)
        return UNKNOWN

    def _blocking(self, node: ast.AST, fr: Frame, ctx: Ctx, what: str) -> None:
        fr.blocking = True
        if ctx.divergent is not None and ctx.via_call:
            self.emit(
                "S104",
                node,
                fr,
                f"{what} forces (and dispatches a possibly collective-"
                f"bearing program) on a path divergent through a callee's "
                f"return value ({ctx.divergent}) — a multihost deadlock "
                "hazard H001 cannot see",
            )

    # -- the heat API op table ------------------------------------------
    def heat_api(self, api: str, args, kwargs, node, fr: Frame, ctx: Ctx):
        """Transfer functions for the recognized public API (keyed on the
        trailing name). Returns NotImplemented for names the table does not
        model so the caller can fall back to analyzed-source resolution."""
        name = api.split(".")[-1] if api else ""
        if name in _FACTORIES:
            return self.factory_transfer(name, args, kwargs, node)
        if name in _UNARY_ELEMENTWISE:
            if args and isinstance(args[0], AbstractArray):
                return args[0].with_(pending=True)
            return UNKNOWN
        if name in _BINARY_ELEMENTWISE:
            if len(args) >= 2:
                out = kwargs.get("out")
                res = self.binary_transfer(args[:2], node, fr, ctx)
                if isinstance(out, AbstractArray) and isinstance(res, AbstractArray):
                    self._check_out(res, out, node, fr)
                return res
            return UNKNOWN
        if name == "where":
            if len(args) >= 3:
                return self.binary_transfer(args[:3], node, fr, ctx, opname="where")
            return UNKNOWN
        if name in _REDUCTIONS:
            if args and isinstance(args[0], AbstractArray):
                return self.reduce_transfer(args[0], args[1:], kwargs, node, fr)
            return UNKNOWN
        if name in _CUM_OPS:
            if args and isinstance(args[0], AbstractArray):
                return args[0].with_(pending=True)
            return UNKNOWN
        if name == "resplit":
            if args and isinstance(args[0], AbstractArray):
                axis = args[1] if len(args) > 1 else kwargs.get("axis", Const(None))
                return self.resplit_transfer(args[0], axis, node, fr, inplace=False)
            return UNKNOWN
        if name == "reshape":
            if args and isinstance(args[0], AbstractArray):
                shape = _const_shape(args[1]) if len(args) == 2 else _const_shape(
                    VTuple(tuple(args[1:]))
                )
                new_split = _split_arg(
                    kwargs.get("new_split"), "new_split" in kwargs
                )
                rank = len(shape) if shape else None
                return AbstractArray(
                    rank=rank,
                    split=_norm_split(new_split, rank) if "new_split" in kwargs else TOP,
                    shape=shape,
                    dtype=args[0].dtype,
                )
            return UNKNOWN
        if name == "transpose":
            if args and isinstance(args[0], AbstractArray):
                return self._transpose(args[0])
            return UNKNOWN
        if name in ("concatenate", "vstack", "hstack", "stack", "column_stack"):
            splits = []
            if args and isinstance(args[0], VTuple):
                for item in args[0].items:
                    if isinstance(item, AbstractArray):
                        splits.append(item.split)
            split = splits[0] if splits and all(s == splits[0] for s in splits) else TOP
            return AbstractArray(rank=None, split=split)
        if name in ("flatten", "ravel"):
            return AbstractArray(rank=1, split=TOP)
        if name in ("squeeze", "expand_dims", "atleast_2d", "broadcast_to", "tile", "repeat"):
            return AbstractArray(rank=None, split=TOP)
        if name == "astype":
            if args and isinstance(args[0], AbstractArray):
                return args[0].with_(
                    dtype=_dtype_from_node(node.args[1] if len(node.args) > 1 else None)
                    or args[0].dtype
                )
            return UNKNOWN
        if name == "qr":
            return self.qr_transfer(args, kwargs, node, fr)
        if name == "solve_triangular":
            return self.solve_triangular_transfer(args, kwargs, node, fr)
        if name in ("matmul", "dot"):
            return self.matmul_transfer(args, node, fr, ctx)
        if name == "svd":
            a = lat.as_array(args[0]) if args else None
            if a is None:
                return UNKNOWN
            # svd.py split semantics (reduced form): split-0 -> split-0 U,
            # replicated S/Vh; split-1 -> the mirror image
            if a.split is TOP:
                u_s, s_s, v_s = TOP, TOP, TOP
            elif a.split == 1:
                u_s, s_s, v_s = None, None, 1
            else:
                u_s, s_s, v_s = a.split, None, None
            dt = _promote(a.dtype, "float32")
            k = None
            if a.shape is not None and all(d is not None for d in a.shape):
                k = min(a.shape)
            u = AbstractArray(
                rank=2, split=u_s, dtype=dt,
                shape=(a.shape[0], k) if a.shape is not None and k else None,
            )
            s = AbstractArray(rank=1, split=s_s, dtype=dt, shape=(k,) if k else None)
            vh = AbstractArray(
                rank=2, split=v_s, dtype=dt,
                shape=(k, a.shape[1]) if a.shape is not None and k else None,
            )
            compute_uv = kwargs.get("compute_uv")
            if isinstance(compute_uv, Const) and compute_uv.value is False:
                return s
            return VTuple((u, s, vh))
        if name in ("cholesky", "inv", "lu", "solve", "lstsq", "det", "cg", "lanczos"):
            return AbstractArray(rank=None, split=TOP)
        if name in ("get_comm", "get_device", "seed", "save", "load"):
            return Scalar()
        return NotImplemented

    def _check_out(self, res: AbstractArray, out: AbstractArray, node, fr: Frame) -> None:
        if (
            isinstance(res.split, int)
            and isinstance(out.split, int)
            and res.split != out.split
        ):
            nbytes = lat.logical_bytes(res)
            fr.add_cost("reshard.implicit", nbytes)
            self.emit(
                "S101",
                node,
                fr,
                f"`out=` buffer is split={out.split} but the result's "
                f"dominant split is {res.split}: the store reshards "
                f"implicitly ({self._fmt_bytes(nbytes)} moved with no fault "
                "site, telemetry bytes, or fusion node)",
            )

    @staticmethod
    def _fmt_bytes(nbytes: Optional[int]) -> str:
        if not nbytes:
            return "unknown bytes"
        return f"~{int(nbytes)} B estimated"

    def factory_transfer(self, name: str, args, kwargs, node: ast.Call):
        split_present = "split" in kwargs
        split = _split_arg(kwargs.get("split"), split_present)
        dtype = None
        for kw in node.keywords:
            if kw.arg == "dtype":
                dtype = _dtype_from_node(kw.value)
        shape: Optional[Tuple[int, ...]] = None
        if name.endswith("_like"):
            base = lat.as_array(args[0]) if args else None
            if base is not None:
                shape = base.shape if base.shape and all(
                    d is not None for d in base.shape
                ) else None
                if not split_present:
                    split = base.split
                dtype = dtype or base.dtype
        elif name in ("rand", "randn"):
            dims = [_const_int(a) for a in args]
            if dims and all(d is not None for d in dims):
                shape = tuple(dims)
            dtype = dtype or "float32"
        elif name in ("standard_normal", "normal", "random", "uniform"):
            sv = kwargs.get("shape") or kwargs.get("size")
            if sv is None and args:
                sv = args[-1] if name in ("normal", "uniform") else args[0]
            shape = _const_shape(sv) if sv is not None else None
            dtype = dtype or "float32"
        elif name == "randint":
            sv = kwargs.get("size")
            shape = _const_shape(sv) if sv is not None else None
            dtype = dtype or "int64"
        elif name in ("randperm", "permutation"):
            n = _const_int(args[0]) if args else None
            shape = (n,) if n is not None else None
            dtype = dtype or "int64"
        elif name == "arange":
            vals = [_const_int(a) for a in args]
            if vals and all(v is not None for v in vals):
                if len(vals) == 1:
                    n = max(0, vals[0])
                elif len(vals) == 2:
                    n = max(0, vals[1] - vals[0])
                else:
                    step = vals[2] or 1
                    n = max(0, _ceil_div(vals[1] - vals[0], step))
                shape = (n,)
            dtype = dtype or "int64"
        elif name in ("linspace", "logspace"):
            n = _const_int(kwargs.get("num")) if "num" in kwargs else (
                _const_int(args[2]) if len(args) > 2 else 50
            )
            shape = (n,) if isinstance(n, int) else None
            dtype = dtype or "float32"
        elif name == "eye":
            s = _const_shape(args[0]) if args else None
            if s is not None:
                shape = (s[0], s[0]) if len(s) == 1 else (s[0], s[1])
            dtype = dtype or "float32"
        elif name in ("array", "asarray"):
            base = lat.as_array(args[0]) if args else None
            if base is not None:
                shape = base.shape if base.shape and all(
                    d is not None for d in base.shape
                ) else None
            elif args and isinstance(args[0], (Const, VTuple)):
                shape = _const_shape(args[0])
            dtype = dtype or (base.dtype if base is not None else None)
        elif name == "full":
            shape = _const_shape(args[0]) if args else None
            dtype = dtype or "float32"
        else:  # empty/zeros/ones
            shape = _const_shape(args[0]) if args else None
            dtype = dtype or "float32"
        rank = len(shape) if shape is not None else None
        return AbstractArray(
            rank=rank,
            split=_norm_split(split, rank),
            shape=shape,
            dtype=dtype,
            pending=True,
            device="mesh",
        )

    # -- the split-dominance transfer (S101 lives here) ------------------
    def binary_transfer(self, ops, node, fr: Frame, ctx: Ctx, opname: str = "") -> object:
        arrays = [v for v in ops if isinstance(v, AbstractArray)]
        if not arrays:
            # constant folding for shape arithmetic; divergence propagates
            if all(isinstance(v, Const) for v in ops) and isinstance(node, ast.BinOp):
                try:
                    l, r = ops[0].value, ops[1].value
                    op = node.op
                    if isinstance(op, ast.Add):
                        return Const(l + r)
                    if isinstance(op, ast.Sub):
                        return Const(l - r)
                    if isinstance(op, ast.Mult):
                        return Const(l * r)
                    if isinstance(op, ast.FloorDiv):
                        return Const(l // r)
                    if isinstance(op, ast.Mod):
                        return Const(l % r)
                    if isinstance(op, ast.Pow):
                        return Const(l ** r)
                    if isinstance(op, ast.Div):
                        return Const(l / r)
                except Exception:
                    return Scalar()
            if any(lat.is_divergent(v) for v in ops):
                return Scalar(
                    divergent=True,
                    via_call=any(getattr(v, "via_call", False) for v in ops),
                )
            return Scalar() if all(isinstance(v, (Const, Scalar)) for v in ops) else UNKNOWN

        # output rank/shape from broadcasting
        shapes = [a.shape for a in arrays]
        out_shape = shapes[0]
        for s in shapes[1:]:
            out_shape = lat.bcast_shape(out_shape, s)
        ranks = [a.rank for a in arrays]
        out_rank = None
        if all(r is not None for r in ranks):
            out_rank = max(ranks)
        if out_shape is not None:
            out_rank = len(out_shape)

        def adjusted(a: AbstractArray) -> lat.Split:
            s = _norm_split(a.split, a.rank)
            if not isinstance(s, int):
                return s
            if a.rank is None or out_rank is None:
                return TOP
            return s + (out_rank - a.rank)

        adj = [adjusted(a) for a in arrays]

        # S101: two operands with concrete-but-different distribution axes
        concrete = [
            (a, s) for a, s in zip(arrays, adj) if isinstance(s, int)
        ]
        if len(concrete) >= 2:
            dom_arr, dom_split = concrete[0]
            for other_arr, other_split in concrete[1:]:
                if other_split != dom_split:
                    nbytes = lat.logical_bytes(other_arr)
                    fr.add_cost("reshard.implicit", nbytes)
                    what = f"`{opname}`" if opname else "this operation"
                    self.emit(
                        "S101",
                        node,
                        fr,
                        f"operands meet at {what} with different concrete "
                        f"splits ({dom_split} vs {other_split}): split "
                        f"dominance keeps split={dom_split} and the other "
                        f"side is resharded implicitly, invisible in the "
                        f"source ({self._fmt_bytes(nbytes)} on the wire, "
                        "every call) — make the layout decision explicit "
                        "where it is made",
                    )
                    break

        # split dominance for the result (first operand wins if set)
        out_split: lat.Split = None
        for s in adj:
            if s is TOP:
                out_split = TOP
                break
            if s is not None:
                out_split = s
                break
        dtype = arrays[0].dtype
        for a in arrays[1:]:
            dtype = _promote(dtype, a.dtype)
        if out_split is not None and out_split is not TOP and out_rank is not None:
            if not (0 <= out_split < out_rank):
                out_split = None
        return AbstractArray(
            rank=out_rank,
            split=out_split,
            shape=out_shape,
            dtype=dtype,
            pending=True,
            device="mesh",
        )

    def matmul_transfer(self, ops, node, fr: Frame, ctx: Ctx):
        arrays = [v for v in ops if isinstance(v, AbstractArray)]
        if not arrays:
            return UNKNOWN
        if len(arrays) < 2 or not all(a.rank == 2 for a in arrays):
            return AbstractArray(rank=None, split=TOP)
        a, b = arrays[0], arrays[1]
        # linalg/basics.py matmul case table: a row-split left operand yields
        # a row-split product, a column-split right operand a column-split
        # product; contraction-axis splits psum
        if a.split is TOP or b.split is TOP:
            split: lat.Split = TOP
        elif a.split == 0:
            split = 0
        elif b.split == 1:
            split = 1
        else:
            split = None
        shape = None
        if a.shape is not None and b.shape is not None:
            shape = (a.shape[0], b.shape[1])
        dtype = _promote(a.dtype, b.dtype)
        out = AbstractArray(rank=2, split=split, shape=shape, dtype=dtype)
        if (a.split == 1 or b.split == 0) and self.p > 1:
            # contraction-axis split: the partial products psum (the case
            # table's reduce combos) — lower-bounded at the result bytes
            fr.add_cost("reduce.psum", lat.logical_bytes(out) or 0)
        return out

    def reduce_transfer(self, x: AbstractArray, rest, kwargs, node, fr: Frame):
        axis_v = kwargs.get("axis", rest[0] if rest else Const(None))
        keepdims = kwargs.get("keepdims", Const(False))
        keep = isinstance(keepdims, Const) and bool(keepdims.value)
        axes: Optional[Tuple[int, ...]] = None
        if isinstance(axis_v, Const):
            if axis_v.value is None:
                axes = None
            elif isinstance(axis_v.value, int):
                axes = (axis_v.value,)
            elif isinstance(axis_v.value, (tuple, list)):
                axes = tuple(axis_v.value)
            else:
                return AbstractArray(rank=None, split=TOP, dtype=x.dtype)
        elif isinstance(axis_v, VTuple):
            dims = [_const_int(i) for i in axis_v.items]
            if all(d is not None for d in dims):
                axes = tuple(dims)
            else:
                return AbstractArray(rank=None, split=TOP, dtype=x.dtype)
        else:
            return AbstractArray(rank=None, split=TOP, dtype=x.dtype)
        if axes is not None and x.rank is not None:
            axes = tuple(a % x.rank for a in axes)
        split = x.split
        crosses = False
        if split is None:
            out_split: lat.Split = None
        elif axes is None:
            out_split = None
            crosses = isinstance(split, int) or split is TOP
        elif split is TOP:
            out_split = TOP
            crosses = True  # may cross: cost as a lower bound stays 0
        elif split in axes:
            out_split = None
            crosses = True
        elif keep:
            out_split = split
        else:
            out_split = split - sum(1 for a in axes if a < split)
        # shape bookkeeping
        shape = None
        if x.shape is not None and x.rank is not None:
            if axes is None:
                shape = (1,) * x.rank if keep else ()
            else:
                dims = list(x.shape)
                for a in sorted(set(axes), reverse=True):
                    if keep:
                        dims[a] = 1
                    else:
                        del dims[a]
                shape = tuple(dims)
        rank = len(shape) if shape is not None else None
        out = AbstractArray(
            rank=rank, split=out_split, shape=shape, dtype=x.dtype, pending=True
        )
        if crosses and isinstance(x.split, int) and self.p > 1:
            # a split-crossing reduction psums its RESULT inside the fused
            # program — the lower bound the cost model prices
            fr.add_cost("reduce.psum", lat.logical_bytes(out) or 0)
        return out

    def resplit_transfer(
        self, x: AbstractArray, axis_v, node, fr: Frame, inplace: bool
    ) -> AbstractArray:
        axis: lat.Split
        if isinstance(axis_v, Const):
            axis = axis_v.value if axis_v.value is None or isinstance(axis_v.value, int) else TOP
        else:
            axis = TOP
        axis = _norm_split(axis, x.rank)
        x = x.with_(split=_norm_split(x.split, x.rank))
        if axis is None and isinstance(x.split, int):
            nbytes = lat.logical_bytes(x)
            fr.add_cost("reshard", nbytes)
            fr.collective = True
            self.emit(
                "S103",
                node,
                fr,
                f"resplit to None of a value inferred split={x.split}: the "
                f"result is replicated ({self._fmt_bytes(nbytes)} allgathered, "
                "O(n) per-host memory) on a path where the sharded layout "
                "was available",
            )
        elif isinstance(axis, int) and isinstance(x.split, int) and axis != x.split:
            fr.add_cost("reshard", lat.logical_bytes(x))
            fr.collective = True
        elif axis is TOP and isinstance(x.split, int):
            fr.collective = True
        return x.with_(split=axis, pending=True)

    # -- declared linalg schedules (mirrors of the runtime's formulas) ---
    def qr_transfer(self, args, kwargs, node, fr: Frame):
        a = lat.as_array(args[0]) if args else None
        method = kwargs.get("method", Const("auto"))
        method = method.value if isinstance(method, Const) else "auto"
        q_split = a.split if a is not None else TOP
        r_split: lat.Split = None
        if (
            a is not None
            and a.shape is not None
            and len(a.shape) == 2
            and all(d is not None for d in a.shape)
            and isinstance(a.split, (int, type(None)))
        ):
            m, n = a.shape
            p = self.p
            item = lat.itemsize(a.dtype)
            acc = lat.itemsize(_promote(a.dtype, "float32"))
            # routing mirror of core/linalg/qr.py::qr
            took_cholqr2 = False
            if method in ("auto", "cholqr2") and (
                method == "cholqr2"
                or (m >= 2 * n and n * n <= (1 << 22) and a.split != 1)
            ):
                if a.split == 0 and p > 1:
                    # CholeskyQR2: two passes psum one (n, n) Gram partial
                    fr.add_cost("allreduce", 2 * n * n * acc)
                    fr.collective = True
                took_cholqr2 = True
            if not took_cholqr2:
                if a.split == 0 and p > 1 and m >= n and _ceil_div(m, p) >= n:
                    # TSQR: one all_gather of the p (k1, n) R factors
                    k1 = min(_ceil_div(m, p), n)
                    fr.add_cost("allgather", p * k1 * n * item)
                    fr.collective = True
                elif a.split == 1 and p > 1 and m >= n:
                    # panel loop: per panel one (m, c) Q bcast + (c, c) R
                    c = n // p
                    if c:
                        fr.add_cost("bcast", p * (m * c + c * c) * item)
                        fr.collective = True
                    r_split = 1
        elif a is not None and a.split == 1:
            r_split = 1
        q = AbstractArray(
            rank=2,
            split=q_split,
            shape=a.shape if a is not None else None,
            dtype=_promote(a.dtype if a is not None else None, "float32"),
        )
        r = AbstractArray(rank=2, split=r_split, dtype=q.dtype)
        return VTuple((q, r))

    def solve_triangular_transfer(self, args, kwargs, node, fr: Frame):
        A = lat.as_array(args[0]) if args else None
        b = lat.as_array(args[1]) if len(args) > 1 else None
        out_rank = b.rank if b is not None else None
        if (
            A is not None
            and isinstance(A.split, int)
            and self.p > 1
            and A.shape is not None
            and all(d is not None for d in A.shape)
        ):
            n = A.shape[0]
            p = self.p
            rows_loc = _ceil_div(n, p)
            n_stages = min(p, n)
            k = 1
            if b is not None and b.rank == 2 and b.shape is not None and b.shape[1]:
                k = b.shape[1]
            acc = lat.itemsize(_promote(_promote(A.dtype, b.dtype if b else None), "float32"))
            # one psum of one solved (rows_loc, k) block per stage
            fr.add_cost("allreduce", n_stages * rows_loc * k * acc)
            fr.collective = True
        return AbstractArray(rank=out_rank, split=b.split if b is not None else TOP)

    # -- array methods ---------------------------------------------------
    def array_method(
        self, recv: AbstractArray, func: ast.Attribute, args, kwargs, node, fr: Frame, ctx: Ctx
    ):
        name = func.attr
        if name in _BLOCKING_METHODS:
            self._blocking(node, fr, ctx, f"`.{name}()` host read")
            if isinstance(func.value, ast.Name):
                fr.env[func.value.id] = recv.with_(pending=False)
            return Scalar()
        if name in _REDUCTIONS:
            return self.reduce_transfer(recv, args, kwargs, node, fr)
        if name in _CUM_OPS:
            return recv.with_(pending=True)
        if name in _UNARY_ELEMENTWISE:
            return recv.with_(pending=True)
        if name in _BINARY_ELEMENTWISE and args:
            return self.binary_transfer([recv] + args[:1], node, fr, ctx)
        if name == "resplit_" or name == "resplit":
            axis_v = args[0] if args else kwargs.get("axis", Const(None))
            out = self.resplit_transfer(recv, axis_v, node, fr, inplace=name == "resplit_")
            if name == "resplit_" and isinstance(func.value, ast.Name):
                fr.env[func.value.id] = out
            return out
        if name == "astype":
            dtype = _dtype_from_node(node.args[0] if node.args else None)
            return recv.with_(dtype=dtype or recv.dtype, pending=True)
        if name == "reshape":
            shape = _const_shape(args[0]) if len(args) == 1 else _const_shape(
                VTuple(tuple(args))
            )
            return AbstractArray(
                rank=len(shape) if shape else None,
                split=TOP,
                shape=shape,
                dtype=recv.dtype,
            )
        if name == "transpose":
            return self._transpose(recv)
        if name in ("flatten", "ravel"):
            return AbstractArray(rank=1, split=TOP, dtype=recv.dtype)
        if name in ("balance_", "redistribute_"):
            return recv
        if name == "copy":
            return recv
        if name in ("get_halo",):
            fr.collective = True
            return Const(None)
        if name == "tolist":
            self._blocking(node, fr, ctx, "`.tolist()` host read")
            return UNKNOWN
        return UNKNOWN


# ----------------------------------------------------------------------
# entry points
# ----------------------------------------------------------------------
def _wanted_rules(rules) -> Optional[set]:
    if rules is None:
        return None
    wanted = (
        {r.strip().upper() for r in rules.split(",") if r.strip()}
        if isinstance(rules, str)
        else {r.strip().upper() for r in rules}
    )
    unknown = wanted - set(_RULE_BY_ID)
    if unknown:
        from .engine import LintError

        raise LintError(f"unknown rule id(s): {sorted(unknown)}")
    return wanted


def _finalize(an: Analyzer, graph: cg.CallGraph, rules=None) -> List[Finding]:
    wanted = _wanted_rules(rules)
    findings = [
        f for f in an.findings.values() if wanted is None or f.rule in wanted
    ]
    by_path: Dict[str, List[Finding]] = {}
    for f in findings:
        by_path.setdefault(f.path, []).append(f)
    for path, fs in by_path.items():
        mod = graph.modules.get(path)
        if mod is None:
            continue
        sup = _suppressions(mod.lines)
        if sup:
            for f in fs:
                f.suppressed = _is_suppressed(f, sup, mod.lines)
    findings.sort(key=lambda f: (f.path, f.line, f.col, f.rule))
    return findings


def verify_paths(
    paths,
    mesh_size: int = DEFAULT_MESH_SIZE,
    rules=None,
    budgets: Optional[Dict[str, int]] = None,
) -> Tuple[List[Finding], dict]:
    """Run the distribution-flow verifier over every ``.py`` file under
    ``paths``. Returns ``(findings, stats)``: engine-compatible
    :class:`Finding` objects (suppressions resolved, S1xx namespace) and a
    stats dict with per-region static cost bounds. ``budgets`` maps region
    globs to byte ceilings (S105). Pure standard library — never initializes
    a backend, never forces a chain."""
    graph = cg.build(paths)
    return _verify_graph(graph, mesh_size=mesh_size, rules=rules, budgets=budgets)


def verify_source(
    src: str,
    path: str = "<string>",
    mesh_size: int = DEFAULT_MESH_SIZE,
    rules=None,
    budgets: Optional[Dict[str, int]] = None,
    extra_sources: Optional[Dict[str, str]] = None,
) -> Tuple[List[Finding], dict]:
    """Verify one in-memory source (tests, drift workloads)."""
    sources = {path: src}
    if extra_sources:
        sources.update(extra_sources)
    graph = cg.build_from_sources(sources)
    return _verify_graph(graph, mesh_size=mesh_size, rules=rules, budgets=budgets)


def _verify_graph(graph, mesh_size, rules=None, budgets=None):
    _wanted_rules(rules)  # validate before paying for the analysis
    an = Analyzer(graph, mesh_size=mesh_size)
    for mod in graph.modules.values():
        an.analyze_module(mod)
    # default-context pass over every function, callees before callers so
    # context-capped summaries are already warm
    for scc in graph.sccs():
        for fn in scc:
            an.analyze_function(fn)
    findings = _finalize(an, graph, rules=rules)
    if budgets:
        findings.extend(_budget_findings(an, graph, budgets, rules))
        findings.sort(key=lambda f: (f.path, f.line, f.col, f.rule))
    regions = {
        name: rec for name, rec in sorted(an.regions.items()) if rec["bytes"] > 0
    }
    stats = {
        "mesh_size": an.p,
        "modules": len(graph.modules),
        "functions": len(graph.all_functions()),
        "contexts": len(an.summaries),
        "regions": regions,
        # region bounds OVERLAP by construction (a caller's bound merges its
        # callees'), so the total sums only the module-level regions — each
        # module's top-to-bottom execution, callees included exactly once
        "total_bytes": sum(
            rec["bytes"] for name, rec in regions.items() if name.endswith("::<module>")
        ),
    }
    return findings, stats


def _budget_findings(an: Analyzer, graph, budgets: Dict[str, int], rules=None) -> List[Finding]:
    wanted = _wanted_rules(rules)
    if wanted is not None and "S105" not in wanted:
        return []
    out: List[Finding] = []
    for pattern, ceiling in budgets.items():
        for region, rec in sorted(an.regions.items()):
            if not (
                fnmatch.fnmatch(region, pattern)
                or fnmatch.fnmatch(region.split("::")[-1], pattern)
            ):
                continue
            if rec["bytes"] <= ceiling:
                continue
            mod = graph.modules.get(rec["path"])
            lines = mod.lines if mod is not None else []
            line = rec["line"]
            f = Finding(
                rule="S105",
                path=rec["path"],
                line=line,
                col=0,
                severity="error",
                message=(
                    f"region `{region}` has a static bytes-on-wire lower "
                    f"bound of {rec['bytes']} B ({_fmt_cost(rec['cost'])}), "
                    f"over the {int(ceiling)} B budget for pattern "
                    f"{pattern!r}"
                ),
                hint=_RULE_BY_ID["S105"].hint,
                source=(lines[line - 1].strip() if 0 < line <= len(lines) else ""),
            )
            sup = _suppressions(lines) if lines else {}
            if sup:
                f.suppressed = _is_suppressed(f, sup, lines)
            out.append(f)
    return out


def _fmt_cost(cost: Dict[str, int]) -> str:
    return ", ".join(f"{op}: {b} B" for op, b in sorted(cost.items())) or "no collectives"


_BUDGET_SUFFIX = {"": 1, "B": 1, "KIB": 1 << 10, "MIB": 1 << 20, "GIB": 1 << 30,
                  "K": 1 << 10, "M": 1 << 20, "G": 1 << 30}


def parse_budget_arg(spec: str) -> Tuple[str, int]:
    """``GLOB=BYTES`` with optional KiB/MiB/GiB suffixes ->
    ``(glob, bytes)``."""
    if "=" not in spec:
        raise ValueError(f"budget {spec!r} is not GLOB=BYTES")
    glob, raw = spec.rsplit("=", 1)
    m = re.fullmatch(r"\s*([0-9.]+)\s*([A-Za-z]*)\s*", raw)
    if not m or m.group(2).upper() not in _BUDGET_SUFFIX:
        raise ValueError(f"budget bytes {raw!r} not understood (use e.g. 4096, 2MiB)")
    return glob.strip(), int(float(m.group(1)) * _BUDGET_SUFFIX[m.group(2).upper()])


# ----------------------------------------------------------------------
# the drift check: static estimates vs telemetry-observed bytes
# ----------------------------------------------------------------------
#: drift workloads: real collective-bearing computations whose observed
#: bytes telemetry records (the declared linalg schedules), written as
#: analyzable source so the SAME text feeds the abstract interpreter and a
#: live run. Shapes are baked per mesh size by :func:`workload_source`.
DRIFT_WORKLOADS: Dict[str, str] = {
    # CholeskyQR2's two Gram psums: allreduce 2 * n^2 * 4 bytes
    "qr_cholqr2": """
import heat_tpu_torch as ht
ht.random.seed(7)
a = ht.random.randn({m}, {n}, split=0)
q, r = ht.linalg.qr(a, method="cholqr2")
""",
    # TSQR's R-factor gather: allgather p * min(m/p, n) * n * 4 bytes
    "qr_tsqr": """
import heat_tpu_torch as ht
ht.random.seed(8)
a = ht.random.randn({m}, {n2}, split=0)
q, r = ht.linalg.qr(a, method="tsqr")
""",
    # blocked substitution: one (rows_loc, 1) psum per stage
    "solve_triangular": """
import heat_tpu_torch as ht
A = ht.eye({ns}, split=0)
b = ht.ones(({ns},), split=0)
x = ht.linalg.solve_triangular(A, b, lower=True)
""",
}


def _workload_params(p: int) -> Dict[str, int]:
    return {"m": 64 * p, "n": 16, "n2": 12, "ns": 40 * p}


def workload_source(name: str, mesh_size: int) -> str:
    """The drift workload's source with shapes baked for ``mesh_size``."""
    return DRIFT_WORKLOADS[name].format(**_workload_params(max(1, mesh_size)))


def static_workload_bytes(name: str, mesh_size: int) -> Dict[str, int]:
    """The cost model's per-collective-type byte estimate for one drift
    workload — pure static analysis of the workload source."""
    src = workload_source(name, mesh_size)
    graph = cg.build_from_sources({f"<workload:{name}>": src})
    an = Analyzer(graph, mesh_size=mesh_size)
    for mod in graph.modules.values():
        an.analyze_module(mod)
    cost: Dict[str, int] = {}
    # module-level regions only: a caller's bound already merges its
    # callees', so summing function regions too would double-count any
    # workload that grows a helper
    for region, rec in an.regions.items():
        if not region.endswith("::<module>"):
            continue
        for op, b in rec["cost"].items():
            if op in OBSERVED_OPS:
                cost[op] = cost.get(op, 0) + b
    return cost


def observed_workload_bytes(name: str) -> Dict[str, int]:
    """Run one drift workload live under telemetry and return the observed
    per-collective-type bytes. The only function here that computes."""
    from heat_tpu_torch.core import telemetry

    src = workload_source(name, _current_mesh_size())
    with telemetry.enabled():
        before = {
            op: rec.get("bytes", 0) for op, rec in telemetry.collectives().items()
        }
        exec(compile(src, f"<workload:{name}>", "exec"), {"__name__": "__drift__"})
        after = telemetry.collectives()
    out: Dict[str, int] = {}
    for op, rec in after.items():
        if op not in OBSERVED_OPS:
            continue
        delta = rec.get("bytes", 0) - before.get(op, 0)
        if delta > 0:
            out[op] = delta
    return out


def _current_mesh_size() -> int:
    import heat_tpu_torch as ht

    return int(ht.get_comm().size)


def drift_report(workloads=None) -> dict:
    """Static-vs-observed byte drift over the drift workloads at the CURRENT
    mesh (initializes the backend). ``ratio`` is max(static, observed) /
    min(...); the acceptance bound is :data:`DRIFT_FACTOR`."""
    p = _current_mesh_size()
    doc = {"mesh_size": p, "workloads": {}}
    for name in workloads or DRIFT_WORKLOADS:
        static = static_workload_bytes(name, p)
        observed = observed_workload_bytes(name)
        doc["workloads"][name] = _drift_entry(static, observed)
    return doc


def _drift_entry(static: Dict[str, int], observed: Dict[str, int]) -> dict:
    s_total = sum(static.values())
    o_total = sum(observed.values())
    entry = {
        "static": static,
        "observed": observed,
        "static_total": s_total,
        "observed_total": o_total,
    }
    if s_total and o_total:
        entry["ratio"] = round(max(s_total, o_total) / min(s_total, o_total), 3)
        entry["drift_pct"] = round(100.0 * abs(s_total - o_total) / o_total, 1)
        entry["within_bound"] = entry["ratio"] <= DRIFT_FACTOR
    elif s_total == o_total:  # both zero (single-device mesh): no drift
        entry["ratio"] = 1.0
        entry["drift_pct"] = 0.0
        entry["within_bound"] = True
    else:
        # one side zero: incomparable — None (not float inf, which would
        # serialize as non-standard JSON `Infinity` in the saved artifact)
        entry["ratio"] = None
        entry["drift_pct"] = None
        entry["within_bound"] = False
    return entry


def compare_observed(report: dict) -> dict:
    """Diff static estimates against a SAVED observed report (the
    ``verify --observed`` path — fully static, no device). The report is the
    :func:`drift_report`/``--save-observed`` JSON shape: its recorded
    mesh_size drives the static formulas."""
    p = int(report.get("mesh_size", DEFAULT_MESH_SIZE))
    doc = {"mesh_size": p, "workloads": {}}
    for name, rec in report.get("workloads", {}).items():
        if name not in DRIFT_WORKLOADS:
            continue
        observed = {
            op: int(b) for op, b in (rec.get("observed") or rec.get("collectives") or {}).items()
        }
        static = static_workload_bytes(name, p)
        doc["workloads"][name] = _drift_entry(static, observed)
    return doc
