"""The SPMD hazard rules (H001–H005).

Heat's SPMD contract — every host runs the same script, one ``split`` axis
expresses distribution, forcing is asynchronous — makes a class of
production-killing bugs *structural*, visible in the AST long before a pod
hangs. Each rule encodes one hazard (doc/internals_distribution.md "The SPMD
hazard model" is the narrative version):

========  ============================================================
H001      collective/forcing call reachable only under host-divergent
          control flow (``process_index()``/``io_owner()``/wall-clock/
          unseeded randomness): some hosts enter the collective, the
          rest never show up — the whole mesh deadlocks.
H002      implicit blocking sync inside a loop (``.item()``/``.numpy()``/
          ``float()``/``print`` of a heat value per iteration): every
          iteration fences the async-forcing pipeline.
H003      bare ``except Exception`` swallowing at a collective/fusion/io
          seam instead of routing through
          ``resilience.record_recoverable`` (or narrowing the type):
          real faults vanish into silent wrong-path fallbacks.
H004      per-call lambda/closure passed to ``fusion.record``/
          ``comm.apply``: the function identity churns every call, so
          the program cache misses forever (every call pays a fresh
          program build).
H005      declared collective schedule or reshard path without its
          ``resilience.check("collective.*")`` fault site: the fault
          harness cannot reach the seam, so recovery there is untested.
========  ============================================================

Detection is deliberately *local and conservative*: rules resolve import
aliases of the ``heat_tpu_torch`` namespace, run a small per-function taint pass
(H001: host-divergent values; H002: heat-produced values) and otherwise
require syntactic evidence. Anything cleverer belongs in the program auditor
(:mod:`heat_tpu_torch.analysis.audit`), which reasons about the recorded
*program* instead of the source, or in the distribution-flow verifier
(:mod:`heat_tpu_torch.analysis.dataflow`, rules S101-S105), which interprets the
source *semantically* — interprocedurally, over the split lattice — and
reuses this module's syntactic vocabulary (:func:`dotted_name`,
:func:`_divergent_call`, :func:`_is_collective_call`) so the two passes
agree on what a divergence source and a collective call look like.
"""

from __future__ import annotations

import ast
from dataclasses import dataclass, field
from typing import Dict, Iterator, List, Optional, Sequence, Set, Tuple

__all__ = ["ModuleContext", "Rule", "RULES", "rule_table"]


# ----------------------------------------------------------------------
# shared AST helpers
# ----------------------------------------------------------------------
def dotted_name(node: ast.AST) -> str:
    """``a.b.c`` for Name/Attribute chains; call roots render as ``f()``
    (so ``get_comm().apply`` -> ``get_comm().apply``). Empty when the root
    is not nameable (subscripts, literals)."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
    elif isinstance(node, ast.Call):
        inner = dotted_name(node.func)
        if not inner:
            return ""
        parts.append(inner + "()")
    else:
        return ""
    return ".".join(reversed(parts))


def last_name(node: ast.AST) -> str:
    if isinstance(node, ast.Attribute):
        return node.attr
    if isinstance(node, ast.Name):
        return node.id
    return ""


def _assigned_names(target: ast.AST) -> Iterator[str]:
    if isinstance(target, ast.Name):
        yield target.id
    elif isinstance(target, (ast.Tuple, ast.List)):
        for elt in target.elts:
            yield from _assigned_names(elt)
    elif isinstance(target, ast.Starred):
        yield from _assigned_names(target.value)


def _function_units(tree: ast.Module):
    """The analysis units: the module top level (examples are scripts!) and
    every function/method body, each yielded as (name, body_statements)."""
    yield "<module>", tree.body
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            yield node.name, node.body


def unit_walk(stmts: Sequence[ast.stmt]) -> Iterator[ast.AST]:
    """``ast.walk`` over a statement list WITHOUT descending into nested
    function/class definitions — each of those is its own analysis unit
    (walking into them here would double-report and cross-taint)."""
    stack: List[ast.AST] = list(stmts)
    while stack:
        node = stack.pop()
        yield node
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef, ast.Lambda)):
            continue  # yielded (so rules can see it) but never expanded
        stack.extend(ast.iter_child_nodes(node))


@dataclass
class ModuleContext:
    """Everything a rule needs about one module: the tree, the raw source
    lines, the path, and the resolved root aliases of the ``heat_tpu_torch``
    namespace (``import heat_tpu_torch as ht`` / ``from heat_tpu_torch import ...``)."""

    tree: ast.Module
    lines: Sequence[str]
    path: str
    heat_aliases: Set[str] = field(default_factory=set)

    def __post_init__(self):
        # only whole-package imports (``import heat_tpu_torch as ht``) seed the
        # H002 taint: that is how user scripts hold the array API, and it
        # keeps ``from heat_tpu_torch.core import <internals>`` plumbing (which
        # mostly returns non-array values) from polluting the heuristic
        for node in ast.walk(self.tree):
            if isinstance(node, ast.Import):
                for alias in node.names:
                    if alias.name.split(".")[0] == "heat_tpu_torch":
                        self.heat_aliases.add((alias.asname or alias.name).split(".")[0])


@dataclass
class Rule:
    id: str
    severity: str
    title: str
    rationale: str
    hint: str
    checker: object = None

    def run(self, ctx: ModuleContext) -> Iterator[Tuple[int, int, str]]:
        return self.checker(ctx)


# ----------------------------------------------------------------------
# H001 — collectives/forcing under host-divergent control flow
# ----------------------------------------------------------------------
#: call names (last attribute) whose result differs across controller
#: processes of one SPMD job
_DIVERGENT_LAST = {"process_index", "io_owner", "getpid", "gethostname"}
#: dotted forms for wall-clock reads (``time`` alone is too generic)
_DIVERGENT_DOTTED = {
    "time.time",
    "time.time_ns",
    "time.perf_counter",
    "time.perf_counter_ns",
    "time.monotonic",
    "datetime.now",
    "datetime.datetime.now",
    "os.getpid",
    "socket.gethostname",
}
#: the stdlib/numpy GLOBAL RNGs draw from per-process state — unseeded by
#: construction. (`random.Random(seed)` / `np.random.default_rng(seed)`
#: objects are fine and not matched.)
_DIVERGENT_RNG_ROOTS = ("random.", "np.random.", "numpy.random.")

#: mesh-spanning calls: if only SOME hosts reach one, the others never join
_COLLECTIVE_LAST = {
    "allreduce",
    "allgather",
    "alltoall",
    "ppermute",
    "exscan",
    "psum",
    "pmean",
    "pmax",
    "pmin",
    "all_gather",
    "all_to_all",
    "reduce_scatter",
    "sync_processes",
    "sync_global_devices",
    "resplit",
    "resplit_",
}
#: names too generic to match alone — the receiver chain must look like a
#: communication context (``comm.apply``, ``self.comm.bcast``,
#: ``get_comm().scan``)
_COLLECTIVE_COMM_ONLY = {"apply", "bcast", "scan", "barrier"}
#: host boundaries that force (and therefore dispatch) a possibly
#: collective-bearing fused program
_FORCING_ATTRS = {"parray", "larray"}
_FORCING_METHODS = {"item", "numpy"}


def _comm_receiver(func: ast.AST) -> bool:
    dotted = dotted_name(func)
    head = dotted.rsplit(".", 1)[0] if "." in dotted else ""
    return (
        "comm" in head
        or "communication" in head
        or head.endswith("get_comm()")
    )


def _is_collective_call(call: ast.Call) -> bool:
    name = last_name(call.func)
    if name in _COLLECTIVE_LAST:
        return True
    return name in _COLLECTIVE_COMM_ONLY and _comm_receiver(call.func)


def _divergent_call(call: ast.Call) -> bool:
    name = last_name(call.func)
    dotted = dotted_name(call.func)
    if name in _DIVERGENT_LAST or dotted in _DIVERGENT_DOTTED:
        return True
    if dotted.startswith(_DIVERGENT_RNG_ROOTS):
        # global-RNG draws; default_rng(seed)/Random(seed) construction is
        # deterministic and exempt, a bare default_rng() is OS-seeded
        if name in {"default_rng", "Random", "RandomState"}:
            return not call.args and not call.keywords
        return name not in {"seed"}
    return False


def _divergent_names(body: Sequence[ast.stmt]) -> Set[str]:
    """Names in this unit bound (transitively) from a host-divergent call."""
    tainted: Set[str] = set()

    def expr_divergent(expr: ast.AST) -> bool:
        for sub in ast.walk(expr):
            if isinstance(sub, ast.Call) and _divergent_call(sub):
                return True
            if isinstance(sub, ast.Name) and sub.id in tainted:
                return True
        return False

    for _ in range(8):  # tiny fixpoint: assignment chains are short
        changed = False
        for node in unit_walk(body):
            targets = []
            if isinstance(node, ast.Assign):
                targets, value = node.targets, node.value
            elif isinstance(node, (ast.AugAssign, ast.AnnAssign, ast.NamedExpr)):
                targets, value = [node.target], node.value
            else:
                continue
            if value is None or not expr_divergent(value):
                continue
            for t in targets:
                for name in _assigned_names(t):
                    if name not in tainted:
                        tainted.add(name)
                        changed = True
        if not changed:
            break
    return tainted


def _terminates(stmts: Sequence[ast.stmt]) -> bool:
    return bool(stmts) and isinstance(
        stmts[-1], (ast.Return, ast.Raise, ast.Continue, ast.Break)
    )


def _h001(ctx: ModuleContext) -> Iterator[Tuple[int, int, str]]:
    for unit_name, body in _function_units(ctx.tree):
        tainted = _divergent_names(body)

        def test_divergent(expr: ast.AST) -> bool:
            for sub in ast.walk(expr):
                if isinstance(sub, ast.Call) and _divergent_call(sub):
                    return True
                if isinstance(sub, ast.Name) and sub.id in tainted:
                    return True
            return False

        reported: Set[int] = set()

        def hazards(stmt: ast.stmt, why: str) -> Iterator[Tuple[int, int, str]]:
            for sub in ast.walk(stmt):
                if id(sub) in reported:
                    continue
                msg = None
                if isinstance(sub, ast.Call) and _is_collective_call(sub):
                    msg = (
                        f"collective `{dotted_name(sub.func) or last_name(sub.func)}` is "
                        f"reachable only under host-divergent control flow ({why}): hosts "
                        "that skip this branch never join the collective — the mesh "
                        "deadlocks"
                    )
                elif isinstance(sub, ast.Call) and last_name(sub.func) in _FORCING_METHODS:
                    msg = (
                        f"`.{last_name(sub.func)}()` forces (and dispatches a possibly "
                        f"collective-bearing fused program) only under host-divergent "
                        f"control flow ({why}) — a multihost deadlock hazard"
                    )
                elif isinstance(sub, ast.Attribute) and sub.attr in _FORCING_ATTRS:
                    msg = (
                        f"`.{sub.attr}` forcing access under host-divergent control flow "
                        f"({why}): the dispatched program's collectives run on a subset "
                        "of hosts — a multihost deadlock hazard"
                    )
                if msg is not None:
                    reported.add(id(sub))
                    yield sub.lineno, sub.col_offset, msg

        def walk_block(stmts: Sequence[ast.stmt], divergent: Optional[str]) -> Iterator:
            guard: Optional[str] = None  # early-exit divergence within this block
            for stmt in stmts:
                why = divergent or guard
                if isinstance(stmt, (ast.If, ast.While)):
                    branch_why = why
                    if test_divergent(stmt.test):
                        branch_why = branch_why or f"branch on line {stmt.lineno}'s test"
                        # `if owner: return` — everything after runs on the
                        # OTHER hosts only: the rest of this block diverges
                        if isinstance(stmt, ast.If) and _terminates(stmt.body):
                            guard = guard or f"early exit on line {stmt.lineno}"
                    yield from walk_block(stmt.body, branch_why)
                    yield from walk_block(stmt.orelse, branch_why)
                elif isinstance(stmt, (ast.For, ast.AsyncFor)):
                    yield from walk_block(stmt.body, why)
                    yield from walk_block(stmt.orelse, why)
                elif isinstance(stmt, (ast.With, ast.AsyncWith)):
                    yield from walk_block(stmt.body, why)
                elif isinstance(stmt, ast.Try):
                    yield from walk_block(stmt.body, why)
                    for h in stmt.handlers:
                        yield from walk_block(h.body, why)
                    yield from walk_block(stmt.orelse, why)
                    yield from walk_block(stmt.finalbody, why)
                elif isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
                    continue  # nested defs are their own analysis unit
                elif why:
                    yield from hazards(stmt, why)
                # statements *inside* a divergent If/While were handled via
                # the recursive calls above; the If/While line itself (its
                # test) cannot contain a collective worth re-reporting

        yield from walk_block(body, None)


# ----------------------------------------------------------------------
# H002 — implicit blocking syncs inside loops
# ----------------------------------------------------------------------
def _heat_tainted_names(ctx: ModuleContext, body: Sequence[ast.stmt]) -> Set[str]:
    """Names bound (transitively) from the heat_tpu_torch namespace in this unit:
    ``x = ht.mean(a)``; ``y = x + 1``; ``z = y.sum()`` are all tainted."""
    tainted: Set[str] = set()
    if not ctx.heat_aliases:
        return tainted

    def expr_tainted(expr: ast.AST) -> bool:
        for sub in ast.walk(expr):
            if isinstance(sub, ast.Name) and sub.id in tainted:
                return True
            if isinstance(sub, ast.Call):
                root = dotted_name(sub.func).split(".")[0]
                if root in ctx.heat_aliases:
                    return True
        return False

    for _ in range(8):
        changed = False
        for node in unit_walk(body):
            targets = []
            if isinstance(node, ast.Assign):
                targets, value = node.targets, node.value
            elif isinstance(node, (ast.AugAssign, ast.AnnAssign, ast.NamedExpr)):
                targets, value = [node.target], node.value
            elif isinstance(node, (ast.For, ast.AsyncFor)):
                targets, value = [node.target], node.iter
            else:
                continue
            if value is None or not expr_tainted(value):
                continue
            for t in targets:
                for name in _assigned_names(t):
                    if name not in tainted:
                        tainted.add(name)
                        changed = True
        if not changed:
            break
    return tainted


_SYNC_CASTS = {"float", "int", "bool", "complex"}


def _h002(ctx: ModuleContext) -> Iterator[Tuple[int, int, str]]:
    if not ctx.heat_aliases:
        return  # the rule tracks values produced by the heat_tpu_torch namespace
    for unit_name, body in _function_units(ctx.tree):
        tainted = _heat_tainted_names(ctx, body)

        def expr_tainted(expr: ast.AST) -> bool:
            for sub in ast.walk(expr):
                if isinstance(sub, ast.Name) and sub.id in tainted:
                    return True
                if isinstance(sub, ast.Call):
                    root = dotted_name(sub.func).split(".")[0]
                    if root in ctx.heat_aliases:
                        return True
            return False

        def sinks(node: ast.AST) -> Iterator[Tuple[int, int, str]]:
            for sub in unit_walk([node]):
                if not isinstance(sub, ast.Call):
                    continue
                name = last_name(sub.func)
                if (
                    isinstance(sub.func, ast.Attribute)
                    and name in _FORCING_METHODS
                    and expr_tainted(sub.func.value)
                ):
                    yield sub.lineno, sub.col_offset, (
                        f"`.{name}()` on a heat array inside a loop blocks on the device "
                        "every iteration — it forces the pending chain and fences the "
                        "async-forcing pipeline"
                    )
                elif (
                    isinstance(sub.func, ast.Name)
                    and name in _SYNC_CASTS
                    and any(expr_tainted(a) for a in sub.args)
                ):
                    yield sub.lineno, sub.col_offset, (
                        f"`{name}()` of a heat array inside a loop is an implicit blocking "
                        "sync every iteration (scalar host read)"
                    )
                elif (
                    isinstance(sub.func, ast.Name)
                    and name == "print"
                    and any(expr_tainted(a) for a in sub.args)
                ):
                    yield sub.lineno, sub.col_offset, (
                        "`print` of a heat array inside a loop forces and host-reads the "
                        "value every iteration — an implicit blocking sync"
                    )

        seen: Set[Tuple[int, int]] = set()
        for stmt in unit_walk(body):
            if isinstance(stmt, (ast.For, ast.AsyncFor, ast.While)):
                nodes: List[ast.AST] = list(stmt.body)
                if isinstance(stmt, ast.While):
                    nodes.append(stmt.test)  # re-evaluated every iteration
                for node in nodes:
                    for line, col, msg in sinks(node):
                        if (line, col) not in seen:
                            seen.add((line, col))
                            yield line, col, msg


# ----------------------------------------------------------------------
# H003 — bare `except Exception` swallowing at collective/fusion/io seams
# ----------------------------------------------------------------------
_FUSION_SEAM = {
    "record",
    "force",
    "defer_apply",
    "defer_reshard",
    "defer_binary",
    "defer_local",
    "defer_reduce",
    "defer_cum",
}
_IO_SEAM = {
    "open",
    "replace",
    "rename",
    "unlink",
    "remove",
    "rmtree",
    "copy2",
    "copyfile",
    "makedirs",
    "mkdir",
    "memmap",
    "fromfile",
    "tofile",
    "run",  # subprocess.run — the native-toolchain seam
    "call_with_retries",  # the resilience-retried io call wrapper
    "atomic_write",
}
#: placement calls: jax's (the fixtures' vocabulary) and the port's, which
#: cuts a tensor into a mesh's blocks, moves an array's shards or re-forms
#: the default mesh
_SHARDING_SEAM = {
    "device_put", "with_sharding_constraint", "is_equivalent_to",
    "_distribute", "redistribute_", "reform",
}


def _seam_calls(stmts: Sequence[ast.stmt]) -> List[str]:
    out = []
    for stmt in stmts:
        for sub in ast.walk(stmt):
            if isinstance(sub, ast.Call):
                name = last_name(sub.func)
                dotted = dotted_name(sub.func)
                if name in _FUSION_SEAM or name in _SHARDING_SEAM:
                    out.append(dotted or name)
                elif name in _COLLECTIVE_LAST or (
                    name in _COLLECTIVE_COMM_ONLY and _comm_receiver(sub.func)
                ):
                    out.append(dotted or name)
                elif name in _IO_SEAM:
                    if name == "run" and "subprocess" not in dotted:
                        continue
                    out.append(dotted or name)
                elif dotted.startswith("_native.") or "._native" in dotted:
                    out.append(dotted)
            elif isinstance(sub, ast.Attribute) and sub.attr == "distributed":
                out.append(dotted_name(sub))  # distributed-runtime state probe
    return out


def _broad_handler(handler: ast.ExceptHandler) -> bool:
    t = handler.type
    if t is None:
        return True
    names = [last_name(e) for e in t.elts] if isinstance(t, ast.Tuple) else [last_name(t)]
    return any(n in ("Exception", "BaseException") for n in names)


def _handler_accounts(handler: ast.ExceptHandler) -> bool:
    """Whether the handler deals with the failure instead of swallowing it:
    re-raises, routes through the resilience policy, warns, records
    telemetry, or at least *uses* the caught exception object."""
    exc_name = handler.name
    for sub in ast.walk(ast.Module(body=handler.body, type_ignores=[])):
        if isinstance(sub, ast.Raise):
            return True
        if isinstance(sub, ast.Call):
            name = last_name(sub.func)
            if name in (
                "record_recoverable",
                "force_recoverable",
                "record_unfused",
                "record_io_retry",
                "record_fault",
                "warn",
            ):
                return True
        if exc_name and isinstance(sub, ast.Name) and sub.id == exc_name:
            return True
    return False


def _h003(ctx: ModuleContext) -> Iterator[Tuple[int, int, str]]:
    for node in ast.walk(ctx.tree):
        if not isinstance(node, ast.Try):
            continue
        seams = _seam_calls(node.body)
        if not seams:
            continue
        for handler in node.handlers:
            if not _broad_handler(handler) or _handler_accounts(handler):
                continue
            what = "bare `except:`" if handler.type is None else "`except Exception`"
            yield handler.lineno, handler.col_offset, (
                f"{what} silently swallows failures of a "
                f"collective/fusion/io seam (`{seams[0]}`): narrow the exception "
                "type, or route the decision through "
                "`resilience.record_recoverable` so real faults propagate"
            )


# ----------------------------------------------------------------------
# H004 — per-call lambdas/closures into the program-cache seams
# ----------------------------------------------------------------------
def _h004_sink(call: ast.Call) -> Optional[str]:
    name = last_name(call.func)
    dotted = dotted_name(call.func)
    if name == "record" and (dotted == "record" or dotted.endswith("fusion.record")):
        return dotted or "record"
    if name == "defer_apply":
        return dotted or "defer_apply"
    if name == "apply" and _comm_receiver(call.func):
        return dotted or "comm.apply"
    return None


def _h004(ctx: ModuleContext) -> Iterator[Tuple[int, int, str]]:
    # units overlap on nested defs (a closure passed to a sink is visible
    # from its own unit AND every enclosing one — which is what lets the
    # rule see outer-local names); report each argument site exactly once
    reported: Set[Tuple[int, int]] = set()
    for unit_name, body in _function_units(ctx.tree):
        if unit_name == "<module>":
            continue  # module-level lambdas are created once per process
        # names bound per-call: lambdas assigned in this body, and nested defs
        local_fns: Set[str] = set()
        for stmt in body:
            for sub in ast.walk(stmt):
                if isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    local_fns.add(sub.name)
                elif isinstance(sub, ast.Assign) and isinstance(sub.value, ast.Lambda):
                    for t in sub.targets:
                        local_fns.update(_assigned_names(t))
        for stmt in body:
            for sub in ast.walk(stmt):
                if not isinstance(sub, ast.Call):
                    continue
                sink = _h004_sink(sub)
                if sink is None:
                    continue
                for arg in list(sub.args) + [kw.value for kw in sub.keywords]:
                    at = (arg.lineno, arg.col_offset)
                    if at in reported:
                        continue
                    if isinstance(arg, ast.Lambda):
                        reported.add(at)
                        yield at[0], at[1], (
                            f"lambda created per call and passed to `{sink}`: its identity "
                            "keys the program cache, so every call pays a fresh program "
                            "build"
                        )
                    elif isinstance(arg, ast.Name) and arg.id in local_fns:
                        reported.add(at)
                        yield at[0], at[1], (
                            f"`{arg.id}` is defined inside this function and passed to "
                            f"`{sink}`: a fresh closure per call churns the program cache "
                            "(every call pays a fresh program build)"
                        )


# ----------------------------------------------------------------------
# H005 — collective schedule / reshard path without its fault site
# ----------------------------------------------------------------------
_H005_TRIGGERS = {"record_collective", "record_collective_operand", "defer_reshard"}
#: the definitions themselves (telemetry/fusion) are not call sites
_H005_EXEMPT_FUNCS = _H005_TRIGGERS


def _h005(ctx: ModuleContext) -> Iterator[Tuple[int, int, str]]:
    for node in ast.walk(ctx.tree):
        if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        if node.name in _H005_EXEMPT_FUNCS:
            continue
        trigger: Optional[ast.Call] = None
        trigger_name = ""
        guarded = False
        for sub in ast.walk(node):
            if not isinstance(sub, ast.Call):
                continue
            name = last_name(sub.func)
            if name in _H005_TRIGGERS and trigger is None:
                trigger, trigger_name = sub, name
            elif name == "check" and sub.args:
                arg = sub.args[0]
                if isinstance(arg, ast.Constant) and isinstance(arg.value, str) and arg.value.startswith("collective."):
                    guarded = True
            elif name == "check_fault_site":  # future-proof alias
                guarded = True
        if trigger is not None and not guarded:
            yield trigger.lineno, trigger.col_offset, (
                f"`{trigger_name}` declares a collective schedule (or records a "
                "reshard) but the function carries no "
                '`resilience.check("collective.<verb>")` fault site: the fault '
                "harness cannot reach this seam, so its failure path is untestable"
            )


# ----------------------------------------------------------------------
# the registry
# ----------------------------------------------------------------------
RULES: List[Rule] = [
    Rule(
        id="H001",
        severity="error",
        title="collective under host-divergent control flow",
        rationale=(
            "SPMD requires every host to reach every collective; a branch on "
            "process identity, wall-clock or unseeded randomness sends only "
            "some hosts in — the rest wait forever (mesh deadlock)"
        ),
        hint=(
            "hoist the collective/forcing call out of the divergent branch "
            "(compute on all hosts, gate only the pure-file-I/O publication on "
            "io_owner()), or derive the branch from data every host shares"
        ),
        checker=_h001,
    ),
    Rule(
        id="H002",
        severity="warning",
        title="implicit blocking sync inside a loop",
        rationale=(
            "forcing is asynchronous: dispatches install futures and only "
            "host reads block. An .item()/float()/print of a heat value per "
            "iteration re-fences the pipeline every step, serializing the loop "
            "at one dispatch RTT per iteration"
        ),
        hint=(
            "keep per-iteration results recorded and read them once after the "
            "loop; if a per-iteration host read is the point (convergence "
            "checks), suppress with `# heat-lint: disable=H002` + justification"
        ),
        checker=_h002,
    ),
    Rule(
        id="H003",
        severity="warning",
        title="bare except swallowing at a collective/fusion/io seam",
        rationale=(
            "a swallowed seam failure silently reroutes real faults (OOM, dead "
            "host, corrupt file) into wrong-path fallbacks; the resilience layer "
            "owns ONE policy for what may fall back (record_recoverable) and "
            "what must propagate"
        ),
        hint=(
            "narrow the except to the exact failure the fallback handles, or "
            "route through `resilience.record_recoverable(exc)`; if swallowing "
            "IS the contract, add `# heat-lint: disable=H003` with a reason"
        ),
        checker=_h003,
    ),
    Rule(
        id="H004",
        severity="warning",
        title="per-call lambda/closure keys the program cache",
        rationale=(
            "fusion's program cache and the retrace ledger key on function "
            "identity; a lambda or nested def created per call never matches, "
            "so every call pays a fresh program build"
        ),
        hint=(
            "hoist the callable to module level, or build it once through an "
            "lru_cache'd factory (see statistics._var_reduction / "
            "spatial.distance._gaussian_metric) so its identity is stable across calls"
        ),
        checker=_h004,
    ),
    Rule(
        id="H005",
        severity="warning",
        title="collective schedule without its fault-injection site",
        rationale=(
            "every collective verb and reshard path carries a named "
            "resilience.check site so the fault harness can prove what happens "
            "when it fails; a declared schedule without one is a seam the "
            "kill-a-host test can never exercise"
        ),
        hint=(
            'add `if resilience._ARMED: resilience.check("collective.<verb>")` '
            "next to the dispatch the schedule declares (see core/communication"
            ".py's verbs for the pattern)"
        ),
        checker=_h005,
    ),
]


def rule_table() -> List[dict]:
    """The rule registry as documentation-ready dicts (the CLI's ``rules``
    subcommand and the README table source)."""
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
