"""Call graph over the analyzed source set.

The dataflow verifier is *interprocedural*: the hazards it exists to catch
hide behind helper-function boundaries, where the per-module lint cannot
see them. This module owns the indexing that makes cross-module
reasoning possible while staying pure standard library:

* parse every ``.py`` file under the given paths into a :class:`ModuleInfo`
  (tree, lines, import alias map, top-level functions, classes + methods);
* resolve names — ``from .basics import dot`` to the analyzed ``dot``,
  ``ht.cluster.KMeans`` through the ``heat_tpu_torch`` alias to the analyzed
  class, ``self.fit_predict`` through the (name-resolved) class hierarchy;
* provide best-effort static call edges and a Tarjan SCC condensation so
  summaries can be computed bottom-up and recursion is detected rather than
  looped on.

Resolution is deliberately conservative: an ambiguous bare name (two
analyzed functions with the same name, neither imported here) resolves to
nothing, and the interpreter treats the call as an unknown effect-free value
— a missed finding, never a false one.
"""

from __future__ import annotations

import ast
import os
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

from .engine import _iter_py_files, _posix

__all__ = [
    "CallGraph",
    "ClassInfo",
    "FunctionInfo",
    "ModuleInfo",
    "build",
    "module_dotted",
]


@dataclass
class FunctionInfo:
    """One analyzed function or method."""

    name: str
    qualname: str  # "<path>::fn" or "<path>::Class.fn"
    node: ast.AST  # FunctionDef | AsyncFunctionDef
    module: "ModuleInfo"
    cls: Optional[str] = None  # owning class name for methods

    def __repr__(self):
        return f"FunctionInfo({self.qualname})"


@dataclass
class ClassInfo:
    name: str
    node: ast.ClassDef
    module: "ModuleInfo"
    methods: Dict[str, FunctionInfo] = field(default_factory=dict)
    bases: List[str] = field(default_factory=list)  # base-class last names


@dataclass
class ModuleInfo:
    path: str
    dotted: str  # "heat_tpu_torch.core.statistics" (best-effort from the path)
    tree: ast.Module
    lines: Sequence[str]
    #: local alias -> absolute dotted source: ``import heat_tpu_torch as ht`` maps
    #: ``ht -> heat_tpu_torch``; ``from heat_tpu_torch.core import manipulations`` maps
    #: ``manipulations -> heat_tpu_torch.core.manipulations``; ``from .basics
    #: import dot`` maps ``dot -> heat_tpu_torch.core.linalg.basics.dot``
    imports: Dict[str, str] = field(default_factory=dict)
    functions: Dict[str, FunctionInfo] = field(default_factory=dict)
    classes: Dict[str, ClassInfo] = field(default_factory=dict)

    @property
    def heat_aliases(self) -> set:
        return {
            alias
            for alias, src in self.imports.items()
            if src.split(".")[0] == "heat_tpu_torch"
        }


def module_dotted(path: str) -> str:
    """Best-effort dotted module path from a file path: the part starting at
    the last path component named like a package root (``heat_tpu_torch``,
    ``tests``) — enough to resolve intra-repo imports."""
    parts = _posix(path).split("/")
    if parts[-1].endswith(".py"):
        parts[-1] = parts[-1][:-3]
    if parts[-1] == "__init__":
        parts = parts[:-1]
    for root in ("heat_tpu_torch", "tests"):
        if root in parts:
            return ".".join(parts[parts.index(root):])
    return ".".join(parts[-2:]) if len(parts) > 1 else parts[0]


def _index_module(path: str, src: str) -> Optional[ModuleInfo]:
    try:
        tree = ast.parse(src, filename=path)
    except SyntaxError:
        return None  # the lint reports H000; the verifier just skips it
    mod = ModuleInfo(
        path=_posix(path), dotted=module_dotted(path), tree=tree, lines=src.splitlines()
    )
    pkg = mod.dotted.rsplit(".", 1)[0] if "." in mod.dotted else mod.dotted
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                mod.imports[(alias.asname or alias.name).split(".")[0]] = (
                    alias.name if alias.asname else alias.name.split(".")[0]
                )
        elif isinstance(node, ast.ImportFrom) and (node.module or node.level):
            base = node.module or ""
            if node.level:  # relative: anchor at this module's package
                anchor = mod.dotted.split(".")
                anchor = anchor[: len(anchor) - node.level] or anchor[:1]
                base = ".".join(anchor + ([base] if base else []))
            for alias in node.names:
                if alias.name == "*":
                    continue
                mod.imports[alias.asname or alias.name] = f"{base}.{alias.name}"
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            mod.functions[node.name] = FunctionInfo(
                node.name, f"{mod.path}::{node.name}", node, mod
            )
        elif isinstance(node, ast.ClassDef):
            ci = ClassInfo(node.name, node, mod)
            ci.bases = [
                b.attr if isinstance(b, ast.Attribute) else getattr(b, "id", "")
                for b in node.bases
            ]
            for sub in node.body:
                if isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    ci.methods[sub.name] = FunctionInfo(
                        sub.name,
                        f"{mod.path}::{node.name}.{sub.name}",
                        sub,
                        mod,
                        cls=node.name,
                    )
            mod.classes[node.name] = ci
    return mod


class CallGraph:
    """The analyzed source set plus name-resolution services."""

    def __init__(self, modules: List[ModuleInfo]):
        self.modules: Dict[str, ModuleInfo] = {m.path: m for m in modules}
        self.by_dotted: Dict[str, ModuleInfo] = {m.dotted: m for m in modules}
        self.functions_by_name: Dict[str, List[FunctionInfo]] = {}
        self.classes_by_name: Dict[str, List[ClassInfo]] = {}
        for m in modules:
            for fn in m.functions.values():
                self.functions_by_name.setdefault(fn.name, []).append(fn)
            for ci in m.classes.values():
                self.classes_by_name.setdefault(ci.name, []).append(ci)

    # -- name resolution -------------------------------------------------
    def resolve_dotted(self, dotted: str):
        """An absolute dotted source name -> FunctionInfo | ClassInfo | None
        (``heat_tpu_torch.core.linalg.basics.dot`` or ``tests.foo.main``)."""
        if not dotted or "." not in dotted:
            return None
        mod_path, leaf = dotted.rsplit(".", 1)
        m = self.by_dotted.get(mod_path)
        if m is not None:
            hit = m.functions.get(leaf) or m.classes.get(leaf)
            if hit is not None:
                return hit
        # package re-export (heat_tpu_torch.cluster.KMeans defined in a
        # submodule and star-imported by the package's __init__, which the
        # import map does not follow): unique last-name match under the
        # package prefix
        cands: List = [
            c
            for c in self.classes_by_name.get(leaf, [])
            if c.module.dotted.startswith(mod_path.split(".")[0])
        ] + [
            f
            for f in self.functions_by_name.get(leaf, [])
            if f.module.dotted.startswith(mod_path.split(".")[0])
        ]
        return cands[0] if len(cands) == 1 else None

    def resolve_name(self, module: ModuleInfo, name: str):
        """A bare name used in ``module`` -> FunctionInfo | ClassInfo | None:
        module-local definition first, then the import map."""
        hit = module.functions.get(name) or module.classes.get(name)
        if hit is not None:
            return hit
        src = module.imports.get(name)
        if src is not None:
            return self.resolve_dotted(src)
        return None

    def resolve_method(self, cls_name: str, method: str) -> Optional[FunctionInfo]:
        """Method lookup through the name-resolved class hierarchy (unique
        class names only — ambiguity resolves to nothing)."""
        seen = set()
        queue = [cls_name]
        while queue:
            cn = queue.pop(0)
            if cn in seen:
                continue
            seen.add(cn)
            cands = self.classes_by_name.get(cn, [])
            if len(cands) != 1:
                continue
            ci = cands[0]
            if method in ci.methods:
                return ci.methods[method]
            queue.extend(b for b in ci.bases if b)
        return None

    # -- static edges + SCC condensation ---------------------------------
    def static_edges(self, fn: FunctionInfo) -> List[FunctionInfo]:
        """Best-effort static call targets of one function: bare names,
        imported names, and ``self.method`` calls. Value-dependent calls are
        the interpreter's job; these edges exist for ordering and tests."""
        out: List[FunctionInfo] = []
        for node in ast.walk(fn.node):
            if not isinstance(node, ast.Call):
                continue
            f = node.func
            target = None
            if isinstance(f, ast.Name):
                target = self.resolve_name(fn.module, f.id)
            elif (
                isinstance(f, ast.Attribute)
                and isinstance(f.value, ast.Name)
                and f.value.id == "self"
                and fn.cls
            ):
                target = self.resolve_method(fn.cls, f.attr)
            elif isinstance(f, ast.Attribute) and isinstance(f.value, ast.Name):
                src = fn.module.imports.get(f.value.id)
                if src is not None:
                    target = self.resolve_dotted(f"{src}.{f.attr}")
            if isinstance(target, FunctionInfo):
                out.append(target)
            elif isinstance(target, ClassInfo):
                init = target.methods.get("__init__")
                if init is not None:
                    out.append(init)
        return out

    def all_functions(self) -> List[FunctionInfo]:
        out = []
        for m in self.modules.values():
            out.extend(m.functions.values())
            for ci in m.classes.values():
                out.extend(ci.methods.values())
        return out

    def sccs(self) -> List[List[FunctionInfo]]:
        """Tarjan SCCs of the static call graph in reverse topological order
        (callees before callers) — the summary computation order; any SCC
        with more than one member (or a self-loop) is recursion."""
        fns = self.all_functions()
        index: Dict[str, int] = {}
        low: Dict[str, int] = {}
        stack: List[FunctionInfo] = []
        on_stack = set()
        result: List[List[FunctionInfo]] = []
        counter = [0]
        edges = {f.qualname: self.static_edges(f) for f in fns}

        def strongconnect(fn: FunctionInfo):
            q = fn.qualname
            index[q] = low[q] = counter[0]
            counter[0] += 1
            stack.append(fn)
            on_stack.add(q)
            work = [(fn, iter(edges[q]))]
            while work:
                cur, it = work[-1]
                advanced = False
                for callee in it:
                    cq = callee.qualname
                    if cq not in index:
                        index[cq] = low[cq] = counter[0]
                        counter[0] += 1
                        stack.append(callee)
                        on_stack.add(cq)
                        work.append((callee, iter(edges[cq])))
                        advanced = True
                        break
                    elif cq in on_stack:
                        low[cur.qualname] = min(low[cur.qualname], index[cq])
                if advanced:
                    continue
                work.pop()
                if work:
                    parent = work[-1][0]
                    low[parent.qualname] = min(low[parent.qualname], low[cur.qualname])
                if low[cur.qualname] == index[cur.qualname]:
                    comp = []
                    while True:
                        w = stack.pop()
                        on_stack.discard(w.qualname)
                        comp.append(w)
                        if w.qualname == cur.qualname:
                            break
                    result.append(comp)

        for fn in fns:
            if fn.qualname not in index:
                strongconnect(fn)
        return result


def build(paths: Iterable[str]) -> CallGraph:
    """Parse and index every ``.py`` file under ``paths`` (same walking rules
    as the lint: ``__pycache__`` and dot-dirs skipped, unparseable files
    dropped)."""
    modules: List[ModuleInfo] = []
    for fname in _iter_py_files(paths):
        try:
            with open(fname, "r", encoding="utf-8", errors="replace") as fh:
                src = fh.read()
        except OSError:
            continue
        mod = _index_module(fname, src)
        if mod is not None:
            modules.append(mod)
    return CallGraph(modules)


def build_from_sources(sources: Dict[str, str]) -> CallGraph:
    """Index in-memory sources (tests, drift workloads): path -> source."""
    modules = []
    for path, src in sources.items():
        mod = _index_module(path, src)
        if mod is not None:
            modules.append(mod)
    return CallGraph(modules)
