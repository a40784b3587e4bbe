"""Host-sync tracer, the torch counterpart of ``repro.analysis.syncs``.

Two rules:

1. **Traced scopes** (SYNC001): inside a ``torch.compile`` or
   ``torch.jit.script`` function (decorated, or passed to the call as
   ``name = torch.compile(fn)``), the body of a ``with
   torch.cuda.graph(...)`` block, or anything lexically nested in one,
   any implicit device->host conversion is flagged: ``float()`` /
   ``int()`` / ``bool()`` on a non-literal, and every explicit
   conversion of rule 2.  These either break the graph, fail at capture
   or sync; all are bugs the annotation must own.
2. **Sync-traced modules** (SYNC002): a module carrying a
   ``# repro: sync-trace`` directive opts its *entire* body into
   tracing of the explicit conversions: ``.item()``, ``.tolist()``,
   ``.cpu()``, ``.numpy()``, ``.to("cpu")`` / ``.to(device="cpu")``,
   ``np.asarray`` / ``np.array`` on a plain-numpy alias,
   ``torch.cuda.synchronize()`` and ``.synchronize()`` on an event or
   stream, and ``bool()`` / ``float()`` / ``int()`` whose argument is a
   tensor reduction (a call of ``.any()``, ``.all()``, ``.sum()``,
   ``.max()`` or ``.min()``): the port's way of pulling a device
   predicate, where the JAX walk wrote ``np.asarray(pred)``.  Bare
   ``float()`` / ``int()`` / ``bool()`` on other operands are mostly host
   scalars and are not flagged module-wide.  This is how
   ``core/engine.py`` pins each of its syncs.

Suppressions: a trailing comment containing the word ``sync``
sanctions a deliberate transfer; a trailing ``# host`` comment asserts
the operand is host data (python numbers, numpy arrays, CPU tensors),
so no transfer occurs.  A finding, like a suppression, sits on the line
where the call expression starts.

``sync_sites`` lists a sync-traced module's sanctioned transfers with
the frequency their comment states (``# sync: once per block``).
"""
from __future__ import annotations

import ast
import re

from .common import (Finding, Project, SourceFile, decorator_is_jit, dotted,
                     is_compiler)

__all__ = ["check", "sync_sites"]

_NUMPY_MODULES = {"numpy"}
_SCALARIZERS = {"float", "int", "bool"}
_REDUCTIONS = {"any", "all", "sum", "max", "min"}
_METHOD_SYNCS = {"item", "tolist", "cpu", "numpy"}
_FREQ_RE = re.compile(r"\bper\s+(\w+)")


def _import_aliases(tree: ast.Module) -> dict[str, str]:
    """local alias -> imported module name (``np`` -> ``numpy``)."""
    aliases: dict[str, str] = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                aliases[a.asname or a.name.split(".")[0]] = a.name
        elif isinstance(node, ast.ImportFrom) and node.module:
            for a in node.names:
                aliases[a.asname or a.name] = \
                    f"{node.module}.{a.name}"
    return aliases


def _traced_roots(sf: SourceFile) -> list[list[ast.AST]]:
    """Statement lists that run traced or captured: the bodies of
    compile-decorated defs, of defs and lambdas handed to
    ``torch.compile(...)`` / ``torch.jit.script(...)``, and of ``with
    torch.cuda.graph(...)`` blocks."""
    defs_by_name: dict[str, list[ast.AST]] = {}
    for node in ast.walk(sf.tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            defs_by_name.setdefault(node.name, []).append(node)

    def body(fn: ast.AST) -> list[ast.AST]:
        return fn.body if isinstance(fn.body, list) else [fn.body]

    roots: list[list[ast.AST]] = []
    for node in ast.walk(sf.tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            if any(decorator_is_jit(d) for d in node.decorator_list):
                roots.append(node.body)
        elif isinstance(node, ast.With):
            if any(isinstance(it.context_expr, ast.Call)
                   and dotted(it.context_expr.func) in (
                       "torch.cuda.graph", "cuda.graph")
                   for it in node.items):
                roots.append(node.body)
        elif isinstance(node, ast.Call) and is_compiler(node.func):
            for arg in node.args[:1]:
                if isinstance(arg, ast.Lambda):
                    roots.append(body(arg))
                elif isinstance(arg, ast.Name):
                    roots.extend(body(d)
                                 for d in defs_by_name.get(arg.id, []))
    return roots


def _to_cpu(node: ast.Call) -> bool:
    """``x.to("cpu")``, ``x.to(device="cpu")``, ``x.to("cpu", ...)``."""
    args = node.args[:1] + [kw.value for kw in node.keywords
                            if kw.arg == "device"]
    return any(isinstance(a, ast.Constant) and a.value == "cpu"
               for a in args)


class _SyncScan(ast.NodeVisitor):
    """Collects conversion-call sites; caller filters by scope/rule."""

    def __init__(self, sf: SourceFile, aliases: dict[str, str],
                 explicit_only: bool):
        self.sf = sf
        self.aliases = aliases
        self.explicit_only = explicit_only
        self.hits: list[tuple[int, str]] = []

    def _owner_module(self, fn: ast.Attribute) -> str | None:
        owner = fn.value
        return self.aliases.get(owner.id) if isinstance(owner, ast.Name) \
            else None

    def _is_reduction(self, node: ast.expr) -> bool:
        return (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr in _REDUCTIONS
                and self._owner_module(node.func) not in _NUMPY_MODULES)

    def visit_Call(self, node: ast.Call):
        fn = node.func
        line = node.lineno
        if isinstance(fn, ast.Name) and fn.id in _SCALARIZERS:
            if node.args and (
                    self._is_reduction(node.args[0]) if self.explicit_only
                    else not isinstance(node.args[0], ast.Constant)):
                self.hits.append(
                    (line, f"{fn.id}() on a device value forces a "
                           f"device->host sync"))
        elif isinstance(fn, ast.Attribute):
            owner_mod = self._owner_module(fn)
            if fn.attr in ("asarray", "array") and \
                    owner_mod in _NUMPY_MODULES:
                self.hits.append(
                    (line, f"{fn.value.id}.{fn.attr}(...) pulls the "
                           f"operand to host"))
            elif fn.attr == "synchronize":
                self.hits.append(
                    (line, f"{dotted(fn) or '.synchronize'}() waits for "
                           f"the device"))
            elif fn.attr in _METHOD_SYNCS:
                self.hits.append(
                    (line, f".{fn.attr}() on a tensor syncs it to host"))
            elif fn.attr == "to" and _to_cpu(node):
                self.hits.append(
                    (line, ".to('cpu') on a tensor syncs it to host"))
        self.generic_visit(node)


def _sync002_hits(sf: SourceFile) -> list[tuple[int, str]]:
    scan = _SyncScan(sf, _import_aliases(sf.tree), explicit_only=True)
    scan.visit(sf.tree)
    return scan.hits


def check(project: Project) -> list[Finding]:
    findings: list[Finding] = []
    seen: set[tuple[str, int]] = set()

    def emit(sf: SourceFile, code: str, hits: list[tuple[int, str]],
             where: str):
        for line, msg in hits:
            if (sf.path, line) in seen:
                continue
            if sf.sync_ok(line) or sf.host_ok(line):
                continue
            seen.add((sf.path, line))
            findings.append(Finding(
                sf.path, line, code,
                f"{msg} {where}; annotate with '# sync' if deliberate "
                f"or '# host' if the operand is host data"))

    for sf in project.files:
        aliases = _import_aliases(sf.tree)
        for stmts in _traced_roots(sf):
            scan = _SyncScan(sf, aliases, explicit_only=False)
            for stmt in stmts:
                scan.visit(stmt)
            emit(sf, "SYNC001", scan.hits,
                 "inside a compiled or graph-captured scope")
        if sf.sync_trace_module():
            emit(sf, "SYNC002", _sync002_hits(sf),
                 "in a '# repro: sync-trace' module")
    return findings


def sync_sites(sf: SourceFile) -> list[tuple[int, str]]:
    """The sanctioned transfers of a sync-traced module: ``(line,
    frequency)`` for each line SYNC002 would flag but for its ``# sync``
    comment, the frequency being the word after ``per`` in that comment
    (``# sync: once per block`` -> ``block``), or ``unstated``."""
    lines = sorted({line for line, _ in _sync002_hits(sf)
                    if sf.sync_ok(line)})
    out = []
    for line in lines:
        m = _FREQ_RE.search(sf.comment_on(line))
        out.append((line, m.group(1) if m else "unstated"))
    return out
