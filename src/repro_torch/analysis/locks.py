"""Lock-discipline checker (``repro.analysis.locks``, framework-free:
the same rules, codes and messages).

A field annotated ``# guarded by: <lock>`` at its ``self.<field> = ...``
declaration may only be read or written (a) lexically inside
``with self.<lock>:``, or (b) inside a method annotated
``# caller holds <lock>`` — in which case every *call site* of that
method must itself hold the lock (or be another caller-holds method
for the same lock).

Scope and limits (documented, deliberate):

- Only ``self.<field>`` accesses inside the declaring class are
  checked; cross-object reads (``other.field``) are out of static
  scope — the ``REPRO_SANITIZE=1`` runtime wrappers in
  :mod:`repro_torch.analysis.sanitize` cover mutations at runtime.
- ``__init__`` is exempt: the object is not yet shared.
- Nested functions and lambdas run later, possibly off-lock, so they
  start with an *empty* held-set even when defined under ``with``.
"""
from __future__ import annotations

import ast

from .common import Finding, Project, SourceFile

__all__ = ["check", "class_guarded_fields"]


def _self_attr(node: ast.expr) -> str | None:
    if isinstance(node, ast.Attribute) and \
            isinstance(node.value, ast.Name) and node.value.id == "self":
        return node.attr
    return None


def class_guarded_fields(sf: SourceFile,
                         cls: ast.ClassDef) -> dict[str, str]:
    """``field -> lock`` map from ``# guarded by:`` annotations on
    ``self.<field> = ...`` assignments anywhere in the class."""
    guarded: dict[str, str] = {}
    for node in ast.walk(cls):
        targets: list[ast.expr] = []
        if isinstance(node, ast.Assign):
            targets = node.targets
        elif isinstance(node, (ast.AnnAssign, ast.AugAssign)):
            targets = [node.target]
        for t in targets:
            fieldname = _self_attr(t)
            if fieldname is None:
                continue
            lock = sf.guarded_by(node.lineno)
            if lock:
                guarded[fieldname] = lock
    return guarded


class _MethodWalker(ast.NodeVisitor):
    def __init__(self, sf: SourceFile, clsname: str,
                 guarded: dict[str, str], holds: dict[str, str],
                 findings: list[Finding]):
        self.sf = sf
        self.clsname = clsname
        self.guarded = guarded
        self.holds = holds
        self.findings = findings
        self.held: frozenset[str] = frozenset()

    # -- scoping ------------------------------------------------------
    def visit_With(self, node: ast.With):
        for item in node.items:
            self.visit(item.context_expr)
        added = {a for item in node.items
                 if (a := _self_attr(item.context_expr))}
        old = self.held
        self.held = old | added
        for stmt in node.body:
            self.visit(stmt)
        self.held = old

    def _deferred(self, node):
        """Nested defs/lambdas execute later: no locks assumed held."""
        old = self.held
        self.held = frozenset()
        self.generic_visit(node)
        self.held = old

    visit_FunctionDef = _deferred
    visit_AsyncFunctionDef = _deferred
    visit_Lambda = _deferred

    # -- checks -------------------------------------------------------
    def visit_Attribute(self, node: ast.Attribute):
        attr = _self_attr(node)
        if attr is not None and attr in self.guarded:
            lock = self.guarded[attr]
            if lock not in self.held:
                self.findings.append(Finding(
                    self.sf.path, node.lineno, "LOCK001",
                    f"{self.clsname}.{attr} is guarded by "
                    f"self.{lock} but accessed without holding it"))
        self.generic_visit(node)

    def visit_Call(self, node: ast.Call):
        attr = _self_attr(node.func)
        if attr is not None and attr in self.holds:
            lock = self.holds[attr]
            if lock not in self.held:
                self.findings.append(Finding(
                    self.sf.path, node.lineno, "LOCK002",
                    f"{self.clsname}.{attr} requires the caller to "
                    f"hold self.{lock} (see its '# caller holds' "
                    f"annotation) but is called without it"))
        self.generic_visit(node)


def _check_class(sf: SourceFile, cls: ast.ClassDef,
                 findings: list[Finding]) -> None:
    guarded = class_guarded_fields(sf, cls)
    holds = {m.name: lock for m in cls.body
             if isinstance(m, (ast.FunctionDef, ast.AsyncFunctionDef))
             and (lock := sf.caller_holds(m))}
    if not guarded and not holds:
        return
    for m in cls.body:
        if not isinstance(m, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        if m.name == "__init__":
            continue
        w = _MethodWalker(sf, cls.name, guarded, holds, findings)
        if m.name in holds:
            w.held = frozenset({holds[m.name]})
        for stmt in m.body:
            w.visit(stmt)


def check(project: Project) -> list[Finding]:
    findings: list[Finding] = []
    for sf in project.files:
        for node in ast.walk(sf.tree):
            if isinstance(node, ast.ClassDef):
                _check_class(sf, node, findings)
    return findings
