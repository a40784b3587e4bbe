"""Shared model for the checkers: findings, parsed source files, and
the comment-annotation grammar (``repro.analysis.common``: the same
grammar, so one comment satisfies both packages' checkers).

Annotation grammar (all annotations are ordinary ``#`` comments):

- ``# guarded by: <lock>`` — trailing comment on a ``self.<field> = ...``
  assignment inside a class body.  Declares that every later read/write
  of ``self.<field>`` must hold ``self.<lock>``.  ``<lock>`` may be
  written with or without the ``self.`` prefix.
- ``# caller holds <lock>`` — trailing comment on a ``def`` line (or a
  comment line directly above/below it, before the first statement).
  Declares the method relies on its caller to hold the lock; the
  checker then verifies every call site instead.
- ``# ... sync ...`` — any trailing comment containing the word
  ``sync`` sanctions a device->host transfer on that line.
- ``# host`` — trailing comment asserting the converted value is plain
  host data (python ints/lists), not a traced array: not a sync.
- ``# repro: sync-trace`` — module directive (comment anywhere at the
  top level) opting the whole module into host-sync tracing, not just
  its compiled or graph-captured scopes.
- ``# oracle: <name>`` — trailing comment on a kernel entry ``def``
  line naming its oracle in ``kernels/ref.py`` when it is not
  ``<entry>_ref``.
"""
from __future__ import annotations

import ast
import io
import re
import tokenize
from dataclasses import dataclass, field


@dataclass(frozen=True)
class Finding:
    """One checker diagnostic, pointing at a file:line."""

    path: str
    line: int
    code: str      # e.g. "LOCK001"
    message: str

    def text(self) -> str:
        return f"{self.path}:{self.line}: {self.code} {self.message}"

    def github(self) -> str:
        return (f"::error file={self.path},line={self.line},"
                f"title={self.code}::{self.message}")


_GUARDED_RE = re.compile(r"#\s*guarded by:\s*(?:self\.)?(\w+)")
_CALLER_HOLDS_RE = re.compile(r"#\s*caller holds\s+(?:self\.)?(\w+)")
_SYNC_WORD_RE = re.compile(r"#[^#]*\bsync\b")
_HOST_RE = re.compile(r"#\s*host\b")
_ORACLE_RE = re.compile(r"#\s*oracle:\s*(\w+)")
_SYNC_TRACE_DIRECTIVE = re.compile(r"#\s*repro:\s*sync-trace\b")


@dataclass
class SourceFile:
    """A parsed module: source text, AST, and its comment map."""

    path: str           # display path (as given on the CLI)
    source: str
    tree: ast.Module = field(repr=False, default=None)  # type: ignore
    comments: dict[int, str] = field(default_factory=dict)  # line -> text

    def __post_init__(self):
        if self.tree is None:
            self.tree = ast.parse(self.source, filename=self.path)
        try:
            toks = tokenize.generate_tokens(
                io.StringIO(self.source).readline)
            for tok in toks:
                if tok.type == tokenize.COMMENT:
                    self.comments[tok.start[0]] = tok.string
        except tokenize.TokenError:
            pass

    # -- annotation lookups -------------------------------------------
    def comment_on(self, line: int) -> str:
        return self.comments.get(line, "")

    def guarded_by(self, line: int) -> str | None:
        m = _GUARDED_RE.search(self.comment_on(line))
        return m.group(1) if m else None

    def caller_holds(self, node: ast.FunctionDef) -> str | None:
        """``# caller holds <lock>`` on the def line or a comment line
        between the decorators and the first body statement."""
        first = node.body[0].lineno if node.body else node.lineno + 1
        for ln in range(node.lineno, first + 1):
            m = _CALLER_HOLDS_RE.search(self.comment_on(ln))
            if m:
                return m.group(1)
        return None

    def sync_ok(self, line: int) -> bool:
        return bool(_SYNC_WORD_RE.search(self.comment_on(line)))

    def host_ok(self, line: int) -> bool:
        return bool(_HOST_RE.search(self.comment_on(line)))

    def oracle_override(self, line: int) -> str | None:
        m = _ORACLE_RE.search(self.comment_on(line))
        return m.group(1) if m else None

    def sync_trace_module(self) -> bool:
        return any(_SYNC_TRACE_DIRECTIVE.search(c)
                   for c in self.comments.values())

    @property
    def module(self) -> str:
        """Dotted module name, rooted at the ``repro_torch`` package when
        the path contains one (``src/repro_torch/kernels/ref.py`` ->
        ``repro_torch.kernels.ref``); the whole path otherwise."""
        parts = self.path.replace("\\", "/").split("/")
        stem = [p[:-3] if p.endswith(".py") else p for p in parts]
        if "repro_torch" in stem:
            stem = stem[stem.index("repro_torch"):]
        name = ".".join(stem)
        return name[:-len(".__init__")] if name.endswith(".__init__") \
            else name


class Project:
    """The set of files one analysis run sees (checkers that need
    cross-module context — the contract checkers — resolve modules
    through this)."""

    def __init__(self, files: list[SourceFile]):
        self.files = files
        self.by_module: dict[str, SourceFile] = {}
        for f in files:
            self.by_module.setdefault(f.module, f)

    @classmethod
    def from_sources(cls, named: list[tuple[str, str]]) -> "Project":
        return cls([SourceFile(path=p, source=s) for p, s in named])

    def find_module(self, suffix: str) -> SourceFile | None:
        """Module whose dotted name equals or ends with ``suffix``."""
        if suffix in self.by_module:
            return self.by_module[suffix]
        for name, f in self.by_module.items():
            if name.endswith("." + suffix):
                return f
        return None


def top_level_functions(tree: ast.Module):
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            yield node


def dotted(node: ast.expr) -> str | None:
    """``torch.jit.script`` for the expression ``torch.jit.script``;
    None for anything but a chain of names."""
    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, ast.Attribute):
        owner = dotted(node.value)
        return f"{owner}.{node.attr}" if owner else None
    return None


_COMPILERS = {"torch.compile", "torch.jit.script", "jit.script"}


def is_compiler(node: ast.expr) -> bool:
    """True for the expressions ``torch.compile``, ``torch.jit.script``
    and ``jit.script``: the calls whose function body runs traced."""
    return dotted(node) in _COMPILERS


def decorator_is_jit(dec: ast.expr) -> bool:
    """True for ``@torch.compile``, ``@torch.compile(mode=...)``,
    ``@torch.jit.script`` and ``@functools.partial(torch.compile, ...)``
    decorator expressions: the port's traced scopes, the counterpart of
    ``@jax.jit``."""
    if is_compiler(dec):
        return True
    if isinstance(dec, ast.Call):
        fn = dec.func
        if dotted(fn) in ("partial", "functools.partial") and dec.args \
                and is_compiler(dec.args[0]):
            return True
        if is_compiler(fn):  # @torch.compile(fullgraph=True) style
            return True
    return False
