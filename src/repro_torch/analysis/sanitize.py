"""Runtime lock-discipline sanitizer (``REPRO_SANITIZE=1``), the
counterpart of ``repro.analysis.sanitize`` under the same variable.

The static checker in :mod:`repro_torch.analysis.locks` proves lexical
discipline; this module catches what statics cannot — a guarded field
mutated through an alias, from a thread the checker never saw, or via
a path added after annotation.  Two pieces:

- :func:`create_lock` — drop-in for ``threading.Lock()``.  Returns a
  plain lock when the sanitizer is off; an :class:`InstrumentedLock`
  (owner-tracking, context-manager compatible) when on.
- :func:`guarded` — class decorator.  When the sanitizer is on it
  re-parses the class's own ``# guarded by:`` source annotations (the
  same grammar the static checker reads — one source of truth) and
  wraps ``__setattr__`` to assert the mapped lock is held by the
  mutating thread.  Assignments during ``__init__`` are exempt, same
  as the static rule.  When off, the decorator returns the class
  unchanged: zero overhead, no source parsing.

Timed runs must never run instrumented: ``chip_smoke.py`` refuses to
start when ``REPRO_SANITIZE`` is set in its environment.
"""
from __future__ import annotations

import ast
import inspect
import os
import textwrap
import threading

__all__ = ["enabled", "create_lock", "guarded", "InstrumentedLock",
           "SanitizeError"]

_ENV = "REPRO_SANITIZE"


def enabled() -> bool:
    return os.environ.get(_ENV, "0") not in ("", "0")


class SanitizeError(AssertionError):
    """A guarded field was mutated without its lock held."""


class InstrumentedLock:
    """``threading.Lock`` plus owner-thread tracking."""

    def __init__(self):
        self._lock = threading.Lock()
        self._owner: int | None = None

    def acquire(self, *args, **kw) -> bool:
        got = self._lock.acquire(*args, **kw)
        if got:
            self._owner = threading.get_ident()
        return got

    def release(self) -> None:
        self._owner = None
        self._lock.release()

    def locked(self) -> bool:
        return self._lock.locked()

    def held_by_me(self) -> bool:
        return self._owner == threading.get_ident()

    def __enter__(self) -> bool:
        return self.acquire()

    def __exit__(self, *exc) -> None:
        self.release()


def create_lock():
    """Factory for guarded-class locks: instrumented iff sanitizing."""
    return InstrumentedLock() if enabled() else threading.Lock()


def _guarded_map(cls) -> dict[str, str]:
    """``field -> lock`` from the class's ``# guarded by:`` comments,
    parsed with the same grammar as the static checker."""
    from .common import SourceFile
    from .locks import class_guarded_fields
    try:
        src = textwrap.dedent(inspect.getsource(cls))
    except (OSError, TypeError):
        return {}
    sf = SourceFile(path=f"<{cls.__name__}>", source=src)
    node = sf.tree.body[0]
    if not isinstance(node, ast.ClassDef):
        return {}
    return class_guarded_fields(sf, node)


def guarded(cls):
    """Class decorator: assert lock holdership on guarded mutations.

    Subclass-safe: decorate both base and subclass and each layer
    checks its own map, chaining ``__setattr__`` through the MRO.
    ``__init__`` bodies (including ``super().__init__``) are exempt
    via a per-instance construction-depth counter.
    """
    if not enabled():
        return cls
    gmap = _guarded_map(cls)

    orig_init = cls.__init__
    orig_setattr = cls.__setattr__

    def __init__(self, *args, **kw):
        depth = getattr(self, "_sanitize_init_depth", 0)
        object.__setattr__(self, "_sanitize_init_depth", depth + 1)
        try:
            orig_init(self, *args, **kw)
        finally:
            object.__setattr__(self, "_sanitize_init_depth", depth)

    def __setattr__(self, name, value):
        if name in gmap and \
                getattr(self, "_sanitize_init_depth", 1) == 0:
            lock = getattr(self, gmap[name], None)
            if isinstance(lock, InstrumentedLock) and \
                    not lock.held_by_me():
                raise SanitizeError(
                    f"{type(self).__name__}.{name} is guarded by "
                    f"{gmap[name]} but was mutated without holding "
                    f"it (REPRO_SANITIZE=1)")
        orig_setattr(self, name, value)

    cls.__init__ = __init__
    cls.__setattr__ = __setattr__
    return cls
