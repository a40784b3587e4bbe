"""repro_torch.analysis — repo-invariant static checkers + runtime
sanitizer, the counterpart of ``repro.analysis`` for the port.

The annotation grammar is the JAX package's (see :mod:`.common`), so one
comment satisfies both packages' checkers.  Three AST-based checkers
(stdlib ``ast`` only):

- :mod:`repro_torch.analysis.locks` — lock-discipline: every access to
  a field annotated ``# guarded by: <lock>`` happens under
  ``with self.<lock>:`` or inside a ``# caller holds <lock>`` helper
  whose call sites are themselves verified.
- :mod:`repro_torch.analysis.syncs` — host-sync tracer: device->host
  transfers (``.item()``, ``.cpu()``, ``bool(t.any())``, ...) inside
  ``torch.compile`` / ``torch.jit.script`` / CUDA-graph scopes, and
  anywhere in a ``# repro: sync-trace`` module, must carry ``# sync``.
- :mod:`repro_torch.analysis.contracts` — every CUDA kernel wrapper has
  a same-signature plain version in ``kernels/ref.py``.

Run the suite with ``python -m repro_torch.analysis src/repro_torch``
(see :mod:`repro_torch.analysis.cli`).  ``REPRO_SANITIZE=1``
additionally arms the runtime lock assertions in
:mod:`repro_torch.analysis.sanitize`.
"""
from __future__ import annotations

from .common import Finding, Project
from .cli import run_analysis

__all__ = ["Finding", "Project", "run_analysis"]
