"""Kernel-oracle contract checker, the counterpart of
``repro.analysis.contracts``'s KERN00x rules.

Every kernel wrapper module under ``repro_torch/kernels/`` (everything
except ``__init__``, ``_build``, ``ops`` and ``ref``) must pair each
public top-level function — the wrapper that launches a CUDA kernel —
with a same-signature plain version in ``kernels/ref.py``: the one
``ops`` dispatches a CPU tensor to and the tests hold the kernel
against.  The oracle is ``<entry>_ref`` by default; a trailing
``# oracle: <name>`` comment on the ``def`` line overrides.  Signatures
match when the parameter-name sets are equal after stripping
tuning-only parameters (anything starting with ``tile_``).

``ref.py`` is resolved by its full dotted name within the port's
package, so a project holding both ``repro`` and ``repro_torch`` never
pairs a port wrapper with the JAX package's oracle.

The JAX package's dispatch-registry contract (DISP001) has no
counterpart: it guards ``ops.set_mode``'s trace cache, and the port's
``kernels/ops.py`` has neither a trace cache nor a mode switch (it
dispatches on the input tensor's device alone).
"""
from __future__ import annotations

import ast

from .common import Finding, Project, top_level_functions

__all__ = ["check", "check_oracles"]

_NOT_WRAPPERS = {"__init__", "_build", "ops", "ref"}
_REF = "repro_torch.kernels.ref"


def _params(fn: ast.FunctionDef) -> set[str]:
    a = fn.args
    names = [p.arg for p in a.posonlyargs + a.args + a.kwonlyargs]
    return {n for n in names if not n.startswith("tile_")}


def is_wrapper(module: str) -> bool:
    """A kernel wrapper module of the port's kernels package."""
    parts = module.split(".")
    return len(parts) == 3 and parts[:2] == ["repro_torch", "kernels"] \
        and parts[2] not in _NOT_WRAPPERS


def check_oracles(project: Project) -> list[Finding]:
    findings: list[Finding] = []
    ref = project.find_module(_REF)
    ref_fns = {fn.name: fn for fn in
               top_level_functions(ref.tree)} if ref else {}
    for sf in project.files:
        if not is_wrapper(sf.module):
            continue
        for fn in top_level_functions(sf.tree):
            if fn.name.startswith("_"):
                continue
            oracle = sf.oracle_override(fn.lineno) or f"{fn.name}_ref"
            if ref is None:
                findings.append(Finding(
                    sf.path, fn.lineno, "KERN002",
                    f"kernel entry {fn.name} needs an oracle but "
                    f"kernels/ref.py is not in the analysis set"))
                continue
            target = ref_fns.get(oracle)
            if target is None:
                findings.append(Finding(
                    sf.path, fn.lineno, "KERN001",
                    f"kernel entry {fn.name} has no oracle "
                    f"{oracle}() in kernels/ref.py (add one, or map "
                    f"it with '# oracle: <name>')"))
            elif _params(target) != _params(fn):
                findings.append(Finding(
                    sf.path, fn.lineno, "KERN003",
                    f"kernel entry {fn.name}{sorted(_params(fn))} and "
                    f"oracle {oracle}{sorted(_params(target))} "
                    f"disagree on parameter names"))
    return findings


def check(project: Project) -> list[Finding]:
    return check_oracles(project)
