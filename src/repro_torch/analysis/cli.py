"""Command line: ``python -m repro_torch.analysis [paths...]``.

Collects ``.py`` files under the given paths (default
``src/repro_torch``), runs the three checkers, and prints findings in
``text`` or ``github`` (workflow-annotation) format.  Exit code 1 iff
there are findings — this is the lint gate.
"""
from __future__ import annotations

import argparse
import os
import sys

from . import contracts, locks, syncs
from .common import Finding, Project, SourceFile

_CHECKS = {
    "locks": locks.check,
    "syncs": syncs.check,
    "contracts": contracts.check,
}


def collect_py_files(paths: list[str]) -> list[str]:
    out: list[str] = []
    for p in paths:
        if os.path.isfile(p):
            out.append(p)
            continue
        for root, dirs, files in os.walk(p):
            dirs[:] = sorted(d for d in dirs
                             if not d.startswith(".")
                             and d != "__pycache__")
            out.extend(os.path.join(root, f) for f in sorted(files)
                       if f.endswith(".py"))
    return out


def load_project(paths: list[str]) -> tuple[Project, list[Finding]]:
    files, errors = [], []
    for path in collect_py_files(paths):
        try:
            with open(path, encoding="utf-8") as fh:
                files.append(SourceFile(path=path, source=fh.read()))
        except SyntaxError as e:
            errors.append(Finding(path, e.lineno or 1, "PARSE001",
                                  f"cannot parse: {e.msg}"))
    return Project(files), errors


def run_analysis(project: Project,
                 checks: tuple[str, ...] = ("locks", "syncs",
                                            "contracts"),
                 ) -> list[Finding]:
    findings: list[Finding] = []
    for name in checks:
        findings.extend(_CHECKS[name](project))
    return sorted(findings, key=lambda f: (f.path, f.line, f.code))


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="repo-invariant linters: lock discipline, "
                    "host-sync tracing, kernel/oracle contracts")
    ap.add_argument("paths", nargs="*", default=["src/repro_torch"],
                    help="files or directories to analyze "
                         "(default: src/repro_torch)")
    ap.add_argument("--format", choices=("text", "github"),
                    default="text")
    ap.add_argument("--checks", default="locks,syncs,contracts",
                    help="comma-separated subset of: "
                         + ",".join(_CHECKS))
    args = ap.parse_args(argv)

    checks = tuple(c for c in args.checks.split(",") if c)
    unknown = [c for c in checks if c not in _CHECKS]
    if unknown:
        ap.error(f"unknown checks: {unknown}")

    project, findings = load_project(args.paths)
    findings += run_analysis(project, checks)
    findings.sort(key=lambda f: (f.path, f.line, f.code))
    for f in findings:
        print(f.github() if args.format == "github" else f.text())
    n = len(project.files)
    print(f"repro_torch.analysis: {len(findings)} finding(s) in {n} "
          f"file(s) [{','.join(checks)}]", file=sys.stderr)
    return 1 if findings else 0
