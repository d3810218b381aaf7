"""The lint's runner: file discovery, pragma handling, rule dispatch, reporting.

The port's own copy of ``repro.analysis.core``, stdlib-only (``ast`` +
``re``), so that ``repro-torch-lint`` runs without torch or jax importable.

Escape hatch
------------
A finding is suppressed by a pragma comment on the flagged line or the line
directly above it, in the reference's syntax, so that one comment can name
a reference code and a port code::

    torch.manual_seed(0)  # repro-lint: disable=RPT001

``# repro-lint: disable-file=RPT001`` anywhere in the file suppresses the
rule for the whole file.  Suppressions are per-code; ``disable=all`` is not
supported: name the rule you are overriding.

Fixture convention
------------------
Directories named ``fixtures`` are skipped when walking a directory tree
(they hold deliberately bad rule fixtures for ``tests/test_torch_analysis.py``)
but are linted when such a path is passed explicitly.  A ``fixtures`` path
component also cancels the test-path exemption some rules apply, so a
fixture under ``tests/fixtures/`` still trips path-exempted rules.

The clean tree
--------------
With no paths, :func:`main` lints the port's files (:func:`clean_tree`):
``src/repro_torch``, ``tests/test_torch_*.py``, ``examples/torch_*.py``,
``chip_smoke.py`` and the root scripts the port added.  The reference's
lint (``repro-lint``) walks ``src`` whole and covers these files with its
own rules too.
"""

from __future__ import annotations

import argparse
import ast
import dataclasses
import os
import re
import sys
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

#: ``# repro-lint: disable=RPT001,RPL002`` / ``disable-file=RPT001``.
_PRAGMA_RE = re.compile(
    r"#\s*repro-lint\s*:\s*(disable(?:-file)?)\s*=\s*([A-Z]{3}\d{3}(?:\s*,\s*[A-Z]{3}\d{3})*)"
)

#: The repository's root (``src/repro_torch/analysis/core.py`` → three up).
REPO_ROOT = Path(__file__).resolve().parents[3]
#: The root scripts that the port added beside ``chip_smoke.py``.
PORT_SCRIPTS = ("chip_smoke.py", "serve_compare.py", "xlstm_sensitivity.py",
                "coupling_gemm_breakdown.py", "phase_step_multi_breakdown.py")


@dataclasses.dataclass(frozen=True)
class Finding:
    """One rule violation at a source location."""

    path: str
    line: int
    col: int
    code: str
    message: str

    def render(self) -> str:
        return f"{self.path}:{self.line}:{self.col}: {self.code} {self.message}"


class FileContext:
    """One parsed source file plus the path facts the rules key on."""

    def __init__(self, path: str, source: str, tree: ast.Module):
        self.path = path
        self.tree = tree
        parts = [p for p in re.split(r"[\\/]", path) if p not in ("", ".")]
        name = parts[-1] if parts else path
        self.is_fixture = "fixtures" in parts
        #: tests/benchmarks get a pass on rules about *production* hygiene
        #: (pinned seeds are the point of a test) — unless the file is a
        #: lint fixture, which must trip its rule wherever it lives.
        self.is_test_path = not self.is_fixture and (
            "tests" in parts
            or "benchmarks" in parts
            or name.startswith("test_")
            or name == "conftest.py"
        )
        self._file_disabled: Set[str] = set()
        self._line_disabled: Dict[int, Set[str]] = {}
        for lineno, text in enumerate(source.splitlines(), start=1):
            m = _PRAGMA_RE.search(text)
            if not m:
                continue
            codes = {c.strip() for c in m.group(2).split(",")}
            if m.group(1) == "disable-file":
                self._file_disabled |= codes
            else:
                self._line_disabled.setdefault(lineno, set()).update(codes)

    def suppressed(self, finding: Finding) -> bool:
        if finding.code in self._file_disabled:
            return True
        for lineno in (finding.line, finding.line - 1):
            if finding.code in self._line_disabled.get(lineno, set()):
                return True
        return False


def clean_tree(root: Path = REPO_ROOT) -> List[str]:
    """The port's files, the default of :func:`main`."""
    paths = [root / "src" / "repro_torch"]
    paths += sorted((root / "tests").glob("test_torch_*.py"))
    paths += sorted((root / "examples").glob("torch_*.py"))
    paths += [root / name for name in PORT_SCRIPTS]
    return [str(p) for p in paths if p.exists()]


def iter_python_files(paths: Iterable[str]) -> List[str]:
    """Expand files/directories into a sorted, deduplicated .py file list.

    Directory walks skip hidden dirs, ``__pycache__``, and ``fixtures``
    dirs; explicitly named paths are always included (that is how the test
    suite lints one fixture at a time).
    """
    out: List[str] = []
    seen: Set[str] = set()

    def add(p: str) -> None:
        key = os.path.normpath(p)
        if key not in seen:
            seen.add(key)
            out.append(key)

    for path in paths:
        if os.path.isfile(path):
            add(path)
            continue
        for root, dirs, files in os.walk(path):
            dirs[:] = sorted(
                d
                for d in dirs
                if not d.startswith(".") and d not in ("__pycache__", "fixtures")
            )
            for fname in sorted(files):
                if fname.endswith(".py"):
                    add(os.path.join(root, fname))
    return out


def lint_paths(
    paths: Iterable[str], select: Optional[Iterable[str]] = None
) -> Tuple[List[Finding], List[str]]:
    """Run the rule set over ``paths``; returns (findings, file errors)."""
    from repro_torch.analysis.rules import RULES

    codes = sorted(RULES) if select is None else sorted(set(select))
    unknown = set(codes) - set(RULES)
    if unknown:
        raise ValueError(f"unknown rule codes: {sorted(unknown)}; known: {sorted(RULES)}")

    findings: List[Finding] = []
    errors: List[str] = []
    for path in iter_python_files(paths):
        try:
            with open(path, encoding="utf-8") as f:
                source = f.read()
            tree = ast.parse(source, filename=path)
        except (OSError, SyntaxError, ValueError) as exc:
            errors.append(f"{path}: {exc}")
            continue
        ctx = FileContext(path, source, tree)
        for code in codes:
            findings.extend(f for f in RULES[code].check(ctx) if not ctx.suppressed(f))
    findings.sort(key=lambda f: (f.path, f.line, f.col, f.code))
    return findings, errors


def main(argv: Optional[Sequence[str]] = None) -> int:
    """``repro-torch-lint`` CLI.  Exit 0 clean, 1 findings (or a compiled
    kernel missing a planner's constant, with ``--vmem``), 2 usage/parse
    errors."""
    from repro_torch.analysis.rules import RULES

    ap = argparse.ArgumentParser(
        prog="repro-torch-lint",
        description="Torch-aware static lint for the port's hazards.",
    )
    ap.add_argument("paths", nargs="*", default=None,
                    help="files or directories to lint (default: the port's files)")
    ap.add_argument("--select", default=None,
                    help="comma-separated rule codes to run (default: all)")
    ap.add_argument("--list-rules", action="store_true",
                    help="print the rule table and exit")
    ap.add_argument("--vmem", action="store_true",
                    help="also run the shared-memory budget of every launch plan "
                         "(imports torch): static, and the compiled kernels on the card")
    ap.add_argument("--device", default=None,
                    help="with --vmem: 'cpu' runs the static budget alone "
                         "(default: the GPU, which the compiled check needs)")
    args = ap.parse_args(argv)

    if args.list_rules:
        for code in sorted(RULES):
            print(f"{code}  {RULES[code].summary}")
        return 0

    select = None
    if args.select:
        select = [c.strip() for c in args.select.split(",") if c.strip()]
    try:
        findings, errors = lint_paths(args.paths or clean_tree(), select=select)
    except ValueError as exc:
        print(str(exc), file=sys.stderr)
        return 2

    for err in errors:
        print(f"error: {err}", file=sys.stderr)
    for finding in findings:
        print(finding.render())

    status = 0
    if errors:
        status = 2
    if findings:
        print(f"\n{len(findings)} finding(s). Suppress a deliberate one with "
              "`# repro-lint: disable=CODE` on or above the line.")
        status = max(status, 1)

    if args.vmem:
        from repro_torch.analysis import vmem

        if vmem.report(sys.stdout):
            status = max(status, 1)
        if args.device != "cpu" and vmem.report_compiled(sys.stdout, args.device):
            status = max(status, 1)

    if status == 0:
        print("repro-torch-lint: clean")
    return status
