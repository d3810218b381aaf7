"""Repo-aware analysis of the port: the counterpart of ``repro.analysis``.

Three layers, by cost:

* ``repro-torch-lint`` / ``python -m repro_torch.analysis`` — pure-AST lint
  of the port's files for torch hazards, no torch import
  (:mod:`repro_torch.analysis.core`, :mod:`repro_torch.analysis.rules`).
* ``python -m repro_torch.analysis --vmem`` — the shared-memory, residency,
  grid and register budget of every launch plan, and the compiled kernels'
  attributes on the card (:mod:`repro_torch.analysis.vmem`).
* ``python -m repro_torch.analysis.tracegate`` — a gate on kernel builds,
  new launch plans, launches and host syncs of pinned workloads against the
  committed ``TRACE_BUDGET_TORCH.json`` (:mod:`repro_torch.analysis.tracegate`).

Only the first layer is imported here; the torch-dependent layers load
lazily so that the lint runs on an interpreter without torch.
"""

from repro_torch.analysis.core import Finding, lint_paths, main  # noqa: F401
from repro_torch.analysis.rules import RULES  # noqa: F401
