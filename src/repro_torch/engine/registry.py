"""Solver registry: one name → factory table for every servable workload
(the port of ``repro.engine.registry``).

The engine serves *installed solver instances*; this module is the global
catalog they are built from.  Workload modules call :func:`register_solver`
at import time (``repro_torch.api`` registers ``retrieval`` and
``maxcut``, ``repro_torch.engine.adapters`` registers ``lm``), so

    engine.install("letters", "retrieval", solver=retrieval_solver)

resolves "retrieval" here and constructs a fresh adapter bound to the
engine.  Keeping the table module-level (not per-engine) mirrors how the
FPGA bitstream catalog is global while each board serves its own queue.
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

#: name → (factory, one-line description).
_SOLVERS: Dict[str, Tuple[Callable[..., object], str]] = {}


def register_solver(name: str, factory: Callable[..., object], doc: str = "") -> None:
    """Register ``factory(**kwargs) -> EngineSolver`` under ``name``.

    Re-registering the same name with a different factory raises — a silent
    overwrite would reroute every engine built afterwards.  Re-registering
    the *same* factory (module re-import) is a no-op.
    """
    if name in _SOLVERS and _SOLVERS[name][0] is not factory:
        raise ValueError(f"solver {name!r} already registered")
    _SOLVERS[name] = (factory, doc)


def solver_factory(name: str) -> Callable[..., object]:
    try:
        return _SOLVERS[name][0]
    except KeyError:
        known = ", ".join(sorted(_SOLVERS)) or "<none>"
        raise KeyError(f"no solver {name!r} registered (known: {known})") from None


def available_solvers() -> Dict[str, str]:
    """name → description of every registered workload."""
    return {name: doc for name, (_, doc) in sorted(_SOLVERS.items())}
