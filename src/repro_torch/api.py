"""Public facade of the port: one import surface, one protocol.

Quickstart::

    from repro_torch import api

    cfg = api.ONNConfig(n=506, backend="kernel")
    params = api.make_params(cfg, weights_int8)          # on the GPU
    out = api.RetrievalSolver(cfg, params).solve(corrupted_batch)

    adj = api.random_graph(torch.Generator().manual_seed(0), 506)
    solver = api.MaxCutSolver(replicas=64, backend="kernel")  # on the GPU
    res = solver.solve(adj, key=torch.Generator().manual_seed(1))

Pass ``device="cpu"`` to ``make_params`` (or to ``MaxCutSolver``) to run on
the CPU through the plain versions of the kernels.  A config with
``mode="rtl"`` and ``sync_jitter`` draws each request's enable-signal offset
from the ``torch.Generator`` passed as ``solve(..., key=generator)``;
``MaxCutSolver`` draws its initial spins and sweep orders the same way.
Both solvers serve through ``repro_torch.engine`` (``as_engine_solver``, and
the registry's "retrieval" and "maxcut" workloads, registered here).
``RetrievalSolver.from_patterns`` trains DO-I couplings on a pattern library
(:mod:`repro_torch.train`).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Protocol, runtime_checkable

import torch

from repro_torch.core.checks import resolve_device
from repro_torch.core.dynamics import (  # noqa: F401 — re-exported API
    BACKENDS,
    BatchState,
    ONNConfig,
    ONNResult,
    OnnParams,
    OnnState,
    advance_chunk,
    batch_done,
    batch_result,
    dead_batch_state,
    functional_update,
    hybrid_mac_sum,
    init_batch_state,
    init_state,
    initial_phase,
    install_lanes,
    make_params,
    pad_config,
    pad_params,
    pad_sigma,
    retrieve,
    run,
    run_batch,
    sign_update,
    step,
    validate_weights,
    weighted_sum,
)
from repro_torch.core.ising import (  # noqa: F401 — re-exported API
    MaxCutResult,
    cut_value_exact,
    maxcut_couplings,
    random_graph,
    solve_maxcut,
    solve_maxcut_batch,
)
from repro_torch.core.learning import diederich_opper_i, hebbian  # noqa: F401
from repro_torch.core.quantization import quantize_weights  # noqa: F401
from repro_torch.engine.registry import register_solver


@runtime_checkable
class Solver(Protocol):
    """A problem-instance → result map.

    ``key`` is a ``torch.Generator`` where the solver draws randomness (rtl
    ``sync_jitter``), and must be None where it draws none: a solver rejects
    a key it would ignore.
    """

    def solve(self, instance: torch.Tensor, key: Optional[Any] = None) -> Any:
        ...


@dataclasses.dataclass(frozen=True, eq=False)
class RetrievalSolver:
    """Batched pattern retrieval on a fixed trained ONN (paper Fig. 7).

    ``solve`` takes a (B, N) ±1 batch of (corrupted) patterns (tensor or
    numpy), moves it to the device of ``params`` (placed there by
    :func:`make_params`: the GPU unless ``device="cpu"``) and returns an
    :class:`ONNResult` on that device.

    With ``mode="rtl"`` and ``sync_jitter`` each request's enable-signal
    offset is drawn as ``torch.randint(0, clocks_per_cycle, (B,),
    generator=key)`` on the generator's device, so the same seed gives the
    same result; ``key`` is then required.  Any other config draws nothing
    and rejects a key.
    """

    config: ONNConfig
    params: OnnParams

    @classmethod
    def from_patterns(
        cls,
        xi: Any,
        *,
        weight_bits: int = 5,
        device=None,
        **cfg_kwargs: Any,
    ) -> "RetrievalSolver":
        """Train DO-I couplings on patterns ``xi`` (P, N) on ``device`` (the
        GPU unless ``"cpu"``), quantize them to ``weight_bits`` and build the
        solver there (``diederich_opper_i`` with its defaults)."""
        do = diederich_opper_i(xi, device=device)
        qw = quantize_weights(do.weights, bits=weight_bits)
        cfg = ONNConfig(n=int(torch.as_tensor(xi).shape[1]), weight_bits=weight_bits,
                        **cfg_kwargs)
        return cls(config=cfg, params=make_params(cfg, qw.values, device=device))

    def solve(self, instance: torch.Tensor, key: Optional[Any] = None) -> ONNResult:
        cfg = self.config
        device = self.params.weights.device
        batch = torch.as_tensor(instance).to(device)
        if not (cfg.mode == "rtl" and cfg.sync_jitter):
            if key is not None:
                raise ValueError(
                    "RetrievalSolver.solve: this config draws no randomness; "
                    "key must be None"
                )
            return retrieve(cfg, self.params, batch)
        if not isinstance(key, torch.Generator):
            raise ValueError(
                "RetrievalSolver.solve: mode='rtl' with sync_jitter draws each "
                f"request's enable offset; pass key=torch.Generator, got {type(key).__name__}"
            )
        t0 = torch.randint(
            0, cfg.clocks_per_cycle, (batch.shape[0],), generator=key,
            device=key.device, dtype=torch.int32,
        )
        return retrieve(cfg, self.params, batch, t0=t0.to(device))

    def as_engine_solver(self):
        """This solver as an installable ``repro_torch.engine`` workload adapter."""
        from repro_torch.engine.adapters import RetrievalEngineSolver

        return RetrievalEngineSolver(solver=self)


@dataclasses.dataclass(frozen=True)
class MaxCutSolver:
    """Batched oscillatory Ising machine on a max-cut embedding (paper §2.2).

    The fields and defaults of ``repro.api.MaxCutSolver`` (the kernel route
    is ``backend="kernel"`` / ``hybrid_impl="kernel"``), plus ``device``: the
    port's device rule, the GPU unless ``"cpu"``.  ``solve`` takes an (N, N)
    adjacency matrix, or an (I, N, N) batch of same-size instances, and a
    required ``torch.Generator``.  From it, on the generator's device, it
    draws ``torch.rand((I, replicas, N))`` (the initial spins), then
    ``torch.rand((I, sweeps, N))`` (one priority row per sweep), and hands
    both to :func:`solve_maxcut_batch` on ``device``: the same seed gives the
    same result.  Each instance runs ``replicas`` anneals of ``sweeps``
    grouped sweeps (``stagger_groups`` groups; 0 → auto, N → asynchronous),
    every field through ``backend``; ``stagnation`` > 0 freezes a replica
    after that many sweeps without a better cut, checked every
    ``settle_chunk`` sweeps.

    Every result field equals the reference's under the same draws for
    integer edge weights.  For other weights the spins and sweep counts are
    the reference's and ``cut_value``, ``trace`` and ``replica_cuts`` are
    within 2 · (γ_E + 2⁻²⁴) · Σ_{i<j} |A_ij| of its values (float32 sums in
    another order; see ``ising.cut_value_exact``).
    """

    sweeps: int = 64
    weight_bits: int = 5
    replicas: int = 1
    stagger_groups: int = 0  # update groups K per sweep (0 = auto, n = async)
    stagnation: int = 0  # sweeps without improvement before freeze (0 = off)
    backend: str = "parallel"
    parallel_factor: int = 0
    hybrid_impl: str = "scan"
    settle_chunk: int = 8
    device: Optional[str] = None  # None: the GPU

    def config(self, n: int) -> ONNConfig:
        """The backend-carrying ONN config of an N-vertex solve."""
        return ONNConfig(
            n=n,
            weight_bits=self.weight_bits,
            max_cycles=self.sweeps,
            backend=self.backend,
            parallel_factor=self.parallel_factor,
            hybrid_impl=self.hybrid_impl,
            settle_chunk=self.settle_chunk,
        )

    def solve(self, instance: torch.Tensor, key: Optional[Any] = None) -> MaxCutResult:
        if not isinstance(key, torch.Generator):
            raise ValueError(
                "MaxCutSolver.solve draws its initial spins and sweep orders; pass "
                f"key=torch.Generator, got {type(key).__name__}"
            )
        dev = resolve_device(self.device)
        adj = torch.as_tensor(instance).to(dev)
        n = adj.shape[-1]
        inst = 1 if adj.dim() == 2 else adj.shape[0]
        init = torch.rand((inst, self.replicas, n), generator=key, device=key.device)
        sweeps = torch.rand((inst, self.sweeps, n), generator=key, device=key.device)
        if adj.dim() == 2:
            init, sweeps = init[0], sweeps[0]
        return solve_maxcut_batch(
            self.config(n), adj, init.to(dev), sweeps.to(dev),
            stagger_groups=self.stagger_groups, stagnation=self.stagnation,
        )

    def as_engine_solver(self):
        """This solver as an installable ``repro_torch.engine`` workload adapter."""
        from repro_torch.engine.adapters import MaxCutEngineSolver

        return MaxCutEngineSolver(solver=self)


# ---------------------------------------------------------------------------
# Engine registration: both Solver implementations serve through the engine
# ---------------------------------------------------------------------------


def _retrieval_engine_factory(**kwargs: Any):
    from repro_torch.engine.adapters import RetrievalEngineSolver

    return RetrievalEngineSolver(**kwargs)


def _maxcut_engine_factory(**kwargs: Any):
    from repro_torch.engine.adapters import MaxCutEngineSolver

    return MaxCutEngineSolver(**kwargs)


register_solver(
    "retrieval",
    _retrieval_engine_factory,
    "batched pattern retrieval on a trained ONN (solver=, or xi= + config kwargs: DO-I)",
)
register_solver(
    "maxcut",
    _maxcut_engine_factory,
    "batched multi-replica Ising-machine max-cut (sweeps=, replicas=, "
    "stagger_groups=, backend=, parallel_factor=, device=)",
)
