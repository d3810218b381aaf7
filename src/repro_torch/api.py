"""Public facade of the port: one import surface, one protocol.

Quickstart::

    from repro_torch import api

    cfg = api.ONNConfig(n=506, backend="kernel")
    params = api.make_params(cfg, weights_int8)          # on the GPU
    out = api.RetrievalSolver(cfg, params).solve(corrupted_batch)

Pass ``device="cpu"`` to ``make_params`` to run on the CPU through the plain
versions of the kernels.  Training (DO-I), the Max-Cut solver and engine
registration wait for later slices of the port.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Protocol, runtime_checkable

import torch

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
from repro_torch.core.learning import hebbian  # noqa: F401
from repro_torch.core.quantization import quantize_weights  # noqa: F401


@runtime_checkable
class Solver(Protocol):
    """A problem-instance → result map.

    ``key`` is kept for the reference's signature; no solver of this slice
    draws randomness, and each rejects a key it would ignore.
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
    """

    config: ONNConfig
    params: OnnParams

    def solve(self, instance: torch.Tensor, key: Optional[Any] = None) -> ONNResult:
        if key is not None:
            raise ValueError(
                "RetrievalSolver.solve: functional-mode retrieval draws no "
                "randomness; key must be None"
            )
        batch = torch.as_tensor(instance).to(self.params.weights.device)
        return retrieve(self.config, self.params, batch)
