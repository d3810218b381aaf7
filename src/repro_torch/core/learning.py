"""Learning rules for associative-memory ONNs.

The paper trains pattern datasets with the Diederich–Opper I rule
(Diederich & Opper, PRL 1987): an iterative, perceptron-style local rule that
repeats Hebbian increments on (pattern, neuron) pairs whose stability
κ_i^μ = ξ_i^μ · (W ξ^μ)_i falls below a threshold, until every pattern is a
sufficiently stable fixed point.  Also provided: the plain Hebbian rule (the
DO-I starting point and a baseline).

Patterns ``xi``: (P, N) int8 in {−1, +1}.  Weights are float32 and are
quantized to the paper's 5-bit signed format afterwards
(:func:`repro_torch.core.quantization.quantize_weights`).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.core.checks import require_int_dtype
from repro_torch.core.coupling import int_matmul


def hebbian(xi: torch.Tensor, self_coupling: bool = True) -> torch.Tensor:
    """W = (1/N) Σ_μ ξ^μ ξ^μᵀ (optionally zeroing the diagonal), float32.

    The sum of ±1 products is an exact integer in float32 and the division
    is one IEEE operation, so the result is bit-exact with the reference.
    """
    n = xi.shape[1]
    x = xi.to(torch.float32)
    w = (x.t() @ x) / n
    if not self_coupling:
        w = w * (1.0 - torch.eye(n, dtype=w.dtype, device=w.device))
    return w


class DOResult(NamedTuple):
    weights: torch.Tensor  # (N, N) float32
    sweeps: torch.Tensor  # int32: sweeps executed
    converged: torch.Tensor  # bool: all stabilities ≥ threshold


def diederich_opper_i(
    xi,
    threshold: float = 1.0,
    lr: Optional[float] = None,
    max_sweeps: int = 500,
    self_coupling: bool = True,
    init_hebbian: bool = True,
    device=None,
) -> DOResult:
    """Diederich–Opper I: ΔW_i: = (lr) ξ_i^μ ξ^μ while κ_i^μ < threshold.

    One *sweep* visits every pattern sequentially and updates every unstable
    row of W for that pattern; ``lr`` defaults to 1/N.  A thin wrapper over
    :func:`repro_torch.train.doi.train_doi` with this function's own defaults
    (self-coupling on), on ``device`` (the GPU unless ``"cpu"``).  Equal to
    ``repro.core.learning.diederich_opper_i`` wherever no stability check
    ties the threshold within the float32 summation bound (see
    :mod:`repro_torch.train.doi`).
    """
    from repro_torch.train.doi import TrainConfig, train_doi  # train builds on core

    res = train_doi(
        xi,
        TrainConfig(
            threshold=float(threshold),
            max_sweeps=int(max_sweeps),
            self_coupling=bool(self_coupling),
            init_hebbian=bool(init_hebbian),
        ),
        lr=lr,
        device=device,
    )
    return DOResult(weights=res.weights, sweeps=res.sweeps, converged=res.converged)


def stability_margins(w: torch.Tensor, xi: torch.Tensor) -> torch.Tensor:
    """κ^μ_i = ξ_i^μ (W ξ^μ)_i for every pattern/neuron: (P, N) float32."""
    fields = xi.to(torch.float32) @ w.to(torch.float32).t()
    return xi.to(torch.float32) * fields


def patterns_are_fixed_points(w_int8: torch.Tensor, xi: torch.Tensor) -> torch.Tensor:
    """True iff every pattern is a strict fixed point of the sign dynamics."""
    require_int_dtype(w_int8, "w_int8")
    require_int_dtype(xi, "xi")
    fields = int_matmul(xi, w_int8)
    return torch.all(xi.to(torch.int32) * fields > 0)
