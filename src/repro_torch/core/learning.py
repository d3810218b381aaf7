"""Learning rules for associative-memory ONNs.

Patterns ``xi``: (P, N) int8 in {−1, +1}.  Weights are float32 and are
quantized to the paper's 5-bit signed format afterwards
(:func:`repro_torch.core.quantization.quantize_weights`).  The
Diederich–Opper I trainer waits for the training slice of the port.
"""

from __future__ import annotations

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
