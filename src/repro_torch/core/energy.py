"""Ising / Hopfield energy functions (paper eq. 1; the port of
``repro.core.energy``).

H = −Σ_{i<j} J_ij σ_i σ_j − μ Σ_i h_i σ_i.

With σ ∈ {−1,+1} the self-coupling terms J_ii σ_i² are a constant offset; we
expose both the pair-sum convention (used for reporting) and the raw quadratic
form (used by the property tests).

The sums run in float64 and are rounded once to float32, so the results do
not depend on the summation order or on TF32 settings, on the CPU or the
card.  The bounds that tie them to the reference's float32 sums are stated
per function.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.checks import require_int_dtype


def hamiltonian(
    j,
    sigma,
    h: Optional[torch.Tensor] = None,
    mu: float = 1.0,
) -> torch.Tensor:
    """Ising energy with pair counting (i<j), excluding self-coupling.

    ``sigma`` is (..., N); the result is float32 of shape (...), on
    ``sigma``'s device.  The quadratic form, the self term and the field
    term are summed in float64 and rounded once to float32; μ then enters
    in float32, as in the reference.  For integer J and h whose sums stay
    below 2²⁴ in magnitude (N²·max|J| + N·max|h| < 2²⁴ suffices) every one
    of those sums is exact in both packages, so the result equals the
    reference's float32 einsum exactly, in any summation order.

    For other J it lies within 2 · γ_K · (Σ_ij |J_ij| + |μ| Σ_i |h_i|) of
    the reference's value, with K = N² + 2 and γ_K = K·2⁻²⁴ / (1 − K·2⁻²⁴):
    each of the two is within γ_K · (...) of the exact energy whatever order
    its sums take (the quadratic form sums N² exact terms ±J_ij, the trace
    and the field N; the two subtractions and the μ product add three
    roundings).  The bound means something while K·2⁻²⁴ < 1 (N ≤ 4095).
    """
    sig = torch.as_tensor(sigma).to(torch.float64)
    jf = torch.as_tensor(j).to(device=sig.device, dtype=torch.float64)
    quad = torch.einsum("...i,ij,...j->...", sig, jf, sig)
    self_term = torch.diagonal(jf).sum()  # σ_i² == 1
    out = -(0.5 * (quad - self_term)).to(torch.float32)
    if h is not None:
        hf = torch.as_tensor(h).to(device=sig.device, dtype=torch.float64)
        field = torch.einsum("i,...i->...", hf, sig).to(torch.float32)
        mu32 = torch.tensor(mu, dtype=torch.float32, device=sig.device)
        out = out - mu32 * field
    return out


def energy_trace(j, sigma_trace) -> torch.Tensor:
    """Energy at every step of a (T, ..., N) spin trajectory (the einsum of
    :func:`hamiltonian` broadcasts over the leading axes)."""
    return hamiltonian(j, sigma_trace)


def is_local_minimum(j, sigma) -> torch.Tensor:
    """True iff no single spin flip strictly lowers the energy.

    For symmetric J with zero diagonal, flipping spin i changes the energy by
    ΔH = 2 σ_i Σ_j J_ij σ_j, so a local minimum has σ_i · field_i ≥ 0 ∀i.

    ``j`` must be an integer (N, N) array and ``sigma`` one (N,) state, as in
    the reference.  The field J σ is a float64 product (torch has no integer
    matmul on the card): exact while N · max|J| < 2⁵³, which holds for any
    int32 J at N < 2²².  The reference's int32 product is exact while
    N · max|J| < 2³¹, so the two agree wherever it does not overflow.
    """
    jt = torch.as_tensor(require_int_dtype(j, "j"))
    sig = torch.as_tensor(sigma)
    if sig.dim() != 1:
        raise ValueError(f"is_local_minimum takes one (N,) state, got shape {tuple(sig.shape)}")
    s64 = sig.to(device=jt.device, dtype=torch.float64)
    field = jt.to(torch.float64) @ s64
    return torch.all(s64 * field >= 0)
