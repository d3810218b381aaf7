"""Plain PyTorch versions of the port's kernels.

Each function is the semantics of one hand-written CUDA kernel in
``csrc/`` and of the TPU kernel it replaces (``repro.kernels.ref``): kernels
1-5 (``coupling_gemm.cu``, ``phase_step_multi.cu``), the hybrid
serialized-MAC kernels 6 and 7 (``coupling_gemm.cu``) and the quantized
matrix product, kernel 8 (``quantized_matvec.cu``).  The wrappers in
:mod:`repro_torch.kernels.ops` run these for tensors on the CPU;
``chip_smoke.py`` holds each CUDA kernel against them on the card.  The
integer products go through :func:`repro_torch.core.coupling.int_matmul`,
which is exact (tolerance 0) on both devices; kernel 8 is a float32 product,
held to the bound of reordered float32 summation.
"""

from __future__ import annotations

import torch

from repro_torch.core.checks import require_int_dtype
from repro_torch.core.coupling import int_matmul


def coupling_sum_ref(w: torch.Tensor, sigma: torch.Tensor) -> torch.Tensor:
    """S = σ Wᵀ: (B, N) int8 spins × (M, N) int8 weights → (B, M) int32;
    per instance, (I, B, N) × (I, M, N) → (I, B, M)."""
    require_int_dtype(w, "w")
    return int_matmul(sigma, w)


def onn_step_ref(w: torch.Tensor, sigma: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """σ' = sign(σWᵀ + h) as int8, where S + h == 0 keeps σ (W square)."""
    s = coupling_sum_ref(w, sigma) + require_int_dtype(bias, "bias").to(torch.int32)[None, :]
    return torch.where(s > 0, 1, torch.where(s < 0, -1, sigma.to(torch.int32))).to(torch.int8)


def quantized_matvec_ref(w_q: torch.Tensor, scale: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """y = (x W_qᵀ) · scale in float32: ``w_q`` (M, K) int8, ``scale`` (M,)
    float32, ``x`` (B, K) float32 → (B, M) float32.

    The product is one float32 matrix product, so its error against exact
    arithmetic is that of float32 summation, |err| ≤ K · 2⁻²⁴ · |scale_m| ·
    Σ_k |x_bk · w_mk| per element, in any summation order.  The caller keeps
    TF32 off (``torch.backends.cuda.matmul.allow_tf32``, False by default).
    """
    require_int_dtype(w_q, "w_q")
    acc = torch.matmul(x.to(torch.float32), w_q.to(torch.float32).t())
    return acc * scale.to(torch.float32)[None, :]


def _align(s: torch.Tensor, phase: torch.Tensor, half: int) -> torch.Tensor:
    return torch.where(
        s > 0, 0, torch.where(s < 0, half, phase.to(torch.int32))
    ).to(torch.int32)


def phase_step_ref(
    w: torch.Tensor,
    sigma: torch.Tensor,
    bias: torch.Tensor,
    phase: torch.Tensor,
    half: int,
) -> torch.Tensor:
    """Fused coupling sum + phase alignment, int32 phases.

    S = σWᵀ + h; θ' = 0 where S > 0, ``half`` where S < 0, θ where S == 0.
    """
    s = coupling_sum_ref(w, sigma) + require_int_dtype(bias, "bias").to(torch.int32)[None, :]
    return _align(s, phase, half)


def hybrid_coupling_sum_ref(w: torch.Tensor, sigma: torch.Tensor, parallel: int) -> torch.Tensor:
    """Serialized-MAC coupling sum, pass by pass (the hybrid datapath).

    An explicit loop over the ``ceil(N / parallel)`` passes: each pass adds
    a ``parallel``-wide column slice of every row (the last one ragged when
    ``parallel`` does not divide N) into an int32 accumulator.  ``w`` is
    (M, N), ``sigma`` (B, N) → (B, M) int32; per instance, ``w`` (I, M, N),
    ``sigma`` (I, B, N) → (I, B, M).
    """
    if parallel <= 0:
        raise ValueError(f"parallel must be positive, got {parallel}")
    require_int_dtype(w, "w")
    n = w.shape[-1]
    acc = torch.zeros((*sigma.shape[:-1], w.shape[-2]), dtype=torch.int32, device=sigma.device)
    for start in range(0, n, parallel):
        acc = acc + int_matmul(sigma[..., start:start + parallel], w[..., start:start + parallel])
    return acc


def hybrid_phase_step_ref(
    w: torch.Tensor,
    sigma: torch.Tensor,
    bias: torch.Tensor,
    phase: torch.Tensor,
    half: int,
    parallel: int,
) -> torch.Tensor:
    """Serialized-MAC coupling sum + the phase-align epilogue (int32 phases)."""
    s = hybrid_coupling_sum_ref(w, sigma, parallel)
    return _align(s + require_int_dtype(bias, "bias").to(torch.int32)[None, :], phase, half)


def phase_step_packed_ref(
    w: torch.Tensor, bias: torch.Tensor, phase: torch.Tensor, half: int
) -> torch.Tensor:
    """Packed-operand cycle: σ = +1 iff θ < half, then :func:`phase_step_ref`.

    ``phase`` is the *unpacked* (B, N) state; packing is a transport layout.
    """
    sigma = torch.where(phase.to(torch.int32) < half, 1, -1).to(torch.int8)
    return phase_step_ref(w, sigma, bias, phase, half)


def phase_step_multi_ref(
    w: torch.Tensor,
    bias: torch.Tensor,
    phase: torch.Tensor,
    prev_phase: torch.Tensor,
    t: torch.Tensor,
    settle_cycle: torch.Tensor,
    settled: torch.Tensor,
    cycled: torch.Tensor,
    frozen: torch.Tensor,
    frozen_p2: torch.Tensor,
    freeze_cycle: torch.Tensor,
    *,
    half: int,
    chunk: int,
    max_cycles: int,
):
    """``chunk`` functional-mode cycles + settle/freeze bookkeeping.

    (B, N) int32 phases and (B, 1) int32 bookkeeping columns (bools as
    {0, 1}) in and out; returns the 9-tuple (phase, prev_phase,
    settle_cycle, settled, cycled, frozen, frozen_p2, freeze_cycle, t).
    The updates run in the order of the reference's per-cycle step.
    """
    h = require_int_dtype(bias, "bias").to(torch.int32)[None, :]
    ph, prev = phase.to(torch.int32), prev_phase.to(torch.int32)
    t, sc = t.to(torch.int32), settle_cycle.to(torch.int32)
    sd, cy = settled.to(torch.int32), cycled.to(torch.int32)
    fz, fp2 = frozen.to(torch.int32), frozen_p2.to(torch.int32)
    fc = freeze_cycle.to(torch.int32)
    one = torch.ones_like(t)
    for _ in range(chunk):
        sigma = torch.where(ph < half, 1, -1).to(torch.int8)
        nph = _align(coupling_sum_ref(w, sigma) + h, ph, half)
        active = (fz == 0) & (t < max_cycles)
        not_first = t > 0
        lane_unchanged = torch.all(nph == ph, dim=-1, keepdim=True)
        phase_p2 = torch.all(nph == prev, dim=-1, keepdim=True)
        is_cycle2 = phase_p2 & ~lane_unchanged & not_first
        sc = torch.where(active & lane_unchanged & (sd == 0), t, sc)
        sd = torch.where(active & lane_unchanged, one, sd)
        cy = torch.where(active & is_cycle2 & (sd == 0), one, cy)
        newly = active & (lane_unchanged | is_cycle2)
        ph, prev = torch.where(active, nph, ph), torch.where(active, ph, prev)
        fp2 = torch.where(newly & is_cycle2, one, fp2)
        fc = torch.where(newly, t + 1, fc)
        fz = torch.where(newly, one, fz)
        t = torch.where(active, t + 1, t)
    return ph, prev, sc, sd, cy, fz, fp2, fc, t
