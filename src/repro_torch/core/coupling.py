"""Coupling-element arithmetic: parallel (recurrent) vs serialized (hybrid).

Paper §2.3 / §3.  Both architectures compute exactly the same integer sum
S_i = Σ_j W_ij σ_j; they differ in hardware cost and timing.

PyTorch has no integer matrix product on CUDA, so :func:`int_matmul` runs
the product in a float type in which every operand and every partial sum is
an exact integer: |partial| ≤ N · 128² for operands in the int8 range, so
float32 is exact while N · 128² ≤ 2**24 (N ≤ 1024) and float64 while
N · 128² ≤ 2**53.  The tolerance against the integer reference is therefore
0, whatever the summation order.
"""

from __future__ import annotations

import torch

from repro_torch.core.checks import require_int_dtype

#: Largest magnitude of an int8 operand; bounds every partial sum by N·128².
_INT8_MAG = 128


def int_matmul(sigma: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Exact S = σ Wᵀ for integer ``sigma`` (..., N) and ``w`` (M, N) → int32.

    A batched ``w`` (I, M, N), one matrix per instance, takes ``sigma``
    (I, B, N) and gives (I, B, M).  Operands must lie in the int8 range
    (spins, 5-bit weights).  Computed in float32 when N·128² ≤ 2**24, else
    float64 (exact to 2**53).
    """
    n = w.shape[-1]
    bound = n * _INT8_MAG * _INT8_MAG
    if bound <= 2**24:
        ftype = torch.float32
    elif bound <= 2**53:
        ftype = torch.float64
    else:
        raise ValueError(f"int_matmul: N={n} exceeds the exact float64 range")
    out = torch.matmul(sigma.to(ftype), w.to(ftype).transpose(-1, -2))
    return out.to(torch.int32)


def check_shapes(w: torch.Tensor, sigma: torch.Tensor) -> None:
    """Raise unless ``w`` (M, N) contracts ``sigma`` (..., N), or ``w``
    (I, M, N) holds one such matrix per instance of ``sigma`` (I, B, N)."""
    if w.dim() not in (2, 3):
        raise ValueError(f"coupling matrix must be 2-d or 3-d, got {tuple(w.shape)}")
    if sigma.shape[-1] != w.shape[-1]:
        raise ValueError(
            f"spin vector {tuple(sigma.shape)} incompatible with {tuple(w.shape)}"
        )
    if w.dim() == 3 and (sigma.dim() != 3 or sigma.shape[0] != w.shape[0]):
        raise ValueError(
            f"batched couplings {tuple(w.shape)} need spins (I, B, N), got {tuple(sigma.shape)}"
        )


def weighted_sum_parallel(w: torch.Tensor, sigma: torch.Tensor) -> torch.Tensor:
    """Recurrent-architecture weighted sum, one fully parallel contraction.

    ``w``: (M, N) int8, ``sigma``: (..., N) int8 in {−1, +1} → (..., M) int32;
    or per instance, ``w`` (I, M, N) with ``sigma`` (I, B, N) → (I, B, M).
    """
    check_shapes(w, sigma)
    require_int_dtype(w, "w")
    return int_matmul(sigma, w)


def weighted_sum_serial(w: torch.Tensor, sigma: torch.Tensor, chunk: int = 1) -> torch.Tensor:
    """Hybrid-architecture weighted sum: accumulate ``chunk`` inputs at a time
    into an int32 accumulator (the serialized MAC of Fig. 5).  A ragged tail
    is simply a shorter last chunk, which leaves the integer sum unchanged."""
    check_shapes(w, sigma)
    require_int_dtype(w, "w")
    if chunk <= 0:
        raise ValueError(f"chunk must be positive, got {chunk}")
    n = w.shape[-1]
    acc = torch.zeros((*sigma.shape[:-1], w.shape[-2]), dtype=torch.int32, device=sigma.device)
    for start in range(0, n, chunk):
        acc = acc + int_matmul(sigma[..., start:start + chunk], w[..., start:start + chunk])
    return acc


def adders_required_parallel(n: int) -> int:
    """Adder count of the recurrent architecture: N rows × (N−1) adders."""
    return n * (n - 1)


def adders_required_serial(n: int) -> int:
    """Adder count of the hybrid architecture: one accumulator per row."""
    return n


def serialization_factor(n: int, overhead_clocks: int = 2, parallel: int = 1) -> int:
    """Fast-clock cycles per slow-clock phase update: ``ceil(N / P)`` passes
    plus a small control overhead (paper §3)."""
    if parallel <= 0:
        raise ValueError(f"parallel must be positive, got {parallel}")
    return -(-n // parallel) + overhead_clocks
