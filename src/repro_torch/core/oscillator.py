"""Phase-controlled digital oscillator semantics (paper §2.3, Fig. 3).

Each oscillator is a ``uint8`` phase counter in the rotating frame of the
global reference oscillator; amplitude ``a = 1`` iff the counter is in the
first half-period, spin ``sigma = +1`` iff ``a == 1``.  Same conventions as
the JAX reference (``repro.core.oscillator``).
"""

from __future__ import annotations

import torch

DEFAULT_PHASE_BITS = 4


def n_positions(phase_bits: int = DEFAULT_PHASE_BITS) -> int:
    """Number of shift-register positions == phases per period (paper eq. 4)."""
    return 1 << phase_bits


def amplitude(theta: torch.Tensor, phase_bits: int = DEFAULT_PHASE_BITS) -> torch.Tensor:
    """Square-wave amplitude (1/0) for phase counter ``theta``."""
    half = n_positions(phase_bits) // 2
    return (theta.to(torch.int32) < half).to(torch.int8)


def spin(theta: torch.Tensor, phase_bits: int = DEFAULT_PHASE_BITS) -> torch.Tensor:
    """Ising spin (+1 / -1) for phase counter ``theta``."""
    return (2 * amplitude(theta, phase_bits) - 1).to(torch.int8)


def phase_of_spin(sigma: torch.Tensor, phase_bits: int = DEFAULT_PHASE_BITS) -> torch.Tensor:
    """Map spins ±1 to the canonical phases 0 (in-phase) / half (anti-phase)."""
    half = n_positions(phase_bits) // 2
    return torch.where(sigma > 0, 0, half).to(torch.uint8)


def free_run(
    theta: torch.Tensor, clocks: int, phase_bits: int = DEFAULT_PHASE_BITS
) -> torch.Tensor:
    """Advance the phase counter ``clocks`` clock edges (lab frame)."""
    mask = n_positions(phase_bits) - 1
    return ((theta.to(torch.int32) + clocks) & mask).to(torch.uint8)


def reference_signal(weighted_sum: torch.Tensor, current_amp: torch.Tensor) -> torch.Tensor:
    """Per-oscillator reference level: high (1) for S > 0, low (0) for S < 0,
    the oscillator's own amplitude for S == 0."""
    return torch.where(
        weighted_sum > 0,
        1,
        torch.where(weighted_sum < 0, 0, current_amp.to(torch.int32)),
    ).to(torch.int8)


def phase_align(
    theta: torch.Tensor,
    weighted_sum: torch.Tensor,
    phase_bits: int = DEFAULT_PHASE_BITS,
) -> torch.Tensor:
    """Snap the phase to the reference wave: 0 if S > 0, ``half`` if S < 0,
    unchanged if S == 0 (rotating frame).  Returns ``uint8``."""
    half = n_positions(phase_bits) // 2
    return torch.where(
        weighted_sum > 0,
        0,
        torch.where(weighted_sum < 0, half, theta.to(torch.int32)),
    ).to(torch.uint8)
