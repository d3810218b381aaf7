"""Phase-controlled digital oscillator semantics (paper §2.3, Fig. 3).

Each oscillator is a ``uint8`` phase counter in the rotating frame of the
global reference oscillator; amplitude ``a = 1`` iff the counter is in the
first half-period, spin ``sigma = +1`` iff ``a == 1``.  Same conventions as
the JAX reference (``repro.core.oscillator``).  The explicit shift-register
model (:class:`ShiftRegisterOscillator`, numpy, one oscillator clock by
clock) is kept only as the oracle the tests hold the counter model to.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

DEFAULT_PHASE_BITS = 4


def n_positions(phase_bits: int = DEFAULT_PHASE_BITS) -> int:
    """Number of shift-register positions == phases per period (paper eq. 4)."""
    return 1 << phase_bits


def phase_step_degrees(phase_bits: int = DEFAULT_PHASE_BITS) -> float:
    """Size of one phase step in degrees (paper eq. 5)."""
    return 360.0 / n_positions(phase_bits)


def oscillator_period(t_clock: float, phase_bits: int = DEFAULT_PHASE_BITS) -> float:
    """Oscillator period in seconds for a given clock period (paper eq. 3)."""
    return n_positions(phase_bits) * t_clock


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


@dataclasses.dataclass
class ShiftRegisterOscillator:
    """Explicit circular-shift-register oscillator (paper Fig. 3 + Table 3).

    Test oracle only: numpy, one oscillator, clock by clock.  The first half
    of the registers holds 1s, the second half 0s; each clock shifts left
    (register ``k`` receives the value of register ``k+1``, the last receives
    the first); the output taps register ``tap``.
    """

    phase_bits: int = DEFAULT_PHASE_BITS
    tap: int = 0

    def __post_init__(self) -> None:
        n = n_positions(self.phase_bits)
        self.registers = np.array([1] * (n // 2) + [0] * (n // 2), dtype=np.int8)

    def clock(self) -> None:
        self.registers = np.roll(self.registers, -1)

    def output(self) -> int:
        return int(self.registers[self.tap])

    def set_phase(self, theta: int) -> None:
        """Load the register state corresponding to phase counter ``theta``
        (the base pattern advanced by ``theta`` clocks)."""
        n = n_positions(self.phase_bits)
        base = np.array([1] * (n // 2) + [0] * (n // 2), dtype=np.int8)
        self.registers = np.roll(base, -int(theta) % n)
