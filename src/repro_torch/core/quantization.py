"""Quantization substrate: n-bit signed weights, 4-bit phases, int4 packing.

5-bit signed coupling weights are carried in ``int8``; phase counters of
``phase_bits <= 4`` can be packed two per byte.  Every function mirrors
``repro.core.quantization`` bit for bit: ``torch.round`` rounds half to even
like ``jnp.round``, and the float32 division order is the reference's.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

DEFAULT_WEIGHT_BITS = 5


@dataclasses.dataclass(frozen=True, eq=False)
class QuantizedWeights:
    """Symmetric-quantized integer weights plus dequantization scale."""

    values: torch.Tensor  # int8, in [-qmax, qmax]
    scale: torch.Tensor  # float32 scalar: w_float ≈ values * scale
    bits: int = DEFAULT_WEIGHT_BITS

    @property
    def qmax(self) -> int:
        return (1 << (self.bits - 1)) - 1

    def dequantize(self) -> torch.Tensor:
        return self.values.to(torch.float32) * self.scale


def symmetric_qmax(bits: int) -> int:
    """Largest representable magnitude for ``bits``-bit signed symmetric."""
    return (1 << (bits - 1)) - 1


def _scale(w: torch.Tensor, qmax: int) -> torch.Tensor:
    absmax = w.abs().max()
    one = torch.ones((), dtype=torch.float32, device=w.device)
    return torch.where(absmax > 0, absmax / qmax, one).to(torch.float32)


def quantize_weights(w: torch.Tensor, bits: int = DEFAULT_WEIGHT_BITS) -> QuantizedWeights:
    """Symmetric round-to-nearest quantization to ``bits`` signed bits
    (range [-qmax, qmax]; -2**(bits-1) is unused so q(-w) == -q(w))."""
    w = w.to(torch.float32)
    qmax = symmetric_qmax(bits)
    scale = _scale(w, qmax)
    q = torch.clamp(torch.round(w / scale), -qmax, qmax).to(torch.int8)
    return QuantizedWeights(values=q, scale=scale, bits=bits)


def fake_quantize(w: torch.Tensor, bits: int = DEFAULT_WEIGHT_BITS) -> torch.Tensor:
    """Quantize-dequantize; bit-exact with ``quantize_weights(w).dequantize()``."""
    w = w.to(torch.float32)
    qmax = symmetric_qmax(bits)
    scale = _scale(w, qmax)
    return torch.clamp(torch.round(w / scale), -qmax, qmax) * scale


def quantize_phase(theta_continuous: torch.Tensor, phase_bits: int = 4) -> torch.Tensor:
    """Quantize a continuous phase in [0, 2π) to a ``phase_bits`` counter."""
    n = 1 << phase_bits
    two_pi = torch.tensor(2 * math.pi, dtype=torch.float32)
    idx = torch.round(theta_continuous / two_pi * n).to(torch.int32) % n
    return idx.to(torch.uint8)


def pack_int4(values: torch.Tensor) -> torch.Tensor:
    """Pack int8 values in [-8, 7] two per byte (low nibble first); even last axis."""
    if values.shape[-1] % 2 != 0:
        raise ValueError(f"last axis must be even, got {tuple(values.shape)}")
    lo = values[..., 0::2].to(torch.int32) & 0xF
    hi = values[..., 1::2].to(torch.int32) & 0xF
    return (lo | (hi << 4)).to(torch.uint8)


def unpack_int4(packed: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`pack_int4` (sign-extending each nibble)."""
    p = packed.to(torch.int32)
    lo, hi = p & 0xF, (p >> 4) & 0xF
    lo = torch.where(lo >= 8, lo - 16, lo)
    hi = torch.where(hi >= 8, hi - 16, hi)
    out = torch.stack([lo, hi], dim=-1).to(torch.int8)
    return out.reshape(*packed.shape[:-1], packed.shape[-1] * 2)


def pack_phases(phases: torch.Tensor) -> torch.Tensor:
    """Pack unsigned 4-bit phase counters two per byte (low nibble first).

    An odd last axis is padded with a zero nibble; returns ``uint8`` of
    last-axis length ``ceil(n / 2)``.
    """
    n = phases.shape[-1]
    p = phases.to(torch.int32)
    if n % 2 != 0:
        p = torch.nn.functional.pad(p, (0, 1))
    lo = p[..., 0::2] & 0xF
    hi = p[..., 1::2] & 0xF
    return (lo | (hi << 4)).to(torch.uint8)


def unpack_phases(packed: torch.Tensor, n: int) -> torch.Tensor:
    """Inverse of :func:`pack_phases`: ``(..., ceil(n/2))`` → ``(..., n)`` uint8."""
    if packed.shape[-1] != (n + 1) // 2:
        raise ValueError(
            f"unpack_phases: packed last axis {packed.shape[-1]} != "
            f"ceil({n}/2) = {(n + 1) // 2}"
        )
    p = packed.to(torch.int32)
    out = torch.stack([p & 0xF, (p >> 4) & 0xF], dim=-1).to(torch.uint8)
    out = out.reshape(*packed.shape[:-1], packed.shape[-1] * 2)
    return out[..., :n]


def weight_memory_bits(n: int, bits: int = DEFAULT_WEIGHT_BITS) -> int:
    """Total coupling-weight memory in bits for an N-oscillator ONN (Table 1)."""
    return n * n * bits


def accumulator_bits(n: int, weight_bits: int = DEFAULT_WEIGHT_BITS) -> int:
    """Width needed to accumulate N signed ``weight_bits`` values exactly:
    ⌈log2(N·qmax + 1)⌉ + 1 bits."""
    qmax = symmetric_qmax(weight_bits)
    # float32 log2, as the reference computes it.
    return int(np.ceil(np.log2(np.float32(n * qmax + 1)))) + 1


def check_weight_range(values: torch.Tensor, bits: int = DEFAULT_WEIGHT_BITS) -> torch.Tensor:
    """Bool scalar tensor: all values representable in ``bits`` signed bits."""
    qmax = symmetric_qmax(bits)
    return torch.all((values >= -qmax) & (values <= qmax))
