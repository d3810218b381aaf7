"""Roofline terms of a dry-run cell (the port of ``repro.launch.hlo_analysis``).

The reference parses the compiled HLO's collectives (``parse_collectives``);
the port has no HLO, so that parser is not ported: the dry run
(``repro_torch.launch.dryrun``) counts the collectives its specs imply, with
the same ring-algorithm wire factors per op:

  all-gather          (S−1)/S · result_bytes
  reduce-scatter      (S−1)   · result_bytes        (input = S · result)
  all-reduce          2·(S−1)/S · result_bytes      (ring RS + AG)
  all-to-all          (S−1)/S · result_bytes
  collective-permute  result_bytes

where S is the size of the group that takes part.  These are
*per-participating-device* bytes on the wire.

Roofline constants: the H100 SXM's, from NVIDIA's data sheet at the 700 W
limit (dense, per card) — 989 TFLOP/s bf16, 3.35 TB/s HBM, 450 GB/s NVLink
each way.  They are :class:`Roofline`'s defaults, and fields, so the same
arithmetic runs on any card's peaks.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit), per card
H100_BF16_FLOPS_PER_S = 989e12
H100_FP32_FLOPS_PER_S = 67e12  # outside the tensor cores
H100_INT8_OPS_PER_S = 1.979e15
H100_HBM_BYTES_PER_S = 3.35e12
H100_NVLINK_BYTES_PER_S = 450e9  # each way
H100_HBM_BYTES = 80e9  # one card's HBM (80 GB)

WIRE_FACTOR = {
    "all-gather": lambda s: (s - 1) / s,
    "reduce-scatter": lambda s: float(s - 1),
    "all-reduce": lambda s: 2 * (s - 1) / s,
    "all-to-all": lambda s: (s - 1) / s,
    "collective-permute": lambda s: 1.0,
}


@dataclasses.dataclass
class CollectiveStats:
    counts: Dict[str, int]
    bytes: Dict[str, float]  # wire bytes per participating device

    @property
    def total_bytes(self) -> float:
        return sum(self.bytes.values())


@dataclasses.dataclass
class Roofline:
    """Three-term roofline for one cell (seconds, per device)."""

    flops_per_device: float
    hbm_bytes_per_device: float
    collective_bytes_per_device: float
    n_devices: int
    peak_flops: float = H100_BF16_FLOPS_PER_S
    hbm_bw: float = H100_HBM_BYTES_PER_S
    link_bw: float = H100_NVLINK_BYTES_PER_S

    @property
    def compute_s(self) -> float:
        return self.flops_per_device / self.peak_flops

    @property
    def memory_s(self) -> float:
        return self.hbm_bytes_per_device / self.hbm_bw

    @property
    def collective_s(self) -> float:
        return self.collective_bytes_per_device / self.link_bw

    @property
    def dominant(self) -> str:
        terms = {
            "compute": self.compute_s,
            "memory": self.memory_s,
            "collective": self.collective_s,
        }
        return max(terms, key=terms.get)

    @property
    def bound_s(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)

    def to_dict(self) -> dict:
        return {
            "flops_per_device": self.flops_per_device,
            "hbm_bytes_per_device": self.hbm_bytes_per_device,
            "collective_bytes_per_device": self.collective_bytes_per_device,
            "n_devices": self.n_devices,
            "compute_s": self.compute_s,
            "memory_s": self.memory_s,
            "collective_s": self.collective_s,
            "dominant": self.dominant,
        }


def model_flops(kind: str, n_params: int, tokens: int, n_active: Optional[int] = None) -> float:
    """Reference useful FLOPs: 6·N·D train, 2·N·D forward-only (per step)."""
    n = n_active if n_active is not None else n_params
    factor = 6.0 if kind == "train" else 2.0
    return factor * n * tokens
