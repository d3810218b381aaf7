"""ONN configurations: the paper's design points + the beyond-paper scale-up.

* ``ONN_RECURRENT_48`` — the recurrent architecture at its Zynq-7020 maximum
  (48 oscillators, 5 weight bits, 4 phase bits; paper Table 5).
* ``ONN_HYBRID_506``   — the hybrid architecture at its maximum (506
  oscillators, the paper's headline result).
* ``ONN_LARGE``        — the scale-up the paper defers to future work, on the
  kernel backend.

The same design points as ``repro.configs.onn``.
"""

from __future__ import annotations

from repro_torch.core.dynamics import ONNConfig

ONN_RECURRENT_48 = ONNConfig(n=48, architecture="recurrent", mode="functional")
ONN_HYBRID_506 = ONNConfig(n=506, architecture="hybrid", mode="functional")

ONN_LARGE_N = 131072
ONN_LARGE_BATCH = 1024
ONN_LARGE = ONNConfig(
    n=ONN_LARGE_N, architecture="hybrid", mode="functional", backend="kernel"
)

# Paper-scale batched cell.
ONN_PAPER_BATCH = 1024

ONN_CELLS = {
    "onn_506": {"n": 506, "batch": ONN_PAPER_BATCH, "cycles": 32},
    "onn_131072": {"n": ONN_LARGE_N, "batch": ONN_LARGE_BATCH, "cycles": 32},
}
