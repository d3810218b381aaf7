"""Tile choice and the multi-cycle eligibility ceiling, from Hopper's limits.

The TPU package budgets a 16 MiB VMEM per core (``VMEM_BUDGET_BYTES``,
``MULTI_KERNEL_MAX_N = 2048`` in ``repro.kernels.autotune``); none of that
carries over.  On an H100 the limits that matter are:

* shared memory a block can use: 232,448 bytes (227 KB), above 48 KB only as
  dynamic shared memory after an opt-in;
* 132 streaming multiprocessors, which the grid should fill;
* ``__dp4a`` consumes four int8 values per instruction, so the contraction
  is loaded in 4-byte words (kernels 1, 3, 4, 6, 7) or 16-byte vectors
  (kernel 5).

**Kernels 1, 3, 4, 6 and 7** (``csrc/coupling_gemm.cu``) use one fixed
tile: 64 lanes × 64 output rows × 64 contraction bytes, 256 threads each
owning 4 × 4 outputs.  Two 64 × 68-byte int8 tiles take 8.5 KB of static
shared memory, so the tile fits at every shape and the ragged edges are
masked in the kernel; nothing here depends on N.  The hybrid kernels 6 and 7
take the MAC width P and walk the contraction in groups of whole passes, by
the TPU package's pass-group rule
(``repro.kernels.coupling_kernel.hybrid_pass_groups``) with the 64-byte tile
in place of the VMEM block: ``max(1, 64 // P)`` passes per group, a P wider
than the tile walked in 64-byte sub-tiles.  The rule lives in the kernel
source (``group_width``); kernels 1, 3 and 4 walk 64-byte groups.

**Kernel 5** (``csrc/phase_step_multi.cu``) gives each block ``bb`` whole
lanes.  Its shared memory is the per-lane state: three int32 phase buffers
(θ, prev-θ, next θ) of N entries and one int8 spin row padded to a multiple
of 16 bytes::

    multi_smem_bytes(bb, N) = align16(12 · bb · N) + bb · align16(N)

plus under 1 KB of static flags.  With one lane per block this fits the
227 KB block limit up to N = :data:`MULTI_KERNEL_MAX_N` (17,801); past it the
dynamics take the per-cycle route through kernel 3.  W itself is not in
shared memory: it streams from L2 every cycle (50 MB of L2 holds W whole up
to N ≈ 7,000; past that it streams from device memory and the kernel slows,
but stays exact).
"""

from __future__ import annotations

#: Dynamic shared memory one block may use on an H100 (opt-in maximum).
SMEM_PER_BLOCK = 232_448
#: Static shared memory of kernel 5 (bookkeeping flags), rounded up.
MULTI_STATIC_SMEM = 1024
#: Streaming multiprocessors of an H100 SXM.
NUM_SMS = 132
#: Lanes per block of kernel 5: the kernel is instantiated for 1, 2, 4 and 8.
MULTI_MAX_LANES = 8
#: Contraction alignment of kernel 5's 16-byte vector loads.
K_ALIGN = 16


def padded_k(n: int) -> int:
    """Row length of W as kernel 5 reads it: N rounded up to 16 bytes."""
    return -(-n // K_ALIGN) * K_ALIGN


def multi_smem_bytes(bb: int, n: int) -> int:
    """Dynamic shared memory of one kernel-5 block holding ``bb`` lanes."""
    phases = -(-(12 * bb * n) // 16) * 16
    return phases + bb * padded_k(n)


def _max_multi_n() -> int:
    budget = SMEM_PER_BLOCK - MULTI_STATIC_SMEM
    n = budget // 13
    while multi_smem_bytes(1, n + 1) <= budget:
        n += 1
    while multi_smem_bytes(1, n) > budget:
        n -= 1
    return n


#: Largest N whose one-lane state fits a block's shared memory.
MULTI_KERNEL_MAX_N = _max_multi_n()


def multi_lanes_per_block(n: int, batch: int) -> int:
    """Lanes per block of kernel 5 for an (N, batch) launch.

    The most lanes (up to 8) whose state fits shared memory, halved while
    the grid would fill fewer than half the SMs: more lanes per block share
    each W row load, more blocks fill the card.
    """
    if n > MULTI_KERNEL_MAX_N:
        raise ValueError(
            f"multi-cycle kernel: N={n} exceeds MULTI_KERNEL_MAX_N={MULTI_KERNEL_MAX_N}"
        )
    budget = SMEM_PER_BLOCK - MULTI_STATIC_SMEM
    bb = MULTI_MAX_LANES
    while bb > 1 and (
        multi_smem_bytes(bb, n) > budget or 2 * -(-batch // bb) < NUM_SMS
    ):
        bb //= 2
    return bb
