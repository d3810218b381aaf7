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

**Kernel 8** (``csrc/quantized_matvec.cu``) multiplies float32 activations
by int8 weights on the CUDA cores (no tensor cores: float32 FMA keeps the
error bound of float32 summation).  The TPU package's ``k_minimum=128`` and
its (8, 128) blocks follow the TPU's vector tiling and do not carry over.
:func:`qmv_plan` picks one of two regimes, the K chunk each block owns and
whether the 16-byte vector path may run:

* **GEMV** (B ≤ :data:`QMV_GEMV_MAX_B`), bound by the bytes of W.  A block
  of 256 threads owns :data:`QMV_GEMV_ROWS` = 128 output rows and one K
  chunk; eight threads share a row group, each loading 16 bytes of W per
  step (:data:`QMV_GEMV_KSTEP` = 128 bytes of a row per step).  The batch is
  rounded up to a power of two (``lanes``), the kernel's template size.  x's
  chunk sits in dynamic shared memory with each 16 floats padded to 20::

      qmv_gemv_smem_bytes(lanes, k_chunk) = 4 · lanes · (k_chunk / 16) · 20

  kept within the 48 KB that needs no opt-in.  The chunk is a multiple of
  128, cut so that the grid is one wave at two blocks per SM (at most
  2 · :data:`NUM_SMS` blocks: a second, partial wave costs more than it
  spreads), or as narrow as one step where the shape is too small for that.
* **GEMM** (B > 16), bound by operations.  A block owns 128 lanes × 128 rows
  (8 × 8 per thread) and walks its chunk in double-buffered 32-wide slabs:
  :data:`QMV_GEMM_SMEM` bytes of static shared memory.  K is split only
  when the tile grid fills fewer than :data:`NUM_SMS` SMs, into chunks of at
  least :data:`QMV_GEMM_MIN_K_CHUNK`.

With more than one chunk the blocks of an output tile meet in a workspace of
``splits · B · M`` float32 partial sums and one int32 counter per tile; the
last to arrive sums the partials in chunk order, so results are bit-identical
from call to call.  The vector path needs K % 16 == 0 and 16-byte aligned x
and W; otherwise the kernels load W byte by byte and x by 4-byte copies.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

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


#: Kernel 8: the largest batch of the GEMV regime, and its template sizes.
QMV_GEMV_MAX_B = 16
QMV_GEMV_LANES = (1, 2, 4, 8, 16)
#: GEMV: output rows per block, and bytes of a W row per step of a row group.
QMV_GEMV_ROWS = 128
QMV_GEMV_KSTEP = 128
#: Shared memory a block may use without an opt-in (kernel 8 stays within it).
QMV_STATIC_SMEM = 48 * 1024
#: GEMM: lanes and rows per block tile, slab width, smallest split-K chunk.
QMV_GEMM_TILE = 128
QMV_GEMM_BK = 32
QMV_GEMM_MIN_K_CHUNK = 64
#: Static shared memory of the split-K arrival flag, as compiled (16 bytes).
QMV_FLAG_SMEM = 16
#: GEMM static shared memory: two x slabs (128 × 36 float32) and two W slabs
#: (128 × 36 bytes), plus the split-K arrival flag (46,096 bytes).
QMV_GEMM_SMEM = (2 * QMV_GEMM_TILE * (QMV_GEMM_BK + 4) * 4 + 2 * QMV_GEMM_TILE * (QMV_GEMM_BK + 4)
                 + QMV_FLAG_SMEM)
#: Grid limit of the split axis (gridDim.y).
_MAX_GRID_Y = 65_535


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def qmv_gemv_smem_bytes(lanes: int, k_chunk: int) -> int:
    """Dynamic shared memory of one GEMV block: x's chunk, 16 floats padded to 20."""
    return 4 * lanes * (k_chunk // 16) * 20


@dataclasses.dataclass(frozen=True)
class QmvPlan:
    """One launch of kernel 8: the regime, the GEMV template size (``lanes``;
    0 in the GEMM regime), the K chunk each block owns and their number
    (``splits``), and whether the 16-byte vector path runs."""

    batch: int
    m: int
    k: int
    regime: str  # "gemv" or "gemm"
    lanes: int
    k_chunk: int
    splits: int
    vector: bool

    @property
    def grid(self) -> Tuple[int, int, int]:
        """(row tiles, K chunks, lane tiles), as the kernel launches it."""
        if self.regime == "gemv":
            return (_cdiv(self.m, QMV_GEMV_ROWS), self.splits, 1)
        return (_cdiv(self.m, QMV_GEMM_TILE), self.splits, _cdiv(self.batch, QMV_GEMM_TILE))

    @property
    def blocks(self) -> int:
        gx, gy, gz = self.grid
        return gx * gy * gz

    @property
    def smem_bytes(self) -> int:
        if self.regime == "gemv":
            return qmv_gemv_smem_bytes(self.lanes, self.k_chunk) + QMV_FLAG_SMEM
        return QMV_GEMM_SMEM

    @property
    def counters(self) -> int:
        """int32 arrival counters (one per output tile) when K is split."""
        gx, _, gz = self.grid
        return gx * gz if self.splits > 1 else 0

    @property
    def workspace(self) -> int:
        """float32 partial sums (splits, B, M) when K is split."""
        return self.splits * self.batch * self.m if self.splits > 1 else 0


def qmv_plan(batch: int, m: int, k: int, *, aligned: bool = True) -> QmvPlan:
    """Kernel 8's launch for x (batch, k) · W_q (m, k)ᵀ; ``aligned`` says
    that both base pointers are 16-byte aligned."""
    vector = aligned and k % 16 == 0
    if batch <= QMV_GEMV_MAX_B:
        lanes = next(n for n in QMV_GEMV_LANES if n >= batch)
        step = QMV_GEMV_KSTEP
        widest = (QMV_STATIC_SMEM - QMV_FLAG_SMEM) // (4 * lanes * 20) * 16 // step * step
        want = max(1, 2 * NUM_SMS // _cdiv(m, QMV_GEMV_ROWS))
        k_chunk = min(widest, max(step, _cdiv(_cdiv(k, want), step) * step))
        regime = "gemv"
    else:
        lanes, step = 0, QMV_GEMM_BK
        tiles = _cdiv(m, QMV_GEMM_TILE) * _cdiv(batch, QMV_GEMM_TILE)
        if tiles >= NUM_SMS:
            k_chunk = max(step, _cdiv(k, step) * step)
        else:
            per = _cdiv(_cdiv(k, _cdiv(NUM_SMS, tiles)), step) * step
            k_chunk = max(QMV_GEMM_MIN_K_CHUNK, per)
        regime = "gemm"
    k_chunk = max(k_chunk, _cdiv(_cdiv(k, _MAX_GRID_Y), step) * step)
    splits = max(1, _cdiv(k, k_chunk))
    return QmvPlan(batch, m, k, regime, lanes, k_chunk, splits, vector)
