"""Tile choice and the multi-cycle eligibility ceiling, from Hopper's limits.

The TPU package budgets a 16 MiB VMEM per core (``VMEM_BUDGET_BYTES``,
``MULTI_KERNEL_MAX_N = 2048`` in ``repro.kernels.autotune``); none of that
carries over.  On an H100 the limits that matter are:

* shared memory a block can use: 232,448 bytes (227 KB), above 48 KB only as
  dynamic shared memory after an opt-in;
* 132 streaming multiprocessors, which the grid should fill;
* the int8 tensor cores take a k32 step per ``mma.sync`` (kernels 1-7 at
  the main path's shapes; kernel 5's stream regime loads the contraction in
  16-byte vectors), and reach their full rate only through ``wgmma`` on
  tiles in shared memory (kernels 1 and 2 at large shapes).

**Kernels 1, 2, 3, 4, 6 and 7** (``csrc/coupling_gemm.cu``) run one body on
``mma.sync.m16n8k32`` s8 → s32, and :func:`coupling_plan` picks its launch
per shape: a tile of :data:`GEMM_TILES`, the grid, and the K walk's unit.

* **Tile.** Both of eight warps.  ``wide``: 64 lanes × 32 output rows per
  block, four warp pairs each owning a 32 × 16 quarter and splitting its
  k32 steps.  ``split``: 16 × 16 per block, the k32 steps dealt round robin
  to the eight warps.  The warps' partial sums meet in shared memory (one
  launch, no atomics).  The plan takes the first tile whose grid fills
  :data:`NUM_SMS` blocks, else ``split``, the tile with the most blocks:
  256 blocks at (1024, 506, 506), 128 at the Max-Cut instance shape
  16 × (64, 506) · (32, 506), where ``wide`` has 16.
* **Ring.** Each block keeps ``stages`` K-steps of :data:`GEMM_BK` bytes in
  shared memory, filled by 16-byte ``cp.async``, and two realigned fragment
  tiles: a staged row holds the nine 16-byte aligned chunks that cover 128
  bytes at any offset, and one pass per step rebuilds it aligned.  Shared
  memory per block, :func:`gemm_smem_bytes`, dynamic (opted in above
  48 KB): ``(stages + 2) · (bm + bn) · 144`` bytes; two ``wide`` blocks
  share an SM.
* **Load path.** One for every N and alignment: the aligned 16-byte
  chunks around each row, realigned with ``__funnelshift_r`` (rows of
  N = 506 start 2 bytes off a word).  Only a chunk at either end of a
  tensor that is not wholly inside it is copied by words, its partial words
  by bytes.
* **K walk.** The hybrid kernels 6 and 7 take the MAC width P and walk the
  contraction in groups of whole passes, by the TPU package's pass-group
  rule (``repro.kernels.coupling_kernel.hybrid_pass_groups``) with a
  64-byte tile in place of the VMEM block: ``max(1, 64 // P)`` passes per
  group (:func:`gemm_group_width`).  Groups that are whole k32 steps (G a
  multiple of 32, as at P = 1, 32, 64) pack contiguously, 128 columns a
  K-step; any other group is walked alone in 128-byte steps, its last one
  zero-padded to whole k32 steps (:func:`coupling_k_steps`).  The rule
  lives here only: the kernel takes the walk's unit (``span``) from the
  plan, and the tile's index with its shape, which it checks against the
  tiles it instantiates (``Tile<>``).  Kernels 1-4 walk 64-byte groups, so
  128-byte steps.
* **Launches.** The grid's y (lane tiles) and z (instances) hold at most
  65,535 (:data:`MAX_GRID_YZ`): past 4,194,240 lanes on the wide tile, or
  65,535 instances, :attr:`CouplingPlan.launches` cuts the plan into runs
  of at most that many tiles, which the wrapper issues in order on one
  stream with σ, θ and the output offset to each run's first lane and
  instance (kernel 8's GEMM likewise past 65,535 × 128 lanes on z,
  :attr:`QmvPlan.launches`).  Below the edge a plan is one launch, its grid
  as before.

**Kernels 1 and 2 at large shapes** (``csrc/coupling_wgmma.cu``).
:func:`coupling_route` sends a launch of kernel 1 (one W, no MAC width) or
kernel 2 to :func:`wgmma_plan` when the work is large: B · M · K at least
:data:`WGMMA_MIN_WORK` (2³⁴) and the wide tile's grid at least
:data:`NUM_SMS` blocks; every other launch, the main path's included, keeps
:func:`coupling_plan`.  On an H100 the regime already wins well below the
threshold (``coupling_gemm_breakdown.py``: 0.026 against the wide tile's
0.366 ms at (1024, 4096, 4096), 0.018 against 0.097 at (1024, 2048,
2048)); 2³⁴ is the least power of two above the work of the grid-edge
launches that keep the wide tile's runs past 65,535 lane tiles
(4,194,341 lanes at N = 48, 9.7e9).

* **Tile.** 128 lanes × 256 output rows a block (``WGMMA_BM`` ×
  ``WGMMA_BN``): two consumer warpgroups of 64 lanes on
  ``wgmma.m64n256k32`` s8 → s32, one producer warp issuing TMA loads of
  128-byte K-steps (one 128-byte swizzle row) into a ring of
  :data:`WGMMA_STAGES` stages; :data:`WGMMA_SMEM` bytes of dynamic shared
  memory, one block an SM.
* **Walk.** A persistent grid of at most :data:`NUM_SMS` blocks over work
  units (one output tile and one K slice each), block x taking units x,
  x + grid, ...  Consecutive units share an operand panel: the lane tiles
  of one W panel where W is at least as large as σ (``lanes_fastest``),
  else the row tiles of one σ panel.
* **Split-K** (kernel 1 only): where the output has at most
  ``NUM_SMS // 2`` tiles, K is cut into ``NUM_SMS // tiles`` slices of whole
  K-steps, each unit's partial sums added into the zeroed output with
  int32 atomics.  Kernel 2 never splits (its sign needs the whole sum).
* **Rows.** TMA reads 16-byte aligned bases and row pitches; where N is not
  a multiple of 16 (or an operand's base is off 16 bytes) the wrapper
  copies the operand into rows of :func:`tma_pitch` bytes (N = 506: 512),
  and TMA fills every column past N with zeros.  One launch whatever B:
  the grid is the persistent one.

**Kernel 5** (``csrc/phase_step_multi.cu``) runs a whole settle-chunk in
one launch, in one of two regimes that :func:`multi_plan` picks by shape:

* **cluster** (N ≤ :data:`MULTI_CLUSTER_MAX_N`, 1,280: every configured N).
  A thread-block cluster of C CTAs (2, 4 or 8) owns L lanes (8, 16 or 32);
  CTA rank r holds the output rows [r·R, (r + 1)·R) of W in shared memory
  for the whole launch, R = ⌈N / C⌉ rounded up to 16 (one warp per 16
  rows, at most 16 warps), and the CTAs exchange σ through distributed
  shared memory once per cycle.  Dynamic shared memory per CTA, with
  rows of ``pitch = ⌈KP / 32⌉ · 32 + 16`` bytes::

      multi_cluster_smem_bytes(n, C, L) = 512 + (R + 2 L) · pitch

  (the W slice, σ double-buffered, 512 bytes of lane masks).  The plan
  takes the (C, L) with the least per-cycle work per wave, ``waves · R ·
  L``, where a wave is ⌊:data:`NUM_SMS` / C⌋ clusters; ties go to fewer
  CTAs, then to the smaller cluster: C = 2, L = 16, 128 CTAs at
  (1024, 506); C = 8, L = 8, 64 CTAs for the serving slab (64, 506).
* **stream** (:data:`MULTI_CLUSTER_MAX_N` < N ≤ :data:`MULTI_KERNEL_MAX_N`).
  Each block owns ``lanes`` (1, 2, 4 or 8) whole lanes: three int32 phase
  buffers of N entries and one spin row of KP bytes each, in shared
  memory, and W streams from L2 every cycle::

      multi_stream_smem_bytes(lanes, N) = align16(12 · lanes · N) + lanes · KP

  plus under 1 KB of static flags.  The most lanes that fit, halved while
  the grid would fill fewer than half the SMs.  With one lane per block
  this fits the 227 KB block limit up to N = :data:`MULTI_KERNEL_MAX_N`
  (17,801); past it the dynamics take the per-cycle route through
  kernel 3.

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
import functools
from typing import Dict, Iterator, Tuple

#: Dynamic shared memory one block may use on an H100 (opt-in maximum).
SMEM_PER_BLOCK = 232_448
#: Static shared memory of kernel 5's stream regime (bookkeeping flags), rounded up.
MULTI_STATIC_SMEM = 1024
#: Streaming multiprocessors of an H100 SXM.
NUM_SMS = 132
#: Lanes per block of kernel 5's stream regime: instantiated for 1, 2, 4 and 8.
MULTI_MAX_LANES = 8
#: Threads of a stream-regime block (``ST_THREADS``).
MULTI_STREAM_THREADS = 256
#: Contraction alignment of W's rows as the wrapper pads them (16-byte loads).
K_ALIGN = 16
#: Kernel 5's cluster regime: the cluster sizes and lanes per cluster it
#: instantiates, its most rows per CTA (16 warps of 16 rows), and the bytes
#: of lane masks at the head of its shared memory.
MULTI_CLUSTERS = (2, 4, 8)
MULTI_CLUSTER_LANES = (8, 16, 32)
MULTI_CLUSTER_MAX_ROWS = 256
MULTI_CLUSTER_HEAD = 512


def padded_k(n: int) -> int:
    """Row length of W as kernel 5 reads it: N rounded up to 16 bytes."""
    return -(-n // K_ALIGN) * K_ALIGN


def multi_stream_smem_bytes(bb: int, n: int) -> int:
    """Dynamic shared memory of one stream-regime block holding ``bb`` lanes."""
    phases = -(-(12 * bb * n) // 16) * 16
    return phases + bb * padded_k(n)


def multi_cluster_rows(n: int, cluster: int) -> int:
    """Rows of W per CTA of a ``cluster``-CTA cluster: ⌈N / C⌉ rounded up to 16."""
    return -(-(-(-n // cluster)) // 16) * 16


def multi_cluster_pitch(n: int) -> int:
    """Bytes per shared-memory row (W slice and σ): whole k32 steps plus 16."""
    return -(-padded_k(n) // 32) * 32 + 16


def multi_cluster_smem_bytes(n: int, cluster: int, lanes: int) -> int:
    """Dynamic shared memory of one cluster-regime CTA: lane masks, the W
    slice and σ double-buffered."""
    rows = multi_cluster_rows(n, cluster)
    return MULTI_CLUSTER_HEAD + (rows + 2 * lanes) * multi_cluster_pitch(n)


def _multi_cluster_fits(n: int, cluster: int, lanes: int) -> bool:
    return (multi_cluster_rows(n, cluster) <= MULTI_CLUSTER_MAX_ROWS
            and multi_cluster_smem_bytes(n, cluster, lanes) <= SMEM_PER_BLOCK)


def _max_multi_n() -> int:
    budget = SMEM_PER_BLOCK - MULTI_STATIC_SMEM
    n = budget // 13
    while multi_stream_smem_bytes(1, n + 1) <= budget:
        n += 1
    while multi_stream_smem_bytes(1, n) > budget:
        n -= 1
    return n


def _max_cluster_n() -> int:
    n = 1
    while _multi_cluster_fits(n + 1, max(MULTI_CLUSTERS), min(MULTI_CLUSTER_LANES)):
        n += 1
    return n


#: Largest N whose one-lane state fits a block's shared memory.
MULTI_KERNEL_MAX_N = _max_multi_n()
#: Largest N whose W slice, σ buffers and lane masks fit a CTA's shared
#: memory in a cluster of 8 (with 8 lanes): the cluster regime's ceiling.
MULTI_CLUSTER_MAX_N = _max_cluster_n()


@dataclasses.dataclass(frozen=True)
class MultiPlan:
    """One launch of kernel 5 for ``batch`` lanes of N = ``n``: the regime
    (``"cluster"`` or ``"stream"``), CTAs per cluster (1 in the stream
    regime), lanes per cluster (stream: per block), rows of W per CTA (stream:
    all of a padded row), the grid in CTAs and the dynamic shared memory of
    one CTA."""

    batch: int
    n: int
    regime: str
    cluster: int
    lanes: int
    rows: int
    grid: int
    smem_bytes: int

    @property
    def threads(self) -> int:
        """Threads a CTA: a warp per 16 rows in the cluster regime."""
        return 2 * self.rows if self.regime == "cluster" else MULTI_STREAM_THREADS

    @property
    def args(self) -> Tuple[int, int, int, int, int]:
        """The kernel's last arguments: regime (0 cluster, 1 stream), cluster,
        lanes, rows, shared memory."""
        return (0 if self.regime == "cluster" else 1, self.cluster, self.lanes, self.rows,
                self.smem_bytes)


@functools.lru_cache(maxsize=1024)
def multi_plan(b: int, n: int) -> MultiPlan:
    """Kernel 5's launch for ``b`` lanes of N = ``n``, by shape alone.

    Cached: the batched solve and the serving loop launch the same shapes
    every chunk, and the wrapper calls it with positional arguments.
    """
    if n < 1 or b < 0:
        raise ValueError(f"multi-cycle kernel: bad shape (B={b}, N={n})")
    if n > MULTI_KERNEL_MAX_N:
        raise ValueError(
            f"multi-cycle kernel: N={n} exceeds MULTI_KERNEL_MAX_N={MULTI_KERNEL_MAX_N}"
        )
    if n > MULTI_CLUSTER_MAX_N:
        budget = SMEM_PER_BLOCK - MULTI_STATIC_SMEM
        bb = MULTI_MAX_LANES
        while bb > 1 and (
            multi_stream_smem_bytes(bb, n) > budget or 2 * _cdiv(b, bb) < NUM_SMS
        ):
            bb //= 2
        return MultiPlan(b, n, "stream", 1, bb, padded_k(n), _cdiv(b, bb),
                         multi_stream_smem_bytes(bb, n))
    best = None
    for c in MULTI_CLUSTERS:
        rows = multi_cluster_rows(n, c)
        for lanes in MULTI_CLUSTER_LANES:
            if not _multi_cluster_fits(n, c, lanes):
                continue
            groups = _cdiv(b, lanes)
            waves = max(1, _cdiv(groups, NUM_SMS // c))
            key = (waves * rows * lanes, groups * c, c)
            if best is None or key < best[0]:
                best = (key, MultiPlan(b, n, "cluster", c, lanes, rows, groups * c,
                                       multi_cluster_smem_bytes(n, c, lanes)))
    if best is None:
        raise ValueError(f"multi-cycle kernel: no cluster of {MULTI_CLUSTERS} holds N={n}")
    return best[1]


#: Kernel 8: the largest batch of the GEMV regime, and its template sizes.
QMV_GEMV_MAX_B = 16
QMV_GEMV_LANES = (1, 2, 4, 8, 16)
#: Threads a block of either regime (``THREADS``).
QMV_THREADS = 256
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
#: CUDA's limit on a grid's y and z: kernel 8's K chunks (y) and GEMM lane
#: tiles (z), the coupling GEMM's lane tiles (y) and instances (z).  A plan
#: past it is cut into several launches of at most this many tiles each
#: (``QmvPlan.launches``, ``CouplingPlan.launches``), issued in order on one
#: stream with the operands' pointers offset to each launch's first lane
#: (and instance).
MAX_GRID_YZ = 65_535


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _runs(total: int, tile: int) -> Tuple[Tuple[int, int], ...]:
    """(first, count) of consecutive runs of ``total`` items, each at most
    :data:`MAX_GRID_YZ` tiles of ``tile`` items: one run unless more are
    needed (an empty total is one empty run)."""
    step = MAX_GRID_YZ * tile
    if total <= step:
        return ((0, total),)
    return tuple((lo, min(step, total - lo)) for lo in range(0, total, step))


def qmv_gemv_smem_bytes(lanes: int, k_chunk: int) -> int:
    """Dynamic shared memory of one GEMV block: x's chunk, 16 floats padded to 20."""
    return 4 * lanes * (k_chunk // 16) * 20


@dataclasses.dataclass(frozen=True)
class QmvPlan:
    """The launches of kernel 8 (:attr:`launches`): the regime, the GEMV template size (``lanes``;
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
    def launches(self) -> Tuple[Tuple[int, int], ...]:
        """(first lane, lanes) of each launch: one, unless the GEMM's lane
        tiles pass :data:`MAX_GRID_YZ` on z; then runs of that many tiles."""
        if self.regime == "gemv":
            return ((0, self.batch),)
        return _runs(self.batch, QMV_GEMM_TILE)

    @property
    def grid(self) -> Tuple[int, int, int]:
        """(row tiles, K chunks, lane tiles) of the first (largest) launch,
        as the kernel launches it."""
        if self.regime == "gemv":
            return (_cdiv(self.m, QMV_GEMV_ROWS), self.splits, 1)
        lanes = self.launches[0][1]
        return (_cdiv(self.m, QMV_GEMM_TILE), self.splits, _cdiv(lanes, QMV_GEMM_TILE))

    @property
    def blocks(self) -> int:
        """Blocks of every launch together."""
        gx, gy, _ = self.grid
        tile = QMV_GEMV_ROWS if self.regime == "gemv" else QMV_GEMM_TILE
        return sum(gx * gy * (1 if self.regime == "gemv" else _cdiv(nb, tile))
                   for _, nb in self.launches)

    @property
    def threads(self) -> int:
        return QMV_THREADS

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
        """float32 partial sums (splits, lanes, M) of the largest launch
        when K is split; the launches run in order and reuse it."""
        return self.splits * self.launches[0][1] * self.m if self.splits > 1 else 0


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
    k_chunk = max(k_chunk, _cdiv(_cdiv(k, MAX_GRID_YZ), step) * step)
    splits = max(1, _cdiv(k, k_chunk))
    return QmvPlan(batch, m, k, regime, lanes, k_chunk, splits, vector)


#: Kernels 1-4, 6, 7: contraction bytes per K-step, the tile of the hybrid
#: pass-group rule, and bytes per staged row (the nine 16-byte chunks that
#: cover a K-step at any offset).
GEMM_BK = 128
GEMM_GROUP_TILE = 64
GEMM_ROW_BYTES = 144
#: Shared memory of one SM: the wide tile's two blocks per SM share it.
SMEM_PER_SM = 233_472
#: The mma depth (bytes of one k32 step).
GEMM_MMA_K = 32


@dataclasses.dataclass(frozen=True)
class GemmTile:
    """One block tile of the coupling GEMM, as ``csrc/coupling_gemm.cu``
    instantiates it (``Tile<FM, FN, WM, WN, KS, STAGES>``): ``fm`` × ``fn``
    mma tiles of 16 × 8 per warp, ``wm`` × ``wn`` warps over the output
    tile, ``ks`` warps over the k32 steps, ``stages`` K-steps in the ring."""

    name: str
    index: int  # the kernel's `tile` argument
    fm: int
    fn: int
    wm: int
    wn: int
    ks: int
    stages: int

    @property
    def bm(self) -> int:
        """Lanes (rows of σ) per block."""
        return 16 * self.fm * self.wm

    @property
    def bn(self) -> int:
        """Output rows (rows of W) per block."""
        return 8 * self.fn * self.wn

    @property
    def threads(self) -> int:
        return 32 * self.wm * self.wn * self.ks


GEMM_TILES = (
    GemmTile("wide", 0, fm=2, fn=2, wm=2, wn=2, ks=2, stages=3),
    GemmTile("split", 1, fm=1, fn=2, wm=1, wn=1, ks=8, stages=4),
)


def gemm_smem_bytes(tile: GemmTile) -> int:
    """Dynamic shared memory of one block: its ring of staged K-steps and
    two realigned fragment tiles."""
    return (tile.stages + 2) * (tile.bm + tile.bn) * GEMM_ROW_BYTES


def gemm_group_width(parallel: int, n: int) -> int:
    """Columns per group of MAC width P: as many whole passes as fit the
    64-byte group tile, or one pass if P is wider; no group is wider than N."""
    if parallel <= 0:
        raise ValueError(f"parallel must be positive, got {parallel}")
    t = GEMM_GROUP_TILE
    return min(parallel if parallel >= t else (t // parallel) * parallel, n)


def gemm_walk_span(parallel: int, n: int) -> int:
    """Columns of the walk's unit: a K-step where the groups are whole k32
    steps and pack contiguously, else one group."""
    g = gemm_group_width(parallel, n)
    return GEMM_BK if g % GEMM_MMA_K == 0 else g


def coupling_k_steps(n: int, parallel: int = GEMM_GROUP_TILE) -> Tuple[Tuple[int, int], ...]:
    """The kernel's walk over the contraction: (first column, live width) of
    every K-step, unit by unit; a step past a ragged last group's end has
    width ≤ 0 and stages nothing.  Each step is zero-padded to
    ``ceil(width / 32)`` k32 steps."""
    if n <= 0:
        return ()
    span = gemm_walk_span(parallel, n)
    per_unit = _cdiv(span, GEMM_BK)
    steps = []
    for u in range(_cdiv(n, span)):
        for sub in range(per_unit):
            k0 = u * span + sub * GEMM_BK
            steps.append((k0, min(GEMM_BK, span - sub * GEMM_BK, n - k0)))
    return tuple(steps)


@dataclasses.dataclass(frozen=True)
class CouplingPlan:
    """The launches of the coupling GEMM (:attr:`launches`): ``inst`` × σ (b, n) · W (m, n)ᵀ, its
    tile, the MAC width it walks (``parallel``; 64, one group tile, for
    kernels 1-4) and the walk's unit, ``span`` columns."""

    inst: int
    b: int
    m: int
    n: int
    parallel: int
    tile: GemmTile
    span: int

    @property
    def launches(self) -> Tuple[Tuple[int, int, int, int], ...]:
        """(first instance, instances, first lane, lanes) of each launch, in
        the order the wrapper issues them: one launch unless the lane tiles
        (grid y) or the instances (grid z) pass :data:`MAX_GRID_YZ`; then
        runs of at most that many tiles, so that every lane of every
        instance is covered once.  A launch over part of the lanes takes one
        instance (the pointer offsets hold one instance's stride)."""
        lanes = _runs(self.b, self.tile.bm)
        if len(lanes) > 1:  # a run of lanes is one instance's: its rows are contiguous
            return tuple((i, 1, b0, nb) for i in range(self.inst) for b0, nb in lanes)
        return tuple((i0, ni, 0, self.b) for i0, ni in _runs(self.inst, 1))

    @property
    def grid(self) -> Tuple[int, int, int]:
        """(row tiles, lane tiles, instances) of the first (largest) launch,
        as the kernel launches it."""
        _, ni, _, nb = self.launches[0]
        return (_cdiv(self.m, self.tile.bn), _cdiv(nb, self.tile.bm), ni)

    @property
    def blocks(self) -> int:
        """Blocks of every launch together."""
        gx = _cdiv(self.m, self.tile.bn)
        return sum(gx * _cdiv(nb, self.tile.bm) * ni for _, ni, _, nb in self.launches)

    @property
    def stages(self) -> int:
        return self.tile.stages

    @property
    def regime(self) -> str:
        """The tile's name, the regime ``ops.REGIME_LAUNCHES`` counts it under."""
        return self.tile.name

    @property
    def threads(self) -> int:
        return self.tile.threads

    @property
    def group_width(self) -> int:
        return gemm_group_width(self.parallel, self.n)

    @property
    def smem_bytes(self) -> int:
        return gemm_smem_bytes(self.tile)

    @property
    def args(self) -> Tuple[int, int, int, int]:
        """The kernel's last arguments: tile index, its lanes and rows, span."""
        return (self.tile.index, self.tile.bm, self.tile.bn, self.span)


@functools.lru_cache(maxsize=1024)
def coupling_plan(inst: int, b: int, m: int, n: int, parallel: int | None = None) -> CouplingPlan:
    """The coupling GEMM's launch for ``inst`` × σ (b, n) · W (m, n)ᵀ;
    ``parallel`` is the hybrid kernels' MAC width (None: kernels 1-4, one
    64-byte group).  Plans are cached (the rtl and Max-Cut loops launch the
    same shapes thousands of times per solve); the wrappers call it with
    positional arguments, the cheapest key."""
    p = GEMM_GROUP_TILE if parallel is None else parallel
    tile = GEMM_TILES[-1]
    for t in GEMM_TILES:
        if inst * _cdiv(b, t.bm) * _cdiv(m, t.bn) >= NUM_SMS:
            tile = t
            break
    return CouplingPlan(inst, b, m, n, p, tile, gemm_walk_span(p, n))


#: Kernels 1 and 2's Hopper regime (``csrc/coupling_wgmma.cu``): lanes and
#: output rows a tile, K bytes a stage, stages in the ring, threads (two
#: consumer warpgroups and the producer's), the epilogue's slab of one
#: consumer warp (16 rows × 32 int32), dynamic shared memory (the ring, the
#: eight consumer warps' slabs, 1 KB to align the ring to the swizzle's
#: period, the full and empty barriers: 214,080 bytes).
WGMMA_BM, WGMMA_BN, WGMMA_BK, WGMMA_STAGES = 128, 256, 128, 4
WGMMA_THREADS = 384
WGMMA_SLAB = 16 * 32 * 4
WGMMA_SMEM = (WGMMA_STAGES * (WGMMA_BM + WGMMA_BN) * WGMMA_BK + 8 * WGMMA_SLAB + 1024
              + 2 * WGMMA_STAGES * 8)
#: The entries that may take it (``ops.GEMM_MODES``' keys), and the least
#: work, B · M · K, routed to it.
WGMMA_MODES = ("coupling_sum", "onn_step")
WGMMA_MIN_WORK = 2**34
#: TMA's alignment of an operand's base and row pitch, in bytes.
TMA_ALIGN = 16


def tma_pitch(n: int) -> int:
    """Bytes of a row as the wgmma regime reads it: N rounded up to 16."""
    return _cdiv(n, TMA_ALIGN) * TMA_ALIGN


@dataclasses.dataclass(frozen=True)
class WgmmaPlan:
    """The launch of kernel 1 (``mode`` ``"coupling_sum"``) or kernel 2
    (``"onn_step"``) in the wgmma regime: σ (b, n) · W (m, n)ᵀ, K cut into
    ``splits`` slices of ``k_chunk`` K-steps, a persistent grid of
    ``grid_blocks`` blocks walking the units with lane tiles fastest
    (``lanes_fastest``) or row tiles fastest."""

    mode: str
    b: int
    m: int
    n: int
    k_chunk: int
    splits: int
    grid_blocks: int
    lanes_fastest: bool

    inst = 1
    regime = "wgmma"

    @property
    def lane_tiles(self) -> int:
        return _cdiv(self.b, WGMMA_BM)

    @property
    def row_tiles(self) -> int:
        return _cdiv(self.m, WGMMA_BN)

    @property
    def tiles(self) -> int:
        return self.lane_tiles * self.row_tiles

    @property
    def k_steps(self) -> int:
        return _cdiv(self.n, WGMMA_BK)

    @property
    def units(self) -> int:
        """Work units: one output tile and one K slice each."""
        return self.tiles * self.splits

    @property
    def k_pitch(self) -> int:
        """Row bytes of the operands as the kernel reads them."""
        return tma_pitch(self.n)

    @property
    def padded(self) -> bool:
        """Whether the wrapper copies the operands into rows of :attr:`k_pitch`."""
        return self.k_pitch != self.n

    def unit(self, u: int) -> Tuple[int, int, int, int]:
        """Unit ``u``'s (lane tile, row tile, first K-step, K-steps), as the
        kernel's ``Walk::unit`` decodes it."""
        s, t = divmod(u, self.tiles)
        if self.lanes_fastest:
            rt, lt = divmod(t, self.lane_tiles)
        else:
            lt, rt = divmod(t, self.row_tiles)
        k0 = s * self.k_chunk
        return lt, rt, k0, min(self.k_chunk, self.k_steps - k0)

    @property
    def launches(self) -> Tuple[Tuple[int, int, int, int], ...]:
        """(first instance, instances, first lane, lanes): one launch."""
        return ((0, 1, 0, self.b),)

    @property
    def grid(self) -> Tuple[int, int, int]:
        return (self.grid_blocks, 1, 1)

    @property
    def blocks(self) -> int:
        return self.grid_blocks

    @property
    def stages(self) -> int:
        return WGMMA_STAGES

    @property
    def threads(self) -> int:
        return WGMMA_THREADS

    @property
    def smem_bytes(self) -> int:
        return WGMMA_SMEM

    @property
    def args(self) -> Tuple[int, int, int, int, int, int, int]:
        """The kernel's last arguments: tile lanes and rows, stages, K-steps
        a slice, slices, grid, walk order."""
        return (WGMMA_BM, WGMMA_BN, WGMMA_STAGES, self.k_chunk, self.splits, self.grid_blocks,
                int(self.lanes_fastest))


@functools.lru_cache(maxsize=256)
def wgmma_plan(mode: str, b: int, m: int, n: int) -> WgmmaPlan:
    """Kernel 1's or kernel 2's launch in the wgmma regime for σ (b, n) ·
    W (m, n)ᵀ, by shape alone (the rule in the module docstring)."""
    if mode not in WGMMA_MODES:
        raise ValueError(f"wgmma regime: mode {mode!r} not one of {WGMMA_MODES}")
    if min(b, m, n) < 1 or (mode == "onn_step" and m != n):
        raise ValueError(f"wgmma regime: bad shape {mode} (B={b}, M={m}, N={n})")
    k_steps = _cdiv(n, WGMMA_BK)
    tiles = _cdiv(b, WGMMA_BM) * _cdiv(m, WGMMA_BN)
    splits = 1
    if mode == "coupling_sum" and 2 * tiles <= NUM_SMS:
        splits = min(k_steps, NUM_SMS // tiles)
    k_chunk = _cdiv(k_steps, splits)
    splits = _cdiv(k_steps, k_chunk)
    return WgmmaPlan(mode, b, m, n, k_chunk, splits, min(tiles * splits, NUM_SMS), m >= b)


def coupling_route(mode: str, inst: int, b: int, m: int, n: int, parallel: int | None = None,
                   *, cached: bool = True):
    """The coupling GEMM's launch for the entry ``mode`` (a key of
    ``ops.GEMM_MODES``) on ``inst`` × σ (b, n) · W (m, n)ᵀ at MAC width
    ``parallel``: :func:`wgmma_plan` for kernel 1 (``"coupling_sum"``, one
    W, ``parallel`` None) and kernel 2 (``"onn_step"``) where
    B · M · N ≥ :data:`WGMMA_MIN_WORK` and the wide tile's grid has at least
    :data:`NUM_SMS` blocks; else :func:`coupling_plan`.  The rule depends on
    the shape alone, never on the grid's edge, so a launch past 65,535 lane
    tiles below the work threshold keeps the wide tile's runs.  ``cached``
    False plans through the planners' ``__wrapped__`` (``analysis/vmem.py``)."""
    wide = GEMM_TILES[0]
    if (inst == 1 and parallel is None and mode in WGMMA_MODES and b * m * n >= WGMMA_MIN_WORK
            and _cdiv(b, wide.bm) * _cdiv(m, wide.bn) >= NUM_SMS):
        return (wgmma_plan if cached else wgmma_plan.__wrapped__)(mode, b, m, n)
    return (coupling_plan if cached else coupling_plan.__wrapped__)(inst, b, m, n, parallel)


#: The bucket grid, under the names of ``repro.kernels.autotune``: the kinds
#: of launch a bucket is planned for (``step``: kernels 1-4 and the instance
#: axis; ``hybrid``: kernels 6 and 7; ``matvec``: kernel 8; ``multi``: kernel
#: 5), the reference's N and batch buckets, and the sizes the port launches
#: or plans to its limits: the cluster regime's ceiling, the ONN dry run's
#: share of ``onn_131072`` (8,192), the stream regime's ceiling, and the main
#: path's batches.  ``analysis/vmem.py`` sweeps it through
#: :func:`iter_buckets`.
KINDS = ("step", "hybrid", "matvec", "multi")
N_BUCKETS = tuple(sorted((16, 32, 48, 64, 128, 256, 506, 512, 1024, 2048, 4096,
                          MULTI_CLUSTER_MAX_N, 8192, MULTI_KERNEL_MAX_N)))
BATCH_BUCKETS = (1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1024)
#: The grid's edges, where a plan first takes a second launch: at N = 506
#: the coupling GEMM's wide tile holds 65,535 × 64 = 4,194,240 lanes a
#: launch and kernel 8's GEMM 65,535 × 128 = 8,388,480; a bucket at each
#: edge, one lane past it, and the sizes ``chip_smoke.py`` launches
#: (``launch_edges``).  The instance axis's edge is ``analysis/vmem.py``'s
#: ``STEP_INSTANCES``.
EDGE_BUCKETS = tuple(
    (kind, 506, b) for kind, edges in (("step", (4_194_240, 4_194_241, 4_194_341)),
                                       ("hybrid", (4_194_240, 4_194_241, 4_194_341)),
                                       ("matvec", (8_388_480, 8_388_481, 8_388_557)))
    for b in edges)


def iter_buckets(kinds: Tuple[str, ...] = KINDS) -> Iterator[Tuple[str, int, int]]:
    """Every ``(kind, n, batch)`` bucket of the grid, then the
    :data:`EDGE_BUCKETS` of those kinds; ``multi`` buckets past
    :data:`MULTI_KERNEL_MAX_N` are skipped (kernel 5 refuses them, and the
    dynamics take the per-cycle route)."""
    for kind in kinds:
        if kind not in KINDS:
            raise ValueError(f"unknown autotune kind {kind!r}; expected one of {KINDS}")
        for n in N_BUCKETS:
            if kind == "multi" and n > MULTI_KERNEL_MAX_N:
                continue
            for batch in BATCH_BUCKETS:
                yield kind, n, batch
    yield from (b for b in EDGE_BUCKETS if b[0] in kinds)


def cache_info() -> Dict[str, int]:
    """The launch planners' cache summary for ``stats()`` surfaces, under the
    keys of ``repro.kernels.autotune.cache_info``: the plans held and the
    hits and misses, summed over :func:`multi_plan`, :func:`coupling_plan`
    and :func:`wgmma_plan`."""
    infos = (multi_plan.cache_info(), coupling_plan.cache_info(), wgmma_plan.cache_info())
    return {
        "entries": sum(i.currsize for i in infos),
        "hits": sum(i.hits for i in infos),
        "misses": sum(i.misses for i in infos),
    }
