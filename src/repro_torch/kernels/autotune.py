"""Tile choice and the multi-cycle eligibility ceiling, from Hopper's limits.

The TPU package budgets a 16 MiB VMEM per core (``VMEM_BUDGET_BYTES``,
``MULTI_KERNEL_MAX_N = 2048`` in ``repro.kernels.autotune``); none of that
carries over.  On an H100 the limits that matter are:

* shared memory a block can use: 232,448 bytes (227 KB), above 48 KB only as
  dynamic shared memory after an opt-in;
* 132 streaming multiprocessors, which the grid should fill;
* the int8 tensor cores take a k32 step per ``mma.sync`` (kernels 1-7;
  kernel 5's stream regime loads the contraction in 16-byte vectors).

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
    """One launch of the coupling GEMM: ``inst`` × σ (b, n) · W (m, n)ᵀ, its
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
    def grid(self) -> Tuple[int, int, int]:
        """(row tiles, lane tiles, instances), as the kernel launches it."""
        return (_cdiv(self.m, self.tile.bn), _cdiv(self.b, self.tile.bm), self.inst)

    @property
    def blocks(self) -> int:
        gx, gy, gz = self.grid
        return gx * gy * gz

    @property
    def stages(self) -> int:
        return self.tile.stages

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


def iter_buckets(kinds: Tuple[str, ...] = KINDS) -> Iterator[Tuple[str, int, int]]:
    """Every ``(kind, n, batch)`` bucket of the grid; ``multi`` buckets past
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


def cache_info() -> Dict[str, int]:
    """The launch planners' cache summary for ``stats()`` surfaces, under the
    keys of ``repro.kernels.autotune.cache_info``: the plans held and the
    hits and misses, summed over :func:`multi_plan` and :func:`coupling_plan`."""
    infos = (multi_plan.cache_info(), coupling_plan.cache_info())
    return {
        "entries": sum(i.currsize for i in infos),
        "hits": sum(i.hits for i in infos),
        "misses": sum(i.misses for i in infos),
    }
