// Int8 coupling GEMM for Hopper (sm_90a) on the int8 tensor cores, in four
// variants that differ only in how the spin operand is staged and in the
// epilogue, each walking the contraction in groups of whole MAC passes.
//
// Replaces six TPU kernels of src/repro/kernels/coupling_kernel.py:
//   * coupling_sum_pallas / _coupling_sum_kernel                 -> onn_coupling_sum
//   * onn_step_pallas / _onn_step_kernel                         -> onn_step
//   * phase_step_pallas / _phase_step_kernel                     -> onn_phase_step
//   * phase_step_packed_pallas / _phase_step_packed_kernel       -> onn_phase_step_packed
//   * hybrid_coupling_sum_pallas / _hybrid_mac_pass_kernel       -> onn_coupling_sum
//   * hybrid_phase_step_pallas / _hybrid_phase_epilogue_kernel   -> onn_phase_step
//     (the hybrid kernels are the plain ones with the walk of their MAC width)
//
// Computes S[b, i] = sum_k sigma[b, k] * W[i, k] with exact int32 accumulation
// (mma.sync m16n8k32 s8.s8.s32: integer sums, so every output is bit-equal to
// the plain version whatever the order), then
//   SUM:    out = S                                   (W may be an (M, N) row slab)
//   PHASE:  out = 0 if S + h > 0, half if S + h < 0, theta if S + h == 0
//   PACKED: as PHASE, with sigma (+1 iff theta < half) unpacked from two 4-bit
//           counters per byte (low first) while the tile is staged, and the
//           kept theta read from the same bytes in the epilogue.
//   STEP:   out = +1 if S + h > 0, -1 if S + h < 0, sigma[b, i] if S + h == 0,
//           stored as int8 (the output type is a function of the mode).
//
// SUM also takes an instance axis: I independent problems, sigma (I, B, N),
// W (I, M, N), out (I, B, M), one grid layer (blockIdx.z) per instance (the
// TPU package gets it from jax.vmap over the pallas_call: the Max-Cut
// annealer's per-instance coupling slabs).  The other modes compile without
// the offsets: with them in every mode, PACKED ran 22 % slower (0.0339
// against 0.0277 ms on an H100 80GB HBM3 at 700 W, the __dp4a body).
//
// The hybrid kernels are the paper's serialized MAC: ceil(N / P) passes of
// a P-wide MAC.  The TPU version is one launch per pass-group, the (B, M)
// accumulator carried through device memory; here one launch does the whole
// contraction with every output in registers.  The walk's unit, `span`
// columns, comes from the launch plan (autotune.coupling_plan, which owns
// the pass-group rule): a BK-wide K-step where the groups of whole passes
// are whole k32 steps and pack contiguously, else one group, staged alone
// in BK-byte K-steps, the last one zero-padded to whole k32 steps of the
// mma; columns past N are zero spins against zero weights (the ragged last
// pass's idle MAC lanes).  Integer addition is associative, so the result
// does not depend on P; kernels 1-4 take the walk of P = 64.
//
// What bounds it on this card: at the main path's shape (B = 1024, N = 506)
// the call moves 0.8-3.3 MB of operands and does 0.52 G int8 operations:
// under 1 us at the HBM rate, far less at the tensor cores'.  The time goes
// to latency: the L2 traffic of tiles that several blocks re-read, shared-
// memory traffic, and per-K-step instruction chains with few warps per SM
// (PERF.md breaks it down with coupling_gemm_breakdown.py).
// The design:
//   * Tiles and grid per shape, chosen by autotune.coupling_plan and passed
//     in by the wrapper (`tile`, with its shape `bm` x `bn`, which the
//     launch checks against Tile<>), both of 8 warps:
//       - WIDE: 64 lanes x 32 rows per block; four warp pairs each own a
//         32 x 16 quarter (2 x 2 mma tiles) and split its k32 steps; 256
//         blocks at (1024, 506, 506).
//       - SPLIT: 16 lanes x 16 rows per block, the k32 steps dealt round
//         robin to the 8 warps; 128 blocks at the Max-Cut shape
//         16 x (64, 506) . (32, 506), where WIDE has 16.
//     The warps' partial sums meet in shared memory (one launch, no
//     atomics), where all threads add them and store whole rows of `out`.
//   * A ring of STAGES K-steps of BK = 128 bytes in shared memory, filled by
//     16-byte cp.async: steps t + 1 .. t + STAGES - 1 are in flight while
//     step t + 1 is realigned and step t multiplied, one barrier per step.
//   * Rows of N = 506 start 2 bytes off a word boundary (and anywhere in an
//     offset view), so no copy size fits them.  Each staged row holds the
//     aligned 16-byte chunks that cover its K-step (nine for 128 bytes at
//     an offset), and one pass per step rebuilds the aligned row into a
//     fragment tile: five word reads at the row's word offset, four
//     __funnelshift_r, columns past the step masked (packed counters of
//     PACKED become spins here, once per block).  Fragment tiles keep
//     144-byte rows, so the mma's fragment reads (rows g, columns 4t) fall
//     on 32 distinct banks.  No byte of sigma or W is loaded one by one
//     except in a chunk at either end of a tensor that is not wholly inside
//     it (a base or length off 16 bytes): it is copied by words and its
//     partial words by bytes, so that nothing outside the tensor is read.
//     One path serves every N and alignment.
//
// Plain C interface for ctypes: every entry returns cudaGetLastError(), or
// cudaErrorInvalidValue for a plan the kernel cannot run (a tile it does not
// instantiate, a tile shape other than the plan's, a span it cannot walk).

#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

#include "attributes.cuh"

namespace {

constexpr int BK = 128;         // contraction bytes per K-step: four k32 steps of the mma
constexpr int CHUNKS = BK / 16; // 16-byte chunks of a K-step on a 16-byte aligned row
constexpr int RAW_LD = 36;      // words per staged row: the nine aligned chunks that
                                // cover BK bytes at any offset
constexpr int FRAG_LD = 36;     // words per realigned row: BK bytes and 16 of padding,
                                // so the fragment reads of rows g, columns 4t hit
                                // 32 distinct banks

enum Mode { SUM = 0, PHASE = 1, PACKED = 2, STEP = 3 };

// A block tile: FM x FN mma tiles (16 x 8 each) per warp, WM x WN warps over
// the output tile, KS warps over the k32 steps, STAGES K-steps in the ring.
template <int FM_, int FN_, int WM_, int WN_, int KS_, int STAGES_>
struct Tile {
  static constexpr int FM = FM_, FN = FN_, WM = WM_, WN = WN_, KS = KS_, STAGES = STAGES_;
  static constexpr int BM = 16 * FM * WM;  // lanes
  static constexpr int BN = 8 * FN * WN;   // output rows
  static constexpr int THREADS = 32 * WM * WN * KS;
};
using Wide = Tile<2, 2, 2, 2, 2, 3>;   // plan tile 0: 64 x 32, 69,120 bytes of shared memory
using Split = Tile<1, 2, 1, 1, 8, 4>;  // plan tile 1: 16 x 16, 27,648 bytes

// Output element type of each mode: int32 sums and phases, int8 spins.
template <int MODE> struct OutOf { using type = int32_t; };
template <> struct OutOf<STEP> { using type = int8_t; };

// --- PTX -------------------------------------------------------------------

// D += A . B on one warp: A 16 x 32 s8 (row), B 32 x 8 s8 (col), D 16 x 8 s32.
// Lane l = 4g + t holds a = {A[g][4t..], A[g+8][4t..], A[g][16+4t..],
// A[g+8][16+4t..]}, b = {B[4t..][g], B[16+4t..][g]} and d = {D[g][2t],
// D[g][2t+1], D[g+8][2t], D[g+8][2t+1]}.
__device__ __forceinline__ void mma_s8_16832(int (&d)[4], const uint32_t (&a)[4],
                                             const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem));
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// --- staging ---------------------------------------------------------------

// The bytes of the word at `wa` that lie in [lo, hi), the others zero: the
// partial first or last word of a tensor.
__device__ __forceinline__ uint32_t edge_word(const uint8_t* wa, const uint8_t* lo,
                                              const uint8_t* hi) {
  uint32_t v = 0;
  for (int i = 0; i < 4; ++i)
    if (wa + i >= lo && wa + i < hi) v |= (uint32_t)wa[i] << (8 * i);
  return v;
}

// Bytes of the word at column c that lie before `width`.
__device__ __forceinline__ uint32_t live_mask(int c, int width) {
  const int n = width - c;
  return n >= 4 ? 0xFFFFFFFFu : (n <= 0 ? 0u : (1u << (8 * n)) - 1u);
}

// Four spins (+1 -> 0x01, -1 -> 0xFF) from the four 4-bit counters of the
// low 16 bits of `bits`, low nibble first: +1 iff theta < half.
__device__ __forceinline__ uint32_t spins_of(uint32_t bits, int half) {
  uint32_t r = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i)
    r |= (((bits >> (4 * i)) & 0xFu) < (uint32_t)half ? 0x01u : 0xFFu) << (8 * i);
  return r;
}

// Start the copy of 16-byte chunk c of a staged row: `ca` the row's step
// rounded down to 16 bytes, `chunks` the chunks that hold its bytes.  A chunk
// that is not wholly inside the tensor's bytes [lo, hi) (only at either end
// of a tensor) is copied word by word, its partial words byte by byte.
__device__ __forceinline__ void copy_chunk(uint32_t* dst, const uint8_t* ca, int c, int chunks,
                                           const uint8_t* lo, const uint8_t* hi) {
  if (c >= chunks) return;
  const uint8_t* src = ca + 16 * c;
  dst += 4 * c;
  if (src >= lo && src + 16 <= hi) {
    cp_async16(dst, src);
    return;
  }
  for (int i = 0; i < 4; ++i) {
    const uint8_t* wa = src + 4 * i;
    if (wa + 4 <= lo || wa >= hi) continue;
    if (wa >= lo && wa + 4 <= hi) {
      cp_async4(dst + i, wa);
    } else {
      dst[i] = edge_word(wa, lo, hi);
    }
  }
}

// Realign chunk q (16 bytes, columns 16 q .. 16 q + 15) of one staged row
// into `dst`, the row of the fragment tile: its step starts `off` bytes into
// the staged row (for NIB, packed counters: `off` in bytes, two spins a
// byte), and columns at or past `width` are zeroed.
template <bool NIB>
__device__ __forceinline__ void realign_chunk(uint32_t* dst, const uint32_t* raw, int off, int q,
                                              int width, int half) {
  const uint32_t sh = 8u * (uint32_t)(off & 3);
  uint32_t v[4];
  if (NIB) {  // packed bytes 8q .. 8q + 7 -> 16 spins
    const uint32_t* src = raw + (off >> 2) + 2 * q;
    const uint32_t p0 = __funnelshift_r(src[0], src[1], sh);
    const uint32_t p1 = __funnelshift_r(src[1], src[2], sh);
    v[0] = spins_of(p0, half);
    v[1] = spins_of(p0 >> 16, half);
    v[2] = spins_of(p1, half);
    v[3] = spins_of(p1 >> 16, half);
  } else {  // staged words off / 4 + 4q .. + 4
    const uint32_t* src = raw + (off >> 2) + 4 * q;
    const uint32_t w4 = src[4];
    v[0] = __funnelshift_r(src[0], src[1], sh);
    v[1] = __funnelshift_r(src[1], src[2], sh);
    v[2] = __funnelshift_r(src[2], src[3], sh);
    v[3] = __funnelshift_r(src[3], w4, sh);
  }
  if (16 * q + 16 > width) {  // the step's ragged tail
#pragma unroll
    for (int i = 0; i < 4; ++i) v[i] &= live_mask(16 * q + 4 * i, width);
  }
  *reinterpret_cast<uint4*>(dst + 4 * q) = make_uint4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ int nibble(const uint8_t* __restrict__ row, int k) {
  return (row[k >> 1] >> ((k & 1) * 4)) & 0xF;
}

template <int MODE, class T>
__global__ void __launch_bounds__(T::THREADS)
coupling_gemm_kernel(const int8_t* __restrict__ sigma,    // (I, B, N), all but PACKED
                     const uint8_t* __restrict__ packed,  // (B, ceil(N/2)), PACKED
                     const int8_t* __restrict__ w,        // (I, M, N)
                     const int32_t* __restrict__ bias,    // (M,), PHASE/PACKED/STEP
                     const int32_t* __restrict__ phase,   // (B, M), PHASE
                     typename OutOf<MODE>::type* __restrict__ out,  // (I, B, M)
                     int I, int B, int M, int N, int span, int half) {
  using OutT = typename OutOf<MODE>::type;
  constexpr int FM = T::FM, FN = T::FN, STAGES = T::STAGES, ROWS = T::BM + T::BN;
  constexpr bool NIB = MODE == PACKED;
  // The ring of STAGES staged K-steps, ROWS x RAW_LD words each, then two
  // realigned fragment tiles, ROWS x FRAG_LD words each (dynamic: the wide
  // tile's are past the 48 KB of static shared memory).
  extern __shared__ __align__(16) uint32_t s_ring[];
  uint32_t* const s_frag = s_ring + STAGES * ROWS * RAW_LD;

  const int pw = (N + 1) / 2;
  const int layers = MODE == SUM ? I : 1;
  const uint8_t* s8 = NIB ? packed : reinterpret_cast<const uint8_t*>(sigma);
  const uint8_t* w8 = reinterpret_cast<const uint8_t*>(w);
  const size_t s_ld = NIB ? (size_t)pw : (size_t)N;
  const uint8_t* s_hi = s8 + (size_t)layers * B * s_ld;
  const uint8_t* w_hi = w8 + (size_t)layers * M * N;
  const uint8_t* s_base = s8;
  const uint8_t* w_base = w8;
  if (MODE == SUM) {  // this block's instance
    const size_t inst = blockIdx.z;
    s_base += inst * B * N;
    w_base += inst * M * N;
    out += inst * B * M;
  }

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tg = lane & 3;
  const int wm = warp % T::WM, wn = (warp / T::WM) % T::WN, kslice = warp / (T::WM * T::WN);
  const int b0 = blockIdx.y * T::BM, i0 = blockIdx.x * T::BN;
  const int per_unit = (span + BK - 1) / BK;
  const int steps = N > 0 ? (N + span - 1) / span * per_unit : 0;

  // Copies: this thread stages chunk q of rows (tid / CHUNKS) + k * ROW_STEP,
  // sigma's rows first, then W's; the row addresses are fixed for the walk.
  constexpr int ROW_STEP = T::THREADS / CHUNKS, COPIES = (ROWS + ROW_STEP - 1) / ROW_STEP;
  static_assert(T::THREADS % CHUNKS == 0, "copy slots");
  const int q = tid % CHUNKS, r0 = tid / CHUNKS;
  const uint8_t* rowp[COPIES];
  bool live[COPIES], sig[COPIES];
#pragma unroll
  for (int k = 0; k < COPIES; ++k) {
    const int r = r0 + k * ROW_STEP;
    sig[k] = r < T::BM;
    if (sig[k]) {
      rowp[k] = s_base + (size_t)(b0 + r) * s_ld;
      live[k] = b0 + r < B;  // rows past the operand are not copied:
    } else {                 // their outputs are never stored
      rowp[k] = w_base + (size_t)(i0 + r - T::BM) * N;
      live[k] = r < ROWS && i0 + r - T::BM < M;
    }
  }

  // K-step t: its first column and its live width (<= 0 for the padding
  // steps of a ragged last group).
  auto step_of = [&](int t, int& k0, int& width) {
    const int u = t / per_unit, sub = t - u * per_unit;
    k0 = u * span + sub * BK;
    width = min(min(BK, span - sub * BK), N - k0);
  };
  auto issue = [&](int t) {
    if (t < steps) {
      int k0, width;
      step_of(t, k0, width);
      uint32_t* raw = s_ring + (t % STAGES) * ROWS * RAW_LD;
#pragma unroll
      for (int k = 0; k < COPIES; ++k) {
        const bool nib = NIB && sig[k];
        const int c0 = nib ? k0 / 2 : k0;
        const int nbytes = nib ? (width + 1) / 2 : width;
        if (!live[k] || nbytes <= 0) continue;
        const uint8_t* a = rowp[k] + c0;
        const int off = (int)(reinterpret_cast<uintptr_t>(a) & 15);
        const uint8_t* ca = a - off;
        const int chunks = (off + nbytes + 15) >> 4;
        uint32_t* dst = raw + (r0 + k * ROW_STEP) * RAW_LD;
        const uint8_t* lo = sig[k] ? s8 : w8;
        const uint8_t* hi = sig[k] ? s_hi : w_hi;
        copy_chunk(dst, ca, q, chunks, lo, hi);
        if (q == CHUNKS - 1) copy_chunk(dst, ca, CHUNKS, chunks, lo, hi);  // the ninth
      }
    }
    cp_async_commit();  // one group per step, empty past the end
  };

  // Realign step t from its staged rows into fragment tile t % 2: this
  // thread's rows and chunk are its copy slots'.
  auto realign = [&](int t) {
    int k0, width;
    step_of(t, k0, width);
    const uint32_t* raw = s_ring + (t % STAGES) * ROWS * RAW_LD;
    uint32_t* frag = s_frag + (t & 1) * ROWS * FRAG_LD;
#pragma unroll
    for (int k = 0; k < COPIES; ++k) {
      const int r = r0 + k * ROW_STEP;
      if (COPIES * ROW_STEP > ROWS && r >= ROWS) continue;
      const bool nib = NIB && sig[k];
      const uint8_t* first = rowp[k] + (nib ? k0 / 2 : k0);
      const int off = (int)(reinterpret_cast<uintptr_t>(first) & 15);
      if (nib) {
        realign_chunk<true>(frag + r * FRAG_LD, raw + r * RAW_LD, off, q, width, half);
      } else {
        realign_chunk<false>(frag + r * FRAG_LD, raw + r * RAW_LD, off, q, width, half);
      }
    }
  };

  int acc[FM][FN][4];
#pragma unroll
  for (int fm = 0; fm < FM; ++fm)
#pragma unroll
    for (int fn = 0; fn < FN; ++fn)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[fm][fn][e] = 0;

  // This thread's fragment words: sigma rows g and g + 8 of each of the
  // warp's FM mma tiles, W row g of each of its FN, column 4 tg.
  const int a_base = (wm * 16 * FM + g) * FRAG_LD + tg;
  const int b_base = (T::BM + wn * 8 * FN + g) * FRAG_LD + tg;

  // Pipeline: step t + STAGES is in flight while step t + 1 is realigned and
  // step t multiplied; one barrier per step.
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) issue(s);
  if (steps > 0) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    realign(0);
    issue(STAGES - 1);
  }
  for (int t = 0; t < steps; ++t) {
    cp_async_wait<STAGES - 2>();  // step t + 1 has landed
    __syncthreads();              // ... for every thread; tile t is realigned, tile t + 1
                                  // and ring slot t are free
    issue(t + STAGES);
    if (t + 1 < steps) realign(t + 1);
    int k0, width;
    step_of(t, k0, width);
    const uint32_t* fa = s_frag + (t & 1) * ROWS * FRAG_LD + a_base;
    const uint32_t* fb = s_frag + (t & 1) * ROWS * FRAG_LD + b_base;
    const int live_k32 = (width + 31) / 32;  // k32 steps with a live column
#pragma unroll
    for (int s = 0; s < BK / 32; ++s) {
      if (s >= live_k32) break;
      if (T::KS > 1 && (s + (BK / 32) * t) % T::KS != kslice) continue;
      uint32_t a[FM][4], bf[FN][2];
#pragma unroll
      for (int fm = 0; fm < FM; ++fm) {
        const uint32_t* r = fa + 16 * fm * FRAG_LD + 8 * s;
        a[fm][0] = r[0];
        a[fm][1] = r[8 * FRAG_LD];
        a[fm][2] = r[4];
        a[fm][3] = r[8 * FRAG_LD + 4];
      }
#pragma unroll
      for (int fn = 0; fn < FN; ++fn) {
        const uint32_t* r = fb + 8 * fn * FRAG_LD + 8 * s;
        bf[fn][0] = r[0];
        bf[fn][1] = r[4];
      }
#pragma unroll
      for (int fm = 0; fm < FM; ++fm)
#pragma unroll
        for (int fn = 0; fn < FN; ++fn) mma_s8_16832(acc[fm][fn], a[fm], bf[fn]);
    }
  }
  // Epilogue: every warp leaves its partial sums in shared memory (rows of
  // the tile, RED_LD words apart: the lanes' paired writes fall on distinct
  // banks), then each thread adds the K slices of column pairs along a row
  // and stores them, so that a warp writes whole rows of `out`.
  constexpr int RED_LD = T::BN + 8, PAIRS = T::BM * T::BN / 2;
  static_assert(T::KS * T::BM * RED_LD <= STAGES * ROWS * RAW_LD, "reduction space");
  cp_async_wait<0>();
  __syncthreads();  // every warp is done with the ring
  int* red = reinterpret_cast<int*>(s_ring);
#pragma unroll
  for (int fm = 0; fm < FM; ++fm)
#pragma unroll
    for (int fn = 0; fn < FN; ++fn)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = wm * 16 * FM + 16 * fm + g + 8 * h;
        const int col = wn * 8 * FN + 8 * fn + 2 * tg;
        *reinterpret_cast<int2*>(red + (kslice * T::BM + row) * RED_LD + col) =
            make_int2(acc[fm][fn][2 * h], acc[fm][fn][2 * h + 1]);
      }
  __syncthreads();

  // One element's value from its sum.
  auto finish = [&](int v, int b, int i, int keep) -> int {
    if (MODE == SUM) return v;
    v += bias[i];
    if (MODE == STEP) return v > 0 ? 1 : (v < 0 ? -1 : (int)sigma[(size_t)b * N + i]);  // i < N
    return v > 0 ? 0 : (v < 0 ? half : keep);
  };
  // Paired loads and stores where M is even and the pointers allow them.
  const bool pair = (M & 1) == 0 &&
                    (reinterpret_cast<uintptr_t>(out) & (2 * sizeof(OutT) - 1)) == 0 &&
                    (MODE != PHASE || (reinterpret_cast<uintptr_t>(phase) & 7) == 0);
  for (int e = tid; e < PAIRS; e += T::THREADS) {
    const int row = e / (T::BN / 2), col = 2 * (e % (T::BN / 2));
    const int b = b0 + row, i = i0 + col;
    if (b >= B || i >= M) continue;
    int v0 = 0, v1 = 0;
#pragma unroll
    for (int ks = 0; ks < T::KS; ++ks) {
      const int2 p = *reinterpret_cast<const int2*>(red + (ks * T::BM + row) * RED_LD + col);
      v0 += p.x;
      v1 += p.y;
    }
    const size_t o = (size_t)b * M + i;
    const bool two = i + 1 < M;
    int keep0 = 0, keep1 = 0;  // the kept phases of PHASE and PACKED
    if (MODE == PHASE) {
      if (pair && two) {
        const int2 p2 = *reinterpret_cast<const int2*>(phase + o);
        keep0 = p2.x;
        keep1 = p2.y;
      } else {
        keep0 = phase[o];
        keep1 = two ? phase[o + 1] : 0;
      }
    } else if (MODE == PACKED) {
      keep0 = nibble(packed + (size_t)b * pw, i);
      keep1 = two ? nibble(packed + (size_t)b * pw, i + 1) : 0;
    }
    v0 = finish(v0, b, i, keep0);
    if (!two) {
      out[o] = (OutT)v0;
      continue;
    }
    v1 = finish(v1, b, i + 1, keep1);
    if (!pair) {
      out[o] = (OutT)v0;
      out[o + 1] = (OutT)v1;
    } else if (MODE == STEP) {
      *reinterpret_cast<uint16_t*>(out + o) = (uint16_t)((v0 & 0xFF) | ((v1 & 0xFF) << 8));
    } else {
      *reinterpret_cast<int2*>(out + o) = make_int2(v0, v1);
    }
  }
}

// One block's dynamic shared memory on tile T: the cp.async ring and the two
// fragment buffers of its lane and row tiles.
template <class T>
constexpr int tile_smem() {
  return (T::STAGES * RAW_LD + 2 * FRAG_LD) * (T::BM + T::BN) * 4;
}

// Above 48 KB a block's dynamic shared memory needs an opt-in, once per
// device (a bit per ordinal, set only when the opt-in succeeded).
template <int MODE, class T>
cudaError_t opt_in_tile() {
  if (tile_smem<T>() <= 48 * 1024) return cudaSuccess;
  static std::atomic<unsigned long long> opted{0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned long long bit = dev < 64 ? 1ull << dev : 0ull;
  if (!(opted.load() & bit)) {
    err = cudaFuncSetAttribute(coupling_gemm_kernel<MODE, T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, tile_smem<T>());
    if (err != cudaSuccess) return err;
    opted.fetch_or(bit);
  }
  return cudaSuccess;
}

template <int MODE, class T>
int launch_tile(const void* sigma, const void* packed, const void* w, const void* bias,
                const void* phase, void* out, int I, int B, int M, int N, int span, int half,
                void* stream) {
  const dim3 grid((M + T::BN - 1) / T::BN, (B + T::BM - 1) / T::BM, I);
  if (grid.y > 65535) return (int)cudaErrorInvalidValue;
  using OutT = typename OutOf<MODE>::type;
  const cudaError_t err = opt_in_tile<MODE, T>();
  if (err != cudaSuccess) return (int)err;
  coupling_gemm_kernel<MODE, T><<<grid, T::THREADS, tile_smem<T>(), (cudaStream_t)stream>>>(
      (const int8_t*)sigma, (const uint8_t*)packed, (const int8_t*)w, (const int32_t*)bias,
      (const int32_t*)phase, (OutT*)out, I, B, M, N, span, half);
  return (int)cudaGetLastError();
}

// One launch of the plan that autotune.coupling_plan chose: its tile's index
// and shape (lanes bm x rows bn, refused unless they are this source's) and
// the walk's unit, `span` columns (PACKED reads two spins a byte, so its
// steps must start on even columns: an odd span only as one unit for all N).
template <class T>
bool tile_is(int bm, int bn) { return bm == T::BM && bn == T::BN; }

template <int MODE>
int launch(const void* sigma, const void* packed, const void* w, const void* bias,
           const void* phase, void* out, int I, int B, int M, int N, int half, int tile, int bm,
           int bn, int span, void* stream) {
  if (span <= 0 || I > 65535 || (I > 1 && MODE != SUM) || (MODE == PACKED && span % 2 && span < N))
    return (int)cudaErrorInvalidValue;
  const bool known = (tile == 0 && tile_is<Wide>(bm, bn)) || (tile == 1 && tile_is<Split>(bm, bn));
  if (!known) return (int)cudaErrorInvalidValue;
  if (I <= 0 || B <= 0 || M <= 0) return (int)cudaGetLastError();
  return tile == 0 ? launch_tile<MODE, Wide>(sigma, packed, w, bias, phase, out, I, B, M, N, span,
                                             half, stream)
                   : launch_tile<MODE, Split>(sigma, packed, w, bias, phase, out, I, B, M, N,
                                              span, half, stream);
}

// The instantiation that launch_tile runs, as compiled (kernel_attributes).
template <int MODE, class T>
int attributes_tile(int* out) {
  const cudaError_t err = opt_in_tile<MODE, T>();
  if (err != cudaSuccess) return (int)err;
  return kernel_attributes(coupling_gemm_kernel<MODE, T>, T::THREADS, tile_smem<T>(), out);
}

template <int MODE>
int attributes(int tile, int* out) {
  return tile == 0 ? attributes_tile<MODE, Wide>(out) : attributes_tile<MODE, Split>(out);
}

}  // namespace

extern "C" {

// Each entry ends in the launch plan: tile, bm, bn, span (see launch).

// S = sigma W^T per instance: sigma (I, B, N) int8, w (I, M, N) int8 ->
// out (I, B, M) int32 (I = 1: one (M, N) matrix or row slab).
int onn_coupling_sum(const void* sigma, const void* w, void* out, int I, int B, int M, int N,
                     int tile, int bm, int bn, int span, void* stream) {
  return launch<SUM>(sigma, nullptr, w, nullptr, nullptr, out, I, B, M, N, 0, tile, bm, bn, span,
                     stream);
}

// sigma' = sign(sigma W^T + h), ties keep sigma: sigma (B, N) int8,
// w (N, N) int8, bias (N,) int32 -> out (B, N) int8.
int onn_step(const void* sigma, const void* w, const void* bias, void* out, int B, int N,
             int tile, int bm, int bn, int span, void* stream) {
  return launch<STEP>(sigma, nullptr, w, bias, nullptr, out, 1, B, N, N, 0, tile, bm, bn, span,
                      stream);
}

// theta' = phase-align(sigma W^T + h, theta): sigma (B, N) int8, w (N, N) int8,
// bias (N,) int32, phase (B, N) int32 -> out (B, N) int32.
int onn_phase_step(const void* sigma, const void* w, const void* bias, const void* phase,
                   void* out, int B, int N, int half, int tile, int bm, int bn, int span,
                   void* stream) {
  return launch<PHASE>(sigma, nullptr, w, bias, phase, out, 1, B, N, N, half, tile, bm, bn, span,
                       stream);
}

// As onn_phase_step with sigma and theta unpacked from packed (B, ceil(N/2)) uint8.
int onn_phase_step_packed(const void* packed, const void* w, const void* bias, void* out,
                          int B, int N, int half, int tile, int bm, int bn, int span,
                          void* stream) {
  return launch<PACKED>(nullptr, packed, w, bias, nullptr, out, 1, B, N, N, half, tile, bm, bn,
                        span, stream);
}

// The instantiation that a launch of `mode` (0 sum, 1 phase, 2 packed, 3 step)
// on the plan (tile, bm, bn, span) runs, as compiled: out[6], as
// kernel_attributes (attributes.cuh) fills it.  Launches nothing.
int onn_coupling_gemm_attributes(int mode, int tile, int bm, int bn, int span, void* out) {
  const bool known = (tile == 0 && tile_is<Wide>(bm, bn)) || (tile == 1 && tile_is<Split>(bm, bn));
  if (!known || span <= 0 || mode < SUM || mode > STEP) return (int)cudaErrorInvalidValue;
  int* o = static_cast<int*>(out);
  switch (mode) {
    case SUM: return attributes<SUM>(tile, o);
    case PHASE: return attributes<PHASE>(tile, o);
    case PACKED: return attributes<PACKED>(tile, o);
    default: return attributes<STEP>(tile, o);
  }
}

}  // extern "C"
