// A whole settle-chunk of functional-mode ONN cycles in one launch (sm_90a).
//
// Replaces phase_step_multi_pallas / _phase_step_multi_kernel of
// src/repro/kernels/coupling_kernel.py: `chunk` cycles of
//   theta' = phase-align(sigma(theta) W^T + h, theta)
// per lane, each followed by the per-lane settle/freeze bookkeeping in the
// order of coupling_kernel.py:476-490, with the state (theta, prev-theta and
// seven int32 columns) read once and written once per launch.  The packed
// variant reads and writes two 4-bit counters per byte (low nibble first, an
// odd N pads a zero nibble).
//
// What bounds it on this card: a chunk of 8 cycles at B = 1024, N = 506 does
// 2 * B * N^2 int8 operations per cycle (4.2 G a launch, 2 us at the int8
// tensor cores' peak) on 8.3 MB of lane state and 0.26 MB of W (2.6 us at
// the HBM rate), so it is bound by bytes; in practice by latency, since the
// 8 cycles are dependent and each ends in an exchange across the lanes' rows.
//
// Two regimes, one source; autotune.multi_plan picks one by shape alone and
// passes the plan (regime, cluster, lanes, rows, shared memory) in; a plan
// this source cannot run is refused, never replaced by the other regime.
//
// CLUSTER (N <= autotune.MULTI_CLUSTER_MAX_N, every configured N): W is held
// once per launch in a thread-block cluster's shared memory.
//   * A cluster of C CTAs (2, 4 or 8, launched with cudaLaunchKernelEx and a
//     cluster dimension) owns L lanes (8, 16 or 32).  CTA rank r owns the
//     output rows [r R, (r + 1) R) of W, R a multiple of 16, and copies that
//     slice into shared memory once, by 16-byte cp.async; rows keep a pitch of
//     KS + 16 bytes (KS: the row rounded up to whole k32 steps), so the
//     fragment reads of rows g, words t fall on 32 distinct banks.
//   * The product runs on mma.sync.m16n8k32 s8 -> s32: A is 16 rows of the
//     slice (one row tile per warp, R / 16 warps), B is sigma of 8 lanes, read
//     from shared memory every k32 step.  A lane tile whose 8 lanes are all
//     inactive skips its mma.
//   * theta and prev-theta of each (row, lane) of a thread's accumulator
//     fragments live in registers for the whole chunk.
//   * sigma lives in shared memory, double-buffered: 2 x L x (KS + 16) bytes,
//     its columns past N zero against W's zero pad.  Each cycle every CTA
//     writes sigma' of its own rows into its own next buffer, then copies that
//     block of each lane into every peer's next buffer through distributed
//     shared memory, 16 bytes a store.
//   * The per-lane all(next == theta) and all(next == prev) are 32-bit lane
//     masks, reduced in the warp (__reduce_and_sync), then across the CTA's
//     warps, then written into every peer's slot for this rank; the slots are
//     double-buffered by cycle parity like sigma.  Rows past N are left out.
//   * One cluster barrier per cycle: with both double buffers, no CTA writes
//     a buffer or a slot until every peer has passed the barrier that ends its
//     reads of it.  After it every CTA ANDs the C partial masks and runs the
//     same bookkeeping on lane masks, so the early exit when no lane is active
//     is the same in every CTA.  Threads 0..L-1 of each CTA also keep their
//     lane's seven columns; rank 0 stores them.  A last cluster barrier keeps
//     every CTA's shared memory alive while a peer can still reach it.
//   * Lanes past B are born frozen.
//
// STREAM (MULTI_CLUSTER_MAX_N < N <= MULTI_KERNEL_MAX_N): each block owns BB
// whole lanes (1, 2, 4 or 8) and streams W from L2 every cycle as 16-byte
// loads of a row zero-padded to KP bytes (__dp4a); the three int32 phase
// buffers of each lane live in shared memory and rotate by index; the
// per-lane flags are block reductions through shared memory.
//
// Plain C interface for ctypes: the entry returns cudaGetLastError(), or
// cudaErrorInvalidValue for a plan it cannot run.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <climits>

#include "attributes.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int NCOLS = 7;  // t, settle_cycle, settled, cycled, frozen, frozen_p2, freeze_cycle
enum Col { T = 0, SC = 1, SD = 2, CY = 3, FZ = 4, FP2 = 5, FC = 6 };

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

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::);
}

// --- CLUSTER regime ----------------------------------------------------------

constexpr int CL_MAX_CLUSTER = 8;
constexpr int CL_MAX_WARPS = 16;  // R <= 256 rows: one 16-row tile per warp
constexpr int CL_THREADS_MAX = 32 * CL_MAX_WARPS;
// Head of the dynamic shared memory: the partial lane masks of every rank by
// cycle parity, [2][CL_MAX_CLUSTER][2] words (128 bytes); the warps' masks,
// [CL_MAX_WARPS][2] (128 bytes); the lanes' clocks at entry, [32] (128 bytes);
// the entry mask of active lanes (4 bytes).  Then the W slice, then sigma.
constexpr int CL_SLOTS = 0, CL_WARP_MASKS = 128, CL_T0 = 256, CL_ACT0 = 384, CL_HEAD = 512;

// Bytes of a shared-memory row (W slice and sigma): KP rounded up to whole
// k32 steps, plus 16 so that rows g = 0..7 start on distinct bank groups.
inline int cluster_pitch(int KP) { return (KP + 31) / 32 * 32 + 16; }

inline long long cluster_smem(int R, int L, int KP) {
  return CL_HEAD + (long long)(R + 2 * L) * cluster_pitch(KP);
}

__device__ __forceinline__ uint32_t ld32(const int8_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

template <bool PACKED, int LT>
__global__ void __launch_bounds__(CL_THREADS_MAX)
phase_step_multi_cluster(const int8_t* __restrict__ w,      // (N, KP), zero columns past N
                         const int32_t* __restrict__ bias,  // (N,)
                         const void* __restrict__ phase_in, // (B, N) int32 | (B, ceil(N/2)) uint8
                         const void* __restrict__ prev_in,
                         const int32_t* __restrict__ cols_in,  // (7, B)
                         void* __restrict__ phase_out, void* __restrict__ prev_out,
                         int32_t* __restrict__ cols_out,       // (7, B)
                         int B, int N, int KP, int R, int half, int chunk, int max_cycles) {
  constexpr int L = 8 * LT;
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int KS = (KP + 31) / 32 * 32, P = KS + 16;
  uint32_t* slots = reinterpret_cast<uint32_t*>(smem + CL_SLOTS);
  uint32_t* warp_masks = reinterpret_cast<uint32_t*>(smem + CL_WARP_MASKS);
  int* lane_t0 = reinterpret_cast<int*>(smem + CL_T0);
  uint32_t* act0 = reinterpret_cast<uint32_t*>(smem + CL_ACT0);
  int8_t* sw = reinterpret_cast<int8_t*>(smem + CL_HEAD);  // (R, P)
  int8_t* sig = sw + (size_t)R * P;                        // (2, L, P)

  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int warp = tid >> 5, ln = tid & 31, g = ln >> 2, tq = ln & 3;
  const int lane0 = (int)(blockIdx.x / C) * L;  // a cluster's CTAs are consecutive in x
  const int row0 = rank * R;
  const int rbase = row0 + warp * 16 + g;  // rows rbase and rbase + 8 of this thread
  const bool rvalid[2] = {rbase < N, rbase + 8 < N};
  const bool tile_live = rbase - g < N;    // warp-uniform: the tile holds a row of W
  const int pw = (N + 1) / 2;

  // 1. This rank's slice of W into shared memory, 16 bytes a copy; the k32
  //    pad past KP and the rows past N of the last tile are zeroed.
  {
    const int rows = max(0, min(R, N - row0));
    const int cpr = KP / 16;
    for (int e = tid; e < rows * cpr; e += nthreads) {
      const int r = e / cpr, c = e % cpr;
      cp_async16(sw + (size_t)r * P + 16 * c, w + (size_t)(row0 + r) * KP + 16 * c);
    }
    if (KS > KP)
      for (int r = tid; r < rows; r += nthreads)
        *reinterpret_cast<int4*>(sw + (size_t)r * P + KP) = make_int4(0, 0, 0, 0);
    const int tail = min(R, (rows + 15) / 16 * 16);
    for (int e = tid; e < (tail - rows) * (KS / 16); e += nthreads) {
      const int r = rows + e / (KS / 16), c = e % (KS / 16);
      *reinterpret_cast<int4*>(sw + (size_t)r * P + 16 * c) = make_int4(0, 0, 0, 0);
    }
  }

  // 2. Bookkeeping columns: thread l < L keeps lane l's seven in registers.
  int col[NCOLS];
#pragma unroll
  for (int c = 0; c < NCOLS; ++c) col[c] = 0;
  if (tid < L) {
    const int lane = lane0 + tid;
#pragma unroll
    for (int c = 0; c < NCOLS; ++c) {
      if (lane < B) col[c] = cols_in[(size_t)c * B + lane];
      else if (c == T) col[c] = max_cycles;  // lanes past B are born frozen
      else if (c == FZ) col[c] = 1;
    }
    lane_t0[tid] = col[T];
  }
  if (warp == 0) {
    const uint32_t a = __ballot_sync(0xFFFFFFFFu, tid < L && col[FZ] == 0 && col[T] < max_cycles);
    if (tid == 0) *act0 = a;
  }

  // 3. theta and prev of this thread's fragment elements: element e of lane
  //    tile j is row rbase + 8 (e >> 1), lane lane0 + 8 j + 2 tq + (e & 1).
  int th[LT][4], pv[LT][4];
  const int hb[2] = {rvalid[0] ? bias[rbase] : 0, rvalid[1] ? bias[rbase + 8] : 0};
#pragma unroll
  for (int j = 0; j < LT; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int lane = lane0 + 8 * j + 2 * tq + (e & 1);
      const int i = rbase + 8 * (e >> 1);
      int p = 0, q = 0;  // padding rows and lanes: theta = 0
      if (lane < B && i < N) {
        if (PACKED) {
          const size_t o = (size_t)lane * pw + (i >> 1);
          const int sh = (i & 1) * 4;
          p = (static_cast<const uint8_t*>(phase_in)[o] >> sh) & 0xF;
          q = (static_cast<const uint8_t*>(prev_in)[o] >> sh) & 0xF;
        } else {
          p = static_cast<const int32_t*>(phase_in)[(size_t)lane * N + i];
          q = static_cast<const int32_t*>(prev_in)[(size_t)lane * N + i];
        }
      }
      th[j][e] = p;
      pv[j][e] = q;
    }
  }

  // sigma of this thread's elements into this CTA's copy of buffer `buf`.
  auto put_local = [&](int buf) {
    int8_t* s = sig + (size_t)buf * L * P;
#pragma unroll
    for (int j = 0; j < LT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (rvalid[e >> 1])
          s[(size_t)(8 * j + 2 * tq + (e & 1)) * P + rbase + 8 * (e >> 1)] =
              th[j][e] < half ? 1 : -1;
  };
  // This rank's columns of buffer `buf` (all L lanes) into every peer's copy.
  const int c_end = min(row0 + R, KS);
  const int cpl = c_end > row0 ? (c_end - row0) / 16 : 0;  // 16-byte chunks per lane
  auto put_peers = [&](int buf) {
    const size_t base = (size_t)buf * L * P + row0;
    for (int e = tid; e < (C - 1) * L * cpl; e += nthreads) {
      const int k = e / (L * cpl), rem = e % (L * cpl);
      const int peer = k < rank ? k : k + 1;
      const size_t off = base + (size_t)(rem / cpl) * P + 16 * (rem % cpl);
      const int4 v = *reinterpret_cast<const int4*>(sig + off);
      *reinterpret_cast<int4*>(cluster.map_shared_rank(sig, peer) + off) = v;
    }
  };

  // 4. Zero both sigma buffers, wait for every CTA of the cluster (a peer's
  //    shared memory is reachable only once it runs), publish sigma(theta).
  for (int e = tid; e < 2 * L * P / 16; e += nthreads)
    reinterpret_cast<int4*>(sig)[e] = make_int4(0, 0, 0, 0);
  cluster.sync();
  put_local(0);
  __syncthreads();
  put_peers(0);
  cp_async_wait_all();
  cluster.sync();

  // Lane masks.  A lane active at cycle c has been active at every cycle
  // before it, so its clock is t0 + c: `live` holds the lanes whose clock is
  // within budget at cycle c, `nf` those past their first cycle; both change
  // only at the cycles a lane's clock crosses 0 or max_cycles (`rescan`).
  uint32_t act = *act0, live = 0, nf = 0;
  int rescan = 0;
  auto scan = [&](int c) {
    live = nf = 0;
    rescan = INT_MAX;
    for (int l = 0; l < L; ++l) {
      const long long t = (long long)lane_t0[l] + c;
      if (t < max_cycles) {
        live |= 1u << l;
        rescan = (int)min((long long)rescan, c + (max_cycles - t));
      }
      if (t > 0) nf |= 1u << l;
      else rescan = (int)min((long long)rescan, c + 1 - t);
    }
  };

  for (int cyc = 0; cyc < chunk; ++cyc) {
    if (cyc == rescan) scan(cyc);
    act &= live;
    if (act == 0) break;  // the same masks in every CTA: a cluster-uniform exit
    const int cur = cyc & 1, nxt = cur ^ 1;

    // S = W sigma for this warp's 16 rows and every lane tile with an active lane.
    int acc[LT][4];
#pragma unroll
    for (int j = 0; j < LT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] = 0;
    if (tile_live) {
      bool on[LT];
#pragma unroll
      for (int j = 0; j < LT; ++j) on[j] = ((act >> (8 * j)) & 0xFFu) != 0;
      const int8_t* a_lo = sw + (size_t)(warp * 16 + g) * P + 4 * tq;
      const int8_t* a_hi = a_lo + 8 * P;
      const int8_t* bq = sig + (size_t)cur * L * P + (size_t)g * P + 4 * tq;
      for (int k = 0; k < KS; k += 32) {
        const uint32_t a[4] = {ld32(a_lo + k), ld32(a_hi + k), ld32(a_lo + k + 16),
                               ld32(a_hi + k + 16)};
#pragma unroll
        for (int j = 0; j < LT; ++j) {
          if (!on[j]) continue;
          const int8_t* b = bq + (size_t)8 * j * P + k;
          const uint32_t bf[2] = {ld32(b), ld32(b + 16)};
          mma_s8_16832(acc[j], a, bf);
        }
      }
    }

    // Phase-align active lanes; the lane masks of this thread's rows.
    uint32_t unch = 0xFFFFFFFFu, p2 = 0xFFFFFFFFu;
#pragma unroll
    for (int j = 0; j < LT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int l = 8 * j + 2 * tq + (e & 1);
        if (!rvalid[e >> 1] || !((act >> l) & 1u)) continue;
        const int s = acc[j][e] + hb[e >> 1];
        const int n = s > 0 ? 0 : (s < 0 ? half : th[j][e]);
        if (n != th[j][e]) unch &= ~(1u << l);
        if (n != pv[j][e]) p2 &= ~(1u << l);
        pv[j][e] = th[j][e];
        th[j][e] = n;
      }
    }
    put_local(nxt);
    unch = __reduce_and_sync(0xFFFFFFFFu, unch);
    p2 = __reduce_and_sync(0xFFFFFFFFu, p2);
    if (ln == 0) {
      warp_masks[2 * warp] = unch;
      warp_masks[2 * warp + 1] = p2;
    }
    __syncthreads();
    put_peers(nxt);
    if (tid < C) {  // this rank's partial masks into rank tid's slot for it
      uint32_t u = 0xFFFFFFFFu, q = 0xFFFFFFFFu;
      for (int v = 0; v < nthreads / 32; ++v) {
        u &= warp_masks[2 * v];
        q &= warp_masks[2 * v + 1];
      }
      uint32_t* dst = cluster.map_shared_rank(slots, tid) + (cur * CL_MAX_CLUSTER + rank) * 2;
      dst[0] = u;
      dst[1] = q;
    }
    cluster.sync();

    // Bookkeeping, in every CTA alike.
    uint32_t U = 0xFFFFFFFFu, P2 = 0xFFFFFFFFu;
    for (int r = 0; r < C; ++r) {
      U &= slots[(cur * CL_MAX_CLUSTER + r) * 2];
      P2 &= slots[(cur * CL_MAX_CLUSTER + r) * 2 + 1];
    }
    const uint32_t cycle2 = P2 & ~U & nf;
    const uint32_t newly = act & (U | cycle2);
    if (tid < L && ((act >> tid) & 1u)) {
      const bool un = (U >> tid) & 1u, c2 = (cycle2 >> tid) & 1u;
      const int t = col[T];
      if (un && col[SD] == 0) col[SC] = t;
      if (un) col[SD] = 1;
      if (c2 && col[SD] == 0) col[CY] = 1;
      if (un || c2) {
        if (c2) col[FP2] = 1;
        col[FC] = t + 1;
        col[FZ] = 1;
      }
      col[T] = t + 1;
    }
    act &= ~newly;
  }
  cluster.sync();  // no CTA leaves while a peer can still reach its shared memory

  if (rank == 0 && tid < L && lane0 + tid < B)
#pragma unroll
    for (int c = 0; c < NCOLS; ++c) cols_out[(size_t)c * B + lane0 + tid] = col[c];
#pragma unroll
  for (int j = 0; j < LT; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int lane = lane0 + 8 * j + 2 * tq + (e & 1);
      const int i = rbase + 8 * (e >> 1);
      if (PACKED) {
        // Rows i (g even) and i + 1 (the thread four lanes up) share a byte.
        const int th_hi = __shfl_xor_sync(0xFFFFFFFFu, th[j][e], 4);
        const int pv_hi = __shfl_xor_sync(0xFFFFFFFFu, pv[j][e], 4);
        if ((g & 1) || lane >= B || i >= N) continue;
        const bool two = i + 1 < N;  // odd N: zero pad nibble
        const size_t o = (size_t)lane * pw + (i >> 1);
        static_cast<uint8_t*>(phase_out)[o] =
            (uint8_t)((th[j][e] & 0xF) | (two ? (th_hi & 0xF) << 4 : 0));
        static_cast<uint8_t*>(prev_out)[o] =
            (uint8_t)((pv[j][e] & 0xF) | (two ? (pv_hi & 0xF) << 4 : 0));
      } else {
        if (lane >= B || i >= N) continue;
        static_cast<int32_t*>(phase_out)[(size_t)lane * N + i] = th[j][e];
        static_cast<int32_t*>(prev_out)[(size_t)lane * N + i] = pv[j][e];
      }
    }
  }
}

// --- STREAM regime -----------------------------------------------------------

constexpr int ST_THREADS = 256;

inline long long stream_smem(int BB, int N, int KP) {
  const long long ph_bytes = 3LL * BB * N * (long long)sizeof(int32_t);
  return (ph_bytes + 15) / 16 * 16 + (long long)BB * KP;
}

template <bool PACKED, int BB>
__global__ void __launch_bounds__(ST_THREADS)
phase_step_multi_stream(const int8_t* __restrict__ w,      // (N, KP), zero columns past N
                        const int32_t* __restrict__ bias,  // (N,)
                        const void* __restrict__ phase_in, // (B, N) int32 | (B, ceil(N/2)) uint8
                        const void* __restrict__ prev_in,
                        const int32_t* __restrict__ cols_in,  // (7, B)
                        void* __restrict__ phase_out,
                        void* __restrict__ prev_out,
                        int32_t* __restrict__ cols_out,       // (7, B)
                        int B, int N, int KP, int half, int chunk, int max_cycles) {
  extern __shared__ __align__(16) unsigned char smem[];
  // Lane state: ph[slot][lane][i], three rotating int32 buffers per lane.
  int32_t* ph = reinterpret_cast<int32_t*>(smem);
  const size_t ph_bytes = (size_t)3 * BB * N * sizeof(int32_t);
  int8_t* sig = reinterpret_cast<int8_t*>(smem + ((ph_bytes + 15) / 16) * 16);  // (BB, KP)

  __shared__ int s_col[NCOLS][BB];
  __shared__ int s_cur[BB], s_prv[BB], s_act[BB], s_unch[BB], s_p2[BB];
  __shared__ int s_any;

  const int tid = threadIdx.x;
  const int lane0 = blockIdx.x * BB;
  const int pw = (N + 1) / 2;
  auto buf = [&](int slot, int l) { return ph + ((size_t)slot * BB + l) * N; };

  if (tid < BB) {
    const int lane = lane0 + tid;
    for (int c = 0; c < NCOLS; ++c) {
      int v = 0;
      if (lane < B) v = cols_in[(size_t)c * B + lane];
      else if (c == T) v = max_cycles;  // lanes past B are born frozen
      else if (c == FZ) v = 1;
      s_col[c][tid] = v;
    }
    s_cur[tid] = 0;
    s_prv[tid] = 1;
  }
  for (int e = tid; e < BB * N; e += ST_THREADS) {
    const int l = e / N, i = e % N;
    const int lane = lane0 + l;
    int p = 0, q = 0;  // inert padding lanes: theta = 0
    if (lane < B) {
      if (PACKED) {
        const uint8_t* pr = static_cast<const uint8_t*>(phase_in) + (size_t)lane * pw;
        const uint8_t* qr = static_cast<const uint8_t*>(prev_in) + (size_t)lane * pw;
        p = (pr[i >> 1] >> ((i & 1) * 4)) & 0xF;
        q = (qr[i >> 1] >> ((i & 1) * 4)) & 0xF;
      } else {
        p = static_cast<const int32_t*>(phase_in)[(size_t)lane * N + i];
        q = static_cast<const int32_t*>(prev_in)[(size_t)lane * N + i];
      }
    }
    buf(0, l)[i] = p;
    buf(1, l)[i] = q;
  }
  for (int e = tid; e < BB * (KP - N); e += ST_THREADS) {
    const int l = e / (KP - N), k = N + e % (KP - N);
    sig[(size_t)l * KP + k] = 0;  // zero spins against W's zero pad columns
  }
  __syncthreads();

  for (int cyc = 0; cyc < chunk; ++cyc) {
    if (tid == 0) {
      int any = 0;
      for (int l = 0; l < BB; ++l) {
        const int act = (s_col[FZ][l] == 0) && (s_col[T][l] < max_cycles);
        s_act[l] = act;
        s_unch[l] = 1;
        s_p2[l] = 1;
        any |= act;
      }
      s_any = any;
    }
    __syncthreads();
    if (!s_any) break;  // inactive lanes stay inactive: the rest are no-ops

    for (int e = tid; e < BB * N; e += ST_THREADS) {
      const int l = e / N, i = e % N;
      sig[(size_t)l * KP + i] = buf(s_cur[l], l)[i] < half ? 1 : -1;
    }
    __syncthreads();

    for (int i = tid; i < N; i += ST_THREADS) {
      int acc[BB];
#pragma unroll
      for (int l = 0; l < BB; ++l) acc[l] = 0;
      const int4* wr = reinterpret_cast<const int4*>(w + (size_t)i * KP);
      for (int kv = 0; kv < KP / 16; ++kv) {
        const int4 wv = __ldg(wr + kv);
#pragma unroll
        for (int l = 0; l < BB; ++l) {
          const int4 sv = reinterpret_cast<const int4*>(sig + (size_t)l * KP)[kv];
          int a = acc[l];
          a = __dp4a(wv.x, sv.x, a);
          a = __dp4a(wv.y, sv.y, a);
          a = __dp4a(wv.z, sv.z, a);
          a = __dp4a(wv.w, sv.w, a);
          acc[l] = a;
        }
      }
      const int h = bias[i];
#pragma unroll
      for (int l = 0; l < BB; ++l) {
        const int cur = s_cur[l], prv = s_prv[l];
        const int nxt = 3 - cur - prv;
        const int s = acc[l] + h;
        const int th = buf(cur, l)[i];
        const int nph = s > 0 ? 0 : (s < 0 ? half : th);
        buf(nxt, l)[i] = nph;
        if (nph != th) s_unch[l] = 0;
        if (nph != buf(prv, l)[i]) s_p2[l] = 0;
      }
    }
    __syncthreads();

    if (tid < BB) {
      const int l = tid;
      const int t = s_col[T][l];
      const bool active = s_act[l];
      const bool not_first = t > 0;
      const bool unchanged = s_unch[l];
      const bool is_cycle2 = s_p2[l] && !unchanged && not_first;
      if (active && unchanged && s_col[SD][l] == 0) s_col[SC][l] = t;
      if (active && unchanged) s_col[SD][l] = 1;
      if (active && is_cycle2 && s_col[SD][l] == 0) s_col[CY][l] = 1;
      const bool newly = active && (unchanged || is_cycle2);
      if (active) {  // prev <- theta, theta <- next
        const int cur = s_cur[l], prv = s_prv[l];
        s_prv[l] = cur;
        s_cur[l] = 3 - cur - prv;
      }
      if (newly && is_cycle2) s_col[FP2][l] = 1;
      if (newly) s_col[FC][l] = t + 1;
      if (newly) s_col[FZ][l] = 1;
      if (active) s_col[T][l] = t + 1;
    }
    __syncthreads();
  }

  if (tid < BB && lane0 + tid < B) {
    for (int c = 0; c < NCOLS; ++c) cols_out[(size_t)c * B + lane0 + tid] = s_col[c][tid];
  }
  if (PACKED) {
    for (int e = tid; e < BB * pw; e += ST_THREADS) {
      const int l = e / pw, j = e % pw;
      const int lane = lane0 + l;
      if (lane >= B) continue;
      const int32_t* c = buf(s_cur[l], l);
      const int32_t* p = buf(s_prv[l], l);
      const int i = 2 * j;
      const int c_hi = (i + 1 < N) ? c[i + 1] : 0;  // odd N: zero pad nibble
      const int p_hi = (i + 1 < N) ? p[i + 1] : 0;
      static_cast<uint8_t*>(phase_out)[(size_t)lane * pw + j] =
          (uint8_t)((c[i] & 0xF) | ((c_hi & 0xF) << 4));
      static_cast<uint8_t*>(prev_out)[(size_t)lane * pw + j] =
          (uint8_t)((p[i] & 0xF) | ((p_hi & 0xF) << 4));
    }
  } else {
    for (int e = tid; e < BB * N; e += ST_THREADS) {
      const int l = e / N, i = e % N;
      const int lane = lane0 + l;
      if (lane >= B) continue;
      static_cast<int32_t*>(phase_out)[(size_t)lane * N + i] = buf(s_cur[l], l)[i];
      static_cast<int32_t*>(prev_out)[(size_t)lane * N + i] = buf(s_prv[l], l)[i];
    }
  }
}

// --- launch ------------------------------------------------------------------

struct Args {
  const void *w, *bias, *phase, *prev, *cols_in;
  void *phase_out, *prev_out, *cols_out;
  int B, N, KP, half, chunk, max_cycles;
};

// The instantiation for L lanes per cluster (8, 16, 32) or BB per block (1,
// 2, 4, 8); every instantiation of a regime has the same parameters.
template <bool PACKED>
decltype(&phase_step_multi_cluster<PACKED, 1>) cluster_kernel(int L) {
  return L == 8 ? phase_step_multi_cluster<PACKED, 1>
                : (L == 16 ? phase_step_multi_cluster<PACKED, 2> : phase_step_multi_cluster<PACKED, 4>);
}

template <bool PACKED>
decltype(&phase_step_multi_stream<PACKED, 1>) stream_kernel(int BB) {
  return BB == 1 ? phase_step_multi_stream<PACKED, 1>
                 : (BB == 2 ? phase_step_multi_stream<PACKED, 2>
                            : (BB == 4 ? phase_step_multi_stream<PACKED, 4>
                                       : phase_step_multi_stream<PACKED, 8>));
}

// A cluster CTA's threads for R rows: one warp per 16 rows.
constexpr int cluster_threads(int R) { return 2 * R; }

// A cluster launch of `blocks` CTAs of cluster_threads(R), C to a cluster.
struct ClusterConfig {
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg;
  ClusterConfig(int blocks, int C, int R, int smem, void* stream) : cfg{} {
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = (unsigned)C;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.gridDim = dim3((unsigned)blocks, 1, 1);
    cfg.blockDim = dim3((unsigned)cluster_threads(R), 1, 1);
    cfg.dynamicSmemBytes = (size_t)smem;
    cfg.stream = (cudaStream_t)stream;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
  }
};

template <class K>
cudaError_t opt_in(K kernel, int smem) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
}

template <bool PACKED>
int launch(const Args& a, int regime, int C, int L, int R, int smem, void* stream) {
  if (regime == 0) {
    const auto kernel = cluster_kernel<PACKED>(L);
    cudaError_t err = opt_in(kernel, smem);
    if (err != cudaSuccess) return (int)err;
    const ClusterConfig c((a.B + L - 1) / L * C, C, R, smem, stream);
    err = cudaLaunchKernelEx(&c.cfg, kernel, (const int8_t*)a.w, (const int32_t*)a.bias, a.phase,
                             a.prev, (const int32_t*)a.cols_in, a.phase_out, a.prev_out,
                             (int32_t*)a.cols_out, a.B, a.N, a.KP, R, a.half, a.chunk,
                             a.max_cycles);
    if (err != cudaSuccess) return (int)err;
    return (int)cudaGetLastError();
  }
  const auto kernel = stream_kernel<PACKED>(L);
  const cudaError_t err = opt_in(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<(a.B + L - 1) / L, ST_THREADS, smem, (cudaStream_t)stream>>>(
      (const int8_t*)a.w, (const int32_t*)a.bias, a.phase, a.prev, (const int32_t*)a.cols_in,
      a.phase_out, a.prev_out, (int32_t*)a.cols_out, a.B, a.N, a.KP, a.half, a.chunk,
      a.max_cycles);
  return (int)cudaGetLastError();
}

// A cluster of C CTAs of R rows and L lanes that this source instantiates.
bool cluster_shape_ok(int C, int L, int R) {
  return (C == 2 || C == 4 || C == 8) && (L == 8 || L == 16 || L == 32) && R % 16 == 0 &&
         R >= 16 && R <= 16 * CL_MAX_WARPS;
}

// Whether this source runs the plan: its regime (0 cluster, 1 stream), cluster
// size, lanes, rows and shared memory must be the ones it instantiates and
// computes for this N.
bool plan_ok(int regime, int C, int L, int R, int smem, int N, int KP) {
  if (regime == 0)
    return cluster_shape_ok(C, L, R) && (long long)C * R >= N && smem == cluster_smem(R, L, KP);
  if (regime == 1)
    return C == 1 && (L == 1 || L == 2 || L == 4 || L == 8) && smem == stream_smem(L, N, KP);
  return false;
}

template <bool PACKED>
int cluster_occupancy(int C, int L, int R, int smem, int* clusters) {
  const auto kernel = cluster_kernel<PACKED>(L);
  const cudaError_t err = opt_in(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const ClusterConfig c(C, C, R, smem, nullptr);
  return (int)cudaOccupancyMaxActiveClusters(clusters, kernel, &c.cfg);
}

// The instantiation that launch runs, as compiled (kernel_attributes; a
// cluster launch also needs its peers resident: cluster_occupancy).
template <bool PACKED>
int attributes(int regime, int L, int R, int smem, int* out) {
  if (regime == 0) {
    const auto kernel = cluster_kernel<PACKED>(L);
    const cudaError_t err = opt_in(kernel, smem);
    if (err != cudaSuccess) return (int)err;
    return kernel_attributes(kernel, cluster_threads(R), smem, out);
  }
  const auto kernel = stream_kernel<PACKED>(L);
  const cudaError_t err = opt_in(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  return kernel_attributes(kernel, ST_THREADS, smem, out);
}

}  // namespace

extern "C" {

// `chunk` cycles + bookkeeping.  w (N, KP) int8 with KP a multiple of 16 and
// zero columns past N; bias (N,) int32; phase/prev (B, N) int32, or
// (B, ceil(N/2)) uint8 when packed != 0; cols_in/cols_out (7, B) int32 in the
// order t, settle_cycle, settled, cycled, frozen, frozen_p2, freeze_cycle.
// The plan (autotune.MultiPlan.args): regime (0 cluster, 1 stream), cluster
// size, lanes per cluster (stream: per block), rows per CTA, dynamic shared
// memory bytes.
int onn_phase_step_multi(const void* w, const void* bias, const void* phase,
                         const void* prev, const void* cols_in, void* phase_out,
                         void* prev_out, void* cols_out, int B, int N, int KP, int half,
                         int chunk, int max_cycles, int packed, int regime, int cluster,
                         int lanes, int rows, int smem, void* stream) {
  if (KP % 16 != 0 || KP < N || !plan_ok(regime, cluster, lanes, rows, smem, N, KP))
    return (int)cudaErrorInvalidValue;
  if (B <= 0 || N <= 0) return (int)cudaGetLastError();
  const Args a{w, bias, phase, prev, cols_in, phase_out, prev_out, cols_out,
               B, N, KP, half, chunk, max_cycles};
  return packed ? launch<true>(a, regime, cluster, lanes, rows, smem, stream)
                : launch<false>(a, regime, cluster, lanes, rows, smem, stream);
}

// How many clusters of the cluster regime's plan (cluster, lanes, rows, smem)
// the device holds at once (cudaOccupancyMaxActiveClusters); 0 means it
// cannot launch.
int onn_phase_step_multi_occupancy(int packed, int cluster, int lanes, int rows, int smem,
                                   void* clusters) {
  if (!cluster_shape_ok(cluster, lanes, rows)) return (int)cudaErrorInvalidValue;
  int* out = static_cast<int*>(clusters);
  return packed ? cluster_occupancy<true>(cluster, lanes, rows, smem, out)
                : cluster_occupancy<false>(cluster, lanes, rows, smem, out);
}

// The instantiation that a launch of the plan (as onn_phase_step_multi takes
// it, for N oscillators in rows of KP bytes) runs, as compiled: out[6], as
// kernel_attributes (attributes.cuh) fills it.
// Refuses a plan that this source does not run; launches nothing.
int onn_phase_step_multi_attributes(int N, int KP, int packed, int regime, int cluster,
                                    int lanes, int rows, int smem, void* out) {
  if (N <= 0 || KP % 16 != 0 || KP < N || !plan_ok(regime, cluster, lanes, rows, smem, N, KP))
    return (int)cudaErrorInvalidValue;
  int* o = static_cast<int*>(out);
  return packed ? attributes<true>(regime, lanes, rows, smem, o)
                : attributes<false>(regime, lanes, rows, smem, o);
}

}  // extern "C"
