// Int8 coupling GEMM for Hopper (sm_90a) at the shapes where the work is
// large: wgmma on TMA-fed shared-memory tiles, a persistent warp-specialized
// block per SM, split-K for the sum where the output has few tiles.
//
// Replaces two TPU kernels of src/repro/kernels/coupling_kernel.py at those
// shapes (csrc/coupling_gemm.cu keeps every other shape):
//   * coupling_sum_pallas / _coupling_sum_kernel  -> onn_coupling_wgmma, SUM
//   * onn_step_pallas / _onn_step_kernel          -> onn_coupling_wgmma, STEP
// autotune.coupling_route picks this regime for one W (I = 1), kernels 1-4's
// walk (no MAC width), modes SUM and STEP, when B * M * K reaches
// autotune.WGMMA_MIN_WORK and the wide tile of coupling_gemm.cu would fill
// the card; autotune.wgmma_plan gives the launch.
//
// Computes S[b, i] = sum_k sigma[b, k] * W[i, k] with exact int32
// accumulation (integer sums: every output is bit-equal to the plain version
// in any order, split-K included), then
//   SUM:  out = S                                  (int32; W may be a row slab)
//   STEP: out = +1 if S + h > 0, -1 if S + h < 0, sigma[b, i] if S + h == 0
//         (int8, W square).
//
// What bounds it on this card: the ONN dry run's onn_131072 shares, (1024,
// 8192) . (8192, 8192) and (1024, 131072) . (512, 131072), are 137 G int8
// operations on 75-200 MB of operands: the tensor cores' rate (0.069 ms at
// 1,979 TOP/s).  Past the grid's edge, (4,194,341, 506) . (506, 506), the
// call is its bytes (8.5 GB of int32 sums out, 2.1 GB of spins in).
// The design:
//   * Tile: 128 lanes (rows of sigma) x 256 output rows (rows of W) a block,
//     two consumer warpgroups of 64 lanes each issuing
//     wgmma.m64n256k32.s32.s8.s8 with both operands in shared memory (sigma
//     and W are row-major, so both are K-major, the only layout 8-bit wgmma
//     takes); 128 int32 accumulators a thread.
//   * Copies: one producer thread issues TMA loads (cp.async.bulk.tensor.2d)
//     of 128-byte K-steps, one 128-byte swizzle row per tile row, into a
//     ring of STAGES stages guarded by full and empty mbarriers.  K tails,
//     lanes past B and rows past M come in zero-filled by TMA's
//     out-of-bounds fill: zero spins against zero weights add nothing.
//     TMA needs 16-byte aligned bases and row pitches; the wrapper copies an
//     operand that is not (N = 506: rows zero-padded to 512).
//   * Walk: a persistent grid (the plan's, at most one block per SM), each
//     block taking work units blockIdx.x, + gridDim.x, ...; a unit is one
//     output tile and one K slice.  Consecutive units share an operand
//     panel: the lane tiles of one W panel where W is the larger operand
//     (each W panel read from HBM once), else the row tiles of one sigma
//     panel.  The producer runs ahead into the next unit while the
//     consumers store, so one tile's epilogue overlaps the next one's loads.
//   * Split-K (SUM only, where the output tiles are at most half the SMs):
//     K is cut into the plan's slices, the tiles of one slice adjacent in
//     the walk so that a slice's panels meet in L2, and each unit adds its
//     partial sums into the zeroed output with int32 atomics (exact in any
//     order).  STEP never splits: its sign needs the whole sum.
//   * Epilogue: each consumer warp passes its accumulators through 2 KB of
//     shared memory, 32 columns a round, and stores two whole rows of the
//     output an instruction (sums as int2, spins as pairs; STEP's bias is
//     read before the shared-memory pass, and the spins its ties keep are
//     read together after it, at most one wait a round); a K slice's
//     partial sums go out as int32 atomics.  Storing straight from the accumulators
//     wrote 8 rows x 32 bytes an instruction, split over two sectors each
//     at N = 506 (rows of 2,024 bytes).
//   * The wrapper's row copy (onn_tma_rows, tma_rows_kernel): rows of N
//     bytes into rows of N rounded up to 16, staged through shared memory
//     8 KB of output a block at a time, 16-byte loads and stores.
//
// Plain C interface for ctypes: the entry returns cudaGetLastError(), or
// cudaErrorInvalidValue for a plan it does not take (a tile or ring other
// than this source's, slices that do not partition K, split-K in STEP, an
// operand TMA cannot read).

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

#include "attributes.cuh"

namespace {

constexpr int BM = 128;              // lanes a tile: two consumer warpgroups of 64
constexpr int BN = 256;              // output rows a tile: the wgmma's N
constexpr int BK = 128;              // K bytes a stage: one swizzle row, four k32 steps
constexpr int STAGES = 4;
constexpr int CONSUMERS = 2;         // consumer warpgroups
constexpr int THREADS = 128 * (CONSUMERS + 1);  // + the producer warpgroup
constexpr int A_BYTES = BM * BK;     // 16 KB of sigma a stage
constexpr int B_BYTES = BN * BK;     // 32 KB of W a stage
constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
constexpr int EPI_COLS = 32;         // output columns an epilogue round
constexpr int SLAB_BYTES = 16 * EPI_COLS * 4;  // a consumer warp's round: 16 rows x 32 int32
// The ring, the consumer warps' epilogue slabs, 1 KB to align the ring to
// the swizzle's 1,024-byte period, and the full and empty barriers:
// 214,080 bytes (autotune.WGMMA_SMEM).
constexpr int SMEM = STAGES * STAGE_BYTES + 4 * CONSUMERS * SLAB_BYTES + 1024 + 2 * STAGES * 8;
constexpr int PRODUCER_REGS = 40, CONSUMER_REGS = 232;

enum Mode { SUM = 0, STEP = 3 };  // the coupling GEMM's mode numbers (ops.GEMM_MODES)

template <int MODE> struct OutOf { using type = int32_t; };
template <> struct OutOf<STEP> { using type = int8_t; };

// The persistent walk: units of one output tile and one K slice.
struct Walk {
  int lane_tiles, row_tiles;  // output tiles: ceil(B / BM) x ceil(M / BN)
  int ksteps, kchunk;         // K-steps in all, K-steps a slice
  int units;                  // tiles x slices
  int lanes_fastest;          // 1: lane tiles vary fastest (one W panel at a time)

  // Unit u's lane tile, row tile, first K-step and K-steps.
  __device__ __forceinline__ void unit(int u, int& lt, int& rt, int& k0, int& nk) const {
    const int tiles = lane_tiles * row_tiles;
    const int s = u / tiles, t = u - s * tiles;
    if (lanes_fastest) {
      rt = t / lane_tiles;
      lt = t - rt * lane_tiles;
    } else {
      lt = t / row_tiles;
      rt = t - lt * row_tiles;
    }
    k0 = s * kchunk;
    nk = min(kchunk, ksteps - k0);
  }
};

// --- PTX -------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// Wait until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

// One box of a 2-d tensor map into shared memory; completion is counted on
// the barrier in bytes.  c0: the K byte, c1: the row.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// The wgmma descriptor of a K-major tile of 128-byte rows in the 128-byte
// swizzle that TMA writes: start address, leading byte offset (unused for a
// swizzled K-major tile), stride byte offset 1,024 (eight rows), swizzle
// mode 1.  One k32 step further along K is 32 bytes: +2 in the address field.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) | ((uint64_t)(1024 >> 4) << 32) |
         ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keep the compiler from moving reads of the accumulators above a wait.
__device__ __forceinline__ void fence_acc(int (&d)[128]) {
#pragma unroll
  for (int i = 0; i < 128; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

#define ACC8(i)                                                                        \
  "+r"(d[i + 0]), "+r"(d[i + 1]), "+r"(d[i + 2]), "+r"(d[i + 3]), "+r"(d[i + 4]),      \
      "+r"(d[i + 5]), "+r"(d[i + 6]), "+r"(d[i + 7])

// D (64 x 256 s32) += A (64 x 32 s8, K-major) . B (256 x 32 s8, K-major)^T;
// D = A . B^T where `accumulate` is 0.  Thread l of warp w of the warpgroup
// holds D[16 w + l / 4 + 8 h][8 j + 2 (l % 4) + e] in d[4 j + 2 h + e].
__device__ __forceinline__ void wgmma_s8_n256(int (&d)[128], uint64_t da, uint64_t db,
                                              int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, "
      "%111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, "
      "%125, %126, %127}, %128, %129, p;\n}\n"
      : ACC8(0), ACC8(8), ACC8(16), ACC8(24), ACC8(32), ACC8(40), ACC8(48), ACC8(56),
        ACC8(64), ACC8(72), ACC8(80), ACC8(88), ACC8(96), ACC8(104), ACC8(112), ACC8(120)
      : "l"(da), "l"(db), "r"(accumulate));
}

#undef ACC8

// --- the kernel ------------------------------------------------------------

template <int MODE>
__global__ void __launch_bounds__(THREADS, 1)
coupling_wgmma_kernel(const __grid_constant__ CUtensorMap sig_map,  // sigma (B, K), pitch lds
                      const __grid_constant__ CUtensorMap w_map,    // W (M, K)
                      const int8_t* __restrict__ sigma,  // the same bytes: STEP's kept spins
                      long long lds,
                      const int32_t* __restrict__ bias,  // (M,), STEP
                      typename OutOf<MODE>::type* __restrict__ out,  // (B, M)
                      int B, int M, Walk walk, int atomic) {
  extern __shared__ uint8_t smem_raw[];
  // The ring at the first 1,024-byte boundary (the swizzle's period).
  const uint32_t ring_s = (smem_addr(smem_raw) + 1023) & ~1023u;
  uint8_t* const ring = smem_raw + (ring_s - smem_addr(smem_raw));
  const uint32_t full_s = ring_s + STAGES * STAGE_BYTES + 4 * CONSUMERS * SLAB_BYTES;
  const uint32_t empty_s = full_s + STAGES * 8;  // STAGES barriers each
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full_s + 8 * s, 1);                      // the producer's expect_tx
      mbar_init(empty_s + 8 * s, CONSUMERS * 128);       // every consumer thread
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == CONSUMERS) {
    // === producer: one thread keeps the ring full, unit after unit ===
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    if (threadIdx.x == CONSUMERS * 128) {
      int stage = 0;
      uint32_t phase = 0;
      for (int u = blockIdx.x; u < walk.units; u += gridDim.x) {
        int lt, rt, k0, nk;
        walk.unit(u, lt, rt, k0, nk);
        for (int k = 0; k < nk; ++k) {
          mbar_wait(empty_s + 8 * stage, phase ^ 1);  // the first pass finds it free
          const uint32_t bar = full_s + 8 * stage;
          const uint32_t a = ring_s + stage * STAGE_BYTES;
          mbar_expect_tx(bar, STAGE_BYTES);
          tma_load(a, &sig_map, bar, (k0 + k) * BK, lt * BM);
          tma_load(a + A_BYTES, &w_map, bar, (k0 + k) * BK, rt * BN);
          if (++stage == STAGES) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
  } else {
    // === consumers: warpgroup wg owns lanes 64 wg .. 64 wg + 63 of each tile ===
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
    using OutT = typename OutOf<MODE>::type;
    const int lane = threadIdx.x & 31, warp = (threadIdx.x >> 5) & 3;
    int2* const slab =
        reinterpret_cast<int2*>(ring + STAGES * STAGE_BYTES + (4 * wg + warp) * SLAB_BYTES);
    // Paired stores where M is even and the output pointer allows them.
    const bool pair = (M & 1) == 0 && (reinterpret_cast<uintptr_t>(out) & (2 * sizeof(OutT) - 1)) == 0;
    int acc[128];
#pragma unroll
    for (int i = 0; i < 128; ++i) acc[i] = 0;
    int stage = 0;
    uint32_t phase = 0;
    for (int u = blockIdx.x; u < walk.units; u += gridDim.x) {
      int lt, rt, k0, nk;
      walk.unit(u, lt, rt, k0, nk);
      int prev = -1;
      for (int k = 0; k < nk; ++k) {
        mbar_wait(full_s + 8 * stage, phase);
        const uint32_t a = ring_s + stage * STAGE_BYTES;
        const uint64_t da = sw128_desc(a + wg * 64 * BK), db = sw128_desc(a + A_BYTES);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BK / 32; ++kk)
          wgmma_s8_n256(acc, da + 2 * kk, db + 2 * kk, (k | kk) != 0);
        wgmma_commit();
        wgmma_wait<1>();  // the previous stage's products are done: release it
        if (prev >= 0) mbar_arrive(empty_s + 8 * prev);
        prev = stage;
        if (++stage == STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
      wgmma_wait<0>();
      fence_acc(acc);
      if (prev >= 0) mbar_arrive(empty_s + 8 * prev);

      // Epilogue, 32 columns a round: the warp's 16 x 32 accumulators
      // through its 2 KB of shared memory (int2 slots XOR-swizzled by row,
      // so that both passes are free of bank conflicts), then two rows of
      // the output an instruction, 16 lanes a row: whole 128-byte lines of
      // sums, 32 bytes of spins.
      const int b0 = lt * BM + 64 * wg + 16 * warp;  // the warp's first lane
#pragma unroll
      for (int q = 0; q < BN / EPI_COLS; ++q) {
        const int i = rt * BN + q * EPI_COLS + 2 * (lane & 15);
        const bool live = i < M, two = i + 1 < M;
        int h0 = 0, h1 = 0;
        if constexpr (MODE == STEP) {  // issued before the shared-memory pass
          h0 = live ? bias[i] : 0;
          h1 = two ? bias[i + 1] : 0;
        }
        __syncwarp();
#pragma unroll
        for (int jj = 0; jj < EPI_COLS / 8; ++jj) {
          const int j = q * (EPI_COLS / 8) + jj;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int r = (lane >> 2) + 8 * h;
            slab[16 * r + ((4 * jj + (lane & 3)) ^ (4 * (r & 3)))] =
                make_int2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
          }
        }
        __syncwarp();
        if (!live) continue;
        if constexpr (MODE == SUM) {
#pragma unroll
          for (int rr = 0; rr < 8; ++rr) {
            const int r = 2 * rr + (lane >> 4), b = b0 + r;
            if (b >= B) break;
            const int2 v = slab[16 * r + ((lane & 15) ^ (4 * (r & 3)))];
            int32_t* const o = out + (size_t)b * M + i;
            if (atomic) {  // a K slice's partial sums
              atomicAdd(o, v.x);
              if (two) atomicAdd(o + 1, v.y);
            } else if (pair && two) {
              *reinterpret_cast<int2*>(o) = v;
            } else {
              o[0] = v.x;
              if (two) o[1] = v.y;
            }
          }
        } else {
          // The round's rows first, then the kept spins of its ties read
          // together (one memory latency a round at most, not one a tie),
          // then the stores.
          int s0[8], s1[8];
          uint32_t ties = 0;
#pragma unroll
          for (int rr = 0; rr < 8; ++rr) {
            const int r = 2 * rr + (lane >> 4);
            const int2 v = slab[16 * r + ((lane & 15) ^ (4 * (r & 3)))];
            const int a0 = v.x + h0, a1 = v.y + h1;
            s0[rr] = a0 > 0 ? 1 : -1;
            s1[rr] = a1 > 0 ? 1 : -1;
            if (b0 + r < B) ties |= ((a0 == 0 ? 1u : 0u) | (two && a1 == 0 ? 2u : 0u)) << (2 * rr);
          }
          if (ties) {
#pragma unroll
            for (int rr = 0; rr < 8; ++rr) {
              const uint32_t t = (ties >> (2 * rr)) & 3u;
              const int8_t* keep = sigma + (size_t)(b0 + 2 * rr + (lane >> 4)) * lds + i;
              if (t & 1u) s0[rr] = keep[0];
              if (t & 2u) s1[rr] = keep[1];
            }
          }
#pragma unroll
          for (int rr = 0; rr < 8; ++rr) {
            const int b = b0 + 2 * rr + (lane >> 4);
            if (b >= B) break;
            int8_t* const o = out + (size_t)b * M + i;
            if (pair && two) {
              *reinterpret_cast<uint16_t*>(o) = (uint16_t)((s0[rr] & 0xFF) | ((s1[rr] & 0xFF) << 8));
            } else {
              o[0] = (int8_t)s0[rr];
              if (two) o[1] = (int8_t)s1[rr];
            }
          }
        }
      }
    }
  }
}

// Rows of `n` bytes at `src` (a pitch of n) into rows of `pitch` bytes at
// `dst` (16-byte aligned, pitch a multiple of 16), for TMA, the bytes past n
// zero.  A block takes COPY_TILE bytes of the output a step: it stages the
// source bytes they hold (at most as many, contiguous) through shared memory
// by aligned 16-byte loads, then writes the output by 16-byte stores, each
// assembled from five aligned words of the stage shifted into place.  The
// 16-byte chunks at the source's two ends are read byte by byte, so that
// nothing outside it is read.
constexpr int COPY_THREADS = 256;
constexpr int COPY_TILE = 8192;

__global__ void __launch_bounds__(COPY_THREADS)
tma_rows_kernel(const uint8_t* __restrict__ src, uint8_t* __restrict__ dst, long long rows,
                int n, int pitch) {
  // the staged source of one step, and room for the last word reads
  __shared__ uint4 stage[COPY_TILE / 16 + 3];
  const long long total = rows * pitch, src_bytes = rows * n;
  const uintptr_t base = reinterpret_cast<uintptr_t>(src);
  // Source bytes before output byte o.
  auto before = [&](long long o) {
    const long long r = o / pitch, c = o - r * pitch;
    return r * n + (c < n ? c : n);
  };
  for (long long o0 = blockIdx.x * (long long)COPY_TILE; o0 < total;
       o0 += (long long)gridDim.x * COPY_TILE) {
    const long long o1 = min(o0 + (long long)COPY_TILE, total);
    const uintptr_t a0 = (base + before(o0)) & ~(uintptr_t)15;
    const int loads = (int)((((base + before(o1)) + 15) & ~(uintptr_t)15) - a0) / 16;
    __syncthreads();  // the previous step's reads of the stage are done
    for (int q = threadIdx.x; q < loads; q += COPY_THREADS) {
      const uint8_t* p = reinterpret_cast<const uint8_t*>(a0) + 16 * q;
      if (p >= src && p + 16 <= src + src_bytes) {
        stage[q] = *reinterpret_cast<const uint4*>(p);
      } else {
        uint32_t w[4] = {0u, 0u, 0u, 0u};
        for (int x = 0; x < 16; ++x)
          if (p + x >= src && p + x < src + src_bytes) w[x >> 2] |= (uint32_t)p[x] << (8 * (x & 3));
        stage[q] = make_uint4(w[0], w[1], w[2], w[3]);
      }
    }
    __syncthreads();
    const uint8_t* st = reinterpret_cast<const uint8_t*>(stage);
    for (long long o = o0 + 16 * threadIdx.x; o < o1; o += 16 * COPY_THREADS) {
      const long long r = o / pitch;
      const int c = (int)(o - r * pitch), live = n - c;  // source bytes of this chunk
      uint32_t v[4] = {0u, 0u, 0u, 0u};
      if (live > 0) {
        const int local = (int)(base + r * n + c - a0);
        const uint32_t* w = reinterpret_cast<const uint32_t*>(st + (local & ~3));
        const uint32_t sh = 8u * (uint32_t)(local & 3);
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          v[k] = __funnelshift_r(w[k], w[k + 1], sh);
          const int left = live - 4 * k;  // bytes of word k inside the row
          if (left < 4) v[k] &= left <= 0 ? 0u : (1u << (8 * left)) - 1u;
        }
      }
      *reinterpret_cast<uint4*>(dst + o) = make_uint4(v[0], v[1], v[2], v[3]);
    }
  }
}

// --- host ------------------------------------------------------------------

// cuTensorMapEncodeTiled from the driver through the runtime, so that the
// library needs no -lcuda.
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static std::atomic<EncodeTiled> fn{nullptr};
  EncodeTiled f = fn.load();
  if (f) return f;
  void* p = nullptr;
  cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
  cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                     cudaEnableDefault, &q);
#else
  cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
  if (err != cudaSuccess || q != cudaDriverEntryPointSuccess) return nullptr;
  f = reinterpret_cast<EncodeTiled>(p);
  fn.store(f);
  return f;
}

// The tensor map of a row-major int8 (rows, cols) operand at `base` with a
// pitch of `ld` bytes, in boxes of BK bytes x box_rows rows, 128-byte
// swizzle, out-of-bounds elements read as zero.
bool make_map(CUtensorMap* map, const void* base, long long rows, long long cols, long long ld,
              int box_rows) {
  const EncodeTiled enc = encoder();
  if (!enc) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)ld};
  const cuuint32_t box[2] = {(cuuint32_t)BK, (cuuint32_t)box_rows};
  const cuuint32_t step[2] = {1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(base), dims, strides, box,
             step, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Above 48 KB a block's dynamic shared memory needs an opt-in, once per
// device (a bit per ordinal, set only when the opt-in succeeded).
template <int MODE>
cudaError_t opt_in() {
  static std::atomic<unsigned long long> opted{0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned long long bit = dev < 64 ? 1ull << dev : 0ull;
  if (!(opted.load() & bit)) {
    err = cudaFuncSetAttribute(coupling_wgmma_kernel<MODE>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
    if (err != cudaSuccess) return err;
    opted.fetch_or(bit);
  }
  return cudaSuccess;
}

bool plan_is(int bm, int bn, int stages) { return bm == BM && bn == BN && stages == STAGES; }

template <int MODE>
int launch(const void* sigma, long long lds, const void* w, long long ldw, const void* bias,
           void* out, int B, int M, int K, int bm, int bn, int stages, int kchunk, int splits,
           int grid, int lanes_fastest, void* stream) {
  if (!plan_is(bm, bn, stages) || B <= 0 || M <= 0 || K <= 0 || grid <= 0 || kchunk <= 0 ||
      splits <= 0 || (MODE == STEP && (splits != 1 || M != K)))
    return (int)cudaErrorInvalidValue;
  const int ksteps = (K + BK - 1) / BK;
  // The slices partition the K-steps: none empty, none missing.
  if ((long long)(splits - 1) * kchunk >= ksteps || (long long)splits * kchunk < ksteps)
    return (int)cudaErrorInvalidValue;
  // TMA reads 16-byte aligned bases and pitches that hold a whole row.
  if (reinterpret_cast<uintptr_t>(sigma) % 16 || reinterpret_cast<uintptr_t>(w) % 16 ||
      lds % 16 || ldw % 16 || lds < K || ldw < K)
    return (int)cudaErrorInvalidValue;
  Walk walk;
  walk.lane_tiles = (B + BM - 1) / BM;
  walk.row_tiles = (M + BN - 1) / BN;
  walk.ksteps = ksteps;
  walk.kchunk = kchunk;
  const long long units = (long long)walk.lane_tiles * walk.row_tiles * splits;
  if (units > 0x7FFFFFFF) return (int)cudaErrorInvalidValue;
  walk.units = (int)units;
  walk.lanes_fastest = lanes_fastest ? 1 : 0;
  CUtensorMap sig_map, w_map;
  if (!make_map(&sig_map, sigma, B, K, lds, BM) || !make_map(&w_map, w, M, K, ldw, BN))
    return (int)cudaErrorInvalidValue;
  const cudaError_t err = opt_in<MODE>();
  if (err != cudaSuccess) return (int)err;
  using OutT = typename OutOf<MODE>::type;
  coupling_wgmma_kernel<MODE><<<grid, THREADS, SMEM, (cudaStream_t)stream>>>(
      sig_map, w_map, (const int8_t*)sigma, lds, (const int32_t*)bias, (OutT*)out, B, M, walk,
      splits > 1 ? 1 : 0);
  return (int)cudaGetLastError();
}

int rows_copy(const void* src, long long rows, int n, void* dst, int pitch, void* stream) {
  if (rows < 0 || n <= 0 || pitch < n || pitch % 16 || reinterpret_cast<uintptr_t>(dst) % 16)
    return (int)cudaErrorInvalidValue;
  if (rows == 0) return (int)cudaGetLastError();
  const long long steps = (rows * pitch + COPY_TILE - 1) / COPY_TILE;
  const int grid = (int)(steps < 132 * 8 ? steps : 132 * 8);  // 8 blocks an SM at most
  tma_rows_kernel<<<grid, COPY_THREADS, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)src, (uint8_t*)dst, rows, n, pitch);
  return (int)cudaGetLastError();
}

template <int MODE>
int attributes(int* out) {
  const cudaError_t err = opt_in<MODE>();
  if (err != cudaSuccess) return (int)err;
  return kernel_attributes(coupling_wgmma_kernel<MODE>, THREADS, SMEM, out);
}

}  // namespace

extern "C" {

// One launch of autotune.wgmma_plan: mode 0 (SUM: out (B, M) int32, zeroed
// by the caller when splits > 1) or 3 (STEP: W square, bias (M,) int32, out
// (B, M) int8); sigma (B, K) with a pitch of lds bytes, w (M, K) with a
// pitch of ldw; then the plan's tile (bm x bn), stages, K-steps a slice,
// slices, grid and walk order.
int onn_coupling_wgmma(int mode, const void* sigma, long long lds, const void* w, long long ldw,
                       const void* bias, void* out, int B, int M, int K, int bm, int bn,
                       int stages, int kchunk, int splits, int grid, int lanes_fastest,
                       void* stream) {
  if (mode == SUM)
    return launch<SUM>(sigma, lds, w, ldw, bias, out, B, M, K, bm, bn, stages, kchunk, splits,
                       grid, lanes_fastest, stream);
  if (mode == STEP)
    return launch<STEP>(sigma, lds, w, ldw, bias, out, B, M, K, bm, bn, stages, kchunk, splits,
                        grid, lanes_fastest, stream);
  return (int)cudaErrorInvalidValue;
}

// src (rows, n) int8, contiguous, into dst (rows, pitch): rows of pitch
// bytes (16-byte aligned, pitch a multiple of 16) as TMA reads them, the
// bytes past n zero.  The wgmma regime's copy of an operand TMA cannot read.
int onn_tma_rows(const void* src, long long rows, int n, void* dst, int pitch, void* stream) {
  return rows_copy(src, rows, n, dst, pitch, stream);
}

// The instantiation that a launch of `mode` on the plan (bm, bn, stages)
// runs, as compiled: out[6], as kernel_attributes (attributes.cuh) fills it.
// Launches nothing.
int onn_coupling_wgmma_attributes(int mode, int bm, int bn, int stages, void* out) {
  if (!plan_is(bm, bn, stages)) return (int)cudaErrorInvalidValue;
  int* o = static_cast<int*>(out);
  if (mode == SUM) return attributes<SUM>(o);
  if (mode == STEP) return attributes<STEP>(o);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
