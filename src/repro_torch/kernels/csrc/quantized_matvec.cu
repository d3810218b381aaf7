// Quantized matrix product for Hopper (sm_90a): y = (x W_q^T) * scale per row.
//
// Replaces the TPU kernel quantized_matvec_pallas / _quantized_matvec_kernel
// of src/repro/kernels/coupling_kernel.py: x (B, K) float32, W_q (M, K) int8,
// scale (M,) float32 -> y (B, M) float32.  The TPU kernel widens each W_q
// block to float32 in VMEM, accumulates x W_q^T over a sequential K grid axis
// in a float32 scratch block, and multiplies by the per-row scale in the last
// K step.  Hopper's blocks run in parallel and in no order, so the K axis is
// cut into chunks that blocks own (split-K) and reduced as described below.
//
// Arithmetic: plain float32 FMA on the CUDA cores, no TF32 and no tensor
// cores, so each element's error against exact arithmetic is that of at most
// K float32 roundings, |err| <= K * 2^-24 * |scale_m| * sum_k |x_bk * w_mk|,
// whatever the order (the plain version's matmul sums in another order).
// Widening int8 to float32 is exact (widen4: a byte placed in the mantissa of
// 2^23, then one exact subtraction).
//
// Determinism: one launch per call and bit-identical results from call to
// call.  No float atomics.  With S > 1 K chunks, every block writes its
// partial sums to a workspace (S, B, M), then __threadfence and one atomic
// increment of its output tile's counter; the block that arrives last sums
// the S partials in chunk order 0..S-1, multiplies by the scale, stores y
// and resets the counter to 0.  Within a block every sum runs in a fixed
// order (increasing k per thread, then a fixed shuffle tree).
//
// Two regimes, chosen by kernels/autotune.py (qmv_plan), which also picks the
// K chunk and whether the 16-byte vector path may run:
//
//   * GEMV, B <= 16 (qmv_gemv_kernel<NB>, NB the batch rounded up to a power
//     of two): bound by bytes.  At (8, 4096, 4096) W_q alone is 16.8 MB,
//     5.0 us at 3.35 TB/s; the operations take 4.0 us at 67 TFLOP/s.  A block
//     of 256 threads owns 128 output rows and one K chunk: eight threads per
//     row group each load 16 bytes of W per step (eight threads read 128
//     contiguous bytes of a row, a warp four rows), four rows per thread, with
//     the next step's 64 bytes in flight in registers while the current one is
//     consumed (16 KB per block, two blocks per SM).  x's chunk (NB lanes x
//     K chunk) sits in shared memory with a 16-float group padded to 20, so
//     the eight threads' float4 reads fall on disjoint banks; each float4 of
//     x serves 4 rows x 4 k.  The eight partial sums of a row are joined by a
//     shuffle tree at the end of the chunk.  The K chunk is cut so that the
//     grid is one wave at two blocks per SM, at most 264 blocks (256 at
//     (8, 4096, 4096)); x's chunk is read once per 128 rows.
//   * GEMM, B > 16 (qmv_gemm_kernel): bound by operations.  At
//     (1024, 506, 506), 0.26 G FMA take 7.8 us at 67 TFLOP/s; the bytes take
//     1.3 us.  A block of 256 threads owns 128 lanes x 128 rows; each thread
//     owns 8 x 8 outputs (lanes ty + 16 i, rows tx + 16 j) and per 4 k reads
//     8 float4 of x and 8 words of W from shared memory for 256 FMAs.  The
//     K slabs (32 wide) are double-buffered: x arrives by cp.async, W through
//     registers into shared memory as int8, widened on the way from shared
//     memory to registers.  Split-K only when the tile grid fills fewer than
//     132 SMs (at (1024, 506, 506): 32 tiles x 4 chunks of 128).
//
// Alignment: at K = 506 a W_q row is only 2-byte aligned and an x row 8-byte
// aligned.  The vector path (16-byte loads of W and x, 16-byte cp.async) runs
// only when K % 16 == 0 and both base pointers are 16-byte aligned; else the
// same kernels load W byte by byte and x by 4-byte cp.async (GEMM) or scalar
// loads (GEMV), masked at every edge.  Out-of-range elements are zeros on
// both sides (0 * 0 adds nothing).
//
// Plain C interface for ctypes: the entry returns cudaGetLastError() or
// cudaErrorInvalidValue for a plan it does not accept.

#include <cuda_runtime.h>
#include <stdint.h>

#include "attributes.cuh"

namespace {

constexpr int THREADS = 256;
constexpr unsigned FULL = 0xffffffffu;

// GEMV: 32 row slots x 4 rows per thread, 8 threads per slot, 16 bytes each.
constexpr int GV_T = 8;
constexpr int GV_RPT = 4;
constexpr int GV_ROWS = (THREADS / GV_T) * GV_RPT;  // 128
constexpr int GV_KSTEP = GV_T * 16;                 // 128
constexpr int GV_SMEM_LIMIT = 48 * 1024;

// GEMM: 128 x 128 output tile, 8 x 8 per thread, 32-wide K slabs.
constexpr int GM_TILE = 128;
constexpr int GM_BK = 32;
constexpr int GM_XP = GM_BK + 4;  // floats per lane row of the x slab (144 B)
constexpr int GM_WP = GM_BK + 4;  // bytes per row of the W slab (9 words: odd)

// Four signed bytes of a word to float32, exactly: with the sign bit of each
// byte flipped, byte + 2^23 is a float32 whose mantissa holds the byte.
__device__ __forceinline__ void widen4(int word, float f[4]) {
  const unsigned u = (unsigned)word ^ 0x80808080u;
  f[0] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540)) - 8388736.0f;
  f[1] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7541)) - 8388736.0f;
  f[2] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7542)) - 8388736.0f;
  f[3] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7543)) - 8388736.0f;
}

__device__ __forceinline__ float comp(const float4& v, int q) {
  return q == 0 ? v.x : q == 1 ? v.y : q == 2 ? v.z : v.w;
}

__device__ __forceinline__ int comp(const int4& v, int q) {
  return q == 0 ? v.x : q == 1 ? v.y : q == 2 ? v.z : v.w;
}

// 16 bytes of row `row` of W from column k, zero past M or kend.  VEC: one
// aligned 16-byte load (K % 16 == 0, so the 16 bytes are all in or all out).
template <bool VEC>
__device__ __forceinline__ int4 load_w16(const int8_t* __restrict__ w, int row, int M, int K,
                                         int k, int kend) {
  int4 v = make_int4(0, 0, 0, 0);
  if (row >= M || k >= kend) return v;
  const int8_t* p = w + (size_t)row * K + k;
  if (VEC) return __ldg(reinterpret_cast<const int4*>(p));
  int words[4] = {0, 0, 0, 0};
#pragma unroll
  for (int j = 0; j < 16; ++j)
    if (k + j < kend) words[j / 4] |= ((int)(uint8_t)__ldg(p + j)) << (8 * (j % 4));
  return make_int4(words[0], words[1], words[2], words[3]);
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem, bool pred) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(gmem),
               "r"(pred ? 4 : 0));
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool pred) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
               "r"(pred ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::);
}

// Split-K arrival: after this block's partials are stored, count it in its
// tile's counter; true (block-uniform) for the block that arrives last.
__device__ __forceinline__ bool last_to_arrive(int* counter, int splits) {
  __shared__ int s_last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) s_last = atomicAdd(counter, 1) == splits - 1;
  __syncthreads();
  if (s_last) __threadfence();
  return s_last;
}

// The last GEMV block of a split row tile: y = (sum of the S partials, in
// chunk order) * scale over rows [i0, i0 + GV_ROWS) of the (B, M) output.
// Consecutive threads take consecutive rows; each thread keeps RED_OUT
// outputs x RED_SPLITS chunks of loads in flight, so that their L2
// latencies overlap.  Resets the tile's counter for the next call.
constexpr int RED_OUT = 4;
constexpr int RED_SPLITS = 4;

__device__ void gemv_reduce_tile(const float* __restrict__ partial,
                                 const float* __restrict__ scale, float* __restrict__ out,
                                 int* counter, int splits, int B, int M, int i0) {
  const size_t stride = (size_t)B * M;
  for (int o0 = 0; o0 < B * GV_ROWS; o0 += THREADS * RED_OUT) {
    float sum[RED_OUT];
    size_t at[RED_OUT];
    bool live[RED_OUT];
#pragma unroll
    for (int n = 0; n < RED_OUT; ++n) {
      const int o = o0 + threadIdx.x + THREADS * n;
      const int b = o / GV_ROWS, row = i0 + o % GV_ROWS;
      live[n] = b < B && row < M;
      at[n] = live[n] ? (size_t)b * M + row : 0;
      sum[n] = 0.0f;
    }
    for (int sp = 0; sp < splits; sp += RED_SPLITS) {
      float v[RED_SPLITS][RED_OUT];
#pragma unroll
      for (int u = 0; u < RED_SPLITS; ++u)
#pragma unroll
        for (int n = 0; n < RED_OUT; ++n)
          v[u][n] = live[n] && sp + u < splits ? __ldcg(partial + (sp + u) * stride + at[n]) : 0.0f;
#pragma unroll
      for (int u = 0; u < RED_SPLITS; ++u)
#pragma unroll
        for (int n = 0; n < RED_OUT; ++n)
          if (sp + u < splits) sum[n] += v[u][n];
    }
#pragma unroll
    for (int n = 0; n < RED_OUT; ++n)
      if (live[n]) out[at[n]] = sum[n] * scale[at[n] % M];
  }
  if (threadIdx.x == 0) *counter = 0;
}

// ---------------------------------------------------------------------------
// GEMV regime
// ---------------------------------------------------------------------------

__device__ __forceinline__ int gv_xpos(int k) { return (k >> 4) * 20 + (k & 15); }

template <int NB, bool VEC>
__global__ void __launch_bounds__(THREADS, 2)
qmv_gemv_kernel(const float* __restrict__ x, const int8_t* __restrict__ w,
                const float* __restrict__ scale, float* __restrict__ out,
                float* __restrict__ partial, int* __restrict__ counters, int B, int M, int K,
                int kc) {
  extern __shared__ float4 gv_smem[];
  float* s_x = reinterpret_cast<float*>(gv_smem);  // NB lanes x (kc / 16 * 20)
  const int pitch = kc / 16 * 20;
  const int split = blockIdx.y, k0 = split * kc;
  const int kend = min(K, k0 + kc);  // global end of this chunk
  const int t = threadIdx.x % GV_T, slot = threadIdx.x / GV_T;
  const int row0 = blockIdx.x * GV_ROWS + slot;

  // The first step's W loads go out before x is staged.
  int4 cur[GV_RPT];
#pragma unroll
  for (int r = 0; r < GV_RPT; ++r)
    cur[r] = load_w16<VEC>(w, row0 + 32 * r, M, K, k0 + 16 * t, kend);

  for (int e = threadIdx.x; e < NB * (kc / 4); e += THREADS) {
    const int b = e / (kc / 4), k = (e % (kc / 4)) * 4;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (b < B) {
      const float* p = x + (size_t)b * K + k0 + k;
      if (VEC) {
        if (k0 + k < kend) v = __ldg(reinterpret_cast<const float4*>(p));
      } else {
        if (k0 + k + 0 < kend) v.x = __ldg(p + 0);
        if (k0 + k + 1 < kend) v.y = __ldg(p + 1);
        if (k0 + k + 2 < kend) v.z = __ldg(p + 2);
        if (k0 + k + 3 < kend) v.w = __ldg(p + 3);
      }
    }
    *reinterpret_cast<float4*>(s_x + b * pitch + gv_xpos(k)) = v;
  }
  __syncthreads();

  float acc[GV_RPT][NB];
#pragma unroll
  for (int r = 0; r < GV_RPT; ++r)
#pragma unroll
    for (int b = 0; b < NB; ++b) acc[r][b] = 0.0f;

  for (int kb = 16 * t; k0 + kb < kend; kb += GV_KSTEP) {
    int4 nxt[GV_RPT];
#pragma unroll
    for (int r = 0; r < GV_RPT; ++r)
      nxt[r] = load_w16<VEC>(w, row0 + 32 * r, M, K, k0 + kb + GV_KSTEP, kend);
    const float* xs = s_x + gv_xpos(kb);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      float wf[GV_RPT][4];
#pragma unroll
      for (int r = 0; r < GV_RPT; ++r) widen4(comp(cur[r], q), wf[r]);
#pragma unroll
      for (int b = 0; b < NB; ++b) {
        const float4 xv = *reinterpret_cast<const float4*>(xs + b * pitch + 4 * q);
#pragma unroll
        for (int r = 0; r < GV_RPT; ++r) {
          float a = acc[r][b];
          a = fmaf(xv.x, wf[r][0], a);
          a = fmaf(xv.y, wf[r][1], a);
          a = fmaf(xv.z, wf[r][2], a);
          a = fmaf(xv.w, wf[r][3], a);
          acc[r][b] = a;
        }
      }
    }
#pragma unroll
    for (int r = 0; r < GV_RPT; ++r) cur[r] = nxt[r];
  }

  // Join the eight threads of a row group (fixed tree: every lane ends with
  // the same sum, lane t == 0 stores it).
#pragma unroll
  for (int r = 0; r < GV_RPT; ++r)
#pragma unroll
    for (int b = 0; b < NB; ++b) {
      float v = acc[r][b];
      v += __shfl_xor_sync(FULL, v, 4);
      v += __shfl_xor_sync(FULL, v, 2);
      v += __shfl_xor_sync(FULL, v, 1);
      acc[r][b] = v;
    }

  const int splits = gridDim.y;
  if (t == 0) {
#pragma unroll
    for (int r = 0; r < GV_RPT; ++r) {
      const int row = row0 + 32 * r;
      if (row >= M) continue;
      const float s = splits == 1 ? scale[row] : 0.0f;
#pragma unroll
      for (int b = 0; b < NB; ++b) {
        if (b >= B) break;
        if (splits == 1)
          out[(size_t)b * M + row] = acc[r][b] * s;
        else
          partial[((size_t)split * B + b) * M + row] = acc[r][b];
      }
    }
  }
  if (splits == 1 || !last_to_arrive(counters + blockIdx.x, splits)) return;
  gemv_reduce_tile(partial, scale, out, counters + blockIdx.x, splits, B, M,
                   blockIdx.x * GV_ROWS);
}

// ---------------------------------------------------------------------------
// GEMM regime
// ---------------------------------------------------------------------------

template <bool VEC>
__global__ void __launch_bounds__(THREADS)
qmv_gemm_kernel(const float* __restrict__ x, const int8_t* __restrict__ w,
                const float* __restrict__ scale, float* __restrict__ out,
                float* __restrict__ partial, int* __restrict__ counters, int B, int M, int K,
                int kc) {
  __shared__ __align__(16) float s_x[2][GM_TILE][GM_XP];
  __shared__ __align__(16) int8_t s_w[2][GM_TILE][GM_WP];
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int i0 = blockIdx.x * GM_TILE, b0 = blockIdx.z * GM_TILE, split = blockIdx.y;
  const int kbeg = split * kc, kend = min(K, kbeg + kc);
  const int slabs = kend > kbeg ? (kend - kbeg + GM_BK - 1) / GM_BK : 0;
  // This thread's 16 bytes of each W slab: row tid / 2, bytes 16 * (tid % 2).
  const int w_row = tid / 2, w_col = 16 * (tid % 2);

  auto issue_x = [&](int slab, int stage) {
    const int kk = kbeg + slab * GM_BK;
    if (VEC) {
      for (int e = tid; e < GM_TILE * GM_BK / 4; e += THREADS) {
        const int lane = e / (GM_BK / 4), c = (e % (GM_BK / 4)) * 4;
        const bool in = b0 + lane < B && kk + c < kend;
        const float* src = in ? x + (size_t)(b0 + lane) * K + kk + c : x;
        cp_async16(&s_x[stage][lane][c], src, in);
      }
    } else {
      for (int e = tid; e < GM_TILE * GM_BK; e += THREADS) {
        const int lane = e / GM_BK, c = e % GM_BK;
        const bool in = b0 + lane < B && kk + c < kend;
        const float* src = in ? x + (size_t)(b0 + lane) * K + kk + c : x;
        cp_async4(&s_x[stage][lane][c], src, in);
      }
    }
    cp_async_commit();
  };
  auto load_w = [&](int slab) {
    return load_w16<VEC>(w, i0 + w_row, M, K, kbeg + slab * GM_BK + w_col, kend);
  };
  auto store_w = [&](int stage, const int4& v) {
    int* dst = reinterpret_cast<int*>(&s_w[stage][w_row][w_col]);
    dst[0] = v.x;
    dst[1] = v.y;
    dst[2] = v.z;
    dst[3] = v.w;
  };

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;

  if (slabs > 0) {
    issue_x(0, 0);
    store_w(0, load_w(0));
    cp_async_wait_all();
    __syncthreads();
  }
  for (int s = 0; s < slabs; ++s) {
    const int cur = s & 1;
    const bool more = s + 1 < slabs;
    int4 wn = make_int4(0, 0, 0, 0);
    if (more) {
      issue_x(s + 1, cur ^ 1);
      wn = load_w(s + 1);
    }
#pragma unroll
    for (int kq = 0; kq < GM_BK; kq += 4) {
      float4 a[8];
      int wq[8];
#pragma unroll
      for (int i = 0; i < 8; ++i)
        a[i] = *reinterpret_cast<const float4*>(&s_x[cur][ty + 16 * i][kq]);
#pragma unroll
      for (int j = 0; j < 8; ++j)
        wq[j] = *reinterpret_cast<const int*>(&s_w[cur][tx + 16 * j][kq]);
      float wf[8][4];
#pragma unroll
      for (int j = 0; j < 8; ++j) widen4(wq[j], wf[j]);
#pragma unroll
      for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float av = comp(a[i], q);
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av, wf[j][q], acc[i][j]);
        }
    }
    if (more) {
      store_w(cur ^ 1, wn);
      cp_async_wait_all();
    }
    __syncthreads();
  }

  const int splits = gridDim.y;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int b = b0 + ty + 16 * i;
    if (b >= B) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int row = i0 + tx + 16 * j;
      if (row >= M) continue;
      if (splits == 1)
        out[(size_t)b * M + row] = acc[i][j] * scale[row];
      else
        partial[((size_t)split * B + b) * M + row] = acc[i][j];
    }
  }
  if (splits == 1) return;
  int* counter = counters + blockIdx.z * gridDim.x + blockIdx.x;
  if (!last_to_arrive(counter, splits)) return;
  // Sum the stored partials in chunk order (not this block's registers, so
  // the result does not depend on which block arrived last); the chunk loop
  // is outermost so that a chunk's 64 loads are in flight together.
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;
  for (int sp = 0; sp < splits; ++sp) {
    const float* part = partial + (size_t)sp * B * M;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int b = min(b0 + ty + 16 * i, B - 1);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int row = min(i0 + tx + 16 * j, M - 1);
        acc[i][j] += __ldcg(part + (size_t)b * M + row);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int b = b0 + ty + 16 * i;
    if (b >= B) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int row = i0 + tx + 16 * j;
      if (row < M) out[(size_t)b * M + row] = acc[i][j] * scale[row];
    }
  }
  if (tid == 0) *counter = 0;
}

// The GEMV's dynamic shared memory: NB lanes of a K chunk of kc, 16 bytes
// padded to 20; -1 where it and the static flag pass the 48 KB that need no
// opt-in.
template <int NB>
int gemv_smem(int kc) {
  const long long smem = (long long)NB * (kc / 16 * 20) * (long long)sizeof(float);
  return smem > GV_SMEM_LIMIT - 16 ? -1 : (int)smem;
}

template <int NB>
cudaError_t launch_gemv(const float* x, const int8_t* w, const float* scale, float* out,
                        float* partial, int* counters, int B, int M, int K, int kc, int splits,
                        bool vec, cudaStream_t stream) {
  const int smem = gemv_smem<NB>(kc);
  if (smem < 0) return cudaErrorInvalidValue;
  dim3 grid((M + GV_ROWS - 1) / GV_ROWS, splits);
  if (vec)
    qmv_gemv_kernel<NB, true><<<grid, THREADS, smem, stream>>>(x, w, scale, out, partial,
                                                               counters, B, M, K, kc);
  else
    qmv_gemv_kernel<NB, false><<<grid, THREADS, smem, stream>>>(x, w, scale, out, partial,
                                                                counters, B, M, K, kc);
  return cudaSuccess;
}

// The GEMV instantiation that launch_gemv runs, as compiled (kernel_attributes).
template <int NB>
int gemv_attributes(int kc, bool vec, int* out) {
  const int smem = gemv_smem<NB>(kc);
  if (smem < 0) return (int)cudaErrorInvalidValue;
  return vec ? kernel_attributes(qmv_gemv_kernel<NB, true>, THREADS, smem, out)
             : kernel_attributes(qmv_gemv_kernel<NB, false>, THREADS, smem, out);
}

}  // namespace

extern "C" {

// y = (x W_q^T) * scale: x (B, K) float32, w (M, K) int8, scale (M,) float32 ->
// out (B, M) float32, as planned by kernels/autotune.py (qmv_plan):
//   gemv_lanes  0 for the GEMM regime, else the GEMV lanes NB (1, 2, 4, 8, 16; B <= NB);
//   k_chunk     contraction elements per block (GEMV: a multiple of 128; GEMM: of 32);
//   splits      ceil(K / k_chunk), at least 1;
//   vector      1 for 16-byte loads (K % 16 == 0 and x, w 16-byte aligned);
//   partial     (splits, B, M) float32 and counters one int32 per output tile,
//               zero before the first call (each call leaves them zero);
//               both unused (may be null) when splits == 1.
int onn_quantized_matvec(const void* x, const void* w, const void* scale, void* out,
                         void* partial, void* counters, int B, int M, int K, int gemv_lanes,
                         int k_chunk, int splits, int vector, void* stream) {
  if (B < 0 || M < 0 || K < 0 || k_chunk <= 0) return (int)cudaErrorInvalidValue;
  if (splits != (K > 0 ? (K + k_chunk - 1) / k_chunk : 1)) return (int)cudaErrorInvalidValue;
  if (splits > 1 && (partial == nullptr || counters == nullptr)) return (int)cudaErrorInvalidValue;
  if (vector && (K % 16 != 0 || (uintptr_t)x % 16 != 0 || (uintptr_t)w % 16 != 0))
    return (int)cudaErrorInvalidValue;
  if (B == 0 || M == 0) return (int)cudaGetLastError();
  auto xs = (const float*)x;
  auto ws = (const int8_t*)w;
  auto sc = (const float*)scale;
  auto o = (float*)out;
  auto p = (float*)partial;
  auto c = (int*)counters;
  auto s = (cudaStream_t)stream;
  const bool vec = vector != 0;
  cudaError_t rc = cudaSuccess;
  if (gemv_lanes == 0) {
    if (k_chunk % GM_BK != 0 || (B + GM_TILE - 1) / GM_TILE > 65535) return (int)cudaErrorInvalidValue;
    dim3 grid((M + GM_TILE - 1) / GM_TILE, splits, (B + GM_TILE - 1) / GM_TILE);
    if (vec)
      qmv_gemm_kernel<true><<<grid, THREADS, 0, s>>>(xs, ws, sc, o, p, c, B, M, K, k_chunk);
    else
      qmv_gemm_kernel<false><<<grid, THREADS, 0, s>>>(xs, ws, sc, o, p, c, B, M, K, k_chunk);
  } else {
    if (k_chunk % GV_KSTEP != 0 || B > gemv_lanes) return (int)cudaErrorInvalidValue;
    switch (gemv_lanes) {
      case 1: rc = launch_gemv<1>(xs, ws, sc, o, p, c, B, M, K, k_chunk, splits, vec, s); break;
      case 2: rc = launch_gemv<2>(xs, ws, sc, o, p, c, B, M, K, k_chunk, splits, vec, s); break;
      case 4: rc = launch_gemv<4>(xs, ws, sc, o, p, c, B, M, K, k_chunk, splits, vec, s); break;
      case 8: rc = launch_gemv<8>(xs, ws, sc, o, p, c, B, M, K, k_chunk, splits, vec, s); break;
      case 16: rc = launch_gemv<16>(xs, ws, sc, o, p, c, B, M, K, k_chunk, splits, vec, s); break;
      default: return (int)cudaErrorInvalidValue;
    }
  }
  if (rc != cudaSuccess) return (int)rc;
  return (int)cudaGetLastError();
}

// The instantiation that a launch of the plan (gemv_lanes, k_chunk, vector as
// onn_quantized_matvec takes them) runs, as compiled: out[6], as
// kernel_attributes (attributes.cuh) fills it.  Refuses a plan that the
// launch refuses; launches nothing.
int onn_quantized_matvec_attributes(int gemv_lanes, int k_chunk, int vector, void* out) {
  int* o = static_cast<int*>(out);
  const bool vec = vector != 0;
  if (k_chunk <= 0) return (int)cudaErrorInvalidValue;
  if (gemv_lanes == 0) {
    if (k_chunk % GM_BK != 0) return (int)cudaErrorInvalidValue;
    return vec ? kernel_attributes(qmv_gemm_kernel<true>, THREADS, 0, o)
               : kernel_attributes(qmv_gemm_kernel<false>, THREADS, 0, o);
  }
  if (k_chunk % GV_KSTEP != 0) return (int)cudaErrorInvalidValue;
  switch (gemv_lanes) {
    case 1: return gemv_attributes<1>(k_chunk, vec, o);
    case 2: return gemv_attributes<2>(k_chunk, vec, o);
    case 4: return gemv_attributes<4>(k_chunk, vec, o);
    case 8: return gemv_attributes<8>(k_chunk, vec, o);
    case 16: return gemv_attributes<16>(k_chunk, vec, o);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
