// Int8 coupling GEMM for Hopper (sm_90a), in three variants that differ only
// in how the spin operand is loaded and in the epilogue.
//
// Replaces three TPU kernels of src/repro/kernels/coupling_kernel.py:
//   * coupling_sum_pallas / _coupling_sum_kernel             -> onn_coupling_sum
//   * phase_step_pallas / _phase_step_kernel                 -> onn_phase_step
//   * phase_step_packed_pallas / _phase_step_packed_kernel   -> onn_phase_step_packed
//
// Computes S[b, i] = sum_k sigma[b, k] * W[i, k] with exact int32 accumulation
// (__dp4a: four int8 products per instruction), then
//   SUM:    out = S                                   (W may be an (M, N) row slab)
//   PHASE:  out = 0 if S + h > 0, half if S + h < 0, theta if S + h == 0
//   PACKED: as PHASE, with sigma (+1 iff theta < half) and the kept theta both
//           unpacked in registers from two 4-bit counters per byte (low first).
//
// What bounds it on this card: at the main path's shape (B = 1024, N = 506)
// the call moves about 4.9 MB (int32 phases in and out dominate) and does
// about 0.52 G int8 operations, so it is memory-bound by a wide margin.  The
// design keeps every output element in registers from the first product to
// the store (one read of each operand tile per block, one int32 write per
// output), loads 64x64 byte tiles of sigma and W into shared memory, and masks
// the ragged B, M and N edges at the load (zero spins against zero weights)
// instead of padding on the host.  Making it fast (wider loads, a pipelined
// ring of tiles, int8 mma) is later work; this version is simple and exact.
//
// Plain C interface for ctypes: every entry returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;        // lanes per block tile
constexpr int BN = 64;        // output rows per block tile
constexpr int BK = 64;        // contraction bytes per stage
constexpr int LDS = BK + 4;   // 17 words per smem row: conflict-free word reads
constexpr int THREADS = 256;  // 16 x 16 threads, 4 x 4 outputs each

enum Mode { SUM = 0, PHASE = 1, PACKED = 2 };

__device__ __forceinline__ int nibble(const uint8_t* __restrict__ row, int k) {
  return (row[k >> 1] >> ((k & 1) * 4)) & 0xF;
}

template <int MODE>
__global__ void __launch_bounds__(THREADS)
coupling_gemm_kernel(const int8_t* __restrict__ sigma,    // (B, N), SUM/PHASE
                     const uint8_t* __restrict__ packed,  // (B, ceil(N/2)), PACKED
                     const int8_t* __restrict__ w,        // (M, N)
                     const int32_t* __restrict__ bias,    // (M,), PHASE/PACKED
                     const int32_t* __restrict__ phase,   // (B, M), PHASE
                     int32_t* __restrict__ out,           // (B, M)
                     int B, int M, int N, int half) {
  __shared__ __align__(16) int8_t s_sig[BM][LDS];
  __shared__ __align__(16) int8_t s_w[BN][LDS];
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int b0 = blockIdx.y * BM, i0 = blockIdx.x * BN;
  const int pw = (N + 1) / 2;
  int acc[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] = 0;

  for (int k0 = 0; k0 < N; k0 += BK) {
    for (int e = tid; e < BM * BK; e += THREADS) {
      const int r = e / BK, c = e % BK;
      const int k = k0 + c;
      const int b = b0 + r;
      int8_t v = 0;
      if (b < B && k < N) {
        if (MODE == PACKED) {
          v = nibble(packed + (size_t)b * pw, k) < half ? 1 : -1;
        } else {
          v = sigma[(size_t)b * N + k];
        }
      }
      s_sig[r][c] = v;
      const int i = i0 + r;
      s_w[r][c] = (i < M && k < N) ? w[(size_t)i * N + k] : (int8_t)0;
    }
    __syncthreads();
#pragma unroll
    for (int kw = 0; kw < BK / 4; ++kw) {
      int a[4], bw[4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
        a[r] = *reinterpret_cast<const int*>(&s_sig[ty + 16 * r][kw * 4]);
#pragma unroll
      for (int c = 0; c < 4; ++c)
        bw[c] = *reinterpret_cast<const int*>(&s_w[tx + 16 * c][kw * 4]);
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[r][c] = __dp4a(a[r], bw[c], acc[r][c]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int b = b0 + ty + 16 * r;
    if (b >= B) continue;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int i = i0 + tx + 16 * c;
      if (i >= M) continue;
      int s = acc[r][c];
      if (MODE != SUM) {
        s += bias[i];
        const int keep = (MODE == PHASE) ? phase[(size_t)b * M + i]
                                         : nibble(packed + (size_t)b * pw, i);
        s = s > 0 ? 0 : (s < 0 ? half : keep);
      }
      out[(size_t)b * M + i] = s;
    }
  }
}

template <int MODE>
int launch(const void* sigma, const void* packed, const void* w, const void* bias,
           const void* phase, void* out, int B, int M, int N, int half, void* stream) {
  if (B > 0 && M > 0) {
    dim3 grid((M + BN - 1) / BN, (B + BM - 1) / BM);
    coupling_gemm_kernel<MODE><<<grid, THREADS, 0, (cudaStream_t)stream>>>(
        (const int8_t*)sigma, (const uint8_t*)packed, (const int8_t*)w,
        (const int32_t*)bias, (const int32_t*)phase, (int32_t*)out, B, M, N, half);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// S = sigma W^T: sigma (B, N) int8, w (M, N) int8 -> out (B, M) int32.
int onn_coupling_sum(const void* sigma, const void* w, void* out, int B, int M, int N,
                     void* stream) {
  return launch<SUM>(sigma, nullptr, w, nullptr, nullptr, out, B, M, N, 0, stream);
}

// theta' = phase-align(sigma W^T + h, theta): sigma (B, N) int8, w (N, N) int8,
// bias (N,) int32, phase (B, N) int32 -> out (B, N) int32.
int onn_phase_step(const void* sigma, const void* w, const void* bias, const void* phase,
                   void* out, int B, int N, int half, void* stream) {
  return launch<PHASE>(sigma, nullptr, w, bias, phase, out, B, N, N, half, stream);
}

// As onn_phase_step with sigma and theta unpacked from packed (B, ceil(N/2)) uint8.
int onn_phase_step_packed(const void* packed, const void* w, const void* bias, void* out,
                          int B, int N, int half, void* stream) {
  return launch<PACKED>(nullptr, packed, w, bias, nullptr, out, B, N, N, half, stream);
}

}  // extern "C"
