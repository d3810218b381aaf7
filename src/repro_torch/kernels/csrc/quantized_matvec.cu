// Quantized matrix product for Hopper (sm_90a): y = (x W_q^T) * scale per row.
//
// Replaces the TPU kernel quantized_matvec_pallas / _quantized_matvec_kernel
// of src/repro/kernels/coupling_kernel.py: x (B, K) float32, W_q (M, K) int8,
// scale (M,) float32 -> y (B, M) float32.  The TPU kernel widens each W_q
// block to float32 in VMEM, accumulates x W_q^T over the K grid axis in a
// float32 scratch block, and multiplies by the per-row scale in the last
// K step.  Here one block owns a tile of outputs for the whole contraction:
// every output element stays in a register from the first product to the
// store, and the scale multiplies it once in the epilogue.
//
// Arithmetic: plain float32 FMA on the CUDA cores, no TF32 and no tensor
// cores, so each element's error against exact arithmetic is that of K
// float32 roundings, |err| <= K * 2^-24 * |scale_m| * sum_k |x_bk * w_mk|,
// whatever the order (the plain version's matmul sums in another order).
// Widening int8 to float32 is exact.
//
// Design (simple and correct first): a block of 256 threads (16 x 16) owns
// BM = 16 * TM lanes by BN = 64 output rows; each thread owns TM x 4 outputs
// (lanes ty + 16 r, rows tx + 16 c).  Each K step loads a BK = 32 wide slab
// of x (float32) and of W_q (int8, widened to float32 on the way into shared
// memory), both stored k-major with an odd row pitch, so the transposing
// stores and the broadcast reads are free of bank conflicts.  Ragged B, M
// and K edges are masked to zero at the load (0 * 0 adds nothing).
//
// What bounds it on this card, by regime:
//   * B = 1024, M = K = 506: 0.52 G FMA-operations against 67 TFLOP/s of
//     float32 is 7.8 us; the bytes (2.1 MB x, 0.26 MB W, 2.1 MB y) 1.3 us:
//     bound by operations.  TM = 4 (64 lanes per tile).
//   * B = 8, M = K = 4096: W_q alone is 16.8 MB, 5.0 us at 3.35 TB/s: bound
//     by bytes, a GEMV that streams W once.  TM = 1 (16 lanes per tile), so
//     fewer masked lanes are computed; byte-wide W loads and 64 blocks on
//     132 SMs keep it far from that bound.  The tile choice lives in
//     kernels/autotune.py; a split-K or wider-load GEMV is later work.
//
// Plain C interface for ctypes: the entry returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BN = 64;        // output rows per block tile
constexpr int BK = 32;        // contraction elements per shared-memory slab
constexpr int THREADS = 256;  // 16 x 16 threads

template <int TM>
__global__ void __launch_bounds__(THREADS)
quantized_matvec_kernel(const float* __restrict__ x,       // (B, K)
                        const int8_t* __restrict__ w,      // (M, K)
                        const float* __restrict__ scale,   // (M,)
                        float* __restrict__ out,           // (B, M)
                        int B, int M, int K) {
  constexpr int BM = 16 * TM;
  __shared__ float s_x[BK][BM + 1];
  __shared__ float s_w[BK][BN + 1];
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int b0 = blockIdx.y * BM, i0 = blockIdx.x * BN;
  float acc[TM][4];
#pragma unroll
  for (int r = 0; r < TM; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] = 0.0f;

  for (int k0 = 0; k0 < K; k0 += BK) {
    // Consecutive threads read consecutive k of one row: coalesced.
    for (int e = tid; e < BM * BK; e += THREADS) {
      const int r = e / BK, c = e % BK;
      const int b = b0 + r, k = k0 + c;
      s_x[c][r] = (b < B && k < K) ? x[(size_t)b * K + k] : 0.0f;
    }
    for (int e = tid; e < BN * BK; e += THREADS) {
      const int r = e / BK, c = e % BK;
      const int i = i0 + r, k = k0 + c;
      s_w[c][r] = (i < M && k < K) ? (float)w[(size_t)i * K + k] : 0.0f;
    }
    __syncthreads();
#pragma unroll 8
    for (int k = 0; k < BK; ++k) {
      float a[TM], bw[4];
#pragma unroll
      for (int r = 0; r < TM; ++r) a[r] = s_x[k][ty + 16 * r];
#pragma unroll
      for (int c = 0; c < 4; ++c) bw[c] = s_w[k][tx + 16 * c];
#pragma unroll
      for (int r = 0; r < TM; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(a[r], bw[c], acc[r][c]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int r = 0; r < TM; ++r) {
    const int b = b0 + ty + 16 * r;
    if (b >= B) continue;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int i = i0 + tx + 16 * c;
      if (i < M) out[(size_t)b * M + i] = acc[r][c] * scale[i];
    }
  }
}

template <int TM>
void launch(const float* x, const int8_t* w, const float* scale, float* out, int B, int M,
            int K, cudaStream_t stream) {
  dim3 grid((M + BN - 1) / BN, (B + 16 * TM - 1) / (16 * TM));
  quantized_matvec_kernel<TM><<<grid, THREADS, 0, stream>>>(x, w, scale, out, B, M, K);
}

}  // namespace

extern "C" {

// y = (x W_q^T) * scale: x (B, K) float32, w (M, K) int8, scale (M,) float32 ->
// out (B, M) float32.  lanes_per_tile is 16 or 64 (kernels/autotune.py).
int onn_quantized_matvec(const void* x, const void* w, const void* scale, void* out, int B,
                         int M, int K, int lanes_per_tile, void* stream) {
  if (lanes_per_tile != 16 && lanes_per_tile != 64) return (int)cudaErrorInvalidValue;
  if (B > 0 && M > 0) {
    auto s = (cudaStream_t)stream;
    if (lanes_per_tile == 16)
      launch<1>((const float*)x, (const int8_t*)w, (const float*)scale, (float*)out, B, M, K, s);
    else
      launch<4>((const float*)x, (const int8_t*)w, (const float*)scale, (float*)out, B, M, K, s);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
