// A whole settle-chunk of functional-mode ONN cycles in one launch (sm_90a).
//
// Replaces phase_step_multi_pallas / _phase_step_multi_kernel of
// src/repro/kernels/coupling_kernel.py.  The TPU kernel keeps all of W
// resident in VMEM; a Hopper block holds at most 227 KB of shared memory, and
// the paper's N = 506 int8 matrix alone is 250 KB.  Lanes never read each
// other's rows, so the grid runs over lanes only:
//
//   * each block owns BB whole lanes (all N oscillators of each) and loops over
//     `chunk` cycles with no synchronisation across blocks;
//   * every cycle, W streams from L2 (256 KB at N = 506 stays resident there,
//     shared by all blocks), as 16-byte loads of a row zero-padded to KP bytes;
//   * per lane, three int32 phase buffers (theta, prev-theta, next theta) live
//     in shared memory and rotate by index instead of being copied;
//   * the per-lane all(next == theta) and all(next == prev) are block
//     reductions through shared flags;
//   * the bookkeeping runs in exactly the order of coupling_kernel.py:476-490;
//   * the packed variant reads and writes two 4-bit counters per byte at the
//     launch boundary only.
//
// What bounds it on this card: per cycle it does 2 * B * N^2 int8 operations
// (0.52 G at B = 1024, N = 506) against about 0.26 MB of W plus the lane state,
// read from L2 rather than device memory, so by the roofline of device memory
// it is bound by operations, and by L2 bandwidth in practice: each block
// re-reads W every cycle.  BB lanes per block amortise one W row load over BB
// dot products (__dp4a, four int8 products per instruction).  A thread-block
// cluster that splits W across SMs through distributed shared memory is later
// work.
//
// Eligibility ceiling: shared memory per block is 12 * BB * N + BB * KP bytes
// of lane state plus a few hundred bytes of flags; see kernels/autotune.py.
//
// Plain C interface for ctypes: the entry returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int NCOLS = 7;  // t, settle_cycle, settled, cycled, frozen, frozen_p2, freeze_cycle
enum Col { T = 0, SC = 1, SD = 2, CY = 3, FZ = 4, FP2 = 5, FC = 6 };

template <bool PACKED, int BB>
__global__ void __launch_bounds__(THREADS)
phase_step_multi_kernel(const int8_t* __restrict__ w,      // (N, KP), zero columns past N
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
  for (int e = tid; e < BB * N; e += THREADS) {
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
  for (int e = tid; e < BB * (KP - N); e += THREADS) {
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

    for (int e = tid; e < BB * N; e += THREADS) {
      const int l = e / N, i = e % N;
      sig[(size_t)l * KP + i] = buf(s_cur[l], l)[i] < half ? 1 : -1;
    }
    __syncthreads();

    for (int i = tid; i < N; i += THREADS) {
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
    for (int e = tid; e < BB * pw; e += THREADS) {
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
    for (int e = tid; e < BB * N; e += THREADS) {
      const int l = e / N, i = e % N;
      const int lane = lane0 + l;
      if (lane >= B) continue;
      static_cast<int32_t*>(phase_out)[(size_t)lane * N + i] = buf(s_cur[l], l)[i];
      static_cast<int32_t*>(prev_out)[(size_t)lane * N + i] = buf(s_prv[l], l)[i];
    }
  }
}

template <bool PACKED, int BB>
int launch(const void* w, const void* bias, const void* phase, const void* prev,
           const void* cols_in, void* phase_out, void* prev_out, void* cols_out, int B,
           int N, int KP, int half, int chunk, int max_cycles, void* stream) {
  const size_t ph_bytes = (size_t)3 * BB * N * sizeof(int32_t);
  const size_t smem = ((ph_bytes + 15) / 16) * 16 + (size_t)BB * KP;
  auto kernel = phase_step_multi_kernel<PACKED, BB>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (B + BB - 1) / BB;
  kernel<<<blocks, THREADS, smem, (cudaStream_t)stream>>>(
      (const int8_t*)w, (const int32_t*)bias, phase, prev, (const int32_t*)cols_in,
      phase_out, prev_out, (int32_t*)cols_out, B, N, KP, half, chunk, max_cycles);
  return (int)cudaGetLastError();
}

template <bool PACKED>
int dispatch(int bb, const void* w, const void* bias, const void* phase, const void* prev,
             const void* cols_in, void* phase_out, void* prev_out, void* cols_out, int B,
             int N, int KP, int half, int chunk, int max_cycles, void* stream) {
  switch (bb) {
    case 1: return launch<PACKED, 1>(w, bias, phase, prev, cols_in, phase_out, prev_out,
                                     cols_out, B, N, KP, half, chunk, max_cycles, stream);
    case 2: return launch<PACKED, 2>(w, bias, phase, prev, cols_in, phase_out, prev_out,
                                     cols_out, B, N, KP, half, chunk, max_cycles, stream);
    case 4: return launch<PACKED, 4>(w, bias, phase, prev, cols_in, phase_out, prev_out,
                                     cols_out, B, N, KP, half, chunk, max_cycles, stream);
    case 8: return launch<PACKED, 8>(w, bias, phase, prev, cols_in, phase_out, prev_out,
                                     cols_out, B, N, KP, half, chunk, max_cycles, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// `chunk` cycles + bookkeeping.  w (N, KP) int8 with KP a multiple of 16 and
// zero columns past N; bias (N,) int32; phase/prev (B, N) int32, or
// (B, ceil(N/2)) uint8 when packed != 0; cols_in/cols_out (7, B) int32 in the
// order t, settle_cycle, settled, cycled, frozen, frozen_p2, freeze_cycle.
// bb (lanes per block) is 1, 2, 4 or 8.
int onn_phase_step_multi(const void* w, const void* bias, const void* phase,
                         const void* prev, const void* cols_in, void* phase_out,
                         void* prev_out, void* cols_out, int B, int N, int KP, int half,
                         int chunk, int max_cycles, int packed, int bb, void* stream) {
  if (B <= 0 || N <= 0) return (int)cudaGetLastError();
  if (KP % 16 != 0 || KP < N) return (int)cudaErrorInvalidValue;
  if (packed)
    return dispatch<true>(bb, w, bias, phase, prev, cols_in, phase_out, prev_out, cols_out,
                          B, N, KP, half, chunk, max_cycles, stream);
  return dispatch<false>(bb, w, bias, phase, prev, cols_in, phase_out, prev_out, cols_out,
                         B, N, KP, half, chunk, max_cycles, stream);
}

}  // extern "C"
