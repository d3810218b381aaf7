// The attribute query that each source's `*_attributes` entry ends in: what
// one compiled instantiation is, for the launch configuration that the
// source's own launch code gives it.  Included by every source (the build
// hashes it into each library's key).
#pragma once

#include <cuda_runtime.h>

namespace {

// out[6]: registers a thread, local bytes a thread, static shared bytes and
// most threads a block (cudaFuncGetAttributes); blocks an SM holds at
// `threads` and `smem` dynamic shared bytes after the launch's opt-in
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor); and `threads`, the block
// size that the launch uses.
template <class K>
int kernel_attributes(K kernel, int threads, int smem, int* out) {
  cudaFuncAttributes a;
  cudaError_t err = cudaFuncGetAttributes(&a, kernel);
  if (err != cudaSuccess) return (int)err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, threads, (size_t)smem);
  if (err != cudaSuccess) return (int)err;
  out[0] = a.numRegs;
  out[1] = (int)a.localSizeBytes;
  out[2] = (int)a.sharedSizeBytes;
  out[3] = a.maxThreadsPerBlock;
  out[4] = blocks;
  out[5] = threads;
  return 0;
}

}  // namespace
