// A kernel's launch resources as the CUDA runtime reports them, for the
// bench entries' launch lines (ops/*.py: launch_config): resident blocks
// per SM at a block size and dynamic shared memory, registers per thread,
// static shared memory and local (stack) bytes per thread. Host code of
// the .cu files only; the g++ twins never include it.
#pragma once

#include <cuda_runtime.h>

// out: [blocks per SM, registers, static smem, dynamic smem, local bytes].
// Returns a cudaError_t.
template <typename Kernel>
static int launch_info(Kernel kernel, int threads, size_t dyn_smem,
                       int* out) {
  if (dyn_smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)dyn_smem);
    if (e != cudaSuccess) return (int)e;
  }
  cudaFuncAttributes a;
  cudaError_t e = cudaFuncGetAttributes(&a, kernel);
  if (e != cudaSuccess) return (int)e;
  int blocks = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, threads,
                                                    dyn_smem);
  if (e != cudaSuccess) return (int)e;
  out[0] = blocks;
  out[1] = a.numRegs;
  out[2] = (int)a.sharedSizeBytes;
  out[3] = (int)dyn_smem;
  out[4] = (int)a.localSizeBytes;
  return 0;
}
