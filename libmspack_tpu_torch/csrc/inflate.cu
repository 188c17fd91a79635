// K1: DEFLATE phase A on Hopper, one thread per stream.
//
// Replaces libmspack_tpu/ops/pallas_inflate.py::_kernel, which decoded 1024
// streams in lockstep, one per VPU lane. Here each thread runs the
// sequential decoder of deflate_core.cuh on its own stream and writes its
// tokens, compacted, into row i of a lane-major (L, cap) trace: the layout
// that native.resolve_traces and the K2 copy machine read, so nothing is
// transposed. Counts go into an (8, L) grid (deflate_core.cuh:write_counts).
//
// What bounds it on this card: serial per-thread decode. A 96 MiB MSZIP
// cabinet is 3072 frames, so 3072 threads, about 23 per SM of the H100's
// 132: far too few to hide the latency of the bit-buffer refills and the
// table reads, and the threads of a warp diverge on every symbol. Its
// design keeps the per-thread tables (1096 bytes) in shared memory rather
// than in local memory, and launches small blocks (8 threads by default, a
// launch argument) so that a few hundred lanes still spread over many SMs.
// Warp-cooperative decode is the first target for making it fast.
#include <cuda_runtime.h>

#include "deflate_core.cuh"

__global__ void k1_inflate_kernel(const uint8_t* __restrict__ streams,
                                  int64_t stride,
                                  const int32_t* __restrict__ lens,
                                  const int32_t* __restrict__ hists, int L,
                                  int32_t* __restrict__ tok,
                                  int32_t* __restrict__ litw, int32_t cap,
                                  int32_t* __restrict__ cnt) {
  extern __shared__ unsigned char smem[];
  int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= L) return;
  dc::Tables& tb = reinterpret_cast<dc::Tables*>(smem)[threadIdx.x];
  dc::Result r = dc::inflate(streams + i * stride, lens[i], hists[i],
                             tok + i * cap, litw + i * cap, cap, tb);
  dc::write_counts(cnt, L, i, r);
}

extern "C" int msp_k1_inflate(const void* streams, int64_t stride,
                              const void* lens, const void* hists, int L,
                              void* tok, void* litw, int32_t cap, void* cnt,
                              int threads, void* stream) {
  if (L <= 0) return 0;
  size_t smem = (size_t)threads * sizeof(dc::Tables);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        k1_inflate_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  int blocks = (L + threads - 1) / threads;
  k1_inflate_kernel<<<blocks, threads, smem, (cudaStream_t)stream>>>(
      (const uint8_t*)streams, stride, (const int32_t*)lens,
      (const int32_t*)hists, L, (int32_t*)tok, (int32_t*)litw, cap,
      (int32_t*)cnt);
  return (int)cudaGetLastError();
}

extern "C" const char* msp_cuda_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}
