// K1: DEFLATE phase A on Hopper, one warp per stream.
//
// Replaces libmspack_tpu/ops/pallas_inflate.py::_kernel, which decoded 1024
// streams in lockstep, one per VPU lane, with its Huffman decode a compare
// of the next 15 bits against every symbol's key. Here each warp runs the
// sequential decoder of deflate_core.cuh on its own stream and writes its
// tokens, compacted, into row i of a lane-major (L, cap) trace: the layout
// that native.resolve_traces and K2 read, so nothing is transposed. Counts
// go into an (8, L) grid (deflate_core.cuh:write_counts).
//
// What bounds it on this card: one stream's dependent chain, symbol after
// symbol. A 96 MiB MSZIP cabinet is 3072 frames, a folder 768: a few warps
// on each of the H100's 132 SMs, each waiting on its own chain of bit
// reads and table loads, while the bytes are a few MB. The design shortens
// that chain as K3's does (lzx_core.cuh): all 32 lanes run the decoder in
// lockstep on identical registers (no divergence), a symbol is one read of
// a first-level table in shared memory (literal/length 10 bits, distance
// 8, code lengths 7) instead of puff's walk of up to 15 dependent steps,
// the bit buffer refills 32 bits at a time, literal runs decode in a tight
// loop that packs the litword, and the warp builds each code and fills its
// tables 32 symbols a step. `warps` warps share a block, each with its own
// tables (dc::Tables, 3984 bytes).
#include <cuda_runtime.h>

#include "deflate_core.cuh"
#include "launch_info.cuh"

__global__ void k1_inflate_kernel(const uint8_t* __restrict__ streams,
                                  int64_t stride,
                                  const int32_t* __restrict__ lens,
                                  const int32_t* __restrict__ hists, int L,
                                  int32_t* __restrict__ tok,
                                  int32_t* __restrict__ litw, int32_t cap,
                                  int32_t* __restrict__ cnt) {
  extern __shared__ __align__(16) unsigned char smem[];
  int w = (int)(threadIdx.x >> 5);
  int64_t i = (int64_t)blockIdx.x * (blockDim.x >> 5) + w;
  if (i >= L) return;  // uniform across the warp
  dc::Tables& T = reinterpret_cast<dc::Tables*>(smem)[w];
  dc::Result r = dc::inflate(streams + i * stride, lens[i], hists[i],
                             tok + i * cap, litw + i * cap, cap, T);
  if (warp::leader()) dc::write_counts(cnt, L, i, r);
}

extern "C" int msp_k1_inflate(const void* streams, int64_t stride,
                              const void* lens, const void* hists, int L,
                              void* tok, void* litw, int32_t cap, void* cnt,
                              int warps, void* stream) {
  if (L <= 0) return 0;
  if (warps < 1 || warps > 32) return (int)cudaErrorInvalidValue;
  size_t smem = (size_t)warps * sizeof(dc::Tables);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        k1_inflate_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  int blocks = (L + warps - 1) / warps;
  k1_inflate_kernel<<<blocks, 32 * warps, smem, (cudaStream_t)stream>>>(
      (const uint8_t*)streams, stride, (const int32_t*)lens,
      (const int32_t*)hists, L, (int32_t*)tok, (int32_t*)litw, cap,
      (int32_t*)cnt);
  return (int)cudaGetLastError();
}

// K1's launch resources at `warps` warps a block (launch_info.cuh).
extern "C" int msp_k1_launch_info(int warps, int* out) {
  return launch_info(k1_inflate_kernel, 32 * warps,
                     (size_t)warps * sizeof(dc::Tables), out);
}

extern "C" const char* msp_cuda_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}
