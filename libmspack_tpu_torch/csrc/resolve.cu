// K2: phase-B copy machine on Hopper, two passes over all frames.
//
// Replaces libmspack_tpu/ops/pallas_resolve.py::_kernel. The TPU ran its
// lanes one after another so that lane k could copy lane k-1's 32 KiB slot
// in as its history. Here the output is one contiguous byte buffer with
// each lane's frame at the prefix-sum offset of the lane sizes, a lane
// whose hist flag is 0 starting a chain (an MSZIP folder), and the work
// splits as resolve_core.cuh sets out:
//
// - pass 1 (k2_pass1_kernel, <<<L, 32>>>): one warp per lane, every lane at
//   once, replays the lane's tokens into a work buffer of uint16 values in
//   shared memory (one per output byte; 256 + k marks byte k of the 32 KiB
//   before the lane), then stores it to the scratch `work` at the lane's
//   slot and writes the lane's count;
// - pass 2 (k2_pass2_kernel, <<<chains, 1024>>>): one block per chain walks
//   its lanes in order with the chain's last 32 KiB in a shared ring,
//   turning markers into bytes and writing every byte of the output. The
//   next lane's values stream into shared memory (cp.async) while the
//   block resolves the current one.
//
// What bounds it on this card: the token chain of one lane in pass 1 (each
// token's writes before the next token's reads, in shared memory) and, in
// pass 2, one dependent step per lane of a chain: pass 2 is the only part
// still serial across frames. The bytes are some 30 MB for a 96 MiB
// cabinet. One warp per chain, as this kernel's first design ran, kept 4
// warps busy on 132 SMs and paid a global-memory round trip per token.
#include <cuda_runtime.h>

#include "launch_info.cuh"
#include "resolve_core.cuh"

namespace {

__global__ void k2_pass1_kernel(const int32_t* __restrict__ tok,
                                const int32_t* __restrict__ litw,
                                int64_t tstride,
                                const int32_t* __restrict__ ntok,
                                const int32_t* __restrict__ outlens,
                                const int64_t* __restrict__ woff,
                                const int32_t* __restrict__ avail,
                                uint16_t* __restrict__ work,
                                int32_t* __restrict__ counts) {
  extern __shared__ __align__(16) uint16_t wk[];
  int64_t lane = blockIdx.x;
  int32_t n = outlens[lane];
  int nt = ntok[lane] < tstride ? ntok[lane] : (int)tstride;  // in the row
  int32_t c = rs::pass1(tok + lane * tstride, litw + lane * tstride, nt, n,
                        avail[lane], wk);
  rs::store_lane(wk, n, work + woff[lane]);
  if (threadIdx.x == 0) counts[lane] = c;
}

// A lane's slot of the scratch into shared memory, 16 bytes a copy,
// asynchronously (cp.async), as one commit group of each thread.
__device__ __forceinline__ void fetch_lane(const uint16_t* src, int32_t n,
                                           uint16_t* dst) {
  for (int q = threadIdx.x; q < (n + 7) >> 3; q += rs::P2_THREADS) {
    uint32_t d = (uint32_t)__cvta_generic_to_shared(dst + 8 * q);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;"
                 :: "r"(d), "l"(src + 8 * q) : "memory");
  }
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// One block per chain. The next lane's values load into the other half of
// `stage` while the block resolves this lane's.
__global__ void __launch_bounds__(rs::P2_THREADS)
    k2_pass2_kernel(const uint16_t* __restrict__ work,
                    const int64_t* __restrict__ woff,
                    const int32_t* __restrict__ outlens,
                    const int64_t* __restrict__ off,
                    const int32_t* __restrict__ chain_lane0,
                    uint8_t* __restrict__ out) {
  extern __shared__ __align__(16) uint16_t stage[];  // 2 x LANE_MAX
  __shared__ uint8_t ring[rs::WINDOW];
  int l0 = chain_lane0[blockIdx.x], l1 = chain_lane0[blockIdx.x + 1];
  if (l0 < l1) fetch_lane(work + woff[l0], outlens[l0], stage);
  for (int lane = l0, b = 0; lane < l1; lane++, b ^= 1) {
    asm volatile("cp.async.wait_group 0;" ::: "memory");
    // every thread's copies of this lane landed; every thread is done
    // with the other half (the lane before) and with the ring's reads
    __syncthreads();
    if (lane + 1 < l1) {
      fetch_lane(work + woff[lane + 1], outlens[lane + 1],
                 stage + (b ^ 1) * rs::LANE_MAX);
    }
    int32_t n = outlens[lane];
    int64_t start = off[lane];
    uint32_t vals[rs::P2_K / 4];
    rs::p2_gather(stage + b * rs::LANE_MAX, n, start, ring, threadIdx.x,
                  vals);
    __syncthreads();
    rs::p2_commit(n, start, ring, out + start, threadIdx.x, vals);
  }
}

constexpr size_t P2_STAGE_BYTES = 2 * rs::LANE_MAX * sizeof(uint16_t);

}  // namespace

// Pass 1 over L lanes of at most maxlen (<= 32768) bytes each; lane i's
// values go to work + woff[i] (woff[i] a multiple of 8).
extern "C" int msp_k2_pass1(const void* tok, const void* litw,
                            int64_t tstride, const void* ntok,
                            const void* outlens, const void* woff,
                            const void* avail, int L, int maxlen, void* work,
                            void* counts, void* stream) {
  if (L <= 0) return 0;
  if (maxlen < 0 || maxlen > rs::LANE_MAX) return (int)cudaErrorInvalidValue;
  size_t smem = ((size_t)maxlen * 2 + 15) & ~(size_t)15;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        k2_pass1_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  k2_pass1_kernel<<<L, 32, smem, (cudaStream_t)stream>>>(
      (const int32_t*)tok, (const int32_t*)litw, tstride,
      (const int32_t*)ntok, (const int32_t*)outlens, (const int64_t*)woff,
      (const int32_t*)avail, (uint16_t*)work, (int32_t*)counts);
  return (int)cudaGetLastError();
}

// Pass 2 over nchains chains (chain c: lanes chain_lane0[c] ..
// chain_lane0[c + 1] - 1), after pass 1 on the same stream.
extern "C" int msp_k2_pass2(const void* work, const void* woff,
                            const void* outlens, const void* off,
                            const void* chain_lane0, int nchains, void* out,
                            void* stream) {
  if (nchains <= 0) return 0;
  cudaError_t e = cudaFuncSetAttribute(
      k2_pass2_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)P2_STAGE_BYTES);
  if (e != cudaSuccess) return (int)e;
  k2_pass2_kernel<<<nchains, rs::P2_THREADS, P2_STAGE_BYTES,
                    (cudaStream_t)stream>>>(
      (const uint16_t*)work, (const int64_t*)woff, (const int32_t*)outlens,
      (const int64_t*)off, (const int32_t*)chain_lane0, (uint8_t*)out);
  return (int)cudaGetLastError();
}

// K2's launch resources (launch_info.cuh): pass 1 (`pass` 1) for lanes of
// at most `maxlen` bytes, or pass 2.
extern "C" int msp_k2_launch_info(int pass, int maxlen, int* out) {
  if (pass == 1) {
    return launch_info(k2_pass1_kernel, 32,
                       ((size_t)maxlen * 2 + 15) & ~(size_t)15, out);
  }
  return launch_info(k2_pass2_kernel, rs::P2_THREADS, P2_STAGE_BYTES, out);
}
