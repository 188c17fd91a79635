// P6 redesigned for Hopper: the mask-sum as a direct vectorised gather, and
// the chained symbol step with its word window in shared memory.
// probes_gather2_core.cuh holds both designs' functions and says how they
// work; the faithful ports stay in probes_micro_gather2.cu.
//
// Replaces, beside those ports, the Pallas kernels of
// tools/micro_gather2.py:
//   p6_masksum_vec_kernel  bench_masksum (pallas_call at :25):
//                          (tab[idx[l], l] + idx[l]) mod N on int32.
//   p6_symbol_smem_kernel  bench_symbol_step (:85): T mock symbol steps a
//                          lane, each refill at the row the last step's
//                          meta chose.
//
// What bounds them on this card. The mask-sum moves 12 bytes a lane
// (bytes), far less than one launch costs at the tool's 8192 lanes: the
// faithful kernel gives a lane to each thread in 32-thread blocks; here a
// thread takes four lanes, whole 16-byte loads and stores, and the
// kernel's time is set against a copy_ of idx (one launch that moves the
// same bytes). The symbol step is a chain of T dependent steps a lane
// (operations): in the faithful kernel each refill reads the row its last
// step chose, a load whose 32 lanes touch up to 32 sectors through L1 and
// L2; here it is one conflict-free shared-memory load, the limits are
// thresholds in registers, and the find exits at bl = 1 where it can.
#include <cuda_runtime.h>
#include <stdint.h>

#include "probes_gather2_core.cuh"

namespace {

__global__ void __launch_bounds__(pg2::MASK_THREADS)
    p6_masksum_vec_kernel(const int32_t* __restrict__ tab,
                          const int32_t* __restrict__ idx,
                          int32_t* __restrict__ out, int N, int L) {
  int64_t q = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  bool vec = pg::aligned16(idx) && pg::aligned16(out);
  pg2::masksum_quad<true>(tab, idx, out, N, L, q, vec);
}

// One block of pg::LANES lanes, a thread a lane.
__global__ void __launch_bounds__(pg::LANES)
    p6_symbol_smem_kernel(const int32_t* __restrict__ meta,
                          const int32_t* __restrict__ limit,
                          const uint32_t* __restrict__ words,
                          const int32_t* __restrict__ x,
                          int32_t* __restrict__ out, int L, int T) {
  __shared__ __align__(16) uint32_t s_words[pg2::WORD_ROWS * pg::LANES];
  int64_t l0 = (int64_t)blockIdx.x * pg::LANES;
  int j = threadIdx.x;
  int64_t l = l0 + j;
  pg::stage_rows(reinterpret_cast<const int32_t*>(words), pg2::WORD_ROWS, L,
                 l0, reinterpret_cast<int32_t*>(s_words), j, pg::LANES);
  bool lane = l < L;
  int32_t lim[15], th[15];
  uint32_t x0 = 0;
  if (lane) {  // while the copies fly
#pragma unroll
    for (int bl = 1; bl < 15; bl++) lim[bl] = limit[bl * (int64_t)L + l];
    pg::thresholds(lim, th);
    x0 = (uint32_t)x[l];
  }
  pg::async_wait();
  __syncthreads();
  if (lane) out[l] = pg2::run(s_words, meta, L, l, th, j, x0, T);
}

}  // namespace

// tab: (N, L); idx, out: (L,) int32; pg2::MASK_LANES lanes a thread.
extern "C" int msp_p6_masksum_vec(const void* tab, const void* idx, void* out,
                                  int N, int L, void* stream) {
  if (L <= 0) return 0;
  const int threads = pg2::MASK_THREADS;
  int64_t quads = ((int64_t)L + pg2::MASK_LANES - 1) / pg2::MASK_LANES;
  p6_masksum_vec_kernel<<<(unsigned)((quads + threads - 1) / threads),
                          threads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)tab, (const int32_t*)idx, (int32_t*)out, N, L);
  return (int)cudaGetLastError();
}

// meta: (288, L), limit: (16, L), words: (32, L) uint32; x, out: (L,)
// int32; pg::LANES lanes a block.
extern "C" int msp_p6_symbol_smem(const void* meta, const void* limit,
                                  const void* words, const void* x, void* out,
                                  int L, int T, void* stream) {
  if (L <= 0) return 0;
  p6_symbol_smem_kernel<<<(L + pg::LANES - 1) / pg::LANES, pg::LANES, 0,
                          (cudaStream_t)stream>>>(
      (const int32_t*)meta, (const int32_t*)limit, (const uint32_t*)words,
      (const int32_t*)x, (int32_t*)out, L, T);
  return (int)cudaGetLastError();
}
