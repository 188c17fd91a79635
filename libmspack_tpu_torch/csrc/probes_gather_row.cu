// P5 redesigned for Hopper: the axis-1 gather from a row staged in shared
// memory, and the mask-sum as a direct vectorised gather.
// probes_gather_core.cuh (the row gather) and probes_gather2_core.cuh (the
// mask-sum, P6's core without its modulo) hold both designs' functions and
// say how they work; the faithful ports stay in probes_micro_gather.cu.
//
// Replaces, beside those ports, the Pallas kernels of tools/micro_gather.py:
//   p5_row_kernel          pallas_dyngather_axis1 (pallas_call at :82):
//                          out[h, l] = t[h, clamp(idx[h, l], 0, L - 1)] on
//                          int32 (H, L).
//   p5_masksum_vec_kernel  bench_pallas_masksum (:132): out[l] =
//                          tab[idx[l], l] where 0 <= idx[l] < N, else 0.
//
// What bounds them on this card. Both move 12 bytes an element (bytes),
// far less than one launch costs at the tool's shapes (8 K elements), so
// each is timed beside a copy_ of idx (one launch that moves the same
// bytes). The faithful gather gives each thread a 64-bit division and
// modulo by L, then two dependent device-memory loads (idx, then t); here
// h comes from the block, the block's rows of t are copied into shared
// memory while idx is loaded, and the second load is a shared-memory one.
// The faithful mask-sum gives a lane to each thread in 32-thread blocks;
// here a thread takes four lanes, whole 16-byte loads and stores.
#include <cuda_runtime.h>
#include <stdint.h>

#include "probes_gather2_core.cuh"

namespace {

// A block of row_threads(L) threads takes row blockIdx.x: thread x gathers
// its quads x, x + blockDim.x, ...; L int32 of dynamic shared memory hold
// the row. VEC: pg::row_vec holds, so only the 16-byte paths are compiled
// in.
template <bool VEC>
__global__ void __launch_bounds__(pg::ROW_THREADS)
    p5_row_kernel(const int32_t* __restrict__ t,
                  const int32_t* __restrict__ idx,
                  int32_t* __restrict__ out, int L) {
  extern __shared__ int4 smem4[];
  int32_t* s = reinterpret_cast<int32_t*>(smem4);
  int64_t at = (int64_t)blockIdx.x * L;
  int x = threadIdx.x;
  pg::stage_flat(t + at, L, s, x, blockDim.x, VEC);
  int32_t first[4] = {0, 0, 0, 0};
  if (VEC && 4 * x < L)  // while the copy flies
    pg::load16(first, idx + at + 4 * x);
  pg::async_wait();
  __syncthreads();
  pg::gather_row(s, idx + at, out + at, L, x, blockDim.x, VEC, first);
}

__global__ void __launch_bounds__(pg2::MASK_THREADS)
    p5_masksum_vec_kernel(const int32_t* __restrict__ tab,
                          const int32_t* __restrict__ idx,
                          int32_t* __restrict__ out, int N, int L) {
  int64_t q = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  bool vec = pg::aligned16(idx) && pg::aligned16(out);
  pg2::masksum_quad<false>(tab, idx, out, N, L, q, vec);
}

}  // namespace

// t, idx, out: (H, L) int32, a block a row. cudaErrorInvalidValue where
// L > pg::ROW_MAX.
extern "C" int msp_p5_dyngather_row(const void* t, const void* idx, void* out,
                                    int H, int L, void* stream) {
  if (H <= 0 || L <= 0) return 0;
  if (L > pg::ROW_MAX) return (int)cudaErrorInvalidValue;
  const int32_t *ti = (const int32_t*)t, *ii = (const int32_t*)idx;
  int32_t* oi = (int32_t*)out;
  auto kernel = pg::row_vec(ti, ii, oi, L) ? p5_row_kernel<true>
                                           : p5_row_kernel<false>;
  kernel<<<(unsigned)H, (unsigned)pg::row_threads(L),
           (size_t)L * sizeof(int32_t), (cudaStream_t)stream>>>(ti, ii, oi,
                                                                L);
  return (int)cudaGetLastError();
}

// tab: (N, L); idx, out: (L,) int32; pg2::MASK_LANES lanes a thread.
extern "C" int msp_p5_masksum_vec(const void* tab, const void* idx, void* out,
                                  int N, int L, void* stream) {
  if (L <= 0) return 0;
  const int threads = pg2::MASK_THREADS;
  int64_t quads = ((int64_t)L + pg2::MASK_LANES - 1) / pg2::MASK_LANES;
  p5_masksum_vec_kernel<<<(unsigned)((quads + threads - 1) / threads),
                          threads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)tab, (const int32_t*)idx, (int32_t*)out, N, L);
  return (int)cudaGetLastError();
}
