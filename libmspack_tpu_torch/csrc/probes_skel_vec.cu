// P2 redesigned for Hopper: the decoder skeleton as one launch that writes
// all 256 token rows and the counts. probes_skel_core.cuh holds the step
// and the grid and says how they work; the faithful port stays in
// probes_micro_skel.cu.
//
// Replaces, beside that port, tools/micro_skel.py::make_kernel (its
// pallas_call at :118): T steps a lane of refill, mock decode and token
// emit over L lanes, out int32 (256, L), cnt int32 (L,).
//
// What bounds it on this card: the dependent chain of T steps a lane as
// written (operations), which nvcc may shorten where it proves the mock
// decode's result (the faithful kernel's SASS keeps only the stores), and
// then the 256 L int32 of out. The faithful call is two launches (its
// wrapper's zero fill of out, then a warp a block, a lane a thread, each
// storing 4 bytes a step); here the rows no step writes are zeroed, with
// 16-byte stores, by blocks of the same launch as the decode.
#include <cuda_runtime.h>
#include <stdint.h>

#include "probes_skel_core.cuh"

namespace {

template <bool VEC>
__global__ void __launch_bounds__(ps::THREADS)
    p2_skel_vec_kernel(const ps::Args a, const ps::Grid g) {
  ps::block<VEC>(a, g, blockIdx.x, threadIdx.x, ps::Store());
}

}  // namespace

// stream: (L, W) uint32; seed, cnt: (L,) int32; out: (256, L) int32, every
// element written (rows t mod 256 for t < T by the steps, the others 0).
// Needs T + WIN <= W (a window never leaves its row).
extern "C" int msp_p2_skel_vec(const void* stream_words, int64_t W,
                               const void* seed, int L, int T, int G, int WIN,
                               void* out, void* cnt, void* stream) {
  if (L <= 0) return 0;
  ps::Args a = {(const uint32_t*)stream_words, W, (const int32_t*)seed, L,
                T, G, WIN, (int32_t*)out, (int32_t*)cnt};
  ps::Grid g = ps::grid(L, T);
  auto kernel = ps::vec(a) ? p2_skel_vec_kernel<true>
                           : p2_skel_vec_kernel<false>;
  kernel<<<(unsigned)(g.decode + g.zero), ps::THREADS, 0,
           (cudaStream_t)stream>>>(a, g);
  return (int)cudaGetLastError();
}
