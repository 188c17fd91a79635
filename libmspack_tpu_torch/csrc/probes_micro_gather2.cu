// P6: the chained gather probes on Hopper.
//
// Replaces the Pallas kernels of tools/micro_gather2.py, P5's probes in the
// form that feeds each call's output to the next (so the TPU tool could
// time a dependent chain):
//   masksum  bench_masksum (pallas_call at :25): P5's compare/select sweep
//            for tab[idx[l], l] over N rows, then (acc + idx) mod N (floor
//            modulo); one thread per lane.
//   symbol   bench_symbol_step (:85): T steps from a seed x per lane:
//            bitbuf ^= the word at row acc & 31 of a 32-row window, the
//            14-compare length find, the meta probe at (code + 7 length)
//            mod 288, acc += meta, and a rotate of bitbuf right by
//            (length + (meta & 7)) & 31, which is 1..22; out = acc + bitbuf.
//            One thread per lane, both probes direct loads.
//
// What bounds them on this card: latency within a lane (288 dependent
// selects; T dependent steps), as in P5.
#include <cuda_runtime.h>
#include <stdint.h>

#include "probes_gather.cuh"

namespace {

__global__ void p6_masksum_kernel(const int32_t* __restrict__ tab,
                                  const int32_t* __restrict__ idx,
                                  int32_t* __restrict__ out, int N, int L) {
  int64_t l = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (l >= L) return;
  int32_t i = idx[l];
  uint32_t a = (uint32_t)probes::masksum_sweep(tab, L, l, i, N);
  int32_t r = (int32_t)(a + (uint32_t)i) % N;  // the int32 sum wraps
  out[l] = r < 0 ? r + N : r;
}

__global__ void p6_symbol_kernel(const int32_t* __restrict__ meta,
                                 const int32_t* __restrict__ limit,
                                 const uint32_t* __restrict__ words,
                                 const int32_t* __restrict__ x,
                                 int32_t* __restrict__ out, int L, int T) {
  int64_t l = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (l >= L) return;
  uint32_t bitbuf = (uint32_t)x[l], acc = (uint32_t)x[l];
  for (int t = 0; t < T; t++) {
    bitbuf ^= words[(acc & 31) * (int64_t)L + l];
    int32_t length, code;
    probes::len_find((int32_t)(bitbuf & 0x7FFF), limit, L, l, length, code);
    int32_t m = meta[((code + length * 7) % 288) * (int64_t)L + l];
    uint32_t consume = (uint32_t)(length + (m & 7)) & 31u;
    bitbuf = __funnelshift_r(bitbuf, bitbuf, consume);
    acc += (uint32_t)m;
  }
  out[l] = (int32_t)(acc + bitbuf);
}

}  // namespace

// tab: (N, L); idx, out: (L,) int32.
extern "C" int msp_p6_masksum(const void* tab, const void* idx, void* out,
                              int N, int L, void* stream) {
  if (L <= 0) return 0;
  const int threads = 32;  // one warp a block: lanes spread over the SMs
  p6_masksum_kernel<<<(L + threads - 1) / threads, threads, 0,
                      (cudaStream_t)stream>>>(
      (const int32_t*)tab, (const int32_t*)idx, (int32_t*)out, N, L);
  return (int)cudaGetLastError();
}

// meta: (288, L), limit: (16, L), words: (32, L) uint32; x, out: (L,) int32.
extern "C" int msp_p6_symbol_step(const void* meta, const void* limit,
                                  const void* words, const void* x,
                                  void* out, int L, int T, void* stream) {
  if (L <= 0) return 0;
  const int threads = 32;
  p6_symbol_kernel<<<(L + threads - 1) / threads, threads, 0,
                     (cudaStream_t)stream>>>(
      (const int32_t*)meta, (const int32_t*)limit, (const uint32_t*)words,
      (const int32_t*)x, (int32_t*)out, L, T);
  return (int)cudaGetLastError();
}
