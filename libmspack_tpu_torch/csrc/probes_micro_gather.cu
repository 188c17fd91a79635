// P5: per-lane gathers on Hopper, the primitives of an entropy decoder.
//
// Replaces the Pallas kernels of tools/micro_gather.py, which chose on the
// TPU the primitive for per-lane Huffman table probes, stream refill and
// phase-B pointer doubling:
//   dyngather  pallas_dyngather_axis0 / _axis1 (pallas_call at :67, :82):
//              out = take_along_axis(t, i, axis) on an (H, L) int32 pair;
//              one thread per output element. An index outside its axis is
//              clamped to it (the TPU tool's indices never are).
//   masksum    bench_pallas_masksum (:132): out[l] = tab[idx[l], l] for a
//              (288, L) table by the TPU's compare/select sweep over all
//              288 rows (probes_gather.cuh); one thread per lane.
//   symbol     bench_symbol_step (:206): T = 256 steps of a mock DEFLATE
//              symbol: refill a 32-bit buffer from a 32-row word window at
//              row widx & 31, find the code length (14 compares against the
//              lane's limits), probe a 288-row meta table at
//              (code + 7 length) mod 288, consume length + (meta & 7) bits,
//              acc += meta; one thread per lane. A GPU thread can index, so
//              both probes are direct loads here, not the TPU's sweeps.
// The shift amounts stay in 0..31: navail is 0 or 10..31 when the buffer
// refills, and a symbol consumes 1..22 bits.
//
// What bounds them on this card: dyngather moves 12 bytes per element
// (memory); masksum and symbol are latency chains within a lane (288
// dependent selects; 256 dependent steps of about 16 operations and two
// loads each).
#include <cuda_runtime.h>
#include <stdint.h>

#include "probes_gather.cuh"

namespace {

__global__ void p5_dyngather_kernel(const int32_t* __restrict__ t,
                                    const int32_t* __restrict__ idx,
                                    int32_t* __restrict__ out, int H, int L,
                                    int axis) {
  int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= (int64_t)H * L) return;
  int64_t h = e / L, l = e % L;
  int32_t k = idx[e];
  if (axis == 0) {
    k = min(max(k, 0), H - 1);
    out[e] = t[k * (int64_t)L + l];
  } else {
    k = min(max(k, 0), L - 1);
    out[e] = t[h * L + k];
  }
}

__global__ void p5_masksum_kernel(const int32_t* __restrict__ tab,
                                  const int32_t* __restrict__ idx,
                                  int32_t* __restrict__ out, int N, int L) {
  int64_t l = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (l >= L) return;
  out[l] = probes::masksum_sweep(tab, L, l, idx[l], N);
}

__global__ void p5_symbol_kernel(const int32_t* __restrict__ meta,
                                 const int32_t* __restrict__ limit,
                                 const uint32_t* __restrict__ words,
                                 int32_t* __restrict__ out, int L, int T) {
  int64_t l = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (l >= L) return;
  uint32_t bitbuf = 0, acc = 0;
  int32_t navail = 0, widx = 0;
  for (int t = 0; t < T; t++) {
    uint32_t w = words[(widx & 31) * (int64_t)L + l];
    bitbuf |= navail < 32 ? w << navail : 0u;
    navail = min(navail + 32, 32);
    int32_t length, code;
    probes::len_find((int32_t)(bitbuf & 0x7FFF), limit, L, l, length, code);
    int32_t m = meta[((code + length * 7) % 288) * (int64_t)L + l];
    uint32_t consume = (uint32_t)(length + (m & 7));
    bitbuf >>= consume;
    navail -= (int32_t)consume;
    widx += 1;
    acc += (uint32_t)m;
  }
  out[l] = (int32_t)acc;
}

}  // namespace

// t, idx, out: (H, L) int32.
extern "C" int msp_p5_dyngather(const void* t, const void* idx, void* out,
                                int H, int L, int axis, void* stream) {
  int64_t n = (int64_t)H * L;
  if (n <= 0) return 0;
  const int threads = 256;
  p5_dyngather_kernel<<<(unsigned)((n + threads - 1) / threads), threads, 0,
                        (cudaStream_t)stream>>>(
      (const int32_t*)t, (const int32_t*)idx, (int32_t*)out, H, L, axis);
  return (int)cudaGetLastError();
}

// tab: (N, L); idx, out: (L,) int32.
extern "C" int msp_p5_masksum(const void* tab, const void* idx, void* out,
                              int N, int L, void* stream) {
  if (L <= 0) return 0;
  const int threads = 32;  // one warp a block: lanes spread over the SMs
  p5_masksum_kernel<<<(L + threads - 1) / threads, threads, 0,
                      (cudaStream_t)stream>>>(
      (const int32_t*)tab, (const int32_t*)idx, (int32_t*)out, N, L);
  return (int)cudaGetLastError();
}

// meta: (288, L), limit: (16, L), words: (32, L) uint32; out: (L,) int32.
extern "C" int msp_p5_symbol_step(const void* meta, const void* limit,
                                  const void* words, void* out, int L, int T,
                                  void* stream) {
  if (L <= 0) return 0;
  const int threads = 32;
  p5_symbol_kernel<<<(L + threads - 1) / threads, threads, 0,
                     (cudaStream_t)stream>>>(
      (const int32_t*)meta, (const int32_t*)limit, (const uint32_t*)words,
      (int32_t*)out, L, T);
  return (int)cudaGetLastError();
}
