// K2: phase-B copy machine on Hopper, one warp per chain of frames.
//
// Replaces libmspack_tpu/ops/pallas_resolve.py::_kernel. The TPU ran its
// lanes one after another so that lane k could copy lane k-1's 32 KiB slot
// in as its history. Here the output is one contiguous byte buffer with
// each lane's frame at the prefix-sum offset of the lane sizes, so a frame's
// history is simply the bytes before it, back to the start of its chain (a
// lane whose hist flag is 0 starts a chain: an MSZIP folder). Chains are
// independent and run on separate warps; the frames of one chain run in
// order on one warp.
//
// Per token the warp shuffles the token and its litword out of a 32-token
// register tile. Literals are written by threads 0..n-1. A match of length
// len at distance dist writes byte k of the match (k < len) from source byte
// (k mod dist) before it, 32 bytes per step: every byte read lies before the
// match's first byte, so the copy is overlap-safe without waiting on the
// bytes the same match writes (the TPU kernel's chunks of min(dist, V)).
//
// Counts follow the TPU kernel: tokens run while the lane's cursor is
// below its end, the cursor moves by each token's full length, and the
// count is cursor - start. A match that reaches before its chain's start
// stops the lane with count -1. Writes never pass the lane's end.
//
// What bounds it on this card: parallelism of one warp per chain. A 96 MiB
// cabinet of four 24 MiB MSZIP folders keeps 4 warps busy on a 132-SM card.
// Splitting a chain at frame boundaries, with a pass that resolves
// history-free tokens first, is the first target for making it fast.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int32_t TOK_MATCH = 0x40000000;
constexpr unsigned FULL = 0xFFFFFFFFu;

__global__ void k2_resolve_kernel(const int32_t* __restrict__ tok,
                                  const int32_t* __restrict__ litw,
                                  int64_t tstride,
                                  const int32_t* __restrict__ ntok,
                                  const int32_t* __restrict__ outlens,
                                  const int64_t* __restrict__ out_off,
                                  const int32_t* __restrict__ chain_lane0,
                                  int nchains, uint8_t* out,
                                  int32_t* __restrict__ counts) {
  int chain = (int)(((int64_t)blockIdx.x * blockDim.x + threadIdx.x) >> 5);
  int j = threadIdx.x & 31;
  if (chain >= nchains) return;  // uniform across the warp
  int64_t lo = out_off[chain_lane0[chain]];
  for (int lane = chain_lane0[chain]; lane < chain_lane0[chain + 1]; lane++) {
    const int32_t* tk = tok + (int64_t)lane * tstride;
    const int32_t* lw = litw + (int64_t)lane * tstride;
    int64_t start = out_off[lane];
    int64_t end = start + outlens[lane];
    int64_t dst = start;
    int nt = ntok[lane] < tstride ? ntok[lane] : (int)tstride;  // in the row
    bool bad = false;
    for (int base = 0; base < nt && dst < end && !bad; base += 32) {
      int myv = base + j < nt ? tk[base + j] : -1;
      int myw = base + j < nt ? lw[base + j] : 0;
      int m = min(32, nt - base);
      for (int k = 0; k < m && dst < end; k++) {
        int v = __shfl_sync(FULL, myv, k);
        uint32_t w = (uint32_t)__shfl_sync(FULL, myw, k);
        if (v < 0) continue;
        int nl, len = 0, dist = 1;
        if (v < TOK_MATCH) {
          nl = v & 7;
        } else {
          nl = (v >> 25) & 3;
          len = (v >> 16) & 0x1FF;
          dist = (v & 0x7FFF) + 1;
        }
        if (j < nl && dst + j < end) {
          out[dst + j] = j < 4 ? (uint8_t)(w >> (8 * j)) : 0;
        }
        __syncwarp();
        int64_t d = dst + nl;
        if (len && d < end) {
          if (d - dist < lo) {
            bad = true;
            break;
          }
          for (int o = j; o < len && d + o < end; o += 32) {
            out[d + o] = out[d - dist + (o % dist)];
          }
          __syncwarp();
        }
        dst = d + len;
      }
    }
    if (j == 0) counts[lane] = bad ? -1 : (int32_t)(dst - start);
  }
}

}  // namespace

extern "C" int msp_k2_resolve(const void* tok, const void* litw,
                              int64_t tstride, const void* ntok,
                              const void* outlens, const void* out_off,
                              const void* chain_lane0, int nchains, void* out,
                              void* counts, void* stream) {
  if (nchains <= 0) return 0;
  const int threads = 128;  // 4 warps, one chain each
  int blocks = (nchains * 32 + threads - 1) / threads;
  k2_resolve_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)tok, (const int32_t*)litw, tstride,
      (const int32_t*)ntok, (const int32_t*)outlens, (const int64_t*)out_off,
      (const int32_t*)chain_lane0, nchains, (uint8_t*)out,
      (int32_t*)counts);
  return (int)cudaGetLastError();
}
