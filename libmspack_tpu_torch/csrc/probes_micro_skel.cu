// P2: the skeleton of a lane-parallel entropy decoder on Hopper.
//
// Replaces tools/micro_skel.py::make_kernel (its pallas_call at :118), which
// timed on the TPU the three cost centres of a per-lane decoder before the
// real kernel was built on them. One thread per lane runs T steps of:
//   1. refill: the lanes (t G + i) mod L, i < G, re-window at their word
//      position wpos (the TPU kernel's round-robin DMA of 64 stream words
//      into VMEM); a lane with at most 31 bits takes the word at wpos from
//      its window (0 when wpos is outside it) into a 64-bit buffer;
//   2. a mock canonical decode: a 14-step length find on the low 15 bits
//      against thresholds (37 bl) mod 97, then a sweep of 288 keys
//      (n * 1315423911) mod 2^20 for the key (length << 16) | code;
//   3. emit: out[t mod 256] = sym + acc, and consume sym mod 15 + 1 bits.
// cnt = acc + wpos at the end.
//
// Where this differs from a C reading of the Pallas code, it follows JAX:
// the key table is taken mod 2^20 of the 32-bit wrapped product (JAX's
// floor modulo of an int32 that wrapped: the low 20 bits), and the refill
// shift w >> (32 - navail) is computed only on the lanes that use it (the
// TPU computes it everywhere, with amounts past 31 that C leaves undefined).
// A window copy started in a step is visible to that step's read, as in
// Pallas interpret mode (the TPU kernel waits on it one step later). A lane
// not yet windowed reads a zero window, where the TPU kernel read
// uninitialised VMEM.
//
// The window is read straight from global memory: a window re-aligned at
// wpos holds stream[l, base .. base + 64), so word wpos - base of it is
// stream[l, wpos], and no copy is made. Each lane reads its own row of the
// (L, W) stream, so a warp's reads are 32 separate sectors.
//
// The mock decode never finds a key: the length find stops at bl = 1
// (peek >> 14 <= 1 < 37), so key is 65536 or 65537, which no n < 288 gives;
// sym is 0 and each step consumes one bit, whatever the stream holds. The
// outputs depend only on the seed and the refill count, and a compiler
// that proves the key range may drop the sweep and the window reads.
//
// What bounds it on this card: latency, the 288-key sweep as written: each
// step depends on the last through the bit buffer and acc.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NKEYS = 288;

__global__ void p2_skel_kernel(const uint32_t* __restrict__ stream, int64_t W,
                               const int32_t* __restrict__ seed, int L, int T,
                               int G, int WIN, int32_t* __restrict__ out,
                               int32_t* __restrict__ cnt) {
  int l = blockIdx.x * blockDim.x + threadIdx.x;
  if (l >= L) return;
  const uint32_t* row = stream + (int64_t)l * W;
  uint32_t bitlo = (uint32_t)seed[l], bithi = 0, acc = (uint32_t)seed[l];
  int32_t navail = 0, wpos = 0, base = 0;
  bool windowed = false;
  for (int t = 0; t < T; t++) {
    int64_t lag = ((int64_t)l - (int64_t)t * G) % L;
    if (L <= G || (lag < 0 ? lag + L : lag) < G) {
      base = wpos;
      windowed = true;
    }
    int32_t off = wpos - base;
    uint32_t w = windowed && off >= 0 && off < WIN ? row[base + off] : 0u;
    if (navail <= 31) {
      if (navail == 0) bitlo = w;
      if (navail > 0) bithi |= w >> (32 - navail);
      navail += 32;
      wpos += 1;
    }
    int32_t peek = (int32_t)(bitlo & 0x7FFF);
    int32_t length = 15, code = 0;
    for (int bl = 1; bl < 15; bl++) {
      int32_t c = peek >> (15 - bl);
      if (c < (bl * 37) % 97) {
        length = bl;
        code = c;
        break;
      }
    }
    int32_t key = (length << 16) | code;
    int32_t sym = 0;
    for (int n = 0; n < NKEYS; n++) {
      sym = key == (int32_t)(((uint32_t)n * 1315423911u) & 0xFFFFFu) ? n
                                                                      : sym;
    }
    uint32_t consume = (uint32_t)(sym % 15 + 1);
    bitlo = (bitlo >> consume) | (bithi << (32 - consume));
    bithi >>= consume;
    navail -= (int32_t)consume;
    out[(int64_t)(t % 256) * L + l] = (int32_t)(acc + (uint32_t)sym);
    acc += (uint32_t)sym;
  }
  cnt[l] = (int32_t)(acc + (uint32_t)wpos);
}

}  // namespace

// stream: (L, W) uint32; seed, cnt: (L,) int32; out: (256, L) int32, rows
// t mod 256 written for t < T. Needs T + WIN <= W (a window never leaves
// its row).
extern "C" int msp_p2_skel(const void* stream_words, int64_t W,
                           const void* seed, int L, int T, int G, int WIN,
                           void* out, void* cnt, void* stream) {
  if (L <= 0) return 0;
  const int threads = 32;  // one warp a block: lanes spread over the SMs
  p2_skel_kernel<<<(L + threads - 1) / threads, threads, 0,
                   (cudaStream_t)stream>>>(
      (const uint32_t*)stream_words, W, (const int32_t*)seed, L, T, G, WIN,
      (int32_t*)out, (int32_t*)cnt);
  return (int)cudaGetLastError();
}
