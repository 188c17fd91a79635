// P3: a one-frame token copy machine on Hopper, one warp per frame.
//
// Replaces tools/micro_copy.py::make_resolver (its pallas_call at :85),
// the prototype of the TPU's LZ match resolver (K2). Tokens (kind, len,
// dist) run in order from the cursor dst = seed:
//   kind 0, a literal run: out[dst + k] = lit[lsrc + k] for k < len, and
//     lsrc moves on by len;
//   kind != 0, a match: chunks of c = min(rem, 128, avail) elements, each
//     copied from cur - avail to cur, where avail starts at dist and grows
//     by every chunk (the TPU kernel's overlap-safe doubling: a chunk never
//     reads what it writes). Every chunk reads from dst - dist. Once a
//     chunk is cut at 128, the span copied so far need not be a whole
//     number of periods, and the chunks after it leave LZ77's copy; the
//     probe's own matches are shorter than 128 (micro_copy.py:111), where
//     the two agree.
// sc = the final dst. The elements are int32, one per byte.
//
// As in K2 (resolve.cu), the warp shuffles each token out of a 32-token
// register tile, and its 32 threads copy 32 elements a step; a chunk's
// reads all lie before its writes, and __syncwarp orders one chunk's writes
// before the next chunk's reads. Literal runs are copied whole: their
// 128-element chunks on the TPU are a vector width, not part of the
// function.
//
// What bounds it on this card: the serial walk over tokens on one warp
// (each token's position depends on every one before it); the bytes moved
// are a few hundred KiB.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned FULL = 0xFFFFFFFFu;
constexpr int V = 128;  // the TPU kernel's chunk: one vector row

__global__ void p3_copy_kernel(const int32_t* __restrict__ seed,
                               const int32_t* __restrict__ tok, int nt,
                               const int32_t* __restrict__ lit, int32_t* out,
                               int32_t* __restrict__ sc) {
  int j = threadIdx.x;
  int32_t dst = seed[0], lsrc = 0;
  for (int base = 0; base < nt; base += 32) {
    int k = base + j;
    int32_t mk = 0, ml = 0, md = 0;
    if (k < nt) {
      mk = tok[3 * k];
      ml = tok[3 * k + 1];
      md = tok[3 * k + 2];
    }
    int m = min(32, nt - base);
    for (int q = 0; q < m; q++) {
      int32_t kind = __shfl_sync(FULL, mk, q);
      int32_t len = __shfl_sync(FULL, ml, q);
      int32_t dist = __shfl_sync(FULL, md, q);
      if (kind == 0) {
        for (int o = j; o < len; o += 32) out[dst + o] = lit[lsrc + o];
        lsrc += len;
      } else {
        int32_t cur = dst, rem = len, avail = dist;
        while (rem > 0) {
          int32_t c = min(min(rem, V), avail);
          for (int o = j; o < c; o += 32) out[cur + o] = out[cur - avail + o];
          __syncwarp();
          cur += c;
          rem -= c;
          avail += c;
        }
      }
      __syncwarp();
      dst += len;
    }
  }
  if (j == 0) sc[0] = dst;
}

}  // namespace

// tok: (nt, 3) int32; lit, out: flat int32; seed, sc: (1,) int32. The
// wrapper checks that every read and write stays inside lit and out.
extern "C" int msp_p3_copy(const void* seed, const void* tok, int nt,
                           const void* lit, void* out, void* sc,
                           void* stream) {
  p3_copy_kernel<<<1, 32, 0, (cudaStream_t)stream>>>(
      (const int32_t*)seed, (const int32_t*)tok, nt, (const int32_t*)lit,
      (int32_t*)out, (int32_t*)sc);
  return (int)cudaGetLastError();
}
