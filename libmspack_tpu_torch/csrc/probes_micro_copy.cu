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
//
// p3_par_kernel, the same function as a block-parallel resolve, one block
// of 1024 threads for the frame (probes_copy_core.cuh says how): the
// tokens a tile of 1024 at a time, each tile's starts and literal offsets
// from block scans, each position's token from a segmented max-scan, each
// position's immediate source from its chunk, then pointer jumping over the
// frame's sources in 129 KiB of shared memory and one pass that writes the
// frame. Its chain is a few scans a tile and at most ceil(log2 33024) = 16
// rounds of jumping (the bit length of the longest chain of copies: 4 in
// the tool's frame, whose chains are 8-15 copies deep), where p3_copy's is
// the token walk; each round reads every position's source once.
#include <cuda_runtime.h>
#include <stdint.h>

#include "probes_copy_core.cuh"

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

// Block-wide exclusive scan of x under op (identity id) over the 1024
// threads; total gets the scan of all of them. wsum: 32 ints of shared
// memory, free again when it returns.
template <class Op>
__device__ __forceinline__ int32_t block_scan(int32_t x, int32_t id, Op op,
                                              int32_t* wsum,
                                              int32_t& total) {
  int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  int32_t inc = x;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    int32_t y = __shfl_up_sync(FULL, inc, d);
    if (lane >= d) inc = op(inc, y);
  }
  if (lane == 31) wsum[w] = inc;
  __syncthreads();
  if (w == 0) {
    int32_t s = wsum[lane];
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      int32_t y = __shfl_up_sync(FULL, s, d);
      if (lane >= d) s = op(s, y);
    }
    wsum[lane] = s;
  }
  __syncthreads();
  int32_t before = w ? wsum[w - 1] : id;
  int32_t mine = __shfl_up_sync(FULL, inc, 1);
  total = wsum[31];
  __syncthreads();
  return op(before, lane ? mine : id);
}

struct Add {
  __device__ int32_t operator()(int32_t a, int32_t b) const { return a + b; }
};
struct Max {
  __device__ int32_t operator()(int32_t a, int32_t b) const {
    return a > b ? a : b;
  }
};

// Dynamic shared memory: the sources, then a tile's starts and args, then
// the scans' 32 words.
constexpr int PAR_SMEM = (pc::MAX_POS + 2 * pc::THREADS + 32) * 4;

__global__ void __launch_bounds__(pc::THREADS)
    p3_par_kernel(const int32_t* __restrict__ seed,
                  const int32_t* __restrict__ tok, int nt,
                  const int32_t* __restrict__ lit, int32_t* __restrict__ out,
                  int32_t* __restrict__ sc, int32_t n) {
  extern __shared__ int32_t smem[];
  int32_t* src = smem;
  int32_t* t_start = src + pc::MAX_POS;
  int32_t* t_arg = t_start + pc::THREADS;
  int32_t* wsum = t_arg + pc::THREADS;
  int t = threadIdx.x;
  for (int32_t p = t; p < n; p += pc::THREADS) src[p] = pc::ZERO;
  int32_t dst = seed[0], lsrc = 0;
  const int32_t lo = dst;
  for (int base = 0; base < nt; base += pc::THREADS) {
    // step 1: the token's start and literal offset from the block's scans
    int32_t kind, len, dist, span, lspan;
    pc::token(tok, nt, base + t, kind, len, dist);
    int32_t start = dst + block_scan(len, 0, Add(), wsum, span);
    int32_t loff = block_scan(kind == 0 ? len : 0, 0, Add(), wsum, lspan);
    pc::mark_token(src, t_start, t_arg, t, kind, len, dist, start,
                   lsrc + loff);
    __syncthreads();
    // steps 2-3: each position's token, then its source
    int32_t a, b, top;
    pc::segment(t, dst, dst + span, a, b);
    int32_t own = block_scan(pc::seg_max(src, a, b), pc::ZERO, Max(), wsum,
                             top);
    pc::seg_resolve(src, a, b, own, t_start, t_arg);
    __syncthreads();  // before the next tile's starts and marks
    dst += span;
    lsrc += lspan;
  }
  // step 4: pointer jumping until every source is a root
  while (__syncthreads_or(pc::jump(src, lo, dst, t))) {
  }
  pc::emit(src, n, lit, out, t);
  if (t == 0) sc[0] = dst;
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

// p3_par_kernel on the same arguments; n: out's elements, at most
// pc::MAX_POS (every one is written).
extern "C" int msp_p3_copy_par(const void* seed, const void* tok, int nt,
                               const void* lit, void* out, void* sc, int n,
                               void* stream) {
  if (n <= 0 || n > pc::MAX_POS) return (int)cudaErrorInvalidValue;
  static bool raised = false;  // once, before any graph capture
  if (!raised) {
    cudaError_t e = cudaFuncSetAttribute(
        p3_par_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        PAR_SMEM);
    if (e != cudaSuccess) return (int)e;
    raised = true;
  }
  p3_par_kernel<<<1, pc::THREADS, PAR_SMEM, (cudaStream_t)stream>>>(
      (const int32_t*)seed, (const int32_t*)tok, nt, (const int32_t*)lit,
      (int32_t*)out, (int32_t*)sc, n);
  return (int)cudaGetLastError();
}
