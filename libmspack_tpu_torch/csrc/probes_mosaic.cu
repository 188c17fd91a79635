// P4: the mosaic probes on Hopper: nine tiny (8, 128) int32 functions.
//
// Replaces tools/mosaic_probe.py (its pallas_call at :20 for the seven
// registered probes and at :139 for dma_row; smem_scalar :91 was defined
// but never registered). On the TPU each probe bisected one construct of
// the Mosaic compiler; here each is one block of 1024 threads, one thread
// per element, and the CLI holds it against its plain version. What each
// computes, for x of shape (8, 128):
//   reduce_pred  x + 1 where any(x > 0), else the output stays 0
//   cond_vec     where any(x > 0): x if 0 <= x < 8 else -1; else -1
//   while22      3 (a while loop of three steps carrying 21 sums)
//   table_rw     x if 0 <= x < 16 else 0, through a 16-row table
//   stage_store  x where t = x[0, 0] puts it in stage slot 0, row 0
//                (t rem 4 == 0 and floor(t / 4) rem 2 == 0), else 0
//   minscalar    x + min(where(x > 0, x, 99))
//   smem_scalar  x + sm[0, 0] + sm[1, 0] + sm[2, 0] + sm[3, 0]
//   u64shift     the low word of (3 lo : lo) >> (x & 31), lo = x as uint32
//   dma_row      row r of hbm[w] in row r, 0 elsewhere: r = t mod 8 (floor
//                modulo), w = t rem 4 (truncated) where that is >= 0, else
//                48, the slab the JAX body reads in interpret mode (its
//                negative start wraps by 64 and clamps so that 16 slabs
//                fit; on a TPU it is out of range)
// Where the TPU kernel left a value unwritten or read scratch it had not
// written (reduce_pred's output, stage_store's stage[0, 0], dma_row's other
// rows), the port defines it as 0. smem_scalar's table and dma_row's
// (64, 8, 128) source are inputs here: the TPU tool passed neither
// (mosaic_probe.py:91-95, :139-151).
//
// What bounds them: nothing but the launch; each moves 8 KiB.
#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int SL = 8, LN = 128, N = SL * LN;
constexpr unsigned FULL = 0xFFFFFFFFu;

__global__ void reduce_pred(const int32_t* x, const int32_t*, int64_t,
                            int32_t* o) {
  int i = threadIdx.x;
  int32_t v = x[i];
  if (__syncthreads_or(v > 0)) o[i] = v + 1;  // the predicated store
}

__global__ void cond_vec(const int32_t* x, const int32_t*, int64_t,
                         int32_t* o) {
  int i = threadIdx.x;
  int32_t v = x[i], s = -1;
  if (__syncthreads_or(v > 0)) {
    for (int n = 0; n < 8; n++) s = v == n ? n : s;
  }
  o[i] = s;
}

__global__ void while22(const int32_t*, const int32_t*, int64_t, int32_t* o) {
  int32_t st[21] = {0};
  int t = 0;
  while (t < 3) {
    for (int k = 0; k < 21; k++) st[k] += t;
    t++;
  }
  o[threadIdx.x] = st[0];
}

__global__ void table_rw(const int32_t* x, const int32_t*, int64_t,
                         int32_t* o) {
  extern __shared__ int32_t tab[];  // (16, N)
  int i = threadIdx.x;
  int32_t v = x[i];
  for (int n = 0; n < 16; n++) tab[n * N + i] = 0;
  for (int n = 0; n < 16; n++) tab[n * N + i] = v == n ? n : tab[n * N + i];
  int32_t r = 0;
  for (int n = 0; n < 16; n++) r = v == n ? tab[n * N + i] : r;
  o[i] = r;
}

__global__ void stage_store(const int32_t* x, const int32_t*, int64_t,
                            int32_t* o) {
  __shared__ int32_t stage[2][4][N];
  int i = threadIdx.x;
  stage[0][0][i] = 0;
  int32_t t = x[0];
  int32_t row = t % 4;          // lax.rem truncates
  int32_t slot = (t >> 2) % 2;  // t // 4 floors
  if (row >= 0 && slot >= 0) stage[slot][row][i] = x[i];
  o[i] = stage[0][0][i];  // each thread reads only what it wrote
}

__global__ void minscalar(const int32_t* x, const int32_t*, int64_t,
                          int32_t* o) {
  __shared__ int32_t part[N / 32], m;
  int i = threadIdx.x;
  int32_t v = x[i];
  int32_t w = __reduce_min_sync(FULL, v > 0 ? v : 99);
  if ((i & 31) == 0) part[i >> 5] = w;
  __syncthreads();
  if (i < 32) w = __reduce_min_sync(FULL, part[i]);
  if (i == 0) m = w;
  __syncthreads();
  o[i] = v + m;
}

__global__ void smem_scalar(const int32_t* x, const int32_t* sm,
                            int64_t stride, int32_t* o) {
  int i = threadIdx.x;
  int32_t v = x[i];
  for (int n = 0; n < 4; n++) v += __ldg(sm + n * stride);  // one address
  o[i] = v;
}

__global__ void u64shift(const int32_t* x, const int32_t*, int64_t,
                         int32_t* o) {
  int i = threadIdx.x;
  uint32_t lo = (uint32_t)x[i], hi = lo * 3u;
  int32_t k = x[i] & 31;
  uint32_t mid = __funnelshift_r(lo, hi, (uint32_t)min(max(k, 1), 31));
  o[i] = (int32_t)(k == 0 ? lo : (k == 32 ? hi : mid));
}

// hbm: (64, SL, LN); the TPU kernel's row DMA as 16-byte cp.async copies.
__global__ void dma_row(const int32_t* x, const int32_t* hbm, int64_t,
                        int32_t* o) {
  __shared__ __align__(16) int32_t win[16][LN];
  int i = threadIdx.x;
  int32_t t = x[0];
  int r = (t % SL + SL) % SL, w = t % 4;
  if (w < 0) w = 64 - 16;  // slabs w..w+15 lie inside hbm
  if (i < 16 * LN / 4) {
    int j = i / (LN / 4), c = (i % (LN / 4)) * 4;
    __pipeline_memcpy_async(&win[j][c],
                            hbm + ((int64_t)(w + j) * SL + r) * LN + c, 16);
  }
  __pipeline_commit();
  __pipeline_wait_prior(0);
  __syncthreads();
  o[i] = i / LN == r ? win[0][i % LN] : 0;
}

typedef void (*Probe)(const int32_t*, const int32_t*, int64_t, int32_t*);

// in the order of the wrapper's PROBES
const Probe PROBES[] = {reduce_pred, cond_vec,    while22,
                        table_rw,    stage_store, minscalar,
                        smem_scalar, u64shift,    dma_row};

}  // namespace

// x, out: (8, 128) int32, out zeroed by the wrapper; aux: smem_scalar's
// table (row stride `stride`) or dma_row's (64, 8, 128) source, 16-byte
// aligned.
extern "C" int msp_p4_probe(int which, const void* x, const void* aux,
                            int64_t stride, void* out, void* stream) {
  if (which < 0 || which >= (int)(sizeof(PROBES) / sizeof(PROBES[0]))) {
    return (int)cudaErrorInvalidValue;
  }
  Probe fn = PROBES[which];
  size_t smem = fn == table_rw ? 16 * N * sizeof(int32_t) : 0;
  static bool allowed = false;  // set once, before any graph capture
  if (smem && !allowed) {
    cudaError_t e = cudaFuncSetAttribute(
        (const void*)fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
    allowed = true;
  }
  void* args[] = {&x, &aux, &stride, &out};
  cudaError_t e = cudaLaunchKernel((const void*)fn, dim3(1), dim3(N), args,
                                   smem, (cudaStream_t)stream);
  return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
}
