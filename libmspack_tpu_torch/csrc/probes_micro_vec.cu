// P1: a per-lane table search on Hopper, two ways and two placements.
//
// Replaces tools/micro_vec.py::make_kernel (its pallas_call at :83), which
// asked on the TPU whether a per-lane lookup costs less as a row-by-row
// sweep or as one whole-table compare and reduce. Per lane l it fills a
// table tab[n] = (7 l + 13 n) & 0xFFFF (n < R_TAB = 288) and a window
// win[n] = l + n (n < R_WIN = 256), then runs `steps` dependent steps from
// acc = l:
//   key = (5 acc + t) & 0xFFFF,  off = (acc + t) & (R_WIN - 1),
//   sym = the last row n with tab[n] == key,
//   acc = (acc + sym + win[off]) & 0x7FFF.
// With no row equal to key, sym is 0 in the sweep and -1 in the vec variant
// (micro_vec.py:57-59 against :67-68): two different functions, each ported
// as it is.
//
// sweep: one thread per lane walks its R_TAB + R_WIN rows (the TPU kernel's
//        fori loops); 32 lanes in a block.
// vec:   one warp per lane; thread j compares rows j, j + 32, ... and the
//        warp reduces with __reduce_max_sync / __reduce_add_sync (the TPU
//        kernel's whole-table compare and axis-0 reduce); 4 lanes in a block.
// The tables live either in global memory (a scratch buffer the wrapper
// allocates, served from L1/L2) or in shared memory (sweep: 32 lanes x
// (288 + 256) rows x 4 B = 68 KiB a block; vec: 8.5 KiB): the question
// these probes answer for K4's adaptive models, whose searches are this
// shape. Each kernel is built once per placement, so its table accesses
// are shared-memory (LDS/STS) or global (LDG/STG) instructions and not
// generic ones. The fills are not unrolled: a table row is a formula of
// (l, n), and with both fills unrolled nvcc forwards each stored row to its
// compare and never reads a table (tools/sass.py shows it), which would
// time no memory.
//
// What bounds it on this card: latency. A step's key depends on the last
// step's acc, so a lane is a chain of `steps` searches; the only bytes that
// must move are the output's.
//
// registers (p1_reg_kernel, both variants): the redesign for that chain.
// One warp per lane fills its table and window in shared memory as vec
// does (the fill not unrolled), then each thread loads its nine table rows
// into registers once, before the step loop; a step is nine ballots over
// them and one indexed window load (probes_vec.cuh). Loading the rows from
// the filled table, not computing them from the formula, keeps nvcc from
// folding the table into the compares; tools/sass.py should show the
// nine LDS before the loop and, a step, one LDS and nine VOTE in it.
#include <cuda_runtime.h>
#include <stdint.h>

#include "probes_vec.cuh"

namespace {

constexpr unsigned FULL = 0xFFFFFFFFu;
constexpr int R_TAB = 288;       // table rows per lane
constexpr int R_WIN = 256;       // window rows per lane
constexpr int ROWS = R_TAB + R_WIN;
constexpr int SWEEP_LANES = 32;  // lanes (threads) in a sweep block
constexpr int VEC_LANES = 4;     // lanes (warps) in a vec block
// shared memory of a block with its tables there, per variant (the sweep's
// 68 KiB is above the 48 KiB a launch gets by default)
constexpr int SMEM_BYTES[2] = {ROWS * SWEEP_LANES * 4, ROWS * VEC_LANES * 4};

// Row n of lane l's table at tab[n * stride]; the window follows the table.
template <bool SHARED>
__global__ void p1_sweep_kernel(int L, int steps, int32_t* gscratch,
                                int32_t* __restrict__ out) {
  extern __shared__ int32_t smem[];
  int l = blockIdx.x * blockDim.x + threadIdx.x;
  if (l >= L) return;
  int32_t* tab;
  int64_t stride;
  if (SHARED) {
    tab = smem + threadIdx.x;
    stride = blockDim.x;
  } else {
    tab = gscratch + l;
    stride = L;
  }
  int32_t* win = tab + (int64_t)R_TAB * stride;
#pragma unroll 1
  for (int n = 0; n < R_TAB; n++) tab[n * stride] = (l * 7 + n * 13) & 0xFFFF;
#pragma unroll 1
  for (int n = 0; n < R_WIN; n++) win[n * stride] = l + n;
  int32_t acc = l;
  for (int t = 0; t < steps; t++) {
    int32_t key = (acc * 5 + t) & 0xFFFF;
    int32_t off = (acc + t) & (R_WIN - 1);
    int32_t sym = 0;
    for (int n = 0; n < R_TAB; n++) sym = tab[n * stride] == key ? n : sym;
    int32_t wv = 0;
    for (int n = 0; n < R_WIN; n++) wv = off == n ? win[n * stride] : wv;
    acc = (acc + sym + wv) & 0x7FFF;
  }
  out[l] = acc;
}

// Lane l's table at tab[0 .. R_TAB), its window right after it.
template <bool SHARED>
__global__ void p1_vec_kernel(int L, int steps, int32_t* gscratch,
                              int32_t* __restrict__ out) {
  extern __shared__ int32_t smem[];
  int warp = threadIdx.x >> 5, j = threadIdx.x & 31;
  int l = blockIdx.x * VEC_LANES + warp;
  if (l >= L) return;  // the whole warp
  int32_t* tab = SHARED ? smem + warp * ROWS : gscratch + (int64_t)l * ROWS;
  int32_t* win = tab + R_TAB;
#pragma unroll 1
  for (int n = j; n < R_TAB; n += 32) tab[n] = (l * 7 + n * 13) & 0xFFFF;
#pragma unroll 1
  for (int n = j; n < R_WIN; n += 32) win[n] = l + n;
  __syncwarp();
  int32_t acc = l;
  for (int t = 0; t < steps; t++) {
    int32_t key = (acc * 5 + t) & 0xFFFF;
    int32_t off = (acc + t) & (R_WIN - 1);
    int32_t best = -1;  // rows rise, so the last match is the largest
    for (int n = j; n < R_TAB; n += 32) best = tab[n] == key ? n : best;
    int32_t part = 0;
    for (int n = j; n < R_WIN; n += 32) part += off == n ? win[n] : 0;
    int32_t sym = __reduce_max_sync(FULL, best);
    int32_t wv = __reduce_add_sync(FULL, part);
    acc = (acc + sym + wv) & 0x7FFF;
  }
  if (j == 0) out[l] = acc;
}

template <bool SHARED>
cudaError_t launch_p1(int variant, int L, int steps, int32_t* scratch,
                      int32_t* out, cudaStream_t s) {
  int smem = SHARED ? SMEM_BYTES[variant] : 0;
  if (variant == 0) {
    if (SHARED) {
      static bool raised = false;  // once, before any graph capture
      if (!raised) {
        cudaError_t e = cudaFuncSetAttribute(
            p1_sweep_kernel<SHARED>,
            cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
        if (e != cudaSuccess) return e;
        raised = true;
      }
    }
    p1_sweep_kernel<SHARED>
        <<<(L + SWEEP_LANES - 1) / SWEEP_LANES, SWEEP_LANES, smem, s>>>(
            L, steps, scratch, out);
  } else {
    p1_vec_kernel<SHARED>
        <<<(L + VEC_LANES - 1) / VEC_LANES, VEC_LANES * 32, smem, s>>>(
            L, steps, scratch, out);
  }
  return cudaGetLastError();
}

// Lane l's table at tab[0 .. R_TAB), its window right after it, in shared
// memory; the table's rows then in registers.
__global__ void p1_reg_kernel(int L, int steps, int32_t miss,
                              int32_t* __restrict__ out) {
  __shared__ int32_t smem[VEC_LANES * ROWS];
  int w = threadIdx.x >> 5, j = threadIdx.x & 31;
  int l = blockIdx.x * VEC_LANES + w;
  if (l >= L) return;  // the whole warp
  int32_t* tab = smem + w * ROWS;
  int32_t* win = tab + R_TAB;
#pragma unroll 1
  for (int n = j; n < R_TAB; n += 32) tab[n] = (l * 7 + n * 13) & 0xFFFF;
#pragma unroll 1
  for (int n = j; n < R_WIN; n += 32) win[n] = l + n;
  __syncwarp();
  warp::Lanes<int32_t> rows[pv::ROWS_PER_THREAD];
#pragma unroll
  for (int i = 0; i < pv::ROWS_PER_THREAD; i++) {
    rows[i].at(j) = tab[j + 32 * i];
  }
  int32_t acc = l;
  for (int t = 0; t < steps; t++) acc = pv::step(acc, t, rows, win, miss);
  if (j == 0) out[l] = acc;
}

}  // namespace

// variant 0 sweep, 1 vec; tables in registers (p1_reg_kernel).
extern "C" int msp_p1_registers(int variant, int L, int steps, void* out,
                                void* stream) {
  if (L <= 0) return 0;
  if (variant != 0 && variant != 1) return (int)cudaErrorInvalidValue;
  p1_reg_kernel<<<(L + VEC_LANES - 1) / VEC_LANES, VEC_LANES * 32, 0,
                  (cudaStream_t)stream>>>(L, steps, variant ? -1 : 0,
                                          (int32_t*)out);
  return (int)cudaGetLastError();
}

// variant 0 sweep, 1 vec; shared 0: tables in `scratch` (ROWS * L int32),
// 1: in shared memory (scratch unused).
extern "C" int msp_p1_vec(int variant, int shared, int L, int steps,
                          void* scratch, void* out, void* stream) {
  if (L <= 0) return 0;
  if (variant != 0 && variant != 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  return (int)(shared ? launch_p1<true> : launch_p1<false>)(
      variant, L, steps, (int32_t*)scratch, (int32_t*)out, s);
}
