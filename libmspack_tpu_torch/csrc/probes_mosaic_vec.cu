// P4 redesigned for Hopper: the nine construct probes as single launches
// that write their whole output. probes_mosaic_core.cuh holds the probes'
// functions and says how they work; the faithful port stays in
// probes_mosaic.cu.
//
// Replaces, beside that port, the Pallas kernels of tools/mosaic_probe.py's
// run (pallas_call at :20): p4_reduce_pred_vec, p4_cond_vec_vec,
// p4_while22_vec, p4_table_rw_vec, p4_stage_store_vec, p4_minscalar_vec,
// p4_u64shift_vec; p4_smem_scalar_vec for probe_smem_scalar (:91); and
// p4_dma_row_vec for probe_dma_row (pallas_call at :139).
//
// What bounds them on this card: nothing but the launch; each moves 8 KiB
// or less (dma_row: x[0, 0], one 512-byte row, the output). The faithful
// call is two launches (its wrapper's zero fill, then a block of 1024
// threads with one 4-byte load and store each, and for table_rw 64 KiB of
// dynamic shared memory; dma_row's wrapper also clones a misaligned
// source, and its kernel copies 16 rows into shared memory to read one);
// here it is one block of 256 threads with one 16-byte load and store
// each, scratch in registers, and a warp reduction where the probe needs
// the whole block.
#include <cuda_runtime.h>
#include <stdint.h>

#include "probes_mosaic_core.cuh"

namespace {

constexpr unsigned FULL = 0xFFFFFFFFu;

// One probe P on the block: VEC as pm::vec_path.
template <int P, bool VEC>
__device__ __forceinline__ void probe(const int32_t* __restrict__ x,
                                      const int32_t* __restrict__ sm,
                                      int64_t stride,
                                      int32_t* __restrict__ out) {
  __shared__ int32_t part[pm::WARPS];
  int q = threadIdx.x;
  if (P == pm::DMA_ROW) {  // sm is the (64, 8, 128) source
    int32_t o[pm::QUAD];
    pm::dma_row_quad<VEC>(x, sm, q, o);
    pm::store_quad<VEC>(out, q, o);
    return;
  }
  int32_t v[pm::QUAD] = {0, 0, 0, 0};
  if (P != pm::WHILE22) pm::load_quad<VEC>(x, q, v);
  pm::Block b = pm::block_inputs<P>(x, sm, stride);
  constexpr pm::Reduce R = pm::reduce_of<P>();
  if (R != pm::NONE) {
    int32_t p = pm::partial<P>(v);
    p = R == pm::ANY ? (int32_t)__reduce_or_sync(FULL, (unsigned)p)
                     : __reduce_min_sync(FULL, p);
    if ((q & 31) == 0) part[q >> 5] = p;
    __syncthreads();
    b.red = part[0];
#pragma unroll
    for (int w = 1; w < pm::WARPS; w++)
      b.red = pm::combine<P>(b.red, part[w]);
  }
  int32_t o[pm::QUAD];
#pragma unroll
  for (int u = 0; u < pm::QUAD; u++) o[u] = pm::finish<P>(v[u], b);
  pm::store_quad<VEC>(out, q, o);
}

#define P4_VEC_KERNEL(name, P)                                          \
  template <bool VEC>                                                   \
  __global__ void __launch_bounds__(pm::THREADS)                        \
      p4_##name##_vec(const int32_t* __restrict__ x,                    \
                      const int32_t* __restrict__ sm, int64_t stride,   \
                      int32_t* __restrict__ out) {                      \
    probe<P, VEC>(x, sm, stride, out);                                  \
  }

P4_VEC_KERNEL(reduce_pred, pm::REDUCE_PRED)
P4_VEC_KERNEL(cond_vec, pm::COND_VEC)
P4_VEC_KERNEL(while22, pm::WHILE22)
P4_VEC_KERNEL(table_rw, pm::TABLE_RW)
P4_VEC_KERNEL(stage_store, pm::STAGE_STORE)
P4_VEC_KERNEL(minscalar, pm::MINSCALAR)
P4_VEC_KERNEL(smem_scalar, pm::SMEM_SCALAR)
P4_VEC_KERNEL(u64shift, pm::U64SHIFT)
P4_VEC_KERNEL(dma_row, pm::DMA_ROW)

typedef void (*Kernel)(const int32_t*, const int32_t*, int64_t, int32_t*);

// [VEC][which], in the order of the wrapper's PROBES
const Kernel KERNELS[2][pm::NPROBES] = {
    {p4_reduce_pred_vec<false>, p4_cond_vec_vec<false>,
     p4_while22_vec<false>, p4_table_rw_vec<false>,
     p4_stage_store_vec<false>, p4_minscalar_vec<false>,
     p4_smem_scalar_vec<false>, p4_u64shift_vec<false>,
     p4_dma_row_vec<false>},
    {p4_reduce_pred_vec<true>, p4_cond_vec_vec<true>, p4_while22_vec<true>,
     p4_table_rw_vec<true>, p4_stage_store_vec<true>,
     p4_minscalar_vec<true>, p4_smem_scalar_vec<true>,
     p4_u64shift_vec<true>, p4_dma_row_vec<true>}};

}  // namespace

// x, out: (8, 128) int32, every element of out written; aux: smem_scalar's
// table (row stride `stride`), dma_row's contiguous (64, 8, 128) source,
// or null; any alignment. The 16-byte path where pm::vec_path holds.
extern "C" int msp_p4_probe_vec(int which, const void* x, const void* aux,
                                int64_t stride, void* out, void* stream) {
  if (which < 0 || which >= pm::NPROBES) return (int)cudaErrorInvalidValue;
  bool vec = pm::vec_path(which, x, aux, out);
  void* args[] = {&x, &aux, &stride, &out};
  cudaError_t e = cudaLaunchKernel((const void*)KERNELS[vec][which], dim3(1),
                                   dim3(pm::THREADS), args, 0,
                                   (cudaStream_t)stream);
  return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
}
