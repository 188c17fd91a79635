// P5 redesigned for Hopper: the axis-0 gather from a thread-block
// cluster's distributed shared memory, and the mock symbol step from
// shared memory. probes_gather_core.cuh holds both designs' functions and
// says how they work; the faithful ports stay in probes_micro_gather.cu.
//
// Replaces, beside those ports, the Pallas kernels of tools/micro_gather.py:
//   p5_cluster_kernel  pallas_dyngather_axis0 (pallas_call at :67):
//                      out = take_along_axis(t, i, 0) on int32 (H, L).
//   p5_symbol_smem_kernel  bench_symbol_step (:206): 256 mock DEFLATE
//                      symbol steps a lane.
//
// What bounds them on this card. The gather moves 12 bytes an element
// (memory): the faithful kernel's reads of t touch a 32-byte sector for 4
// useful bytes (8x the sector traffic, bound by L2 throughput once the
// table is cached); here t is read once in whole 16-byte rows into a
// cluster's shared memory (8 blocks hold 512 KiB: a tile at H = 32768),
// and each element then costs one 4-byte read of another SM's shared
// memory (ld.shared::cluster). On the H100 those reads make the kernel
// slower than the faithful one (PERF.md; micro_gather times the reads of
// both). The symbol step is a chain of 256 dependent steps a lane
// (operations): the faithful kernel waits on a load of meta and up to 14
// loads of limit in an early-exit loop each step; here meta is one
// shared-memory load, the limits are thresholds in registers and the
// length find has no branch.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "probes_gather_core.cuh"

namespace cg = cooperative_groups;

namespace {

// One cluster of S blocks a tile: blockIdx.x / S is the tile, the block's
// rank in its cluster the rows it holds.
__global__ void __launch_bounds__(pg::THREADS)
    p5_cluster_kernel(const int32_t* __restrict__ t,
                      const int32_t* __restrict__ idx,
                      int32_t* __restrict__ out, int H, int L) {
  extern __shared__ int4 smem4[];
  int32_t* rows = reinterpret_cast<int32_t*>(smem4);
  cg::cluster_group cluster = cg::this_cluster();
  int32_t S = (int32_t)cluster.num_blocks();
  int32_t rank = (int32_t)cluster.block_rank();
  int32_t tile = (int32_t)(blockIdx.x / S);
  int32_t R = pg::rows_per_rank(H, S);
  pg::load_rows(t, H, L, tile, rank, R, rows, threadIdx.x, blockDim.x);
  pg::async_wait();
  cluster.sync();
  pg::gather_rows(idx, out, H, L, tile, rank, R, threadIdx.x, blockDim.x,
                  pg::RankRows(rows, (int64_t)R * pg::COLS));
  cluster.sync();  // no block leaves while another reads its rows
}

__global__ void __launch_bounds__(pg::STAGE_THREADS)
    p5_symbol_smem_kernel(const int32_t* __restrict__ meta,
                          const int32_t* __restrict__ limit,
                          const uint32_t* __restrict__ words,
                          int32_t* __restrict__ out, int L, int T) {
  extern __shared__ int4 smem4[];
  int32_t* s_meta = reinterpret_cast<int32_t*>(smem4);
  uint32_t* s_words =
      reinterpret_cast<uint32_t*>(s_meta + pg::META_ROWS * pg::LANES);
  int64_t l0 = (int64_t)blockIdx.x * pg::LANES;
  pg::stage(meta, words, L, l0, s_meta, s_words, threadIdx.x, blockDim.x);
  int j = threadIdx.x;
  bool lane = j < pg::LANES && l0 + j < L;
  int32_t lim[15], th[15];
  if (lane) {  // while the copies fly
#pragma unroll
    for (int bl = 1; bl < 15; bl++) lim[bl] = limit[bl * (int64_t)L + l0 + j];
    pg::thresholds(lim, th);
  }
  pg::async_wait();
  __syncthreads();
  if (lane) out[l0 + j] = pg::run(s_meta, s_words, th, j, T);
}

// Clears the runtime's last error and returns rc.
int fail(cudaError_t rc) {
  cudaGetLastError();
  return (int)rc;
}

}  // namespace

// t, idx, out: (H, L) int32, in tiles of pg::COLS columns, each held by a
// cluster of pg::cluster_size(H, L, the card's SMs) blocks, which *S
// receives. cudaErrorInvalidValue where no cluster holds a tile,
// cudaErrorInvalidConfiguration where the card cannot place one.
extern "C" int msp_p5_dyngather_cluster(const void* t, const void* idx,
                                        void* out, int H, int L, int* S,
                                        void* stream) {
  int dev = 0, sms = 0;
  cudaError_t rc = cudaGetDevice(&dev);
  if (rc == cudaSuccess)
    rc = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (rc != cudaSuccess) return fail(rc);
  int s = pg::cluster_size(H, L, sms);
  if (s < 1) return (int)cudaErrorInvalidValue;
  *S = s;
  auto kernel = p5_cluster_kernel;
  static bool ready = false;
  if (!ready) {
    rc = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, pg::SMEM_MAX);
    if (rc != cudaSuccess) return fail(rc);
    ready = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(((L + pg::COLS - 1) / pg::COLS) * s));
  cfg.blockDim = dim3(pg::THREADS);
  cfg.dynamicSmemBytes = (size_t)pg::rows_per_rank(H, s) * pg::COLS * 4;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)s;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  // the clusters this shape can place at once, asked once a shape
  static int last_s = -1, last_bytes = -1, last_n = 0;
  if (s != last_s || (int)cfg.dynamicSmemBytes != last_bytes) {
    int n = 0;
    rc = cudaOccupancyMaxActiveClusters(&n, kernel, &cfg);
    if (rc != cudaSuccess) return fail(rc);
    last_s = s;
    last_bytes = (int)cfg.dynamicSmemBytes;
    last_n = n;
  }
  if (last_n < 1) return fail(cudaErrorInvalidConfiguration);
  rc = cudaLaunchKernelEx(&cfg, kernel, (const int32_t*)t,
                          (const int32_t*)idx, (int32_t*)out, H, L);
  if (rc != cudaSuccess) return fail(rc);
  return (int)cudaGetLastError();
}

// meta: (288, L), limit: (16, L), words: (32, L) uint32; out: (L,) int32;
// pg::LANES lanes a block.
extern "C" int msp_p5_symbol_smem(const void* meta, const void* limit,
                                  const void* words, void* out, int L, int T,
                                  void* stream) {
  if (L <= 0) return 0;
  auto kernel = p5_symbol_smem_kernel;
  static bool ready = false;
  if (!ready) {
    cudaError_t rc = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)pg::SYMBOL_SMEM);
    if (rc != cudaSuccess) return fail(rc);
    ready = true;
  }
  kernel<<<(L + pg::LANES - 1) / pg::LANES, pg::STAGE_THREADS,
           (size_t)pg::SYMBOL_SMEM, (cudaStream_t)stream>>>(
      (const int32_t*)meta, (const int32_t*)limit, (const uint32_t*)words,
      (int32_t*)out, L, T);
  return (int)cudaGetLastError();
}
