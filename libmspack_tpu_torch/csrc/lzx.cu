// K3: LZX phase A on Hopper, one warp per stream.
//
// Replaces libmspack_tpu/ops/pallas_lzx.py::_kernel, which decoded 1024
// streams in lockstep, one per VPU lane, as a 21-mode state machine with
// whole-table compares (a TPU lane cannot index a table). Here one warp
// runs the sequential decoder of lzx_core.cuh on one stream and writes its
// tokens, compacted, into row i of a lane-major (L, cap) trace: the layout
// native.lzx_resolve_traces reads, so nothing is transposed. Counts go into
// an (8, L) grid (lzx_core.cuh:write_counts).
//
// Each stream's whole decoder state (trees, code lengths, bit cursor,
// R0-R2, block and frame position, intel state) is one 8800-byte lz::State
// record in device memory, allocated by the wrapper. A launch copies the
// record into shared memory (16 bytes a thread), decodes on it there and
// copies it back, so the record a launch leaves behind is its export and
// passing it to the next launch (fresh = 0) is the import. That is how a
// CAB folder longer than one launch's trace budget decodes in frame-aligned
// segments.
//
// What bounds it on this card: a serial chain per stream. A CAB folder is
// one LZX stream (reset interval 0, cabd.c:1249-1250), so the 96 MiB bench
// cabinet's four folders run on 4 warps of the H100's 132 SMs; a CHM gives
// one stream per ResetTable chunk, hundreds of warps. Each symbol is a
// chain of a bit-buffer peek, a code lookup and the token logic, and each
// symbol's bits depend on the last one's length. The design shortens each
// link: a first-level lookup table per tree (main 12 bits, length 10,
// aligned 7, pretree 8) in shared memory, which the warp fills lane by lane
// when a block header has built the tree, so most symbols take one shared
// load instead of a walk of up to 16 steps through global memory; runs of
// literals decode in a tight loop straight off the main table, its address
// held in a register; the record's trees in shared memory for the longer
// codes; the bit buffer refilled from 32-bit words; the hot scalars in
// registers. What remains per symbol: the refill test, one shared load,
// the shift by the code's length, the literal packing and every fourth
// literal lane 0's token stores; per match the length and aligned tables
// and the checks; per block the serial canonical-code build on lane 0.
// Making it fast (splitting a folder at reset-free block edges, several
// streams a warp) is later work.
#include <cuda_runtime.h>

#include "launch_info.cuh"
#include "lzx_core.cuh"

static_assert(sizeof(lz::State) % 16 == 0, "records copy as uint4");

__global__ void __launch_bounds__(32)
    k3_lzx_kernel(const uint8_t* __restrict__ streams, int64_t stride,
                  const int32_t* __restrict__ lens,
                  const int32_t* __restrict__ targets,
                  const int32_t* __restrict__ hists, int L, int wbits,
                  int delta, int fresh, lz::State* __restrict__ states,
                  int32_t* __restrict__ tok, int32_t* __restrict__ litw,
                  int32_t cap, int32_t* __restrict__ cnt) {
  __shared__ __align__(16) lz::State s;
  __shared__ lz::Tables T;
  constexpr int W = sizeof(lz::State) / 16;
  const int64_t i = blockIdx.x;
  const int lane = threadIdx.x;
  uint4* rec = reinterpret_cast<uint4*>(states + i);
  uint4* sh = reinterpret_cast<uint4*>(&s);
  if (fresh) {
    lz::init(s);
  } else {
    for (int k = lane; k < W; k += 32) sh[k] = rec[k];
    __syncwarp();
  }
  lz::Result r = lz::decode_stream(streams + i * stride, lens[i], targets[i],
                                   hists[i], wbits, delta, s, T,
                                   tok + i * cap, litw + i * cap, cap);
  for (int k = lane; k < W; k += 32) rec[k] = sh[k];
  if (lane == 0) lz::write_counts(cnt, L, i, r);
}

// K3's launch resources (launch_info.cuh): one warp a block, no dynamic
// shared memory.
extern "C" int msp_k3_launch_info(int* out) {
  return launch_info(k3_lzx_kernel, 32, 0, out);
}

extern "C" int64_t msp_k3_state_bytes() { return sizeof(lz::State); }

extern "C" int msp_k3_lzx(const void* streams, int64_t stride,
                          const void* lens, const void* targets,
                          const void* hists, int L, int wbits, int delta,
                          int fresh, void* states, void* tok, void* litw,
                          int32_t cap, void* cnt, void* stream) {
  if (L <= 0) return 0;
  // the bit reader loads aligned words; the records copy as uint4
  if ((((uintptr_t)streams | (uintptr_t)stride) & 3) ||
      ((uintptr_t)states & 15)) {
    return (int)cudaErrorMisalignedAddress;
  }
  k3_lzx_kernel<<<L, 32, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)streams, stride, (const int32_t*)lens,
      (const int32_t*)targets, (const int32_t*)hists, L, wbits, delta, fresh,
      (lz::State*)states, (int32_t*)tok, (int32_t*)litw, cap,
      (int32_t*)cnt);
  return (int)cudaGetLastError();
}
