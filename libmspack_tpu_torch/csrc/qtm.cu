// K4: Quantum phase A on Hopper, one warp per stream.
//
// Replaces libmspack_tpu/ops/pallas_qtm.py::_kernel, which decoded 1024
// streams in lockstep, one per VPU lane, as a 15-mode state machine: every
// model search a whole-table compare, every division a 28-step restoring
// long division, and the rescales deferred to periodic masked blocks that
// replay the exchange sort from a pair schedule (a TPU lane cannot branch
// or index a table). Here one warp runs the reference codec's sequential
// reader (qtm_core.cuh) on one stream and writes its tokens, compacted,
// into row i of a lane-major (L, cap) trace: the layout
// native.lzx_resolve_traces reads, so phase B is the LZX resolver with no
// E8. Counts go into an (8, L) grid (qtm_core.cuh:write_counts).
//
// Each stream's whole decoder state (the nine adaptive models with their
// rescale countdowns, the bit cursor, frame_todo and the coder registers)
// is one 2448-byte qt::State record in device memory, allocated by the
// wrapper. A launch copies the record into shared memory (16 bytes a
// thread), decodes on it there and copies it back, so the record a launch
// leaves behind is its export and passing it to the next launch (fresh =
// 0) is the import. Segment edges sit on 32 KiB frame starts, where the
// coder re-inits (qtmd.c:430-442), so nothing else carries.
//
// What bounds it on this card: a serial chain per stream. Quantum is a
// sequential adaptive arithmetic decoder, every symbol updating the model
// the next one reads, so a stream has no parallelism between symbols
// (pallas_qtm.py:6-9), and a CAB Quantum folder is one stream: the bench
// cabinet's four 6 MiB folders run on 4 warps of the H100's 132 SMs. In
// the reference codec's reader a symbol is a chain of a 32-bit division
// for the search value, a linear search, two more divisions for the new
// bounds, the +8 update and a renormalisation one bit at a time. The
// design shortens each link: the
// models live in shared memory, so a load after the warp's own store is a
// shared-memory access; the search is two ballots over the model's rows
// (lane l holds rows l and l + 32) that compare cum[k] * span with the
// scaled code value, so no division comes before it; each lane divides for
// its own rows' bounds beside the search, and two shuffles fetch rows
// i - 1 and i; the +8 update is one store a lane, the halving rescale a
// suffix max over the warp; the renormalisation takes all its bits at once
// in closed form from a reader refilled by 32-bit words; a literal's model
// rows are loaded beside the selector's symbol; the coder registers,
// cursor, outpos and frame_todo stay in registers. What remains per
// symbol: the votes, shuffles and divisions of that chain, the
// renormalisation's dependent shifts and counts, the model's shared loads
// and stores, and the serial exchange sort at the fourth and every 50th
// rescale. Making it fast (splitting a folder, several streams a warp) is
// later work.
#include <cuda_runtime.h>

#include "launch_info.cuh"
#include "qtm_core.cuh"

static_assert(sizeof(qt::State) % 16 == 0, "records copy as uint4");

__global__ void __launch_bounds__(32)
    k4_qtm_kernel(const uint8_t* __restrict__ streams, int64_t stride,
                  const int32_t* __restrict__ lens,
                  const int32_t* __restrict__ targets, int L, int wbits,
                  int fresh, qt::State* __restrict__ states,
                  int32_t* __restrict__ tok, int32_t* __restrict__ litw,
                  int32_t cap, int32_t* __restrict__ cnt) {
  __shared__ __align__(16) qt::State s;
  constexpr int W = sizeof(qt::State) / 16;
  const int64_t i = blockIdx.x;
  const int lane = threadIdx.x;
  uint4* rec = reinterpret_cast<uint4*>(states + i);
  uint4* sh = reinterpret_cast<uint4*>(&s);
  if (fresh) {
    qt::init(s, wbits);
  } else {
    for (int k = lane; k < W; k += 32) sh[k] = rec[k];
    __syncwarp();
  }
  qt::Result r = qt::decode_stream(streams + i * stride, lens[i], targets[i],
                                   wbits, s, tok + i * cap, litw + i * cap,
                                   cap);
  for (int k = lane; k < W; k += 32) rec[k] = sh[k];
  if (lane == 0) qt::write_counts(cnt, L, i, r);
}

// K4's launch resources (launch_info.cuh): one warp a block, no dynamic
// shared memory.
extern "C" int msp_k4_launch_info(int* out) {
  return launch_info(k4_qtm_kernel, 32, 0, out);
}

extern "C" int64_t msp_k4_state_bytes() { return sizeof(qt::State); }

extern "C" int msp_k4_qtm(const void* streams, int64_t stride,
                          const void* lens, const void* targets, int L,
                          int wbits, int fresh, void* states, void* tok,
                          void* litw, int32_t cap, void* cnt, void* stream) {
  if (L <= 0) return 0;
  // the bit reader loads aligned words; the records copy as uint4
  if ((((uintptr_t)streams | (uintptr_t)stride) & 3) ||
      ((uintptr_t)states & 15)) {
    return (int)cudaErrorMisalignedAddress;
  }
  k4_qtm_kernel<<<L, 32, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)streams, stride, (const int32_t*)lens,
      (const int32_t*)targets, L, wbits, fresh, (qt::State*)states,
      (int32_t*)tok, (int32_t*)litw, cap, (int32_t*)cnt);
  return (int)cudaGetLastError();
}
