// K4: Quantum phase A on Hopper, one thread per stream.
//
// Replaces libmspack_tpu/ops/pallas_qtm.py::_kernel, which decoded 1024
// streams in lockstep, one per VPU lane, as a 15-mode state machine: every
// model search a whole-table compare, every division a 28-step restoring
// long division, and the rescales deferred to periodic masked blocks that
// replay the exchange sort from a pair schedule (a TPU lane cannot branch
// or index a table). Here each thread runs the reference codec's
// sequential reader (qtm_core.cuh) on its own stream and writes its
// tokens, compacted, into row i of a lane-major (L, cap) trace: the layout
// native.lzx_resolve_traces reads, so phase B is the LZX resolver with no
// E8. Counts go into an (8, L) grid (qtm_core.cuh:write_counts).
//
// Each lane's whole decoder state (the nine adaptive models with their
// rescale countdowns, the bit cursor, frame_todo and the coder registers)
// is one 2448-byte qt::State record in device memory, allocated by the
// wrapper; the decoder works on it in place, so the record a launch leaves
// behind is its export, and passing it to the next launch (fresh = 0) is
// the import. Segment edges sit on 32 KiB frame starts, where the coder
// re-inits (qtmd.c:430-442), so nothing else carries.
//
// What bounds it on this card: one serial thread per stream. Quantum is a
// sequential adaptive arithmetic decoder, every symbol updating the model
// the next one reads, so a stream has no parallelism inside it
// (pallas_qtm.py:6-9); a CAB Quantum folder is one stream, so the bench
// cabinet's four 6 MiB folders run on 4 threads of the H100's 132 SMs,
// each a chain of dependent divisions, model scans and bit reads with the
// models in global memory (L1-cached). The launch puts one thread in each
// block so that lanes spread over as many SMs as possible. Making it fast
// (models in shared memory or registers, fewer bit-at-a-time
// renormalisations) is later work.
#include <cuda_runtime.h>

#include "qtm_core.cuh"

__global__ void k4_qtm_kernel(const uint8_t* __restrict__ streams,
                              int64_t stride,
                              const int32_t* __restrict__ lens,
                              const int32_t* __restrict__ targets, int L,
                              int wbits, int fresh,
                              qt::State* __restrict__ states,
                              int32_t* __restrict__ tok,
                              int32_t* __restrict__ litw, int32_t cap,
                              int32_t* __restrict__ cnt) {
  int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= L) return;
  qt::State& s = states[i];
  if (fresh) qt::init(s, wbits);
  qt::Result r = qt::decode_stream(streams + i * stride, lens[i], targets[i],
                                   wbits, s, tok + i * cap, litw + i * cap,
                                   cap);
  qt::write_counts(cnt, L, i, r);
}

extern "C" int64_t msp_k4_state_bytes() { return sizeof(qt::State); }

extern "C" int msp_k4_qtm(const void* streams, int64_t stride,
                          const void* lens, const void* targets, int L,
                          int wbits, int fresh, void* states, void* tok,
                          void* litw, int32_t cap, void* cnt, void* stream) {
  if (L <= 0) return 0;
  k4_qtm_kernel<<<L, 1, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)streams, stride, (const int32_t*)lens,
      (const int32_t*)targets, L, wbits, fresh, (qt::State*)states,
      (int32_t*)tok, (int32_t*)litw, cap, (int32_t*)cnt);
  return (int)cudaGetLastError();
}
