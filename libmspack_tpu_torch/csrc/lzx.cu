// K3: LZX phase A on Hopper, one thread per stream.
//
// Replaces libmspack_tpu/ops/pallas_lzx.py::_kernel, which decoded 1024
// streams in lockstep, one per VPU lane, as a 21-mode state machine with
// whole-table compares (a TPU lane cannot index a table). Here each thread
// runs the sequential decoder of lzx_core.cuh on its own stream and writes
// its tokens, compacted, into row i of a lane-major (L, cap) trace: the
// layout native.lzx_resolve_traces reads, so nothing is transposed. Counts
// go into an (8, L) grid (lzx_core.cuh:write_counts).
//
// Each lane's whole decoder state (trees, code lengths, bit cursor, R0-R2,
// block and frame position, intel state) is one 8800-byte lz::State record
// in device memory, allocated by the wrapper; the decoder works on it in
// place, so the record a launch leaves behind is its export, and passing it
// to the next launch (fresh = 0) is the import. That is how a CAB folder
// longer than one launch's trace budget decodes in frame-aligned segments.
//
// What bounds it on this card: one serial thread per stream. A CAB folder
// is one LZX stream (reset interval 0, cabd.c:1249-1250), so the 96 MiB
// bench cabinet's four folders run on 4 threads of the H100's 132 SMs,
// each a chain of dependent bit-buffer refills and table reads from
// global memory (the tables stay in the state record, served by L1). A
// CHM gives one stream per ResetTable chunk, hundreds of lanes. The launch
// puts one thread in each block so that those lanes spread over as many
// SMs as possible (fastest at 4 lanes as at 256; PERF.md). Making it fast
// (table lookups in shared memory, splitting a folder at reset-free block
// edges) is later work.
#include <cuda_runtime.h>

#include "lzx_core.cuh"

__global__ void k3_lzx_kernel(const uint8_t* __restrict__ streams,
                              int64_t stride,
                              const int32_t* __restrict__ lens,
                              const int32_t* __restrict__ targets,
                              const int32_t* __restrict__ hists, int L,
                              int wbits, int delta, int fresh,
                              lz::State* __restrict__ states,
                              int32_t* __restrict__ tok,
                              int32_t* __restrict__ litw, int32_t cap,
                              int32_t* __restrict__ cnt) {
  int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= L) return;
  lz::State& s = states[i];
  if (fresh) lz::init(s);
  lz::Result r = lz::decode_stream(streams + i * stride, lens[i], targets[i],
                                   hists[i], wbits, delta, s, tok + i * cap,
                                   litw + i * cap, cap);
  lz::write_counts(cnt, L, i, r);
}

extern "C" int64_t msp_k3_state_bytes() { return sizeof(lz::State); }

extern "C" int msp_k3_lzx(const void* streams, int64_t stride,
                          const void* lens, const void* targets,
                          const void* hists, int L, int wbits, int delta,
                          int fresh, void* states, void* tok, void* litw,
                          int32_t cap, void* cnt, void* stream) {
  if (L <= 0) return 0;
  k3_lzx_kernel<<<L, 1, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)streams, stride, (const int32_t*)lens,
      (const int32_t*)targets, (const int32_t*)hists, L, wbits, delta, fresh,
      (lz::State*)states, (int32_t*)tok, (int32_t*)litw, cap,
      (int32_t*)cnt);
  return (int)cudaGetLastError();
}
