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
// What bounds it on this card: a serial chain per stream. Each symbol is a
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
//
// A CAB folder is one LZX stream (reset interval 0, cabd.c:1249-1250), so
// one warp a folder left the card almost empty. Where the caller gives a
// folder's CFDATA sizes and each block holds one 32 KiB frame, the folder
// decodes a warp per frame instead (msp_k3_lzx_split; lzx_core.cuh's
// split_seed, frame_target, split_join): a header walk seeds every frame,
// the frames decode at once with R0-R2 as symbols, and a join checks the
// seams and compacts the tokens. A stream whose split fails a check
// decodes serially in the same launch sequence. All passes are this one
// kernel, told apart by a mode argument.
#include <cuda_runtime.h>

#include "launch_info.cuh"
#include "lzx_core.cuh"

static_assert(sizeof(lz::State) % 16 == 0, "records copy as uint4");

// The passes of a launch; all run as this one kernel.
enum { MODE_SERIAL = 0, MODE_SEED = 1, MODE_FRAME = 2, MODE_JOIN = 3 };

__global__ void __launch_bounds__(32)
    k3_lzx_kernel(const uint8_t* __restrict__ streams, int64_t stride,
                  const int32_t* __restrict__ lens,
                  const int32_t* __restrict__ targets,
                  const int32_t* __restrict__ hists, int L, int wbits,
                  int delta, int fresh, lz::State* __restrict__ states,
                  int32_t* __restrict__ tok, int32_t* __restrict__ litw,
                  int32_t cap, int32_t* __restrict__ cnt, int mode,
                  lz::Split sp) {
  __shared__ __align__(16) lz::State s;
  __shared__ lz::Tables T;
  constexpr int W = sizeof(lz::State) / 16;
  const int64_t b = blockIdx.x;
  const int lane = threadIdx.x;
  if (mode == MODE_JOIN) {  // block b: frame b's checks and tokens
    int j = sp.fstream[b], i = sp.lane[j], k = (int)(b - sp.first[j]);
    if (sp.flags[j] & lz::SPLIT_SEED) return;
    int fail = lz::split_join(sp, b, k, sp.first[j + 1] - sp.first[j],
                              targets[i], hists[i], wbits, tok + i * cap,
                              litw + i * cap, cap, cnt, L, i);
    if (fail && lane == 0) atomicOr(sp.flags + j, fail);
    return;
  }
  // the decodes: split stream b's header walk, a decode between each two
  // of its steps (MODE_SEED); frame b from its seed into its scratch row
  // (MODE_FRAME); or row b, unless its split stream decoded it
  // (MODE_SERIAL). One decode_stream call serves all three, so that the
  // decoder is inlined once.
  int64_t i = b, target, stop;
  int j = -1, one_header = 0;
  int32_t *tokp = nullptr, *litwp = nullptr, capv = 0x7FFFFFFF;
  const lz::State* from = nullptr;
  lz::SeedWalk w = {};
  if (mode == MODE_SEED) {
    i = sp.lane[b];
    int f0 = sp.first[b];
    target = targets[i];
    w = lz::seed_walk(target, sp.fstart + f0, sp.first[b + 1] - f0,
                      sp.seeds + f0);
  } else if (mode == MODE_FRAME) {
    j = sp.fstream[b];
    i = sp.lane[j];
    if (sp.flags[j]) return;
    target = lz::frame_target((int)(b - sp.first[j]), targets[i]);
    tokp = sp.ftok + b * lz::FRAME;
    litwp = sp.flitw + b * lz::FRAME;
    capv = lz::FRAME;
    from = sp.seeds + b;
  } else {
    j = sp.split_of ? sp.split_of[i] : -1;
    if (j >= 0 && sp.flags[j] == 0) return;
    target = targets[i];
    tokp = tok + i * cap;
    litwp = litw + i * cap;
    capv = cap;
    from = fresh ? nullptr : states + i;
  }
  stop = target;
  if (from) {
    lz::copy_record(&s, from);
  } else {
    lz::init(s);
  }
  lz::Result r = {lz::ERR_OK, 0, 0, 0, 0, 0};
  while (mode != MODE_SEED || lz::seed_step(w, s, r.err, stop, one_header)) {
    r = lz::decode_stream(streams + i * stride, lens[i], target, stop,
                          one_header, hists[i], wbits, delta, s, T, tokp,
                          litwp, capv);
    if (mode != MODE_SEED) break;
  }
  if (mode == MODE_SEED) {
    if (lane == 0) sp.flags[b] = w.flags;
    return;
  }
  if (mode == MODE_FRAME) {
    lz::put_frame_end(s, r.ntok, sp.ends + b);
    return;
  }
  uint4* rec = reinterpret_cast<uint4*>(states + i);
  const uint4* sh = reinterpret_cast<const uint4*>(&s);
  for (int k = lane; k < W; k += 32) rec[k] = sh[k];
  if (lane == 0) {
    lz::write_counts(cnt, L, i, r);
    if (j >= 0) cnt[6 * L + i] = sp.flags[j];
  }
}

// K3's launch resources (launch_info.cuh): one warp a block, no dynamic
// shared memory.
extern "C" int msp_k3_launch_info(int* out) {
  return launch_info(k3_lzx_kernel, 32, 0, out);
}

extern "C" int64_t msp_k3_state_bytes() { return sizeof(lz::State); }

extern "C" int64_t msp_k3_frame_end_bytes() { return sizeof(lz::FrameEnd); }

static int misaligned(const void* streams, int64_t stride,
                      const void* states) {
  // the bit reader loads aligned words; the records copy as uint4
  return (((uintptr_t)streams | (uintptr_t)stride) & 3) ||
         ((uintptr_t)states & 15);
}

extern "C" int msp_k3_lzx(const void* streams, int64_t stride,
                          const void* lens, const void* targets,
                          const void* hists, int L, int wbits, int delta,
                          int fresh, void* states, void* tok, void* litw,
                          int32_t cap, void* cnt, void* stream) {
  if (L <= 0) return 0;
  if (misaligned(streams, stride, states)) {
    return (int)cudaErrorMisalignedAddress;
  }
  k3_lzx_kernel<<<L, 32, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)streams, stride, (const int32_t*)lens,
      (const int32_t*)targets, (const int32_t*)hists, L, wbits, delta, fresh,
      (lz::State*)states, (int32_t*)tok, (int32_t*)litw, cap,
      (int32_t*)cnt, MODE_SERIAL, lz::Split{});
  return (int)cudaGetLastError();
}

// A fresh, non-DELTA launch in which S streams (meta: lz::make_split)
// split into F frames: the seed pass (a block a split stream), the frame
// pass and the join (a block a frame), then the serial pass over all L
// rows, where a split stream's row returns at once unless its flags are
// set. Four launches in order on one stream; nothing waits between them.
extern "C" int msp_k3_lzx_split(const void* streams, int64_t stride,
                                const void* lens, const void* targets,
                                const void* hists, int L, int wbits,
                                void* states, void* tok, void* litw,
                                int32_t cap, void* cnt, const void* meta,
                                int S, int F, void* seeds, void* ends,
                                void* ftok, void* flitw, void* flags,
                                void* stream) {
  if (L <= 0) return 0;
  if (misaligned(streams, stride, states) || ((uintptr_t)seeds & 15) ||
      ((uintptr_t)ends & 7)) {
    return (int)cudaErrorMisalignedAddress;
  }
  lz::Split sp = lz::make_split((const int32_t*)meta, S, F, seeds, ends,
                                ftok, flitw, flags);
  cudaStream_t st = (cudaStream_t)stream;
  const int modes[4] = {MODE_SEED, MODE_FRAME, MODE_JOIN, MODE_SERIAL};
  const int grid[4] = {S, F, F, L};
  for (int m = 0; m < 4; m++) {
    if (grid[m] <= 0) continue;
    k3_lzx_kernel<<<grid[m], 32, 0, st>>>(
        (const uint8_t*)streams, stride, (const int32_t*)lens,
        (const int32_t*)targets, (const int32_t*)hists, L, wbits, 0, 1,
        (lz::State*)states, (int32_t*)tok, (int32_t*)litw, cap,
        (int32_t*)cnt, modes[m], sp);
    int rc = (int)cudaGetLastError();
    if (rc) return rc;
  }
  return 0;
}
