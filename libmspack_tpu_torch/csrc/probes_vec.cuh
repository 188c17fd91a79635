// P1 redesigned: the per-lane key search as a warp ballot over table rows
// held in registers (probes_micro_vec.cu's p1_reg_kernel).
//
// One warp per lane; thread j holds the lane's table rows j + 32 i, i <
// ROWS_PER_THREAD (288 = 9 x 32), in registers, loaded once from the table
// it filled in shared memory. A step compares the key with the nine rows,
// takes a ballot of each compare, and the last matching row is 32 i + 31 -
// clz(b) for the highest i with b != 0: nine independent votes, a select
// chain that keeps the highest nonzero ballot, and one clz (one clz per
// ballot measured slower on the H100: PERF.md), no pass over memory
// and no reduction. The window value is one load, win[off], the same
// address in every thread (a broadcast).
//
// The step is written once for the kernel and for a host twin that g++
// builds from this header (define PROBES_VEC_HOST_TWIN): the rows are
// warp::Lanes, one value a thread on the card and 32 in the twin, where
// warp::ballot evaluates the compare for lanes 0..31 in turn
// (stream_core.cuh).
#pragma once

#include "stream_core.cuh"

namespace pv {

constexpr int R_TAB = 288;  // table rows per lane
constexpr int R_WIN = 256;  // window rows per lane
constexpr int ROWS_PER_THREAD = R_TAB / 32;

// One dependent step of a lane: acc after step t. rows[i] is row 32 i +
// (the thread's lane); miss is sym where no row equals the key (the sweep's
// 0, the vec variant's -1).
SC_FN int32_t step(int32_t acc, int32_t t,
                   const warp::Lanes<int32_t>* rows, const int32_t* win,
                   int32_t miss) {
  int32_t key = (acc * 5 + t) & 0xFFFF;
  int32_t off = (acc + t) & (R_WIN - 1);
  uint32_t top = 0;
  int32_t base = 0;
#ifdef __CUDA_ARCH__
#pragma unroll
#endif
  for (int i = 0; i < ROWS_PER_THREAD; i++) {
    uint32_t b =
        warp::ballot([&](int lane) { return rows[i].at(lane) == key; });
    if (b) {
      top = b;
      base = 32 * i + 31;
    }
  }
  int32_t sym = top ? base - warp::clz32(top) : miss;
  return (acc + sym + win[off]) & 0x7FFF;
}

}  // namespace pv

#ifdef PROBES_VEC_HOST_TWIN
// The kernel's function for lanes 0..L-1, one lane after another, each
// with its 32 threads emulated: out[l] = lane l's acc after `steps` steps.
extern "C" int pv_search_host(int32_t miss, int L, int steps, int32_t* out) {
  int32_t tab[pv::R_TAB], win[pv::R_WIN];
  warp::Lanes<int32_t> rows[pv::ROWS_PER_THREAD];
  for (int l = 0; l < L; l++) {
    for (int n = 0; n < pv::R_TAB; n++) tab[n] = (l * 7 + n * 13) & 0xFFFF;
    for (int n = 0; n < pv::R_WIN; n++) win[n] = l + n;
    for (int i = 0; i < pv::ROWS_PER_THREAD; i++) {
      warp::each([&](int j) { rows[i].at(j) = tab[j + 32 * i]; });
    }
    int32_t acc = l;
    for (int t = 0; t < steps; t++) acc = pv::step(acc, t, rows, win, miss);
    out[l] = acc;
  }
  return 0;
}
#endif
