// Device helpers shared by the gather probes P5 (probes_micro_gather.cu) and
// P6 (probes_micro_gather2.cu). Tables are (rows, L) int32, row n of lane l
// at n * L + l, so a warp's 32 lanes read 128 contiguous bytes of a row.
#pragma once

#include <stdint.h>

namespace probes {

// The TPU kernels' mask-sum probe: tab[idx, l] found by comparing idx with
// every row n < N and keeping the last match; 0 when idx is not a row.
__device__ __forceinline__ int32_t masksum_sweep(
    const int32_t* __restrict__ tab, int64_t L, int64_t l, int32_t idx,
    int N) {
  int32_t acc = 0;
  for (int n = 0; n < N; n++) acc = idx == n ? tab[n * L + l] : acc;
  return acc;
}

// The mock canonical length find: the first bl in 1..14 whose code
// peek >> (15 - bl) lies below the lane's limit[bl], else length 15 and
// code 0.
__device__ __forceinline__ void len_find(int32_t peek,
                                         const int32_t* __restrict__ limit,
                                         int64_t L, int64_t l,
                                         int32_t& length, int32_t& code) {
  length = 15;
  code = 0;
  for (int bl = 1; bl < 15; bl++) {
    int32_t c = peek >> (15 - bl);
    if (c < limit[bl * L + l]) {
      length = bl;
      code = c;
      return;
    }
  }
}

}  // namespace probes
