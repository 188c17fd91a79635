// P6 redesigned: the mask-sum as a direct vectorised gather, and the
// chained symbol step with its word window in shared memory
// (probes_gather2_smem.cu's kernels); P5's mask-sum
// (probes_gather_row.cu's p5_masksum_vec_kernel) runs the same core.
//
// The mask-sum, out[l] = (tab[idx[l], l] + idx[l]) mod N (the probe 0 where
// idx[l] is not a row, the int32 sum wrapping, a floor modulo; P5's is the
// probe alone: the template flag MOD): a thread
// takes MASK_LANES = 4 adjacent lanes, one 16-byte load of idx, four
// independent guarded loads of tab (no sweep over the rows) and one 16-byte
// store; lanes past the last whole 4 and inputs that are not 16-byte
// aligned take the same function a lane at a time.
//
// The symbol step (probes_micro_gather2.cu's p6_symbol_kernel, bit for bit):
// a block of pg::LANES lanes copies its lanes' 32-row word window into
// shared memory, (row, lane) with lane j in column j, so the refill at row
// acc & 31, which depends on the last step's meta, is one shared-memory
// load in bank j mod 32 whatever the rows a warp's lanes ask for. The
// lane's limits become thresholds in registers (pg::thresholds); the length
// find exits at bl = 1 where peek < th[1] (length 1, code peek >> 14, meta
// row 7 or 8) and otherwise counts its compares (pg::len_find). meta is
// read through L1 (staged in shared memory too, 80 KiB a block, it ran
// slower: PERF.md).
//
// The same functions run in the kernels and in a host twin that g++ builds
// from this header (define PROBES_GATHER2_CORE_HOST_TWIN): the twin runs a
// block's threads one after another.
#pragma once

#include "probes_gather_core.cuh"

namespace pg2 {

constexpr int MASK_LANES = 4;       // lanes a mask-sum thread
constexpr int MASK_THREADS = 64;    // threads a mask-sum block (128 and
                                    // 256 ran no faster: PERF.md)
constexpr int META_ROWS = 288;
constexpr int WORD_ROWS = 32;

using pg::ldg;

// s mod N rounded to the floor (N >= 1): one compare and subtract where
// 0 <= s < 2 N, else the remainder made non-negative.
SC_FN int32_t floor_mod(int32_t s, int32_t N) {
  if ((uint32_t)s < 2u * (uint32_t)N) return s >= N ? s - N : s;
  int32_t r = s % N;
  return r < 0 ? r + N : r;
}

// One lane: tab[i, l] where 0 <= i < N (else 0); with MOD (P6) plus i as
// int32, mod N, without it (P5) the probe alone.
template <bool MOD>
SC_FN int32_t masksum_value(int32_t a, int32_t i, int32_t N) {
  return MOD ? floor_mod((int32_t)((uint32_t)a + (uint32_t)i), N) : a;
}

template <bool MOD>
SC_FN int32_t masksum_lane(const int32_t* tab, int64_t L, int64_t l,
                           int32_t i, int32_t N) {
  int32_t a = (uint32_t)i < (uint32_t)N ? ldg(tab + i * L + l) : 0;
  return masksum_value<MOD>(a, i, N);
}

// Thread q's lanes [4 q, 4 q + 4) of L. vec: idx and out are 16-byte
// aligned, so a whole quad is one load and one store.
template <bool MOD>
SC_FN void masksum_quad(const int32_t* tab, const int32_t* idx, int32_t* out,
                        int32_t N, int64_t L, int64_t q, bool vec) {
  int64_t l0 = q * MASK_LANES;
  if (l0 >= L) return;
  if (vec && l0 + MASK_LANES <= L) {
    int32_t v[MASK_LANES], a[MASK_LANES];
    pg::load16(v, idx + l0);
#ifdef __CUDA_ARCH__
#pragma unroll
#endif
    for (int u = 0; u < MASK_LANES; u++)
      a[u] = (uint32_t)v[u] < (uint32_t)N ? ldg(tab + v[u] * L + l0 + u) : 0;
#ifdef __CUDA_ARCH__
#pragma unroll
#endif
    for (int u = 0; u < MASK_LANES; u++)
      v[u] = masksum_value<MOD>(a[u], v[u], N);
    pg::store16(out + l0, v);
    return;
  }
  for (int64_t l = l0; l < L && l < l0 + MASK_LANES; l++)
    out[l] = masksum_lane<MOD>(tab, L, l, idx[l], N);
}

SC_FN uint32_t rotr(uint32_t x, uint32_t n) {
#ifdef __CUDA_ARCH__
  return __funnelshift_r(x, x, n);
#else
  n &= 31u;
  return n ? (x >> n) | (x << (32u - n)) : x;
#endif
}

// The length find with an early exit at bl = 1 (probes::len_find's first
// iteration: peek >> 14 < lim[1] exactly where peek < th[1]), else the
// count of pg::len_find; returns the meta row (code + 7 length) mod 288.
SC_FN uint32_t meta_row(int32_t peek, const int32_t* th, int32_t& length) {
  if (peek < th[1]) {
    length = 1;
    return (uint32_t)(peek >> 14) + 7u;  // code 0 or 1: rows 7 and 8
  }
  int32_t code;
  pg::len_find(peek, th, length, code);
  return (uint32_t)(code + length * 7) % (uint32_t)META_ROWS;
}

// One lane's T steps from the seed x: lane j of its block, its word window
// in s_words (WORD_ROWS x pg::LANES), meta (META_ROWS, L) in device memory
// at column l, read through L1, thresholds th. Returns acc + bitbuf.
SC_FN int32_t run(const uint32_t* s_words, const int32_t* meta, int64_t L,
                  int64_t l, const int32_t* th, int j, uint32_t x, int T) {
  uint32_t bitbuf = x, acc = x;
  const int32_t* col = meta + l;
  for (int t = 0; t < T; t++) {
    bitbuf ^= s_words[(acc & 31u) * pg::LANES + j];
    int32_t length;
    uint32_t row = meta_row((int32_t)(bitbuf & 0x7FFFu), th, length);
    int32_t m = ldg(col + row * L);
    bitbuf = rotr(bitbuf, (uint32_t)(length + (m & 7)) & 31u);
    acc += (uint32_t)m;
  }
  return (int32_t)(acc + bitbuf);
}

}  // namespace pg2

#ifdef PROBES_GATHER2_CORE_HOST_TWIN
#include <vector>

// msp_p6_masksum_vec's (MOD) or msp_p5_masksum_vec's function on host
// pointers: tab (N, L); idx, out (L,).
template <bool MOD>
static void masksum_host(const int32_t* tab, const int32_t* idx,
                         int32_t* out, int N, int L) {
  bool vec = pg::aligned16(idx) && pg::aligned16(out);
  for (int64_t q = 0; q * pg2::MASK_LANES < L; q++)
    pg2::masksum_quad<MOD>(tab, idx, out, N, L, q, vec);
}

extern "C" void pg2_masksum_host(const int32_t* tab, const int32_t* idx,
                                 int32_t* out, int N, int L) {
  masksum_host<true>(tab, idx, out, N, L);
}

extern "C" void pg2_masksum_p5_host(const int32_t* tab, const int32_t* idx,
                                    int32_t* out, int N, int L) {
  masksum_host<false>(tab, idx, out, N, L);
}

// The early-exit length find on n lanes: peek (n,), limit (16, n).
extern "C" void pg2_len_find_host(const int32_t* peek, const int32_t* limit,
                                  int n, int32_t* length, int32_t* row) {
  for (int l = 0; l < n; l++) {
    int32_t lim[15], th[15];
    for (int bl = 1; bl < 15; bl++) lim[bl] = limit[bl * n + l];
    pg::thresholds(lim, th);
    row[l] = (int32_t)pg2::meta_row(peek[l], th, length[l]);
  }
}

// msp_p6_symbol_smem's function on host pointers, block by block: meta
// (288, L), limit (16, L), words (32, L); x, out (L,).
extern "C" void pg2_symbol_host(const int32_t* meta, const int32_t* limit,
                                const uint32_t* words, const int32_t* x,
                                int32_t* out, int L, int T) {
  std::vector<uint32_t> s_words((size_t)pg2::WORD_ROWS * pg::LANES);
  for (int64_t l0 = 0; l0 < L; l0 += pg::LANES) {
    pg::stage_rows(reinterpret_cast<const int32_t*>(words), pg2::WORD_ROWS,
                   L, l0, reinterpret_cast<int32_t*>(s_words.data()), 0, 1);
    for (int j = 0; j < pg::LANES && l0 + j < L; j++) {
      int32_t lim[15], th[15];
      for (int bl = 1; bl < 15; bl++)
        lim[bl] = limit[bl * (int64_t)L + l0 + j];
      pg::thresholds(lim, th);
      out[l0 + j] = pg2::run(s_words.data(), meta, L, l0 + j, th, j,
                             (uint32_t)x[l0 + j], T);
    }
  }
}
#endif
