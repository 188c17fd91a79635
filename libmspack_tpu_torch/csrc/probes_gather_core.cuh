// P5 redesigned: the axis-0 gather with its table in a thread-block
// cluster's distributed shared memory, and the mock symbol step run from
// shared memory (probes_gather_cluster.cu's kernels); the axis-1 gather
// from a row staged in shared memory (probes_gather_row.cu).
//
// The gather, out[h, l] = t[clamp(idx[h, l], 0, H - 1), l] on int32 (H, L)
// (probes_micro_gather.cu's p5_dyngather_kernel gives a thread to each
// element; consecutive threads then read t from rows 4 L bytes apart, a
// 32-byte sector for 4 useful bytes). Here the columns are cut in tiles of
// COLS = 4 adjacent columns, 16 bytes a row (tiles of 8 columns, whole
// 32-byte sectors, ran slower on the H100: PERF.md). A cluster of S blocks
// holds one tile: block r of the cluster copies rows [r R, r R + R) of it
// into its shared memory (cp.async, 16 bytes a copy, all in flight at
// once), R = ceil(H / S) rows of COLS int32, then, after a cluster
// barrier, writes out's rows [r R, r R + R) of the tile, a row of idx and
// of out a thread and step: table row k lies in rank k / R at row k mod R
// (place), read through the cluster's shared window. Every byte of t, idx
// and out crosses device memory once.
//
// The row gather, out[h, l] = t[h, clamp(idx[h, l], 0, L - 1)] on int32
// (H, L): element (h, l) reads only row h of t. A block takes one row (h
// from blockIdx, so no division by L; 1024 / L rows a block ran no faster
// at L = 128: PERF.md), copies it into its shared memory with cp.async (16
// bytes a copy), and loads each thread's first four indices while the
// copy flies; after the wait a thread's quad is four shared-memory loads
// and one 16-byte store. Rows wider than ROW_MAX are refused.
//
// The symbol step, 256 steps of a mock DEFLATE symbol per lane (see
// probes_micro_gather.cu): a block of LANES lanes first copies its lanes'
// 288-row meta table and 32-row word window into shared memory, (row,
// lane) with lane j of the block in column j, so lane j reads bank j mod
// 32 whatever the row; the lane's 14 limits become registers. A step then
// reads its word at row t & 31 (fetched a step ahead: off the data chain),
// finds the code length without a branch (the count of 14 compares with
// thresholds made from the limits once) and reads meta with one
// shared-memory load.
//
// The same functions run in the kernels and in a host twin that g++
// builds from this header (define PROBES_GATHER_CORE_HOST_TWIN): the
// twin runs a cluster's blocks one after another, each block's threads as
// one, and reads another block's rows from its own copy of them.
#pragma once

#include "stream_core.cuh"

namespace pg {

constexpr int MAX_CLUSTER = 8;      // the portable cluster size
constexpr int SMEM_MAX = 232448;    // dynamic shared memory of one block
constexpr int THREADS = 256;        // threads of a gather block
constexpr int UNROLL = 4;           // 16-byte pieces a gather thread has in
                                    // flight
constexpr int COLS = 4;             // columns of a tile

// Rows of the tile each rank holds.
SC_FN int32_t rows_per_rank(int32_t H, int32_t S) { return (H + S - 1) / S; }

// Whether a cluster of S blocks holds an (H, L) table in tiles of COLS
// columns: S a power of two up to MAX_CLUSTER, R COLS int32 a block.
SC_FN bool fits(int32_t H, int32_t L, int32_t S) {
  if (H < 1 || L < 1 || S < 1 || S > MAX_CLUSTER || (S & (S - 1)))
    return false;
  return (int64_t)rows_per_rank(H, S) * COLS * 4 <= SMEM_MAX;
}

// The blocks S of the cluster that holds a tile of an (H, L) table on a
// card of `sms` SMs: the fewest that fit, doubled (up to MAX_CLUSTER,
// and to H at most) until the tiles' clusters give every SM a block; 0
// where MAX_CLUSTER blocks cannot hold a tile.
SC_FN int32_t cluster_size(int32_t H, int32_t L, int32_t sms) {
  int32_t S = 1;
  while (S <= MAX_CLUSTER && !fits(H, L, S)) S *= 2;
  if (S > MAX_CLUSTER) return 0;
  int64_t tiles = (L + COLS - 1) / COLS;
  while (S < MAX_CLUSTER && tiles * S < sms && H >= 2 * S) S *= 2;
  return S;
}

struct Place {
  int32_t rank, row;
};

// Table row k, clamped to [0, H), as (rank, row in that rank's rows).
// k / R from a float reciprocal, cheaper than an integer division by a
// value known at run time: k < 2^24, so k * inv_r is within 2^-23 of k / R
// relative, never reaches the next integer from below (k / R < 8 is at
// least 1 / R under it) and falls just under it where R divides k (R = 41,
// k = 41: 0.99999994), which one correction mends.
SC_FN Place place(int32_t k, int32_t H, int32_t R, float inv_r) {
  k = k < 0 ? 0 : (k >= H ? H - 1 : k);
  int32_t rank = (int32_t)((float)k * inv_r);
  rank += (rank + 1) * R <= k ? 1 : 0;
  Place p;
  p.rank = rank;
  p.row = k - rank * R;
  return p;
}

SC_FN bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

// A load of data the kernel never writes: through the read-only path on
// the card.
template <class T>
SC_FN T ldg(const T* p) {
#ifdef __CUDA_ARCH__
  return __ldg(p);
#else
  return *p;
#endif
}

// 16 bytes from global src to shared dst without a register: cp.async on
// the card, complete at the next async_wait().
SC_FN void copy16_async(void* dst, const void* src) {
#ifdef __CUDA_ARCH__
  uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;"
               :
               : "r"(d), "l"(src)
               : "memory");
#else
  memcpy(dst, src, 16);
#endif
}

SC_FN void async_wait() {
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.wait_all;" ::: "memory");
#endif
}

SC_FN void load16(int32_t* v, const int32_t* p) {
#ifdef __CUDA_ARCH__
  int4 x = __ldg(reinterpret_cast<const int4*>(p));
  v[0] = x.x;
  v[1] = x.y;
  v[2] = x.z;
  v[3] = x.w;
#else
  memcpy(v, p, 16);
#endif
}

SC_FN void store16(int32_t* p, const int32_t* v) {
#ifdef __CUDA_ARCH__
  *reinterpret_cast<int4*>(p) = make_int4(v[0], v[1], v[2], v[3]);
#else
  memcpy(p, v, 16);
#endif
}

// Rank `rank` of tile `tile` copies its rows of t into smem (R rows of
// COLS; columns past L are 0). Thread tid of nthreads takes every
// nthreads-th piece: a row's 16 bytes where the tile is whole and its rows
// are 16-byte aligned (complete at async_wait()), else one element.
SC_FN void load_rows(const int32_t* t, int32_t H, int32_t L, int32_t tile,
                     int32_t rank, int32_t R, int32_t* smem, int tid,
                     int nthreads) {
  int64_t h0 = (int64_t)rank * R;
  int32_t rows = (int32_t)(H - h0 < R ? H - h0 : R);
  if (rows <= 0) return;
  int32_t col0 = tile * COLS;
  if (L % 4 == 0 && col0 + COLS <= L && aligned16(t)) {
    for (int32_t r = tid; r < rows; r += nthreads)
      copy16_async(smem + COLS * r, t + (h0 + r) * L + col0);
    return;
  }
  for (int32_t e = tid; e < rows * COLS; e += nthreads) {
    int32_t r = e / COLS, c = e % COLS;
    smem[e] = col0 + c < L ? t[(h0 + r) * L + col0 + c] : 0;
  }
}

// The rows the cluster's ranks hold: word `word` of rank `rank`'s rows.
// On the card a rank's rows lie at the same shared-memory offset in every
// block of the cluster, read through the cluster's shared window
// (mapa, then ld.shared::cluster); in the twin the ranks' rows lie one
// after another in one array, per_rank int32 apart.
struct RankRows {
#ifdef __CUDA_ARCH__
  uint32_t base;  // this block's rows, a shared-memory address
  __device__ SC_INLINE RankRows(const int32_t* rows, int64_t)
      : base((uint32_t)__cvta_generic_to_shared(rows)) {}
  __device__ SC_INLINE int32_t operator()(int32_t rank, int32_t word) const {
    uint32_t addr = base + 4u * (uint32_t)word, v;
    asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
                 : "=r"(addr)
                 : "r"(addr), "r"(rank));
    asm volatile("ld.shared::cluster.u32 %0, [%1];" : "=r"(v) : "r"(addr));
    return (int32_t)v;
  }
#else
  const int32_t* rows;
  int64_t per_rank;
  RankRows(const int32_t* r, int64_t n) : rows(r), per_rank(n) {}
  int32_t operator()(int32_t rank, int32_t word) const {
    return rows[rank * per_rank + word];
  }
#endif
};

// Rank `rank` writes out's rows [rank R, rank R + R) of tile `tile` from
// the cluster's rows. Where the tile is whole and idx and out are 16-byte
// aligned, a thread takes a row (16 bytes) at a time and keeps UNROLL rows
// in flight: their indices, then their 4 UNROLL reads, then their stores;
// else one element at a time.
SC_FN void gather_rows(const int32_t* idx, int32_t* out, int32_t H,
                       int32_t L, int32_t tile, int32_t rank, int32_t R,
                       int tid, int nthreads, const RankRows& read) {
  int64_t h0 = (int64_t)rank * R;
  int32_t rows = (int32_t)(H - h0 < R ? H - h0 : R);
  if (rows <= 0) return;
  int32_t col0 = tile * COLS;
  float inv_r = 1.0f / (float)R;
  if (L % 4 == 0 && col0 + COLS <= L && aligned16(idx) && aligned16(out)) {
    for (int32_t base = tid; base < rows; base += nthreads * UNROLL) {
      int64_t at[UNROLL];
      int32_t v[UNROLL][COLS];
#ifdef __CUDA_ARCH__
#pragma unroll
#endif
      for (int u = 0; u < UNROLL; u++) {
        int32_t r = base + u * nthreads;
        at[u] = r < rows ? (h0 + r) * L + col0 : -1;
        if (at[u] >= 0) load16(v[u], idx + at[u]);
      }
#ifdef __CUDA_ARCH__
#pragma unroll
#endif
      for (int u = 0; u < UNROLL; u++) {
        if (at[u] < 0) continue;
#ifdef __CUDA_ARCH__
#pragma unroll
#endif
        for (int c = 0; c < COLS; c++) {
          Place p = place(v[u][c], H, R, inv_r);
          v[u][c] = read(p.rank, p.row * COLS + c);
        }
      }
#ifdef __CUDA_ARCH__
#pragma unroll
#endif
      for (int u = 0; u < UNROLL; u++)
        if (at[u] >= 0) store16(out + at[u], v[u]);
    }
    return;
  }
  for (int32_t e = tid; e < rows * COLS; e += nthreads) {
    int32_t c = e % COLS;
    if (col0 + c >= L) continue;
    int64_t at = (h0 + e / COLS) * L + col0 + c;
    Place p = place(idx[at], H, R, inv_r);
    out[at] = read(p.rank, p.row * COLS + c);
  }
}

// ---------------------------------------------------------------- row

constexpr int ROW_MAX = 12288;     // widest row a block stages: 48 KiB,
                                   // shared memory without an opt-in
constexpr int ROW_THREADS = 256;   // threads of a block, at most

// Threads of the block that takes a row: a quad of elements each, at
// most ROW_THREADS.
SC_FN int32_t row_threads(int32_t L) {
  int32_t q = (L + 3) / 4;
  return q < ROW_THREADS ? q : ROW_THREADS;
}

// Whether the row gather takes its 16-byte paths on (H, L) t, idx, out:
// L % 4 == 0 and all three 16-byte aligned, so every row is.
SC_FN bool row_vec(const int32_t* t, const int32_t* idx, const int32_t* out,
                   int32_t L) {
  return L % 4 == 0 && aligned16(t) && aligned16(idx) && aligned16(out);
}

// n int32 from src to dst (shared memory, 16-byte aligned): with vec
// (src 16-byte aligned, n % 4 == 0) 16 bytes a copy (complete at
// async_wait()), else an element at a time. Thread tid of nthreads.
SC_FN void stage_flat(const int32_t* src, int64_t n, int32_t* dst, int tid,
                      int nthreads, bool vec) {
  if (vec) {
    for (int64_t e = tid; e < n / 4; e += nthreads)
      copy16_async(dst + 4 * e, src + 4 * e);
    return;
  }
  for (int64_t e = tid; e < n; e += nthreads) dst[e] = src[e];
}

SC_FN int32_t clamp_col(int32_t k, int32_t L) {
  return k < 0 ? 0 : (k >= L ? L - 1 : k);
}

// Thread x of bx across one row: out[l] = s[clamp(idx[l], 0, L - 1)],
// s the row in shared memory, idx and out the row in device memory. vec
// (row_vec): quads x, x + bx, ..., each one
// 16-byte load of idx, four shared-memory loads and one 16-byte store, the
// first quad's indices in `first` (loaded while the row's copy flew);
// else elements x, x + bx, ...
SC_FN void gather_row(const int32_t* s, const int32_t* idx, int32_t* out,
                      int32_t L, int x, int bx, bool vec,
                      const int32_t* first) {
  if (!vec) {
    for (int32_t l = x; l < L; l += bx) out[l] = s[clamp_col(idx[l], L)];
    return;
  }
  for (int32_t q = x; 4 * q < L; q += bx) {
    int32_t v[4];
    if (q == x) {
#ifdef __CUDA_ARCH__
#pragma unroll
#endif
      for (int u = 0; u < 4; u++) v[u] = first[u];
    } else {
      load16(v, idx + 4 * q);
    }
#ifdef __CUDA_ARCH__
#pragma unroll
#endif
    for (int u = 0; u < 4; u++) v[u] = s[clamp_col(v[u], L)];
    store16(out + 4 * q, v);
  }
}

// ---------------------------------------------------------------- symbol

constexpr int META_ROWS = 288;
constexpr int WORD_ROWS = 32;
constexpr int STAGE_THREADS = 256;  // threads that stage a block's tables
constexpr int LANES = 64;           // lanes a block (32 ran no faster)

// Shared memory of a block: meta, then the words.
constexpr int64_t SYMBOL_SMEM = (int64_t)(META_ROWS + WORD_ROWS) * LANES * 4;

// rows x LANES int32 of a (rows, L) table, lanes [l0, l0 + LANES), into
// dst (row, lane); lanes past L get 0. 16 bytes a copy where the block's
// lanes are whole and 16-byte aligned (complete at async_wait()).
SC_FN void stage_rows(const int32_t* src, int rows, int64_t L, int64_t l0,
                      int32_t* dst, int tid, int nthreads) {
  if (L % 4 == 0 && l0 + LANES <= L && aligned16(src)) {
    constexpr int Q = LANES / 4;  // 16-byte pieces a row
    for (int e = tid; e < rows * Q; e += nthreads)
      copy16_async(dst + 4 * e, src + (int64_t)(e / Q) * L + l0 + 4 * (e % Q));
    return;
  }
  for (int e = tid; e < rows * LANES; e += nthreads) {
    int64_t l = l0 + e % LANES;
    dst[e] = l < L ? src[(int64_t)(e / LANES) * L + l] : 0;
  }
}

// The block of lanes [l0, l0 + LANES) copies its meta rows and word rows
// into s_meta (META_ROWS x LANES) and s_words (WORD_ROWS x LANES).
SC_FN void stage(const int32_t* meta, const uint32_t* words, int64_t L,
                 int64_t l0, int32_t* s_meta, uint32_t* s_words, int tid,
                 int nthreads) {
  stage_rows(meta, META_ROWS, L, l0, s_meta, tid, nthreads);
  stage_rows(reinterpret_cast<const int32_t*>(words), WORD_ROWS, L, l0,
             reinterpret_cast<int32_t*>(s_words), tid, nthreads);
}

// A lane's limits as the thresholds of the length find. peek >> (15 - bl)
// < lim[bl] holds exactly where peek < lim[bl] << (15 - bl) (no limit above
// 0: never; 2^15 or more: always, as peek < 2^15). The first bl that
// holds is then the first whose running maximum of those bounds, th[bl],
// exceeds peek; th is non-decreasing, so that bl is 1 + the number of
// th[bl] <= peek (15 where all 14 are).
SC_FN void thresholds(const int32_t* lim, int32_t* th) {
  int32_t run = 0;
  for (int bl = 1; bl < 15; bl++) {
    int64_t x = (int64_t)lim[bl] << (15 - bl);
    int32_t b = x <= 0 ? 0 : (x > 32768 ? 32768 : (int32_t)x);
    run = b > run ? b : run;
    th[bl] = run;
  }
  th[0] = 0;
}

SC_FN int popc32(uint32_t x) {
#ifdef __CUDA_ARCH__
  return __popc(x);
#else
  return __builtin_popcount(x);
#endif
}

// The mock canonical length find without a branch (probes::len_find's
// function): 14 independent compares of peek with the lane's thresholds
// make a mask, and n, its count of set bits, gives length n + 1 and code
// peek >> (14 - n); at n = 14 (length 15, code 0) th[14] <= peek, a
// compare that runs beside the others, has set peek to 0 first.
SC_FN void len_find(int32_t peek, const int32_t* th, int32_t& length,
                    int32_t& code) {
  uint32_t mask = 0;
#ifdef __CUDA_ARCH__
#pragma unroll
#endif
  for (int bl = 1; bl < 15; bl++)
    mask |= (th[bl] <= peek ? 1u : 0u) << (bl - 1);
  int32_t src = th[14] <= peek ? 0 : peek;
  int32_t n = popc32(mask);
  length = n + 1;
  code = src >> (14 - n);
}

// One lane's run: T steps of refill, length find, meta probe and consume
// (bit for bit probes_micro_gather.cu's p5_symbol_kernel; widx is t),
// lane j of its block with its thresholds th; returns its sum of meta.
SC_FN int32_t run(const int32_t* s_meta, const uint32_t* s_words,
                  const int32_t* th, int j, int T) {
  uint32_t bitbuf = 0, acc = 0;
  int32_t navail = 0;
  const int32_t* col = s_meta + j;
  uint32_t w = s_words[j];
  for (int t = 0; t < T; t++) {
    uint32_t next = s_words[((t + 1) & 31) * LANES + j];
    bitbuf |= navail < 32 ? w << navail : 0u;
    navail = navail + 32 < 32 ? navail + 32 : 32;
    int32_t length, code;
    len_find((int32_t)(bitbuf & 0x7FFF), th, length, code);
    uint32_t row = (uint32_t)(code + length * 7) % (uint32_t)META_ROWS;
    int32_t m = col[row * LANES];
    uint32_t consume = (uint32_t)(length + (m & 7));
    bitbuf >>= consume;
    navail -= (int32_t)consume;
    acc += (uint32_t)m;
    w = next;
  }
  return (int32_t)acc;
}

}  // namespace pg

#ifdef PROBES_GATHER_CORE_HOST_TWIN
#include <vector>

// msp_p5_dyngather_cluster's function on host pointers at a cluster of S
// blocks, the blocks one after another; -1 where S blocks cannot hold a
// tile.
extern "C" int pg_dyngather_host(const int32_t* t, const int32_t* idx,
                                 int32_t* out, int H, int L, int S) {
  if (!pg::fits(H, L, S)) return -1;
  int32_t R = pg::rows_per_rank(H, S);
  // each rank's rows, then a row that no load writes: a read past a
  // rank's rows finds it, not the next rank's first row
  int64_t per_rank = (int64_t)(R + 1) * pg::COLS;
  std::vector<int32_t> smem((size_t)(S * per_rank), INT32_MIN);
  for (int32_t tile = 0; tile < (L + pg::COLS - 1) / pg::COLS; tile++) {
    for (int32_t r = 0; r < S; r++)
      pg::load_rows(t, H, L, tile, r, R, smem.data() + r * per_rank, 0, 1);
    // the cluster barrier: every rank's rows are in before any is read
    for (int32_t r = 0; r < S; r++)
      pg::gather_rows(idx, out, H, L, tile, r, R, 0, 1,
                      pg::RankRows(smem.data(), per_rank));
  }
  return 0;
}

// msp_p5_dyngather_row's function on host pointers, a block (a row) after
// another, its threads one after another; -1 where a row is wider than
// pg::ROW_MAX.
extern "C" int pg_dyngather_row_host(const int32_t* t, const int32_t* idx,
                                     int32_t* out, int H, int L) {
  if (H < 1 || L < 1 || L > pg::ROW_MAX) return -1;
  std::vector<int32_t> smem((size_t)L);
  int bx = pg::row_threads(L);
  bool vec = pg::row_vec(t, idx, out, L);
  for (int64_t at = 0; at < (int64_t)H * L; at += L) {
    pg::stage_flat(t + at, L, smem.data(), 0, 1, vec);
    for (int x = 0; x < bx; x++) {
      int32_t first[4] = {0, 0, 0, 0};
      if (vec && 4 * x < L) pg::load16(first, idx + at + 4 * x);
      pg::gather_row(smem.data(), idx + at, out + at, L, x, bx, vec, first);
    }
  }
  return 0;
}

// pg::cluster_size: the cluster msp_p5_dyngather_cluster launches on a
// card of `sms` SMs (0: none holds a tile).
extern "C" int pg_cluster_size_host(int H, int L, int sms) {
  return pg::cluster_size(H, L, sms);
}

// pg::len_find on n lanes: peek (n,), limit (16, n).
extern "C" void pg_len_find_host(const int32_t* peek, const int32_t* limit,
                                 int n, int32_t* length, int32_t* code) {
  for (int l = 0; l < n; l++) {
    int32_t lim[15], th[15];
    for (int bl = 1; bl < 15; bl++) lim[bl] = limit[bl * n + l];
    pg::thresholds(lim, th);
    pg::len_find(peek[l], th, length[l], code[l]);
  }
}

// msp_p5_symbol_smem's function on host pointers, block by block: meta
// (288, L), limit (16, L), words (32, L); out (L,).
extern "C" void pg_symbol_host(const int32_t* meta, const int32_t* limit,
                               const uint32_t* words, int32_t* out, int L,
                               int T) {
  std::vector<int32_t> s_meta((size_t)pg::META_ROWS * pg::LANES);
  std::vector<uint32_t> s_words((size_t)pg::WORD_ROWS * pg::LANES);
  for (int64_t l0 = 0; l0 < L; l0 += pg::LANES) {
    pg::stage(meta, words, L, l0, s_meta.data(), s_words.data(), 0, 1);
    for (int j = 0; j < pg::LANES && l0 + j < L; j++) {
      int32_t lim[15], th[15];
      for (int bl = 1; bl < 15; bl++)
        lim[bl] = limit[bl * (int64_t)L + l0 + j];
      pg::thresholds(lim, th);
      out[l0 + j] = pg::run(s_meta.data(), s_words.data(), th, j, T);
    }
  }
}
#endif
