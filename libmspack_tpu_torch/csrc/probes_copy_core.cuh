// P3 redesigned: the one-frame token copy machine as a block-parallel
// resolve (steps 2-4 of probes_micro_copy.cu's p3_par_kernel).
//
// The function is micro_copy.resolve_plain's: tokens (kind, len, dist) run
// from dst = seed; a literal run copies lit[lsrc ..], a match copies in the
// TPU kernel's chunks c = min(rem, 128, avail), every chunk reading from
// dst - dist, avail starting at dist and growing by each chunk. A chunk
// reads only positions before its own start, and every position is written
// once, so each output position p has one immediate source fixed before
// any token runs:
//   a literal position: lit[lsrc + o] (a root);
//   a position nothing writes (below seed, past the last token): 0 (a root);
//   a match position at offset o of its token: the position dst - dist +
//     (o - s), s the start of the chunk that holds o (chunk_start).
// The frame is out[p] = out[src(p)] with src(p) < p, so pointer jumping,
// src[p] = src[src[p]] until every position names a root, resolves it in
// at most ceil(log2 n) rounds, whatever order the token walk had.
//
// The positions' sources are int32 in one array (shared memory on the
// card): v >= 0 names position v, ZERO (-1) is the root 0, and -2 - i the
// root lit[i]. A tile of up to THREADS tokens at a time, one a thread:
// after the block's scans of len and of the literal runs' len give each
// token its start and lsrc, each token with len > 0 marks its start with
// its index in the tile, a segmented max-scan over the tile's
// positions gives each position its token (seg_max, then seg_resolve with
// the scan of the segments' maxima), and seg_resolve writes the position's
// source. Positions of the tile not yet marked hold ZERO from the start,
// which is below every mark. Each thread's segment of the tile's positions
// is contiguous and of odd length, so the threads of a warp read 32
// different banks.
//
// The same functions run in the kernel (probes_micro_copy.cu, the block's
// scans with warp shuffles) and in a host twin that g++ builds from this
// header (define PROBES_COPY_CORE_HOST_TWIN): the block's threads run one
// after another between barriers and the scans are serial loops. A jumping
// round in place reads either a position's old source or its new one, both
// on its chain, so the rounds may differ between the two and the frame
// does not. The block scans run only on the card: micro_copy.main() holds
// the kernel there against the plain version on every case the twin is
// tested on (micro_copy.inputs()).
#pragma once

#include "stream_core.cuh"

namespace pc {

constexpr int THREADS = 1024;     // the block, and the tokens of a tile
constexpr int CHUNK = 128;        // the TPU kernel's chunk: one vector row
constexpr int MAX_POS = 258 * 128;  // the frame: (ROWS + 2, V) int32
constexpr int32_t ZERO = -1;      // the root "0"

SC_FN int32_t lit_root(int32_t i) { return -2 - i; }

// The start, in its token, of the chunk that holds offset o of a match at
// distance dist: chunks of dist, 2 dist, 4 dist, ... while they are below
// CHUNK (at most 7 doublings), then of CHUNK.
SC_FN int32_t chunk_start(int32_t o, int32_t dist) {
  int32_t s = 0, a = dist;
  while (a < CHUNK && s + a <= o) {
    s += a;
    a += a;
  }
  if (a >= CHUNK) s += (o - s) / CHUNK * CHUNK;
  return s;
}

// Token k of tok (nt rows of kind, len, dist); rows past nt are empty
// literal runs.
SC_FN void token(const int32_t* tok, int nt, int k, int32_t& kind,
                 int32_t& len, int32_t& dist) {
  kind = len = dist = 0;
  if (k < nt) {
    kind = tok[3 * k];
    len = tok[3 * k + 1];
    dist = tok[3 * k + 2];
  }
}

// What a tile keeps of token t: its start, and lit's index of its first
// element (a literal run: -1 - lsrc) or its distance (a match: dist >= 1).
SC_FN int32_t token_arg(int32_t kind, int32_t lsrc, int32_t dist) {
  return kind == 0 ? -1 - lsrc : dist;
}

// Step 1's end for token t of a tile, given its start and lit's index of
// its first element (the block's scans): what the tile keeps of it, and
// the mark of its start if it writes a position.
SC_FN void mark_token(int32_t* src, int32_t* t_start, int32_t* t_arg, int t,
                      int32_t kind, int32_t len, int32_t dist, int32_t start,
                      int32_t lsrc) {
  t_start[t] = start;
  t_arg[t] = token_arg(kind, lsrc, dist);
  if (len > 0) src[start] = t;
}

// The immediate source of position p of a token at start with arg.
SC_FN int32_t source(int32_t p, int32_t start, int32_t arg) {
  int32_t o = p - start;
  if (arg < 0) return lit_root(-1 - arg + o);
  return start - arg + (o - chunk_start(o, arg));
}

// Thread t's segment [a, b) of the tile's positions [r0, r1).
SC_FN void segment(int t, int32_t r0, int32_t r1, int32_t& a, int32_t& b) {
  int32_t len = ((r1 - r0 + THREADS - 1) / THREADS) | 1;
  a = r0 + t * len;
  if (a > r1) a = r1;
  b = a + len < r1 ? a + len : r1;
}

// Step 2, before the scan: the largest mark in [a, b).
SC_FN int32_t seg_max(const int32_t* src, int32_t a, int32_t b) {
  int32_t m = ZERO;
  for (int32_t p = a; p < b; p++) m = src[p] > m ? src[p] : m;
  return m;
}

// Steps 2-3 after the scan: own is the largest mark before a; each
// position of [a, b) takes its token's source.
SC_FN void seg_resolve(int32_t* src, int32_t a, int32_t b, int32_t own,
                       const int32_t* t_start, const int32_t* t_arg) {
  for (int32_t p = a; p < b; p++) {
    own = src[p] > own ? src[p] : own;
    src[p] = source(p, t_start[own], t_arg[own]);
  }
}

// Step 4, one round of thread t over [lo, hi): whether a source it wrote
// still names a position.
SC_FN bool jump(int32_t* src, int32_t lo, int32_t hi, int t) {
  bool more = false;
  for (int32_t p = lo + t; p < hi; p += THREADS) {
    int32_t v = src[p];
    if (v >= 0) {
      int32_t w = src[v];
      src[p] = w;
      more |= w >= 0;
    }
  }
  return more;
}

// The frame from the roots: thread t's positions of [0, n).
SC_FN void emit(const int32_t* src, int32_t n, const int32_t* lit,
                int32_t* out, int t) {
  for (int32_t p = t; p < n; p += THREADS) {
    int32_t v = src[p];
    out[p] = v == ZERO ? 0 : lit[-2 - v];
  }
}

}  // namespace pc

#ifdef PROBES_COPY_CORE_HOST_TWIN
#include <vector>

// The kernel's launch, its threads one after another (arguments as
// msp_p3_copy_par takes them, but host pointers); *rounds gets the jumping
// rounds this order took. Returns 1 if n is above MAX_POS.
extern "C" int pc_resolve_host(const int32_t* seed, const int32_t* tok,
                               int nt, const int32_t* lit, int32_t* out,
                               int32_t* sc, int32_t n, int32_t* rounds) {
  using namespace pc;
  if (n < 0 || n > MAX_POS) return 1;
  std::vector<int32_t> src(n, ZERO), t_start(THREADS), t_arg(THREADS),
      seg(THREADS);
  int32_t dst = seed[0], lsrc = 0, lo = dst;
  for (int base = 0; base < nt; base += THREADS) {
    // step 1: the tile's scans of len and of the literal runs' len
    int32_t at = dst, lat = lsrc;
    for (int t = 0; t < THREADS; t++) {
      int32_t kind, len, dist;
      token(tok, nt, base + t, kind, len, dist);
      mark_token(src.data(), t_start.data(), t_arg.data(), t, kind, len,
                 dist, at, lat);
      at += len;
      lat += kind == 0 ? len : 0;
    }
    for (int t = 0; t < THREADS; t++) {
      int32_t a, b;
      segment(t, dst, at, a, b);
      seg[t] = seg_max(src.data(), a, b);
    }
    int32_t own = ZERO;  // the exclusive max-scan of the segments' maxima
    for (int t = 0; t < THREADS; t++) {
      int32_t m = seg[t];
      seg[t] = own;
      own = m > own ? m : own;
    }
    for (int t = 0; t < THREADS; t++) {
      int32_t a, b;
      segment(t, dst, at, a, b);
      seg_resolve(src.data(), a, b, seg[t], t_start.data(), t_arg.data());
    }
    dst = at;
    lsrc = lat;
  }
  int32_t r = 0;
  for (bool more = true; more; r++) {
    more = false;
    for (int t = 0; t < THREADS; t++) more |= jump(src.data(), lo, dst, t);
  }
  for (int t = 0; t < THREADS; t++) emit(src.data(), n, lit, out, t);
  sc[0] = dst;
  *rounds = r;
  return 0;
}
#endif
