// P2 redesigned: the decoder skeleton of tools/micro_skel.py (pallas_call
// at :118) as one launch that writes all 256 token rows and the counts
// (probes_skel_vec.cu's kernel).
//
// One lane's step is probes_micro_skel.cu's, bit for bit: the refill
// through a 64-word window that the lanes (t G + i) mod L, i < G,
// re-align at their word position, the 14-step length find, the sweep of
// 288 keys (n * 1315423911) mod 2^20 as written, the consume, and the token
// sym + acc in row t mod 256; cnt = acc + wpos at the end. JAX's semantics
// where C's differ, a zero window for a lane not yet windowed, and a copy
// visible within its step are as that file says. The window schedule is a
// countdown a lane (lag = (l - t G) mod L, less G each step), where the
// faithful kernel takes a 64-bit modulo by L every step.
//
// The grid has two kinds of block, THREADS threads each. A decode block's
// thread runs one lane, so a warp's token row is 128 consecutive bytes a
// step. (Four consecutive lanes a thread, a 16-byte store a row, ran 1.27
// us slower at L = 1024, T = 64 on the H100: the decode folds to each
// lane's refill bookkeeping, and four lanes put four times that serial work
// on a thread; PERF.md.) The blocks after them write the rows [min(T, 256),
// 256), which no step writes, with 16-byte zero stores, ZERO_CHUNKS a
// thread; they spread over the SMs beside the latency-bound decode. At
// T >= 256 there are none. So every element of out is written by exactly
// one kind of block, and the wrapper allocates it with torch.empty. The
// 16-byte zero stores are a template flag that the host sets where L % 4 ==
// 0 and out is 16-byte aligned; elsewhere the zero blocks store an element
// at a time.
//
// The same functions run in the kernel and in a host twin that g++ builds
// from this header (define PROBES_SKEL_CORE_HOST_TWIN): the twin runs the
// blocks one after another, each block's threads in turn.
#pragma once

#include "probes_gather_core.cuh"

namespace ps {

constexpr int NOUT = 256;       // token rows
constexpr int NKEYS = 288;
constexpr int CHUNK = 4;        // elements of a zero store
constexpr int THREADS = 64;     // threads a block
constexpr int ZERO_CHUNKS = 8;  // zero stores a zero thread

struct Args {
  const uint32_t* stream;  // (L, W)
  int64_t W;
  const int32_t* seed;  // (L,)
  int32_t L, T, G, WIN;
  int32_t* out;  // (NOUT, L)
  int32_t* cnt;  // (L,)
};

struct Grid {
  int32_t decode, zero;  // blocks of each kind, decode first
};

// The first row that no step writes.
SC_FN int32_t zero_row0(int32_t T) {
  return T <= 0 ? 0 : (T < NOUT ? T : NOUT);
}

SC_FN Grid grid(int32_t L, int32_t T) {
  int64_t chunks =
      ((int64_t)(NOUT - zero_row0(T)) * L + CHUNK - 1) / CHUNK;
  int64_t per = (int64_t)THREADS * ZERO_CHUNKS;
  Grid g;
  g.decode = (int32_t)(((int64_t)L + THREADS - 1) / THREADS);
  g.zero = (int32_t)((chunks + per - 1) / per);
  return g;
}

// Whether the zero blocks' chunks are whole, 16-byte aligned stores.
SC_FN bool vec(const Args& a) {
  return a.L % CHUNK == 0 && pg::aligned16(a.out);
}

struct Lane {
  uint32_t bitlo, bithi, acc;
  int32_t navail, wpos, base, lag;
  bool windowed;
};

SC_FN Lane start(int32_t seed, int32_t l) {
  Lane s;
  s.bitlo = s.acc = (uint32_t)seed;
  s.bithi = 0;
  s.navail = s.wpos = s.base = 0;
  s.lag = l;  // (l - 0 G) mod L
  s.windowed = false;
  return s;
}

// The mock canonical decode of the low 15 bits of bitlo, as micro_skel.py
// wrote it: a length find against (37 bl) mod 97, then the sweep of every
// key for (length << 16) | code.
SC_FN int32_t symbol(uint32_t bitlo) {
  int32_t peek = (int32_t)(bitlo & 0x7FFF);
  int32_t length = 15, code = 0;
  for (int bl = 1; bl < 15; bl++) {
    int32_t c = peek >> (15 - bl);
    if (c < (bl * 37) % 97) {
      length = bl;
      code = c;
      break;
    }
  }
  int32_t key = (length << 16) | code;
  int32_t sym = 0;
  for (int n = 0; n < NKEYS; n++) {
    sym = key == (int32_t)(((uint32_t)n * 1315423911u) & 0xFFFFFu) ? n : sym;
  }
  return sym;
}

// Step t of a lane whose stream row is `row`: refill, decode, consume.
// Returns its token, sym + acc.
SC_FN int32_t step(Lane& s, const uint32_t* row, const Args& a) {
  if (a.L <= a.G || s.lag < a.G) {  // re-windowed at wpos this step
    s.base = s.wpos;
    s.windowed = true;
  }
  s.lag -= a.G;  // G < L wherever the countdown is read
  s.lag += s.lag < 0 ? a.L : 0;
  int32_t off = s.wpos - s.base;
  uint32_t w = s.windowed && off >= 0 && off < a.WIN
                   ? pg::ldg(row + s.base + off)
                   : 0u;
  if (s.navail <= 31) {
    if (s.navail == 0) s.bitlo = w;
    if (s.navail > 0) s.bithi |= w >> (32 - s.navail);
    s.navail += 32;
    s.wpos += 1;
  }
  int32_t sym = symbol(s.bitlo);
  uint32_t consume = (uint32_t)(sym % 15 + 1);
  s.bitlo = (s.bitlo >> consume) | (s.bithi << (32 - consume));
  s.bithi >>= consume;
  s.navail -= (int32_t)consume;
  int32_t v = (int32_t)(s.acc + (uint32_t)sym);
  s.acc += (uint32_t)sym;
  return v;
}

// Where a block's stores go: the kernel's and the twin's output.
struct Store {
  SC_MEMBER void row(int32_t* p, int32_t v) const { *p = v; }
  template <bool VEC>
  SC_MEMBER void zero(int32_t* p, int n) const {
    if (VEC) {
      const int32_t z[CHUNK] = {0, 0, 0, 0};
      pg::store16(p, z);
    } else {
      for (int u = 0; u < n; u++) p[u] = 0;
    }
  }
  SC_MEMBER void count(int32_t* p, int32_t v) const { *p = v; }
};

// Decode thread l: lane l's T steps, then its count.
template <class Sink>
SC_FN void decode_lane(const Args& a, int64_t l, const Sink& sink) {
  if (l >= a.L) return;
  Lane s = start(a.seed[l], (int32_t)l);
  const uint32_t* words = a.stream + l * a.W;
  int32_t* row = a.out + l;  // row t mod NOUT
  for (int t = 0, r = 0; t < a.T; t++) {
    sink.row(row, step(s, words, a));
    row += a.L;
    if (++r == NOUT) {
      r = 0;
      row = a.out + l;
    }
  }
  sink.count(a.cnt + l, (int32_t)(s.acc + (uint32_t)s.wpos));
}

// Zero block z, thread x: its ZERO_CHUNKS chunks of CHUNK elements of the
// rows [zero_row0(T), NOUT), chunk (z ZERO_CHUNKS + k) THREADS + x for
// k < ZERO_CHUNKS, so a warp's stores are consecutive.
template <bool VEC, class Sink>
SC_FN void zero_chunks(const Args& a, int64_t z, int x, const Sink& sink) {
  int64_t begin = (int64_t)zero_row0(a.T) * a.L, end = (int64_t)NOUT * a.L;
#pragma unroll
  for (int k = 0; k < ZERO_CHUNKS; k++) {
    int64_t e = begin + ((z * ZERO_CHUNKS + k) * THREADS + x) * CHUNK;
    if (e < end)
      sink.template zero<VEC>(a.out + e, end - e < CHUNK ? (int)(end - e)
                                                          : CHUNK);
  }
}

// Thread x of block b of grid(L, T).
template <bool VEC, class Sink>
SC_FN void block(const Args& a, const Grid& g, int64_t b, int x,
                 const Sink& sink) {
  if (b < g.decode) {
    decode_lane(a, b * THREADS + x, sink);
  } else {
    zero_chunks<VEC>(a, b - g.decode, x, sink);
  }
}

}  // namespace ps

#ifdef PROBES_SKEL_CORE_HOST_TWIN
template <class Sink>
static void run_host(const ps::Args& a, const Sink& sink) {
  ps::Grid g = ps::grid(a.L, a.T);
  bool v = ps::vec(a);
  for (int64_t b = 0; b < (int64_t)g.decode + g.zero; b++) {
    for (int x = 0; x < ps::THREADS; x++) {
      if (v)
        ps::block<true>(a, g, b, x, sink);
      else
        ps::block<false>(a, g, b, x, sink);
    }
  }
}

// msp_p2_skel_vec's function on host pointers: stream (L, W) words; seed,
// cnt (L,); out (256, L).
extern "C" void ps_skel_host(const uint32_t* stream, int64_t W,
                             const int32_t* seed, int L, int T, int G,
                             int WIN, int32_t* out, int32_t* cnt) {
  ps::Args a = {stream, W, seed, L, T, G, WIN, out, cnt};
  run_host(a, ps::Store());
}

// Which blocks write each element of out: a decode block's store sets
// 0x100 in hits, a zero block's adds 1.
struct Tally {
  int32_t *out, *hits;
  void row(int32_t* p, int32_t) const { hits[p - out] |= 0x100; }
  template <bool VEC>
  void zero(int32_t* p, int n) const {
    for (int u = 0; u < n; u++) hits[p - out + u] += 1;
  }
  void count(int32_t*, int32_t) const {}
};

// ps_skel_host's grid with its stores tallied into hits (256, L) instead;
// out is only an address there.
extern "C" void ps_skel_cover_host(const uint32_t* stream, int64_t W,
                                   const int32_t* seed, int L, int T, int G,
                                   int WIN, int32_t* out, int32_t* cnt,
                                   int32_t* hits) {
  ps::Args a = {stream, W, seed, L, T, G, WIN, out, cnt};
  Tally t = {out, hits};
  run_host(a, t);
}

// grid(L, T): {decode blocks, zero blocks}.
extern "C" void ps_grid_host(int L, int T, int32_t* blocks) {
  ps::Grid g = ps::grid(L, T);
  blocks[0] = g.decode;
  blocks[1] = g.zero;
}
#endif
