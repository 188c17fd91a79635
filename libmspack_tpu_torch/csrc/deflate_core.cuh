// DEFLATE phase A for one stream: decode a raw deflate stream (an MSZIP
// frame without its 'CK' signature) into the token trace of
// libmspack_tpu/ops/pallas_inflate.py (format at :55-61):
//
//   -1                              NOP (never emitted here; padding)
//   0x20000000 | n                  n in 1..4 literal bytes, LSB-first in litw
//   0x40000000 | nl<<25 | len<<16 | (dist-1)
//                                   nl in 0..3 pending literals (in litw),
//                                   then a match, len <= 258, dist <= 32768
//
// The same functions run in the Hopper kernel (inflate.cu, one warp per
// stream, the tables in shared memory) and in a host twin that g++ builds
// from this header and stream_core.cuh (define DEFLATE_CORE_HOST_TWIN), so
// the tests check the kernel's logic, its warp steps included, on a CPU.
//
// The decoder is sequential and follows puff: all 32 lanes of the warp run
// it in lockstep on identical registers. Bits come LSB-first from a reader
// refilled with aligned 32-bit words (Bits), reading zeros past the
// stream's end with an exact tell(). Each code gets a canonical
// description (per-length counts plus the symbols sorted by length, then
// symbol), built by the warp 32 symbols a step, and a first-level lookup
// table filled lane by lane from it: the symbol and length of every code
// of at most the table's bits, so a symbol is one table read; a longer
// code goes on through the canonical walk from the table's bits + 1.
// Literal runs decode in a loop straight off the literal/length table.
//
// Every condition the TPU kernel flags is flagged here, with err = 1:
// a Huffman miss, length slot >= 29, distance symbol 30 or 31 (the fixed
// tree has no codes for them), dist > output + history, an over-subscribed
// table, a bad stored LEN/NLEN, block type 3, and a code-length run past
// HLIT + HDIST. err = 2 means the token cap was reached.
#pragma once

#include "stream_core.cuh"

#define DC_FN SC_FN
#ifdef __CUDACC__
#define DC_NOINLINE __noinline__
#else
#define DC_NOINLINE __attribute__((noinline))
#endif

// A diagnostic build (-DDC_CYCLES, tools/diag_mszip.py) counts each
// stream's clock64 cycles by part into counts rows 4-7 (write_counts).
#if defined(DC_CYCLES) && defined(__CUDA_ARCH__)
#define DC_TICK(v) long long v = clock64()
#define DC_TOCK(acc, v) (acc) += clock64() - (v)
#else
#define DC_TICK(v)
#define DC_TOCK(acc, v)
#endif

namespace dc {

constexpr int32_t TOK_LIT = 0x20000000;
constexpr int32_t TOK_MATCH = 0x40000000;
constexpr int NLIT = 288;   // literal/length symbols (HLIT <= 288)
constexpr int NDIST = 32;   // distance symbols (HDIST <= 32)
constexpr int NCL = 19;     // code-length symbols

// first-level table bits of the literal/length, distance and code-length
// codes (code-length codes are at most 7 bits long)
constexpr int LIT_TB = 10, DIST_TB = 8, CL_TB = 7;
// A table entry: symbol | length << 12, or LONG for the prefix of a code
// longer than the table's bits or of no code. A literal's entry, and only
// a literal's, has bits 8-11 clear.
constexpr uint16_t LONG = 0xFFFF;

enum { ERR_OK = 0, ERR_DATA = 1, ERR_TCAP = 2 };

// Where the canonical walk resumes past a table's bits: the first code and
// the symbol index of the next length.
struct Walk {
  int32_t first, index;
};

// One stream's decode tables (3984 bytes). The kernel keeps one per warp
// in shared memory; the host twin keeps one on the stack.
struct Tables {
  uint16_t lit[1 << LIT_TB];
  uint16_t dist[1 << DIST_TB];
  uint16_t cl[1 << CL_TB];
  uint16_t lcount[16];
  uint16_t dcount[16];
  uint16_t ccount[16];
  uint16_t lsym[NLIT];
  uint16_t dsym[NDIST];
  uint16_t csym[NCL + 1];
  uint16_t run[16];  // build's next symbol index of each length
  Walk lwalk, dwalk, cwalk;
  uint8_t lens[NLIT + NDIST];
};

// An LSB-first bit reader over bytes, reading zeros past the stream's end.
// It refills from 32-bit words aligned in memory: the first word may start
// up to 3 bytes before the stream, whose bytes read as zeros and are
// dropped. buf holds exactly the nbits bits that follow tell().
struct Bits {
  const uint8_t* src;
  int64_t n;
  int64_t wpos;  // byte offset from src of the next word to load
  uint64_t buf;  // the next bits, LSB first
  int nbits;

  // The 32 bits at byte offset q (src + q 4-byte aligned), LSB first.
  SC_MEMBER uint32_t word_at(int64_t q) const {
    if (__builtin_expect(q >= 0 && q + 4 <= n, 1)) {
      uint32_t w;
#ifdef __CUDA_ARCH__
      w = *reinterpret_cast<const uint32_t*>(src + q);
#else
      memcpy(&w, src + q, 4);
#endif
      return w;
    }
    return edge_word(src, n, q);
  }

  // A word that starts before the stream or ends past it, bytes outside
  // reading as 0: kept out of line, off the decoder's hot paths.
  static __host__ __device__ DC_NOINLINE uint32_t edge_word(
      const uint8_t* s, int64_t len, int64_t q) {
    uint32_t w = 0;
    for (int k = 0; k < 4; k++) {
      int64_t p = q + k;
      if (p >= 0 && p < len) w |= (uint32_t)s[p] << (8 * k);
    }
    return w;
  }

  SC_MEMBER void init(const uint8_t* s, int64_t len) {
    int a = (int)((uintptr_t)s & 3);
    src = s;
    n = len;
    wpos = -a;
    buf = 0;
    nbits = 0;
    if (a) {
      fill();
      drop(8 * a);
    }
  }

  // From nbits <= 32 to nbits > 32.
  SC_MEMBER void fill() {
    while (nbits <= 32) {
      buf |= (uint64_t)word_at(wpos) << nbits;
      wpos += 4;
      nbits += 32;
    }
  }

  SC_MEMBER int64_t tell() const { return wpos * 8 - nbits; }

  SC_MEMBER void drop(int k) {
    buf >>= k;
    nbits -= k;
  }

  // The next k bits (0 <= k <= 32), left in the buffer.
  SC_MEMBER uint32_t peek(int k) {
    if (__builtin_expect(nbits < k, 0)) fill();
    return (uint32_t)(buf & ((1ull << k) - 1));
  }

  SC_MEMBER uint32_t take(int k) {
    uint32_t v = peek(k);
    drop(k);
    return v;
  }
};

// The tokens written so far: n of at most cap, the next at tok and litw;
// and the diagnostic build's cycle counts (DC_CYCLES).
struct Trace {
  int32_t* tok;
  int32_t* litw;
  int32_t cap;
  int32_t n;
  long long c_lit, c_hdr, n_lit;
};

struct Result {
  int32_t err;
  int32_t outbytes;
  int32_t ntok;
  int32_t words;  // 32-bit words of input consumed, rounded up
  int32_t c_all, c_lit, c_hdr, n_lit;  // DC_CYCLES: cycles, literals
};

DC_FN bool emit(Trace& t, int32_t tok, uint32_t litw) {
  if (t.n >= t.cap) return false;
  if (warp::leader()) {
    *t.tok = tok;
    *t.litw = (int32_t)litw;
  }
  t.tok++;
  t.litw++;
  t.n++;
  return true;
}

// Canonical code from the code lengths lens[0..n) (each <= 15), 32 symbols
// a step: the lanes of equal length (match_any) count themselves and take
// consecutive places in sym, the group's lowest lane moving its length's
// running index on. Returns -1 when over-subscribed (the TPU kernel's
// limit[l] > 2^l test; sym then untouched), 0 otherwise; incomplete codes
// are accepted and decode to a miss.
DC_FN int build(uint16_t* count, uint16_t* sym, const uint8_t* lens, int n,
                uint16_t* run) {
  warp::sync();
  warp::each([&](int lane) {
    if (lane < 16) count[lane] = 0;
  });
  warp::sync();
  for (int c = 0; c < n; c += 32) {
    warp::Lanes<uint32_t> l = warp::map<uint32_t>(
        [&](int lane) { return c + lane < n ? (uint32_t)lens[c + lane] : 0u; });
    warp::Lanes<uint32_t> m = warp::match_any(l);
    warp::each([&](int lane) {
      uint32_t v = l.at(lane), mm = m.at(lane);
      if (v && (mm & ((1u << lane) - 1)) == 0) count[v] += warp::popc(mm);
    });
    warp::sync();
  }
  int left = 1;
  for (int len = 1; len < 16; len++) {
    left = (left << 1) - count[len];
    if (left < 0) return -1;
  }
  warp::each([&](int lane) {
    if (lane < 16) {
      int o = 0;
      for (int k = 1; k < lane; k++) o += count[k];
      run[lane] = (uint16_t)o;
    }
  });
  warp::sync();
  for (int c = 0; c < n; c += 32) {
    warp::Lanes<uint32_t> l = warp::map<uint32_t>(
        [&](int lane) { return c + lane < n ? (uint32_t)lens[c + lane] : 0u; });
    warp::Lanes<uint32_t> m = warp::match_any(l);
    warp::each([&](int lane) {
      uint32_t v = l.at(lane), below = m.at(lane) & ((1u << lane) - 1);
      if (v) sym[run[v] + warp::popc(below)] = (uint16_t)(c + lane);
    });
    warp::sync();
    warp::each([&](int lane) {
      uint32_t v = l.at(lane), mm = m.at(lane);
      if (v && (mm & ((1u << lane) - 1)) == 0) run[v] += warp::popc(mm);
    });
    warp::sync();
  }
  return 0;
}

// The first-level table of a code that is not over-subscribed. Codes of
// length l <= tb are consecutive from the canonical first code f_l, so
// they own the tb-bit prefixes (MSB first) [f_l << (tb - l), (f_l + count)
// << (tb - l)), one range after another; the prefixes past the last range
// belong to longer codes (or to none) and get LONG. The stream gives a
// code's first bit first, into the buffer's lowest bit, so a prefix's entry
// is at its bit reversal. Lanes split each range.
DC_FN void fill_table(uint16_t* tab, int tb, Walk& w, const uint16_t* count,
                      const uint16_t* sym) {
  int first = 0, index = 0, start = 0;
  for (int l = 1; l <= tb; l++) {
    int c = count[l], sh = tb - l, end = (first + c) << sh;
    warp::each([&](int lane) {
      for (int p = start + lane; p < end; p += 32) {
        tab[warp::brev((uint32_t)p, tb)] =
            (uint16_t)(sym[index + (p >> sh) - first] | l << 12);
      }
    });
    index += c;
    first = (first + c) << 1;
    start = end;
  }
  warp::each([&](int lane) {
    for (int p = start + lane; p < (1 << tb); p += 32) {
      tab[warp::brev((uint32_t)p, tb)] = LONG;
    }
  });
  if (warp::leader()) {
    w.first = first;
    w.index = index;
  }
  warp::sync();
}

// One symbol, or -1 when no code of <= 15 bits matches (a miss): the table
// entry of the next tb bits, else puff's canonical walk from length tb + 1.
DC_FN int decode(Bits& b, const uint16_t* tab, int tb, const Walk& w,
                 const uint16_t* count, const uint16_t* sym) {
  uint32_t bits = b.peek(15);
  uint32_t low = bits & ((1u << tb) - 1);
  uint32_t e = tab[low];
  if (e != LONG) {
    b.drop((int)(e >> 12));
    return (int)(e & 0xFFF);
  }
  int code = (int)warp::brev(low, tb) << 1, first = w.first, index = w.index;
  for (int len = tb + 1; len <= 15; len++) {
    code |= (int)((bits >> (len - 1)) & 1);
    int c = count[len];
    if (code - c < first) {
      b.drop(len);
      return sym[index + (code - first)];
    }
    index += c;
    first = (first + c) << 1;
    code <<= 1;
  }
  return -1;
}

DC_FN int stored_block(Bits& b, Trace& t, int32_t& out) {
  b.drop(b.nbits & 7);  // realign to a byte boundary
  uint32_t len = b.take(16);
  uint32_t nlen = b.take(16);
  if ((len ^ 0xFFFFu) != nlen) return ERR_DATA;
  while (len) {
    int k = len < 4 ? (int)len : 4;
    uint32_t w = b.take(8 * k);
    if (!emit(t, TOK_LIT | k, w)) return ERR_TCAP;
    out += k;
    len -= k;
  }
  return ERR_OK;
}

DC_FN void fixed_tables(Tables& T) {
  warp::sync();
  warp::each([&](int lane) {
    for (int s = lane; s < NLIT; s += 32) {
      T.lens[s] = (uint8_t)(s < 144 ? 8 : s < 256 ? 9 : s < 280 ? 7 : 8);
    }
    if (lane < 30) T.lens[NLIT + lane] = 5;
  });
  build(T.lcount, T.lsym, T.lens, NLIT, T.run);
  // 30 symbols, as the TPU kernel's fixed keys: codes 30/31 miss
  build(T.dcount, T.dsym, T.lens + NLIT, 30, T.run);
  fill_table(T.lit, LIT_TB, T.lwalk, T.lcount, T.lsym);
  fill_table(T.dist, DIST_TB, T.dwalk, T.dcount, T.dsym);
}

// The code-length code's order (16, 17, 18, 0, 8, 7, 9, 6, ..., 1, 15).
DC_FN int cl_order(int i) {
  if (i < 3) return 16 + i;
  if (i == 3) return 0;
  return (i & 1) ? 7 - ((i - 5) >> 1) : 8 + ((i - 4) >> 1);
}

DC_FN int dynamic_tables(Bits& b, Tables& T) {
  int nlen = (int)b.take(5) + 257;  // <= 288
  int ndist = (int)b.take(5) + 1;   // <= 32
  int ncode = (int)b.take(4) + 4;
  warp::sync();
  warp::each([&](int lane) {
    if (lane < NCL) T.lens[lane] = 0;
  });
  warp::sync();
  for (int i = 0; i < ncode; i++) {
    uint32_t v = b.take(3);
    if (warp::leader()) T.lens[cl_order(i)] = (uint8_t)v;
  }
  if (build(T.ccount, T.csym, T.lens, NCL, T.run) < 0) return ERR_DATA;
  fill_table(T.cl, CL_TB, T.cwalk, T.ccount, T.csym);
  int idx = 0, prev = 0;
  while (idx < nlen + ndist) {
    int sym = decode(b, T.cl, CL_TB, T.cwalk, T.ccount, T.csym);
    if (sym < 0) return ERR_DATA;
    if (sym < 16) {
      if (warp::leader()) T.lens[idx] = (uint8_t)sym;
      idx++;
      prev = sym;
      continue;
    }
    int rep, val = 0;
    if (sym == 16) {
      rep = 3 + (int)b.take(2);
      val = prev;  // 0 before any literal length, as the reference
    } else if (sym == 17) {
      rep = 3 + (int)b.take(3);
    } else {
      rep = 11 + (int)b.take(7);
    }
    if (idx + rep > nlen + ndist) return ERR_DATA;
    warp::each([&](int lane) {
      for (int k = lane; k < rep; k += 32) T.lens[idx + k] = (uint8_t)val;
    });
    idx += rep;
  }
  if (build(T.lcount, T.lsym, T.lens, nlen, T.run) < 0) return ERR_DATA;
  if (build(T.dcount, T.dsym, T.lens + nlen, ndist, T.run) < 0) {
    return ERR_DATA;
  }
  fill_table(T.lit, LIT_TB, T.lwalk, T.lcount, T.lsym);
  fill_table(T.dist, DIST_TB, T.dwalk, T.dcount, T.dsym);
  return ERR_OK;
}

DC_FN int codes_block(Bits& b, Trace& t, Tables& T, int32_t& out,
                      int32_t hist) {
  uint32_t litword = 0;
  int32_t litcnt = 0;
  const warp::SharedTable lit(T.lit);
  for (;;) {
    // a run of literals straight from the table, up to another entry
    DC_TICK(c0);
    uint32_t e = lit[b.peek(LIT_TB)];
    while (__builtin_expect((e & 0xF00) == 0, 1)) {
      b.drop((int)(e >> 12));
      litword |= (e & 0xFF) << (8 * litcnt);
      out++;
      t.n_lit++;
      if (++litcnt == 4) {
        if (!emit(t, TOK_LIT | 4, litword)) return ERR_TCAP;
        litword = 0;
        litcnt = 0;
      }
      e = lit[b.peek(LIT_TB)];
    }
    DC_TOCK(t.c_lit, c0);
    int sym;
    if (e != LONG) {
      b.drop((int)(e >> 12));
      sym = (int)(e & 0xFFF);
    } else {
      sym = decode(b, T.lit, LIT_TB, T.lwalk, T.lcount, T.lsym);
      if (sym < 0) return ERR_DATA;
    }
    if (sym < 256) {  // a literal of a code longer than the table's bits
      litword |= (uint32_t)sym << (8 * litcnt);
      out++;
      if (++litcnt == 4) {
        if (!emit(t, TOK_LIT | 4, litword)) return ERR_TCAP;
        litword = 0;
        litcnt = 0;
      }
      continue;
    }
    if (sym == 256) {
      if (litcnt && !emit(t, TOK_LIT | litcnt, litword)) return ERR_TCAP;
      return ERR_OK;
    }
    int slot = sym - 257;
    if (slot >= 29) return ERR_DATA;
    int el = (slot < 8 || slot == 28) ? 0 : (slot - 4) >> 2;
    int mlen = slot < 8 ? slot + 3
               : slot == 28 ? 258
                            : ((4 + (slot & 3)) << el) + 3;
    mlen += (int)b.take(el);
    int ds = decode(b, T.dist, DIST_TB, T.dwalk, T.dcount, T.dsym);
    if (ds < 0 || ds >= 30) return ERR_DATA;
    int ed = ds < 2 ? 0 : (ds >> 1) - 1;
    int dist = (ds < 2 ? ds + 1 : ((2 + (ds & 1)) << ed) + 1) +
               (int)b.take(ed);
    if (dist > out + hist) return ERR_DATA;
    if (!emit(t, TOK_MATCH | (litcnt << 25) | (mlen << 16) | (dist - 1),
              litword)) {
      return ERR_TCAP;
    }
    litword = 0;
    litcnt = 0;
    out += mlen;
  }
}

// Decode one stream of n bytes; hist is the history available before it
// (0 for a folder's first frame, 32768 after). Writes at most cap tokens.
DC_FN Result inflate(const uint8_t* src, int64_t n, int32_t hist,
                     int32_t* tok, int32_t* litw, int32_t cap, Tables& T) {
  Bits b;
  b.init(src, n);
  Trace t = {tok, litw, cap, 0, 0, 0, 0};
  DC_TICK(c_start);
  int32_t out = 0;
  int err = ERR_OK;
  bool fixed_built = false;  // T holds the fixed codes
  for (;;) {
    int final = (int)b.take(1);
    int type = (int)b.take(2);
    if (type == 0) {
      err = stored_block(b, t, out);
    } else if (type == 1) {
      DC_TICK(h0);
      if (!fixed_built) fixed_tables(T);
      DC_TOCK(t.c_hdr, h0);
      fixed_built = true;
      err = codes_block(b, t, T, out, hist);
    } else if (type == 2) {
      fixed_built = false;
      DC_TICK(h0);
      err = dynamic_tables(b, T);
      DC_TOCK(t.c_hdr, h0);
      if (err == ERR_OK) err = codes_block(b, t, T, out, hist);
    } else {
      err = ERR_DATA;
    }
    if (err != ERR_OK || final) break;
  }
  int64_t used = b.tell();
  Result r = {err, out, t.n, (int32_t)((used + 31) >> 5), 0,
              (int32_t)t.c_lit, (int32_t)t.c_hdr, (int32_t)t.n_lit};
#if defined(DC_CYCLES) && defined(__CUDA_ARCH__)
  r.c_all = (int32_t)(clock64() - c_start);
#endif
  return r;
}

// Counts rows of lane i in an (8, L) grid: 0 err, 1 output bytes,
// 2 tokens, 3 words consumed, 4-7 zero (a DC_CYCLES build: cycles in all,
// in literal runs and in block headers, and the literals of those runs).
DC_FN void write_counts(int32_t* cnt, int64_t L, int64_t i, Result r) {
  cnt[0 * L + i] = r.err;
  cnt[1 * L + i] = r.outbytes;
  cnt[2 * L + i] = r.ntok;
  cnt[3 * L + i] = r.words;
#ifdef DC_CYCLES
  cnt[4 * L + i] = r.c_all;
  cnt[5 * L + i] = r.c_lit;
  cnt[6 * L + i] = r.c_hdr;
  cnt[7 * L + i] = r.n_lit;
#else
  for (int row = 4; row < 8; row++) cnt[row * L + i] = 0;
#endif
}

}  // namespace dc

#ifdef DEFLATE_CORE_HOST_TWIN
// Host twin of the kernel's launch: the same per-stream call, one stream
// after another, with the warp's lanes evaluated in turn. Built only by
// the tests.
extern "C" int dc_inflate_host(const uint8_t* streams, int64_t stride,
                               const int32_t* lens, const int32_t* hists,
                               int L, int32_t* tok, int32_t* litw,
                               int32_t cap, int32_t* cnt) {
  dc::Tables T;
  for (int i = 0; i < L; i++) {
    dc::Result r = dc::inflate(streams + (int64_t)i * stride, lens[i],
                               hists[i], tok + (int64_t)i * cap,
                               litw + (int64_t)i * cap, cap, T);
    dc::write_counts(cnt, L, i, r);
  }
  return 0;
}

// The table decode alone, for the tests: build the code of lens[0..n) and
// its table of tb bits, then decode nsym symbols from src (nbytes bytes)
// into out_sym, each with the bit position after it in out_pos, stopping
// at a -1. Returns build's result (no decode when it is -1).
extern "C" int dc_table_decode(const uint8_t* lens, int n, int tb,
                               const uint8_t* src, int64_t nbytes, int nsym,
                               int32_t* out_sym, int64_t* out_pos) {
  dc::Tables T;
  dc::Walk w;
  int r = dc::build(T.lcount, T.lsym, lens, n, T.run);
  if (r < 0) return r;
  dc::fill_table(T.lit, tb, w, T.lcount, T.lsym);
  dc::Bits b;
  b.init(src, nbytes);
  for (int k = 0; k < nsym; k++) {
    out_sym[k] = dc::decode(b, T.lit, tb, w, T.lcount, T.lsym);
    out_pos[k] = b.tell();
    if (out_sym[k] < 0) break;
  }
  return r;
}

// The bit reader alone: takes ks[0..nk) bits in turn from src (nbytes
// bytes), each value into out_val and the position after it into out_pos.
extern "C" void dc_read_bits(const uint8_t* src, int64_t nbytes,
                             const int32_t* ks, int nk, uint32_t* out_val,
                             int64_t* out_pos) {
  dc::Bits b;
  b.init(src, nbytes);
  for (int k = 0; k < nk; k++) {
    out_val[k] = b.take(ks[k]);
    out_pos[k] = b.tell();
  }
}
#endif
