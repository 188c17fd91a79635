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
// The same functions run in the Hopper kernel (inflate.cu, one thread per
// stream) and in a host twin that g++ builds from this header alone (define
// DEFLATE_CORE_HOST_TWIN), so the tests check the kernel's logic on a CPU.
//
// Decoding is sequential and puff-style: a 64-bit bit buffer refilled one
// byte at a time, LSB-first, reading zeros past the stream's end (as the TPU
// kernel's zero-padded word grid does), and canonical Huffman decode from
// per-length counts plus a symbol list sorted by (length, symbol).
//
// Every condition the TPU kernel flags is flagged here, with err = 1:
// a Huffman miss, length slot >= 29, distance symbol 30 or 31 (the fixed
// tree has no codes for them), dist > output + history, an over-subscribed
// table, a bad stored LEN/NLEN, block type 3, and a code-length run past
// HLIT + HDIST. err = 2 means the token cap was reached.
#pragma once

#include <stdint.h>

#ifndef __CUDACC__
#define __host__
#define __device__
#endif

#define DC_FN static __host__ __device__ inline

namespace dc {

constexpr int32_t TOK_LIT = 0x20000000;
constexpr int32_t TOK_MATCH = 0x40000000;
constexpr int NLIT = 288;   // literal/length symbols (HLIT <= 288)
constexpr int NDIST = 32;   // distance symbols (HDIST <= 32)
constexpr int NCL = 19;     // code-length symbols

enum { ERR_OK = 0, ERR_DATA = 1, ERR_TCAP = 2 };

// Per-stream decode tables: 1096 bytes. The kernel keeps one per thread in
// shared memory; the host twin keeps one on the stack.
struct Tables {
  uint16_t lcount[16];
  uint16_t dcount[16];
  uint16_t ccount[16];
  uint16_t lsym[NLIT];
  uint16_t dsym[NDIST];
  uint16_t csym[NCL + 1];
  uint8_t lens[NLIT + NDIST];
};

struct Bits {
  const uint8_t* src;
  int64_t n;
  int64_t pos;
  uint64_t buf;
  int nbits;
};

struct Trace {
  int32_t* tok;
  int32_t* litw;
  int32_t cap;
  int32_t n;
};

struct Result {
  int32_t err;
  int32_t outbytes;
  int32_t ntok;
  int32_t words;  // 32-bit words of input consumed, rounded up
};

DC_FN void need(Bits& b, int k) {
  while (b.nbits < k) {
    uint64_t v = b.pos < b.n ? b.src[b.pos] : 0;
    b.pos++;
    b.buf |= v << b.nbits;
    b.nbits += 8;
  }
}

DC_FN uint32_t peek(Bits& b, int k) {
  need(b, k);
  return (uint32_t)(b.buf & ((1ull << k) - 1));
}

DC_FN void drop(Bits& b, int k) {
  b.buf >>= k;
  b.nbits -= k;
}

DC_FN uint32_t take(Bits& b, int k) {
  uint32_t v = peek(b, k);
  drop(b, k);
  return v;
}

DC_FN bool emit(Trace& t, int32_t tok, int32_t litw) {
  if (t.n >= t.cap) return false;
  t.tok[t.n] = tok;
  t.litw[t.n] = litw;
  t.n++;
  return true;
}

// Canonical code from code lengths. Returns -1 when over-subscribed
// (the TPU kernel's limit[l] > 2^l test), 0 otherwise; incomplete codes
// are accepted and decode to a miss.
DC_FN int build(uint16_t* count, uint16_t* symbol, const uint8_t* length,
                int n) {
  uint16_t offs[16];
  for (int l = 0; l < 16; l++) count[l] = 0;
  for (int s = 0; s < n; s++) count[length[s]]++;
  int left = 1;
  for (int l = 1; l < 16; l++) {
    left = (left << 1) - count[l];
    if (left < 0) return -1;
  }
  offs[1] = 0;
  for (int l = 1; l < 15; l++) offs[l + 1] = offs[l] + count[l];
  for (int s = 0; s < n; s++) {
    if (length[s]) symbol[offs[length[s]]++] = (uint16_t)s;
  }
  return 0;
}

// One symbol, or -1 when no code of <= 15 bits matches (a miss).
DC_FN int decode(Bits& b, const uint16_t* count, const uint16_t* symbol) {
  uint32_t bits = peek(b, 15);
  int code = 0, first = 0, index = 0;
  for (int len = 1; len <= 15; len++) {
    code |= (int)(bits & 1);
    bits >>= 1;
    int c = count[len];
    if (code - c < first) {
      drop(b, len);
      return symbol[index + (code - first)];
    }
    index += c;
    first = (first + c) << 1;
    code <<= 1;
  }
  return -1;
}

DC_FN int stored_block(Bits& b, Trace& t, int32_t& out) {
  drop(b, b.nbits & 7);  // realign to a byte boundary
  uint32_t len = take(b, 16);
  uint32_t nlen = take(b, 16);
  if ((len ^ 0xFFFFu) != nlen) return ERR_DATA;
  while (len) {
    int k = len < 4 ? (int)len : 4;
    uint32_t w = take(b, 8 * k);
    if (!emit(t, TOK_LIT | k, (int32_t)w)) return ERR_TCAP;
    out += k;
    len -= k;
  }
  return ERR_OK;
}

DC_FN void fixed_tables(Tables& tb) {
  for (int s = 0; s < 144; s++) tb.lens[s] = 8;
  for (int s = 144; s < 256; s++) tb.lens[s] = 9;
  for (int s = 256; s < 280; s++) tb.lens[s] = 7;
  for (int s = 280; s < NLIT; s++) tb.lens[s] = 8;
  for (int s = 0; s < 30; s++) tb.lens[NLIT + s] = 5;
  build(tb.lcount, tb.lsym, tb.lens, NLIT);
  // 30 symbols, as the TPU kernel's fixed keys: codes 30/31 miss
  build(tb.dcount, tb.dsym, tb.lens + NLIT, 30);
}

DC_FN int dynamic_tables(Bits& b, Tables& tb) {
  const uint8_t order[NCL] = {16, 17, 18, 0, 8, 7, 9, 6, 10, 5,
                              11, 4, 12, 3, 13, 2, 14, 1, 15};
  int nlen = (int)take(b, 5) + 257;  // <= 288
  int ndist = (int)take(b, 5) + 1;   // <= 32
  int ncode = (int)take(b, 4) + 4;
  for (int i = 0; i < NCL; i++) tb.lens[i] = 0;
  for (int i = 0; i < ncode; i++) tb.lens[order[i]] = (uint8_t)take(b, 3);
  if (build(tb.ccount, tb.csym, tb.lens, NCL) < 0) return ERR_DATA;
  int idx = 0, prev = 0;
  while (idx < nlen + ndist) {
    int sym = decode(b, tb.ccount, tb.csym);
    if (sym < 0) return ERR_DATA;
    if (sym < 16) {
      tb.lens[idx++] = (uint8_t)sym;
      prev = sym;
      continue;
    }
    int rep, val = 0;
    if (sym == 16) {
      rep = 3 + (int)take(b, 2);
      val = prev;  // 0 before any literal length, as the reference
    } else if (sym == 17) {
      rep = 3 + (int)take(b, 3);
    } else {
      rep = 11 + (int)take(b, 7);
    }
    if (idx + rep > nlen + ndist) return ERR_DATA;
    while (rep--) tb.lens[idx++] = (uint8_t)val;
  }
  if (build(tb.lcount, tb.lsym, tb.lens, nlen) < 0) return ERR_DATA;
  if (build(tb.dcount, tb.dsym, tb.lens + nlen, ndist) < 0) return ERR_DATA;
  return ERR_OK;
}

DC_FN int codes_block(Bits& b, Trace& t, const Tables& tb, int32_t& out,
                      int32_t hist) {
  uint32_t litword = 0;
  int32_t litcnt = 0;
  for (;;) {
    int sym = decode(b, tb.lcount, tb.lsym);
    if (sym < 0) return ERR_DATA;
    if (sym < 256) {
      litword |= (uint32_t)sym << (8 * litcnt);
      out++;
      if (++litcnt == 4) {
        if (!emit(t, TOK_LIT | 4, (int32_t)litword)) return ERR_TCAP;
        litword = 0;
        litcnt = 0;
      }
      continue;
    }
    if (sym == 256) {
      if (litcnt && !emit(t, TOK_LIT | litcnt, (int32_t)litword)) {
        return ERR_TCAP;
      }
      return ERR_OK;
    }
    int slot = sym - 257;
    if (slot >= 29) return ERR_DATA;
    int el = (slot < 8 || slot == 28) ? 0 : (slot - 4) >> 2;
    int mlen = slot < 8 ? slot + 3
               : slot == 28 ? 258
                            : ((4 + (slot & 3)) << el) + 3;
    mlen += (int)take(b, el);
    int ds = decode(b, tb.dcount, tb.dsym);
    if (ds < 0 || ds >= 30) return ERR_DATA;
    int ed = ds < 2 ? 0 : (ds >> 1) - 1;
    int dist = (ds < 2 ? ds + 1 : ((2 + (ds & 1)) << ed) + 1) + (int)take(b, ed);
    if (dist > out + hist) return ERR_DATA;
    if (!emit(t, TOK_MATCH | (litcnt << 25) | (mlen << 16) | (dist - 1),
              (int32_t)litword)) {
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
                     int32_t* tok, int32_t* litw, int32_t cap, Tables& tb) {
  Bits b = {src, n, 0, 0, 0};
  Trace t = {tok, litw, cap, 0};
  int32_t out = 0;
  int err = ERR_OK;
  for (;;) {
    int final = (int)take(b, 1);
    int type = (int)take(b, 2);
    if (type == 0) {
      err = stored_block(b, t, out);
    } else if (type == 1) {
      fixed_tables(tb);
      err = codes_block(b, t, tb, out, hist);
    } else if (type == 2) {
      err = dynamic_tables(b, tb);
      if (err == ERR_OK) err = codes_block(b, t, tb, out, hist);
    } else {
      err = ERR_DATA;
    }
    if (err != ERR_OK || final) break;
  }
  int64_t used = b.pos * 8 - b.nbits;
  Result r = {err, out, t.n, (int32_t)((used + 31) >> 5)};
  return r;
}

// Counts rows of lane i in an (8, L) grid: 0 err, 1 output bytes,
// 2 tokens, 3 words consumed, 4-7 zero.
DC_FN void write_counts(int32_t* cnt, int64_t L, int64_t i, Result r) {
  cnt[0 * L + i] = r.err;
  cnt[1 * L + i] = r.outbytes;
  cnt[2 * L + i] = r.ntok;
  cnt[3 * L + i] = r.words;
  for (int row = 4; row < 8; row++) cnt[row * L + i] = 0;
}

}  // namespace dc

#ifdef DEFLATE_CORE_HOST_TWIN
// Host twin of the kernel's launch: the same per-lane call, one lane after
// another. Built only by the tests.
extern "C" int dc_inflate_host(const uint8_t* streams, int64_t stride,
                               const int32_t* lens, const int32_t* hists,
                               int L, int32_t* tok, int32_t* litw,
                               int32_t cap, int32_t* cnt) {
  dc::Tables tb;
  for (int i = 0; i < L; i++) {
    dc::Result r = dc::inflate(streams + (int64_t)i * stride, lens[i],
                               hists[i], tok + (int64_t)i * cap,
                               litw + (int64_t)i * cap, cap, tb);
    dc::write_counts(cnt, L, i, r);
  }
  return 0;
}
#endif
