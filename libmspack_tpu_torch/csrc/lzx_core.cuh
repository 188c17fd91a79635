// LZX phase A for one stream: decode an LZX (or LZX DELTA) stream into the
// token trace of libmspack_tpu/ops/pallas_lzx.py (format at :39-45):
//
//   -1                    NOP (never emitted here; padding)
//   0x20000000 | n        n in 1..4 literal bytes, LSB-first in litw
//   0x40000000 | len      a match of len bytes (2..33024); litw = the
//                         linear distance back in the output
//
// The same functions run in the Hopper kernel (lzx.cu, one thread per
// stream) and in a host twin that g++ builds from this header alone (define
// LZX_CORE_HOST_TWIN), so the tests check the kernel's logic on a CPU.
//
// The decoder is sequential and follows the reference codec
// (libmspack_tpu/codecs/lzx.py, lzxd.c) step for step: an MSB-first bit
// reader over 16-bit little-endian units, reading zeros past the stream's
// end; canonical Huffman decode from per-length counts plus a symbol list
// sorted by (length, symbol); code lengths delta-coded through the pretree;
// R0-R2; aligned offsets; uncompressed blocks; the 16-bit realign at every
// 32 KiB of output; the DELTA long-match escape and 16-bit chunk field; the
// intel E8 header. A match whose ring-window source was overwritten in this
// lap (offset > window) splits into two linear-distance tokens, as
// codecs/lzx.py:337-357 does.
//
// Its whole state lives in one State record per stream, which the caller
// allocates: the decoder works on it in place, so passing the record of a
// stopped decode back in resumes it. Decodes stop at a target output
// position, which is a multiple of 32 KiB except at the stream's end; the
// record is then at a frame start.
//
// Errors (err = 1) are the reference's: a bad block type, a pretree, main,
// aligned or non-empty length tree that is not a complete code, a LENGTH
// symbol from an empty length tree, a match past the block, frame or window
// end, and a match offset beyond the stream and the history budget. err = 2
// means the token cap was reached.
#pragma once

#include <stdint.h>

#ifndef __CUDACC__
#define __host__
#define __device__
#endif

#define LZ_FN static __host__ __device__ inline

namespace lz {

constexpr int32_t TOK_LIT = 0x20000000;
constexpr int32_t TOK_MATCH = 0x40000000;
constexpr int FRAME = 32768;
constexpr int NPRE = 20;
constexpr int MAIN_MAX = 256 + 290 * 8;  // main tree symbols at window 2^25
constexpr int NLEN = 250;                // length tree (249 coded + 1)
constexpr int NALN = 8;
constexpr int SAFETY = 64;               // code-length runs may overshoot

enum { ERR_OK = 0, ERR_DATA = 1, ERR_TCAP = 2 };

// One stream's whole decoder state (8800 bytes). The layout is mirrored by
// STATE_DTYPE in libmspack_tpu_torch/ops/cuda_lzx.py; keep the two in step.
struct State {
  int64_t bitpos;           // input cursor, in bits from the stream's start
  int64_t outpos;           // output bytes decoded
  uint32_t r0, r1, r2;      // repeated offsets
  int32_t block_type;       // 0 before the first block
  int32_t block_remaining;
  int32_t block_length;
  int32_t header_read;
  int32_t intel_started;
  int32_t intel_filesize;
  int32_t length_empty;
  int32_t err;
  int32_t pad;
  uint16_t main_count[17], len_count[17], aln_count[17];
  uint16_t main_sym[MAIN_MAX];
  uint16_t len_sym[NLEN];
  uint16_t aln_sym[NALN];
  uint8_t main_lens[MAIN_MAX + SAFETY];
  uint8_t len_lens[NLEN + SAFETY];
  uint8_t aln_lens[NALN];
};

struct Bits {
  const uint8_t* src;
  int64_t n;
  int64_t upos;   // byte position of the next 16-bit unit to load
  uint64_t buf;   // the next bits, MSB first
  int nbits;
};

struct Trace {
  int32_t* tok;
  int32_t* litw;
  int32_t cap;
  int32_t n;
  uint32_t word;  // pending literals, LSB first
  int32_t cnt;
};

struct Result {
  int32_t err;
  int32_t outpos;
  int32_t ntok;
  int32_t cursor;  // input bytes consumed, rounded up
  int32_t intel_started;
  int32_t intel_filesize;
};

LZ_FN uint32_t byte_at(const Bits& b, int64_t p) {
  return p < b.n ? b.src[p] : 0u;
}

LZ_FN void fill(Bits& b) {
  while (b.nbits <= 48) {
    uint64_t u = byte_at(b, b.upos) | (byte_at(b, b.upos + 1) << 8);
    b.upos += 2;
    b.buf |= u << (48 - b.nbits);
    b.nbits += 16;
  }
}

LZ_FN int64_t tell(const Bits& b) { return b.upos * 8 - b.nbits; }

LZ_FN void drop(Bits& b, int k) {
  b.buf <<= k;
  b.nbits -= k;
}

LZ_FN uint32_t peek(Bits& b, int k) {
  if (b.nbits < k) fill(b);
  return (uint32_t)(b.buf >> (64 - k));
}

LZ_FN uint32_t take(Bits& b, int k) {
  if (k == 0) return 0;
  uint32_t v = peek(b, k);
  drop(b, k);
  return v;
}

// Position the reader at bit p (units stay aligned to even bytes).
LZ_FN void seek(Bits& b, int64_t p) {
  b.upos = (p >> 4) << 1;
  b.buf = 0;
  b.nbits = 0;
  if (p & 15) {
    fill(b);
    drop(b, (int)(p & 15));
  }
}

LZ_FN bool emit(Trace& t, int32_t tok, uint32_t litw) {
  if (t.n >= t.cap) return false;
  t.tok[t.n] = tok;
  t.litw[t.n] = (int32_t)litw;
  t.n++;
  return true;
}

LZ_FN bool flush(Trace& t) {
  if (!t.cnt) return true;
  if (!emit(t, TOK_LIT | t.cnt, t.word)) return false;
  t.word = 0;
  t.cnt = 0;
  return true;
}

LZ_FN bool literal(Trace& t, uint32_t v) {
  t.word |= v << (8 * t.cnt);
  if (++t.cnt < 4) return true;
  return flush(t);
}

// Canonical code from code lengths (lengths above 16 are no code, as in
// the reference's table build). Returns the unused code space out of 2^16:
// 0 for a complete code, -1 when over-subscribed.
LZ_FN int build(uint16_t* count, uint16_t* sym, const uint8_t* lens, int n) {
  uint16_t offs[17];
  for (int l = 0; l < 17; l++) count[l] = 0;
  for (int s = 0; s < n; s++) {
    if (lens[s] <= 16) count[lens[s]]++;
  }
  count[0] = 0;
  int left = 1;
  for (int l = 1; l < 17; l++) {
    left = (left << 1) - count[l];
    if (left < 0) return -1;
  }
  offs[1] = 0;
  for (int l = 1; l < 16; l++) offs[l + 1] = offs[l] + count[l];
  for (int s = 0; s < n; s++) {
    int l = lens[s];
    if (l >= 1 && l <= 16) sym[offs[l]++] = (uint16_t)s;
  }
  return left;
}

// One symbol, MSB first, or -1 when no code of <= 16 bits matches.
LZ_FN int decode(Bits& b, const uint16_t* count, const uint16_t* sym) {
  uint32_t bits = peek(b, 16);
  int code = 0, first = 0, index = 0;
  for (int len = 1; len <= 16; len++) {
    code |= (int)((bits >> (16 - len)) & 1);
    int c = count[len];
    if (code - c < first) {
      drop(b, len);
      return sym[index + (code - first)];
    }
    index += c;
    first = (first + c) << 1;
    code <<= 1;
  }
  return -1;
}

// Code lengths lens[first..last) delta-coded against their previous values
// through a fresh pretree (lzxd.c:138-183, codecs/lzx.py:162-198). A run
// may overshoot last by up to 51 entries, into the next range or the
// SAFETY tail, as the reference's does.
LZ_FN int read_lens(Bits& b, uint8_t* lens, int first, int last) {
  uint8_t plens[NPRE];
  uint16_t pcount[17], psym[NPRE];
  for (int i = 0; i < NPRE; i++) plens[i] = (uint8_t)take(b, 4);
  if (build(pcount, psym, plens, NPRE) != 0) return ERR_DATA;
  int pos = first;
  while (pos < last) {
    int sym = decode(b, pcount, psym);
    if (sym < 0) return ERR_DATA;
    int run = 1, value = 0;
    if (sym == 17) {
      run = (int)take(b, 4) + 4;
    } else if (sym == 18) {
      run = (int)take(b, 5) + 20;
    } else {
      if (sym == 19) {
        run = (int)take(b, 1) + 4;
        sym = decode(b, pcount, psym);
        if (sym < 0) return ERR_DATA;
      }
      value = lens[pos] - sym;
      if (value < 0) value += 17;
      value &= 0xFF;
    }
    for (int k = 0; k < run; k++) lens[pos + k] = (uint8_t)value;
    pos += run;
  }
  return ERR_OK;
}

LZ_FN int begin_block(Bits& b, State& s, int num_offsets) {
  if (s.block_type == 3 && (s.block_length & 1)) {
    seek(b, tell(b) + 8);  // the pad byte after an odd uncompressed block
  }
  s.block_type = (int32_t)take(b, 3);
  uint32_t hi = take(b, 16);
  uint32_t lo = take(b, 8);
  s.block_remaining = s.block_length = (int32_t)((hi << 8) | lo);
  if (s.block_type == 3) {
    s.intel_started = 1;
    // drop the reference's buffered bits: 1-16, to the next 16-bit unit
    int64_t p = ((tell(b) >> 4) + 1) << 4;
    int64_t q = p >> 3;
    uint32_t r[3];
    for (int k = 0; k < 3; k++) {
      r[k] = byte_at(b, q) | (byte_at(b, q + 1) << 8) |
             (byte_at(b, q + 2) << 16) | (byte_at(b, q + 3) << 24);
      q += 4;
    }
    s.r0 = r[0];
    s.r1 = r[1];
    s.r2 = r[2];
    seek(b, q * 8);
    return ERR_OK;
  }
  if (s.block_type != 1 && s.block_type != 2) return ERR_DATA;
  if (s.block_type == 2) {
    for (int i = 0; i < NALN; i++) s.aln_lens[i] = (uint8_t)take(b, 3);
    if (build(s.aln_count, s.aln_sym, s.aln_lens, NALN) != 0) return ERR_DATA;
  }
  int err = read_lens(b, s.main_lens, 0, 256);
  if (err == ERR_OK) err = read_lens(b, s.main_lens, 256, 256 + num_offsets);
  if (err != ERR_OK) return err;
  if (build(s.main_count, s.main_sym, s.main_lens, MAIN_MAX) != 0) {
    return ERR_DATA;
  }
  if (s.main_lens[0xE8]) s.intel_started = 1;
  err = read_lens(b, s.len_lens, 0, NLEN - 1);
  if (err != ERR_OK) return err;
  // an all-zero length tree is allowed until a LENGTH symbol needs it
  s.length_empty = 1;
  for (int i = 0; i < NLEN; i++) {
    if (s.len_lens[i]) s.length_empty = 0;
  }
  int left = build(s.len_count, s.len_sym, s.len_lens, NLEN);
  return left == 0 || s.length_empty ? ERR_OK : ERR_DATA;
}

LZ_FN int64_t position_base(int slot) {
  if (slot < 4) return slot;
  if (slot < 38) return (int64_t)(2 + (slot & 1)) << ((slot >> 1) - 1);
  return 524288 + (int64_t)(slot - 38) * 131072;
}

// A match: main element sym >= 256 decoded at s.outpos in the frame that
// starts at fbase and ends at fend.
LZ_FN int match(Bits& b, State& s, Trace& t, int sym, int64_t fbase,
                int64_t fend, int wbits, int delta, int32_t hist) {
  int elem = sym - 256;
  int64_t len = elem & 7;
  if (len == 7) {
    if (s.length_empty) return ERR_DATA;
    int ls = decode(b, s.len_count, s.len_sym);
    if (ls < 0) return ERR_DATA;
    len += ls;
  }
  len += 2;
  int slot = elem >> 3;
  uint32_t off;
  if (slot == 0) {
    off = s.r0;
  } else if (slot == 1) {
    off = s.r1;
    s.r1 = s.r0;
    s.r0 = off;
  } else if (slot == 2) {
    off = s.r2;
    s.r2 = s.r0;
    s.r0 = off;
  } else {
    int extra = slot >= 36 ? 17 : (slot >> 1) - 1;
    off = (uint32_t)(position_base(slot) - 2);
    if (extra >= 3 && s.block_type == 2) {
      if (extra > 3) off += take(b, extra - 3) << 3;
      int a = decode(b, s.aln_count, s.aln_sym);
      if (a < 0) return ERR_DATA;
      off += (uint32_t)a;
    } else if (extra) {
      off += take(b, extra);
    }
    s.r2 = s.r1;
    s.r1 = s.r0;
    s.r0 = off;
  }
  if (delta && len == 257) {  // long-match escape (lzxd.c:588-611)
    uint32_t e = peek(b, 3);
    if ((e >> 2) == 0) {
      drop(b, 1);
      len += take(b, 8);
    } else if ((e >> 1) == 2) {
      drop(b, 2);
      len += take(b, 10) + 0x100;
    } else if (e == 6) {
      drop(b, 3);
      len += take(b, 12) + 0x500;
    } else {
      drop(b, 3);
      len += take(b, 15);
    }
  }
  int64_t wsize = (int64_t)1 << wbits;
  int64_t lap = s.outpos & (wsize - 1);
  int64_t o = off;
  if (lap + len > wsize) return ERR_DATA;           // over the window wrap
  if (len > s.block_remaining || s.outpos + len > fend) return ERR_DATA;
  int64_t first = len;
  if (o > lap) {
    if (o > fbase && o - lap > hist) return ERR_DATA;  // beyond the stream
    if (o - lap > wsize) return ERR_DATA;
    if (o > wsize && len > o - lap) first = o - lap;   // ring alias: split
  }
  if (!flush(t)) return ERR_TCAP;
  if (o > lap && o > wsize) {
    if (!emit(t, TOK_MATCH | (int32_t)first, (uint32_t)(o - wsize))) {
      return ERR_TCAP;
    }
    if (first < len && !emit(t, TOK_MATCH | (int32_t)(len - first), off)) {
      return ERR_TCAP;
    }
  } else if (!emit(t, TOK_MATCH | (int32_t)len, off)) {
    return ERR_TCAP;
  }
  s.outpos += len;
  s.block_remaining -= (int32_t)len;
  return ERR_OK;
}

// Decode frames until s.outpos reaches target (or an error).
LZ_FN int run(Bits& b, State& s, Trace& t, int64_t target, int32_t hist,
              int wbits, int delta) {
  const uint16_t slots[11] = {30, 32, 34, 36, 38, 42, 50, 66, 98, 162, 290};
  int num_offsets = slots[wbits - 15] << 3;
  while (s.outpos < target) {
    int64_t fbase = s.outpos;
    int64_t fend = fbase + FRAME < target ? fbase + FRAME : target;
    if (delta) take(b, 16);  // the chunk size field before each frame
    if (!s.header_read) {
      int32_t v = 0;
      if (take(b, 1)) {
        uint32_t hi = take(b, 16);
        v = (int32_t)((hi << 16) | take(b, 16));
      }
      s.intel_filesize = v;
      s.header_read = 1;
    }
    while (s.outpos < fend) {
      if (s.block_remaining == 0) {
        int err = begin_block(b, s, num_offsets);
        if (err != ERR_OK) return err;
        continue;
      }
      if (s.block_type == 3) {  // raw bytes, from the byte cursor
        int64_t k = fend - s.outpos;
        if (s.block_remaining < k) k = s.block_remaining;
        int64_t q = tell(b) >> 3;
        for (int64_t j = 0; j < k; j++) {
          if (!literal(t, byte_at(b, q + j))) return ERR_TCAP;
        }
        seek(b, (q + k) * 8);
        s.outpos += k;
        s.block_remaining -= (int32_t)k;
        continue;
      }
      int sym = decode(b, s.main_count, s.main_sym);
      if (sym < 0) return ERR_DATA;
      if (sym < 256) {
        if (!literal(t, (uint32_t)sym)) return ERR_TCAP;
        s.outpos++;
        s.block_remaining--;
        continue;
      }
      int err = match(b, s, t, sym, fbase, fend, wbits, delta, hist);
      if (err != ERR_OK) return err;
    }
    // realign to 16 bits; in an uncompressed block the reference holds no
    // buffered bits and reads on from its byte cursor
    if (s.block_type != 3) seek(b, (tell(b) + 15) & ~(int64_t)15);
  }
  return flush(t) ? ERR_OK : ERR_TCAP;
}

LZ_FN void init(State& s) {
  uint8_t* p = reinterpret_cast<uint8_t*>(&s);
  for (unsigned k = 0; k < sizeof(State); k++) p[k] = 0;
  s.r0 = s.r1 = s.r2 = 1;
}

// Decode one stream of n bytes up to output position target, resuming
// from s; hist is the history budget before the stream's start (DELTA
// reference data). Writes at most cap tokens.
LZ_FN Result decode_stream(const uint8_t* src, int64_t n, int64_t target,
                           int32_t hist, int wbits, int delta, State& s,
                           int32_t* tok, int32_t* litw, int32_t cap) {
  Trace t = {tok, litw, cap, 0, 0, 0};
  if (s.err == ERR_OK && s.outpos < target) {
    Bits b = {src, n, 0, 0, 0};
    seek(b, s.bitpos);
    s.err = run(b, s, t, target, hist, wbits, delta);
    s.bitpos = tell(b);
  }
  Result r = {s.err, (int32_t)s.outpos, t.n, (int32_t)((s.bitpos + 7) >> 3),
              s.intel_started, s.intel_filesize};
  return r;
}

// Counts rows of lane i in an (8, L) grid: 0 err, 1 output position,
// 2 tokens, 3 input bytes consumed, 4 intel_started, 5 intel_filesize,
// 6-7 zero.
LZ_FN void write_counts(int32_t* cnt, int64_t L, int64_t i, Result r) {
  cnt[0 * L + i] = r.err;
  cnt[1 * L + i] = r.outpos;
  cnt[2 * L + i] = r.ntok;
  cnt[3 * L + i] = r.cursor;
  cnt[4 * L + i] = r.intel_started;
  cnt[5 * L + i] = r.intel_filesize;
  cnt[6 * L + i] = 0;
  cnt[7 * L + i] = 0;
}

}  // namespace lz

#ifdef LZX_CORE_HOST_TWIN
// Host twin of the kernel's launch: the same per-lane call, one lane after
// another. Built only by the tests.
extern "C" int64_t lz_state_bytes() { return sizeof(lz::State); }

extern "C" int lz_decode_host(const uint8_t* streams, int64_t stride,
                              const int32_t* lens, const int32_t* targets,
                              const int32_t* hists, int L, int wbits,
                              int delta, int fresh, uint8_t* states,
                              int32_t* tok, int32_t* litw, int32_t cap,
                              int32_t* cnt) {
  for (int i = 0; i < L; i++) {
    lz::State& s = reinterpret_cast<lz::State*>(states)[i];
    if (fresh) lz::init(s);
    lz::Result r = lz::decode_stream(
        streams + (int64_t)i * stride, lens[i], targets[i], hists[i], wbits,
        delta, s, tok + (int64_t)i * cap, litw + (int64_t)i * cap, cap);
    lz::write_counts(cnt, L, i, r);
  }
  return 0;
}
#endif
