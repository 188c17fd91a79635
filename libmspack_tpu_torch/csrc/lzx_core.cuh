// LZX phase A for one stream: decode an LZX (or LZX DELTA) stream into the
// token trace of libmspack_tpu/ops/pallas_lzx.py (format at :39-45):
//
//   -1                    NOP (never emitted here; padding)
//   0x20000000 | n        n in 1..4 literal bytes, LSB-first in litw
//   0x40000000 | len      a match of len bytes (2..33024); litw = the
//                         linear distance back in the output
//
// The same functions run in the Hopper kernel (lzx.cu, one warp per stream,
// the State record and the lookup tables in shared memory) and in a host
// twin that g++ builds from this header and stream_core.cuh (define
// LZX_CORE_HOST_TWIN), so the tests check the kernel's logic, its warp
// steps included, on a CPU.
//
// The decoder is sequential and follows the reference codec
// (libmspack_tpu/codecs/lzx.py, lzxd.c): an MSB-first bit reader over
// 16-bit little-endian units, reading zeros past the stream's end;
// canonical Huffman codes from per-length counts plus a symbol list sorted
// by (length, symbol); code lengths delta-coded through the pretree; R0-R2;
// aligned offsets; uncompressed blocks; the 16-bit realign at every 32 KiB
// of output; the DELTA long-match escape and 16-bit chunk field; the intel
// E8 header. A match whose ring-window source was overwritten in this lap
// (offset > window) splits into two linear-distance tokens, as
// codecs/lzx.py:337-357 does.
//
// Each tree also gets a first-level lookup table (Tables): the symbol and
// length of every code of at most its table's bits, packed in 16 bits, so
// a symbol is one table read; a longer code goes on through the canonical
// walk from the table's bits + 1. The warp fills a table lane by lane from
// the tree's canonical code once a block header has built it (and on
// resuming a record inside a block). Runs of literals decode in a loop
// straight off the main table. The hot scalars (bit buffer and cursor,
// outpos, the block's state, R0-R2) stay in registers (Regs).
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

#include "stream_core.cuh"

#define LZ_FN SC_FN

namespace lz {

constexpr int32_t TOK_LIT = 0x20000000;
constexpr int32_t TOK_MATCH = 0x40000000;
constexpr int FRAME = 32768;
constexpr int NPRE = 20;
constexpr int MAIN_MAX = 256 + 290 * 8;  // main tree symbols at window 2^25
constexpr int NLEN = 250;                // length tree (249 coded + 1)
constexpr int NALN = 8;
constexpr int SAFETY = 64;               // code-length runs may overshoot

// first-level table bits of the main, length, aligned and pretree tables
constexpr int MAIN_TB = 12, LEN_TB = 10, ALN_TB = 7, PRE_TB = 8;
// A table entry: symbol | (length - 1) << 12, or LONG for a prefix of a
// code longer than the table's bits (no code in a table has length 16).
// A literal's entry, and only a literal's, has bits 8-11 clear.
constexpr uint16_t LONG = 0xFFFF;

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

// Where the canonical walk resumes past a table's bits: the first code and
// the symbol index of the next length.
struct Walk {
  int32_t first, index;
};

// The kernel's shared memory beside the State record: the lookup tables,
// the pretree's canonical code and the scratch of build.
struct Tables {
  uint16_t main[1 << MAIN_TB];
  uint16_t len[1 << LEN_TB];
  uint16_t aln[1 << ALN_TB];
  uint16_t pre[1 << PRE_TB];
  Walk main_walk, len_walk, aln_walk, pre_walk;
  uint16_t pcount[17], psym[NPRE], offs[17];
  uint8_t plens[NPRE];
};

using Bits = BitReader<true>;

// The scalars of a State, in registers while a launch decodes.
struct Regs {
  int64_t outpos;
  uint32_t r0, r1, r2;
  int32_t block_type, block_remaining, block_length, header_read;
  int32_t intel_started, intel_filesize, length_empty;
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

LZ_FN bool emit(Trace& t, int32_t tok, uint32_t litw) {
  if (t.n >= t.cap) return false;
  if (warp::leader()) {
    t.tok[t.n] = tok;
    t.litw[t.n] = (int32_t)litw;
  }
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
// the reference's table build), lane 0 writing count and sym. Returns the
// unused code space out of 2^16: 0 for a complete code, -1 when
// over-subscribed (sym then untouched).
LZ_FN int build(uint16_t* count, uint16_t* sym, const uint8_t* lens, int n,
                uint16_t* offs) {
  warp::sync();
  if (warp::leader()) {
    for (int l = 0; l < 17; l++) count[l] = 0;
    for (int s = 0; s < n; s++) {
      if (lens[s] <= 16) count[lens[s]]++;
    }
    count[0] = 0;
  }
  warp::sync();
  int left = 1;
  for (int l = 1; l < 17; l++) {
    left = (left << 1) - count[l];
    if (left < 0) return -1;
  }
  if (warp::leader()) {
    offs[1] = 0;
    for (int l = 1; l < 16; l++) offs[l + 1] = offs[l] + count[l];
    for (int s = 0; s < n; s++) {
      int l = lens[s];
      if (l >= 1 && l <= 16) sym[offs[l]++] = (uint16_t)s;
    }
  }
  warp::sync();
  return left;
}

// The first-level table of a code that is not over-subscribed. Codes of
// length l <= tb are consecutive from the canonical first code f_l, so
// they fill the tb-bit prefixes [f_l << (tb - l), (f_l + count) << (tb -
// l)), one range after another; the prefixes past the last range belong to
// longer codes (or to none) and get LONG. Lanes split each range.
LZ_FN void fill_table(uint16_t* tab, int tb, Walk& w, const uint16_t* count,
                      const uint16_t* sym) {
  int first = 0, index = 0, start = 0;
  for (int l = 1; l <= tb; l++) {
    int c = count[l], sh = tb - l, end = (first + c) << sh;
    warp::each([&](int lane) {
      for (int e = start + lane; e < end; e += 32) {
        tab[e] = (uint16_t)(sym[index + (e >> sh) - first] | (l - 1) << 12);
      }
    });
    index += c;
    first = (first + c) << 1;
    start = end;
  }
  warp::each([&](int lane) {
    for (int e = start + lane; e < (1 << tb); e += 32) tab[e] = LONG;
  });
  if (warp::leader()) {
    w.first = first;
    w.index = index;
  }
  warp::sync();
}

// One symbol, MSB first, or -1 when no code of <= 16 bits matches: the
// table entry of the next tb bits, else the reference's canonical walk
// (lzxd.c's table fallback) from length tb + 1.
LZ_FN int decode(Bits& b, const uint16_t* tab, int tb, const Walk& w,
                 const uint16_t* count, const uint16_t* sym) {
  uint32_t bits = b.peek(16);
  uint32_t e = tab[bits >> (16 - tb)];
  if (e != LONG) {
    b.drop((int)(e >> 12) + 1);
    return (int)(e & 0xFFF);
  }
  int code = (int)(bits >> (16 - tb)) << 1, first = w.first, index = w.index;
  for (int len = tb + 1; len <= 16; len++) {
    code |= (int)((bits >> (16 - len)) & 1);
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

// Code lengths lens[first..last) delta-coded against their previous values
// through a fresh pretree (lzxd.c:138-183, codecs/lzx.py:162-198). A run
// may overshoot last by up to 51 entries, into the next range or the
// SAFETY tail, as the reference's does.
LZ_FN int read_lens(Bits& b, Tables& T, uint8_t* lens, int first,
                    int last) {
  for (int i = 0; i < NPRE; i++) {
    uint32_t v = b.take(4);
    if (warp::leader()) T.plens[i] = (uint8_t)v;
  }
  if (build(T.pcount, T.psym, T.plens, NPRE, T.offs) != 0) return ERR_DATA;
  fill_table(T.pre, PRE_TB, T.pre_walk, T.pcount, T.psym);
  int pos = first;
  while (pos < last) {
    int sym = decode(b, T.pre, PRE_TB, T.pre_walk, T.pcount, T.psym);
    if (sym < 0) return ERR_DATA;
    int run = 1, value = 0;
    if (sym == 17) {
      run = (int)b.take(4) + 4;
    } else if (sym == 18) {
      run = (int)b.take(5) + 20;
    } else {
      if (sym == 19) {
        run = (int)b.take(1) + 4;
        sym = decode(b, T.pre, PRE_TB, T.pre_walk, T.pcount, T.psym);
        if (sym < 0) return ERR_DATA;
      }
      value = lens[pos] - sym;
      if (value < 0) value += 17;
      value &= 0xFF;
    }
    warp::sync();
    warp::each([&](int lane) {
      for (int k = lane; k < run; k += 32) lens[pos + k] = (uint8_t)value;
    });
    warp::sync();
    pos += run;
  }
  return ERR_OK;
}

LZ_FN uint32_t le32_at(const Bits& b, int64_t q) {
  return b.byte_at(q) | (b.byte_at(q + 1) << 8) | (b.byte_at(q + 2) << 16) |
         (b.byte_at(q + 3) << 24);
}

LZ_FN int begin_block(Bits& b, State& s, Regs& r, Tables& T,
                      int num_offsets) {
  if (r.block_type == 3 && (r.block_length & 1)) {
    b.seek(b.tell() + 8);  // the pad byte after an odd uncompressed block
  }
  r.block_type = (int32_t)b.take(3);
  uint32_t hi = b.take(16);
  uint32_t lo = b.take(8);
  r.block_remaining = r.block_length = (int32_t)((hi << 8) | lo);
  if (r.block_type == 3) {
    r.intel_started = 1;
    // drop the reference's buffered bits: 1-16, to the next 16-bit unit
    int64_t q = (((b.tell() >> 4) + 1) << 4) >> 3;
    r.r0 = le32_at(b, q);
    r.r1 = le32_at(b, q + 4);
    r.r2 = le32_at(b, q + 8);
    b.seek((q + 12) * 8);
    return ERR_OK;
  }
  if (r.block_type != 1 && r.block_type != 2) return ERR_DATA;
  if (r.block_type == 2) {
    for (int i = 0; i < NALN; i++) {
      uint32_t v = b.take(3);
      if (warp::leader()) s.aln_lens[i] = (uint8_t)v;
    }
    if (build(s.aln_count, s.aln_sym, s.aln_lens, NALN, T.offs) != 0) {
      return ERR_DATA;
    }
    fill_table(T.aln, ALN_TB, T.aln_walk, s.aln_count, s.aln_sym);
  }
  int err = read_lens(b, T, s.main_lens, 0, 256);
  if (err == ERR_OK) err = read_lens(b, T, s.main_lens, 256, 256 + num_offsets);
  if (err != ERR_OK) return err;
  if (build(s.main_count, s.main_sym, s.main_lens, MAIN_MAX, T.offs) != 0) {
    return ERR_DATA;
  }
  fill_table(T.main, MAIN_TB, T.main_walk, s.main_count, s.main_sym);
  if (s.main_lens[0xE8]) r.intel_started = 1;
  err = read_lens(b, T, s.len_lens, 0, NLEN - 1);
  if (err != ERR_OK) return err;
  // an all-zero length tree is allowed until a LENGTH symbol needs it
  r.length_empty = warp::ballot([&](int lane) {
    bool any = false;
    for (int i = lane; i < NLEN; i += 32) any = any || s.len_lens[i];
    return any;
  }) == 0;
  int left = build(s.len_count, s.len_sym, s.len_lens, NLEN, T.offs);
  if (left >= 0) fill_table(T.len, LEN_TB, T.len_walk, s.len_count, s.len_sym);
  return left == 0 || r.length_empty ? ERR_OK : ERR_DATA;
}

LZ_FN int64_t position_base(int slot) {
  if (slot < 4) return slot;
  if (slot < 38) return (int64_t)(2 + (slot & 1)) << ((slot >> 1) - 1);
  return 524288 + (int64_t)(slot - 38) * 131072;
}

// Position slots at window 2^wbits (lzxd.c:position_slots): 30, 32, 34,
// 36, 38, 42, 50, 66, 98, 162, 290 for wbits 15..25.
LZ_FN int position_slots(int wbits) {
  return wbits < 19 ? 30 + 2 * (wbits - 15) : 34 + (1 << (wbits - 17));
}

// A match: main element sym >= 256 decoded at r.outpos in the frame that
// starts at fbase and ends at fend.
LZ_FN int match(Bits& b, State& s, Regs& r, Tables& T, Trace& t, int sym,
                int64_t fbase, int64_t fend, int wbits, int delta,
                int32_t hist) {
  int elem = sym - 256;
  int64_t len = elem & 7;
  if (len == 7) {
    if (r.length_empty) return ERR_DATA;
    int ls = decode(b, T.len, LEN_TB, T.len_walk, s.len_count, s.len_sym);
    if (ls < 0) return ERR_DATA;
    len += ls;
  }
  len += 2;
  int slot = elem >> 3;
  uint32_t off;
  if (slot == 0) {
    off = r.r0;
  } else if (slot == 1) {
    off = r.r1;
    r.r1 = r.r0;
    r.r0 = off;
  } else if (slot == 2) {
    off = r.r2;
    r.r2 = r.r0;
    r.r0 = off;
  } else {
    int extra = slot >= 36 ? 17 : (slot >> 1) - 1;
    off = (uint32_t)(position_base(slot) - 2);
    if (extra >= 3 && r.block_type == 2) {
      if (extra > 3) off += b.take(extra - 3) << 3;
      int a = decode(b, T.aln, ALN_TB, T.aln_walk, s.aln_count, s.aln_sym);
      if (a < 0) return ERR_DATA;
      off += (uint32_t)a;
    } else if (extra) {
      off += b.take(extra);
    }
    r.r2 = r.r1;
    r.r1 = r.r0;
    r.r0 = off;
  }
  if (delta && len == 257) {  // long-match escape (lzxd.c:588-611)
    uint32_t e = b.peek(3);
    if ((e >> 2) == 0) {
      b.drop(1);
      len += b.take(8);
    } else if ((e >> 1) == 2) {
      b.drop(2);
      len += b.take(10) + 0x100;
    } else if (e == 6) {
      b.drop(3);
      len += b.take(12) + 0x500;
    } else {
      b.drop(3);
      len += b.take(15);
    }
  }
  int64_t wsize = (int64_t)1 << wbits;
  int64_t lap = r.outpos & (wsize - 1);
  int64_t o = off;
  if (lap + len > wsize) return ERR_DATA;           // over the window wrap
  if (len > r.block_remaining || r.outpos + len > fend) return ERR_DATA;
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
  r.outpos += len;
  r.block_remaining -= (int32_t)len;
  return ERR_OK;
}

// Decode frames until r.outpos reaches target (or an error).
LZ_FN int run(Bits& b, State& s, Regs& r, Tables& T, Trace& t,
              int64_t target, int32_t hist, int wbits, int delta) {
  int num_offsets = position_slots(wbits) << 3;
  const warp::SharedTable main_tab(T.main);
  while (r.outpos < target) {
    int64_t fbase = r.outpos;
    int64_t fend = fbase + FRAME < target ? fbase + FRAME : target;
    if (delta) b.take(16);  // the chunk size field before each frame
    if (!r.header_read) {
      int32_t v = 0;
      if (b.take(1)) {
        uint32_t hi = b.take(16);
        v = (int32_t)((hi << 16) | b.take(16));
      }
      r.intel_filesize = v;
      r.header_read = 1;
    }
    while (r.outpos < fend) {
      if (r.block_remaining == 0) {
        int err = begin_block(b, s, r, T, num_offsets);
        if (err != ERR_OK) return err;
        continue;
      }
      if (r.block_type == 3) {  // raw bytes, from the byte cursor
        int64_t k = fend - r.outpos;
        if (r.block_remaining < k) k = r.block_remaining;
        int64_t q = b.tell() >> 3;
        for (int64_t j = 0; j < k; j++) {
          if (!literal(t, b.byte_at(q + j))) return ERR_TCAP;
        }
        b.seek((q + k) * 8);
        r.outpos += k;
        r.block_remaining -= (int32_t)k;
        continue;
      }
      // a run of literals straight from the main table, up to the first
      // other entry or the block's or the frame's end
      int32_t room = fend - r.outpos < r.block_remaining
                         ? (int32_t)(fend - r.outpos) : r.block_remaining;
      int32_t k = 0;
      bool full = false;
      for (; k < room; k++) {
        uint32_t e = main_tab[b.peek(16) >> (16 - MAIN_TB)];
        if (e & 0xF00) break;
        b.drop((int)(e >> 12) + 1);
        if (!literal(t, e & 0xFF)) {
          full = true;
          break;
        }
      }
      r.outpos += k;
      r.block_remaining -= k;
      if (full) return ERR_TCAP;
      if (k == room) continue;
      int sym = decode(b, T.main, MAIN_TB, T.main_walk, s.main_count,
                       s.main_sym);
      if (sym < 0) return ERR_DATA;
      if (sym < 256) {
        if (!literal(t, (uint32_t)sym)) return ERR_TCAP;
        r.outpos++;
        r.block_remaining--;
        continue;
      }
      int err = match(b, s, r, T, t, sym, fbase, fend, wbits, delta, hist);
      if (err != ERR_OK) return err;
    }
    // realign to 16 bits; in an uncompressed block the reference holds no
    // buffered bits and reads on from its byte cursor
    if (r.block_type != 3) b.seek((b.tell() + 15) & ~(int64_t)15);
  }
  return flush(t) ? ERR_OK : ERR_TCAP;
}

// A fresh record: zeros (lane by lane), then R0-R2 = 1 (lane 0).
LZ_FN void init(State& s) {
  uint32_t* p = reinterpret_cast<uint32_t*>(&s);
  warp::each([&](int l) {
    for (unsigned k = l; k < sizeof(State) / 4; k += 32) p[k] = 0;
  });
  warp::sync();
  if (warp::leader()) s.r0 = s.r1 = s.r2 = 1;
  warp::sync();
}

// Decode one stream of n bytes up to output position target, resuming
// from s; hist is the history budget before the stream's start (DELTA
// reference data). Writes at most cap tokens.
LZ_FN Result decode_stream(const uint8_t* src, int64_t n, int64_t target,
                           int32_t hist, int wbits, int delta, State& s,
                           Tables& T, int32_t* tok, int32_t* litw,
                           int32_t cap) {
  Trace t = {tok, litw, cap, 0, 0, 0};
  Regs r = {s.outpos,        s.r0,           s.r1,
            s.r2,            s.block_type,   s.block_remaining,
            s.block_length,  s.header_read,  s.intel_started,
            s.intel_filesize, s.length_empty};
  int32_t err = s.err;
  int64_t bitpos = s.bitpos;
  if (err == ERR_OK && r.outpos < target) {
    // resuming inside a coded block: its tables from the trees it built
    if (r.block_remaining > 0 && (r.block_type == 1 || r.block_type == 2)) {
      fill_table(T.main, MAIN_TB, T.main_walk, s.main_count, s.main_sym);
      fill_table(T.len, LEN_TB, T.len_walk, s.len_count, s.len_sym);
      if (r.block_type == 2) {
        fill_table(T.aln, ALN_TB, T.aln_walk, s.aln_count, s.aln_sym);
      }
    }
    Bits b = {src, n, 0, 0, 0};
    b.seek(bitpos);
    err = run(b, s, r, T, t, target, hist, wbits, delta);
    bitpos = b.tell();
  }
  warp::sync();
  if (warp::leader()) {
    s.bitpos = bitpos;
    s.outpos = r.outpos;
    s.r0 = r.r0;
    s.r1 = r.r1;
    s.r2 = r.r2;
    s.block_type = r.block_type;
    s.block_remaining = r.block_remaining;
    s.block_length = r.block_length;
    s.header_read = r.header_read;
    s.intel_started = r.intel_started;
    s.intel_filesize = r.intel_filesize;
    s.length_empty = r.length_empty;
    s.err = err;
  }
  warp::sync();
  Result res = {err, (int32_t)r.outpos, t.n, (int32_t)((bitpos + 7) >> 3),
                r.intel_started, r.intel_filesize};
  return res;
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
// Host twin of the kernel's launch: the same per-stream call, one stream
// after another, with the warp's lanes evaluated in turn. Built only by
// the tests.
extern "C" int64_t lz_state_bytes() { return sizeof(lz::State); }

extern "C" int lz_decode_host(const uint8_t* streams, int64_t stride,
                              const int32_t* lens, const int32_t* targets,
                              const int32_t* hists, int L, int wbits,
                              int delta, int fresh, uint8_t* states,
                              int32_t* tok, int32_t* litw, int32_t cap,
                              int32_t* cnt) {
  lz::Tables T;
  for (int i = 0; i < L; i++) {
    lz::State& s = reinterpret_cast<lz::State*>(states)[i];
    if (fresh) lz::init(s);
    lz::Result r = lz::decode_stream(
        streams + (int64_t)i * stride, lens[i], targets[i], hists[i], wbits,
        delta, s, T, tok + (int64_t)i * cap, litw + (int64_t)i * cap, cap);
    lz::write_counts(cnt, L, i, r);
  }
  return 0;
}

// The table decode alone, for the tests. lz_first_bits(tree): the table
// bits of the main (0), length (1), aligned (2) and pretree (3) tables.
// lz_table_decode: build the code of lens[0..n) and its table of tb bits,
// then decode nsym symbols from src (n bytes) into out_sym, each with the
// bit position after it in out_pos, stopping at a -1. Returns build's
// unused code space (no decode when it is -1).
extern "C" int lz_first_bits(int tree) {
  const int tb[4] = {lz::MAIN_TB, lz::LEN_TB, lz::ALN_TB, lz::PRE_TB};
  return tb[tree];
}

extern "C" int lz_table_decode(const uint8_t* lens, int n, int tb,
                               const uint8_t* src, int64_t nbytes, int nsym,
                               int32_t* out_sym, int64_t* out_pos) {
  uint16_t count[17], sym[lz::MAIN_MAX], offs[17], tab[1 << lz::MAIN_TB];
  lz::Walk w;
  int left = lz::build(count, sym, lens, n, offs);
  if (left < 0) return left;
  lz::fill_table(tab, tb, w, count, sym);
  lz::Bits b = {src, nbytes, 0, 0, 0};
  for (int k = 0; k < nsym; k++) {
    out_sym[k] = lz::decode(b, tab, tb, w, count, sym);
    out_pos[k] = b.tell();
    if (out_sym[k] < 0) break;
  }
  return left;
}
#endif
