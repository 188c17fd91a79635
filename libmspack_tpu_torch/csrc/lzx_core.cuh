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
//
// A CAB folder can also decode frame-parallel (split_seed, the frame
// pass, split_join below): a header walk at the CFDATA boundaries gives each
// 32 KiB frame a seed record, each frame decodes from its seed with R0-R2
// carried as symbols, and a join checks every seam, resolves the symbols
// and compacts the frames' tokens into the serial decode's trace row.
#pragma once

#include "stream_core.cuh"

#define LZ_FN SC_FN

namespace lz {

constexpr int32_t TOK_LIT = 0x20000000;
constexpr int32_t TOK_MATCH = 0x40000000;
// A frame lane's repeated-offset match whose offset is still an input
// symbol (R0-R2 at the frame's start): TOK_REP | len, litw = the symbol's
// index << 16 | the match's output position in its frame. Only the split
// join reads it; it never reaches a trace.
constexpr int32_t TOK_REP = 0x10000000;
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
  int32_t rtag;             // bit i: R_i is input symbol r_i (0..2)
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
  uint32_t r0, r1, r2, rtag;
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

// A Trace with tok null counts its tokens and stores none (the seed walk's).
LZ_FN bool emit(Trace& t, int32_t tok, uint32_t litw) {
  if (t.n >= t.cap) return false;
  if (t.tok && warp::leader()) {
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
    r.rtag = 0;
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
  bool symbol = false;  // off is the index of an input symbol
  if (slot == 0) {
    off = r.r0;
    symbol = r.rtag & 1;
  } else if (slot == 1) {
    off = r.r1;
    symbol = r.rtag & 2;
    r.r1 = r.r0;
    r.r0 = off;
    r.rtag = (r.rtag & 4) | ((r.rtag & 1) << 1) | ((r.rtag >> 1) & 1);
  } else if (slot == 2) {
    off = r.r2;
    symbol = r.rtag & 4;
    r.r2 = r.r0;
    r.r0 = off;
    r.rtag = (r.rtag & 2) | ((r.rtag & 1) << 2) | ((r.rtag >> 2) & 1);
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
    r.rtag = (r.rtag << 1) & 6;
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
  if (symbol) {  // the offset's checks wait for the join (split_join)
    uint32_t at = off << 16 | (uint32_t)(r.outpos - fbase);
    if (!flush(t) || !emit(t, TOK_REP | (int32_t)len, at)) return ERR_TCAP;
    r.outpos += len;
    r.block_remaining -= (int32_t)len;
    return ERR_OK;
  }
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

// Decode from r.outpos up to stop, inside the frame [fbase, fend): blocks
// begin as their headers come, up to but not past stop; with one_header,
// return after the first block begins. Tokens are left pending (flush).
LZ_FN int run_to(Bits& b, State& s, Regs& r, Tables& T, Trace& t,
                 int64_t fbase, int64_t fend, int64_t stop, int32_t hist,
                 int wbits, int delta, int num_offsets, int one_header) {
  const warp::SharedTable main_tab(T.main);
  while (r.outpos < stop) {
    if (r.block_remaining == 0) {
      int err = begin_block(b, s, r, T, num_offsets);
      if (err != ERR_OK || one_header) return err;
      continue;
    }
    if (r.block_type == 3) {  // raw bytes, from the byte cursor
      int64_t k = stop - r.outpos;
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
    // other entry or the block's end or stop
    int32_t room = stop - r.outpos < r.block_remaining
                       ? (int32_t)(stop - r.outpos) : r.block_remaining;
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
  return ERR_OK;
}

// The E8 header at the stream's start: a flag bit, then the file size.
LZ_FN void read_intel_header(Bits& b, Regs& r) {
  int32_t v = 0;
  if (b.take(1)) {
    uint32_t hi = b.take(16);
    v = (int32_t)((hi << 16) | b.take(16));
  }
  r.intel_filesize = v;
  r.header_read = 1;
}

// Decode frames until r.outpos reaches stop (or an error); frames end
// every FRAME bytes and at target. A decode starts at a frame's start but
// for the seed walk's (split_seed), which may start and stop inside a
// frame, or read one block header alone (one_header).
LZ_FN int run(Bits& b, State& s, Regs& r, Tables& T, Trace& t,
              int64_t target, int64_t stop, int one_header, int32_t hist,
              int wbits, int delta) {
  int num_offsets = position_slots(wbits) << 3;
  while (r.outpos < stop) {
    int64_t fbase = r.outpos & ~(int64_t)(FRAME - 1);
    int64_t fend = fbase + FRAME < target ? fbase + FRAME : target;
    // the chunk size field before each frame
    if (delta && r.outpos == fbase) b.take(16);
    if (!r.header_read) read_intel_header(b, r);
    int err = run_to(b, s, r, T, t, fbase, fend, fend < stop ? fend : stop,
                     hist, wbits, delta, num_offsets, one_header);
    if (err != ERR_OK) return err;
    if (one_header) break;
    // realign to 16 bits at the frame's end; in an uncompressed block the
    // reference holds no buffered bits and reads on from its byte cursor
    if (r.outpos == fend && r.block_type != 3) {
      b.seek((b.tell() + 15) & ~(int64_t)15);
    }
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

// Decode one stream of n bytes up to output position stop (frames end at
// target, stop <= target; run), resuming from s; hist is the history
// budget before the stream's start (DELTA reference data). Writes at most
// cap tokens, none where tok is null. Every decode of a K3 launch goes
// through its one call of this (k3_lzx_kernel), so that the decoder is
// inlined once.
LZ_FN Result decode_stream(const uint8_t* src, int64_t n, int64_t target,
                           int64_t stop, int one_header, int32_t hist,
                           int wbits, int delta, State& s, Tables& T,
                           int32_t* tok, int32_t* litw, int32_t cap) {
  Trace t = {tok, litw, cap, 0, 0, 0};
  Regs r = {s.outpos,        s.r0,           s.r1,
            s.r2,            (uint32_t)s.rtag, s.block_type,
            s.block_remaining, s.block_length, s.header_read,
            s.intel_started, s.intel_filesize, s.length_empty};
  int32_t err = s.err;
  int64_t bitpos = s.bitpos;
  if (err == ERR_OK && r.outpos < stop) {
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
    err = run(b, s, r, T, t, target, stop, one_header, hist, wbits, delta);
    bitpos = b.tell();
  }
  warp::sync();
  if (warp::leader()) {
    s.bitpos = bitpos;
    s.outpos = r.outpos;
    s.r0 = r.r0;
    s.r1 = r.r1;
    s.r2 = r.r2;
    s.rtag = (int32_t)r.rtag;
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


// ------------------------------------------------------------- the split --
//
// A CAB folder whose CFDATA blocks each hold one 32 KiB frame decodes on a
// warp per frame. The decoder realigns to 16 bits at every frame end, so a
// frame's first bit is its CFDATA block's first byte; what a frame lane
// cannot know is the state there: the block it is in (type, trees, bytes
// left), the E8 fields and R0-R2.
//
// split_seed (a warp per stream) walks the block headers. A block's frames
// after its header get seeds at their CFDATA starts with its trees and the
// bytes left; a block that ends on a frame edge puts the next header at
// that frame's first bit, an uncompressed block's end follows from its
// length, and only a block that ends inside frame j decodes: frame j's
// prefix from its CFDATA start to the block's end, storing no tokens, to
// reach the next header. Seeds carry R0-R2 as the input symbols 0, 1, 2.
// The walk reads each header and each prefix through decode_stream
// (seed_step between two decodes), so that a kernel that runs it holds one
// copy of the decoder.
//
// The frame pass (a warp per frame: decode_stream from the frame's seed to
// its end, into a scratch row, then put_frame_end) runs the serial
// decoder; a repeated-offset match whose offset is still a symbol
// writes TOK_REP and leaves its offset checks to the join. The frame's end
// scalars and token count go into a FrameEnd.
//
// split_join (a warp per frame) checks its frame (no error, at its end)
// and its seam (the frame before ends where this frame's seed starts, in
// the same block state), composes the R transfers of the frames before it
// into its input R0-R2, resolves and checks its TOK_REP tokens, and copies
// its tokens to their place in the stream's trace row; the last frame's
// warp writes the stream's counts as the serial decode would (row 2 may
// count one more literal token a frame edge: a run of literals splits
// there). Any failure sets the stream's flags, and K3's serial pass then
// decodes that stream alone, as if it had never split.

enum {
  SPLIT_DONE = 1,   // counts row 6 of a stream the frame lanes decoded
  SPLIT_SEED = 2,   // the header walk failed
  SPLIT_FRAME = 4,  // a frame lane flagged or stopped short
  SPLIT_SEAM = 8,   // a frame ended elsewhere than the next frame's seed
  SPLIT_CHECK = 16, // a symbolic offset failed its checks or needs a split
  SPLIT_CAP = 32    // the compacted trace exceeds the token cap
};

// A frame lane's end: its record's scalars and its token count.
struct FrameEnd {
  int64_t bitpos, outpos;
  uint32_t r0, r1, r2, rtag;
  int32_t block_type, block_remaining, block_length, header_read;
  int32_t intel_started, intel_filesize, length_empty, err;
  int32_t ntok, pad;
};

// The split streams of a launch. meta holds, as int32: lane[S] (each
// stream's row), first[S + 1] (its first frame; first[S] = F),
// fstream[F] (each frame's stream), fstart[F] (each frame's CFDATA start,
// in bytes from its stream's start) and split_of[L] (each row's stream,
// -1 for a row that decodes serially).
struct Split {
  int32_t S, F;
  const int32_t* lane;
  const int32_t* first;
  const int32_t* fstream;
  const int32_t* fstart;
  const int32_t* split_of;  // null: nothing splits
  State* seeds;             // [F]
  FrameEnd* ends;           // [F]
  int32_t* ftok;            // [F, FRAME] scratch rows of the frame lanes
  int32_t* flitw;
  int32_t* flags;           // [S] SPLIT_* bits, 0 while all is well
};

LZ_FN Split make_split(const int32_t* meta, int S, int F, void* seeds,
                       void* ends, void* ftok, void* flitw, void* flags) {
  Split sp;
  sp.S = S;
  sp.F = F;
  sp.lane = meta;
  sp.first = meta + S;
  sp.fstream = meta + 2 * S + 1;
  sp.fstart = meta + 2 * S + 1 + F;
  sp.split_of = meta + 2 * S + 1 + 2 * F;
  sp.seeds = (State*)seeds;
  sp.ends = (FrameEnd*)ends;
  sp.ftok = (int32_t*)ftok;
  sp.flitw = (int32_t*)flitw;
  sp.flags = (int32_t*)flags;
  return sp;
}

// A whole record, shared <-> global, the lanes splitting its 16-byte words.
LZ_FN void copy_record(State* dst, const State* src) {
  warp::sync();
#ifdef __CUDA_ARCH__
  const uint4* a = reinterpret_cast<const uint4*>(src);
  uint4* d = reinterpret_cast<uint4*>(dst);
  for (int k = threadIdx.x & 31; k < (int)(sizeof(State) / 16); k += 32) {
    d[k] = a[k];
  }
#else
  memcpy(dst, src, sizeof(State));
#endif
  warp::sync();
}

// The seed of a frame: s's trees, block and E8 state, the given cursor,
// position and bytes left in the block, R0-R2 as symbols. s's scalars are
// the seed's afterwards.
LZ_FN void put_seed(State& s, State* dst, int64_t bitpos, int64_t outpos,
                    int64_t remaining) {
  warp::sync();
  if (warp::leader()) {
    s.bitpos = bitpos;
    s.outpos = outpos;
    s.r0 = 0;
    s.r1 = 1;
    s.r2 = 2;
    s.rtag = 7;
    s.block_remaining = (int32_t)remaining;
    s.err = ERR_OK;
  }
  copy_record(dst, &s);
}

// Where the seed walk's next decode starts: s's cursor, position and bytes
// left in the block; R0-R2 symbols (a dry prefix needs no offset values).
LZ_FN void set_cursor(State& s, int64_t bitpos, int64_t outpos,
                      int64_t remaining) {
  warp::sync();
  if (warp::leader()) {
    s.bitpos = bitpos;
    s.outpos = outpos;
    s.block_remaining = (int32_t)remaining;
    s.rtag = 7;
    s.err = ERR_OK;
  }
  warp::sync();
}

LZ_FN int64_t frames_of(int64_t total) { return (total + FRAME - 1) / FRAME; }

// The header walk of one stream of total output bytes and nf frames whose
// CFDATA blocks start at fstart[0..nf), as steps between decodes of s
// (seed_step, then decode_stream to stop, reading one header alone where
// one_header is set, storing no tokens; until seed_step returns false).
// It writes seeds[0..nf); flags ends 0, or SPLIT_SEED where a header does
// not read or the frames do not match.
struct SeedWalk {
  int64_t total;
  const int32_t* fstart;
  State* seeds;
  int nf;
  int phase;    // WALK_*: what the last decode did
  int next;     // the first frame without a seed
  int64_t o, e; // the block's first and end output positions
  int flags;
};

enum { WALK_START = 0, WALK_HEADER = 1, WALK_PREFIX = 2, WALK_DONE = 3 };

LZ_FN SeedWalk seed_walk(int64_t total, const int32_t* fstart, int nf,
                         State* seeds) {
  SeedWalk w = {total, fstart, seeds, nf, WALK_START, 1, 0, 0, 0};
  if (nf < 1 || nf != frames_of(total) || fstart[0] != 0) {
    w.phase = WALK_DONE;
    w.flags = SPLIT_SEED;
  }
  return w;
}

// The next header at bit, output position w.e: the seed of the frame that
// opens there, then a decode that reads the header.
LZ_FN bool walk_on(SeedWalk& w, State& s, int64_t bit, int64_t& stop,
                   int& one_header) {
  int64_t e = w.e;
  if (e % FRAME == 0 && w.next == (int)(e / FRAME)) {
    put_seed(s, w.seeds + w.next, bit, e, 0);
    w.next++;
  }
  w.o = e;
  set_cursor(s, bit, e, 0);
  w.phase = WALK_HEADER;
  stop = w.total;
  one_header = 1;
  return true;
}

// One step of the walk (see "the split" above) after a decode whose error
// was err (none before the first): true with the next decode's stop and
// one_header set, false when the walk is done.
LZ_FN bool seed_step(SeedWalk& w, State& s, int err, int64_t& stop,
                     int& one_header) {
  if (w.phase == WALK_DONE) return false;
  if (w.phase == WALK_START) {  // s is fresh: frame 0's seed as it is
    copy_record(w.seeds, &s);
    w.phase = WALK_HEADER;
    stop = w.total;
    one_header = 1;
    return true;
  }
  if (err != ERR_OK || (w.phase == WALK_PREFIX && s.outpos != w.e)) {
    w.phase = WALK_DONE;
    w.flags = SPLIT_SEED;
    return false;
  }
  if (w.phase == WALK_PREFIX) return walk_on(w, s, s.bitpos, stop, one_header);
  // a block has begun at w.o; the cursor is past its header
  int64_t o = w.o, e = o + s.block_length, total = w.total;
  if (e == o) {  // the next header follows at once
    stop = total;
    one_header = 1;
    return true;
  }
  int hf = (int)(o / FRAME);     // the frame that read this header
  int64_t after = s.bitpos;      // an uncompressed block's first byte * 8
  int type = s.block_type;
  for (; (int64_t)w.next * FRAME < (e < total ? e : total); w.next++) {
    int64_t at = (int64_t)w.next * FRAME;
    put_seed(s, w.seeds + w.next, (int64_t)w.fstart[w.next] * 8, at, e - at);
  }
  if (e >= total) {
    w.phase = WALK_DONE;
    w.flags = w.next == w.nf ? 0 : SPLIT_SEED;
    return false;
  }
  w.e = e;
  int j = (int)(e / FRAME);  // e's frame (on an edge: the one it opens)
  if (type == 3) {
    int g = (int)((e - 1) / FRAME);  // the frame of its last byte
    int64_t at = (int64_t)g * FRAME;
    return walk_on(w, s, g <= hf ? after + 8 * (e - o)
                                 : 8 * (w.fstart[g] + (e - at)),
                   stop, one_header);
  }
  if (e % FRAME == 0) {
    return walk_on(w, s, (int64_t)w.fstart[j] * 8, stop, one_header);
  }
  int64_t fbase = (int64_t)j * FRAME;
  if (j != hf) {
    set_cursor(s, (int64_t)w.fstart[j] * 8, fbase, e - fbase);
  } else {
    set_cursor(s, after, o, e - o);
  }
  w.phase = WALK_PREFIX;
  stop = e;
  one_header = 0;
  return true;
}

// The whole walk, for the host twin; the kernel runs the same steps around
// its one decode_stream call.
LZ_FN int split_seed(const uint8_t* src, int64_t n, int64_t total,
                     int32_t hist, int wbits, const int32_t* fstart, int nf,
                     State& s, Tables& T, State* seeds) {
  SeedWalk w = seed_walk(total, fstart, nf, seeds);
  init(s);
  int err = ERR_OK, one_header = 0;
  int64_t stop = 0;
  while (seed_step(w, s, err, stop, one_header)) {
    err = decode_stream(src, n, total, stop, one_header, hist, wbits, 0, s,
                        T, nullptr, nullptr, 0x7FFFFFFF).err;
  }
  return w.flags;
}

// Frame k's output end in a stream of total bytes: a frame lane's target.
LZ_FN int64_t frame_target(int k, int64_t total) {
  int64_t end = (int64_t)(k + 1) * FRAME;
  return end < total ? end : total;
}

// A frame lane's end, after decode_stream from its seed: s's scalars and
// the lane's token count.
LZ_FN void put_frame_end(const State& s, int32_t ntok, FrameEnd* end) {
  warp::sync();
  if (warp::leader()) {
    FrameEnd e = {s.bitpos,        s.outpos,        s.r0,
                  s.r1,            s.r2,            (uint32_t)s.rtag,
                  s.block_type,    s.block_remaining, s.block_length,
                  s.header_read,   s.intel_started, s.intel_filesize,
                  s.length_empty,  s.err,           ntok,
                  0};
    *end = e;
  }
  warp::sync();
}

// R0-R2 as a transfer: each is a value or (its rtag bit set) the input
// symbol the value names.
struct Rx {
  uint32_t v[3];
  uint32_t tag;
};

// a, then b.
LZ_FN Rx rx_then(const Rx& a, const Rx& b) {
  Rx c = {{0, 0, 0}, 0};
  for (int i = 0; i < 3; i++) {
    if ((b.tag >> i) & 1) {
      uint32_t src = b.v[i];
      c.v[i] = a.v[src];
      c.tag |= ((a.tag >> src) & 1) << i;
    } else {
      c.v[i] = b.v[i];
    }
  }
  return c;
}

// Frame k (global index f) of a stream of nf frames and total bytes: the
// checks, then its tokens from the scratch row into the trace row (tok,
// litw, cap) at the tokens of the frames before it. Returns SPLIT_* bits
// of a failure, 0 when its part is in place.
LZ_FN int split_join(const Split& sp, int64_t f, int k, int nf,
                     int64_t total, int32_t hist, int wbits, int32_t* tok,
                     int32_t* litw, int32_t cap, int32_t* cnt, int64_t L,
                     int64_t i) {
  const FrameEnd* ends = sp.ends + (f - k);
  // the R transfer and the tokens of frames 0..k-1: a chunk a lane, then
  // the chunks in order
  int c = (k + 31) / 32;
  warp::Lanes<uint32_t> v0, v1, v2, tg;
  warp::Lanes<int64_t> nt;
  warp::each([&](int l) {
    Rx a = {{0, 1, 2}, 7};
    int64_t m = 0;
    int hi = (l + 1) * c < k ? (l + 1) * c : k;
    for (int g = l * c; g < hi; g++) {
      Rx x = {{ends[g].r0, ends[g].r1, ends[g].r2}, ends[g].rtag};
      a = rx_then(a, x);
      m += ends[g].ntok;
    }
    v0.at(l) = a.v[0];
    v1.at(l) = a.v[1];
    v2.at(l) = a.v[2];
    tg.at(l) = a.tag;
    nt.at(l) = m;
  });
  Rx rin = {{1, 1, 1}, 0};  // a fresh stream's R0-R2
  int64_t off = 0;
  for (int l = 0; l < 32; l++) {
    Rx x = {{warp::shfl(v0, l), warp::shfl(v1, l), warp::shfl(v2, l)},
            warp::shfl(tg, l)};
    rin = rx_then(rin, x);
    off += warp::shfl(nt, l);
  }
  const FrameEnd& E = ends[k];
  int64_t fbase = (int64_t)k * FRAME;
  int fail = 0;
  if (E.err != ERR_OK || E.outpos != frame_target(k, total)) {
    fail |= SPLIT_FRAME;
  }
  if (k > 0) {
    const FrameEnd& P = ends[k - 1];
    const State& S = sp.seeds[f];
    if (P.bitpos != S.bitpos || P.outpos != S.outpos ||
        P.block_type != S.block_type ||
        P.block_remaining != S.block_remaining ||
        P.block_length != S.block_length ||
        P.header_read != S.header_read ||
        P.intel_started != S.intel_started ||
        P.intel_filesize != S.intel_filesize ||
        P.length_empty != S.length_empty) {
      fail |= SPLIT_SEAM;
    }
  }
  if (off + E.ntok > cap) fail |= SPLIT_CAP;
  if (fail) return fail;
  // the frame's tokens, each TOK_REP resolved and checked as match() would
  const int32_t* st = sp.ftok + f * FRAME;
  const int32_t* sl = sp.flitw + f * FRAME;
  int64_t wsize = (int64_t)1 << wbits;
  int32_t n = E.ntok;
  warp::Lanes<int> bad = warp::map<int>([&](int l) {
    int b = 0;
    for (int32_t t = l; t < n; t += 32) {
      int32_t v = st[t], w = sl[t];
      if (v & TOK_REP) {
        int64_t len = v & 0xFFFFF;
        int64_t o = rin.v[(w >> 16) & 3];
        int64_t lap = (fbase + (w & 0xFFFF)) & (wsize - 1);
        if (o > lap && ((o > fbase && o - lap > hist) || o - lap > wsize ||
                        (o > wsize && len > o - lap))) {
          b = 1;  // the serial decode flags it, or splits its source
        }
        v = TOK_MATCH | (int32_t)len;
        w = (int32_t)(o > lap && o > wsize ? o - wsize : o);
      }
      tok[off + t] = v;
      litw[off + t] = w;
    }
    return b;
  });
  if (warp::ballot([&](int l) { return bad.at(l) != 0; })) return SPLIT_CHECK;
  if (k == nf - 1 && warp::leader()) {
    Result res = {ERR_OK, (int32_t)E.outpos, (int32_t)(off + n),
                  (int32_t)((E.bitpos + 7) >> 3), E.intel_started,
                  E.intel_filesize};
    write_counts(cnt, L, i, res);
    cnt[6 * L + i] = SPLIT_DONE;
  }
  warp::sync();
  return 0;
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
        streams + (int64_t)i * stride, lens[i], targets[i], targets[i], 0,
        hists[i], wbits, delta, s, T, tok + (int64_t)i * cap,
        litw + (int64_t)i * cap, cap);
    lz::write_counts(cnt, L, i, r);
  }
  return 0;
}

extern "C" int64_t lz_frame_end_bytes() { return sizeof(lz::FrameEnd); }

// Host twin of the split launch (lzx.cu:msp_k3_lzx_split): the seed, frame
// and join passes, each block after another, then the serial decode of
// every row that did not split or whose split failed.
extern "C" int lz_split_host(const uint8_t* streams, int64_t stride,
                             const int32_t* lens, const int32_t* targets,
                             const int32_t* hists, int L, int wbits,
                             uint8_t* states, int32_t* tok, int32_t* litw,
                             int32_t cap, int32_t* cnt, const int32_t* meta,
                             int S, int F, void* seeds, void* ends,
                             void* ftok, void* flitw, void* flags) {
  lz::State s;
  lz::Tables T;
  lz::Split sp = lz::make_split(meta, S, F, seeds, ends, ftok, flitw, flags);
  for (int j = 0; j < S; j++) {
    int i = sp.lane[j], f0 = sp.first[j];
    sp.flags[j] = lz::split_seed(streams + (int64_t)i * stride, lens[i],
                                 targets[i], hists[i], wbits,
                                 sp.fstart + f0, sp.first[j + 1] - f0, s, T,
                                 sp.seeds + f0);
  }
  for (int f = 0; f < F; f++) {
    int j = sp.fstream[f], i = sp.lane[j];
    if (sp.flags[j]) continue;
    lz::copy_record(&s, sp.seeds + f);
    int64_t end = lz::frame_target(f - sp.first[j], targets[i]);
    lz::Result r = lz::decode_stream(
        streams + (int64_t)i * stride, lens[i], end, end, 0, hists[i], wbits,
        0, s, T, sp.ftok + (int64_t)f * lz::FRAME,
        sp.flitw + (int64_t)f * lz::FRAME, lz::FRAME);
    lz::put_frame_end(s, r.ntok, sp.ends + f);
  }
  for (int f = 0; f < F; f++) {
    int j = sp.fstream[f], i = sp.lane[j];
    if (sp.flags[j] & lz::SPLIT_SEED) continue;
    int k = f - sp.first[j];
    sp.flags[j] |= lz::split_join(
        sp, f, k, sp.first[j + 1] - sp.first[j], targets[i], hists[i], wbits,
        tok + (int64_t)i * cap, litw + (int64_t)i * cap, cap, cnt, L, i);
  }
  for (int i = 0; i < L; i++) {
    int j = sp.split_of[i];
    if (j >= 0 && sp.flags[j] == 0) continue;
    lz::State& st = reinterpret_cast<lz::State*>(states)[i];
    lz::init(st);
    lz::Result r = lz::decode_stream(
        streams + (int64_t)i * stride, lens[i], targets[i], targets[i], 0,
        hists[i], wbits, 0, st, T, tok + (int64_t)i * cap,
        litw + (int64_t)i * cap, cap);
    lz::write_counts(cnt, L, i, r);
    if (j >= 0) cnt[6 * L + i] = sp.flags[j];
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
