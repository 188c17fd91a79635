// Quantum phase A for one stream: decode a CAB Quantum folder stream (the
// 0xFF trailer the CAB reader injects after every block included,
// cabd.c:1327-1332) into the token trace of libmspack_tpu/ops/pallas_qtm.py,
// which is pallas_lzx.py's format (:39-45):
//
//   -1                    NOP (never emitted here; padding)
//   0x20000000 | n        n in 1..4 literal bytes, LSB-first in litw
//   0x40000000 | len      a match of len bytes (3..259); litw = the linear
//                         distance back in the output
//
// The same functions run in the Hopper kernel (qtm.cu, one thread per
// stream) and in a host twin that g++ builds from this header alone (define
// QTM_CORE_HOST_TWIN), so the tests check the kernel's logic on a CPU.
//
// The decoder is the reference codec's sequential reader
// (libmspack_tpu/codecs/qtm.py, qtmd.c) step for step: an MSB-first bit
// reader over 16-bit big-endian units, reading zeros past the stream's end;
// the 16-bit H/L/C range coder with underflow renormalisation; nine
// adaptive models (selector, four literal models, the match-3, match-4 and
// variable-length position models, the length model), each symbol search
// followed by the +8 update, the halving rescale once the total passes 3800
// and, every fifth rescale, the reference's exchange sort run as it stands;
// selectors 0-6 with the position and length extra-bit tables; at each
// 32 KiB frame end a byte realign, a scan to the 0xFF trailer and a coder
// re-init. Literals flush at four, at a frame end and at the target, and
// before a match, as the TPU kernel flushes them, so the traces are equal.
//
// Its whole state lives in one State record per stream, which the caller
// allocates: the decoder works on it in place, so passing the record of a
// stopped decode back in resumes it. Decodes stop at a target output
// position, which is a multiple of 32 KiB except at the stream's end; the
// record is then at a frame start, where the coder re-inits (qtmd.c:
// 430-442), so only the models, the cursor and frame_todo carry.
//
// Errors (err = 1) are the reference's: a match that overshoots its frame
// ("overshot frame alignment", codecs/qtm.py:329-330), an offset beyond the
// window (:227-228; the slot tables bound offsets at the window size, so
// only a model corrupted in memory reaches it), a selector above 6 (:305,
// likewise unreachable from the selector model's alphabet), and input that
// runs out: a trailer scan past the stream's end, or a decode that needs
// more than the 16 zero bits the reference's soft end of input supplies
// (codecs/bitstream.py:44-55). err = 2 means the token cap was reached.
#pragma once

#include <stdint.h>

#ifndef __CUDACC__
#define __host__
#define __device__
#endif

#define QT_FN static __host__ __device__ inline

namespace qt {

constexpr int32_t TOK_LIT = 0x20000000;
constexpr int32_t TOK_MATCH = 0x40000000;
constexpr int FRAME = 32768;
constexpr int NT = 9;      // models: selector, literal 0-3, match3, match4,
                           // variable-length position, length
constexpr int TROWS = 65;  // the widest model (64 entries) plus its sentinel

enum { ERR_OK = 0, ERR_DATA = 1, ERR_TCAP = 2 };

// One adaptive model: sym/cum rows 0..entries, cum[entries] = 0 the
// sentinel, rows past it zero (codecs/qtm.py:102-155).
struct Model {
  int32_t entries;
  int32_t rescales_left;
  uint16_t sym[TROWS];
  uint16_t cum[TROWS];
};

// One stream's whole decoder state (2448 bytes). The layout is mirrored by
// STATE_DTYPE in libmspack_tpu_torch/ops/cuda_qtm.py; keep the two in step.
struct State {
  int64_t bitpos;      // input cursor, in bits from the stream's start
  int64_t outpos;      // output bytes decoded
  int32_t frame_todo;  // bytes left in this frame; FRAME at a frame start
  int32_t err;
  uint16_t H, L, C;    // range coder
  uint16_t pad;
  Model m[NT];
};

struct Bits {
  const uint8_t* src;
  int64_t n;
  int64_t upos;  // byte position of the next 16-bit unit to load
  uint64_t buf;  // the next bits, MSB first
  int nbits;
};

struct Trace {
  int32_t* tok;
  int32_t* litw;
  int32_t cap;
  int32_t n;
  uint32_t word;  // pending literals, LSB first
  int32_t cnt;
  int32_t wraps;  // matches of this call that crossed a window lap end
};

struct Result {
  int32_t err;
  int32_t outpos;
  int32_t ntok;
  int32_t cursor;  // input bytes consumed, rounded up
  int32_t wraps;
};

QT_FN uint32_t byte_at(const Bits& b, int64_t p) {
  return p < b.n ? b.src[p] : 0u;
}

QT_FN void fill(Bits& b) {
  while (b.nbits <= 48) {
    uint64_t u = (byte_at(b, b.upos) << 8) | byte_at(b, b.upos + 1);
    b.upos += 2;
    b.buf |= u << (48 - b.nbits);
    b.nbits += 16;
  }
}

QT_FN int64_t tell(const Bits& b) { return b.upos * 8 - b.nbits; }

QT_FN uint32_t take(Bits& b, int k) {
  if (k == 0) return 0;
  if (b.nbits < k) fill(b);
  uint32_t v = (uint32_t)(b.buf >> (64 - k));
  b.buf <<= k;
  b.nbits -= k;
  return v;
}

// Position the reader at bit p (units stay aligned to even bytes).
QT_FN void seek(Bits& b, int64_t p) {
  b.upos = (p >> 4) << 1;
  b.buf = 0;
  b.nbits = 0;
  if (p & 15) {
    fill(b);
    b.buf <<= (p & 15);
    b.nbits -= (int)(p & 15);
  }
}

QT_FN bool emit(Trace& t, int32_t tok, uint32_t litw) {
  if (t.n >= t.cap) return false;
  t.tok[t.n] = tok;
  t.litw[t.n] = (int32_t)litw;
  t.n++;
  return true;
}

QT_FN bool flush(Trace& t) {
  if (!t.cnt) return true;
  if (!emit(t, TOK_LIT | t.cnt, t.word)) return false;
  t.word = 0;
  t.cnt = 0;
  return true;
}

QT_FN void model_init(Model& m, int start, int len) {
  m.entries = len;
  m.rescales_left = 4;
  for (int i = 0; i <= len; i++) {
    m.sym[i] = (uint16_t)(start + i);
    m.cum[i] = (uint16_t)(len - i);
  }
}

// The rescale once the total passes 3800: halve, or every fifth time turn
// the cumulative frequencies into counts, halve them, exchange-sort the
// symbols by count (the reference's i < j loop, whose order of equal counts
// no key-based sort reproduces) and rebuild (codecs/qtm.py:133-155).
QT_FN void model_update(Model& m) {
  int n = m.entries;
  if (--m.rescales_left) {
    for (int i = n - 1; i >= 0; i--) {
      m.cum[i] >>= 1;
      if (m.cum[i] <= m.cum[i + 1]) m.cum[i] = (uint16_t)(m.cum[i + 1] + 1);
    }
    return;
  }
  m.rescales_left = 50;
  for (int i = 0; i < n; i++) {
    m.cum[i] = (uint16_t)(((m.cum[i] - m.cum[i + 1]) + 1) >> 1);
  }
  for (int i = 0; i < n - 1; i++) {
    for (int j = i + 1; j < n; j++) {
      if (m.cum[i] < m.cum[j]) {
        uint16_t c = m.cum[i];
        m.cum[i] = m.cum[j];
        m.cum[j] = c;
        uint16_t s = m.sym[i];
        m.sym[i] = m.sym[j];
        m.sym[j] = s;
      }
    }
  }
  for (int i = n - 1; i >= 0; i--) {
    m.cum[i] = (uint16_t)(m.cum[i] + m.cum[i + 1]);
  }
}

// One symbol of model m: search, narrow, update, renormalise
// (codecs/qtm.py:74-131, qtmd.c:92-123).
QT_FN int get_symbol(Bits& b, State& s, Model& m) {
  uint32_t span = (uint32_t)(uint16_t)(s.H - s.L) + 1;
  uint32_t total = m.cum[0];
  uint32_t symf =
      (((uint32_t)(uint16_t)(s.C - s.L) + 1) * total - 1) / span & 0xFFFF;
  int i = 1;
  while (i < m.entries && m.cum[i] > symf) i++;
  int sym = m.sym[i - 1];
  uint32_t lo = s.L, hi = s.H, code = s.C;
  hi = (lo + (m.cum[i - 1] * span) / total - 1) & 0xFFFF;
  lo = (lo + (m.cum[i] * span) / total) & 0xFFFF;
  for (int j = i - 1; j >= 0; j--) m.cum[j] = (uint16_t)(m.cum[j] + 8);
  if (m.cum[0] > 3800) model_update(m);
  for (;;) {
    if ((lo & 0x8000) != (hi & 0x8000)) {
      if ((lo & 0x4000) && !(hi & 0x4000)) {
        code ^= 0x4000;  // underflow: shift out the second-highest bit
        lo &= 0x3FFF;
        hi |= 0x4000;
      } else {
        break;
      }
    }
    lo = (lo << 1) & 0xFFFF;
    hi = ((hi << 1) | 1) & 0xFFFF;
    code = ((code << 1) | take(b, 1)) & 0xFFFF;
  }
  s.L = (uint16_t)lo;
  s.H = (uint16_t)hi;
  s.C = (uint16_t)code;
  return sym;
}

QT_FN uint32_t extra_bits(int slot) { return (slot < 2 ? 0 : slot - 2) >> 1; }

QT_FN uint32_t position_base(int slot) {
  // sum of 2^extra_bits over the slots below: 0,1,2,3 then pairs
  if (slot < 4) return (uint32_t)slot;
  uint32_t e = extra_bits(slot);
  return (2u << e) + ((uint32_t)(slot & 1) << e);
}

QT_FN uint32_t length_extra(int slot) {
  return slot >= 26 ? 0 : (uint32_t)((slot < 2 ? 0 : slot - 2) >> 2);
}

QT_FN uint32_t length_base(int slot) {
  if (slot >= 26) return 254;
  if (slot < 2) return (uint32_t)slot;
  uint32_t e = length_extra(slot);
  return 2u + (4u << e) - 4u + ((uint32_t)((slot - 2) & 3) << e);
}

// Decode until s.outpos reaches target (or an error).
QT_FN int run(Bits& b, State& s, Trace& t, int64_t target, int wbits) {
  int64_t wsize = (int64_t)1 << wbits;
  int64_t limit = b.n * 8 + 16;  // the reference's soft end of input
  while (s.outpos < target) {
    if (s.frame_todo == FRAME) {  // coder init from 16 raw bits
      s.H = 0xFFFF;
      s.L = 0;
      s.C = (uint16_t)take(b, 16);
    }
    int sel = get_symbol(b, s, s.m[0]);
    if (sel < 4) {
      uint32_t v = (uint32_t)get_symbol(b, s, s.m[1 + sel]);
      t.word |= v << (8 * t.cnt);
      t.cnt++;
      s.outpos++;
      s.frame_todo--;
      if ((t.cnt == 4 || s.frame_todo == 0 || s.outpos >= target) &&
          !flush(t)) {
        return ERR_TCAP;
      }
    } else {
      int64_t len;
      int slot;
      if (sel == 4) {
        slot = get_symbol(b, s, s.m[5]);
        len = 3;
      } else if (sel == 5) {
        slot = get_symbol(b, s, s.m[6]);
        len = 4;
      } else if (sel == 6) {
        int ls = get_symbol(b, s, s.m[8]);
        len = length_base(ls) + take(b, length_extra(ls)) + 5;
        slot = get_symbol(b, s, s.m[7]);
      } else {
        return ERR_DATA;
      }
      int64_t off = position_base(slot) + take(b, extra_bits(slot)) + 1;
      int64_t lap = s.outpos & (wsize - 1);
      if (off > lap && off - lap > wsize) return ERR_DATA;
      s.frame_todo -= (int32_t)len;
      if (s.frame_todo < 0) return ERR_DATA;  // overshot frame alignment
      if (!flush(t)) return ERR_TCAP;
      if (lap + len > wsize) t.wraps++;
      // a ring-window source this lap has overwritten: two linear tokens
      // (codecs/qtm.py:229-236)
      int64_t first = off > lap && off > wsize && len > off - lap
                          ? off - lap : len;
      if (off > lap && off > wsize) {
        if (!emit(t, TOK_MATCH | (int32_t)first, (uint32_t)(off - wsize))) {
          return ERR_TCAP;
        }
        if (first < len &&
            !emit(t, TOK_MATCH | (int32_t)(len - first), (uint32_t)off)) {
          return ERR_TCAP;
        }
      } else if (!emit(t, TOK_MATCH | (int32_t)len, (uint32_t)off)) {
        return ERR_TCAP;
      }
      s.outpos += len;
    }
    if (s.frame_todo == 0) {  // byte realign, then scan to the trailer
      take(b, b.nbits & 7);
      for (;;) {
        if (tell(b) >= b.n * 8) return ERR_DATA;
        if (take(b, 8) == 0xFF) break;
      }
      s.frame_todo = FRAME;
    }
    if (tell(b) > limit) return ERR_DATA;
  }
  return ERR_OK;
}

QT_FN void init(State& s, int wbits) {
  uint8_t* p = reinterpret_cast<uint8_t*>(&s);
  for (unsigned k = 0; k < sizeof(State); k++) p[k] = 0;
  s.frame_todo = FRAME;
  int span = wbits * 2;
  model_init(s.m[0], 0, 7);
  for (int k = 0; k < 4; k++) model_init(s.m[1 + k], 64 * k, 64);
  model_init(s.m[5], 0, span < 24 ? span : 24);
  model_init(s.m[6], 0, span < 36 ? span : 36);
  model_init(s.m[7], 0, span);
  model_init(s.m[8], 0, 27);
}

// Decode one stream of n bytes up to output position target, resuming
// from s. Writes at most cap tokens.
QT_FN Result decode_stream(const uint8_t* src, int64_t n, int64_t target,
                           int wbits, State& s, int32_t* tok, int32_t* litw,
                           int32_t cap) {
  Trace t = {tok, litw, cap, 0, 0, 0, 0};
  if (s.err == ERR_OK && s.outpos < target) {
    Bits b = {src, n, 0, 0, 0};
    seek(b, s.bitpos);
    s.err = run(b, s, t, target, wbits);
    s.bitpos = tell(b);
  }
  Result r = {s.err, (int32_t)s.outpos, t.n,
              (int32_t)((s.bitpos + 7) >> 3), t.wraps};
  return r;
}

// Counts rows of lane i in an (8, L) grid: 0 err, 1 output position,
// 2 tokens, 3 input bytes consumed, 4 matches of this call that crossed a
// window lap end, 5-7 zero.
QT_FN void write_counts(int32_t* cnt, int64_t L, int64_t i, Result r) {
  cnt[0 * L + i] = r.err;
  cnt[1 * L + i] = r.outpos;
  cnt[2 * L + i] = r.ntok;
  cnt[3 * L + i] = r.cursor;
  cnt[4 * L + i] = r.wraps;
  cnt[5 * L + i] = 0;
  cnt[6 * L + i] = 0;
  cnt[7 * L + i] = 0;
}

}  // namespace qt

#ifdef QTM_CORE_HOST_TWIN
// Host twin of the kernel's launch: the same per-lane call, one lane after
// another. Built only by the tests.
extern "C" int64_t qt_state_bytes() { return sizeof(qt::State); }

extern "C" int qt_decode_host(const uint8_t* streams, int64_t stride,
                              const int32_t* lens, const int32_t* targets,
                              int L, int wbits, int fresh, uint8_t* states,
                              int32_t* tok, int32_t* litw, int32_t cap,
                              int32_t* cnt) {
  for (int i = 0; i < L; i++) {
    qt::State& s = reinterpret_cast<qt::State*>(states)[i];
    if (fresh) qt::init(s, wbits);
    qt::Result r = qt::decode_stream(
        streams + (int64_t)i * stride, lens[i], targets[i], wbits, s,
        tok + (int64_t)i * cap, litw + (int64_t)i * cap, cap);
    qt::write_counts(cnt, L, i, r);
  }
  return 0;
}
#endif
