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
// The same functions run in the Hopper kernel (qtm.cu, one warp per stream,
// the State record in shared memory) and in a host twin that g++ builds
// from this header and stream_core.cuh (define QTM_CORE_HOST_TWIN), so the
// tests check the kernel's logic, its warp steps included, on a CPU.
//
// The decoder is the reference codec's sequential reader
// (libmspack_tpu/codecs/qtm.py, qtmd.c): an MSB-first bit reader over 16-bit
// big-endian units, reading zeros past the stream's end; the 16-bit H/L/C
// range coder with underflow renormalisation; nine adaptive models
// (selector, four literal models, the match-3, match-4 and variable-length
// position models, the length model), each symbol search followed by the +8
// update, the halving rescale once the total passes 3800 and, at the fourth
// rescale and every 50th after it, the reference's exchange sort run as it
// stands; selectors 0-6 with the position and length extra-bit tables; at
// each 32 KiB frame end a byte realign, a scan to the 0xFF trailer and a
// coder re-init. Literals flush at four, at a frame end and at the target,
// and before a match, as the TPU kernel flushes them, so the traces are
// equal.
//
// What the warp does in a symbol (stream_core.cuh): lane l holds rows l and
// l + 32 of the model (row 64 is the sentinel), so the search is two
// ballots, the new bounds each lane's own division and two shuffles, the
// +8 update one store a lane, and the halving rescale a suffix max over
// the warp; the exchange sort stays serial on lane 0. The
// renormalisation's bit loop is one take of all its bits, in closed form.
// The coder registers, the cursor, outpos and frame_todo stay in registers.
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

#include "stream_core.cuh"

#define QT_FN SC_FN

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

using Bits = BitReader<false>;

// The hot scalars of a State, in registers while a launch decodes.
struct Regs {
  int64_t outpos;
  int32_t frame_todo;
  uint32_t H, L, C;
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

QT_FN bool emit(Trace& t, int32_t tok, uint32_t litw) {
  if (t.n >= t.cap) return false;
  if (warp::leader()) {
    t.tok[t.n] = tok;
    t.litw[t.n] = (int32_t)litw;
  }
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

// The first row k in [1, n) where hit(cum[k]) holds, or n: the search of
// codecs/qtm.py:84-86. Lane l tests rows l and l + 32, whose values it
// holds in a and b.
template <class F>
QT_FN int first_row(const warp::Lanes<uint32_t>& a,
                    const warp::Lanes<uint32_t>& b, int n, F hit) {
  uint64_t lo = warp::ballot([&](int l) {
    return l >= 1 && l < n && hit(a.at(l));
  });
  uint64_t hi = warp::ballot([&](int l) {
    return l + 32 < n && hit(b.at(l));
  });
  uint64_t mask = lo | (hi << 32);
  return mask ? warp::ffs64(mask) - 1 : n;
}

QT_FN warp::Lanes<uint32_t> rows(const Model& m, int base) {
  return warp::map<uint32_t>([&](int l) { return (uint32_t)m.cum[l + base]; });
}

// What a symbol reads of its model before the search, loaded ahead of it:
// the rows as the lanes hold them (a: row l, c: row l + 32), the total
// and the entries.
struct Rows {
  warp::Lanes<uint32_t> a, c;
  uint32_t total;
  int n;
};

QT_FN Rows load(const Model& m) {
  Rows w = {rows(m, 0), rows(m, 32), m.cum[0], m.entries};
  return w;
}

// The halving rescale. The reference's loop from the top down,
// cum'[i] = max(cum[i] >> 1, cum'[i + 1] + 1) with cum'[n] = 0
// (codecs/qtm.py:138-142), is cum'[i] = max(e[i..n]) - i with
// e[j] = (cum[j] >> 1) + j for j < n and e[n] = n: a suffix max over the
// warp, lane l holding rows l and l + 32, row 64 beside them.
QT_FN void halve(Model& m) {
  int n = m.entries;
  auto e = [&](int j) -> uint32_t {
    return j < n ? (uint32_t)(m.cum[j] >> 1) + j : j == n ? (uint32_t)n : 0u;
  };
  warp::Lanes<uint32_t> a = warp::map<uint32_t>([&](int l) { return e(l); });
  warp::Lanes<uint32_t> b =
      warp::map<uint32_t>([&](int l) { return e(l + 32); });
  for (int d = 1; d < 32; d <<= 1) {
    a = warp::max(a, warp::shfl_down(a, d));
    b = warp::max(b, warp::shfl_down(b, d));
  }
  uint32_t top = e(64);
  uint32_t upper = warp::shfl(b, 0);  // the max of rows 32..63
  a = warp::max(a, upper > top ? upper : top);
  b = warp::max(b, top);
  warp::each([&](int l) {
    if (l < n) m.cum[l] = (uint16_t)(a.at(l) - l);
    if (l + 32 < n) m.cum[l + 32] = (uint16_t)(b.at(l) - (l + 32));
  });
}

// Turn the cumulative frequencies into counts, halve them, exchange-sort
// the symbols by count (the reference's i < j loop, whose order of equal
// counts no key-based sort reproduces) and rebuild (codecs/qtm.py:143-155).
// Lane 0 alone.
QT_FN void sort_rebuild(Model& m) {
  int n = m.entries;
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

// The rescale once the total passes 3800: halve, or at the fourth rescale
// and every 50th after it sort and rebuild (codecs/qtm.py:133-155).
QT_FN void model_update(Model& m) {
  int left = m.rescales_left - 1;
  warp::sync();
  if (left) {
    if (warp::leader()) m.rescales_left = left;
    halve(m);
  } else if (warp::leader()) {
    m.rescales_left = 50;
    sort_rebuild(m);
  }
  warp::sync();
}

// After a symbol at row i: the +8 update of rows 0..i-1, whose values lane
// l holds in a (row l) and b (row l + 32), then the rescale if the total
// passes 3800. Every lane has read the rows it needs.
QT_FN void update(Model& m, int i, const warp::Lanes<uint32_t>& a,
                  const warp::Lanes<uint32_t>& b, uint32_t total) {
  warp::sync();
  warp::each([&](int l) {
    if (l < i) m.cum[l] = (uint16_t)(a.at(l) + 8);
    if (l + 32 < i) m.cum[l + 32] = (uint16_t)(b.at(l) + 8);
  });
  warp::sync();
  if (total + 8 > 3800) model_update(m);
}

// The renormalisation loop (codecs/qtm.py:117-131) in one step. It first
// shifts k1 times while the top bits of lo and hi agree: k1 is their
// leading equal bits, 16 when lo == hi. Then it makes k2 underflow steps,
// one for each leading position from bit 14 down where lo has a 1 and hi a
// 0 after those shifts (the bits shifted in, 0 into lo and 1 into hi, end
// the run). So lo and hi come out in closed form, code takes k1 + k2 bits
// at once, and of the underflow steps' flips of code's bit 14 only the
// last, shifted once more into bit 15, survives. k1 + k2 <= 16, since each
// step doubles hi - lo (plus one).
QT_FN void renorm(Bits& b, uint32_t& lo, uint32_t& hi, uint32_t& code) {
  uint32_t x = (lo ^ hi) & 0xFFFF;
  int k1 = x ? warp::clz32(x) - 16 : 16;
  int k2 = warp::clz32(
      ~(uint32_t)((uint64_t)(lo & ~hi & 0xFFFF) << (k1 + 17)));
  int k = k1 + k2;
  uint32_t lk = (lo << k1) & 0xFFFF;
  uint32_t hk = ((hi << k1) | ((1u << k1) - 1)) & 0xFFFF;
  uint32_t in = b.peek(16) >> (16 - k);  // k bits; none for k = 0
  b.drop(k);
  code = (((code << k) | in) & 0xFFFF) ^ (k2 ? 0x8000u : 0u);
  lo = k2 ? (lk << k2) & 0x7FFF : lk;
  hi = k2 ? ((hk << k2) | ((1u << k2) - 1) | 0x8000) & 0xFFFF : hk;
}

// One symbol of model m, whose rows w holds (codecs/qtm.py:74-131,
// qtmd.c:92-123): search, narrow, update, renormalise. The reference's
// search value is symf = (num / span) & 0xFFFF; where num / span < 2^16,
// as everywhere after a coder init or a renormalisation (span > 2^14),
// cum[k] <= symf is cum[k] * span <= num, so the search waits for no
// division; the other case divides and tests cum[k] * 1 <= symf. The new
// bounds need cum[i - 1] * span / total and cum[i] * span / total: each
// lane divides for its own two rows beside the search, and two shuffles
// fetch rows i - 1 and i (row 64, the sentinel, is 0).
QT_FN int get_symbol(Bits& b, Regs& r, Model& m, const Rows& w) {
  uint32_t span = ((r.H - r.L) & 0xFFFF) + 1;
  uint32_t num = (((r.C - r.L) & 0xFFFF) + 1) * w.total - 1;
  uint32_t mul = span, lim = num;
  if ((num >> 16) >= span) {
    mul = 1;
    lim = (num / span) & 0xFFFF;
  }
  int i = first_row(w.a, w.c, w.n, [&](uint32_t v) { return v * mul <= lim; });
  warp::Lanes<uint32_t> qa =
      warp::map<uint32_t>([&](int l) { return w.a.at(l) * span / w.total; });
  warp::Lanes<uint32_t> qc =
      warp::map<uint32_t>([&](int l) { return w.c.at(l) * span / w.total; });
  uint32_t q1 = warp::shfl(i - 1 < 32 ? qa : qc, (i - 1) & 31);
  uint32_t q0 = i < 64 ? warp::shfl(i < 32 ? qa : qc, i & 31) : 0u;
  uint32_t hi = (r.L + q1 - 1) & 0xFFFF;
  uint32_t lo = (r.L + q0) & 0xFFFF;
  int sym = m.sym[i - 1];
  update(m, i, w.a, w.c, w.total);
  renorm(b, lo, hi, r.C);
  r.L = lo;
  r.H = hi;
  return sym;
}

QT_FN int get_symbol(Bits& b, Regs& r, Model& m) {
  return get_symbol(b, r, m, load(m));
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

// Decode until r.outpos reaches target (or an error).
QT_FN int run(Bits& b, Regs& r, State& s, Trace& t, int64_t target,
              int wbits) {
  int64_t wsize = (int64_t)1 << wbits;
  int64_t limit = b.n * 8 + 16;  // the reference's soft end of input
  while (r.outpos < target) {
    if (r.frame_todo == FRAME) {  // coder init from 16 raw bits
      r.H = 0xFFFF;
      r.L = 0;
      r.C = b.take(16);
    }
    // the literal models' rows, loaded beside the selector's symbol, which
    // writes only the selector model
    Rows w0 = load(s.m[1]), w1 = load(s.m[2]), w2 = load(s.m[3]),
         w3 = load(s.m[4]);
    int sel = get_symbol(b, r, s.m[0]);
    if (sel < 4) {
      Rows w = sel == 0 ? w0 : sel == 1 ? w1 : sel == 2 ? w2 : w3;
      uint32_t v = (uint32_t)get_symbol(b, r, s.m[1 + sel], w);
      t.word |= v << (8 * t.cnt);
      t.cnt++;
      r.outpos++;
      r.frame_todo--;
      if ((t.cnt == 4 || r.frame_todo == 0 || r.outpos >= target) &&
          !flush(t)) {
        return ERR_TCAP;
      }
    } else {
      int64_t len;
      int slot;
      if (sel == 4) {
        slot = get_symbol(b, r, s.m[5]);
        len = 3;
      } else if (sel == 5) {
        slot = get_symbol(b, r, s.m[6]);
        len = 4;
      } else if (sel == 6) {
        int ls = get_symbol(b, r, s.m[8]);
        len = length_base(ls) + b.take(length_extra(ls)) + 5;
        slot = get_symbol(b, r, s.m[7]);
      } else {
        return ERR_DATA;
      }
      int64_t off = position_base(slot) + b.take(extra_bits(slot)) + 1;
      int64_t lap = r.outpos & (wsize - 1);
      if (off > lap && off - lap > wsize) return ERR_DATA;
      r.frame_todo -= (int32_t)len;
      if (r.frame_todo < 0) return ERR_DATA;  // overshot frame alignment
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
      r.outpos += len;
    }
    if (r.frame_todo == 0) {  // byte realign, then scan to the trailer
      b.take(b.nbits & 7);
      for (;;) {
        if (b.tell() >= b.n * 8) return ERR_DATA;
        if (b.take(8) == 0xFF) break;
      }
      r.frame_todo = FRAME;
    }
    if (b.tell() > limit) return ERR_DATA;
  }
  return ERR_OK;
}

// A fresh record: zeros (lane by lane), then the models (lane 0).
QT_FN void init(State& s, int wbits) {
  uint32_t* p = reinterpret_cast<uint32_t*>(&s);
  warp::each([&](int l) {
    for (unsigned k = l; k < sizeof(State) / 4; k += 32) p[k] = 0;
  });
  warp::sync();
  if (warp::leader()) {
    s.frame_todo = FRAME;
    int span = wbits * 2;
    model_init(s.m[0], 0, 7);
    for (int k = 0; k < 4; k++) model_init(s.m[1 + k], 64 * k, 64);
    model_init(s.m[5], 0, span < 24 ? span : 24);
    model_init(s.m[6], 0, span < 36 ? span : 36);
    model_init(s.m[7], 0, span);
    model_init(s.m[8], 0, 27);
  }
  warp::sync();
}

// Decode one stream of n bytes up to output position target, resuming
// from s. Writes at most cap tokens.
QT_FN Result decode_stream(const uint8_t* src, int64_t n, int64_t target,
                           int wbits, State& s, int32_t* tok, int32_t* litw,
                           int32_t cap) {
  Trace t = {tok, litw, cap, 0, 0, 0, 0};
  Regs r = {s.outpos, s.frame_todo, s.H, s.L, s.C};
  int32_t err = s.err;
  int64_t bitpos = s.bitpos;
  if (err == ERR_OK && r.outpos < target) {
    Bits b = {src, n, 0, 0, 0};
    b.seek(bitpos);
    err = run(b, r, s, t, target, wbits);
    bitpos = b.tell();
  }
  warp::sync();
  if (warp::leader()) {
    s.bitpos = bitpos;
    s.outpos = r.outpos;
    s.frame_todo = r.frame_todo;
    s.err = err;
    s.H = (uint16_t)r.H;
    s.L = (uint16_t)r.L;
    s.C = (uint16_t)r.C;
  }
  warp::sync();
  Result res = {err, (int32_t)r.outpos, t.n, (int32_t)((bitpos + 7) >> 3),
                t.wraps};
  return res;
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
// Host twin of the kernel's launch: the same per-stream call, one stream
// after another, with the warp's lanes evaluated in turn. Built only by
// the tests.
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

// The warp steps alone, for the tests. qt_model_symbol: one symbol's model
// work on a qt::Model record at search value symf (search, +8 update,
// rescale); returns the row found. qt_rescale: one rescale.
extern "C" int64_t qt_model_bytes() { return sizeof(qt::Model); }

extern "C" int qt_model_symbol(uint8_t* model, uint32_t symf) {
  qt::Model& m = *reinterpret_cast<qt::Model*>(model);
  qt::Rows w = qt::load(m);
  int i = qt::first_row(w.a, w.c, w.n,
                        [&](uint32_t v) { return v <= symf; });
  qt::update(m, i, w.a, w.c, w.total);
  return i;
}

extern "C" void qt_rescale(uint8_t* model) {
  qt::model_update(*reinterpret_cast<qt::Model*>(model));
}

// renorm on n coder states (lo, hi, code) with the 32 stream bits that
// follow each (MSB first): the new states in place, the bits taken in used.
extern "C" void qt_renorm(uint16_t* lo, uint16_t* hi, uint16_t* code,
                          const uint32_t* next, int64_t n, uint8_t* used) {
  for (int64_t k = 0; k < n; k++) {
    uint8_t src[4] = {(uint8_t)(next[k] >> 24), (uint8_t)(next[k] >> 16),
                      (uint8_t)(next[k] >> 8), (uint8_t)next[k]};
    qt::Bits b = {src, 4, 0, 0, 0};
    uint32_t l = lo[k], h = hi[k], c = code[k];
    qt::renorm(b, l, h, c);
    lo[k] = (uint16_t)l;
    hi[k] = (uint16_t)h;
    code[k] = (uint16_t)c;
    used[k] = (uint8_t)b.tell();
  }
}
#endif
