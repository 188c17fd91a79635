// Frozen copy of the encoders that make the benchmark's archives: the
// MSZIP (deflate), LZX (and LZX DELTA) and Quantum encoder entry points of
// libmspack_tpu_torch/native/msp_native.cpp, with only the tables, models
// and matcher they use. The benchmark builds this file with g++ itself, so
// a change to the program's encoders does not change what it decodes.

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace lzx {

constexpr int kNumChars = 256;
constexpr int kPretreeSyms = 20;
constexpr int kAlignedSyms = 8;
constexpr int kLengthSyms = 250;     // 249 + 1
constexpr int kMaxMainSyms = 256 + 290 * 8;
constexpr int kFrame = 32768;

static const uint16_t kPosSlots[11] = {30, 32, 34, 36, 38, 42,
                                       50, 66, 98, 162, 290};

struct Tables {
  uint8_t extra_bits[291];
  uint32_t pos_base[291];
  Tables() {
    uint32_t off = 0;
    for (int i = 0; i <= 290; i++) {
      extra_bits[i] = i < 4 ? 0 : (uint8_t)((i / 2 - 1) > 17 ? 17 : i / 2 - 1);
      if (i < 291) pos_base[i] = off;
      off += 1u << extra_bits[i];
    }
  }
};
static const Tables kT;

}  // namespace lzx

namespace qtm {

constexpr int kFrame = 32768;

struct Tables {
  uint8_t extra_bits[42];
  uint32_t pos_base[42];
  uint8_t len_extra[27];
  uint8_t len_base[27];
  Tables() {
    uint32_t off = 0;
    for (int i = 0; i < 42; i++) {
      extra_bits[i] = (uint8_t)((i < 2 ? 0 : i - 2) >> 1);
      pos_base[i] = off;
      off += 1u << extra_bits[i];
    }
    uint32_t loff = 0;
    for (int i = 0; i < 27; i++) {
      len_extra[i] = (uint8_t)((i < 2 ? 0 : i - 2) >> 2);
      len_base[i] = (uint8_t)loff;
      loff += 1u << len_extra[i];
    }
    len_base[26] = 254;
    len_extra[26] = 0;
  }
};
static const Tables kQ;


struct Model {
  int entries;
  int shiftsleft;
  uint16_t sym[65];
  uint16_t cum[65];

  void init(int start, int len) {
    shiftsleft = 4;
    entries = len;
    for (int i = 0; i <= len; i++) {
      sym[i] = (uint16_t)(start + i);
      cum[i] = (uint16_t)(len - i);
    }
  }
  void update() {
    if (--shiftsleft) {
      for (int i = entries - 1; i >= 0; i--) {
        cum[i] >>= 1;
        if (cum[i] <= cum[i + 1]) cum[i] = cum[i + 1] + 1;
      }
    } else {
      shiftsleft = 50;
      for (int i = 0; i < entries; i++) {
        cum[i] = (uint16_t)(((cum[i] - cum[i + 1]) + 1) >> 1);
      }
      // in-place selection sort by frequency, decreasing (stability
      // characteristics must match the reference, qtmd.c:148-159)
      for (int i = 0; i < entries - 1; i++) {
        for (int j = i + 1; j < entries; j++) {
          if (cum[i] < cum[j]) {
            uint16_t t = cum[i]; cum[i] = cum[j]; cum[j] = t;
            t = sym[i]; sym[i] = sym[j]; sym[j] = t;
          }
        }
      }
      for (int i = entries - 1; i >= 0; i--)
        cum[i] = (uint16_t)(cum[i] + cum[i + 1]);
    }
  }
};

// ----------------------------------------------------------- encoder
// Native port of compress/qtm_e.py (same algorithm, same bitstreams):
// Witten-Neal-Cleary 16-bit range coder mirroring Decoder::get_symbol,
// with the decoder's 16-bit lookahead register handled by splicing raw
// extra-bit fields 16 RC bits after the coder's logical position.
// After the flush the RC stream is exactly shifts+1 bits while the
// decoder consumes 16+shifts, so each frame pads 15 zero bits + byte
// alignment — the tail can never contain a spurious 0xFF trailer.

struct FrameCoder {
  uint16_t H = 0xFFFF, L = 0;
  int underflow = 0;
  std::vector<uint8_t> rc;                 // RC bits in stream order
  struct Ins { uint32_t pos; uint32_t val; int nbits; };
  std::vector<Ins> ins;

  inline void emit(int bit) {
    rc.push_back((uint8_t)bit);
    if (underflow) {
      rc.insert(rc.end(), (size_t)underflow, (uint8_t)(bit ^ 1));
      underflow = 0;
    }
  }

  void encode(Model& m, int symbol) {
    int k = 0;
    while (m.sym[k] != symbol) k++;        // alphabet <= 64
    uint32_t rng = (uint32_t)(H - L) + 1;
    uint32_t tot = m.cum[0];
    uint16_t Hv = (uint16_t)(L + ((uint32_t)m.cum[k] * rng) / tot - 1);
    uint16_t Lv = (uint16_t)(L + ((uint32_t)m.cum[k + 1] * rng) / tot);
    for (int j = k; j >= 0; j--) m.cum[j] += 8;
    if (m.cum[0] > 3800) m.update();
    for (;;) {
      if ((Lv & 0x8000) == (Hv & 0x8000)) {
        emit(Lv >> 15);
      } else if ((Lv & 0x4000) && !(Hv & 0x4000)) {
        underflow++;
        Lv &= 0x3FFF;
        Hv |= 0x4000;
      } else {
        break;
      }
      Lv = (uint16_t)(Lv << 1);
      Hv = (uint16_t)((Hv << 1) | 1);
    }
    H = Hv;
    L = Lv;
  }

  inline void raw(uint32_t val, int nbits) {
    if (nbits)
      ins.push_back({(uint32_t)(16 + rc.size() + underflow), val, nbits});
  }

  // flush + splice; appends the frame payload to out. Returns bytes
  // written or -1 when out of capacity.
  int64_t finish(uint8_t* out, uint64_t cap) {
    underflow++;
    emit(L < 0x4000 ? 0 : 1);
    rc.insert(rc.end(), 15, 0);            // decoder eats 16+shifts bits

    uint64_t acc = 0, outn = 0;
    int accn = 0;
    auto putbit = [&](int b) -> bool {
      acc = (acc << 1) | (unsigned)b;
      if (++accn == 8) {
        if (outn >= cap) return false;
        out[outn++] = (uint8_t)acc;
        acc = 0;
        accn = 0;
      }
      return true;
    };
    size_t ip = 0;
    for (size_t i = 0; i <= rc.size(); i++) {
      while (ip < ins.size() && ins[ip].pos == i) {
        for (int b = ins[ip].nbits - 1; b >= 0; b--)
          if (!putbit((ins[ip].val >> b) & 1)) return -1;
        ip++;
      }
      if (i < rc.size() && !putbit(rc[i])) return -1;
    }
    while (accn)
      if (!putbit(0)) return -1;
    return (int64_t)outn;
  }
};

struct Encoder {
  int wb;
  uint32_t wsize;
  Model m0, m1, m2, m3, m4, m5, m6, m6len, m7;

  void init(int window_bits) {
    wb = window_bits;
    wsize = 1u << wb;
    int i = wb * 2;
    m0.init(0, 64); m1.init(64, 64); m2.init(128, 64); m3.init(192, 64);
    m4.init(0, i > 24 ? 24 : i);
    m5.init(0, i > 36 ? 36 : i);
    m6.init(0, i);
    m6len.init(0, 27);
    m7.init(0, 7);
  }

  // largest slot with pos_base[s] <= dist-1 that also fits the model's
  // alphabet (qtmd.c:242-251 sizes model 4/5 below the full table)
  static inline int pos_slot(uint32_t dist, int entries) {
    uint32_t f = dist - 1;
    int lo = 0, hi = entries - 1, s = 0;
    while (lo <= hi) {
      int mid = (lo + hi) >> 1;
      if (kQ.pos_base[mid] <= f) { s = mid; lo = mid + 1; }
      else hi = mid - 1;
    }
    if (f >= kQ.pos_base[s] + (1u << kQ.extra_bits[s])) return -1;
    return s;
  }

  bool encode_match(FrameCoder& fc, uint32_t length, uint32_t dist) {
    if (length == 3) {
      int s = pos_slot(dist, m4.entries);
      if (s < 0) return false;
      fc.encode(m7, 4);
      fc.encode(m4, s);
      fc.raw(dist - 1 - kQ.pos_base[s], kQ.extra_bits[s]);
      return true;
    }
    if (length == 4) {
      int s = pos_slot(dist, m5.entries);
      if (s < 0) return false;
      fc.encode(m7, 5);
      fc.encode(m5, s);
      fc.raw(dist - 1 - kQ.pos_base[s], kQ.extra_bits[s]);
      return true;
    }
    int s = pos_slot(dist, m6.entries);
    if (s < 0) return false;
    uint32_t lv = length - 5;
    int ls = 26;
    while (kQ.len_base[ls] > lv) ls--;
    fc.encode(m7, 6);
    fc.encode(m6len, ls);
    fc.raw(lv - kQ.len_base[ls], kQ.len_extra[ls]);
    fc.encode(m6, s);
    fc.raw(dist - 1 - kQ.pos_base[s], kQ.extra_bits[s]);
    return true;
  }

  inline void encode_literal(FrameCoder& fc, uint8_t byte) {
    int sel = byte >> 6;
    fc.encode(m7, sel);
    Model* lm[4] = {&m0, &m1, &m2, &m3};
    fc.encode(*lm[sel], byte);
  }
};

}  // namespace qtm

// ============================================================ LZX encode
// Entropy-coded LZX encoder (native port of compress/lzx_e.py). The
// reference has no LZX compressor at all (reference: lzxc.c:18 stub);
// format semantics are those pinned by the decoder above (lzxd.c).
// One VERBATIM/ALIGNED/UNCOMPRESSED block per 32 KiB frame, chosen by
// measured bit cost; greedy hash-chain matching with R0-R2 repeated-
// offset priority; trees delta-coded against the previous block via
// the 20-symbol pretree with run codes 17/18/19.

namespace lzxe {

using lzx::kT;
using lzx::kPosSlots;
constexpr int kFrame = 32768;
constexpr int kNumChars = 256;
constexpr int kSecondary = 249;

// ------------------------------------------------------------- writer
// MSB-first bits packed into 16-bit little-endian units.
struct BitOut {
  std::vector<uint8_t> out;
  uint64_t pend = 0;
  int cnt = 0;

  inline void put(uint32_t v, int nbits) {
    pend = (pend << nbits) | (v & ((nbits == 32 ? 0xFFFFFFFFull : ((1ull << nbits) - 1))));
    cnt += nbits;
    while (cnt >= 16) {
      uint32_t unit = (uint32_t)(pend >> (cnt - 16)) & 0xFFFF;
      out.push_back((uint8_t)(unit & 0xFF));
      out.push_back((uint8_t)(unit >> 8));
      cnt -= 16;
    }
    pend &= (1ull << cnt) - 1;
  }
  inline void align16() { put(0, cnt ? 16 - cnt : 16); }
  inline void bytes(const uint8_t* p, size_t n) {
    out.insert(out.end(), p, p + n);
  }
};

// ------------------------------------------- length-limited huffman
// Huffman depths via the in-place sorted-array method, then zlib-style
// overflow redistribution to the limit; resulting code is always
// Kraft-complete (the decoder rejects incomplete tables).
static void make_lengths(const uint32_t* freq, int n, int limit,
                         uint8_t* lens) {
  std::vector<int> used;
  used.reserve(n);
  for (int i = 0; i < n; i++) {
    lens[i] = 0;
    if (freq[i]) used.push_back(i);
  }
  if (used.empty()) return;
  if (used.size() == 1) {
    int s = used[0];
    lens[s] = 1;
    lens[s + 1 < n ? s + 1 : s - 1] = 1;
    return;
  }
  int m = (int)used.size();
  // heap-free Huffman: sort leaves by freq, merge with a second queue
  std::vector<std::pair<uint64_t, int>> leaves(m);  // (freq, used-index)
  for (int i = 0; i < m; i++) leaves[i] = {freq[used[i]], i};
  std::sort(leaves.begin(), leaves.end());
  std::vector<uint64_t> nodew(2 * m);
  std::vector<int> parent(2 * m, -1);
  int li = 0, qi = m, qh = m;  // internal nodes at [m, qi)
  auto takemin = [&]() -> int {
    if (li < m && (qh >= qi || leaves[li].first <= nodew[qh]))
      return li++;
    return qh++;
  };
  for (int k = 0; k < m - 1; k++) {
    int a = takemin(), b = takemin();
    uint64_t wa = a < m ? leaves[a].first : nodew[a];
    uint64_t wb = b < m ? leaves[b].first : nodew[b];
    nodew[qi] = wa + wb;
    parent[a] = qi;
    parent[b] = qi;
    qi++;
  }
  // depth of each leaf
  std::vector<int> depth(2 * m, 0);
  for (int k = qi - 1; k >= m; k--)
    depth[k] = parent[k] < 0 ? 0 : depth[parent[k]] + 1;
  int bl_count[64] = {0};
  int maxd = 0;
  std::vector<int> leafdepth(m);
  for (int i = 0; i < m; i++) {
    int d = depth[parent[i]] + 1;
    leafdepth[i] = d;
    if (d > maxd) maxd = d;
  }
  if (maxd > limit) {
    // clamp and redistribute (zlib tree.c discipline)
    for (int i = 0; i < m; i++)
      if (leafdepth[i] > limit) leafdepth[i] = limit;
    int64_t kraft = 0;
    for (int i = 0; i < m; i++) kraft += 1ll << (limit - leafdepth[i]);
    // overflow: push shallow symbols deeper (smallest kraft step first:
    // deepest candidates < limit)
    while (kraft > (1ll << limit)) {
      int pick = -1, pd = -1;
      for (int i = 0; i < m; i++)
        if (leafdepth[i] < limit && leafdepth[i] > pd) {
          pd = leafdepth[i];
          pick = i;
        }
      leafdepth[pick]++;
      kraft -= 1ll << (limit - leafdepth[pick]);
    }
    // deficit: promote the deepest symbols (unit steps available at
    // len == limit, so this always lands exactly on completeness)
    while (kraft < (1ll << limit)) {
      int64_t deficit = (1ll << limit) - kraft;
      int pick = -1, pd = -1;
      for (int i = 0; i < m; i++) {
        int d = leafdepth[i];
        if (d > 1 && (1ll << (limit - d)) <= deficit && d > pd) {
          pd = d;
          pick = i;
        }
      }
      // promoting d -> d-1 adds 2^(limit-d) (the delta, not the new
      // total contribution 2^(limit-d+1))
      kraft += 1ll << (limit - leafdepth[pick]);
      leafdepth[pick]--;
    }
  }
  (void)bl_count;
  for (int i = 0; i < m; i++) lens[used[leaves[i].second]] = (uint8_t)leafdepth[i];
}

// canonical MSB codes in (length asc, symbol asc) order — the decoder's
// make_decode_table assignment (readhuff.h:83-176)
static void canonical_codes(const uint8_t* lens, int n, uint16_t* codes) {
  int count[18] = {0};
  for (int i = 0; i < n; i++) count[lens[i]]++;
  count[0] = 0;
  uint32_t next[18] = {0};
  uint32_t code = 0;
  for (int b = 1; b <= 17; b++) {
    code = (code + count[b - 1]) << 1;
    next[b] = code;
  }
  for (int i = 0; i < n; i++)
    codes[i] = lens[i] ? (uint16_t)next[lens[i]]++ : 0;
}

// ------------------------------------------------ pretree emission
struct LenOp {
  uint8_t sym;     // pretree symbol 0..19
  uint8_t ebits;   // raw extra bits after it (0 if none)
  uint8_t extra;   // extra value
  uint8_t sym2;    // second pretree symbol for code 19 (0xFF if none)
};

static void len_ops(const uint8_t* prev, const uint8_t* now, int first,
                    int last, std::vector<LenOp>& ops) {
  int x = first;
  while (x < last) {
    int v = now[x];
    int run = 1;
    while (x + run < last && now[x + run] == v) run++;
    if (v == 0) {
      while (run >= 20) {
        int t = run > 51 ? 51 : run;
        ops.push_back({18, 5, (uint8_t)(t - 20), 0xFF});
        run -= t;
        x += t;
      }
      while (run >= 4) {
        int t = run > 19 ? 19 : run;
        ops.push_back({17, 4, (uint8_t)(t - 4), 0xFF});
        run -= t;
        x += t;
      }
    }
    while (run >= 4) {
      int t = run == 8 ? 4 : (run >= 5 ? 5 : 4);
      uint8_t z = (uint8_t)(((int)prev[x] - v + 17) % 17);
      ops.push_back({19, 1, (uint8_t)(t - 4), z});
      run -= t;
      x += t;
    }
    while (run > 0) {
      ops.push_back({(uint8_t)(((int)prev[x] - v + 17) % 17), 0, 0, 0xFF});
      run--;
      x++;
    }
  }
}

static int64_t lens_cost(const uint8_t* prev, const uint8_t* now, int first,
                         int last) {
  std::vector<LenOp> ops;
  len_ops(prev, now, first, last, ops);
  uint32_t freq[20] = {0};
  int64_t extra = 0;
  for (auto& op : ops) {
    freq[op.sym]++;
    if (op.sym2 != 0xFF) freq[op.sym2]++;
    extra += op.ebits;
  }
  uint8_t pl[20];
  make_lengths(freq, 20, 15, pl);
  int64_t c = 80 + extra;
  for (int s = 0; s < 20; s++) c += (int64_t)pl[s] * freq[s];
  return c;
}

static void write_lens(BitOut& w, const uint8_t* prev, const uint8_t* now,
                       int first, int last) {
  std::vector<LenOp> ops;
  len_ops(prev, now, first, last, ops);
  uint32_t freq[20] = {0};
  for (auto& op : ops) {
    freq[op.sym]++;
    if (op.sym2 != 0xFF) freq[op.sym2]++;
  }
  uint8_t pl[20];
  uint16_t pc[20];
  make_lengths(freq, 20, 15, pl);
  canonical_codes(pl, 20, pc);
  for (int i = 0; i < 20; i++) w.put(pl[i], 4);
  for (auto& op : ops) {
    w.put(pc[op.sym], pl[op.sym]);
    if (op.ebits) w.put(op.extra, op.ebits);
    if (op.sym2 != 0xFF) w.put(pc[op.sym2], pl[op.sym2]);
  }
}

// --------------------------------------------------------- matcher
// Hash chains with a window-sized ring for the chain links: position
// p's link lives at prev[p & (window-1)]. A slot is only overwritten
// by p + window, and chains never follow distances >= window, so no
// staleness check is needed. Memory is O(window), not O(input) —
// essential for 2 GiB CAB folders. Positions are int32 (the CAB
// format caps folders below 2^31; msp_lzx_encode rejects larger).
struct Matcher {
  static constexpr int kHashBits = 17;
  const uint8_t* buf;
  size_t len;
  int max_chain;
  uint32_t mask;
  std::vector<int32_t> head;
  std::vector<int32_t> prev;

  Matcher(const uint8_t* b, size_t n, int chain, uint32_t window)
      : buf(b), len(n), max_chain(chain), mask(window - 1),
        head((size_t)1 << kHashBits, -1), prev(window, -1) {}

  static inline uint32_t h3(const uint8_t* p) {
    return ((uint32_t)p[0] << 12 ^ (uint32_t)p[1] << 6 ^ (uint32_t)p[2]) &
           ((1u << kHashBits) - 1);
  }
  inline void insert(size_t pos) {
    if (pos + 2 >= len) return;
    uint32_t h = h3(buf + pos);
    prev[(uint32_t)pos & mask] = head[h];
    head[h] = (int32_t)pos;
  }
};

struct Token {
  uint8_t kind;     // 0 literal, 1 rep, 2 explicit
  uint8_t lit;      // literal byte / rep slot
  uint32_t length;
  uint32_t dist;
};

// ----------------------------------------------------------- encoder
struct Encoder {
  int window_bits;
  uint32_t window_size;
  int reset_interval;
  bool is_delta;
  int max_chain;
  int num_slots;
  int num_offsets;
  uint32_t max_formatted;
  const uint8_t* buf;   // ref + data
  size_t origin;        // ref length
  size_t total;         // buf length

  Encoder(int wb, int ri, bool delta, int chain)
      : window_bits(wb), window_size(1u << wb), reset_interval(ri),
        is_delta(delta), max_chain(chain) {
    num_slots = kPosSlots[wb - 15];
    num_offsets = num_slots << 3;
    max_formatted = kT.pos_base[num_slots - 1] +
                    (1u << kT.extra_bits[num_slots - 1]) - 1;
  }

  inline bool dist_ok(uint64_t dist, size_t pos_buf) const {
    uint64_t pos_data = pos_buf - origin;
    uint64_t wp = pos_data & (window_size - 1);
    if (dist <= wp) return true;
    if (origin) return dist <= wp + origin;
    return pos_data >= 65536 && dist <= pos_data - 65536;
  }

  inline int slot_for(uint32_t fmt) const {
    // pos_base is monotone; binary search
    int lo = 0, hi = num_slots - 1;
    while (lo < hi) {
      int mid = (lo + hi + 1) >> 1;
      if (kT.pos_base[mid] <= fmt) lo = mid;
      else hi = mid - 1;
    }
    return lo;
  }

  void tokenize_frame(Matcher& mt, size_t pos, size_t fend,
                      size_t chunk_start, uint32_t* R,
                      std::vector<Token>& toks) const {
    const uint8_t* b = buf;
    uint64_t max_match = is_delta ? 257 + 32767 : 257;
    uint64_t wlimit = window_size - 2;
    while (pos < fend) {
      uint64_t cap = fend - pos;
      if (cap > max_match) cap = max_match;
      // repeated offsets first
      uint32_t rep_len = 0;
      int rep_slot = -1;
      for (int ri = 0; ri < 3; ri++) {
        uint64_t d = R[ri];
        if (d <= pos - chunk_start && d <= wlimit && dist_ok(d, pos)) {
          uint64_t l = 0;
          const uint8_t* s = b + pos - d;
          const uint8_t* t = b + pos;
          while (l < cap && s[l] == t[l]) l++;
          if (l > rep_len) {
            rep_len = (uint32_t)l;
            rep_slot = ri;
          }
        }
      }
      // hash chain
      uint32_t best_len = 0;
      uint64_t best_dist = 0;
      if (pos + 2 < fend) {
        int64_t cand = mt.head[Matcher::h3(b + pos)];
        int chain = max_chain;
        while (cand >= 0 && chain-- > 0) {
          // ring slots older than one window are never followed:
          // the dist checks below break first
          uint64_t dist = pos - (uint64_t)cand;
          if (!(dist <= pos - chunk_start && dist <= wlimit &&
                dist + 2 <= max_formatted && dist_ok(dist, pos)))
            break;
          const uint8_t* s = b + cand;
          const uint8_t* t = b + pos;
          if (best_len < cap && s[best_len] == t[best_len]) {
            uint64_t l = 0;
            while (l < cap && s[l] == t[l]) l++;
            if (l > best_len) {
              best_len = (uint32_t)l;
              best_dist = dist;
              if (l >= cap) break;
            }
          }
          cand = mt.prev[(uint32_t)cand & mt.mask];
        }
        if (best_len < 3) best_len = 0;
      }
      if (rep_len >= 2 && rep_len + 1 >= best_len) {
        toks.push_back({1, (uint8_t)rep_slot, rep_len, 0});
        if (rep_slot == 1) std::swap(R[0], R[1]);
        else if (rep_slot == 2) std::swap(R[0], R[2]);
        for (size_t p = pos; p < pos + rep_len; p++) mt.insert(p);
        pos += rep_len;
      } else if (best_len >= 3 && (best_len >= 4 || best_dist < 4096)) {
        toks.push_back({2, 0, best_len, (uint32_t)best_dist});
        R[2] = R[1];
        R[1] = R[0];
        R[0] = (uint32_t)best_dist;
        for (size_t p = pos; p < pos + best_len; p++) mt.insert(p);
        pos += best_len;
      } else {
        toks.push_back({0, b[pos], 0, 0});
        mt.insert(pos);
        pos++;
      }
    }
  }

  struct FrameOut {
    const std::vector<Token>* toks;
    const uint8_t* data;
    uint32_t len;
  };

  void emit_tokens(BitOut& w, const std::vector<Token>& toks, bool aligned,
                   const uint16_t* mcodes, const uint8_t* mlens,
                   const uint16_t* lcodes, const uint8_t* llens,
                   const uint16_t* acodes, const uint8_t* alens) const {
    for (auto& t : toks) {
      if (t.kind == 0) {
        w.put(mcodes[t.lit], mlens[t.lit]);
        continue;
      }
      uint32_t length = t.length;
      uint32_t enc_len = length > 257 ? 257 : length;
      int lh = (int)enc_len - 2;
      if (lh > 7) lh = 7;
      int slot;
      uint32_t fmt = 0;
      if (t.kind == 1) {
        slot = t.lit;
      } else {
        fmt = t.dist + 2;
        slot = slot_for(fmt);
      }
      int sym = kNumChars + (slot << 3) + lh;
      w.put(mcodes[sym], mlens[sym]);
      if (lh == 7) {
        int sec = enc_len - 9;
        w.put(lcodes[sec], llens[sec]);
      }
      if (t.kind == 2) {
        int extra = kT.extra_bits[slot];
        uint32_t val = fmt - kT.pos_base[slot];
        if (extra >= 3 && aligned) {
          if (extra > 3) w.put(val >> 3, extra - 3);
          w.put(acodes[val & 7], alens[val & 7]);
        } else if (extra) {
          w.put(val, extra);
        }
      }
      if (is_delta && length >= 257) {
        uint32_t ex = length - 257;
        if (ex < 0x100) {
          w.put(0, 1);
          w.put(ex, 8);
        } else if (ex < 0x100 + 0x400) {
          w.put(2, 2);
          w.put(ex - 0x100, 10);
        } else if (ex < 0x500 + 0x1000) {
          w.put(6, 3);
          w.put(ex - 0x500, 12);
        } else {
          w.put(7, 3);
          w.put(ex, 15);
        }
      }
    }
  }

  // Emit ONE block covering `frames` (trees amortise across the whole
  // block); handles per-frame offsets, DELTA chunk fields and 16-bit
  // frame realigns. Returns true if an UNCOMPRESSED block was chosen
  // (caller restores the R snapshot: the raw 12 bytes pin it there).
  bool emit_block_group(BitOut& w, const std::vector<FrameOut>& frames,
                        uint8_t* prev_main, uint8_t* prev_len,
                        const uint32_t* R_before, bool more_blocks,
                        std::vector<uint64_t>& offs,
                        bool first_of_chunk) const {
    int main_n = kNumChars + num_offsets;
    std::vector<uint32_t> fmain(main_n, 0);
    uint32_t flen[kSecondary] = {0};
    uint32_t falign[8] = {0};
    int64_t verb_extra = 0, align_extra = 0;
    uint32_t block_len = 0;
    for (auto& fo : frames) {
      block_len += fo.len;
      for (auto& t : *fo.toks) {
        if (t.kind == 0) {
          fmain[t.lit]++;
          continue;
        }
        int slot;
        if (t.kind == 1) {
          slot = t.lit;
        } else {
          uint32_t fmt = t.dist + 2;
          slot = slot_for(fmt);
          int extra = kT.extra_bits[slot];
          if (extra >= 3) {
            falign[(fmt - kT.pos_base[slot]) & 7]++;
            align_extra += extra - 3;
          } else {
            align_extra += extra;
          }
          verb_extra += extra;
        }
        uint32_t length = t.length;
        uint32_t enc_len = length > 257 ? 257 : length;
        int lh = (int)enc_len - 2;
        if (lh > 7) lh = 7;
        fmain[kNumChars + (slot << 3) + lh]++;
        if (lh == 7) flen[enc_len - 9]++;
        if (is_delta && length >= 257) {
          uint32_t ex = length - 257;
          int eb = ex < 0x100 ? 9 : ex < 0x500 ? 12 : ex < 0x1500 ? 15 : 18;
          verb_extra += eb;
          align_extra += eb;
        }
      }
    }
    std::vector<uint8_t> mlens(main_n), llens(kSecondary);
    make_lengths(fmain.data(), main_n, 16, mlens.data());
    make_lengths(flen, kSecondary, 16, llens.data());
    int64_t body = 0;
    for (int sy = 0; sy < main_n; sy++) body += (int64_t)mlens[sy] * fmain[sy];
    for (int sy = 0; sy < kSecondary; sy++)
      body += (int64_t)llens[sy] * flen[sy];
    int64_t tree_cost = lens_cost(prev_main, mlens.data(), 0, 256) +
                        lens_cost(prev_main, mlens.data(), 256, main_n) +
                        lens_cost(prev_len, llens.data(), 0, kSecondary);
    uint8_t alens[8];
    make_lengths(falign, 8, 7, alens);
    bool any_a = false;
    for (int k = 0; k < 8; k++) any_a |= alens[k] != 0;
    if (!any_a)
      for (int k = 0; k < 8; k++) alens[k] = 3;
    int64_t acost = 0;
    for (int sy = 0; sy < 8; sy++) acost += (int64_t)alens[sy] * falign[sy];
    int64_t verb_bits = 3 + 24 + tree_cost + body + verb_extra;
    int64_t alig_bits = 3 + 24 + 24 + tree_cost + body + align_extra + acost;
    int64_t unc_bits = 3 + 24 + 16 + 8ll * (12 + block_len + (block_len & 1));
    bool stored = unc_bits < verb_bits && unc_bits < alig_bits;

    auto frame_prologue = [&](bool first_frame) -> size_t {
      offs.push_back(w.out.size());
      size_t patch = SIZE_MAX;
      if (is_delta) {
        patch = w.out.size();
        w.put(0, 16);
      }
      if (first_frame && first_of_chunk) w.put(0, 1);
      return patch;
    };
    auto frame_epilogue = [&](size_t patch) {
      if (w.cnt) w.align16();
      if (patch != SIZE_MAX) {
        size_t chunk = w.out.size() - patch - 2;
        w.out[patch] = (uint8_t)(chunk & 0xFF);
        w.out[patch + 1] = (uint8_t)((chunk >> 8) & 0xFF);
      }
    };

    if (stored) {
      bool first = true;
      for (auto& fo : frames) {
        size_t patch = frame_prologue(first);
        if (first) {
          w.put(3, 3);
          w.put(block_len, 24);
          w.align16();
          uint8_t rb[12];
          for (int k = 0; k < 3; k++)
            for (int j = 0; j < 4; j++)
              rb[k * 4 + j] = (R_before[k] >> (8 * j)) & 0xFF;
          w.bytes(rb, 12);
          first = false;
        }
        w.bytes(fo.data, fo.len);
        frame_epilogue(patch);
      }
      if ((block_len & 1) && more_blocks) {
        uint8_t z = 0;
        w.bytes(&z, 1);
      }
      return true;
    }

    bool aligned = alig_bits < verb_bits;
    uint16_t acodes[8];
    canonical_codes(alens, 8, acodes);
    std::vector<uint16_t> mcodes(main_n), lcodes(kSecondary);
    bool first = true;
    for (auto& fo : frames) {
      size_t patch = frame_prologue(first);
      if (first) {
        w.put(aligned ? 2 : 1, 3);
        w.put(block_len, 24);
        if (aligned)
          for (int k = 0; k < 8; k++) w.put(alens[k], 3);
        write_lens(w, prev_main, mlens.data(), 0, 256);
        write_lens(w, prev_main, mlens.data(), 256, main_n);
        write_lens(w, prev_len, llens.data(), 0, kSecondary);
        memcpy(prev_main, mlens.data(), main_n);
        memcpy(prev_len, llens.data(), kSecondary);
        canonical_codes(mlens.data(), main_n, mcodes.data());
        canonical_codes(llens.data(), kSecondary, lcodes.data());
        first = false;
      }
      emit_tokens(w, *fo.toks, aligned, mcodes.data(), mlens.data(),
                  lcodes.data(), llens.data(), acodes, alens);
      frame_epilogue(patch);
    }
    if (w.out.size() & 1) {
      uint8_t z = 0;
      w.bytes(&z, 1);
    }
    return false;
  }

  // full stream; returns frame offsets through `offs`
  std::vector<uint8_t> compress(const uint8_t* data, size_t len,
                                const uint8_t* ref, size_t ref_len,
                                std::vector<uint64_t>& offs,
                                int block_frames) {
    std::vector<uint8_t> holder;
    if (ref_len) {
      holder.resize(ref_len + len);
      memcpy(holder.data(), ref, ref_len);
      memcpy(holder.data() + ref_len, data, len);
      buf = holder.data();
    } else {
      buf = data;
    }
    origin = ref_len;
    total = ref_len + len;
    Matcher mt(buf, total, max_chain, window_size);
    for (size_t p = 0; p < origin; p++) mt.insert(p);

    BitOut w;
    int main_n = kNumChars + num_offsets;
    std::vector<uint8_t> prev_main(main_n, 0), prev_len(kSecondary, 0);
    uint32_t R[3] = {1, 1, 1};

    if (len == 0) {  // zero-length stream: one empty uncompressed block
      if (is_delta) w.put(0, 16);
      offs.push_back(0);
      w.put(0, 1);
      w.put(3, 3);
      w.put(0, 24);
      w.align16();
      uint8_t rb[12];
      for (int k = 0; k < 3; k++)
        for (int j = 0; j < 4; j++) rb[k * 4 + j] = (R[k] >> (8 * j)) & 0xFF;
      w.bytes(rb, 12);
      return std::move(w.out);
    }

    size_t nframes = (len + kFrame - 1) / kFrame;
    if (block_frames < 1) block_frames = 1;
    size_t chunk_start = 0;
    bool first_of_chunk = false;
    std::vector<std::vector<Token>> toks_pool;
    size_t i = 0;
    while (i < nframes) {
      if (i == 0 || (reset_interval && (i % (size_t)reset_interval) == 0)) {
        std::fill(prev_main.begin(), prev_main.end(), 0);
        std::fill(prev_len.begin(), prev_len.end(), 0);
        R[0] = R[1] = R[2] = 1;
        chunk_start = i * kFrame;
        first_of_chunk = true;
      }
      size_t chunk_end = reset_interval
                             ? std::min(nframes, (i / (size_t)reset_interval + 1) *
                                                     (size_t)reset_interval)
                             : nframes;
      size_t bend = std::min(i + (size_t)block_frames, chunk_end);

      uint32_t R_snapshot[3] = {R[0], R[1], R[2]};
      size_t cstart = chunk_start ? origin + chunk_start : 0;
      size_t nblk = bend - i;
      if (toks_pool.size() < nblk) toks_pool.resize(nblk);
      std::vector<FrameOut> frames;
      frames.reserve(nblk);
      for (size_t k = 0; k < nblk; k++) {
        size_t fstart = (i + k) * kFrame;
        size_t fend = std::min(fstart + (size_t)kFrame, len);
        toks_pool[k].clear();
        tokenize_frame(mt, origin + fstart, origin + fend, cstart, R,
                       toks_pool[k]);
        frames.push_back(
            {&toks_pool[k], data + fstart, (uint32_t)(fend - fstart)});
      }
      bool stored = emit_block_group(w, frames, prev_main.data(),
                                     prev_len.data(), R_snapshot,
                                     bend < nframes, offs, first_of_chunk);
      if (stored) {
        R[0] = R_snapshot[0];
        R[1] = R_snapshot[1];
        R[2] = R_snapshot[2];
      }
      first_of_chunk = false;
      i = bend;
    }
    return std::move(w.out);
  }
};

}  // namespace lzxe

namespace lzxe {
// ===================== DEFLATE (MSZIP) encoder ======================
// The project's own deflate entropy coder (reference mszipc.c is a
// stub; format pinned by the reference decoder, mszipd.c:91-219).
// Greedy hash-chain matching with one-symbol lazy evaluation, Huffman
// lengths via make_lengths (limit 15 / 7), code-length RLE 16/17/18,
// per-frame stored/fixed/dynamic choice by measured bit cost.

struct LsbOut {
  std::vector<uint8_t>& out;
  uint64_t acc = 0;
  int cnt = 0;
  explicit LsbOut(std::vector<uint8_t>& o) : out(o) {}
  inline void put(uint32_t v, int n) {
    acc |= (uint64_t)(v & (n >= 32 ? 0xFFFFFFFFu : ((1u << n) - 1)))
           << cnt;
    cnt += n;
    while (cnt >= 8) {
      out.push_back((uint8_t)acc);
      acc >>= 8;
      cnt -= 8;
    }
  }
  inline void code(uint32_t c, int len) {
    uint32_t rev = 0;
    for (int i = 0; i < len; i++) { rev = (rev << 1) | (c & 1); c >>= 1; }
    put(rev, len);
  }
  inline void flush() { if (cnt) { out.push_back((uint8_t)acc); acc = 0; cnt = 0; } }
};

static const uint16_t kDLenBase[29] = {3,4,5,6,7,8,9,10,11,13,15,17,19,
  23,27,31,35,43,51,59,67,83,99,115,131,163,195,227,258};
static const uint8_t kDLenExtra[29] = {0,0,0,0,0,0,0,0,1,1,1,1,2,2,2,2,
  3,3,3,3,4,4,4,4,5,5,5,5,0};
static const uint16_t kDDistBase[30] = {1,2,3,4,5,7,9,13,17,25,33,49,65,
  97,129,193,257,385,513,769,1025,1537,2049,3073,4097,6145,8193,12289,
  16385,24577};
static const uint8_t kDDistExtra[30] = {0,0,0,0,1,1,2,2,3,3,4,4,5,5,6,6,
  7,7,8,8,9,9,10,10,11,11,12,12,13,13};
static const uint8_t kDClOrder[19] = {16,17,18,0,8,7,9,6,10,5,11,4,12,3,
  13,2,14,1,15};

static inline int d_len_code(uint32_t l) {
  int lo = 0, hi = 28;
  while (lo < hi) { int mid = (lo + hi + 1) >> 1;
    if (kDLenBase[mid] <= l) lo = mid; else hi = mid - 1; }
  return lo;
}
static inline int d_dist_code(uint32_t d) {
  int lo = 0, hi = 29;
  while (lo < hi) { int mid = (lo + hi + 1) >> 1;
    if (kDDistBase[mid] <= d) lo = mid; else hi = mid - 1; }
  return lo;
}

// canonical codes for the LSB (deflate) decoder: same (len asc, sym
// asc) assignment; the writer bit-reverses on emit
static void d_canonical(const uint8_t* lens, int n, uint16_t* codes) {
  int count[16] = {0};
  for (int i = 0; i < n; i++) count[lens[i]]++;
  count[0] = 0;
  uint32_t next[17] = {0};
  uint32_t code = 0;
  for (int b = 1; b <= 15; b++) { code = (code + count[b - 1]) << 1; next[b] = code; }
  for (int i = 0; i < n; i++)
    codes[i] = lens[i] ? (uint16_t)next[lens[i]]++ : 0;
}

struct DTok { uint8_t kind; uint8_t lit; uint16_t len; uint16_t dist16; uint32_t dist; };

static void d_tokenize(const uint8_t* buf, size_t start, size_t end,
                       Matcher& mt, std::vector<DTok>& toks) {
  size_t pos = start;
  uint32_t pl = 0, pd = 0;   // pending lazy match
  bool pend = false;
  while (pos < end) {
    uint32_t best_len = 0, best_dist = 0;
    size_t cap = end - pos;
    if (cap > 258) cap = 258;
    if (pos + 2 < end) {
      int64_t cand = mt.head[Matcher::h3(buf + pos)];
      int chain = 128;
      while (cand >= 0 && chain-- > 0) {
        uint64_t dist = pos - (uint64_t)cand;
        if (dist > 32768) break;
        const uint8_t* sp = buf + cand;
        const uint8_t* tp = buf + pos;
        if (best_len < cap && sp[best_len] == tp[best_len]) {
          uint32_t l = 0;
          while (l < cap && sp[l] == tp[l]) l++;
          if (l > best_len) { best_len = l; best_dist = (uint32_t)dist;
            if (l >= cap) break; }
        }
        cand = mt.prev[(uint32_t)cand & mt.mask];
      }
      if (best_len < 3) best_len = 0;
    }
    if (pend) {
      if (best_len > pl) {
        toks.push_back({0, buf[pos - 1], 0, 0, 0});
        pl = best_len; pd = best_dist;
        mt.insert(pos); pos++;
        continue;
      }
      toks.push_back({1, 0, (uint16_t)pl, 0, pd});
      size_t stop = pos - 1 + pl;
      if (stop > end) stop = end;
      while (pos < stop) { mt.insert(pos); pos++; }
      pend = false;
      continue;
    }
    if (best_len >= 3) {
      if (best_len < 32 && pos + 1 < end) {
        pl = best_len; pd = best_dist; pend = true;
        mt.insert(pos); pos++;
        continue;
      }
      toks.push_back({1, 0, (uint16_t)best_len, 0, best_dist});
      size_t stop = pos + best_len;
      if (stop > end) stop = end;
      while (pos < stop) { mt.insert(pos); pos++; }
    } else {
      toks.push_back({0, buf[pos], 0, 0, 0});
      mt.insert(pos); pos++;
    }
  }
  if (pend) toks.push_back({1, 0, (uint16_t)pl, 0, pd});
}

struct DClOp { uint8_t sym, nextra; uint16_t extra; };

static void d_cl_ops(const uint8_t* lens, int n, std::vector<DClOp>& ops) {
  int i = 0;
  while (i < n) {
    uint8_t v = lens[i];
    int run = 1;
    while (i + run < n && lens[i + run] == v) run++;
    int total = run;
    if (v == 0) {
      while (run >= 11) { int take = run < 138 ? run : 138;
        ops.push_back({18, 7, (uint16_t)(take - 11)}); run -= take; }
      if (run >= 3) { ops.push_back({17, 3, (uint16_t)(run - 3)}); run = 0; }
      for (; run > 0; run--) ops.push_back({0, 0, 0});
    } else {
      ops.push_back({v, 0, 0});
      run--;
      while (run >= 3) { int take = run < 6 ? run : 6;
        ops.push_back({16, 2, (uint16_t)(take - 3)}); run -= take; }
      for (; run > 0; run--) ops.push_back({v, 0, 0});
    }
    i += total;
  }
}

static void d_emit_frame(const uint8_t* buf, size_t start, size_t end,
                         Matcher& mt, std::vector<uint8_t>& out) {
  std::vector<DTok> toks;
  toks.reserve((end - start) / 3 + 16);
  d_tokenize(buf, start, end, mt, toks);

  uint32_t lfreq[288] = {0}, dfreq[30] = {0};
  lfreq[256] = 1;
  for (const DTok& t : toks) {
    if (t.kind == 0) lfreq[t.lit]++;
    else { lfreq[257 + d_len_code(t.len)]++; dfreq[d_dist_code(t.dist)]++; }
  }
  uint8_t dyn_lit[288], dyn_dist[30];
  make_lengths(lfreq, 288, 15, dyn_lit);
  make_lengths(dfreq, 30, 15, dyn_dist);
  int nlit = 288; while (nlit > 257 && dyn_lit[nlit - 1] == 0) nlit--;
  int ndist = 30; while (ndist > 1 && dyn_dist[ndist - 1] == 0) ndist--;
  uint8_t all_lens[318];
  memcpy(all_lens, dyn_lit, nlit);
  memcpy(all_lens + nlit, dyn_dist, ndist);
  std::vector<DClOp> ops;
  d_cl_ops(all_lens, nlit + ndist, ops);
  uint32_t clfreq[19] = {0};
  for (const DClOp& o : ops) clfreq[o.sym]++;
  uint8_t cl_lens[19];
  make_lengths(clfreq, 19, 7, cl_lens);
  int ncl = 19;
  while (ncl > 4 && cl_lens[kDClOrder[ncl - 1]] == 0) ncl--;

  static uint8_t fix_lit[288], fix_dist[30];
  static bool fix_init = false;
  if (!fix_init) {
    for (int i = 0; i < 144; i++) fix_lit[i] = 8;
    for (int i = 144; i < 256; i++) fix_lit[i] = 9;
    for (int i = 256; i < 280; i++) fix_lit[i] = 7;
    for (int i = 280; i < 288; i++) fix_lit[i] = 8;
    for (int i = 0; i < 30; i++) fix_dist[i] = 5;
    fix_init = true;
  }

  auto body_cost = [&](const uint8_t* ll, const uint8_t* dl) -> int64_t {
    int64_t c = ll[256];
    for (const DTok& t : toks) {
      if (t.kind == 0) {
        if (!ll[t.lit]) return 1ll << 40;
        c += ll[t.lit];
      } else {
        int lc = d_len_code(t.len), dc = d_dist_code(t.dist);
        if (!ll[257 + lc] || !dl[dc]) return 1ll << 40;
        c += ll[257 + lc] + kDLenExtra[lc] + dl[dc] + kDDistExtra[dc];
      }
    }
    return c;
  };
  int64_t hdr = 5 + 5 + 4 + 3 * ncl;
  for (const DClOp& o : ops) hdr += cl_lens[o.sym] + o.nextra;
  int64_t dyn_cost = 3 + hdr + body_cost(dyn_lit, dyn_dist);
  int64_t fix_cost = 3 + body_cost(fix_lit, fix_dist);
  int64_t sto_cost = 3 + 5 + 32 + 8 * (int64_t)(end - start);

  LsbOut w(out);
  if (sto_cost < dyn_cost && sto_cost < fix_cost) {
    w.put(1, 1); w.put(0, 2);
    if (w.cnt) w.put(0, 8 - w.cnt);
    uint32_t n = (uint32_t)(end - start);
    w.put(n, 16); w.put(n ^ 0xFFFF, 16);
    w.flush();
    out.insert(out.end(), buf + start, buf + end);
    return;
  }
  uint16_t lcodes[288], dcodes[30];
  const uint8_t *ll, *dl;
  if (fix_cost <= dyn_cost) {
    w.put(1, 1); w.put(1, 2);
    ll = fix_lit; dl = fix_dist;
  } else {
    w.put(1, 1); w.put(2, 2);
    w.put(nlit - 257, 5); w.put(ndist - 1, 5); w.put(ncl - 4, 4);
    for (int k = 0; k < ncl; k++) w.put(cl_lens[kDClOrder[k]], 3);
    uint16_t clcodes[19];
    d_canonical(cl_lens, 19, clcodes);
    for (const DClOp& o : ops) {
      w.code(clcodes[o.sym], cl_lens[o.sym]);
      if (o.nextra) w.put(o.extra, o.nextra);
    }
    ll = dyn_lit; dl = dyn_dist;
  }
  d_canonical(ll, 288, lcodes);
  d_canonical(dl, 30, dcodes);
  for (const DTok& t : toks) {
    if (t.kind == 0) w.code(lcodes[t.lit], ll[t.lit]);
    else {
      int lc = d_len_code(t.len);
      w.code(lcodes[257 + lc], ll[257 + lc]);
      if (kDLenExtra[lc]) w.put(t.len - kDLenBase[lc], kDLenExtra[lc]);
      int dc = d_dist_code(t.dist);
      w.code(dcodes[dc], dl[dc]);
      if (kDDistExtra[dc]) w.put(t.dist - kDDistBase[dc], kDDistExtra[dc]);
    }
  }
  w.code(lcodes[256], ll[256]);
  w.flush();
}

}  // namespace lzxe (deflate section)

extern "C" {


// Encode one Quantum stream (CAB folder): one payload per 32 KiB frame
// (= one CFDATA block; the CAB reader injects the 0xFF realign trailer,
// cabd.c:1327-1332). frame_offs gets n_frames+1 byte offsets into out.
// Returns the frame count, or <0 on error.
int64_t msp_qtm_encode(const uint8_t* data, uint64_t len, int window_bits,
                       int max_chain, uint8_t* out, uint64_t out_cap,
                       int64_t* frame_offs) {
  if (window_bits < 10 || window_bits > 21) return -2;
  if (len >= (1ull << 31)) return -3;
  qtm::Encoder enc;
  enc.init(window_bits);
  uint32_t wsize = enc.wsize;
  lzxe::Matcher mat(data, (size_t)len, max_chain > 0 ? max_chain : 64,
                    wsize);
  constexpr uint32_t kMaxMatch = 259;   // len_base[26]=254 (+5)

  size_t pos = 0;
  uint64_t outn = 0;
  int64_t nf = 0;
  frame_offs[0] = 0;
  while (pos < len) {
    size_t fend = pos + qtm::kFrame;
    if (fend > len) fend = len;
    qtm::FrameCoder fc;
    while (pos < fend) {
      uint32_t cap = (uint32_t)(fend - pos);
      if (cap > kMaxMatch) cap = kMaxMatch;
      uint32_t best_len = 0, best_dist = 0;
      if (pos + 2 < len && cap >= 3) {
        int32_t cand = mat.head[lzxe::Matcher::h3(data + pos)];
        int chain = mat.max_chain;
        while (cand >= 0 && chain-- > 0) {
          uint64_t dist = pos - (size_t)cand;
          if (dist > wsize) break;       // ring holds last 2^wb bytes
          uint32_t l = 0;
          const uint8_t* a = data + cand;
          const uint8_t* b = data + pos;
          while (l < cap && a[l] == b[l]) l++;
          if (l > best_len) {
            best_len = l;
            best_dist = (uint32_t)dist;
            if (l >= cap) break;
          }
          cand = mat.prev[(uint32_t)cand & mat.mask];
        }
      }
      if (best_len >= 3 && enc.encode_match(fc, best_len, best_dist)) {
        for (uint32_t k = 0; k < best_len; k++) mat.insert(pos + k);
        pos += best_len;
      } else {
        enc.encode_literal(fc, data[pos]);
        mat.insert(pos);
        pos++;
      }
    }
    int64_t nb = fc.finish(out + outn, out_cap - outn);
    if (nb < 0) return -1;
    outn += (uint64_t)nb;
    frame_offs[++nf] = (int64_t)outn;
  }
  return nf;
}

// Entropy-encode one LZX stream. Writes the stream to `out` and the
// per-frame byte offsets to `frame_offs` (caller sizes it to the frame
// count). Returns the stream length, or -1 if out_cap is too small.
int64_t msp_lzx_encode(const uint8_t* data, uint64_t len, int window_bits,
                       int reset_interval, int is_delta, const uint8_t* ref,
                       uint64_t ref_len, int max_chain, int block_frames,
                       uint8_t* out, uint64_t out_cap,
                       uint64_t* frame_offs) {
  int lo = is_delta ? 17 : 15, hi = is_delta ? 25 : 21;
  if (window_bits < lo || window_bits > hi) return -2;
  if (len + ref_len >= (1ull << 31)) return -3;  // int32 match positions
  lzxe::Encoder enc(window_bits, reset_interval, is_delta != 0,
                    max_chain > 0 ? max_chain : 64);
  std::vector<uint64_t> offs;
  std::vector<uint8_t> stream =
      enc.compress(data, len, ref, ref_len, offs, block_frames);
  if (stream.size() > out_cap) return -1;
  memcpy(out, stream.data(), stream.size());
  for (size_t i = 0; i < offs.size(); i++) frame_offs[i] = offs[i];
  return (int64_t)stream.size();
}


// Whole-cabinet decode (see cabpipe above): CFDATA walk + checksum +
// per-folder codec decode, folder-parallel with no phase barrier.
// comp_types[f] is the raw CFFOLDER value (low byte codec 0/1/2/3,
// high bits window size for LZX/Quantum). `stage` is a caller-owned
// warm arena (>= total compressed size; cab_len always suffices) used
// to make LZX/Quantum inputs contiguous. Returns 0, or an error code
// telling the caller to fall back to the exact-semantics driver.

// DEFLATE/MSZIP frames: each 32 KiB chunk one final deflate block,
// cross-frame history when hist != 0. offsets gets n_frames+1 byte
// offsets into out (each frame "CK"-prefixed). Returns n_frames, or
// -1 if out_cap would overflow.
int64_t msp_deflate_frames(const uint8_t* data, int64_t n, int hist,
                           uint8_t* out, int64_t out_cap,
                           int64_t* offsets) {
  const int64_t FRAME = 32768;
  std::vector<uint8_t> buf;
  int64_t nf = 0;
  int64_t pos_out = 0;
  lzxe::Matcher mt(data, (size_t)n, 128, 1u << 16);
  for (int64_t i = 0; i < n; i += FRAME, nf++) {
    int64_t end = i + FRAME < n ? i + FRAME : n;
    offsets[nf] = pos_out;
    buf.clear();
    buf.push_back('C');
    buf.push_back('K');
    if (!hist) {
      lzxe::Matcher fresh(data + i, (size_t)(end - i), 128, 1u << 16);
      lzxe::d_emit_frame(data + i, 0, (size_t)(end - i), fresh, buf);
    } else {
      // matcher persists; entries older than 32 KiB are distance-
      // rejected in d_tokenize
      lzxe::d_emit_frame(data, (size_t)i, (size_t)end, mt, buf);
    }
    if (pos_out + (int64_t)buf.size() > out_cap) return -1;
    memcpy(out + pos_out, buf.data(), buf.size());
    pos_out += (int64_t)buf.size();
  }
  offsets[nf] = pos_out;
  return nf;
}

}  // extern "C"
