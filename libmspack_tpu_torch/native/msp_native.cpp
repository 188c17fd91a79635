// Native host runtime for libmspack_tpu: multithreaded codec engine.
//
// The TPU owns the MXU/VPU-friendly passes (CRC, checksums, E8, batch
// transforms, device-resident delivery); entropy decoding is a scalar /
// random-access workload, so the framework's host runtime does it in
// C++ with a thread pool — the reference library is strictly
// single-threaded (libmspack mspack.h threading notes), which is the
// baseline this engine is designed to beat.
//
// Architecture (two-phase, mirroring the device pipeline):
//   phase A: per-frame DEFLATE tokenisation (independent -> threaded)
//   phase B: per-folder sequential token resolution at memcpy speed
//            (MSZIP history crosses frames through the 32 KiB window,
//            so resolution is ordered within a folder; folders thread)
//
// Exposed as a flat C ABI consumed via ctypes (no pybind11 in image).
//
// The port's copy of libmspack_tpu/native/msp_native.cpp, with the entry
// points that no Python wrapper calls left out (the many-stream LZX
// encode batch, the tokenize-only MSZIP pass, msp_version); built by g++ into
// libmspack_tpu_torch/_build/. msp_mszip_folders, the many-folder MSZIP
// decode the corpus planner calls, is libmspack_tpu/native/
// msp_native.cpp:2226-2278.

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

constexpr int kFrameSize = 32768;

// ---------------------------------------------------------------- bits
struct BitIn {
  const uint8_t* p;
  const uint8_t* end;
  uint64_t buf = 0;
  int n = 0;
  int64_t virtual_zeros = 0;  // bits consumed past the end

  const uint8_t* end8;  // last position where an 8-byte load is safe

  explicit BitIn(const uint8_t* data, size_t len)
      : p(data), end(data + len), end8(len >= 8 ? data + len - 8 : data - 1) {}

  inline void fill() {
    if (p <= end8) {
      // branch-free style refill: one unaligned 64-bit load tops the
      // buffer up to >= 56 bits
      uint64_t w;
      memcpy(&w, p, 8);
      buf |= w << n;
      p += (63 - n) >> 3;
      n |= 56;
      return;
    }
    while (n <= 56) {
      if (p < end) {
        buf |= (uint64_t)(*p++) << n;
        n += 8;
      } else {
        virtual_zeros += 64 - n;
        n = 64;  // implicit zero bytes; consumption tracked
        break;
      }
    }
  }
  inline uint32_t peek(int k) { return (uint32_t)(buf & ((1u << k) - 1)); }
  inline void drop(int k) { buf >>= k; n -= k; }
  inline uint32_t get(int k) {
    if (n < k) fill();
    uint32_t v = peek(k);
    drop(k);
    return v;
  }
  // consumed bits beyond the stream end (reference allows 16: the two
  // fake zero bytes of readbits.h read_input)
  inline bool overran(const uint8_t* start, size_t len) const {
    int64_t filled = (int64_t)(p - start) * 8 + virtual_zeros;
    int64_t consumed = filled - n;
    return consumed > (int64_t)len * 8 + 16;
  }
};

// ------------------------------------------------------------- huffman
// Two-level decode table: 10-bit root; long codes chain to subtables.
// Entry layout: sym(16) | len(8) | is_sub(1); for is_sub entries the
// sym field is the subtable offset and len the subtable bit width.
struct Huff {
  std::vector<uint32_t> tab;
  int root_bits = 10;
  bool ok = false;

  static constexpr uint32_t kSub = 1u << 24;

  bool build(const uint8_t* lens, int nsyms) {
    tab.assign(1u << root_bits, 0xFFFFFFFFu);
    int count[16] = {0};
    for (int s = 0; s < nsyms; s++) count[lens[s]]++;
    count[0] = 0;
    uint32_t code = 0;
    uint32_t next_code[16] = {0};
    int64_t kraft = 0;
    for (int b = 1; b <= 15; b++) {
      code = (code + count[b - 1]) << 1;
      next_code[b] = code;
      kraft += (int64_t)count[b] << (15 - b);
    }
    if (kraft > (1 << 15)) return ok = false;  // over-subscribed

    // assign codes; fill root + subtables
    for (int s = 0; s < nsyms; s++) {
      int L = lens[s];
      if (!L) continue;
      uint32_t c = next_code[L]++;
      // bit-reverse the L-bit code (stream is LSB-first)
      uint32_t r = 0;
      for (int i = 0; i < L; i++) r |= ((c >> i) & 1u) << (L - 1 - i);
      if (L <= root_bits) {
        uint32_t entry = (uint32_t)s | ((uint32_t)L << 16);
        for (uint32_t i = r; i < tab.size() && i < (1u << root_bits);
             i += (1u << L))
          tab[i] = entry;
      } else {
        uint32_t rootIdx = r & ((1u << root_bits) - 1);
        int extra = L - root_bits;
        // allocate / locate subtable covering 5 extra bits (max 15-10)
        uint32_t subBase;
        if (tab[rootIdx] == 0xFFFFFFFFu || !(tab[rootIdx] & kSub)) {
          subBase = (uint32_t)tab.size();
          tab.resize(tab.size() + 32, 0xFFFFFFFFu);
          tab[rootIdx] = kSub | subBase;
        } else {
          subBase = tab[rootIdx] & 0xFFFFFFu;
        }
        uint32_t hi = r >> root_bits;  // extra bits (LSB-first), < 32
        uint32_t entry = (uint32_t)s | ((uint32_t)L << 16);
        for (uint32_t i = hi; i < 32; i += (1u << extra))
          tab[subBase + i] = entry;
      }
    }
    return ok = true;
  }

  // decode one symbol; returns sym or -1
  inline int decode(BitIn& b) const {
    if (b.n < 15) b.fill();
    uint32_t e = tab[b.peek(root_bits)];
    if (e == 0xFFFFFFFFu) return -1;
    if (e & kSub) {
      uint32_t sub = e & 0xFFFFFFu;
      e = tab[sub + ((b.buf >> root_bits) & 31)];
      if (e == 0xFFFFFFFFu) return -1;
    }
    b.drop((e >> 16) & 0xFF);
    return (int)(e & 0xFFFF);
  }
};

// --------------------------------------------------------- deflate A
static const uint16_t kLitBase[29] = {3, 4, 5, 6, 7, 8, 9, 10, 11, 13,
                                      15, 17, 19, 23, 27, 31, 35, 43, 51,
                                      59, 67, 83, 99, 115, 131, 163, 195,
                                      227, 258};
static const uint8_t kLitExtra[29] = {0, 0, 0, 0, 0, 0, 0, 0, 1, 1,
                                      1, 1, 2, 2, 2, 2, 3, 3, 3, 3,
                                      4, 4, 4, 4, 5, 5, 5, 5, 0};
static const uint16_t kDistBase[30] = {1, 2, 3, 4, 5, 7, 9, 13, 17, 25,
                                       33, 49, 65, 97, 129, 193, 257, 385,
                                       513, 769, 1025, 1537, 2049, 3073,
                                       4097, 6145, 8193, 12289, 16385, 24577};
static const uint8_t kDistExtra[30] = {0, 0, 0, 0, 1, 1, 2, 2, 3, 3,
                                       4, 4, 5, 5, 6, 6, 7, 7, 8, 8,
                                       9, 9, 10, 10, 11, 11, 12, 12, 13, 13};
static const uint8_t kBitlenOrder[19] = {16, 17, 18, 0, 8, 7, 9, 6, 10, 5,
                                         11, 4, 12, 3, 13, 2, 14, 1, 15};

// Tokenised frame: literal bytes packed densely + command stream.
// command u32: lo16 = length; hi16 = distance (0 => literal run).
struct FrameTokens {
  std::vector<uint8_t> lits;
  std::vector<uint32_t> cmds;
  uint32_t out_len = 0;
  int err = 0;  // 0 ok
};

// Tokenise one complete MSZIP frame (a standalone deflate stream).
static void tokenize_frame(const uint8_t* data, size_t len, FrameTokens* ft) {
  BitIn b(data, len);
  ft->out_len = 0;
  ft->err = 0;
  ft->lits.resize(kFrameSize);      // a frame emits at most 32768 bytes
  ft->cmds.reserve(4096);
  uint8_t* litp = ft->lits.data();
  uint8_t* lit_end = litp + kFrameSize;
  uint32_t pending_lits = 0;
  auto flush_lits = [&]() {
    while (pending_lits) {
      uint32_t run = pending_lits > 0xFFFF ? 0xFFFF : pending_lits;
      ft->cmds.push_back(run);
      pending_lits -= run;
    }
  };

  for (;;) {
    uint32_t last = b.get(1);
    uint32_t type = b.get(2);
    if (type == 0) {
      // stored block
      int align = b.n & 7;
      b.drop(align);
      uint32_t l = b.get(16);
      uint32_t nl = b.get(16);
      if (l != ((~nl) & 0xFFFF)) { ft->err = 2; return; }
      if (litp + l > lit_end) { ft->err = 12; return; }
      for (uint32_t i = 0; i < l; i++) *litp++ = (uint8_t)b.get(8);
      pending_lits += l;
      ft->out_len += l;
    } else if (type == 1 || type == 2) {
      Huff lit, dist;
      if (type == 1) {
        uint8_t ll[288], dl[32];
        int i = 0;
        for (; i < 144; i++) ll[i] = 8;
        for (; i < 256; i++) ll[i] = 9;
        for (; i < 280; i++) ll[i] = 7;
        for (; i < 288; i++) ll[i] = 8;
        for (i = 0; i < 32; i++) dl[i] = 5;
        if (!lit.build(ll, 288) || !dist.build(dl, 32)) { ft->err = 3; return; }
      } else {
        uint32_t nlit = b.get(5) + 257;
        uint32_t ndist = b.get(5) + 1;
        uint32_t nbl = b.get(4) + 4;
        if (nlit > 288 || ndist > 32) { ft->err = 4; return; }
        uint8_t bl[19] = {0};
        for (uint32_t i = 0; i < nbl; i++) bl[kBitlenOrder[i]] = (uint8_t)b.get(3);
        Huff blh;
        if (!blh.build(bl, 19)) { ft->err = 5; return; }
        uint8_t lens[320] = {0};
        uint32_t total = nlit + ndist;
        uint32_t i = 0;
        uint8_t prev = 0;
        while (i < total) {
          int c = blh.decode(b);
          if (c < 0) { ft->err = 6; return; }
          if (c < 16) { lens[i++] = prev = (uint8_t)c; continue; }
          uint32_t run, fill = 0;
          if (c == 16) { run = b.get(2) + 3; fill = prev; }
          else if (c == 17) { run = b.get(3) + 3; }
          else { run = b.get(7) + 11; }
          if (i + run > total) { ft->err = 7; return; }
          while (run--) lens[i++] = (uint8_t)fill;
        }
        if (!lit.build(lens, nlit) || !dist.build(lens + nlit, ndist)) {
          ft->err = 8; return;
        }
      }
      for (;;) {
        int s = lit.decode(b);
        if (s < 0) { ft->err = 9; return; }
        if (s < 256) {
          if (litp >= lit_end) { ft->err = 12; return; }
          *litp++ = (uint8_t)s;
          pending_lits++;
          ft->out_len++;
        } else if (s == 256) {
          break;
        } else {
          s -= 257;
          if (s >= 29) { ft->err = 10; return; }
          uint32_t l = kLitBase[s] + b.get(kLitExtra[s]);
          int d = dist.decode(b);
          if (d < 0 || d >= 30) { ft->err = 11; return; }
          uint32_t dd = kDistBase[d] + b.get(kDistExtra[d]);
          flush_lits();
          ft->cmds.push_back(l | (dd << 16));
          ft->out_len += l;
        }
        if (ft->out_len > (uint32_t)kFrameSize) { ft->err = 12; return; }
      }
    } else {
      ft->err = 1;
      return;
    }
    if (last) break;
  }
  flush_lits();
  ft->lits.resize((size_t)(litp - ft->lits.data()));
  if (b.overran(data, len)) ft->err = 13;
}

// --------------------------------------------------------- phase B
// Apply a folder's token streams into `out`; matches may reach back
// across frame boundaries (dist <= 32768 into earlier output).
static int resolve_folder(const FrameTokens* frames, int n_frames,
                          uint8_t* out, size_t out_cap) {
  size_t pos = 0;
  for (int fi = 0; fi < n_frames; fi++) {
    const FrameTokens& ft = frames[fi];
    if (ft.err) return ft.err;
    const uint8_t* lit = ft.lits.data();
    for (uint32_t cmd : ft.cmds) {
      uint32_t l = cmd & 0xFFFF;
      uint32_t d = cmd >> 16;
      if (pos + l > out_cap) return 20;
      if (d == 0) {
        memcpy(out + pos, lit, l);
        lit += l;
        pos += l;
      } else {
        if (d > pos) return 21;
        const uint8_t* src = out + pos - d;
        uint8_t* dst = out + pos;
        if (d >= l) {
          memcpy(dst, src, l);
        } else if (d >= 8) {
          size_t done = 0;
          while (done < l) {
            size_t chunk = d < (l - done) ? d : (l - done);
            memcpy(dst + done, src + done, chunk);
            done += chunk;
          }
        } else {
          for (uint32_t i = 0; i < l; i++) dst[i] = src[i];
        }
        pos += l;
      }
    }
  }
  return 0;
}

struct FolderJob {
  const uint8_t* const* frames;
  const uint64_t* frame_lens;
  const uint32_t* sizes;
  int n_frames;
  uint8_t* out;
  uint64_t out_cap;
  int result = -1;
};

}  // namespace

// ================================================================= LZX
// Sequential LZX / LZX DELTA decoder (reference semantics: lzxd.c via
// codecs/lzx.py). Decodes a whole stream into a flat output buffer;
// parallelism comes from decoding many streams (folders / CHM reset
// chunks) across the thread pool.

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

// MSB bitstream over 16-bit little-endian units.
struct MsbBits {
  const uint8_t* p;
  const uint8_t* end;
  uint64_t buf = 0;  // top `n` bits valid
  int n = 0;
  int64_t fake = 0;

  MsbBits(const uint8_t* d, size_t len) : p(d), end(d + len) {}

  inline void fill() {
    while (n <= 48) {
      uint32_t unit;
      if (p + 1 < end) {
        unit = (uint32_t)p[0] | ((uint32_t)p[1] << 8);
        p += 2;
      } else if (p < end) {
        unit = (uint32_t)p[0];  // final odd byte + fake zero high byte
        p += 1;
        fake += 8;
      } else {
        unit = 0;
        fake += 16;
      }
      buf |= (uint64_t)unit << (48 - n);
      n += 16;
    }
  }
  inline uint32_t peek(int k) { return (uint32_t)(buf >> (64 - k)); }
  inline void drop(int k) { buf <<= k; n -= k; }
  inline uint32_t get(int k) {
    if (n < k) fill();
    uint32_t v = peek(k);
    drop(k);
    return v;
  }
  inline void align16() {
    if (n > 0) fill();
    if (n & 15) drop(n & 15);
  }
  // byte-aligned raw read for uncompressed blocks; bit buffer must be
  // conceptually byte-synchronised by the caller
  inline int raw(uint8_t* dst, int want) {
    int got = 0;
    while (got < want && p < end) dst[got++] = *p++;
    return got;
  }
};

// MSB canonical huffman, root 11 bits + subtables (codes <= 16 bits).
struct HuffM {
  std::vector<uint32_t> tab;
  static constexpr int kRoot = 11;
  static constexpr uint32_t kSub = 1u << 28;
  bool empty = false;

  // returns false on invalid table (caller decides empty-tree policy)
  bool build(const uint8_t* lens, int nsyms) {
    tab.assign(1u << kRoot, 0xFFFFFFFFu);
    int count[17] = {0};
    // lengths outside 1..16 are treated as absent, exactly like
    // make_decode_table (readhuff.h loops bit_num 1..16): malformed
    // streams can leave e.g. 254 via the run-19 negative wrap
    for (int s = 0; s < nsyms; s++)
      if (lens[s] <= 16) count[lens[s]]++;
    count[0] = 0;
    int64_t kraft = 0;
    uint32_t next_code[18] = {0};
    uint32_t code = 0;
    for (int b = 1; b <= 16; b++) {
      code = (code + count[b - 1]) << 1;
      next_code[b] = code;
      kraft += (int64_t)count[b] << (16 - b);
    }
    if (kraft > (1 << 16)) return false;  // over-subscribed
    bool any = false;
    for (int s = 0; s < nsyms; s++) {
      int L = lens[s];
      if (!L || L > 16) continue;
      any = true;
      uint32_t c = next_code[L]++;
      if (L <= kRoot) {
        // left-justify to kRoot bits
        uint32_t base = c << (kRoot - L);
        uint32_t entry = (uint32_t)s | ((uint32_t)L << 20);
        for (uint32_t i = 0; i < (1u << (kRoot - L)); i++)
          tab[base + i] = entry;
      } else {
        uint32_t rootIdx = c >> (L - kRoot);
        uint32_t subBase;
        if (tab[rootIdx] == 0xFFFFFFFFu || !(tab[rootIdx] & kSub)) {
          subBase = (uint32_t)tab.size();
          tab.resize(tab.size() + 32, 0xFFFFFFFFu);
          tab[rootIdx] = kSub | subBase;
        } else {
          subBase = tab[rootIdx] & 0xFFFFFFFu;
        }
        int extra = L - kRoot;  // 1..5
        uint32_t lo = c & ((1u << extra) - 1);
        uint32_t base = lo << (5 - extra);
        uint32_t entry = (uint32_t)s | ((uint32_t)L << 20);
        for (uint32_t i = 0; i < (1u << (5 - extra)); i++)
          tab[subBase + base + i] = entry;
      }
    }
    if (kraft < (1 << 16)) return false;  // under-subscribed (incomplete)
    (void)any;
    return true;
  }

  inline int decode(MsbBits& b) const {
    if (b.n < 16) b.fill();
    uint32_t e = tab[b.peek(kRoot)];
    if (e == 0xFFFFFFFFu) return -1;
    if (e & kSub) {
      uint32_t sub = e & 0xFFFFFFFu;
      uint32_t lo = (uint32_t)((b.buf << kRoot) >> (64 - 5));
      e = tab[sub + lo];
      if (e == 0xFFFFFFFFu) return -1;
    }
    b.drop((int)((e >> 20) & 0x1F));
    return (int)(e & 0xFFFFF);
  }
};

struct Decoder {
  int window_bits;
  uint32_t window_size;
  int reset_interval;
  int64_t output_length;
  bool is_delta;
  const uint8_t* ref_data;
  uint32_t ref_len;

  uint8_t maintree_len[kMaxMainSyms + 64] = {0};
  uint8_t length_len[kLengthSyms + 64] = {0};
  uint8_t pretree_len[kPretreeSyms + 64] = {0};
  uint8_t aligned_len[kAlignedSyms + 64] = {0};
  HuffM maintree, lengtht, pretree, aligned;
  bool length_empty = false;

  uint32_t R0 = 1, R1 = 1, R2 = 1;
  bool header_read = false;
  int block_type = 0;
  uint32_t block_remaining = 0, block_length = 0;
  int32_t intel_filesize = 0;
  bool intel_started = false;
  int num_offsets;
  // E8 bookkeeping: the reference untransforms each frame into a
  // SEPARATE buffer (lzxd.c:706-733 copies window->e8_buf), so match
  // sources always see PRE-transform bytes. This flat-buffer decoder
  // (where `out` doubles as the match window) therefore defers E8 to
  // one exact post-pass over the finished output (apply_e8), replaying
  // the per-reset-interval intel_filesize values and the frame at
  // which intel_started first fired.
  int64_t e8_base = 0;          // absolute output offset of stream start
  bool e8_defer = false;        // caller applies E8 itself (chunk grids)
  int64_t first_e8_frame = -1;  // local frame where intel_started fired
  std::vector<std::pair<int64_t, int32_t>> ifsz_log;  // (frame, filesize)

  void reset_state() {
    R0 = R1 = R2 = 1;
    header_read = false;
    block_remaining = 0;
    block_type = 0;
    memset(maintree_len, 0, sizeof(maintree_len));
    memset(length_len, 0, sizeof(length_len));
  }

  // returns 0 ok
  int read_lens(MsbBits& b, uint8_t* lens, int first, int last) {
    for (int x = 0; x < kPretreeSyms; x++)
      pretree_len[x] = (uint8_t)b.get(4);
    if (!pretree.build(pretree_len, kPretreeSyms)) return 31;
    int x = first;
    while (x < last) {
      int z = pretree.decode(b);
      if (z < 0) return 32;
      if (z == 17) {
        int y = (int)b.get(4) + 4;
        while (y--) lens[x++] = 0;
      } else if (z == 18) {
        int y = (int)b.get(5) + 20;
        while (y--) lens[x++] = 0;
      } else if (z == 19) {
        int y = (int)b.get(1) + 4;
        int zz = pretree.decode(b);
        if (zz < 0) return 33;
        int v = lens[x] - zz;
        if (v < 0) v += 17;
        while (y--) lens[x++] = (uint8_t)v;
      } else {
        int v = lens[x] - z;
        if (v < 0) v += 17;
        lens[x++] = (uint8_t)v;
      }
    }
    return 0;
  }

  // decode `todo` bytes into out (flat buffer); out_pos = already decoded
  int run(MsbBits& b, uint8_t* out, int64_t todo) {
    int64_t pos = 0;        // bytes produced
    int64_t frame = 0;
    while (pos < todo) {
      if (reset_interval && (frame % reset_interval) == 0) {
        reset_state();
      }
      if (is_delta) {
        if (b.n < 16) b.fill();
        b.drop(16);
      }
      if (!header_read) {
        uint32_t i = b.get(1), j = 0, k = 0;
        if (i) { j = b.get(16); k = b.get(16); }
        intel_filesize = (int32_t)((j << 16) | k);
        header_read = true;
        ifsz_log.emplace_back(frame, intel_filesize);
      }
      int64_t frame_size = kFrame;
      if (output_length && output_length - pos < frame_size)
        frame_size = output_length - pos;
      if (frame_size > todo - pos) {
        // caller wants less than a frame; decode the full frame anyway
        // is not needed here because todo == output_length in this API
        frame_size = todo - pos;
      }

      int64_t frame_end = pos + frame_size;
      while (pos < frame_end) {
        if (block_remaining == 0) {
          if (block_type == 3 && (block_length & 1) && b.p < b.end) b.p++;
          block_type = (int)b.get(3);
          uint32_t i = b.get(16), j = b.get(8);
          block_remaining = block_length = (i << 8) | j;
          if (block_type == 2) {
            for (int k = 0; k < 8; k++) aligned_len[k] = (uint8_t)b.get(3);
            if (!aligned.build(aligned_len, kAlignedSyms)) return 34;
          }
          if (block_type == 1 || block_type == 2) {
            int r;
            if ((r = read_lens(b, maintree_len, 0, 256))) return r;
            if ((r = read_lens(b, maintree_len, 256, 256 + num_offsets)))
              return r;
            if (!maintree.build(maintree_len, kMaxMainSyms)) return 35;
            if (maintree_len[0xE8] && !intel_started) {
              intel_started = true;
              first_e8_frame = frame;
            }
            if ((r = read_lens(b, length_len, 0, 249))) return r;
            length_empty = !lengtht.build(length_len, kLengthSyms);
            if (length_empty) {
              for (int k = 0; k < kLengthSyms; k++)
                if (length_len[k]) return 36;  // invalid, not just empty
            }
          } else if (block_type == 3) {
            if (!intel_started) {
              intel_started = true;
              first_e8_frame = frame;
            }
            if (b.n == 0) b.fill();
            b.n = 0;
            b.buf = 0;
            uint8_t hdr[12];
            if (b.raw(hdr, 12) != 12) return 37;
            R0 = (uint32_t)hdr[0] | ((uint32_t)hdr[1] << 8) |
                 ((uint32_t)hdr[2] << 16) | ((uint32_t)hdr[3] << 24);
            R1 = (uint32_t)hdr[4] | ((uint32_t)hdr[5] << 8) |
                 ((uint32_t)hdr[6] << 16) | ((uint32_t)hdr[7] << 24);
            R2 = (uint32_t)hdr[8] | ((uint32_t)hdr[9] << 8) |
                 ((uint32_t)hdr[10] << 16) | ((uint32_t)hdr[11] << 24);
          } else {
            return 38;
          }
        }
        int64_t this_run = block_remaining;
        if (this_run > frame_end - pos) this_run = frame_end - pos;
        block_remaining -= (uint32_t)this_run;
        int64_t run_end = pos + this_run;

        if (block_type == 1 || block_type == 2) {
          bool al = block_type == 2;
          while (pos < run_end) {
            int sym = maintree.decode(b);
            if (sym < 0) return 39;
            if (sym < kNumChars) {
              out[pos++] = (uint8_t)sym;
              continue;
            }
            sym -= kNumChars;
            uint32_t match_len = sym & 7;
            if (match_len == 7) {
              if (length_empty) return 40;
              int lf = lengtht.decode(b);
              if (lf < 0) return 41;
              match_len += (uint32_t)lf;
            }
            match_len += 2;
            uint32_t slot = (uint32_t)sym >> 3;
            uint32_t offset;
            if (slot == 0) offset = R0;
            else if (slot == 1) { offset = R1; R1 = R0; R0 = offset; }
            else if (slot == 2) { offset = R2; R2 = R0; R0 = offset; }
            else {
              int extra = slot >= 36 ? 17 : kT.extra_bits[slot];
              offset = kT.pos_base[slot] - 2;
              if (extra >= 3 && al) {
                if (extra > 3) offset += b.get(extra - 3) << 3;
                int ab = aligned.decode(b);
                if (ab < 0) return 42;
                offset += (uint32_t)ab;
              } else if (extra) {
                offset += b.get(extra);
              }
              R2 = R1; R1 = R0; R0 = offset;
            }
            if (match_len == 257 && is_delta) {
              if (b.n < 3) b.fill();
              uint32_t e;
              if (b.peek(1) == 0) { b.drop(1); e = b.get(8); }
              else if (b.peek(2) == 2) { b.drop(2); e = b.get(10) + 0x100; }
              else if (b.peek(3) == 6) { b.drop(3); e = b.get(12) + 0x500; }
              else { b.drop(3); e = b.get(15); }
              match_len += e;
            }
            if (offset > window_size) return 43;
            int64_t src = pos - (int64_t)offset;
            // matches may overrun the block run (handled below) but can
            // NEVER cross the frame boundary (lzxd.c frame-size check);
            // frame_end <= todo <= out_cap, so this also fences the
            // output buffer against malformed streams
            if (pos + match_len > frame_end) return 44;
            if (src < 0) {
              // LZX DELTA reference data at the window tail
              int64_t need = -src;
              if (need > (int64_t)ref_len) return 45;
              const uint8_t* rs = ref_data + (ref_len - need);
              uint32_t first = (uint32_t)(need < (int64_t)match_len
                                              ? need : (int64_t)match_len);
              for (uint32_t k = 0; k < first; k++) out[pos + k] = rs[k];
              for (uint32_t k = first; k < match_len; k++)
                out[pos + k] = out[k - first];
              pos += match_len;
            } else {
              uint8_t* dst = out + pos;
              const uint8_t* sp = out + src;
              if (offset >= match_len) {
                memcpy(dst, sp, match_len);
              } else if (offset >= 8) {
                uint32_t done = 0;
                while (done < match_len) {
                  uint32_t chunk = offset < match_len - done
                                       ? offset : match_len - done;
                  memcpy(dst + done, sp + done, chunk);
                  done += chunk;
                }
              } else {
                for (uint32_t k = 0; k < match_len; k++) dst[k] = sp[k];
              }
              pos += match_len;
            }
          }
        } else {  // uncompressed
          int64_t need = this_run;
          while (need > 0) {
            int got = b.raw(out + pos, (int)need);
            if (got <= 0) return 46;
            pos += got;
            need -= got;
          }
        }
        // overrun handling: a final match may exceed run_end
        if (pos > run_end) {
          int64_t over = pos - run_end;
          if ((uint64_t)over > block_remaining) return 47;
          block_remaining -= (uint32_t)over;
        }
      }
      if (pos - (frame * kFrame) > kFrame) {
        // keep frame accounting exact
      }
      b.align16();
      frame++;
    }
    if (!e8_defer) apply_e8(out, todo);
    return 0;
  }

  // Exact deferred E8 pass (see the field comment above): per 32 KiB
  // frame, with the per-reset-interval intel_filesize that was current
  // when the frame decoded, skipping frames before intel_started fired
  // (those can only contain 0xE8 bytes via DELTA reference data, which
  // the reference likewise leaves untransformed until started fires).
  void apply_e8(uint8_t* out, int64_t total) {
    if (!intel_started || first_e8_frame < 0) return;
    size_t li = 0;
    int32_t fsz = 0;
    for (int64_t f = 0, fstart = 0; fstart < total; f++, fstart += kFrame) {
      while (li < ifsz_log.size() && ifsz_log[li].first <= f)
        fsz = ifsz_log[li++].second;
      int64_t flen = total - fstart < kFrame ? total - fstart : kFrame;
      int64_t gframe = (e8_base >> 15) + f;
      if (f < first_e8_frame || !fsz || gframe >= 32768 || flen <= 10)
        continue;
      uint8_t* data = out + fstart;
      int64_t i = 0, dataend = flen - 10;
      int32_t curpos = (int32_t)(e8_base + fstart);
      while (i < dataend) {
        if (data[i] != 0xE8) { i++; curpos++; continue; }
        i++;
        int32_t abs_off = (int32_t)((uint32_t)data[i] |
                                    ((uint32_t)data[i + 1] << 8) |
                                    ((uint32_t)data[i + 2] << 16) |
                                    ((uint32_t)data[i + 3] << 24));
        if (abs_off >= -curpos && abs_off < fsz) {
          uint32_t rel = (uint32_t)(abs_off >= 0 ? abs_off - curpos
                                                 : abs_off + fsz);
          data[i] = (uint8_t)rel;
          data[i + 1] = (uint8_t)(rel >> 8);
          data[i + 2] = (uint8_t)(rel >> 16);
          data[i + 3] = (uint8_t)(rel >> 24);
        }
        i += 4;
        curpos += 5;
      }
    }
  }
};

}  // namespace lzx

// ============================================================== Quantum
// Sequential adaptive arithmetic decoder (reference semantics: qtmd.c
// via codecs/qtm.py). One stream per CAB folder; folders thread.

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

// MSB bitstream over 16-bit BIG-endian units (qtmd.c:30-35).
struct QBits {
  const uint8_t* p;
  const uint8_t* end;
  uint64_t buf = 0;
  int n = 0;

  QBits(const uint8_t* d, size_t len) : p(d), end(d + len) {}
  inline void fill() {
    while (n <= 48) {
      uint32_t unit;
      if (p + 1 < end) {
        unit = ((uint32_t)p[0] << 8) | (uint32_t)p[1];
        p += 2;
      } else if (p < end) {
        unit = (uint32_t)p[0] << 8;
        p += 1;
      } else {
        unit = 0;
      }
      buf |= (uint64_t)unit << (48 - n);
      n += 16;
    }
  }
  inline uint32_t get(int k) {
    if (k == 0) return 0;
    if (n < k) fill();
    uint32_t v = (uint32_t)(buf >> (64 - k));
    buf <<= k;
    n -= k;
    return v;
  }
};

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

struct Decoder {
  uint32_t window_size;
  Model m0, m1, m2, m3, m4, m5, m6, m6len, m7;
  uint16_t H = 0, L = 0, C = 0;
  bool header_read = false;

  void init(int window_bits) {
    window_size = 1u << window_bits;
    int i = window_bits * 2;
    m0.init(0, 64); m1.init(64, 64); m2.init(128, 64); m3.init(192, 64);
    m4.init(0, i > 24 ? 24 : i);
    m5.init(0, i > 36 ? 36 : i);
    m6.init(0, i);
    m6len.init(0, 27);
    m7.init(0, 7);
  }

  int get_symbol(QBits& b, Model& m) {
    uint32_t range = ((uint32_t)(uint16_t)(H - L) & 0xFFFF) + 1;
    uint32_t symf = ((((uint32_t)(uint16_t)(C - L) + 1) * m.cum[0] - 1)
                     / range) & 0xFFFF;
    int i = 1;
    while (i < m.entries && m.cum[i] > symf) i++;
    int s = m.sym[i - 1];

    range = (uint32_t)(H - L) + 1;
    uint32_t total = m.cum[0];
    H = (uint16_t)(L + (m.cum[i - 1] * range) / total - 1);
    L = (uint16_t)(L + (m.cum[i] * range) / total);

    for (int j = i - 1; j >= 0; j--) m.cum[j] = (uint16_t)(m.cum[j] + 8);
    if (m.cum[0] > 3800) m.update();

    for (;;) {
      if ((L & 0x8000) != (H & 0x8000)) {
        if ((L & 0x4000) && !(H & 0x4000)) {
          C ^= 0x4000; L &= 0x3FFF; H |= 0x4000;
        } else {
          break;
        }
      }
      L = (uint16_t)(L << 1);
      H = (uint16_t)((H << 1) | 1);
      C = (uint16_t)((C << 1) | b.get(1));
    }
    return s;
  }

  // decode out_len bytes into flat buffer
  int run(QBits& b, uint8_t* out, int64_t out_len) {
    int64_t pos = 0;
    int64_t frame_todo = kFrame;
    while (pos < out_len) {
      if (!header_read) {
        H = 0xFFFF; L = 0;
        C = (uint16_t)b.get(16);
        header_read = true;
      }
      int sel = get_symbol(b, m7);
      uint32_t match_len, match_off;
      if (sel < 4) {
        Model* mdl = sel == 0 ? &m0 : sel == 1 ? &m1 : sel == 2 ? &m2 : &m3;
        int s = get_symbol(b, *mdl);
        out[pos++] = (uint8_t)s;
        frame_todo--;
      } else {
        if (sel == 4) {
          int s = get_symbol(b, m4);
          match_off = kQ.pos_base[s] + b.get(kQ.extra_bits[s]) + 1;
          match_len = 3;
        } else if (sel == 5) {
          int s = get_symbol(b, m5);
          match_off = kQ.pos_base[s] + b.get(kQ.extra_bits[s]) + 1;
          match_len = 4;
        } else if (sel == 6) {
          int s = get_symbol(b, m6len);
          match_len = kQ.len_base[s] + b.get(kQ.len_extra[s]) + 5;
          s = get_symbol(b, m6);
          match_off = kQ.pos_base[s] + b.get(kQ.extra_bits[s]) + 1;
        } else {
          return 71;
        }
        // flat-buffer source resolution: the ring window holds the last
        // window_size output bytes, so src = pos - off when in range.
        // off > pos would read pre-history (uninitialised in the
        // reference) -> reject to scalar path.
        if (match_off > window_size || (int64_t)match_off > pos) return 72;
        // fences the output buffer (sized out_len) against malformed
        // streams; valid folders never need to write past their size
        if ((int64_t)(pos + match_len) > out_len) return 73;
        const uint8_t* sp = out + pos - match_off;
        uint8_t* dst = out + pos;
        if (match_off >= match_len) {
          memcpy(dst, sp, match_len);
        } else {
          for (uint32_t k = 0; k < match_len; k++) dst[k] = sp[k];
        }
        pos += match_len;
        frame_todo -= match_len;
      }
      if (frame_todo < 0) return 74;
      if (frame_todo == 0) {
        // realign to byte, scan forward to the 0xFF trailer
        if (b.n & 7) { b.buf <<= (b.n & 7); b.n -= (b.n & 7); }
        int guard = 0;
        for (;;) {
          if (b.p >= b.end && b.n <= 0) return 75;
          uint32_t v = b.get(8);
          if (v == 0xFF) break;
          if (++guard > 8) return 76;
        }
        header_read = false;
        frame_todo = kFrame;
      }
    }
    return 0;
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


// ======================================================== CAB pipeline
// Full native MSZIP-cabinet decode: walk each folder's CFDATA chain
// (per-block XOR checksum exactly as cabd.c:1462-1479), then per
// folder stream checksum -> tokenize -> resolve frame by frame with no
// cross-phase barrier (tokens are applied while hot in cache).
// Split blocks (uncomp == 0) and anything non-conforming bail out so
// the python driver's exact reference semantics take over.

namespace cabpipe {

struct Frame {
  const uint8_t* p;  // CFDATA payload (an MSZIP one starts with 'CK')
  uint32_t clen;
  uint32_t ulen;
  uint32_t cksum;
};

static uint32_t cab_checksum(const uint8_t* d, size_t n, uint32_t ck) {
  size_t full = n & ~(size_t)3;
  size_t i = 0;
#if defined(__BYTE_ORDER__) && __BYTE_ORDER__ == __ORDER_LITTLE_ENDIAN__
  // the little-endian words 8 bytes at a time (a loop the compiler
  // vectorises): the two halves of the 64-bit XOR are the XORs of the
  // even and the odd words
  uint64_t acc = 0;
  for (; i + 8 <= full; i += 8) {
    uint64_t w;
    memcpy(&w, d + i, 8);
    acc ^= w;
  }
  ck ^= (uint32_t)acc ^ (uint32_t)(acc >> 32);
#endif
  for (; i < full; i += 4)
    ck ^= (uint32_t)d[i] | ((uint32_t)d[i + 1] << 8) |
          ((uint32_t)d[i + 2] << 16) | ((uint32_t)d[i + 3] << 24);
  size_t rem = n - full;
  uint32_t ul = 0;
  if (rem == 3)
    ul = ((uint32_t)d[full] << 16) | ((uint32_t)d[full + 1] << 8) |
         d[full + 2];
  else if (rem == 2)
    ul = ((uint32_t)d[full] << 8) | d[full + 1];
  else if (rem == 1)
    ul = d[full];
  return ck ^ ul;
}

// The block's stored checksum against its payload and header tail
// (cabd.c:1440-1446); a stored 0 is no checksum.
static bool checksum_ok(const Frame& frm) {
  if (!frm.cksum) return true;
  uint32_t sum = cab_checksum(frm.p, frm.clen, 0);
  uint8_t tail[4] = {(uint8_t)(frm.clen & 0xFF), (uint8_t)(frm.clen >> 8),
                     (uint8_t)(frm.ulen & 0xFF), (uint8_t)(frm.ulen >> 8)};
  return cab_checksum(tail, 4, sum) == frm.cksum;
}

// Walk one folder's CFDATA chain of `nblocks` blocks from `off` into
// `fr`, as cabd.c:1362-1460 reads blocks that lie in one cabinet.
// Returns 0, or the code of the first block it does not follow exactly:
// 2 the image ends inside it, 3 split across cabinets (uncomp 0) or over
// CAB's block or input limit, 4 an MSZIP block (codec 1) without 'CK',
// 6 a bad checksum (checked only where `verify`).
static int walk_folder(const uint8_t* cab, uint64_t cab_len, uint64_t off,
                       int nblocks, int codec, int block_resv, bool verify,
                       std::vector<Frame>& fr) {
  fr.clear();
  fr.reserve(nblocks > 0 ? nblocks : 0);
  for (int b = 0; b < nblocks; b++) {
    if (off + 8 > cab_len) return 2;
    uint32_t cksum = (uint32_t)cab[off] | ((uint32_t)cab[off + 1] << 8) |
                     ((uint32_t)cab[off + 2] << 16) |
                     ((uint32_t)cab[off + 3] << 24);
    uint32_t clen = (uint32_t)cab[off + 4] | ((uint32_t)cab[off + 5] << 8);
    uint32_t ulen = (uint32_t)cab[off + 6] | ((uint32_t)cab[off + 7] << 8);
    off += 8 + (uint32_t)block_resv;
    if (off + clen > cab_len) return 2;
    if (ulen == 0 || ulen > 32768) return 3;   // split/oversize
    if (clen > 32768 + 6144) return 3;
    const uint8_t* p = cab + off;
    off += clen;
    if (codec == 1 && (clen < 2 || p[0] != 'C' || p[1] != 'K')) return 4;
    fr.push_back({p, clen, ulen, cksum});
    if (verify && !checksum_ok(fr.back())) return 6;
  }
  return 0;
}

}  // namespace cabpipe

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

}  // namespace lzxe}  // namespace lzxe


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

// forward declarations (pipeline dispatch below uses these)
int msp_lzx_decode(const uint8_t* stream, uint64_t stream_len,
                   int window_bits, int reset_interval_frames,
                   int64_t output_length, int is_delta,
                   const uint8_t* ref_data, uint32_t ref_len,
                   uint8_t* out, uint64_t out_cap);
int msp_qtm_decode(const uint8_t* stream, uint64_t stream_len,
                   int window_bits, int64_t out_len, uint8_t* out,
                   uint64_t out_cap);

// Decode one MSZIP folder: frames[i] are the deflate streams (CK
// stripped), sizes[i] their expected output lengths. Thread-parallel
// phase A, sequential phase B. Returns 0 on success.
int msp_mszip_folder(const uint8_t* const* frames, const uint64_t* frame_lens,
                     const uint32_t* sizes, int n_frames, uint8_t* out,
                     uint64_t out_cap, int n_threads) {
  std::vector<FrameTokens> toks(n_frames);
  if (n_threads < 1) n_threads = 1;
  std::atomic<int> next(0);
  auto worker = [&]() {
    for (;;) {
      int i = next.fetch_add(1);
      if (i >= n_frames) break;
      tokenize_frame(frames[i], frame_lens[i], &toks[i]);
    }
  };
  if (n_threads == 1 || n_frames == 1) {
    worker();
  } else {
    std::vector<std::thread> ths;
    int nt = n_threads < n_frames ? n_threads : n_frames;
    for (int t = 0; t < nt; t++) ths.emplace_back(worker);
    for (auto& t : ths) t.join();
  }
  uint64_t total = 0;
  for (int i = 0; i < n_frames; i++) {
    if (toks[i].err) return 100 + toks[i].err;
    if (toks[i].out_len != sizes[i]) return 99;
    total += sizes[i];
  }
  if (total > out_cap) return 98;
  return resolve_folder(toks.data(), n_frames, out, out_cap);
}

// Decode many folders concurrently (folder-level + frame-level threads).
// frame_ptrs/frame_lens are flattened; folder_offsets[i] is the first
// frame index of folder i (n_folders+1 entries, last = total frames).
// out_offsets[i] similarly into `out`.
int msp_mszip_folders(const uint8_t* const* frame_ptrs,
                      const uint64_t* frame_lens, const uint32_t* sizes,
                      const int64_t* folder_offsets, int n_folders,
                      uint8_t* out, const int64_t* out_offsets,
                      int n_threads) {
  // phase A over ALL frames with one pool
  int64_t total_frames = folder_offsets[n_folders];
  std::vector<FrameTokens> toks(total_frames);
  std::atomic<int64_t> next(0);
  auto worker = [&]() {
    for (;;) {
      int64_t i = next.fetch_add(1);
      if (i >= total_frames) break;
      tokenize_frame(frame_ptrs[i], frame_lens[i], &toks[i]);
    }
  };
  int nt = n_threads < 1 ? 1 : n_threads;
  {
    std::vector<std::thread> ths;
    for (int t = 0; t < nt; t++) ths.emplace_back(worker);
    for (auto& t : ths) t.join();
  }
  // validate
  for (int64_t i = 0; i < total_frames; i++) {
    if (toks[i].err) return 100 + toks[i].err;
    if (toks[i].out_len != sizes[i]) return 99;
  }
  // phase B per folder, folder-parallel
  std::atomic<int> nf(0);
  std::atomic<int> err(0);
  auto resolver = [&]() {
    for (;;) {
      int f = nf.fetch_add(1);
      if (f >= n_folders) break;
      int r = resolve_folder(
          toks.data() + folder_offsets[f],
          (int)(folder_offsets[f + 1] - folder_offsets[f]),
          out + out_offsets[f],
          (uint64_t)(out_offsets[f + 1] - out_offsets[f]));
      if (r) err.store(r);
    }
  };
  {
    std::vector<std::thread> ths;
    int nt2 = nt < n_folders ? nt : n_folders;
    for (int t = 0; t < nt2; t++) ths.emplace_back(resolver);
    for (auto& t : ths) t.join();
  }
  return err.load();
}


// Phase B for the TPU entropy kernel: resolve per-lane token traces
// (ops/pallas_inflate.py format: -1 NOP, 0x20000000|n literal pack of
// n bytes in the litw plane, 0x40000000|nl<<25|len<<16|(dist-1) match
// preceded by nl<=3 packed literals from the litw plane) into a
// folder's bytes. tok/litw are (n_lanes_total, T) row-major — lane l's
// trace is the contiguous row l. Frames of the folder are lanes
// [lane0, lane0+n_frames); history chains across frames.
int msp_resolve_trace(const int32_t* tok, const int32_t* litw, int64_t T,
                      int64_t lane_stride, int lane0, int n_frames,
                      const uint32_t* sizes, uint8_t* out,
                      uint64_t out_cap) {
  uint64_t pos = 0;
  for (int f = 0; f < n_frames; f++) {
    const int32_t* tr = tok + (int64_t)(lane0 + f) * lane_stride;
    const int32_t* lw = litw + (int64_t)(lane0 + f) * lane_stride;
    uint64_t target = pos + sizes[f];
    if (target > out_cap) return 20;
    for (int64_t t = 0; t < T && pos < target; t++) {
      int32_t v = tr[t];
      if (v < 0) continue;
      if (v & 0x20000000) {
        uint32_t n = (uint32_t)(v & 7);
        uint32_t w = (uint32_t)lw[t];
        // token contract: a literal word carries 1..4 bytes (n > 4
        // would shift w past 32 bits — reject malformed traces)
        if (n > 4) return 24;
        if (pos + n > target) return 22;
        for (uint32_t i = 0; i < n; i++) {
          out[pos++] = (uint8_t)(w >> (8 * i));
        }
      } else if (v & 0x40000000) {
        // round-4 kernels carry <= 3 pending literals on match tokens
        // (bits 25-26; bytes LSB-first in the litword plane)
        uint32_t nl = ((uint32_t)v >> 25) & 3;
        if (nl) {
          uint32_t w = (uint32_t)lw[t];
          if (pos + nl > target) return 22;
          for (uint32_t i = 0; i < nl; i++) {
            out[pos++] = (uint8_t)(w >> (8 * i));
          }
        }
        uint32_t l = ((uint32_t)v >> 16) & 0x1FF;
        uint32_t d = ((uint32_t)v & 0x7FFF) + 1;
        if (pos + l > target || d > pos) return 21;
        const uint8_t* src = out + pos - d;
        uint8_t* dst = out + pos;
        if (d >= l) {
          memcpy(dst, src, l);
        } else {
          for (uint32_t i = 0; i < l; i++) dst[i] = src[i];
        }
        pos += l;
      }
    }
    if (pos != target) return 23;
  }
  return 0;
}

// Folder-parallel variant: folder f covers lanes
// [folder_lane0[f], folder_lane0[f] + folder_nframes[f]) and writes to
// out + out_offsets[f].
int msp_resolve_traces(const int32_t* tok, const int32_t* litw, int64_t T,
                       int64_t lane_stride, const int32_t* folder_lane0,
                       const int32_t* folder_nframes,
                       const uint32_t* sizes, const int64_t* size_offsets,
                       int n_folders, uint8_t* out,
                       const int64_t* out_offsets, int n_threads) {
  std::atomic<int> next(0);
  std::atomic<int> err(0);
  auto worker = [&]() {
    for (;;) {
      int f = next.fetch_add(1);
      if (f >= n_folders) break;
      int r = msp_resolve_trace(
          tok, litw, T, lane_stride, folder_lane0[f], folder_nframes[f],
          sizes + size_offsets[f], out + out_offsets[f],
          (uint64_t)(out_offsets[f + 1] - out_offsets[f]));
      if (r) err.store(r);
    }
  };
  int nt = n_threads < 1 ? 1 : n_threads;
  if (nt > n_folders) nt = n_folders;
  if (nt <= 1) {
    worker();
  } else {
    std::vector<std::thread> ths;
    for (int t = 0; t < nt; t++) ths.emplace_back(worker);
    for (auto& t : ths) t.join();
  }
  return err.load();
}

// E8 call-translation untransform on one frame (reference
// lzxd.c:706-733 / codecs/lzx.py:_e8_transform): scan for 0xE8, fix
// up absolute call targets back to relative, skipping the last 10
// bytes of the frame.
static void msp_e8_untransform(uint8_t* d, uint32_t fs, int32_t curpos,
                               int32_t filesize) {
  if (fs <= 10) return;
  uint32_t pos = 0, end = fs - 10;
  while (pos < end) {
    if (d[pos] != 0xE8) {
      pos++;
      curpos++;
      continue;
    }
    pos++;
    int32_t abs_off = (int32_t)((uint32_t)d[pos] | ((uint32_t)d[pos + 1] << 8)
                                | ((uint32_t)d[pos + 2] << 16)
                                | ((uint32_t)d[pos + 3] << 24));
    if (abs_off >= -curpos && abs_off < filesize) {
      uint32_t rel = (uint32_t)(abs_off >= 0 ? abs_off - curpos
                                             : abs_off + filesize);
      d[pos] = (uint8_t)rel;
      d[pos + 1] = (uint8_t)(rel >> 8);
      d[pos + 2] = (uint8_t)(rel >> 16);
      d[pos + 3] = (uint8_t)(rel >> 24);
    }
    pos += 4;
    curpos += 5;
  }
}

// Resolve one LZX lane trace (ops/pallas_lzx.py format: -1 NOP,
// 0x20000000|n literal pack from the litw plane,
// 0x40000000|len match with litw = linear distance; distances may
// reach into a wsize-byte prefix) into out_len bytes, then apply
// the E8 untransform per 32 KiB frame when the intel header fired.
// work must hold wsize + out_len bytes. The prefix is zeros with the
// last hist_len bytes of hist at its end (the port's change: the JAX
// package's copy takes a whole wsize-byte row).
int msp_lzx_resolve_trace(const int32_t* tok, const int32_t* litw,
                          int64_t T, int64_t lane_stride, int lane,
                          uint64_t out_len, uint32_t wsize, int iflag,
                          int32_t ifsz, uint8_t* out, uint8_t* work,
                          const uint8_t* hist, uint32_t hist_len,
                          int64_t e8_base) {
  const int32_t* tr = tok + (int64_t)lane * lane_stride;
  const int32_t* lw = litw + (int64_t)lane * lane_stride;
  // DELTA reference data, or on a segment resume the previous segment's
  // window tail, ends the prefix so linear distances reach into it
  uint32_t h = hist ? (hist_len < wsize ? hist_len : wsize) : 0;
  memset(work, 0, wsize - h);
  if (h) memcpy(work + wsize - h, hist + (hist_len - h), h);
  uint64_t pos = wsize, target = wsize + out_len;
  for (int64_t t = 0; t < T && pos < target; t++) {
    int32_t v = tr[t];
    if (v < 0) continue;
    if (v & 0x20000000) {
      uint32_t n = (uint32_t)(v & 7);
      uint32_t w = (uint32_t)lw[t];
      // token contract: a literal word carries 1..4 bytes (n > 4
      // would shift w past 32 bits — reject malformed traces)
      if (n > 4) return 24;
      if (pos + n > target) return 22;
      for (uint32_t i = 0; i < n; i++) {
        work[pos++] = (uint8_t)(w >> (8 * i));
      }
    } else if (v & 0x40000000) {
      uint32_t l = (uint32_t)v & 0xFFFFF;
      uint64_t d = (uint64_t)(uint32_t)lw[t];
      if (d == 0 || d > pos || pos + l > target) return 21;
      const uint8_t* src = work + pos - d;
      uint8_t* dst = work + pos;
      if (d >= l) {
        memcpy(dst, src, l);
      } else {
        for (uint32_t i = 0; i < l; i++) dst[i] = src[i];
      }
      pos += l;
    }
  }
  if (pos != target) return 23;
  if (iflag && ifsz != 0) {
    // e8_base: absolute byte offset of this segment (the intel frame
    // counter and curpos are stream-absolute, lzxd.c:706-733)
    uint64_t off = 0;
    while (off < out_len) {
      uint64_t abs = (uint64_t)e8_base + off;
      uint32_t frame = (uint32_t)(abs >> 15);
      if (frame >= 32768) break;
      uint32_t fs = out_len - off > 32768 ? 32768
                                          : (uint32_t)(out_len - off);
      msp_e8_untransform(work + wsize + off, fs, (int32_t)abs, ifsz);
      off += fs;
    }
  }
  memcpy(out, work + wsize, out_len);
  return 0;
}

// Standalone E8 untransform over a whole decoded buffer (per 32 KiB
// frame while the absolute frame index < 32768) — used by the
// segmented kernel path, whose window tails must stay PRE-transform.
void msp_e8_decode(uint8_t* buf, uint64_t len, int32_t ifsz,
                   int64_t base) {
  uint64_t off = 0;
  while (off < len) {
    uint64_t abs = (uint64_t)base + off;
    uint32_t frame = (uint32_t)(abs >> 15);
    if (frame >= 32768) break;
    uint32_t fs = len - off > 32768 ? 32768 : (uint32_t)(len - off);
    msp_e8_untransform(buf + off, fs, (int32_t)abs, ifsz);
    off += fs;
  }
}

// Batch variant: lanes are independent streams (CAB folders / CHM
// reset-interval chunks), resolved across a thread pool.
int msp_lzx_resolve_traces(const int32_t* tok, const int32_t* litw,
                           int64_t T, int64_t lane_stride,
                           const uint32_t* out_lens,
                           const int32_t* iflags, const int32_t* ifszs,
                           int n_lanes, uint32_t wsize, uint8_t* out,
                           const int64_t* out_offsets, int n_threads,
                           const uint8_t* const* hists,
                           const uint32_t* hist_lens,
                           const int64_t* e8_bases) {
  uint64_t max_out = 0;
  for (int i = 0; i < n_lanes; i++) {
    if (out_lens[i] > max_out) max_out = out_lens[i];
  }
  std::atomic<int> next(0);
  std::atomic<int> err(0);
  auto worker = [&]() {
    std::vector<uint8_t> work(wsize + max_out);
    for (;;) {
      int i = next.fetch_add(1);
      if (i >= n_lanes) break;
      if ((uint64_t)(out_offsets[i + 1] - out_offsets[i])
          < out_lens[i]) {
        err.store(20);
        continue;
      }
      int r = msp_lzx_resolve_trace(
          tok, litw, T, lane_stride, i, out_lens[i], wsize, iflags[i],
          ifszs[i], out + out_offsets[i], work.data(),
          hists ? hists[i] : nullptr, hists ? hist_lens[i] : 0,
          e8_bases ? e8_bases[i] : 0);
      if (r) err.store(r);
    }
  };
  int nt = n_threads < 1 ? 1 : n_threads;
  if (nt > n_lanes) nt = n_lanes;
  if (nt <= 1) {
    worker();
  } else {
    std::vector<std::thread> ths;
    for (int t = 0; t < nt; t++) ths.emplace_back(worker);
    for (auto& t : ths) t.join();
  }
  return err.load();
}

// LZSS one-shot decode (SZDD/KWAJ/HLP variants), mode as in lzss.py.
int64_t msp_lzss(const uint8_t* in, uint64_t in_len, int mode, uint8_t* out,
                 uint64_t out_cap) {
  uint8_t window[4096];
  memset(window, 0x20, sizeof(window));
  uint32_t pos = mode == 2 ? 4096 - 18 : 4096 - 16;
  uint8_t invert = mode == 1 ? 0xFF : 0x00;
  uint64_t i = 0, o = 0;
  while (i < in_len) {
    uint8_t c = in[i++] ^ invert;
    for (int bit = 0; bit < 8; bit++) {
      if (c & (1 << bit)) {
        if (i >= in_len) return (int64_t)o;
        uint8_t v = in[i++];
        window[pos] = v;
        if (o < out_cap) out[o] = v;
        o++;
        pos = (pos + 1) & 4095;
      } else {
        if (i + 1 >= in_len) return (int64_t)o;
        uint32_t mpos = in[i] | ((in[i + 1] & 0xF0) << 4);
        uint32_t len = (in[i + 1] & 0x0F) + 3;
        i += 2;
        while (len--) {
          uint8_t v = window[mpos];
          window[pos] = v;
          if (o < out_cap) out[o] = v;
          o++;
          pos = (pos + 1) & 4095;
          mpos = (mpos + 1) & 4095;
        }
      }
    }
  }
  return (int64_t)o;
}


// Decode one LZX stream (whole folder / CHM chunk) into a flat buffer.
// Returns 0 on success. matches into DELTA reference data supported.
// e8_defer != 0 skips the E8 untransform (chunk-grid callers apply it
// themselves, or decline); intel_out (if non-null) receives
// {intel_started, last nonzero intel_filesize}.
int msp_lzx_decode_ex(const uint8_t* stream, uint64_t stream_len,
                      int window_bits, int reset_interval_frames,
                      int64_t output_length, int is_delta,
                      const uint8_t* ref_data, uint32_t ref_len,
                      uint8_t* out, uint64_t out_cap,
                      int64_t e8_base, int e8_defer, int32_t* intel_out) {
  if (is_delta ? (window_bits < 17 || window_bits > 25)
               : (window_bits < 15 || window_bits > 21))
    return 60;
  if ((uint64_t)output_length > out_cap) return 61;
  lzx::Decoder d;
  d.window_bits = window_bits;
  d.window_size = 1u << window_bits;
  d.reset_interval = reset_interval_frames;
  d.output_length = output_length;
  d.is_delta = is_delta != 0;
  d.ref_data = ref_data;
  d.ref_len = ref_len;
  d.num_offsets = (int)lzx::kPosSlots[window_bits - 15] << 3;
  d.e8_base = e8_base;
  d.e8_defer = e8_defer != 0;
  d.reset_state();
  lzx::MsbBits b(stream, stream_len);
  int r = d.run(b, out, output_length);
  if (intel_out) {
    intel_out[0] = d.intel_started ? 1 : 0;
    int32_t anyfsz = 0;
    for (auto& p : d.ifsz_log)
      if (p.second) anyfsz = p.second;
    intel_out[1] = anyfsz;
  }
  return r;
}

int msp_lzx_decode(const uint8_t* stream, uint64_t stream_len,
                   int window_bits, int reset_interval_frames,
                   int64_t output_length, int is_delta,
                   const uint8_t* ref_data, uint32_t ref_len,
                   uint8_t* out, uint64_t out_cap) {
  return msp_lzx_decode_ex(stream, stream_len, window_bits,
                           reset_interval_frames, output_length, is_delta,
                           ref_data, ref_len, out, out_cap, 0, 0, nullptr);
}

// Decode many LZX streams concurrently (one thread per stream).
// E8 is DEFERRED in every chunk: outputs are pre-transform bytes, and
// intel_out[2*i..2*i+1] reports {started, filesize} per chunk. A caller
// whose chunks are slices of ONE sequential stream (CHM reset grid)
// must fall back to a whole-stream decode when any chunk reports intel
// activity, because intel_started / curpos / the frame counter are
// stream-global in the reference (lzxd.c:707-713) while chunks decode
// with local state. For valid real-world content E8 never fires in
// chunked sections (the reference's own ResetTable random access,
// chmd.c:1180-1184, restarts lzxd state and would self-disagree).
int msp_lzx_many(const uint8_t* const* streams, const uint64_t* stream_lens,
                 const int* window_bits, const int* reset_intervals,
                 const int64_t* out_lens, int n, uint8_t* out,
                 const int64_t* out_offsets, int n_threads,
                 int32_t* intel_out) {
  std::atomic<int> next(0);
  std::atomic<int> err(0);
  auto worker = [&]() {
    for (;;) {
      int i = next.fetch_add(1);
      if (i >= n) break;
      int r = msp_lzx_decode_ex(streams[i], stream_lens[i], window_bits[i],
                                reset_intervals[i], out_lens[i], 0, nullptr,
                                0, out + out_offsets[i],
                                (uint64_t)(out_offsets[i + 1] -
                                           out_offsets[i]),
                                0, /*e8_defer=*/1,
                                intel_out ? intel_out + 2 * i : nullptr);
      if (r) err.store(r);
    }
  };
  int nt = n_threads < 1 ? 1 : (n_threads < n ? n_threads : n);
  std::vector<std::thread> ths;
  for (int t = 0; t < nt; t++) ths.emplace_back(worker);
  for (auto& t : ths) t.join();
  return err.load();
}


// Decode one Quantum stream (CAB folder; 0xFF trailer byte appended to
// each block by the caller, matching cabd.c:1327-1332).
int msp_qtm_decode(const uint8_t* stream, uint64_t stream_len,
                   int window_bits, int64_t out_len, uint8_t* out,
                   uint64_t out_cap) {
  if (window_bits < 10 || window_bits > 21) return 70;
  if ((uint64_t)out_len > out_cap) return 61;
  // flat-buffer decode only valid while matches stay within history;
  // window wrap (output > window) is handled by the ring equivalence
  qtm::Decoder d;
  d.init(window_bits);
  qtm::QBits b(stream, stream_len);
  return d.run(b, out, out_len);
}


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


// One folder's CFDATA walk alone (cabpipe::walk_folder), for callers that
// decode elsewhere: block b's payload starts at cab[pay_off[b]], holds
// pay_len[b] bytes and decodes to ulen[b]. Returns 0, or the walk's code
// for a folder the caller must read with the exact-semantics driver.
int msp_cab_walk(const uint8_t* cab, uint64_t cab_len, int64_t data_offset,
                 int nblocks, int codec, int block_resv, int verify,
                 int64_t* pay_off, int32_t* pay_len, int32_t* ulen) {
  if (data_offset < 0) return 2;
  std::vector<cabpipe::Frame> fr;
  int r = cabpipe::walk_folder(cab, cab_len, (uint64_t)data_offset, nblocks,
                               codec, block_resv, verify != 0, fr);
  if (r) return r;
  for (size_t b = 0; b < fr.size(); b++) {
    pay_off[b] = (int64_t)(fr[b].p - cab);
    pay_len[b] = (int32_t)fr[b].clen;
    ulen[b] = (int32_t)fr[b].ulen;
  }
  return 0;
}


// Whole-cabinet decode (see cabpipe above): CFDATA walk + checksum +
// per-folder codec decode, folder-parallel with no phase barrier.
// comp_types[f] is the raw CFFOLDER value (low byte codec 0/1/2/3,
// high bits window size for LZX/Quantum). `stage` is a caller-owned
// warm arena (>= total compressed size; cab_len always suffices) used
// to make LZX/Quantum inputs contiguous. Returns 0, or an error code
// telling the caller to fall back to the exact-semantics driver.
int msp_cab_pipeline(const uint8_t* cab, uint64_t cab_len,
                     const int64_t* data_offsets, const int32_t* nblocks,
                     const uint32_t* comp_types, int block_resv,
                     int n_folders, int verify, uint8_t* out,
                     uint64_t out_cap, int64_t* folder_out_offsets,
                     uint8_t* stage, uint64_t stage_cap, int n_threads) {
  std::vector<std::vector<cabpipe::Frame>> folders(n_folders);
  std::vector<uint64_t> stage_offs(n_folders + 1, 0);
  int64_t out_total = 0;
  for (int f = 0; f < n_folders; f++) {
    folder_out_offsets[f] = out_total;
    int codec = comp_types[f] & 0x0F;
    if (codec > 3) return 8;
    auto& fr = folders[f];
    // the checksums are verified below, folder-parallel
    int r = cabpipe::walk_folder(cab, cab_len, (uint64_t)data_offsets[f],
                                 nblocks[f], codec, block_resv, false, fr);
    if (r) return r;
    uint64_t csum_bytes = 0;
    for (auto& frm : fr) {
      if (codec == 0 && frm.clen != frm.ulen) return 4;
      out_total += frm.ulen;
      csum_bytes += frm.clen;
    }
    // only LZX/Quantum stage contiguous input; Quantum gets a 0xFF
    // realign trailer per block (cabd.c:1327-1332)
    uint64_t need = codec >= 2
                        ? csum_bytes + (codec == 2 ? (uint64_t)nblocks[f] : 0)
                        : 0;
    stage_offs[f + 1] = stage_offs[f] + need;
  }
  folder_out_offsets[n_folders] = out_total;
  if ((uint64_t)out_total > out_cap) return 5;
  if (stage_offs[n_folders] > stage_cap) return 5;

  std::atomic<int> nf(0);
  std::atomic<int> err(0);
  auto worker = [&]() {
    FrameTokens ft;
    for (;;) {
      int f = nf.fetch_add(1);
      if (f >= n_folders) break;
      if (err.load(std::memory_order_relaxed)) return;
      int codec = comp_types[f] & 0x0F;
      uint8_t* fout = out + folder_out_offsets[f];
      uint64_t fcap =
          (uint64_t)(folder_out_offsets[f + 1] - folder_out_offsets[f]);
      // checksum pass (all codecs)
      if (verify) {
        for (auto& frm : folders[f]) {
          if (!cabpipe::checksum_ok(frm)) {
            err.store(6);
            return;
          }
        }
      }
      if (codec == 0) {  // NONE: block copy (cabd.c:1502-1551)
        size_t pos = 0;
        for (auto& frm : folders[f]) {
          memcpy(fout + pos, frm.p, frm.ulen);
          pos += frm.ulen;
        }
      } else if (codec == 1) {  // MSZIP: stream tokenize + resolve
        size_t pos = 0;
        for (auto& frm : folders[f]) {
          ft.cmds.clear();
          tokenize_frame(frm.p + 2, frm.clen - 2, &ft);
          if (ft.err || ft.out_len != frm.ulen) {
            err.store(7);
            return;
          }
          const uint8_t* lit = ft.lits.data();
          for (uint32_t cmd : ft.cmds) {
            uint32_t l = cmd & 0xFFFF;
            uint32_t d = cmd >> 16;
            if (pos + l > fcap) {
              err.store(20);
              return;
            }
            uint8_t* dst = fout + pos;
            if (d == 0) {
              memcpy(dst, lit, l);
              lit += l;
            } else if (d > pos) {
              err.store(21);
              return;
            } else if (d >= l) {
              memcpy(dst, dst - d, l);
            } else if (d >= 8) {
              const uint8_t* src = dst - d;
              size_t done = 0;
              while (done < l) {
                size_t chunk = d < (l - done) ? d : (l - done);
                memcpy(dst + done, src + done, chunk);
                done += chunk;
              }
            } else {
              const uint8_t* src = dst - d;
              for (uint32_t i = 0; i < l; i++) dst[i] = src[i];
            }
            pos += l;
          }
        }
      } else {  // LZX (3) / Quantum (2): contiguous staging + decode
        uint8_t* sp = stage + stage_offs[f];
        uint64_t n = 0;
        for (auto& frm : folders[f]) {
          memcpy(sp + n, frm.p, frm.clen);
          n += frm.clen;
          if (codec == 2) sp[n++] = 0xFF;
        }
        int wb = (comp_types[f] >> 8) & 0x1F;
        int r = codec == 3
                    ? msp_lzx_decode(sp, n, wb, 0, (int64_t)fcap, 0, nullptr,
                                     0, fout, fcap)
                    : msp_qtm_decode(sp, n, wb, (int64_t)fcap, fout, fcap);
        if (r) {
          err.store(30 + r);
          return;
        }
      }
    }
  };
  int nt = n_threads < 1 ? 1 : n_threads;
  if (nt > n_folders) nt = n_folders;
  if (nt <= 1) {
    worker();
  } else {
    std::vector<std::thread> ths;
    for (int t = 0; t < nt; t++) ths.emplace_back(worker);
    for (auto& th : ths) th.join();
  }
  return err.load();
}

// Back-compat MSZIP-only entry: routes through msp_cab_pipeline with a
// zero-length stage (MSZIP never stages).
int msp_cab_mszip_pipeline(const uint8_t* cab, uint64_t cab_len,
                           const int64_t* data_offsets,
                           const int32_t* nblocks, int block_resv,
                           int n_folders, int verify, uint8_t* out,
                           uint64_t out_cap, int64_t* folder_out_offsets,
                           int n_threads) {
  std::vector<uint32_t> ct(n_folders, 1);
  return msp_cab_pipeline(cab, cab_len, data_offsets, nblocks, ct.data(),
                          block_resv, n_folders, verify, out, out_cap,
                          folder_out_offsets, nullptr, 0, n_threads);
}


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
