// MSZIP phase B in two passes: K1's token traces (deflate_core.cuh's
// format) into bytes, every frame (lane) at once, then chain by chain.
//
// The output is one contiguous byte buffer, lane i at off[i] (the prefix
// sum of the lane sizes); the lanes of a chain (an MSZIP folder) are
// consecutive, and a lane's history is the bytes before it back to its
// chain's first lane.
//
// Pass 1, one warp per lane, all lanes at once: the warp replays its
// lane's tokens into a work buffer of n uint16 values, one per output
// byte. A value below 256 is that byte; 256 + k is a marker, "byte k of
// the 32 KiB window that ends at this lane's start". A match copies
// values, markers included, so a marker never needs more than that
// window. Counts follow the TPU kernel: tokens run while the lane's cursor
// is below its end, the cursor moves by each token's full length, and the
// count is cursor - start; a match that reaches before its chain's start
// (avail: the bytes of the chain before the lane, capped at 32768) stops
// the lane with count -1. Writes never pass the lane's end; bytes no token
// writes are 0. The values go to the lane's slot of a scratch (woff: the
// lane sizes rounded up to 8 values and summed, so a slot is 16-byte
// aligned).
//
// Pass 2, one block of P2_THREADS threads per chain: it walks the chain's
// lanes in order, keeping the chain's last 32 KiB of bytes in a ring (ring[q
// mod 32768] = the byte at output position q). For each lane every thread
// first reads its positions' values and looks each marker up in the ring
// (p2_gather), then, after a barrier, writes them to the ring and the
// output (p2_commit): a lane's markers may name ring slots that its own
// bytes overwrite.
//
// The same functions run in the Hopper kernels (resolve.cu: pass 1's work
// buffer in shared memory, pass 2's ring too) and in a host twin that g++
// builds from this header and stream_core.cuh (define
// RESOLVE_CORE_HOST_TWIN), the warp's lanes and the block's threads
// evaluated one after another.
#pragma once

#include "stream_core.cuh"

#define RS_FN SC_FN

namespace rs {

constexpr int32_t TOK_MATCH = 0x40000000;
constexpr int WINDOW = 32768;    // the history a lane may reach
constexpr int LANE_MAX = 32768;  // bytes of one lane (MSZIP's frame)
constexpr int P2_THREADS = 1024;
constexpr int P2_K = LANE_MAX / P2_THREADS;  // positions per thread

// Pass 1 for one lane of n <= LANE_MAX bytes, one warp: the nt tokens tk
// (litwords lw) replayed into work[0..n). Returns the lane's count.
RS_FN int32_t pass1(const int32_t* tk, const int32_t* lw, int nt, int32_t n,
                    int32_t avail, uint16_t* work) {
  warp::each([&](int lane) {
    for (int p = lane; p < n; p += 32) work[p] = 0;
  });
  warp::sync();
  int32_t dst = 0;
  bool bad = false;
  for (int base = 0; base < nt && dst < n && !bad; base += 32) {
    warp::Lanes<int32_t> tv = warp::map<int32_t>(
        [&](int lane) { return base + lane < nt ? tk[base + lane] : -1; });
    warp::Lanes<int32_t> wv = warp::map<int32_t>(
        [&](int lane) { return base + lane < nt ? lw[base + lane] : 0; });
    int m = nt - base < 32 ? nt - base : 32;
    for (int k = 0; k < m && dst < n; k++) {
      int32_t v = warp::shfl(tv, k);
      uint32_t w = (uint32_t)warp::shfl(wv, k);
      if (v < 0) continue;  // NOP
      int nl, len = 0, dist = 1;
      if (v < TOK_MATCH) {
        nl = v & 7;
      } else {
        nl = (v >> 25) & 3;
        len = (v >> 16) & 0x1FF;
        dist = (v & 0x7FFF) + 1;
      }
      int32_t room = n - dst;
      warp::each([&](int lane) {
        if (lane < nl && lane < room) {
          work[dst + lane] = lane < 4 ? (uint16_t)((w >> (8 * lane)) & 0xFF)
                                      : (uint16_t)0;
        }
      });
      int32_t d = dst + nl;
      if (len && d < n) {
        int32_t src = d - dist;
        if (src < -avail) {
          bad = true;
          break;
        }
        warp::sync();  // the literals before the match reads them
        int32_t mlen = len < n - d ? len : n - d;
        // byte o of the match is source byte o mod dist, and every source
        // lies before d: no read waits on a write of the same match
        warp::each([&](int lane) {
          if (dist >= mlen) {
            for (int o = lane; o < mlen; o += 32) {
              int32_t s = src + o;
              work[d + o] = s >= 0 ? work[s] : (uint16_t)(256 + WINDOW + s);
            }
          } else {
            int r = lane % dist, step = 32 % dist;
            for (int o = lane; o < mlen; o += 32) {
              int32_t s = src + r;
              work[d + o] = s >= 0 ? work[s] : (uint16_t)(256 + WINDOW + s);
              r += step;
              if (r >= dist) r -= dist;
            }
          }
        });
      }
      warp::sync();  // this token's writes before the next token's reads
      dst = d + len;
    }
  }
  warp::sync();
  return bad ? -1 : dst;
}

// The values of a lane of n bytes, rounded up to 8, from work to dst (both
// 16-byte aligned: a lane's slot in the scratch starts at a multiple of 8
// values), 16 bytes a step, lane by lane.
RS_FN void store_lane(const uint16_t* work, int32_t n, uint16_t* dst) {
  int n8 = (n + 7) >> 3;
  warp::each([&](int lane) {
    for (int q = lane; q < n8; q += 32) {
#ifdef __CUDA_ARCH__
      reinterpret_cast<uint4*>(dst)[q] =
          reinterpret_cast<const uint4*>(work)[q];
#else
      memcpy(dst + 8 * q, work + 8 * q, 16);
#endif
    }
  });
}

// Pass 2, thread t's reads of one lane of n bytes at output position
// start: byte k % 4 of vals[k / 4] is the byte at position t + k *
// P2_THREADS (below n), its work value or, for a marker, the ring's byte.
RS_FN void p2_gather(const uint16_t* work, int32_t n, int64_t start,
                     const uint8_t* ring, int t, uint32_t* vals) {
#ifdef __CUDA_ARCH__
#pragma unroll
#endif
  for (int k = 0; k < P2_K; k++) {
    if ((k & 3) == 0) vals[k >> 2] = 0;
    int p = t + k * P2_THREADS;
    if (p < n) {
      uint32_t v = work[p];
      if (v >= 256) v = ring[(start + v - 256) & (WINDOW - 1)];
      vals[k >> 2] |= v << (8 * (k & 3));
    }
  }
}

// Pass 2, thread t's writes after every thread's p2_gather of the lane.
RS_FN void p2_commit(int32_t n, int64_t start, uint8_t* ring, uint8_t* out,
                     int t, const uint32_t* vals) {
#ifdef __CUDA_ARCH__
#pragma unroll
#endif
  for (int k = 0; k < P2_K; k++) {
    int p = t + k * P2_THREADS;
    if (p < n) {
      uint8_t v = (uint8_t)(vals[k >> 2] >> (8 * (k & 3)));
      ring[(start + p) & (WINDOW - 1)] = v;
      out[p] = v;
    }
  }
}

}  // namespace rs

#ifdef RESOLVE_CORE_HOST_TWIN
#include <vector>

// Host twins of the two launches, built only by the tests. Arguments as
// msp_k2_pass1 / msp_k2_pass2 take them (resolve.cu): off is each lane's
// output offset, woff its slot in the scratch work (multiples of 8).
static void rs_pass1_all(const int32_t* tok, const int32_t* litw,
                         int64_t tstride, const int32_t* ntok,
                         const int32_t* outlens, const int64_t* woff,
                         const int32_t* avail, int L, uint16_t* work,
                         int32_t* counts) {
  std::vector<uint16_t> buf(rs::LANE_MAX);
  for (int i = 0; i < L; i++) {
    int nt = ntok[i] < tstride ? ntok[i] : (int)tstride;
    counts[i] = rs::pass1(tok + i * tstride, litw + i * tstride, nt,
                          outlens[i], avail[i], buf.data());
    rs::store_lane(buf.data(), outlens[i], work + woff[i]);
  }
}

static void rs_pass2_all(const uint16_t* work, const int64_t* woff,
                         const int32_t* outlens, const int64_t* off,
                         const int32_t* chains, int nchains, uint8_t* out) {
  std::vector<uint8_t> ring(rs::WINDOW);
  std::vector<uint32_t> vals(rs::LANE_MAX / 4);
  for (int c = 0; c < nchains; c++) {
    for (int i = chains[c]; i < chains[c + 1]; i++) {
      for (int t = 0; t < rs::P2_THREADS; t++) {
        rs::p2_gather(work + woff[i], outlens[i], off[i], ring.data(), t,
                      vals.data() + t * (rs::P2_K / 4));
      }
      for (int t = 0; t < rs::P2_THREADS; t++) {
        rs::p2_commit(outlens[i], off[i], ring.data(), out + off[i], t,
                      vals.data() + t * (rs::P2_K / 4));
      }
    }
  }
}

extern "C" int rs_pass1_host(const int32_t* tok, const int32_t* litw,
                             int64_t tstride, const int32_t* ntok,
                             const int32_t* outlens, const int64_t* woff,
                             const int32_t* avail, int L, uint16_t* work,
                             int32_t* counts) {
  rs_pass1_all(tok, litw, tstride, ntok, outlens, woff, avail, L, work,
               counts);
  return 0;
}

extern "C" int rs_resolve_host(const int32_t* tok, const int32_t* litw,
                               int64_t tstride, const int32_t* ntok,
                               const int32_t* outlens, const int64_t* off,
                               const int64_t* woff, const int32_t* avail,
                               const int32_t* chains, int nchains, int L,
                               uint16_t* work, uint8_t* out,
                               int32_t* counts) {
  rs_pass1_all(tok, litw, tstride, ntok, outlens, woff, avail, L, work,
               counts);
  rs_pass2_all(work, woff, outlens, off, chains, nchains, out);
  return 0;
}
#endif
