// What the kernels' cores (deflate_core.cuh, resolve_core.cuh,
// lzx_core.cuh, qtm_core.cuh) share: the warp steps, written once for the
// kernels (K1-K4) and their g++ twins, and the MSB-first word-wide bit
// reader of LZX and Quantum.
//
// A K1, K3 or K4 launch runs one warp per stream, K2's pass 1 one warp per
// frame. All 32 threads run the decoder's control flow in lockstep on
// identical values (the coder, the bit cursor and the other hot scalars,
// kept in registers), so the warp never diverges; the stream's tables and
// models lie in shared memory. A
// warp step splits rows over lanes: each lane's share is a function of its
// lane index, written as a lambda of `lane`. On the device each thread
// evaluates it for its own lane and the intrinsics (__ballot_sync,
// __shfl_*_sync, __syncwarp) combine the lanes; in the twin (no
// __CUDA_ARCH__) the same lambda runs for lanes 0..31 in turn and a loop
// builds the same mask or value. So the twin runs the partition the card
// runs.
//
// Shared memory is written lane by lane (each lane its own rows) or by
// lane 0 alone (warp::leader), and a warp::sync() separates every write
// from another lane's read of it, and every read from another lane's later
// write. Global stores of results are lane 0's, but for rows the lanes
// split between them.
#pragma once

#include <stdint.h>
#include <string.h>

#ifdef __CUDACC__
#define SC_INLINE __forceinline__
#else
#define __host__
#define __device__
#define SC_INLINE inline
#endif

#define SC_FN static __host__ __device__ SC_INLINE
#define SC_MEMBER __host__ __device__ SC_INLINE

namespace warp {

constexpr uint32_t ALL = 0xFFFFFFFFu;
#ifdef __CUDA_ARCH__
constexpr int N = 1;   // the lanes one thread evaluates: its own
#else
constexpr int N = 32;  // the twin evaluates all of them
#endif

// The lane of a thread's k-th evaluation.
SC_FN int lane(int k) {
#ifdef __CUDA_ARCH__
  return (int)(threadIdx.x & 31) + k;
#else
  return k;
#endif
}

SC_FN bool leader() {
#ifdef __CUDA_ARCH__
  return (threadIdx.x & 31) == 0;
#else
  return true;
#endif
}

SC_FN void sync() {
#ifdef __CUDA_ARCH__
  __syncwarp();
#endif
}

// One value per lane: a thread's own on the device, all 32 in the twin.
template <class T>
struct Lanes {
  T v[N];
  SC_MEMBER T& at(int l) { return v[N == 1 ? 0 : l]; }
  SC_MEMBER const T& at(int l) const { return v[N == 1 ? 0 : l]; }
};

// f(lane) for every lane.
template <class F>
SC_FN void each(F f) {
  for (int k = 0; k < N; k++) f(lane(k));
}

template <class T, class F>
SC_FN Lanes<T> map(F f) {
  Lanes<T> r;
  for (int k = 0; k < N; k++) r.v[k] = f(lane(k));
  return r;
}

// The mask of the lanes whose f(lane) holds.
template <class F>
SC_FN uint32_t ballot(F f) {
#ifdef __CUDA_ARCH__
  return __ballot_sync(ALL, f(lane(0)));
#else
  uint32_t m = 0;
  for (int l = 0; l < 32; l++) m |= (f(l) ? 1u : 0u) << l;
  return m;
#endif
}

// Lane l gets x of lane l + d, or its own x where l + d > 31.
template <class T>
SC_FN Lanes<T> shfl_down(const Lanes<T>& x, int d) {
  Lanes<T> r;
#ifdef __CUDA_ARCH__
  r.v[0] = __shfl_down_sync(ALL, x.v[0], d);
#else
  for (int l = 0; l < 32; l++) r.v[l] = x.v[l + d < 32 ? l + d : l];
#endif
  return r;
}

// x of lane src, in every lane.
template <class T>
SC_FN T shfl(const Lanes<T>& x, int src) {
#ifdef __CUDA_ARCH__
  return __shfl_sync(ALL, x.v[0], src);
#else
  return x.v[src];
#endif
}

template <class T>
SC_FN Lanes<T> max(Lanes<T> x, const Lanes<T>& y) {
  for (int k = 0; k < N; k++) x.v[k] = x.v[k] > y.v[k] ? x.v[k] : y.v[k];
  return x;
}

template <class T>
SC_FN Lanes<T> max(Lanes<T> x, T y) {
  for (int k = 0; k < N; k++) x.v[k] = x.v[k] > y ? x.v[k] : y;
  return x;
}

SC_FN int clz32(uint32_t x) {
#ifdef __CUDA_ARCH__
  return __clz((int)x);
#else
  return x ? __builtin_clz(x) : 32;
#endif
}

// For each lane, the mask of the lanes whose x equals its own.
template <class T>
SC_FN Lanes<uint32_t> match_any(const Lanes<T>& x) {
  Lanes<uint32_t> r;
#ifdef __CUDA_ARCH__
  r.v[0] = __match_any_sync(ALL, x.v[0]);
#else
  for (int l = 0; l < 32; l++) {
    uint32_t m = 0;
    for (int k = 0; k < 32; k++) m |= (x.v[k] == x.v[l] ? 1u : 0u) << k;
    r.v[l] = m;
  }
#endif
  return r;
}

SC_FN int popc(uint32_t x) {
#ifdef __CUDA_ARCH__
  return __popc(x);
#else
  return __builtin_popcount(x);
#endif
}

// The low `bits` bits of x in reverse order (1 <= bits <= 32).
SC_FN uint32_t brev(uint32_t x, int bits) {
#ifdef __CUDA_ARCH__
  return __brev(x) >> (32 - bits);
#else
  uint32_t r = 0;
  for (int k = 0; k < bits; k++) r |= ((x >> k) & 1u) << (bits - 1 - k);
  return r;
#endif
}

// 1 + the index of the lowest set bit, 0 for none.
SC_FN int ffs64(uint64_t x) {
#ifdef __CUDA_ARCH__
  return __ffsll((long long)x);
#else
  return __builtin_ffsll((long long)x);
#endif
}

// A read-only view of a uint16_t table in shared memory, for a hot loop.
// On the device it keeps the table's 32-bit shared address in a register
// and reads with ld.shared; left to itself the compiler rebuilds that
// address from the block's shared window (an S2R and two more
// instructions) before every read. In the twin it is the pointer.
struct SharedTable {
#ifdef __CUDA_ARCH__
  uint32_t base;
  __device__ SC_INLINE explicit SharedTable(const uint16_t* p)
      : base((uint32_t)__cvta_generic_to_shared(p)) {
    asm volatile("" : "+r"(base));
  }
  __device__ SC_INLINE uint32_t operator[](uint32_t i) const {
    uint16_t v;
    asm volatile("ld.shared.u16 %0, [%1];" : "=h"(v) : "r"(base + 2 * i)
                 : "memory");
    return v;
  }
#else
  const uint16_t* p;
  explicit SharedTable(const uint16_t* q) : p(q) {}
  uint32_t operator[](uint32_t i) const { return p[i]; }
#endif
};

}  // namespace warp

// An MSB-first bit reader over 16-bit units, each little-endian (LZX,
// LE_UNITS) or big-endian (Quantum), reading zeros past the stream's end.
// It refills from aligned 32-bit words (two units), so on the device the
// stream must start on a 4-byte boundary; a unit that starts at 2 mod 4
// (after a seek) is loaded alone first. buf holds exactly the nbits bits
// that follow tell(), whatever the refill, so tell() is exact.
template <bool LE_UNITS>
struct BitReader {
  const uint8_t* src;
  int64_t n;
  int64_t upos;  // byte position of the next 16-bit unit to load (even)
  uint64_t buf;  // the next bits, MSB first
  int nbits;

  SC_MEMBER uint32_t byte_at(int64_t p) const { return p < n ? src[p] : 0u; }

  // The 32 stream bits at byte q (q % 4 == 0), in reading order.
  SC_MEMBER uint32_t word_at(int64_t q) const {
    uint32_t w = 0;
    if (q + 4 <= n) {
#ifdef __CUDA_ARCH__
      w = *reinterpret_cast<const uint32_t*>(src + q);
#else
      memcpy(&w, src + q, 4);
#endif
    } else {
      for (int k = 0; k < 4; k++) w |= byte_at(q + k) << (8 * k);
    }
    if (LE_UNITS) return (w << 16) | (w >> 16);
#ifdef __CUDA_ARCH__
    return __byte_perm(w, 0, 0x0123);
#else
    return __builtin_bswap32(w);
#endif
  }

  // From nbits <= 48 to nbits > 32.
  SC_MEMBER void fill() {
    if (upos & 2) {
      buf |= (uint64_t)(word_at(upos - 2) & 0xFFFF) << (48 - nbits);
      upos += 2;
      nbits += 16;
    }
    while (nbits <= 32) {
      buf |= (uint64_t)word_at(upos) << (32 - nbits);
      upos += 4;
      nbits += 32;
    }
  }

  SC_MEMBER int64_t tell() const { return upos * 8 - nbits; }

  SC_MEMBER void drop(int k) {
    buf <<= k;
    nbits -= k;
  }

  // The next k bits (1 <= k <= 32), left in the buffer.
  SC_MEMBER uint32_t peek(int k) {
    if (nbits < k) fill();
    return (uint32_t)(buf >> (64 - k));
  }

  SC_MEMBER uint32_t take(int k) {
    if (k == 0) return 0;
    uint32_t v = peek(k);
    drop(k);
    return v;
  }

  // Position the reader at bit p (units stay aligned to even bytes).
  SC_MEMBER void seek(int64_t p) {
    upos = (p >> 4) << 1;
    buf = 0;
    nbits = 0;
    if (p & 15) {
      fill();
      drop((int)(p & 15));
    }
  }
};
