// P4 redesigned: the nine construct probes of tools/mosaic_probe.py (its
// run's pallas_call at :20, smem_scalar's body at :91, dma_row's call at
// :139) as single launches that write their whole output
// (probes_mosaic_vec.cu's kernels).
//
// Each probe maps int32 x (8, 128) to int32 out (8, 128); PLAIN in
// libmspack_tpu_torch/tools/mosaic_probe.py is the function. A thread takes
// QUAD = 4 adjacent elements, one 16-byte load of x and one 16-byte store
// of out, so one block of THREADS = 256 threads covers the output (1024
// threads of one element ran 0.1-0.3 us slower on the three reducing
// probes on the H100, within 0.12 us on the others; PERF.md). Three
// probes need the whole block: reduce_pred and cond_vec whether any x > 0,
// minscalar the least of where(x > 0, x, 99). A thread folds its quad into
// a partial (partial), the kernel folds a warp's partials with
// __reduce_or_sync / __reduce_min_sync and the WARPS warps' in shared
// memory (combine), and each thread finishes its quad with the block's
// value (finish).
//
// Scratch that the TPU kernel kept in VMEM and that an element only ever
// reads at its own position lives in registers: table_rw's 16-row table
// (a register a row, the loop unrolled) and stage_store's stage, of which
// only slot 0, row 0 is read, so its store is a select.
// reduce_pred writes 0 where no x > 0 (the faithful kernel leaves those
// elements to its wrapper's zero fill), so a call is one launch into
// torch.empty. dma_row (dma_row_quad) reads x[0, 0] alone: warp k covers
// output row k, the source row's warp loads it by quads, the other warps
// store zeros with no load; no shared memory, no barrier.
//
// The same functions run in the kernels and in a host twin that g++ builds
// from this header (define PROBES_MOSAIC_CORE_HOST_TWIN): the twin runs the
// block's threads one after another, the partials before the finish.
#pragma once

#include "probes_gather_core.cuh"

namespace pm {

constexpr int SL = 8, LN = 128, N = SL * LN;
constexpr int QUAD = 4;            // elements a thread
constexpr int THREADS = N / QUAD;  // one block
constexpr int WARPS = THREADS / 32;

// in the order of the wrapper's PROBES
enum Probe {
  REDUCE_PRED,
  COND_VEC,
  WHILE22,
  TABLE_RW,
  STAGE_STORE,
  MINSCALAR,
  SMEM_SCALAR,
  U64SHIFT,
  DMA_ROW,
  NPROBES
};

// What a probe needs from the whole block.
enum Reduce { NONE, ANY, MIN };

template <int P>
__host__ __device__ constexpr Reduce reduce_of() {
  return P == REDUCE_PRED || P == COND_VEC ? ANY
                                           : (P == MINSCALAR ? MIN : NONE);
}

SC_FN int32_t min_arg(int32_t v) { return v > 0 ? v : 99; }


// Thread q's quad of x (VEC: 16-byte aligned, one load).
template <bool VEC>
SC_FN void load_quad(const int32_t* x, int q, int32_t* v) {
  if (VEC) {
    pg::load16(v, x + q * QUAD);
  } else {
#pragma unroll
    for (int u = 0; u < QUAD; u++) v[u] = pg::ldg(x + q * QUAD + u);
  }
}

template <bool VEC>
SC_FN void store_quad(int32_t* out, int q, const int32_t* o) {
  if (VEC) {
    pg::store16(out + q * QUAD, o);
  } else {
#pragma unroll
    for (int u = 0; u < QUAD; u++) out[q * QUAD + u] = o[u];
  }
}

// A quad's share of the block's value: 1 where any of its x > 0 (ANY),
// the least min_arg (MIN; from INT32_MAX, min's identity, so that a block
// whose x all exceed 99 takes its least x), 0 (NONE).
template <int P>
SC_FN int32_t partial(const int32_t* v) {
  int32_t any = 0, m = INT32_MAX;
#pragma unroll
  for (int u = 0; u < QUAD; u++) {
    any |= v[u] > 0;
    m = min_arg(v[u]) < m ? min_arg(v[u]) : m;
  }
  return reduce_of<P>() == ANY ? any : (reduce_of<P>() == MIN ? m : 0);
}

template <int P>
SC_FN int32_t combine(int32_t a, int32_t b) {
  return reduce_of<P>() == MIN ? (a < b ? a : b) : (a | b);
}

// dma_row: t = x[0, 0] picks output row r = t mod 8 (floor modulo) and
// source slab w = t rem 4 (truncated, as lax.rem) where that is >= 0, else
// DMA_NEG_SLAB, the slab the JAX body reads as the JAX package's tests run
// it (mosaic_probe.py's DMA_NEG_SLAB says why).
constexpr int DMA_SLABS = 64, DMA_NEG_SLAB = DMA_SLABS - 16;
constexpr int ROW_QUADS = LN / QUAD;  // 32: a warp an output row

SC_FN int dma_row_of(int32_t t) {
  int r = t % SL;
  return r < 0 ? r + SL : r;
}

SC_FN int dma_slab_of(int32_t t) {
  int w = t % 4;
  return w < 0 ? DMA_NEG_SLAB : w;
}

// Thread q's quad of dma_row's output from hbm, contiguous (64, 8, 128)
// (VEC: 16-byte aligned): quad q lies in row q / ROW_QUADS, and only the
// source row's quads load, from hbm[w, r].
template <bool VEC>
SC_FN void dma_row_quad(const int32_t* x, const int32_t* hbm, int q,
                        int32_t* o) {
  int32_t t = pg::ldg(x);  // one address for the whole block
  if (q / ROW_QUADS == dma_row_of(t)) {
    load_quad<VEC>(hbm + (int64_t)dma_slab_of(t) * N, q, o);
  } else {
#pragma unroll
    for (int u = 0; u < QUAD; u++) o[u] = 0;
  }
}

// Whether a call takes the 16-byte path: what it reads and writes by quads
// is 16-byte aligned (x and out; dma_row's aux and out, x's one word at
// any alignment).
SC_FN bool vec_path(int which, const void* x, const void* aux,
                    const void* out) {
  return pg::aligned16(which == DMA_ROW ? aux : x) && pg::aligned16(out);
}

// What every element's result may depend on besides its own x: the
// block's reduction, x[0, 0] (stage_store) and the table's sum
// (smem_scalar).
struct Block {
  int32_t red;
  int32_t t;
  uint32_t sum;
};

// sm[0, 0] + sm[1, 0] + sm[2, 0] + sm[3, 0], wrapping; rows `stride`
// apart.
SC_FN uint32_t table_sum(const int32_t* sm, int64_t stride) {
  uint32_t s = 0;
#pragma unroll
  for (int n = 0; n < 4; n++) s += (uint32_t)pg::ldg(sm + n * stride);
  return s;
}

// stage_store's test: t puts x in stage slot 0, row 0 (t rem 4 == 0, the
// remainder truncated as lax.rem does, and floor(t / 4) rem 2 == 0).
SC_FN bool stage_hit(int32_t t) { return t % 4 == 0 && (t >> 2) % 2 == 0; }

SC_FN uint32_t funnel_r(uint32_t lo, uint32_t hi, uint32_t k) {
#ifdef __CUDA_ARCH__
  return __funnelshift_r(lo, hi, k);
#else
  return (lo >> k) | (hi << (32u - k));  // 1 <= k <= 31
#endif
}

// One element's result from its x and the block's values.
template <int P>
SC_FN int32_t finish(int32_t v, const Block& b) {
  if (P == REDUCE_PRED) return b.red ? (int32_t)((uint32_t)v + 1u) : 0;
  if (P == COND_VEC) {
    int32_t s = -1;
#pragma unroll
    for (int n = 0; n < 8; n++) s = b.red && v == n ? n : s;
    return s;
  }
  if (P == WHILE22) {  // a while loop of three steps carrying 21 sums
    int32_t st[21];
#pragma unroll
    for (int k = 0; k < 21; k++) st[k] = 0;
#pragma unroll
    for (int t = 0; t < 3; t++) {
#pragma unroll
      for (int k = 0; k < 21; k++) st[k] += t;
    }
    return st[0];
  }
  if (P == TABLE_RW) {
    // The 16-row table, a register a row: row n is 0, then n where v == n
    // (its one write), and the read takes row v. As an array the rows
    // became one store and one load at index v, in local memory.
    int32_t r = 0;
#pragma unroll
    for (int n = 0; n < 16; n++) {
      int32_t row = v == n ? n : 0;
      r = v == n ? row : r;
    }
    return r;
  }
  if (P == STAGE_STORE) return stage_hit(b.t) ? v : 0;
  if (P == MINSCALAR) return (int32_t)((uint32_t)v + (uint32_t)b.red);
  if (P == SMEM_SCALAR) return (int32_t)((uint32_t)v + b.sum);
  // U64SHIFT: the low word of (3 lo : lo) >> (x & 31), lo = x as uint32
  uint32_t lo = (uint32_t)v;
  uint32_t k = (uint32_t)v & 31u;
  return (int32_t)(k == 0 ? lo : funnel_r(lo, lo * 3u, k));
}

// The block's values other than the reduction: what P reads of x[0, 0]
// and of the table.
template <int P>
SC_FN Block block_inputs(const int32_t* x, const int32_t* sm,
                         int64_t stride) {
  Block b;
  b.red = 0;
  b.t = P == STAGE_STORE ? pg::ldg(x) : 0;
  b.sum = P == SMEM_SCALAR ? table_sum(sm, stride) : 0u;
  return b;
}

}  // namespace pm

#ifdef PROBES_MOSAIC_CORE_HOST_TWIN
// msp_p4_probe_vec's function on host pointers, the block's threads one
// after another: x, out (8, 128); sm: smem_scalar's table (rows `stride`
// apart), dma_row's (64, 8, 128) source, or null.
template <int P>
static void probe_host(const int32_t* x, const int32_t* sm, int64_t stride,
                       int32_t* out) {
  bool vec = pm::vec_path(P, x, sm, out);
  if (P == pm::DMA_ROW) {
    for (int q = 0; q < pm::THREADS; q++) {
      int32_t o[pm::QUAD];
      if (vec) {
        pm::dma_row_quad<true>(x, sm, q, o);
        pm::store_quad<true>(out, q, o);
      } else {
        pm::dma_row_quad<false>(x, sm, q, o);
        pm::store_quad<false>(out, q, o);
      }
    }
    return;
  }
  int32_t v[pm::THREADS][pm::QUAD] = {};
  pm::Block b = pm::block_inputs<P>(x, sm, stride);
  for (int q = 0; q < pm::THREADS; q++) {
    if (P == pm::WHILE22) continue;
    if (vec)
      pm::load_quad<true>(x, q, v[q]);
    else
      pm::load_quad<false>(x, q, v[q]);
    int32_t p = pm::partial<P>(v[q]);
    b.red = q == 0 ? p : pm::combine<P>(b.red, p);
  }
  for (int q = 0; q < pm::THREADS; q++) {
    int32_t o[pm::QUAD];
    for (int u = 0; u < pm::QUAD; u++) o[u] = pm::finish<P>(v[q][u], b);
    if (vec)
      pm::store_quad<true>(out, q, o);
    else
      pm::store_quad<false>(out, q, o);
  }
}

typedef void (*HostProbe)(const int32_t*, const int32_t*, int64_t,
                          int32_t*);
static const HostProbe HOST_PROBES[pm::NPROBES] = {
    probe_host<pm::REDUCE_PRED>, probe_host<pm::COND_VEC>,
    probe_host<pm::WHILE22>,     probe_host<pm::TABLE_RW>,
    probe_host<pm::STAGE_STORE>, probe_host<pm::MINSCALAR>,
    probe_host<pm::SMEM_SCALAR>, probe_host<pm::U64SHIFT>,
    probe_host<pm::DMA_ROW>};

// -1 for an unknown probe.
extern "C" int pm_probe_host(int which, const int32_t* x, const int32_t* sm,
                             int64_t stride, int32_t* out) {
  if (which < 0 || which >= pm::NPROBES) return -1;
  HOST_PROBES[which](x, sm, stride, out);
  return 0;
}
#endif
