"""Device LZX decode as tensor ops: LZX's ``engine="torch"``.

PyTorch counterpart of ``libmspack_tpu/ops/lzx_jax.py``, the XLA-level LZX
decode of the JAX package (its ``engine="jax"``) for LZX's structure
(reference: lzxd.c):

* The host walks block headers only (3-bit type + 24-bit length +
  pretree delta-coded tree lengths, lzxd.c:138-183 / :476-522): KB-sized,
  branchy, sequential; everything byte-volume runs on the device.
* Per VERBATIM/ALIGNED block, one device pass (``_block_device``):
  1. canonical 2^16 MSB LUTs for the main and length trees (+2^7
     aligned);
  2. speculative symbol decode at EVERY bit position of the stream slice
     (main sym -> literal / match length header -> length tree ->
     position slot extra bits, with the aligned low-3 path);
  3. jump/output-sum pointer-doubling levels;
  4. a frame walk that follows the token chain from the block's first
     symbol, realigning to 16 bits at every 32 KiB frame boundary
     (lzxd.c frame epilogue; matches may overrun a frame but never a
     block) and returning each frame segment's start position and token
     count and the block's end bit position (the host needs it to parse
     the next header: block extents are only discoverable by decoding);
  5. per-segment token extraction by rank jumping.
* Phase B over the whole stream: the R0/R1/R2 repeated-offset LRU as a
  scan over substitution maps (each token either permutes (R0,R1,R2) or
  inserts a constant; composition is associative, so the sequential LRU
  of lzxd.c:565-585 parallelizes: ``rep_scan``, a log-step scan), then
  the pointer-doubling match resolve (``ops/match_resolve``).
* E8 call translation per frame on the host (``codecs.lzx._e8_transform``).

UNCOMPRESSED blocks are handled on the host (their extent is known
without entropy decode): raw bytes land in the base output buffer and a
pseudo token resets (R0,R1,R2) to the stored values (lzxd.c:303-320).

LZX DELTA (OAB, reference lzxd.c:348-382/:588-611) is covered too:
windows 2^17..2^25, the long-match escape, the per-frame 16-bit chunk
size skip, and reference data as a prefix of the phase-B buffer.

Not covered (``NeedFallback``, so ``lzx_stream_decode`` returns None and
the caller takes the scalar or native path): window bits outside the
per-mode range, a block spanning more frames or a longer slice than
``BUCKETS[-1]``, malformed streams. Each decline's ``reason`` is one of
``DECLINE_REASONS``. Where an index leaves its array (a unit read past
the slice, a frame walk off the chain) the reads follow ``jnp.take``'s
fill rule (``bitview.take``), as the JAX op's do.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from .._device import resolve_device
from ..codecs.lzx import (EXTRA_BITS, POSITION_BASE, POSITION_SLOTS,
                          _e8_transform)
from .bitview import I8_FILL, I32_FILL, U8_FILL, U32_FILL, take
from .inflate import NeedFallback, add_ms
from .match_resolve import resolve, tokens_to_ptr

__all__ = ["lzx_stream_decode", "rep_scan", "e8_untransform",
           "DECLINE_REASONS", "BUCKETS"]

FRAME_SIZE = 32768
R_TOK = FRAME_SIZE            # max tokens per frame segment (1 byte/token)
N_DOUBLINGS = 15              # 2^15 = R_TOK
MAINSYMS = 256 + (POSITION_SLOTS[21 - 15] << 3)   # 656, window <= 2^21
MAINSYMS_DELTA = 256 + (POSITION_SLOTS[25 - 15] << 3)   # 2576, <= 2^25
LENSYMS = 250
NUM_SECONDARY = 249
MAX_SLOTS = len(POSITION_BASE)   # 290 (delta windows reach slot 289)

_EXTRA_TBL = np.zeros(MAX_SLOTS, np.int64)
_BASE_TBL = np.zeros(MAX_SLOTS, np.int64)
for _s in range(MAX_SLOTS):
    _EXTRA_TBL[_s] = 17 if _s >= 36 else EXTRA_BITS[_s]
    _BASE_TBL[_s] = POSITION_BASE[_s] - 2

# (F_MAX frames per block, slice bytes) buckets; a block spanning more
# frames or a longer slice falls back to the scalar/native engines.
BUCKETS = ((4, 1 << 16), (4, 1 << 18), (16, 1 << 21), (64, 1 << 23))

# the JAX op's NeedFallback texts, and its two early None returns
DECLINE_REASONS = (
    "window or length outside the mode's range",
    "reference data without DELTA or beyond the window",
    "undecodable code in tree header", "stream too large for device path",
    "EOF in uncompressed block", "bad stored R0-R2", "bad block type",
    "block exceeds device buckets", "device block decode failed",
    "block overran its slice", "phase B validity check failed")


# ----------------------------------------------------------------------
# Host-side bit reader + header walker (MSB over 16-bit LE units)


class _MsbBits:
    """Position-based MSB bit reader over 16-bit little-endian units.

    The unit grid is absolute (byte pairs 2u,2u+1): the format keeps all
    bit reads 16-bit aligned (uncompressed blocks realign to 16 bits
    before their raw bytes and consume a pad byte when odd-length,
    lzxd.c:286-320), so the grid never shifts."""

    __slots__ = ("data", "pos")

    def __init__(self, data: bytes, pos: int = 0):
        self.data = data
        self.pos = pos

    def read(self, n: int) -> int:
        v = 0
        d = self.data
        ln = len(d)
        p = self.pos
        for _ in range(n):
            u2 = (p >> 4) << 1
            lo = d[u2] if u2 < ln else 0
            hi = d[u2 + 1] if u2 + 1 < ln else 0
            v = (v << 1) | (((lo | (hi << 8)) >> (15 - (p & 15))) & 1)
            p += 1
        self.pos = p
        return v


def _canon_decmap(lens) -> dict:
    """(length, canonical MSB code) -> symbol, ignoring lens > 16 like the
    reference table builder (readhuff.h)."""
    lens = [l if 0 < l <= 16 else 0 for l in lens]
    max_len = max(lens) if lens else 0
    bl_count = [0] * (max_len + 1)
    for l in lens:
        if l:
            bl_count[l] += 1
    code = 0
    next_code = [0] * (max_len + 2)
    for l in range(1, max_len + 1):
        code = (code + bl_count[l - 1]) << 1
        next_code[l] = code
    out = {}
    for sym, l in enumerate(lens):
        if l:
            out[(l, next_code[l])] = sym
            next_code[l] += 1
    return out


def _host_huff(rdr: _MsbBits, decmap: dict) -> int:
    code = 0
    for ln in range(1, 17):
        code = (code << 1) | rdr.read(1)
        sym = decmap.get((ln, code))
        if sym is not None:
            return sym
    raise NeedFallback("undecodable code in tree header")


def _host_read_lens(rdr: _MsbBits, lens: np.ndarray, first: int,
                    last: int) -> None:
    """Pretree-delta code lengths, mirroring codecs/lzx._read_lens
    (reference lzxd.c:138-183) including the mod-17 wrap and byte-store
    quirks."""
    pre = [rdr.read(4) for _ in range(20)]
    decmap = _canon_decmap(pre)
    x = first
    while x < last:
        z = _host_huff(rdr, decmap)
        if z == 17:
            for _ in range(rdr.read(4) + 4):
                lens[x] = 0
                x += 1
        elif z == 18:
            for _ in range(rdr.read(5) + 20):
                lens[x] = 0
                x += 1
        elif z == 19:
            y = rdr.read(1) + 4
            z = _host_huff(rdr, decmap)
            z = int(lens[x]) - z
            if z < 0:
                z += 17
            z &= 0xFF
            for _ in range(y):
                lens[x] = z
                x += 1
        else:
            z = int(lens[x]) - z
            if z < 0:
                z += 17
            lens[x] = z & 0xFF
            x += 1


# ----------------------------------------------------------------------
# Device: LUT build, speculative decode, frame walk, extraction


def _device_lut_msb(lens, nsyms: int, nbits: int):
    """Canonical MSB LUT (index = next ``nbits`` stream bits, entry =
    len | sym<<5, -1 invalid). Returns (lut, total): total == 2^nbits
    means Kraft-complete; 0 means empty."""
    dev = lens.device
    lens = lens.to(torch.int64)
    syms = torch.arange(nsyms, device=dev)
    eff = torch.where((lens > 0) & (lens <= 16), lens, 0)
    present = eff > 0
    key = torch.where(present, eff * 4096 + syms, 1 << 22)
    order = torch.argsort(key, stable=True)
    s_lens = eff[order]
    sizes = torch.where(present[order],
                        1 << (nbits - s_lens.clamp(1, nbits)), 0)
    cum_end = torch.cumsum(sizes, 0)
    total = cum_end[-1]

    v = torch.arange(1 << nbits, device=dev)
    idx = torch.searchsorted(cum_end, v, right=True).clamp(0, nsyms - 1)
    sym = order[idx]
    L = eff[sym]
    valid = (v < total) & (L > 0) & (L <= nbits)
    return torch.where(valid, L | (sym << 5), -1), total


def _spec_decode(units, mainlut, lenlut, allut, aligned_flag: bool,
                 length_empty: bool, P: int, DELTA: bool):
    """Speculative LZX symbol decode at every bit position 0..P-1.

    units: int64 tensor of 16-bit units. Returns per-position (kind int8
    [0 lit, 1 match, 3 bad], outlen, dist [computed offset for new], slot
    int8 [0/1/2 rep, 3 new offset], lit uint8, nxt bit position). With
    DELTA, matches of length 257 read the extra-length escape
    (lzxd.c:588-611)."""
    dev = units.device
    p = torch.arange(P, device=dev)
    extra_tbl = torch.from_numpy(_EXTRA_TBL).to(dev)
    base_tbl = torch.from_numpy(_BASE_TBL).to(dev)

    def win17(pos):
        u = pos >> 4
        q = pos & 15
        a = take(units, u, U32_FILL)
        b = take(units, u + 1, U32_FILL)
        hi = ((a << 16) & 0xFFFFFFFF) | b
        return (hi >> (15 - q)) & 0x1FFFF

    def read_dyn(pos, nbits):
        # MSB-first read of `nbits` (<=17) at `pos`
        return win17(pos) >> (17 - nbits)

    e1 = mainlut[win17(p) >> 1]
    n1 = e1 & 31
    sym = e1 >> 5
    bad = e1 < 0
    is_lit = (sym < 256) & ~bad

    elem = (sym - 256).clamp(min=0)
    len_hdr = elem & 7
    slot = (elem >> 3).clamp(max=MAX_SLOTS - 1)

    p1 = p + n1
    e2 = lenlut[win17(p1) >> 1]
    need_len = (~is_lit) & (len_hdr == 7)
    n2 = torch.where(need_len, e2 & 31, 0)
    lsym = e2 >> 5
    bad |= need_len & ((e2 < 0) | length_empty)
    mlen = torch.where(len_hdr == 7, 7 + lsym, len_hdr) + 2

    extra = extra_tbl[slot]
    base = base_tbl[slot]
    p2 = p1 + n2

    # verbatim path: `extra` raw bits
    off_verb = base + read_dyn(p2, extra)
    # aligned path for extra >= 3: (extra-3) raw high bits + aligned sym
    hi_bits = (extra - 3).clamp(min=0)
    hi_val = read_dyn(p2, hi_bits)
    e3 = allut[win17(p2 + hi_bits) >> 10]
    n3 = e3 & 31
    asym = e3 >> 5
    use_al = aligned_flag & (extra >= 3)
    bad |= (~is_lit) & (slot >= 3) & use_al & (e3 < 0)
    off = torch.where(use_al, base + (hi_val << 3) + asym, off_verb)
    nb_off = torch.where(use_al, hi_bits + n3, extra)

    is_rep = slot < 3
    off_bits = torch.where(is_rep, 0, nb_off)

    if DELTA:
        # extra-length escape after the offset bits (lzxd.c:588-611):
        # bit order at p3 is [1|0..0+8] [10|+10] [110|+12] [111|+15]
        p3 = p + n1 + n2 + off_bits
        t3 = win17(p3) >> 14
        case_a = (t3 >> 2) == 0
        case_b = (t3 >> 1) == 0b10
        case_c = t3 == 0b110
        esc_val = torch.where(
            case_a, read_dyn(p3 + 1, 8),
            torch.where(case_b, read_dyn(p3 + 2, 10) + 0x100,
                        torch.where(case_c, read_dyn(p3 + 3, 12) + 0x500,
                                    read_dyn(p3 + 3, 15))))
        esc_bits = torch.where(case_a, 9, torch.where(
            case_b, 12, torch.where(case_c, 15, 18)))
        is_esc = (~is_lit) & (mlen == 257)
        mlen = torch.where(is_esc, mlen + esc_val, mlen)
        off_bits = off_bits + torch.where(is_esc, esc_bits, 0)

    tok_bits = torch.where(is_lit, n1, n1 + n2 + off_bits)
    nxt = p + tok_bits
    bad |= nxt > P

    kind = torch.where(bad, 3, torch.where(is_lit, 0, 1))
    outlen = torch.where(kind == 0, 1, torch.where(kind == 1, mlen, 0))
    dist = torch.where(is_rep, 0, off)
    nxt = torch.where(bad, p, nxt).clamp(0, P - 1)
    return (kind.to(torch.int8), outlen.to(torch.int32), dist.to(torch.int32),
            torch.where(is_rep, slot, 3).to(torch.int8),
            (sym & 0xFF).to(torch.uint8), nxt.to(torch.int32))


def _block_device(units, d0: int, main_lens, len_lens, al_lens,
                  aligned_flag: bool, length_empty: bool, block_len: int,
                  o0: int, U: int, F: int, DELTA: bool = False):
    """One VERBATIM/ALIGNED block: speculative decode + frame walk + token
    extraction. Returns flat (F*R_TOK,) token fields, the block's end bit
    position and a validity flag, as device tensors."""
    dev = units.device
    P = 16 * (U - 2)

    nmain = MAINSYMS_DELTA if DELTA else MAINSYMS
    mainlut, tm = _device_lut_msb(main_lens, nmain, 16)
    lenlut, tl = _device_lut_msb(len_lens, LENSYMS, 16)
    allut, ta = _device_lut_msb(al_lens, 8, 7)
    ok = (tm == (1 << 16)) & ((tl == (1 << 16)) | (tl == 0))
    if aligned_flag:
        ok &= ta == (1 << 7)

    kind, outlen, dist, slot, lit, nxt = _spec_decode(
        units, mainlut, lenlut, allut, aligned_flag, length_empty, P, DELTA)
    del mainlut, lenlut, allut

    # int32 levels, as the JAX op's (its int32 wrap included)
    sums = [outlen]
    jumps = [nxt]
    for _ in range(N_DOUBLINGS - 1):
        j, s = jumps[-1], sums[-1]
        sums.append(s + s.index_select(0, j))
        jumps.append(j.index_select(0, j))

    # frame walk: follow the chain from d0, realigning at every 32 KiB
    # output boundary (crossing matches overrun but never cross blocks)
    fb0 = (o0 // FRAME_SIZE + 1) * FRAME_SIZE - o0   # first boundary
    i32 = dict(dtype=torch.int32, device=dev)
    cur = torch.tensor(d0, **i32)
    produced = torch.tensor(0, **i32)
    seg_start = torch.zeros(F, **i32)
    seg_cnt = torch.zeros(F, **i32)
    for f in range(F):
        active = produced < block_len
        boundary = fb0 + f * FRAME_SIZE
        target = min(boundary, block_len) - produced
        # a DELTA match (<=33024) may overrun an entire frame; that frame
        # decodes nothing but still realigns + chunk-skips (reference:
        # empty bytes_todo iteration of the frame loop)
        empty = target <= 0

        pos, acc, cnt = cur, torch.tensor(0, **i32), torch.tensor(0, **i32)
        for k in range(N_DOUBLINGS - 1, -1, -1):
            sk = take(sums[k], pos, I32_FILL)
            go = ((acc + sk) < target) & ~empty
            acc = torch.where(go, acc + sk, acc)
            pos = torch.where(go, take(jumps[k], pos, I32_FILL), pos)
            cnt = cnt + torch.where(go, 1 << k, 0).to(torch.int32)
        # the next token reaches/crosses the target
        acc = torch.where(empty, 0, acc + take(sums[0], pos, I32_FILL))
        pos_end = torch.where(empty, cur, take(jumps[0], pos, I32_FILL))
        cnt = torch.where(empty, 0, cnt + 1).to(torch.int32)

        new_prod = produced + acc
        hit_boundary = new_prod >= boundary
        aligned_pos = (pos_end + 15) & ~15
        if DELTA:
            aligned_pos = aligned_pos + 16   # frame chunk-size skip
        new_cur = torch.where(hit_boundary, aligned_pos, pos_end)

        seg_start[f] = torch.where(active, cur, 0)
        seg_cnt[f] = torch.where(active, cnt, 0)
        ok &= torch.where(active & ~empty, acc > 0, True)
        cur = torch.where(active, new_cur, cur).to(torch.int32)
        produced = torch.where(active, new_prod, produced).to(torch.int32)
    ok &= produced == block_len

    # token extraction by rank jumping
    ranks = torch.arange(R_TOK, device=dev, dtype=torch.int32)
    pos = seg_start[:, None].expand(F, R_TOK).reshape(-1)
    rk = ranks[None, :].expand(F, R_TOK).reshape(-1)
    for k in range(N_DOUBLINGS):
        bit = (rk >> k) & 1
        pos = torch.where(bit == 1, take(jumps[k], pos, I32_FILL), pos)
    del sums, jumps
    live = rk < seg_cnt.repeat_interleave(R_TOK)
    t_kind_raw = take(kind, pos, I8_FILL)
    t_kind = torch.where(live, t_kind_raw, 3).to(torch.int8)
    t_outlen = torch.where(live, take(outlen, pos, I32_FILL), 0)
    t_dist = torch.where(live, take(dist, pos, I32_FILL), 0)
    t_slot = torch.where(live, take(slot, pos, I8_FILL), 0).to(torch.int8)
    t_lit = take(lit, pos, U8_FILL)
    ok &= ~(live & (t_kind_raw == 3)).any()
    return (t_kind, t_outlen.to(torch.int32), t_dist.to(torch.int32),
            t_slot, t_lit, cur, ok)


# ----------------------------------------------------------------------
# Phase B: rep-offset scan + match resolve over the whole stream


def _rep_combine(a_src, a_val, b_src, b_val):
    """The map ``b`` applied after ``a``: each of b's three entries either
    inserts its constant (src < 0) or reads a's entry src."""
    idx = b_src.clamp(0, 2)
    g_src = torch.gather(a_src, 1, idx)
    g_val = torch.gather(a_val, 1, idx)
    return (torch.where(b_src < 0, b_src, g_src),
            torch.where(b_src < 0, b_val, g_val))


def rep_scan(src, val):
    """Inclusive scan of the (T, 3) substitution maps ``(src, val)`` under
    ``_rep_combine``, in ceil(log2 T) steps (Hillis-Steele): after the
    step of distance d, row i holds the composition of rows i-2d+1..i.
    Equal to ``lax.associative_scan(_rep_combine, ...)`` wherever the
    result is read (val where src < 0)."""
    src = src.to(torch.int64)
    val = val.to(torch.int64)
    T = src.shape[0]
    d = 1
    while d < T:
        n_src, n_val = _rep_combine(src[:-d], val[:-d], src[d:], val[d:])
        src = torch.cat([src[:d], n_src])
        val = torch.cat([val[:d], n_val])
        d *= 2
    return src, val


_PERM = np.asarray([
    [0, 1, 2],    # slot 0: R unchanged
    [1, 0, 2],    # slot 1: swap R0,R1
    [2, 1, 0],    # slot 2: swap R0,R2
    [-1, 0, 1],   # new offset: insert const
], np.int64)


def _phase_b(kind, outlen, dist, slot, lit, aux, base, wsize: int,
             ref_len: int, N: int, S0: int = 0):
    """kind 0=literal/raw-run, 1=match, 2=R-reset pseudo, 3=dead.
    aux (T,2): R1/R2 constants for kind-2 rows. Returns (out, ok).

    S0 (32 KiB-rounded) shifts the output region: base[0:S0] holds LZX
    DELTA reference data in its tail (base[S0-ref_len:S0]), matches may
    reach up to ref_len bytes before the stream start (lzxd.c:622-628)
    and the prefix is pointer-self-rooted."""
    dev = kind.device
    T = kind.shape[0]
    is_match = kind == 1
    perm = torch.from_numpy(_PERM).to(dev)

    src = perm[0].expand(T, 3)
    src = torch.where(is_match[:, None], perm[slot.to(torch.int64).clamp(0, 3)],
                      src)
    src = torch.where((kind == 2)[:, None], -1, src)
    aux = aux.to(torch.int64)
    val = torch.stack([dist.to(torch.int64),
                       torch.where(kind == 2, aux[:, 0], 0),
                       torch.where(kind == 2, aux[:, 1], 0)], dim=1)

    s_src, s_val = rep_scan(src, val)
    # initial R0=R1=R2=1 (lzxd.c reset state)
    r0 = torch.where(s_src[:, 0] < 0, s_val[:, 0], 1)
    dist_f = torch.where(is_match, r0, 0)
    del src, val, s_src, s_val

    outlen = outlen.to(torch.int64)
    out_start = torch.cumsum(outlen, 0) - outlen + S0
    bad = (is_match & (dist_f > out_start - S0 + ref_len)).any()
    bad |= (is_match & (dist_f > wsize)).any()
    bad |= (is_match & (dist_f < 1)).any()
    # scalar parity: matches may not run over the window wrap
    bad |= (is_match & ((out_start - S0) % wsize + outlen > wsize)).any()

    ptr, _ = tokens_to_ptr(N, out_start, is_match.to(torch.int64), lit,
                           dist_f)
    if S0:
        pos = torch.arange(N, device=dev)
        ptr = torch.where(pos < S0, pos, ptr)   # ref bytes are roots
    # literal bytes (and each raw run's first byte, which base holds
    # already) at their output positions
    lit_at = (kind == 0) & (outlen > 0)
    lit_buf = base.clone()
    lit_buf[out_start[lit_at].clamp(0, N - 1)] = lit[lit_at]
    return resolve(ptr, lit_buf), not bool(bad)


# ----------------------------------------------------------------------
# Host orchestration


def _le32(d: bytes, o: int) -> int:
    return int.from_bytes(d[o : o + 4], "little")


def lzx_stream_decode(data: bytes, window_bits: int, out_len: int, *,
                      is_delta: bool = False, ref_data: bytes | None = None,
                      device="cuda", declines=None,
                      timings=None) -> bytes | None:
    """Decode a fresh LZX stream (CAB folder / CHM reset chunk / OAB DELTA
    block) on ``device``. Returns bytes, or None when the scalar/native
    path is needed (oversize blocks, malformed streams); ``declines`` (a
    Counter), when given, counts the decline's reason, and ``timings`` (a
    dict) adds ``phase_a_ms``, ``phase_b_ms`` (the host clock around each
    phase's device work and the copy back that waits for it) and
    ``e8_ms``."""
    lo, hi = (17, 25) if is_delta else (15, 21)
    early = None
    if not (lo <= window_bits <= hi) or out_len < 0:
        early = "window or length outside the mode's range"
    elif ref_data and (not is_delta or len(ref_data) > (1 << window_bits)):
        early = "reference data without DELTA or beyond the window"
    if early is not None:
        if declines is not None:
            declines[early] += 1
        return None
    if out_len == 0:
        return b""
    try:
        return _run(data, window_bits, out_len, is_delta, ref_data or b"",
                    resolve_device(device), timings)
    except NeedFallback as e:
        if declines is not None:
            declines[e.reason] += 1
        return None


def _run(data: bytes, wb: int, out_len: int, is_delta: bool, ref: bytes,
         dev, timings=None) -> bytes:
    rdr = _MsbBits(data)
    if is_delta:
        rdr.pos = 16                  # first frame's chunk size
    filesize = 0
    if rdr.read(1):
        v = (rdr.read(16) << 16) | rdr.read(16)
        filesize = v - (1 << 32) if v & 0x80000000 else v
    first_e8_frame = None

    nmain = 256 + (POSITION_SLOTS[wb - 15] << 3)
    NMAIN = MAINSYMS_DELTA if is_delta else MAINSYMS
    maintree_len = np.zeros(NMAIN, np.int32)
    length_len = np.zeros(LENSYMS, np.int32)

    rl = len(ref)
    S0 = (rl + FRAME_SIZE - 1) & ~(FRAME_SIZE - 1)   # 32 KiB-rounded
    N = max(256, 1 << max(0, S0 + out_len - 1).bit_length())
    if N > (1 << 27):
        raise NeedFallback("stream too large for device path")
    base = np.zeros(N, np.uint8)
    if rl:
        base[S0 - rl : S0] = np.frombuffer(ref, np.uint8)

    # flat token stream: device arrays from blocks + host pseudo rows
    parts = []          # (kind, outlen, dist, slot, lit, aux) chunks
    o = 0
    while o < out_len:
        btype = rdr.read(3)
        blen = (rdr.read(16) << 8) | rdr.read(8)
        blen_eff = min(blen, out_len - o)

        if btype == 3:                      # UNCOMPRESSED
            if rdr.pos & 15 == 0:
                rdr.pos += 16               # ensure(16) then drop all
            else:
                rdr.pos = (rdr.pos + 15) & ~15
            bo = rdr.pos >> 3
            if bo + 12 + blen_eff > len(data):
                raise NeedFallback("EOF in uncompressed block")
            r0, r1, r2 = _le32(data, bo), _le32(data, bo + 4), _le32(data, bo + 8)
            if r0 < 1 or r1 < 1 or r2 < 1:
                raise NeedFallback("bad stored R0-R2")
            pos_b = bo + 12
            first_raw = data[pos_b]
            if not is_delta:
                base[S0 + o : S0 + o + blen_eff] = np.frombuffer(
                    data[pos_b : pos_b + blen_eff], np.uint8)
                pos_b += blen_eff
            else:
                # DELTA interleaves a 16-bit chunk size at every frame
                # boundary, even inside raw data (frame-loop prologue)
                left, cur_o = blen_eff, o
                while left:
                    chunk = min(left, FRAME_SIZE - (cur_o % FRAME_SIZE))
                    if pos_b + chunk > len(data):
                        raise NeedFallback("EOF in uncompressed block")
                    base[S0 + cur_o : S0 + cur_o + chunk] = np.frombuffer(
                        data[pos_b : pos_b + chunk], np.uint8)
                    pos_b += chunk
                    cur_o += chunk
                    left -= chunk
                    if (cur_o % FRAME_SIZE) == 0 and cur_o < out_len:
                        pos_b += 2          # next frame's chunk size
            parts.append(_pseudo_rows(blen_eff, first_raw, r0, r1, r2, dev))
            rdr.pos = (pos_b + (blen - blen_eff)) * 8
            if blen & 1 and (o + blen_eff) < out_len:
                rdr.pos += 8                # odd-length pad byte
            if first_e8_frame is None:
                first_e8_frame = o // FRAME_SIZE
            o += blen_eff
            continue

        if btype not in (1, 2):
            raise NeedFallback("bad block type")
        aligned = btype == 2
        al_lens = np.zeros(8, np.int32)
        if aligned:
            for i in range(8):
                al_lens[i] = rdr.read(3)
        _host_read_lens(rdr, maintree_len, 0, 256)
        _host_read_lens(rdr, maintree_len, 256, nmain)
        if maintree_len[0xE8] and first_e8_frame is None:
            first_e8_frame = o // FRAME_SIZE
        _host_read_lens(rdr, length_len, 0, NUM_SECONDARY)
        length_empty = not length_len[:NUM_SECONDARY].any()
        if blen_eff == 0:
            continue

        frames_spanned = (o % FRAME_SIZE + blen_eff
                          + FRAME_SIZE - 1) // FRAME_SIZE
        d0 = rdr.pos
        u0 = d0 >> 4                        # slice at a unit boundary
        rest = len(data) - 2 * u0
        bucket = next((b for b in BUCKETS
                       if frames_spanned <= b[0]
                       and min(rest, 4 * blen_eff + 4096) <= b[1]), None)
        if bucket is None:
            raise NeedFallback("block exceeds device buckets")
        F, S = bucket
        sl = data[2 * u0 : 2 * u0 + S]
        buf = np.zeros(S + 4, np.uint8)
        buf[: len(sl)] = np.frombuffer(sl, np.uint8)
        # 16-bit little-endian units, consumed MSB-first (lzxd.c:86-91)
        units = torch.from_numpy(buf[0::2].astype(np.int64)
                                 | (buf[1::2].astype(np.int64) << 8))

        t0 = time.perf_counter()
        (t_kind, t_outlen, t_dist, t_slot, t_lit,
         end_rel, ok) = _block_device(
            units.to(dev), d0 - 16 * u0,
            torch.from_numpy(maintree_len[:NMAIN].copy()).to(dev),
            torch.from_numpy(length_len[:LENSYMS].copy()).to(dev),
            torch.from_numpy(al_lens).to(dev), aligned, length_empty,
            blen_eff, o, U=(S + 4) // 2, F=F, DELTA=is_delta)
        ok = bool(ok)
        add_ms(timings, "phase_a_ms", t0)
        if not ok:
            raise NeedFallback("device block decode failed")
        # at the final frame boundary the walk's realign (+ DELTA chunk
        # skip) may step 16+16 bits past the stream's last data bit
        slack = 32 if (o + blen_eff) >= out_len else 0
        end_rel = int(end_rel)
        if end_rel > 8 * len(sl) + slack:
            # tokens near the slice end were decoded from zero padding
            raise NeedFallback("block overran its slice")
        rdr.pos = 16 * u0 + end_rel
        parts.append((t_kind, t_outlen, t_dist, t_slot, t_lit,
                      torch.zeros((F * R_TOK, 2), dtype=torch.int32,
                                  device=dev)))
        o += blen_eff

    # assemble the flat token stream, padded to a power of two with dead
    # rows
    cols = [torch.cat([p[c] for p in parts]) for c in range(6)]
    T = cols[0].shape[0]
    padn = max(256, 1 << max(0, T - 1).bit_length()) - T
    if padn:
        cols[0] = torch.cat([cols[0], cols[0].new_full((padn,), 3)])
        cols[1:5] = [torch.cat([c, c.new_zeros(padn)]) for c in cols[1:5]]
        cols[5] = torch.cat([cols[5], cols[5].new_zeros((padn, 2))])

    t0 = time.perf_counter()
    out, ok = _phase_b(*cols, torch.from_numpy(base).to(dev), 1 << wb, rl,
                       N, S0)
    if not ok:
        raise NeedFallback("phase B validity check failed")
    result = out[S0 : S0 + out_len].cpu().numpy()
    add_ms(timings, "phase_b_ms", t0)

    if first_e8_frame is not None and filesize:
        t0 = time.perf_counter()
        result = e8_untransform(result.tobytes(), filesize, first_e8_frame)
        add_ms(timings, "e8_ms", t0)
        return result
    return result.tobytes()


def e8_untransform(data: bytes, filesize: int, first_frame: int = 0) -> bytes:
    """The E8 call translation undone per 32 KiB frame of a whole stream's
    bytes, from frame ``first_frame`` on (reference lzxd.c:706-733: frames
    past 32768 and frames of 10 bytes or fewer are left as they are)."""
    out = bytearray(data)
    nframes = (len(out) + FRAME_SIZE - 1) // FRAME_SIZE
    for f in range(first_frame, min(nframes, 32768)):
        fo = f * FRAME_SIZE
        fsz = min(FRAME_SIZE, len(out) - fo)
        if fsz > 10:
            out[fo : fo + fsz] = _e8_transform(bytearray(out[fo : fo + fsz]),
                                               fo, filesize)
    return bytes(out)


def _pseudo_rows(raw_len: int, first_byte: int, r0: int, r1: int, r2: int,
                 dev):
    """One kind-2 R-reset row followed by one kind-0 raw-run row."""
    def t(vals, dtype):
        # numpy's conversion, as the JAX op's: a stored R above 2^31 - 1
        # raises OverflowError there too
        return torch.from_numpy(np.array(vals, dtype)).to(dev)
    return (t([2, 0], np.int8), t([0, raw_len], np.int32),
            t([r0, 0], np.int32), t([0, 0], np.int8),
            t([0, first_byte], np.uint8), t([[r1, r2], [0, 0]], np.int32))
