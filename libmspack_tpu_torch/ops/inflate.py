"""Batched speculative inflate as tensor ops: CAB-MSZIP's ``engine="torch"``.

PyTorch counterpart of ``libmspack_tpu/ops/inflate_jax.py``, the XLA-level
inflate of the JAX package (its ``engine="jax"``). The scalar decoder
(codecs/mszip.py <- reference mszipd.c) advances one bit cursor through
one stream; here (SURVEY.md §7, rapidgzip-style speculation, exact
because frame starts are known):

Phase A, per deflate block, fully vectorized:
  1. the host parses the tiny block header (fixed/dynamic code lengths)
     and builds 15-bit flat decode LUTs (numpy);
  2. the device evaluates THE WHOLE DECODE STEP AT EVERY BIT POSITION of
     the stream at once: literal/length symbol, length extra bits,
     distance symbol, distance extra bits -> (next position, kind,
     byte/length/distance);
  3. the true symbol chain is the orbit of the block's start position
     under next-position: linked with jump-table pointer doubling and
     rank decomposition (log2 rounds of gathers);
  4. gathering the per-position fields at the chain positions yields the
     ordered token stream.

Phase B: the tokens of all frames of a folder become per-byte source
pointers (MSZIP history crosses frame boundaries through the 32 KiB
window) and resolve by pointer doubling.

Any stream the fast path cannot prove it decoded exactly (an invalid
symbol on the chain, too many blocks, a length overrun) raises
``NeedFallback``; ``inflate_folder`` then returns None and the caller's
scalar codec reproduces the reference's exact error and repair semantics.
Each decline's ``reason`` is one of ``DECLINE_REASONS``, the JAX op's
texts without their frame numbers.

The JAX op pads frames and batches to the buckets ``S_BUCKETS`` and
``B_BUCKETS`` so that it compiles once per bucket; the buckets are kept
here because a frame beyond the largest declines. Out-of-range word reads
at the top bit positions read 0xFFFFFFFF, as ``jnp.take`` fills them.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from .._device import resolve_device
from ..codecs.mszip import (BITLEN_ORDER, DIST_EXTRABITS, DIST_OFFSETS,
                            FIXED_DISTANCE_LENS, FIXED_LITERAL_LENS,
                            LIT_EXTRABITS, LIT_LENGTHS)
from .bitview import U32_FILL, bitrev_table
from .match_resolve import point_roots, scatter_max_marks

__all__ = ["NeedFallback", "inflate_folder", "DECLINE_REASONS",
           "S_BUCKETS", "B_BUCKETS", "MAX_TOKENS"]

FRAME_SIZE = 32768
MAX_TOKENS = FRAME_SIZE + 8   # >= one output byte per token, plus EOB slack

# stream-size buckets (bytes): 40960 covers the largest legal CAB MSZIP
# block (32768 + 12 growth); frames per phase-A batch
S_BUCKETS = (1024, 40960)
B_BUCKETS = (1, 4, 16, 64)

# a minimal valid deflate stream (fixed-huffman, empty) used to pad
# batches
_EMPTY_STREAM = b"\x03\x00"

_LIT_BASE = np.asarray(LIT_LENGTHS, np.int32)
_LIT_EXTRA = np.asarray(LIT_EXTRABITS, np.int32)
_DIST_BASE = np.asarray(DIST_OFFSETS, np.int32)
_DIST_EXTRA = np.asarray(DIST_EXTRABITS, np.int32)

DECLINE_REASONS = (
    "header ran past stream end", "over-subscribed huffman code",
    "truncated stored block", "stored length complement mismatch",
    "truncated stored payload", "bad block type", "too many symbols",
    "bad bitlen symbol", "bitlen RLE overrun", "beyond largest bucket",
    "invalid symbol on chain", "too many deflate blocks per frame",
    "overflows 32k", "length != expected",
    "folder too large for single-pass resolve",
    "match distance before folder start")


class NeedFallback(Exception):
    """Raised when a stream needs the scalar decoder. ``reason`` is the
    message without the frame number or size it names."""

    def __init__(self, message: str, reason: str | None = None):
        super().__init__(message)
        self.reason = reason or message


# ---------------------------------------------------------------------------
# host side: header parsing + LUT construction
# ---------------------------------------------------------------------------

class _HostBits:
    """Minimal LSB bit reader over a bytes object for header parsing."""

    __slots__ = ("data", "pos")

    def __init__(self, data: bytes, bitpos: int = 0):
        self.data = data
        self.pos = bitpos

    def read(self, n: int) -> int:
        p = self.pos
        if n == 0:
            return 0
        byte = p >> 3
        chunk = self.data[byte : byte + 4]
        if len(chunk) < 4:
            chunk = chunk + b"\x00" * (4 - len(chunk))
            if byte >= len(self.data) + 2:
                raise NeedFallback("header ran past stream end")
        word = int.from_bytes(chunk, "little")
        self.pos = p + n
        return (word >> (p & 7)) & ((1 << n) - 1)


_BITREV = {}


def _bitrev_arr(nbits):
    if nbits not in _BITREV:
        _BITREV[nbits] = bitrev_table(nbits)
    return _BITREV[nbits]


def _canonical_codes(lens: np.ndarray):
    """RFC1951 canonical code assignment; returns codes (same shape)."""
    maxb = 15
    bl_count = np.bincount(lens, minlength=maxb + 1)
    bl_count[0] = 0
    next_code = np.zeros(maxb + 2, np.int64)
    code = 0
    for b in range(1, maxb + 1):
        code = (code + int(bl_count[b - 1])) << 1
        next_code[b] = code
    codes = np.zeros(len(lens), np.int64)
    for sym in range(len(lens)):
        L = lens[sym]
        if L:
            codes[sym] = next_code[L]
            next_code[L] += 1
    return codes


def _build_lut15(lens: np.ndarray, kind: str = "lit") -> np.ndarray:
    """15-bit LSB-indexed decode LUT with the symbol's whole decode recipe
    packed into one int32 entry (so phase A needs one gather per tree):

    lit entry:  bits 0-3 codelen | 4-12 sym | 13-15 len_extra_bits |
                16-24 len_base
    dist entry: bits 0-3 codelen | 4-8 dsym | 9-12 dist_extra_bits |
                13-27 dist_base
    -1 = invalid. Over-subscribed code -> NeedFallback (the scalar path
    reproduces the reference error)."""
    lens = np.asarray(lens, np.int64)
    kraft = np.sum((lens > 0) * (1 << (15 - np.maximum(lens, 1))))
    if kraft > (1 << 15):
        raise NeedFallback("over-subscribed huffman code")
    codes = _canonical_codes(lens)
    lut = np.full(1 << 15, -1, np.int32)
    for sym in range(len(lens)):
        L = int(lens[sym])
        if L == 0:
            continue
        if kind == "lit":
            if 257 <= sym <= 285:
                c = sym - 257
                entry = (L | (sym << 4) | (int(_LIT_EXTRA[c]) << 13)
                         | (int(_LIT_BASE[c]) << 16))
            elif sym <= 256:
                entry = L | (sym << 4)
            else:
                continue  # 286/287: leave invalid (reference errors)
        else:
            if sym >= 30:
                continue  # invalid distance codes
            entry = (L | (sym << 4) | (int(_DIST_EXTRA[sym]) << 9)
                     | (int(_DIST_BASE[sym]) << 13))
        # low L bits of the peeked value = bit-reversed code
        base = int(_bitrev_arr(L)[codes[sym]]) if L else 0
        lut[base :: 1 << L] = entry
    return lut


def _parse_block_header(stream: bytes, bitpos: int):
    """Parse one deflate block header. Returns
    (last_block, 'huff', lit_lut, dist_lut, data_bitpos) for huffman
    blocks, or (last_block, 'stored', payload_range, next_bitpos)."""
    bits = _HostBits(stream, bitpos)
    last = bits.read(1)
    btype = bits.read(2)
    if btype == 0:
        # stored: align, 4 bytes len/nlen, raw payload
        pos = (bits.pos + 7) & ~7
        byte = pos >> 3
        if byte + 4 > len(stream):
            raise NeedFallback("truncated stored block")
        length = stream[byte] | (stream[byte + 1] << 8)
        comp = stream[byte + 2] | (stream[byte + 3] << 8)
        if length != (~comp & 0xFFFF):
            raise NeedFallback("stored length complement mismatch")
        start = byte + 4
        if start + length > len(stream):
            raise NeedFallback("truncated stored payload")
        return (last, "stored", (start, length), (start + length) * 8)
    if btype == 1:
        lit_lens = np.frombuffer(FIXED_LITERAL_LENS, np.uint8).astype(np.int64)
        dist_lens = np.frombuffer(FIXED_DISTANCE_LENS, np.uint8).astype(np.int64)
        return (last, "huff", _build_lut15(lit_lens, "lit"),
                _build_lut15(dist_lens, "dist"), bits.pos)
    if btype != 2:
        raise NeedFallback("bad block type")

    lit_codes = bits.read(5) + 257
    dist_codes = bits.read(5) + 1
    bitlen_codes = bits.read(4) + 4
    if lit_codes > 288 or dist_codes > 32:
        raise NeedFallback("too many symbols")
    bl_len = np.zeros(19, np.int64)
    for i in range(bitlen_codes):
        bl_len[BITLEN_ORDER[i]] = bits.read(3)
    bl_lut = _build_lut15(bl_len)

    total = lit_codes + dist_codes
    lens = np.zeros(total, np.int64)
    last_code = 0
    i = 0
    while i < total:
        e = int(bl_lut[bits.read(7) & 0x7F])
        if e < 0:
            raise NeedFallback("bad bitlen symbol")
        # we read 7 bits but the code is shorter: rewind the difference
        clen, code = e & 0xF, (e >> 4) & 0x1FF
        bits.pos -= 7 - clen
        if code < 16:
            lens[i] = last_code = code
            i += 1
            continue
        if code == 16:
            run, fill = bits.read(2) + 3, last_code
        elif code == 17:
            run, fill = bits.read(3) + 3, 0
        else:
            run, fill = bits.read(7) + 11, 0
        if i + run > total:
            raise NeedFallback("bitlen RLE overrun")
        lens[i : i + run] = fill
        i += run
    return (last, "huff", _build_lut15(lens[:lit_codes], "lit"),
            _build_lut15(lens[lit_codes:], "dist"), bits.pos)


# ---------------------------------------------------------------------------
# device side: speculative decode of one batch of huffman block bodies
# ---------------------------------------------------------------------------

def _phase_a(data, start_bits, lit_lut, dist_lut, P: int, R: int, S: int):
    """Speculative decode of B huffman block bodies.

    data: (B*S,) uint8 padded streams; start_bits: (B,) ints;
    lit_lut/dist_lut: (B, 32768) int32, all on one device.
    Returns per-rank token arrays (B, R): kind (0 lit/1 match/2 end/
    3 invalid), outlen, dist (int32), lit (uint8); plus (B,) end bit
    positions, chain-invalid flags and reached-end flags."""
    dev = data.device
    B = start_bits.shape[0]
    NP = B * P

    ar = torch.arange(NP, device=dev)
    blk = ar // P
    p = ar % P

    # 96-bit window: three 32-bit words from the byte stream, so every bit
    # field of a full decode step (<=48 bits past p) comes from 3 word
    # gathers and shifts; reads past the batch end give 0xFFFFFFFF
    by = data.reshape(-1, 4).to(torch.int64)
    words = by[:, 0] | (by[:, 1] << 8) | (by[:, 2] << 16) | (by[:, 3] << 24)
    words = torch.cat([words, words.new_full((2,), U32_FILL)])
    wbase = blk * (S // 4) + (p >> 5)
    w0 = words[wbase]
    w1 = words[wbase + 1]
    w2 = words[wbase + 2]
    del wbase
    q0 = p & 31

    def extract(rel, nbits):
        """bits [p+rel, p+rel+nbits) of the stream, as uint32 shifts."""
        k = q0 + rel
        hiword = k >= 32
        a = torch.where(hiword, w1, w0)
        b = torch.where(hiword, w2, w1)
        kk = k & 31
        lo = (a >> kk) | torch.where(kk > 0, (b << (32 - kk)) & 0xFFFFFFFF,
                                     torch.zeros_like(b))
        return lo & ((1 << nbits) - 1)

    lit_flat = lit_lut.reshape(-1).to(torch.int64)
    dist_flat = dist_lut.reshape(-1).to(torch.int64)

    e1 = lit_flat[blk * 32768 + extract(0, 15)]
    n1 = e1 & 0xF
    sym = (e1 >> 4) & 0x1FF
    bad1 = e1 < 0

    is_lit = (sym < 256) & ~bad1
    is_match = (sym > 256) & ~bad1
    lext = (e1 >> 13) & 0x7
    lenv = ((e1 >> 16) & 0x1FF) + (extract(n1, 5) & ((1 << lext) - 1))
    p3 = p + n1 + lext

    e2 = dist_flat[blk * 32768 + extract(n1 + lext, 15)]
    n2 = e2 & 0xF
    bad2 = is_match & (e2 < 0)
    dext = (e2 >> 9) & 0xF
    dist = ((e2 >> 13) & 0x7FFF) + (extract(n1 + lext + n2, 13)
                                    & ((1 << dext) - 1))
    p4 = p3 + n2 + dext
    del w0, w1, w2, e2

    invalid = (bad1
               | (is_match & (bad2 | (p4 > P)))
               | (is_lit & ((p + n1) > P)))
    nxt = torch.where(is_lit, p + n1, torch.where(is_match, p4, p))
    nxt = torch.where(invalid, p, nxt).clamp(0, P - 1)

    outlen = torch.where(is_lit, 1, torch.where(is_match, lenv, 0))
    outlen = torch.where(invalid, 0, outlen)
    kind = torch.where(is_lit, 0, torch.where(is_match, 1, 2))
    kind = torch.where(invalid, 3, kind)

    # global-index jump tables
    nxt_flat = blk * P + nxt
    n_doublings = max(1, R - 1).bit_length()
    jumps = [nxt_flat]
    for _ in range(n_doublings - 1):
        jumps.append(jumps[-1][jumps[-1]])

    ranks = torch.arange(R, device=dev)
    # (B, R) chain positions
    pos = (torch.arange(B, device=dev)[:, None] * P
           + start_bits.to(dev, torch.int64).clamp(0, P - 1)[:, None])
    pos = pos.expand(B, R).reshape(-1)
    rk = ranks[None, :].expand(B, R).reshape(-1)
    for k in range(n_doublings):
        bit = (rk >> k) & 1
        pos = torch.where(bit == 1, jumps[k][pos], pos)
    del jumps

    t_kind = kind[pos].reshape(B, R).to(torch.int32)
    t_outlen = outlen[pos].reshape(B, R).to(torch.int32)
    t_dist = dist[pos].reshape(B, R).to(torch.int32)
    t_lit = (sym[pos] & 0xFF).reshape(B, R).to(torch.uint8)

    # bit position AFTER the EOB code (the next deflate block header
    # starts there): the chain sticks AT the EOB position, so add its
    # huffman code length
    last_pos = pos.reshape(B, R)[:, R - 1]
    end_pos = (last_pos - torch.arange(B, device=dev) * P + n1[last_pos])
    chain_invalid = (t_kind == 3).any(dim=1)
    reached_end = (t_kind == 2).any(dim=1)
    return (t_kind, t_outlen, t_dist, t_lit, end_pos.to(torch.int32),
            chain_invalid, reached_end)


# ---------------------------------------------------------------------------
# folder-level assembly (phase B)
# ---------------------------------------------------------------------------

def _phase_b(t_kind, t_outlen, t_dist, t_lit, frame_base, N: int):
    """Expand folder-ordered tokens into bytes.

    t_*: (B, R) token arrays in frame order; frame_base: (B,) output
    offset of each frame. N: output buffer size (>= total). Returns
    (bytes (N,) uint8, whether a root lies before the folder)."""
    dev = t_kind.device
    B, R = t_kind.shape
    live = (t_kind == 0) | (t_kind == 1)
    tlen = torch.where(live, t_outlen, 0).to(torch.int64)
    within = torch.cumsum(tlen, dim=1) - tlen
    out_start = (frame_base.to(dev, torch.int64)[:, None] + within).reshape(-1)
    flat_len = tlen.reshape(-1)

    T = B * R
    marks = scatter_max_marks(
        N + 1, torch.where(flat_len > 0, out_start.clamp(0, N), N),
        torch.arange(T, device=dev) + 1)
    tok_id = (torch.cummax(marks[:N], 0).values - 1).clamp(0, T - 1)

    bpos = torch.arange(N, device=dev)
    k = t_kind.reshape(-1)[tok_id]
    d = t_dist.reshape(-1)[tok_id].to(torch.int64)
    lit = t_lit.reshape(-1)[tok_id]
    root = point_roots(torch.where(k == 0, bpos, bpos - d), N)
    out = lit[root.clamp(0, N - 1)]
    return out, bool((root < 0).any())


# ---------------------------------------------------------------------------
# public entry
# ---------------------------------------------------------------------------

def add_ms(timings, name: str, t0: float) -> None:
    """Add the host-clock milliseconds since ``t0`` to ``timings[name]``
    (a dict, or None to skip)."""
    if timings is not None:
        timings[name] = timings.get(name, 0.0) + \
            (time.perf_counter() - t0) * 1e3


def inflate_folder(frames: list[bytes], expected_sizes: list[int] | None = None,
                   *, device="cuda", declines=None,
                   timings=None) -> bytes | None:
    """Decode one CAB-MSZIP folder's deflate streams (CK already stripped)
    on ``device``. Returns the folder's bytes, or None if any frame needs
    the scalar fallback; ``declines`` (a Counter), when given, counts the
    decline's reason, and ``timings`` (a dict) adds ``phase_a_ms`` and
    ``phase_b_ms``: the host clock around each phase's device work and the
    copy back that waits for it."""
    if not frames:
        return b""
    try:
        return _inflate_folder(frames, expected_sizes,
                               resolve_device(device), timings)
    except NeedFallback as e:
        if declines is not None:
            declines[e.reason] += 1
        return None


def _bucket(v, buckets):
    for b in buckets:
        if v <= b:
            return b
    raise NeedFallback(f"size {v} beyond largest bucket",
                       "beyond largest bucket")


def _inflate_folder(frames, expected_sizes, dev, timings=None):
    B = len(frames)
    S = _bucket(max(len(f) for f in frames) + 8, S_BUCKETS)
    P = S * 8

    data = np.zeros((B, S), np.uint8)
    for i, f in enumerate(frames):
        data[i, : len(f)] = np.frombuffer(f, np.uint8)

    # token accumulators per frame: lists of (kind, outlen, dist, lit)
    all_tokens = [[] for _ in range(B)]
    pending = {i: 0 for i in range(B)}   # frame -> current bitpos

    max_rounds = 64
    for _ in range(max_rounds):
        # parse headers for all pending frames
        todo = []
        for i in list(pending):
            last, kindh, *rest = _parse_block_header(frames[i], pending[i])
            if kindh == "stored":
                (start, length), nxt = rest
                # stored payload as one literal run: emit literal tokens
                all_tokens[i].append((np.zeros(length, np.int32),
                                      np.ones(length, np.int32),
                                      np.zeros(length, np.int32),
                                      data[i, start : start + length].copy()))
                if last:
                    del pending[i]
                else:
                    pending[i] = nxt
                continue
            lit_lut, dist_lut, data_bitpos = rest
            todo.append((i, last, lit_lut, dist_lut, data_bitpos))
        if not todo:
            break

        # phase A over the round's batch in chunks of at most B_BUCKETS[-1]
        # frames, each padded to its bucket
        maxb = B_BUCKETS[-1]
        for c0 in range(0, len(todo), maxb):
            chunk = todo[c0 : c0 + maxb]
            bb = _bucket(len(chunk), B_BUCKETS)
            chunk_p = chunk + [chunk[0]] * (bb - len(chunk))
            idxs = [t[0] for t in chunk_p]
            lit_luts = torch.from_numpy(np.stack([t[2] for t in chunk_p]))
            dist_luts = torch.from_numpy(np.stack([t[3] for t in chunk_p]))
            starts = torch.tensor([t[4] for t in chunk_p], dtype=torch.int64)
            sub = torch.from_numpy(data[idxs].reshape(-1))

            t0 = time.perf_counter()
            out = _phase_a(sub.to(dev), starts.to(dev), lit_luts.to(dev),
                           dist_luts.to(dev), P, MAX_TOKENS, S)
            (t_kind, t_outlen, t_dist, t_lit, end_pos, chain_inv,
             reached) = (t.cpu().numpy() for t in out)
            add_ms(timings, "phase_a_ms", t0)

            for j, (i, last, *_r) in enumerate(chunk):
                if chain_inv[j] or not reached[j]:
                    raise NeedFallback(f"frame {i}: invalid symbol on chain",
                                       "invalid symbol on chain")
                mask = (t_kind[j] == 0) | (t_kind[j] == 1)
                all_tokens[i].append((t_kind[j][mask], t_outlen[j][mask],
                                      t_dist[j][mask], t_lit[j][mask]))
                if last:
                    del pending[i]
                else:
                    pending[i] = int(end_pos[j])
    if pending:
        raise NeedFallback("too many deflate blocks per frame")

    # flatten per-frame token lists, compute frame lengths
    frame_lens = []
    ks, os_, ds, ls = [], [], [], []
    for i in range(B):
        if all_tokens[i]:
            k, o, d, lt = (np.concatenate([t[c] for t in all_tokens[i]])
                           for c in range(4))
        else:
            k, o, d = (np.zeros(0, np.int32) for _ in range(3))
            lt = np.zeros(0, np.uint8)
        flen = int(o.sum())
        if flen > FRAME_SIZE:
            raise NeedFallback(f"frame {i} overflows 32k", "overflows 32k")
        if expected_sizes is not None and flen != expected_sizes[i]:
            raise NeedFallback(f"frame {i} length {flen} != expected",
                               "length != expected")
        frame_lens.append(flen)
        ks.append(k)
        os_.append(o)
        ds.append(d)
        ls.append(lt)

    total = sum(frame_lens)
    if total == 0:
        return b""

    # pad token arrays to a common power-of-two R
    R = max(max(len(k) for k in ks), 1)
    R = max(1 << (R - 1).bit_length(), 256)
    tk = np.full((B, R), 2, np.int32)
    to = np.zeros((B, R), np.int32)
    td = np.zeros((B, R), np.int32)
    tl = np.zeros((B, R), np.uint8)
    for i in range(B):
        n = len(ks[i])
        tk[i, :n] = ks[i]
        to[i, :n] = os_[i]
        td[i, :n] = ds[i]
        tl[i, :n] = ls[i]
    base = np.zeros(B, np.int64)
    base[1:] = np.cumsum(frame_lens)[:-1]

    N = max(256, 1 << (total - 1).bit_length())
    if total > (1 << 26):
        # very large folders need a chunked resolver; scalar for now
        raise NeedFallback("folder too large for single-pass resolve")
    t0 = time.perf_counter()
    out, bad_src = _phase_b(*(torch.from_numpy(a).to(dev)
                              for a in (tk, to, td, tl, base)), N)
    if bad_src:
        raise NeedFallback("match distance before folder start")
    out = out[:total].cpu().numpy().tobytes()
    add_ms(timings, "phase_b_ms", t0)
    return out
