"""MSZIP compressor (compress path).

The reference ships no MSZIP compressor (reference: mszipc.c is a
stub). Each 32 KiB frame becomes a 'CK'-prefixed raw deflate stream
(format pinned by the reference *decoder*, mszipd.c:91-219). History
is carried across frames: the matcher window spans the previous frame,
so matches reach back exactly as the format allows.

The deflate entropy coder is the project's own: hash-chain matcher
with one-symbol lazy evaluation, package-merge length-limited Huffman
trees (shared with the LZX encoder), code-length-code RLE (16/17/18),
and per-frame fixed/dynamic/stored block choice by measured bit cost.
No zlib.

Copied from ``libmspack_tpu/compress/mszip_c.py`` so that the port imports nothing
of the JAX package; the copy differs in nothing else.
"""
from __future__ import annotations

from .lzx_e import make_lengths, canonical_codes, _Matcher

FRAME_SIZE = 32768

# deflate length codes 257..285: (base, extra_bits)
_LEN_BASE = []
_LEN_EXTRA = []
for _c in range(29):
    if _c < 8:
        _LEN_BASE.append(_c + 3)
        _LEN_EXTRA.append(0)
    elif _c < 28:
        _e = (_c - 4) >> 2
        _LEN_BASE.append(((4 + (_c & 3)) << _e) + 3)
        _LEN_EXTRA.append(_e)
    else:
        _LEN_BASE.append(258)
        _LEN_EXTRA.append(0)

_DIST_BASE = []
_DIST_EXTRA = []
for _c in range(30):
    if _c < 2:
        _DIST_BASE.append(_c + 1)
        _DIST_EXTRA.append(0)
    else:
        _e = (_c >> 1) - 1
        _DIST_BASE.append(((2 + (_c & 1)) << _e) + 1)
        _DIST_EXTRA.append(_e)

_BITLEN_ORDER = (16, 17, 18, 0, 8, 7, 9, 6, 10, 5,
                 11, 4, 12, 3, 13, 2, 14, 1, 15)

_FIXED_LIT_LENS = [8] * 144 + [9] * 112 + [7] * 24 + [8] * 8
_FIXED_DIST_LENS = [5] * 30


def _len_code(length: int) -> int:
    """length 3..258 -> deflate length code index 0..28."""
    if length == 258:
        return 28
    lo, hi = 0, 27
    while lo < hi:
        mid = (lo + hi + 1) // 2
        if _LEN_BASE[mid] <= length:
            lo = mid
        else:
            hi = mid - 1
    return lo


def _dist_code(dist: int) -> int:
    lo, hi = 0, 29
    while lo < hi:
        mid = (lo + hi + 1) // 2
        if _DIST_BASE[mid] <= dist:
            lo = mid
        else:
            hi = mid - 1
    return lo


class _LsbWriter:
    """LSB-first bit accumulator (deflate bit order)."""

    def __init__(self):
        self.out = bytearray()
        self.acc = 0
        self.nbits = 0

    def bits(self, value: int, n: int) -> None:
        self.acc |= (value & ((1 << n) - 1)) << self.nbits
        self.nbits += n
        while self.nbits >= 8:
            self.out.append(self.acc & 0xFF)
            self.acc >>= 8
            self.nbits -= 8

    def code(self, code: int, length: int) -> None:
        """Huffman code: deflate stores codes MSB-of-code-first, i.e.
        bit-reversed in the LSB stream."""
        rev = 0
        for _ in range(length):
            rev = (rev << 1) | (code & 1)
            code >>= 1
        self.bits(rev, length)

    def flush(self) -> bytes:
        if self.nbits:
            self.out.append(self.acc & 0xFF)
            self.acc = 0
            self.nbits = 0
        return bytes(self.out)


def _tokenize(buf: bytes, start: int, end: int,
              max_chain: int = 128) -> list:
    """Lazy hash-chain LZ77 over buf[start:end]; history = buf[:start].
    Tokens: (0, byte) | (1, length, dist)."""
    m = _Matcher(buf, max_chain=max_chain)
    for p in range(max(0, start - FRAME_SIZE), start):
        m.insert(p)
    toks = []
    pos = start
    pend = None  # pending (length, dist) from lazy evaluation
    while pos < end:
        ln, dist = m.longest(pos, end, 32768, 258)
        if pend is not None:
            pl, pd = pend
            if ln > pl:
                # the previous position does better as a literal
                toks.append((0, buf[pos - 1]))
                pend = (ln, dist)
                m.insert(pos)
                pos += 1
                continue
            # commit the pending match
            toks.append((1, pl, pd))
            stop = min(pos - 1 + pl, end)
            while pos < stop:
                m.insert(pos)
                pos += 1
            pend = None
            continue
        if ln >= 3:
            if ln < 32 and pos + 1 < end:
                pend = (ln, dist)
                m.insert(pos)
                pos += 1
                continue
            toks.append((1, ln, dist))
            stop = min(pos + ln, end)
            while pos < stop:
                m.insert(pos)
                pos += 1
        else:
            toks.append((0, buf[pos]))
            m.insert(pos)
            pos += 1
    if pend is not None:
        toks.append((1, pend[0], pend[1]))
    return toks


def _emit_body(w: _LsbWriter, toks, lit_codes, lit_lens,
               dist_codes, dist_lens) -> None:
    for t in toks:
        if t[0] == 0:
            w.code(lit_codes[t[1]], lit_lens[t[1]])
        else:
            _, ln, dist = t
            lc = _len_code(ln)
            sym = 257 + lc
            w.code(lit_codes[sym], lit_lens[sym])
            if _LEN_EXTRA[lc]:
                w.bits(ln - _LEN_BASE[lc], _LEN_EXTRA[lc])
            dc = _dist_code(dist)
            w.code(dist_codes[dc], dist_lens[dc])
            if _DIST_EXTRA[dc]:
                w.bits(dist - _DIST_BASE[dc], _DIST_EXTRA[dc])
    w.code(lit_codes[256], lit_lens[256])


def _body_cost(toks, lit_lens, dist_lens) -> int:
    cost = lit_lens[256]
    for t in toks:
        if t[0] == 0:
            if lit_lens[t[1]] == 0:
                return 1 << 30
            cost += lit_lens[t[1]]
        else:
            lc = _len_code(t[1])
            dc = _dist_code(t[2])
            ll = lit_lens[257 + lc]
            dl = dist_lens[dc]
            if ll == 0 or dl == 0:
                return 1 << 30
            cost += ll + _LEN_EXTRA[lc] + dl + _DIST_EXTRA[dc]
    return cost


def _cl_ops_iter(all_lens) -> list:
    ops = []
    i = 0
    n = len(all_lens)
    while i < n:
        v = all_lens[i]
        run = 1
        while i + run < n and all_lens[i + run] == v:
            run += 1
        total = run
        if v == 0:
            while run >= 11:
                take = min(run, 138)
                ops.append((18, take - 11, 7))
                run -= take
            if run >= 3:
                ops.append((17, run - 3, 3))
                run = 0
            for _ in range(run):
                ops.append((0, 0, 0))
        else:
            ops.append((v, 0, 0))
            run -= 1
            while run >= 3:
                take = min(run, 6)
                ops.append((16, take - 3, 2))
                run -= take
            for _ in range(run):
                ops.append((v, 0, 0))
        i += total
    return ops


def _deflate_frame(buf: bytes, start: int, end: int) -> bytes:
    """One final deflate block covering buf[start:end] with history
    buf[:start]; picks stored/fixed/dynamic by measured bit cost."""
    chunk = buf[start:end]
    toks = _tokenize(buf, start, end)

    # frequencies
    lfreq = [0] * 288
    dfreq = [0] * 30
    lfreq[256] = 1
    for t in toks:
        if t[0] == 0:
            lfreq[t[1]] += 1
        else:
            lfreq[257 + _len_code(t[1])] += 1
            dfreq[_dist_code(t[2])] += 1

    dyn_lit = make_lengths(lfreq, 15)
    dyn_dist = make_lengths(dfreq, 15)
    # trim trailing zeros (hlit >= 257, hdist >= 1)
    nlit = max(257, 288 - next((i for i, l in enumerate(
        reversed(dyn_lit)) if l), 288))
    ndist = max(1, 30 - next((i for i, l in enumerate(
        reversed(dyn_dist)) if l), 30))
    all_lens = dyn_lit[:nlit] + dyn_dist[:ndist]
    ops = _cl_ops_iter(all_lens)
    clfreq = [0] * 19
    for sym, _, _ in ops:
        clfreq[sym] += 1
    cl_lens = make_lengths(clfreq, 7)
    ncl = 19
    while ncl > 4 and cl_lens[_BITLEN_ORDER[ncl - 1]] == 0:
        ncl -= 1
    hdr_cost = 5 + 5 + 4 + 3 * ncl + sum(
        cl_lens[sym] + ne for sym, _, ne in ops)
    dyn_cost = 3 + hdr_cost + _body_cost(toks, dyn_lit, dyn_dist)
    fix_cost = 3 + _body_cost(toks, _FIXED_LIT_LENS, _FIXED_DIST_LENS)
    sto_cost = 3 + 16 + 16 + 8 * len(chunk) + 7  # + worst-case align

    w = _LsbWriter()
    if sto_cost < min(dyn_cost, fix_cost):
        w.bits(1, 1)
        w.bits(0, 2)
        # align to byte
        if w.nbits:
            w.bits(0, 8 - w.nbits)
        w.bits(len(chunk), 16)
        w.bits(len(chunk) ^ 0xFFFF, 16)
        out = w.flush() + chunk
        return out
    if fix_cost <= dyn_cost:
        w.bits(1, 1)
        w.bits(1, 2)
        lit_lens, dist_lens = _FIXED_LIT_LENS, _FIXED_DIST_LENS
        lit_codes = canonical_codes(lit_lens)
        dist_codes = canonical_codes(dist_lens)
    else:
        w.bits(1, 1)
        w.bits(2, 2)
        w.bits(nlit - 257, 5)
        w.bits(ndist - 1, 5)
        w.bits(ncl - 4, 4)
        for k in range(ncl):
            w.bits(cl_lens[_BITLEN_ORDER[k]], 3)
        cl_codes = canonical_codes(cl_lens)
        for sym, extra, nextra in ops:
            w.code(cl_codes[sym], cl_lens[sym])
            if nextra:
                w.bits(extra, nextra)
        lit_lens, dist_lens = dyn_lit, dyn_dist
        lit_codes = canonical_codes(lit_lens)
        dist_codes = canonical_codes(dist_lens)
    _emit_body(w, toks, lit_codes, lit_lens, dist_codes, dist_lens)
    return w.flush()


def compress_frames(data: bytes, level: int = 9,
                    cross_frame_history: bool = True) -> list[bytes]:
    """Split `data` into 32 KiB frames, each deflated independently and
    prefixed with 'CK'. Returns the list of compressed frame payloads
    (one CAB CFDATA block each). `level` kept for API compatibility
    (the matcher always runs deep chains). Auto-routes to the native
    C++ encoder (same algorithm, ~100x); this module is the bit-level
    reference implementation."""
    frames = []
    n = len(data)
    if n == 0:
        return []
    from .. import native
    nf = native.deflate_frames(data, cross_frame_history)
    if nf is not None:
        return nf
    for i in range(0, n, FRAME_SIZE):
        end = min(i + FRAME_SIZE, n)
        if cross_frame_history:
            payload = _deflate_frame(data, i, end)
        else:
            chunk = data[i:end]
            payload = _deflate_frame(chunk, 0, len(chunk))
        frames.append(b"CK" + payload)
    return frames


def compress_kwaj(data: bytes, level: int = 9) -> bytes:
    """KWAJ method-4 body: 16-bit-length-prefixed CK frames, 0 ends
    (reference: mszipd.c:462-495)."""
    out = bytearray()
    for frame in compress_frames(data, level, cross_frame_history=False):
        out += len(frame).to_bytes(2, "little")
        out += frame
    out += b"\x00\x00"
    return bytes(out)
