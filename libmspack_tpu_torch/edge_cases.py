"""A seeded batch of deflate frames that covers what K1 and K2 must get
right: stored, fixed and dynamic blocks, several blocks in one frame, an
empty frame, length-258 and distance-1 matches, a frame whose matches
reach a whole frame back into the frame before it, and corrupt frames
for every class of error the decoder flags.

Frames come from zlib (raw deflate) and from a small fixed-Huffman writer
here, which can emit what zlib never does (a match 32768 back, distance
code 30). Both the tests and ``chip_smoke.py`` feed this batch to the
kernels and to their plain versions.
"""
from __future__ import annotations

import zlib
from dataclasses import dataclass

import numpy as np

from .ops.cuda_inflate import _DIST_BASE, _DIST_EXTRA, _LEN_BASE, _LEN_EXTRA


@dataclass
class Case:
    name: str
    stream: bytes       # raw deflate, no 'CK'
    hist: int           # history budget: 0, or 32768 after a frame
    raw: bytes | None   # expected output; None for a corrupt frame
    chained: bool = False  # continues the folder of the lane before it


class _BitWriter:
    def __init__(self):
        self.acc = self.n = 0
        self.out = bytearray()

    def bits(self, v, k):
        self.acc |= v << self.n
        self.n += k
        while self.n >= 8:
            self.out.append(self.acc & 0xFF)
            self.acc >>= 8
            self.n -= 8

    def code(self, c, k):
        """A Huffman code, most significant bit first."""
        self.bits(int(format(c, f"0{k}b")[::-1], 2), k)

    def getvalue(self):
        if self.n:
            self.bits(0, 8 - self.n)
        return bytes(self.out)


def _fixed_lit(w, sym):
    if sym < 144:
        w.code(0x30 + sym, 8)
    elif sym < 256:
        w.code(0x190 + sym - 144, 9)
    elif sym < 280:
        w.code(sym - 256, 7)
    else:
        w.code(0xC0 + sym - 280, 8)


def fixed_block(w, tokens, final=1):
    """One fixed-Huffman block. A token is a literal byte (int), a match
    ``(length, distance)``, or ``("dcode", n)``: length 3 with the raw
    distance code n."""
    w.bits(final, 1)
    w.bits(1, 2)
    for t in tokens:
        if isinstance(t, int):
            _fixed_lit(w, t)
            continue
        if t[0] == "dcode":
            _fixed_lit(w, 257)
            w.code(t[1], 5)
            continue
        ln, dist = t
        slot = max(i for i, b in enumerate(_LEN_BASE) if b <= ln)
        _fixed_lit(w, 257 + slot)
        w.bits(ln - _LEN_BASE[slot], _LEN_EXTRA[slot])
        ds = max(i for i, b in enumerate(_DIST_BASE) if b <= dist)
        w.code(ds, 5)
        w.bits(dist - _DIST_BASE[ds], _DIST_EXTRA[ds])
    _fixed_lit(w, 256)


def replay(tokens, hist=b""):
    """The bytes ``fixed_block`` tokens decode to after ``hist``."""
    out = bytearray(hist)
    for t in tokens:
        if isinstance(t, int):
            out.append(t)
        else:
            ln, dist = t
            for _ in range(ln):
                out.append(out[-dist])
    return bytes(out[len(hist):])


def _zlib(raw, level=9, strategy=zlib.Z_DEFAULT_STRATEGY):
    co = zlib.compressobj(level, zlib.DEFLATED, -15, 8, strategy)
    return co.compress(raw) + co.flush()


def _text(rng, n):
    words = [b"cabinet", b"folder", b"frame", b"deflate", b"token",
             b"lane", b"history", b"match", b"literal", b"the", b"of"]
    out = bytearray()
    while len(out) < n:
        out += words[rng.randint(len(words))] + b" "
    return bytes(out[:n])


def _random(rng, n):
    return rng.randint(0, 256, n).astype(np.uint8).tobytes()


def edge_case_batch(frame_size=32768, seed=0, variants=1):
    """The cases, in lane order. ``variants`` repeats the zlib frames
    with fresh data (the smoke run uses about 32 frames)."""
    rng = np.random.RandomState(seed)
    F = frame_size
    cases = []
    for v in range(variants):
        multi = zlib.compressobj(6, zlib.DEFLATED, -15)
        a, b = _text(rng, F // 2), _random(rng, F - F // 2)
        cases += [
            Case(f"dynamic{v}", _zlib(t := _text(rng, F)), 0, t),
            Case(f"fixed{v}", _zlib(t := _text(rng, F), 6, zlib.Z_FIXED),
                 0, t),
            Case(f"stored{v}", _zlib(t := _random(rng, F), 0), 0, t),
            Case(f"multi_block{v}",
                 multi.compress(a) + multi.flush(zlib.Z_FULL_FLUSH)
                 + multi.compress(b) + multi.flush(), 0, a + b),
            Case(f"rle{v}", _zlib(t := bytes([7 + v]) * F), 0, t),
        ]
    # a chained pair: every match of the second frame reaches F back
    prev = _text(rng, F)
    toks = [(258, F)] * max(1, F // 516) + [ord("x"), (258, 1)]
    toks += list(_random(rng, 64))
    w = _BitWriter()
    fixed_block(w, toks)
    cases += [Case("chain_head", _zlib(prev, 6), 0, prev),
              Case("hist_reach", w.getvalue(), 32768, replay(toks, prev),
                   chained=True),
              Case("empty", b"\x01\x00\x00\xff\xff", 0, b"")]
    # corrupt frames: one per class of error
    bad = {}
    bad["block_type3"] = b"\x07"
    w = _BitWriter()
    fixed_block(w, [97, 98, 99, ("dcode", 30)])
    bad["distance_code30"] = w.getvalue()
    w = _BitWriter()
    fixed_block(w, [97, 98, 99, (4, 10)])
    bad["distance_beyond_history"] = w.getvalue()
    w = _BitWriter()
    w.bits(1, 1)
    w.bits(2, 2)
    w.bits(0, 5)
    w.bits(0, 5)
    w.bits(15, 4)
    for _ in range(19):
        w.bits(1, 3)  # 19 codes of length 1: over-subscribed
    bad["oversubscribed_table"] = w.getvalue()
    bad["stored_len_nlen"] = b"\x01\x05\x00\x05\x00" + b"hello"
    w = _BitWriter()
    fixed_block(w, list(_text(rng, 200)))
    s = w.getvalue()
    bad["truncated"] = s[:len(s) // 2]
    cases += [Case(k, v, 0, None) for k, v in bad.items()]
    return cases


def folders_of(cases):
    """Valid cases grouped into folders: [(first lane, [lanes])]."""
    out = []
    for i, c in enumerate(cases):
        if c.raw is None:
            continue
        if c.chained and out and out[-1][1][-1] == i - 1:
            out[-1][1].append(i)
        else:
            out.append((i, [i]))
    return out


def resolve_valid(cases, tok, litw, cnt):
    """Resolve every valid folder's trace with the native host resolver.

    tok, litw: int32 numpy ``(L, T)``; cnt: the ``(8, L)`` counts. Returns
    {first lane: bytes or None}; None where phase A flagged a lane or the
    resolver failed."""
    from . import native

    tok = np.ascontiguousarray(tok, np.int32)
    litw = np.ascontiguousarray(litw, np.int32)
    got = {}
    for l0, lanes in folders_of(cases):
        sizes = [len(cases[i].raw) for i in lanes]
        if any(cnt[0, i] != 0 or cnt[1, i] != sizes[k]
               for k, i in enumerate(lanes)):
            got[l0] = None
            continue
        out = np.zeros(max(sum(sizes), 1), np.uint8)
        r = native.resolve_traces(tok, litw, [l0], [len(lanes)], sizes,
                                  out, [0, sum(sizes)], 1)
        got[l0] = out[:sum(sizes)].tobytes() if r == 0 else None
    return got
