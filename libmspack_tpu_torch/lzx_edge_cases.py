"""A seeded batch of LZX streams that covers what K3 must get right:
verbatim, aligned and uncompressed blocks (one entered after an odd bit
count, one crossing a frame end at an odd byte), an empty LENGTH tree,
multi-frame streams, windows 2^15, 2^16 and 2^21, an intel E8 header, a
ring-window alias on a 2^15 window, a code-length run that crosses each
main-tree part's end, zero-length VERBATIM and ALIGNED blocks, R0-R2 at
or above 2^31 from an uncompressed block, LZX DELTA with reference data
and the long-match escape, DELTA at window 2^25 with matches into the
first bytes of a full-size reference, a stream asked for 0 bytes, and
corrupt streams (bad block type, an over-subscribed pretree, a LENGTH
symbol from an empty tree, an offset beyond the stream, an offset behind
the window wrap and the frame's start, a repeat match of an R0 above
2^31).

``lzx_split_batch`` adds streams for K3's frame split, each with its
frames' CFDATA sizes: blocks that end inside frames, odd uncompressed
blocks across and on frame edges, repeat matches at frame starts, the
E8 header.

Streams come from the port's copy of the encoder (``compress/lzx_e``,
native or Python) and from a small block writer here, which can emit what the encoder
never does: a chosen block type, R0-R2 set by an uncompressed block, a
corrupt tree. Each valid case's bytes are the reference codec's
(``codecs/lzx.py``) on the same stream. The tests and ``chip_smoke.py``
feed this batch to K3 and to its plain version.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .codecs.lzx import LzxDecompressor
from .compress import lzx_e
from .compress.lzx_c import LzxBitWriter
from .errors import MSPackError

FRAME = 32768


@dataclass
class LzxCase:
    name: str
    stream: bytes
    out_len: int
    window_bits: int
    delta: bool = False
    ref: bytes = b""            # DELTA reference data (window tail)
    raw: bytes | None = None    # the reference codec's bytes; None: corrupt
    frame_sizes: list | None = None  # bytes of each frame, as CFDATA


def scalar_decode(stream, out_len, window_bits, delta=False, ref=b""):
    """The reference codec's bytes (E8 applied), or None on its error."""
    pos = [0]

    def rd(n):
        b = stream[pos[0]:pos[0] + n]
        pos[0] += len(b)
        return b

    out = bytearray()
    d = LzxDecompressor(rd, window_bits, 0, out_len, is_delta=delta)
    if ref:
        d.set_reference_data(ref)
    try:
        d.decompress(out_len, out.extend)
    except MSPackError:
        return None
    return bytes(out)


def _write_ops(w, ops):
    """A pretree and the code-length ops of ``lzx_e._len_ops`` after it
    (``lzx_e.write_lens`` for ops made by hand)."""
    freqs = [0] * 20
    for sym, _, _ in ops:
        freqs[sym] += 1
    plens = lzx_e.make_lengths(freqs, lzx_e.PRETREE_LEN_LIMIT)
    pcodes = lzx_e.canonical_codes(plens)
    for p in plens:
        w.write_bits(p, 4)
    for sym, extra, ebits in ops:
        w.write_bits(pcodes[sym], plens[sym])
        if ebits > 0:
            w.write_bits(extra, ebits)


class _Writer:
    """Hand-made LZX streams, block by block. Tokens are the encoder's:
    ``(0, byte)``, ``(1, length, repeat index)``, ``(2, length, dist)``;
    none may cross a 32 KiB frame end, where the writer realigns.
    ``frames`` keeps each frame's first byte, as a CAB writer cuts its
    CFDATA blocks."""

    def __init__(self, window_bits, intel_filesize=0):
        self.w = LzxBitWriter()
        self.enc = lzx_e.LzxEncoder(window_bits)
        self.nmain = 256 + self.enc.num_offsets
        self.prev_main = [0] * self.nmain
        self.prev_len = [0] * lzx_e.NUM_SECONDARY
        self.pos = 0
        self.frames = [0]
        self.w.write_bits(1 if intel_filesize else 0, 1)
        if intel_filesize:
            self.w.write_bits(intel_filesize >> 16, 16)
            self.w.write_bits(intel_filesize & 0xFFFF, 16)

    def _advance(self, n):
        self.pos += n
        if self.pos % FRAME == 0:
            if not self.w.bit_aligned:
                self.w.align16()
            self.frames.append(len(self.w.out))

    def block(self, tokens, aligned=False, empty_length=False,
              zero_length=False, spill=0):
        """One VERBATIM (or ALIGNED) block. ``empty_length`` writes an
        all-zero LENGTH tree whatever the tokens need; ``zero_length``
        writes the trees the tokens need, a length of 0 and no tokens;
        ``spill`` > 0 ends each of the two main-tree parts with a run of
        zeros that goes ``spill`` lengths past the part's end (the
        reference writes them into the lengths that follow, which the next
        part then reads as its previous lengths: lzxd.c:138-183)."""
        fmain, flen, falign, _, _ = self.enc._freqs(tokens)
        mlens = lzx_e.make_lengths(fmain, lzx_e.TREE_LEN_LIMIT)
        llens = ([0] * len(flen) if empty_length
                 else lzx_e.make_lengths(flen, lzx_e.TREE_LEN_LIMIT))
        alens = lzx_e.make_lengths(falign, lzx_e.ALIGNED_LEN_LIMIT)
        if not any(alens):
            alens = [3] * 8
        w = self.w
        w.write_bits(2 if aligned else 1, 3)
        w.write_bits(0 if zero_length
                     else sum(1 if t[0] == 0 else t[1] for t in tokens), 24)
        if aligned:
            for a in alens:
                w.write_bits(a, 3)
        if spill:
            prev = list(self.prev_main) + [0] * spill
            for first, last in ((0, 256), (256, self.nmain)):
                if any(mlens[last - 24:last]):
                    raise ValueError("spill needs 24 unused symbols at the "
                                     "end of each main-tree part")
                ops = lzx_e._len_ops(prev, mlens, first, last - 24)
                ops.append((18, 24 + spill - 20, 5))
                _write_ops(w, ops)
                prev[last:last + spill] = [0] * spill
        else:
            lzx_e.write_lens(w, self.prev_main, mlens, 0, 256)
            lzx_e.write_lens(w, self.prev_main, mlens, 256, self.nmain)
        lzx_e.write_lens(w, self.prev_len, llens, 0, lzx_e.NUM_SECONDARY)
        self.prev_main[:] = mlens
        self.prev_len[:] = llens
        if zero_length:
            return self
        codes = (lzx_e.canonical_codes(mlens), mlens,
                 lzx_e.canonical_codes(llens), llens,
                 lzx_e.canonical_codes(alens), alens)
        for t in tokens:
            self.enc._emit_tokens(w, [t], aligned, *codes)
            self._advance(1 if t[0] == 0 else t[1])
        return self

    def stored(self, data, rs=(1, 1, 1)):
        """One UNCOMPRESSED block (R0-R2 = ``rs``); odd length: pad."""
        w = self.w
        w.write_bits(3, 3)
        w.write_bits(len(data), 24)
        w.align16()
        for r in rs:
            w.write_bytes(r.to_bytes(4, "little"))
        for k in range(len(data)):
            w.write_bytes(data[k:k + 1])
            self._advance(1)
        if len(data) & 1:
            w.write_bytes(b"\x00")
        return self

    def raw_bits(self, value, n):
        self.w.write_bits(value, n)
        return self

    def getvalue(self):
        if not self.w.bit_aligned:
            self.w.align16()
        return bytes(self.w.out)


def _text(rng, n):
    words = [b"cabinet", b"folder", b"window", b"aligned", b"verbatim",
             b"pretree", b"offset", b"literal", b"the", b"of", b"lzx"]
    out = bytearray()
    while len(out) < n:
        out += words[rng.randint(len(words))] + b" "
    return bytes(out[:n])


def _corpus(rng, n):
    """Text, repeated noise and byte ramps, as the bench corpus mixes."""
    parts, size = [], 0
    while size < n:
        for p in (_text(rng, 3000) * 3,
                  rng.randint(0, 64, 2048, dtype=np.uint8).tobytes() * 4,
                  bytes(np.arange(256, dtype=np.uint8)) * 8):
            parts.append(p)
            size += len(p)
    return b"".join(parts)[:n]


def _fill(n, length=257):
    """Repeat-offset matches (R0 = 1) covering n bytes."""
    toks = [(1, length, 0)] * (n // length)
    if n % length:
        toks.append((1, n % length, 0))
    return toks


def _lits(data):
    return [(0, b) for b in data]


def _out_len(tokens):
    """The bytes a token list decodes to."""
    return sum(1 if t[0] == 0 else t[1] for t in tokens)


def lzx_edge_batch(seed=0, big=1 << 17):
    """The cases, valid ones first. ``big`` sizes the encoder-made streams
    at windows 2^16 and 2^21 (the smoke run passes more)."""
    rng = np.random.RandomState(seed)
    cases = []

    def add(name, stream, out_len, wb, delta=False, ref=b"", valid=True):
        raw = scalar_decode(stream, out_len, wb, delta, ref)
        if valid and raw is None:
            raise AssertionError(f"{name}: the reference codec rejects it")
        if not valid and raw is not None:
            raise AssertionError(f"{name}: the reference codec accepts it")
        cases.append(LzxCase(name, stream, out_len, wb, delta, ref, raw))

    # window 2^15: small hand-made streams
    t = _text(rng, 1500)
    s = _Writer(15).block(_lits(t[:700]) + [(2, 40, 300)]
                          + _lits(t[700:])).getvalue()
    add("verbatim", s, 1540, 15)
    toks = _lits(t[:400]) + [(2, 30, 100), (2, 12, 333), (0, 65),
                             (2, 9, 64), (1, 9, 1)] + _lits(t[400:600])
    s = _Writer(15).block(toks, aligned=True).getvalue()
    add("aligned", s, 400 + 30 + 12 + 1 + 9 + 9 + 200, 15)
    # a verbatim block of 37 tokens ends at some bit count; the stored
    # block after it drops 1-16 bits, its odd length takes a pad byte
    s = (_Writer(15).block(_lits(t[:37])).stored(t[37:338], (5, 6, 7))
         .block(_lits(t[338:400]) + [(1, 20, 0), (1, 8, 1)]).getvalue())
    add("stored_after_odd_bits", s, 400 + 28, 15)
    s = _Writer(15).block(_lits(t[:300]) + [(2, 5, 17), (2, 3, 200),
                                            (2, 8, 31)],
                          empty_length=True).getvalue()
    add("empty_length_tree", s, 316, 15)
    e8 = bytearray(_text(rng, 4000))
    for p in range(10, 3980, 97):
        e8[p:p + 5] = b"\xe8" + int(rng.randint(0, 1 << 20)).to_bytes(4,
                                                                  "little")
    s = lzx_e.LzxEncoder(15, intel_filesize=3_000_000).compress(
        bytes(e8))[0]
    add("e8_header", s, len(e8), 15)
    # three frames of long repeat matches, and blocks ending on frame ends
    s = (_Writer(15).block(_lits(b"ab") + _fill(FRAME - 2))
         .block(_fill(FRAME)).block(_fill(5000)).getvalue())
    add("multi_frame", s, 2 * FRAME + 5000, 15)
    # R2 = 33000 > window, set by a stored block; used from frame 2 on, a
    # lap later, it reads the ring slot rewritten in this lap: one token
    # at linear distance 33000 - 32768 (codecs/lzx.py:346-357)
    s = (_Writer(15).stored(b"r", (1, 1, 33000))
         .block(_fill(FRAME - 1) + _fill(FRAME)
                + _lits(_text(rng, 300)) + [(1, 20, 2)] + _lits(b"end"))
         .getvalue())
    add("ring_alias", s, 2 * FRAME + 323, 15)
    # a stored block that crosses the first frame's end 3 bytes in
    s = (_Writer(15).block(_lits(b"x") + _fill(FRAME - 4))
         .stored(_text(rng, 11)).block(_lits(b"tail") + [(1, 30, 0)])
         .getvalue())
    add("stored_odd_frame_cross", s, FRAME + 8 + 34, 15)

    # cases added later draw from their own generator, so that the cases
    # above and below keep their bytes
    rng2 = np.random.RandomState(seed + 7)
    t2 = _text(rng2, 800)
    # a code-length run that crosses each main-tree part's end: the zeros
    # it spills are the previous lengths the next part's deltas read, so
    # the second block's repeat-match lengths decode only if they are kept
    # (the TPU kernel flags such a run, pallas_lzx.py:494-498)
    reps = [(1, n, 0) for n in (2, 3, 4, 5)]
    toks = [_lits(t2[:300]) + [(2, 20, 100)] + reps * 3 + _lits(t2[300:400]),
            _lits(t2[400:600]) + [(2, 9, 150)] + reps + _lits(t2[600:700])]
    s = _Writer(15).block(toks[0]).block(toks[1], spill=4).getvalue()
    add("lens_run_crosses_part", s, sum(map(_out_len, toks)), 15)
    # zero-length VERBATIM and ALIGNED blocks (trees, no symbols) between
    # two blocks
    for aligned in (False, True):
        toks = [_lits(t2[:100]), _lits(t2[100:200]) + [(2, 30, 50)]]
        s = (_Writer(15).block(toks[0])
             .block(toks[1], aligned=aligned, zero_length=True)
             .block(toks[1]).getvalue())
        add(f"zero_length_{'aligned' if aligned else 'verbatim'}", s,
            sum(map(_out_len, toks)), 15)
    # R0-R2 at or above 2^31 from an uncompressed block, shifted out by
    # three matches before a repeat match reads R2 (the TPU kernel holds
    # them as int32)
    high = (0x80000001, 0xFFFFFFFF, 0x80000000)
    toks = (_lits(t2[:60]) + [(2, 10, 50), (2, 5, 20), (2, 7, 33), (1, 9, 2)]
            + _lits(t2[60:90]))
    s = _Writer(15).stored(b"hi", high).block(toks).getvalue()
    add("r_above_2g_shifted_out", s, 2 + _out_len(toks), 15)

    # DELTA, window 2^17: long matches into the reference data escape
    base = _text(rng, 3000) + bytes(rng.randint(0, 256, 400, np.uint8))
    new = bytearray(base)
    for _ in range(4):
        p = rng.randint(len(new) - 20)
        new[p:p + 6] = bytes(rng.randint(0, 256, 6, np.uint8))
    new = bytes(new) + b"appended " * 30
    s = lzx_e.LzxEncoder(17, is_delta=True).compress(new, ref_data=base)[0]
    add("delta_ref_escape", s, len(new), 17, delta=True, ref=base)
    # DELTA at window 2^25 with a full-size reference (the window less one
    # frame, as an OAB patch block of 32 KiB has it): matches reach its
    # first bytes, its middle and its end
    ref = rng2.randint(0, 256, (1 << 25) - FRAME, np.uint8).tobytes()
    mid = len(ref) // 2
    new = (ref[:3000] + _text(rng2, 500) + ref[mid:mid + 3000]
           + ref[-3000:] + ref[1000:1500])
    # (the matcher's chains must be long to find the oldest bytes of a
    # random reference)
    s = lzx_e.compress(new, 25, is_delta=True, ref_data=ref,
                       max_chain=1024)[0]
    add("delta_w25_full_ref", s, len(new), 25, delta=True, ref=ref)

    # encoder-made streams at windows 2^16 and 2^21, and stored blocks
    corpus = _corpus(rng, big)
    for wb in (16, 21):
        s = lzx_e.compress(corpus, wb)[0]
        add(f"corpus_w{wb}", s, len(corpus), wb)
    noise = bytes(rng.randint(0, 256, 3 * FRAME + 777, np.uint8))
    add("stored_frames_w16", lzx_e.compress(noise, 16)[0], len(noise), 16)
    add("empty_output", cases[-1].stream, 0, 16)

    # corrupt streams, window 2^15
    add("bad_block_type", _Writer(15).raw_bits(0, 3).raw_bits(100, 24)
        .getvalue(), 100, 15, valid=False)
    w = _Writer(15).raw_bits(1, 3).raw_bits(100, 24)
    for _ in range(20):
        w.raw_bits(1, 4)   # twenty codes of length 1: over-subscribed
    add("oversubscribed_pretree", w.getvalue(), 100, 15, valid=False)
    s = _Writer(15).block(_lits(b"abc") + [(2, 11, 2)],
                          empty_length=True).getvalue()
    add("length_from_empty_tree", s, 14, 15, valid=False)
    s = _Writer(15).block(_lits(b"abc") + [(2, 4, 100)]).getvalue()
    add("offset_beyond_stream", s, 7, 15, valid=False)
    # R2 = 33000 used in frame 1, 300 bytes in: the source lies behind the
    # wrap and before the frame's start, which the reference rejects
    # (codecs/lzx.py:337-341) even though 33000 bytes were decoded
    s = (_Writer(15).stored(b"r", (1, 1, 33000))
         .block(_fill(FRAME - 1) + _lits(_text(rng, 300)) + [(1, 20, 2)])
         .getvalue())
    add("offset_past_frame_start", s, FRAME + 320, 15, valid=False)
    # R0 at 2^31 + 1 from an uncompressed block, read by a repeat match: an
    # offset beyond the stream, which the reference rejects
    s = (_Writer(15).stored(b"hi", high)
         .block(_lits(t2[:20]) + [(1, 9, 0)]).getvalue())
    add("r0_above_2g_used", s, 2 + 20 + 9, 15, valid=False)
    return cases


def frame_sizes(stream, starts, out_len):
    """CFDATA payload lengths: the stream cut at its frames' first bytes
    (``starts``, one a frame and maybe one more at the end)."""
    starts = list(starts[:max(1, -(-out_len // FRAME))]) + [len(stream)]
    return [b - a for a, b in zip(starts, starts[1:])]


def _mixed(rng, pos, n, text, opens=False):
    """Tokens for n output bytes from output position pos: literals of
    ``text``, explicit matches and repeat matches of every slot, none
    crossing a frame end (a byte before one is a literal). ``opens``: a
    repeat match of slot k mod 3 opens each frame k > 0."""
    toks, end = [], pos + n
    while pos < end:
        room = min(end, (pos // FRAME + 1) * FRAME) - pos
        kind = rng.randint(10)
        if opens and pos % FRAME == 0 and pos and room >= 2:
            ln = min(room, int(rng.randint(2, 200)))
            toks.append((1, ln, pos // FRAME % 3))
            pos += ln
            continue
        if pos < 64 or room < 2 or kind < 5:
            k = min(room, rng.randint(1, 40))
            toks += _lits(text[pos % 1000:pos % 1000 + k].ljust(k, b"."))
            pos += k
            continue
        ln = min(room, int(rng.randint(2, 200)))
        if kind < 8:
            toks.append((2, ln, int(rng.randint(1, min(pos, 20000)))))
        else:
            toks.append((1, ln, int(rng.randint(3))))
        pos += ln
    return toks


def _repeats(pos, n):
    """Repeat matches of R0 for n output bytes from pos, cut at frame
    ends (a lone byte before one is a literal)."""
    toks, end = [], pos + n
    while pos < end:
        ln = min(257, end - pos, (pos // FRAME + 1) * FRAME - pos)
        toks.append((1, ln, 0) if ln > 1 else (0, 0x2E))
        pos += ln
    return toks


def lzx_split_batch(seed=0):
    """Streams for K3's frame split (``lzx_phase_a(frame_sizes=...)``),
    each with its frames' CFDATA sizes: blocks that end inside frames and
    on frame edges, uncompressed blocks of odd length that cross a frame
    edge or end on one (its pad byte then opens the next frame), the E8
    header, repeat matches of every slot at frame starts and a folder of
    repeat matches alone, each with a last frame shorter than 32 KiB."""
    rng = np.random.RandomState(seed + 11)
    text = _text(rng, 2000)
    cases = []

    def add(name, w, wb):
        s = w.getvalue()
        raw = scalar_decode(s, w.pos, wb)
        if raw is None:
            raise AssertionError(f"{name}: the reference codec rejects it")
        cases.append(LzxCase(name, s, w.pos, wb, raw=raw,
                             frame_sizes=frame_sizes(s, w.frames, w.pos)))

    for wb in (15, 16):
        w, pos = _Writer(wb), 0
        for n, aligned in ((20000, False), (30000, True), (40000, False),
                           (10000, True), (31072, False), (5000, True)):
            w.block(_mixed(rng, pos, n, text), aligned=aligned)
            pos += n
        add(f"split_blocks_inside_frames_w{wb}", w, wb)
    w, pos = _Writer(16), 0
    for n, stored in ((30001, False), (5001, True), (20000, False),
                      (10533, True), (12345, False), (7, True),
                      (9000, False)):
        if stored:
            w.stored(bytes(rng.randint(0, 256, n, np.uint8)),
                     tuple(int(v) for v in rng.randint(1, 3000, 3)))
        else:
            w.block(_mixed(rng, pos, n, text))
        pos += n
    add("split_stored_odd", w, 16)
    # three full frames of repeat matches of R0 alone, after a frame that
    # sets R0-R2 to 3, 17 and 90
    w = _Writer(15).block(_lits(text[:200]) + [(2, 30, 90), (2, 40, 17),
                                                 (2, 30, 3)]
                          + _mixed(rng, 300, FRAME - 300, text))
    w.block([(1, 3, 2), (1, 5, 1), (1, 7, 2)]
            + _repeats(FRAME + 15, 3 * FRAME - 15) + _lits(text[:100]))
    add("split_repeats_across_frames", w, 15)
    e8 = bytearray(_text(rng, 3 * FRAME + 999))
    for p in range(10, len(e8) - 10, 101):
        e8[p:p + 5] = b"\xe8" + int(rng.randint(0, 1 << 20)).to_bytes(
            4, "little")
    s, offs = lzx_e.LzxEncoder(16, intel_filesize=5_000_000).compress(
        bytes(e8))
    cases.append(LzxCase("split_e8", s, len(e8), 16,
                         raw=scalar_decode(s, len(e8), 16),
                         frame_sizes=frame_sizes(s, offs, len(e8))))
    return cases


def lzx_split_many(seed=0, frames=66):
    """A folder of more than 64 frames for K3's frame split, so that the
    join composes several frames a lane: blocks of uneven lengths that end
    inside frames and on frame edges, aligned and verbatim, a repeat match
    of every slot in turn opening each frame, a last frame shorter than
    32 KiB. Window 2^16, with its frames' CFDATA sizes."""
    rng = np.random.RandomState(seed + 23)
    text = _text(rng, 2000)
    total = frames * FRAME - 4321
    w, pos = _Writer(16), 0
    while pos < total:
        n = int(rng.randint(3000, 3 * FRAME))
        if rng.randint(3) == 0:  # to the next frame edge
            n = FRAME - pos % FRAME
        n = min(n, total - pos)
        w.block(_mixed(rng, pos, n, text, opens=True),
                aligned=bool(rng.randint(2)))
        pos += n
    s = w.getvalue()
    raw = scalar_decode(s, total, 16)
    if raw is None:
        raise AssertionError("lzx_split_many: the reference codec rejects it")
    return LzxCase("split_many_frames", s, total, 16, raw=raw,
                   frame_sizes=frame_sizes(s, w.frames, total))


def groups(cases):
    """Lane indices grouped by (window_bits, delta): one launch each."""
    out: dict = {}
    for i, c in enumerate(cases):
        out.setdefault((c.window_bits, c.delta), []).append(i)
    return out


def inputs(cases):
    """K3's batch for the cases as CPU tensors: (streams, lens, target
    output sizes, history budgets)."""
    from .ops.cuda_lzx import pack_streams

    s, lens = pack_streams([c.stream for c in cases])
    tg = torch.tensor([c.out_len for c in cases], dtype=torch.int32)
    hs = torch.tensor([len(c.ref) for c in cases], dtype=torch.int32)
    return s, lens, tg, hs


def segmented(launch, totals, seg):
    """Decode in launches of <= seg output bytes per lane through the state
    record. ``launch(targets, tcap, state)`` runs K3 (or its plain version
    or twin) with ``state`` None the first time and returns ``(tok, litw,
    cnt, state)``. Returns each lane's tokens of all launches, concatenated,
    as int32 numpy ``(tok, litw)``, the last state and the launch count;
    raises AssertionError where a lane stops short of its target."""
    from .parallel.cuda_pipeline import segment_targets

    toks = [[] for _ in totals]
    lits = [[] for _ in totals]
    state = None
    launches = 0
    for _, targets in segment_targets(totals, seg):
        tok, litw, cnt, state = launch(
            torch.tensor(targets, dtype=torch.int32), seg, state)
        launches += 1
        tok, litw, cnt = tok.cpu(), litw.cpu(), cnt.cpu()
        if (cnt[0] != 0).any() or not np.array_equal(cnt[1].numpy(),
                                                     targets):
            raise AssertionError("a lane stopped short of its segment")
        for i in range(len(totals)):
            k = int(cnt[2, i])
            toks[i] += tok[i, :k].tolist()
            lits[i] += litw[i, :k].tolist()
    T = max(1, max(len(t) for t in toks))
    tok = np.full((len(totals), T), -1, np.int32)
    litw = np.zeros((len(totals), T), np.int32)
    for i in range(len(totals)):
        tok[i, :len(toks[i])] = toks[i]
        litw[i, :len(lits[i])] = lits[i]
    return tok, litw, state, launches


def resolve(cases, tok, litw, cnt):
    """Resolve each lane's trace with the engine's host phase B
    (``cuda_pipeline.resolve_lzx``), intel E8 translation included.

    ``cases`` share one window; ``tok``, ``litw``: int32 numpy ``(L, T)``;
    ``cnt``: the ``(8, L)`` counts. Returns a list of bytes, or None where
    the lane is flagged or the resolver fails."""
    from .parallel.cuda_pipeline import resolve_lzx

    wb = cases[0].window_bits
    out = []
    for i, c in enumerate(cases):
        if cnt[0, i] != 0 or cnt[1, i] != c.out_len:
            out.append(None)
            continue
        got = resolve_lzx(tok[i:i + 1], litw[i:i + 1], [c.out_len],
                          cnt[4, i:i + 1], cnt[5, i:i + 1], wb,
                          [c.ref], n_threads=1)
        out.append(None if got is None else got[0].tobytes())
    return out
