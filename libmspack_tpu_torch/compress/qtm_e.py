"""Quantum encoder — adaptive arithmetic-coded LZ (compress path).

The reference ships no Quantum compressor at all (qtmc.c is not even in
its build, reference: libmspack/Makefile.am:28-44); this encoder is
built from the format semantics our decoder (codecs/qtm.py, reference
qtmd.c) pins down, and is verified by decoding its output through both
our decoders and the compiled reference library.

Stream model (mirror of qtmd.c):

* MSB-first bitstream; the decoder ingests 16-bit big-endian units, so
  the byte stream is plain MSB-first (qtmd.c:30-35).
* 16-bit H/L range coder (Witten-Neal-Cleary with underflow counting).
  The decoder keeps a 16-bit lookahead register C, which creates the
  one genuinely tricky encoding rule: *raw* extra bits (match offsets /
  lengths, read with READ_MANY_BITS in qtmd.c:274-340) appear in the
  byte stream 16 range-coder bits LATER than the range coder's logical
  position, because the decoder has already buffered those 16 bits into
  C when it reads the extras.  The encoder therefore records each raw
  field as an insertion at RC-bit index ``16 + shifts_so_far`` and
  splices the stream together at frame end.
* Every decoded symbol updates its model exactly like the decoder
  (+8 per cumfreq, rescale/re-sort past 3800, qtmd.c:106-166); the
  encoder reuses codecs.qtm._Model so the two stay in lockstep.
* 32 KiB output frames: H/L/C re-initialise per frame; models persist
  across frames.  At frame end the decoder byte-realigns and scans for
  a 0xFF trailer (qtmd.c:430-442).  In a CAB, each frame is one CFDATA
  block and the *reader* injects the 0xFF (cabd.c:1327-1332), so frame
  payloads must not contain a stray 0xFF after the decoder's final bit
  position.  The flush below guarantees the tail is zero padding:
  after the flush bit the RC stream is exactly ``shifts + 1`` bits
  while the decoder consumes ``16 + shifts``, so each frame ends with
  15 zero bits plus byte alignment — never a spurious trailer.

Matches: selector 4 = length 3, selector 5 = length 4, selector 6 =
lengths 5..259 via the 27-slot length model; offsets use the LZX-style
slot tables with up to 19 extra bits (qtmd.c:52-82).  Long-range
length-3/4 matches are unrepresentable when the slot exceeds the
model-4/5 alphabet (min(2*window_bits, 24)/36 entries, qtmd.c:242-251)
and fall back to shorter selectors or literals.

Copied from ``libmspack_tpu/compress/qtm_e.py`` so that the port imports nothing
of the JAX package; the copy differs in nothing else.
"""
from __future__ import annotations

from bisect import bisect_right

from ..codecs.qtm import (EXTRA_BITS, FRAME_SIZE, LENGTH_BASE,
                          LENGTH_EXTRA, POSITION_BASE, _Model)
from .lzx_e import _Matcher

MAX_MATCH = LENGTH_BASE[26] + 5        # 259: longest selector-6 length
_LENGTH_BASE26 = LENGTH_BASE[:27]


class _FrameCoder:
    """One frame's range coder, mirroring QtmDecompressor._get_symbol."""

    __slots__ = ("H", "L", "underflow", "shifts", "rc", "inserts")

    def __init__(self):
        self.H = 0xFFFF
        self.L = 0
        self.underflow = 0
        self.shifts = 0        # decoder renorm shifts == emitted + pending
        self.rc = []           # range-coder output bits, in stream order
        self.inserts = []      # (rc_bit_index, value, nbits) raw fields

    def _emit(self, b: int) -> None:
        rc = self.rc
        rc.append(b)
        if self.underflow:
            nb = b ^ 1
            rc.extend([nb] * self.underflow)
            self.underflow = 0

    def encode(self, model: _Model, sym: int) -> None:
        """Narrow [L,H] to `sym`'s cumfreq interval and update the model
        with the decoder's exact arithmetic (qtmd.c:92-123)."""
        k = model.syms.index(sym)              # 0..entries-1
        cf = model.cumfreq
        rng = (self.H - self.L) + 1
        total = cf[0]
        H = (self.L + (cf[k] * rng) // total - 1) & 0xFFFF
        L = (self.L + (cf[k + 1] * rng) // total) & 0xFFFF

        for j in range(k, -1, -1):
            cf[j] += 8
        if cf[0] > 3800:
            model.update()

        while True:
            if (L & 0x8000) == (H & 0x8000):
                self._emit(L >> 15)
            elif (L & 0x4000) and not (H & 0x4000):
                self.underflow += 1
                L &= 0x3FFF
                H |= 0x4000
            else:
                break
            L = (L << 1) & 0xFFFF
            H = ((H << 1) | 1) & 0xFFFF
            self.shifts += 1
        self.H, self.L = H, L

    def raw(self, value: int, nbits: int) -> None:
        """Queue raw extra bits; the decoder reads them 16 RC bits ahead
        of the range coder's logical position (C lookahead)."""
        if nbits:
            self.inserts.append((16 + self.shifts, value, nbits))

    def finish(self) -> bytes:
        """Flush and splice the frame payload (without 0xFF trailer)."""
        # disambiguating quarter: 01 (L < 0x4000, H >= 0x8000) or
        # 10 (L >= 0x4000, H >= 0xC000); any continuation stays inside.
        self.underflow += 1
        self._emit(0 if self.L < 0x4000 else 1)

        rc = self.rc
        rc.extend([0] * 15)    # decoder consumes 16 + shifts = len(rc) + 15

        bits = []
        prev = 0
        for pos, val, nb in self.inserts:
            bits.extend(rc[prev:pos])
            prev = pos
            bits.extend((val >> (nb - 1 - i)) & 1 for i in range(nb))
        bits.extend(rc[prev:])

        pad = -len(bits) % 8
        bits.extend([0] * pad)
        out = bytearray(len(bits) // 8)
        for i in range(len(out)):
            b = 0
            for bit in bits[8 * i : 8 * i + 8]:
                b = (b << 1) | bit
            out[i] = b
        return bytes(out)


def _pos_slot(dist: int, entries: int) -> int:
    """Largest slot with POSITION_BASE[slot] <= dist-1, or -1 if the
    model's alphabet cannot express this distance."""
    s = bisect_right(POSITION_BASE, dist - 1, 0, entries) - 1
    if s + 1 < entries or dist - 1 < POSITION_BASE[entries - 1] + (
            1 << EXTRA_BITS[entries - 1]):
        return s
    return -1


class QtmEncoder:
    """Greedy Quantum encoder producing one payload per 32 KiB frame
    (= one CAB CFDATA block; the CAB reader injects the 0xFF trailer)."""

    def __init__(self, window_bits: int, max_chain: int = 64):
        if not (10 <= window_bits <= 21):
            raise ValueError("Quantum window must be 2^10..2^21")
        self.window_bits = window_bits
        self.window_size = 1 << window_bits
        self.max_chain = max_chain
        i = window_bits * 2
        self.model0 = _Model(0, 64)
        self.model1 = _Model(64, 64)
        self.model2 = _Model(128, 64)
        self.model3 = _Model(192, 64)
        self.model4 = _Model(0, min(i, 24))
        self.model5 = _Model(0, min(i, 36))
        self.model6 = _Model(0, i)
        self.model6len = _Model(0, 27)
        self.model7 = _Model(0, 7)

    # ------------------------------------------------------------------

    def _encode_match(self, coder: _FrameCoder, length: int,
                      dist: int) -> bool:
        """Try to encode a match; returns False when unrepresentable
        (long-distance length-3/4, qtmd.c:242-251 model sizing)."""
        if length == 3:
            slot = _pos_slot(dist, self.model4.entries)
            if slot < 0:
                return False
            coder.encode(self.model7, 4)
            coder.encode(self.model4, slot)
            coder.raw(dist - 1 - POSITION_BASE[slot], EXTRA_BITS[slot])
            return True
        if length == 4:
            slot = _pos_slot(dist, self.model5.entries)
            if slot < 0:
                return False
            coder.encode(self.model7, 5)
            coder.encode(self.model5, slot)
            coder.raw(dist - 1 - POSITION_BASE[slot], EXTRA_BITS[slot])
            return True
        slot = _pos_slot(dist, self.model6.entries)
        if slot < 0:
            return False
        lv = length - 5
        lsym = bisect_right(_LENGTH_BASE26, lv) - 1
        coder.encode(self.model7, 6)
        coder.encode(self.model6len, lsym)
        coder.raw(lv - LENGTH_BASE[lsym], LENGTH_EXTRA[lsym])
        coder.encode(self.model6, slot)
        coder.raw(dist - 1 - POSITION_BASE[slot], EXTRA_BITS[slot])
        return True

    def _encode_literal(self, coder: _FrameCoder, byte: int) -> None:
        sel = byte >> 6
        coder.encode(self.model7, sel)
        coder.encode((self.model0, self.model1,
                      self.model2, self.model3)[sel], byte)

    # ------------------------------------------------------------------

    def compress(self, data: bytes) -> list[bytes]:
        """Encode `data` into per-frame payloads (models carry across
        frames, H/L/C restart per frame, matches never cross a frame
        boundary: qtmd.c frame_todo accounting)."""
        matcher = _Matcher(data, self.max_chain)
        wsize = self.window_size
        payloads = []
        pos = 0
        n = len(data)
        while pos < n:
            frame_end = min(pos + FRAME_SIZE, n)
            coder = _FrameCoder()
            while pos < frame_end:
                cap = min(MAX_MATCH, frame_end - pos)
                length, dist = matcher.longest(pos, n, wsize, cap)
                # the matcher searches the whole buffer; clamp the
                # window-resident constraint (ring holds last 2^wb bytes)
                if length >= 3 and self._encode_match(coder, length, dist):
                    for p in range(pos, pos + length):
                        matcher.insert(p)
                    pos += length
                else:
                    self._encode_literal(coder, data[pos])
                    matcher.insert(pos)
                    pos += 1
            payloads.append(coder.finish())
        return payloads


def compress(data: bytes, window_bits: int,
             engine: str = "auto") -> list[bytes]:
    """Encode to per-frame payloads. engine: "auto" prefers the native
    C++ port (msp_qtm_encode, same algorithm), "python" forces this
    module's reference implementation."""
    if engine == "auto":
        try:
            from .. import native
            r = native.qtm_encode(data, window_bits)
            if r is not None:
                return r
        except Exception:
            pass
    return QtmEncoder(window_bits).compress(data)


def window_bits_for(n: int) -> int:
    """Smallest legal window holding n bytes, clamped to 2^10..2^21."""
    bits = 10
    while (1 << bits) < n and bits < 21:
        bits += 1
    return bits
