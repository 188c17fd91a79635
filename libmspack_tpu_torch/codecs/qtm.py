"""Quantum decoder (L2 codec) — adaptive arithmetic-coded LZ.

Format semantics (reference: libmspack/mspack/qtmd.c, qtm.h):

* MSB-first bitstream of 16-bit *big-endian* units (qtmd.c:30-35).
* 16-bit range coder with underflow handling; every decoded symbol
  updates its model's cumulative frequencies (+8), with a rescale +
  frequency re-sort once the total passes 3800.
* A 7-symbol selector model routes to: 4 positional literal models
  (64 syms each) or 3 match shapes (len-3, len-4, variable length).
* Position/length slot tables like LZX but with 19-bit extras.
* 32 KiB frames: at each frame end the stream re-aligns to a byte,
  skips forward to a 0xFF trailer byte (CAB injects one per block),
  and the range coder re-initialises from the stream.
* Window 1 KiB..2 MiB may be *smaller* than a frame; matches never
  cross a frame boundary but output wraps the window, forcing a flush
  (a caller that hasn't consumed the previous lap is an error —
  qtmd.c:356-380).

Architecture: the adaptive model updates make Quantum inherently
sequential within a folder (SURVEY.md §7 hard part 3); parallelism
comes from decoding many folders at once. This implementation splits
the codec into the framework's components — a `RangeDecoder` carrying
the coder registers, `AdaptiveModel` objects owning their own search/
update, and a *linear* sliding history buffer written with the shared
overlap-safe `lz_fill` primitive — rather than the reference's fused
macro loop over a ring window.

Copied from ``libmspack_tpu/codecs/qtm.py`` so that the port imports nothing
of the JAX package; the copy differs in nothing else.
"""
from __future__ import annotations

from ..errors import ArgsError, DecrunchError, MSPackError
from .bitstream import ByteFeed, MSBBitReader
from .mszip import lz_fill

FRAME_SIZE = 32768

# position slots (qtmd.c:52-64): extra_bits[i] = max(0, i-2)>>1
EXTRA_BITS = tuple((0 if i < 2 else i - 2) >> 1 for i in range(42))


def _cumulative_bases(extras):
    bases, offset = [], 0
    for eb in extras:
        bases.append(offset)
        offset += 1 << eb
    return tuple(bases)


POSITION_BASE = _cumulative_bases(EXTRA_BITS)
LENGTH_EXTRA = tuple(((0 if i < 2 else i - 2) >> 2) for i in range(26)) + (0,)
LENGTH_BASE = _cumulative_bases(LENGTH_EXTRA[:26]) + (254,)


class RangeDecoder:
    """The 16-bit arithmetic coder registers + renormalisation.

    Reference: qtmd.c:92-123 (GET_SYMBOL's coder half) and the H/L/C
    init at each frame start (qtmd.c:430-442).
    """

    __slots__ = ("lo", "hi", "code", "bits")

    def __init__(self, bits: MSBBitReader):
        self.bits = bits
        self.lo = 0
        self.hi = 0xFFFF
        self.code = 0

    def begin_frame(self) -> None:
        self.lo = 0
        self.hi = 0xFFFF
        self.code = self.bits.read(16)

    def frequency(self, total: int) -> int:
        """Map the current code point to a cumulative frequency."""
        span = ((self.hi - self.lo) & 0xFFFF) + 1
        return ((((self.code - self.lo + 1) * total) - 1) // span) & 0xFFFF

    def narrow(self, cum_hi: int, cum_lo: int, total: int) -> None:
        """Narrow the interval to [cum_lo, cum_hi) / total, renormalise."""
        span = (self.hi - self.lo) + 1
        self.hi = (self.lo + (cum_hi * span) // total - 1) & 0xFFFF
        self.lo = (self.lo + (cum_lo * span) // total) & 0xFFFF

        lo, hi, code = self.lo, self.hi, self.code
        read = self.bits.read
        while True:
            if (lo & 0x8000) != (hi & 0x8000):
                if (lo & 0x4000) and not (hi & 0x4000):
                    # underflow: shift out the 2nd-highest bit
                    code ^= 0x4000
                    lo &= 0x3FFF
                    hi |= 0x4000
                else:
                    break
            lo = (lo << 1) & 0xFFFF
            hi = ((hi << 1) | 1) & 0xFFFF
            code = ((code << 1) | read(1)) & 0xFFFF
        self.lo, self.hi, self.code = lo, hi, code


class AdaptiveModel:
    """One adaptive model: symbol/cumfreq arrays with a 0-sentinel.

    Owns both the cumulative-frequency search and the per-decode
    update (+8 / rescale / frequency re-sort — qtmd.c:106-166).
    """

    __slots__ = ("entries", "rescales_left", "syms", "cumfreq")

    def __init__(self, start: int, length: int):
        self.rescales_left = 4
        self.entries = length
        self.syms = [start + i for i in range(length + 1)]
        self.cumfreq = [length - i for i in range(length + 1)]

    def decode(self, coder: RangeDecoder) -> int:
        cf = self.cumfreq
        target = coder.frequency(cf[0])
        pick = 1
        n = self.entries
        while pick < n and cf[pick] > target:
            pick += 1
        sym = self.syms[pick - 1]
        coder.narrow(cf[pick - 1], cf[pick], cf[0])

        for j in range(pick):
            cf[j] += 8
        if cf[0] > 3800:
            self.update()
        return sym

    def update(self) -> None:
        """Halve frequencies; every 5th time re-sort symbols by count."""
        self.rescales_left -= 1
        n = self.entries
        cf = self.cumfreq
        if self.rescales_left:
            for i in range(n - 1, -1, -1):
                cf[i] >>= 1
                if cf[i] <= cf[i + 1]:
                    cf[i] = cf[i + 1] + 1
            return
        # every 5th rescale: convert to plain counts, halve, re-sort
        self.rescales_left = 50
        for i in range(n):
            cf[i] = ((cf[i] - cf[i + 1]) + 1) >> 1
        syms = self.syms
        for i in range(n - 1):
            for j in range(i + 1, n):
                if cf[i] < cf[j]:
                    cf[i], cf[j] = cf[j], cf[i]
                    syms[i], syms[j] = syms[j], syms[i]
        for i in range(n - 1, -1, -1):
            cf[i] += cf[i + 1]


class QtmDecompressor:
    """Streaming Quantum decoder over a read(n)->bytes input callable."""

    def __init__(self, read_fn, window_bits: int,
                 input_buffer_size: int = 4096):
        if not (10 <= window_bits <= 21):
            raise ArgsError("Quantum window must be 2^10..2^21")
        self.bits = MSBBitReader(
            ByteFeed(read_fn, chunk=max(2, input_buffer_size)),
            unit_order="be")
        self.window_size = 1 << window_bits
        # linear history: one window of virtual pre-stream (zeros),
        # then decoded bytes; slid as both delivery and match reach
        # move past old data.
        self.history = bytearray(self.window_size)
        self.origin = -self.window_size  # abs position of history[0]
        self.cursor = 0        # abs position decoded
        self.served = 0        # abs position delivered to the caller
        self.flushable = 0     # abs position available for delivery
        self.frame_todo = FRAME_SIZE
        self.at_frame_start = True
        self.error: MSPackError | None = None
        self.coder = RangeDecoder(self.bits)

        literal_span = window_bits * 2
        self.literal_models = tuple(
            AdaptiveModel(base, 64) for base in (0, 64, 128, 192))
        self.match3_model = AdaptiveModel(0, min(literal_span, 24))
        self.match4_model = AdaptiveModel(0, min(literal_span, 36))
        self.matchv_model = AdaptiveModel(0, literal_span)
        self.matchv_len_model = AdaptiveModel(0, 27)
        self.selector_model = AdaptiveModel(0, 7)

    # ------------------------------------------------------------------

    def decompress(self, out_bytes: int, write_fn) -> None:
        if self.error:
            raise self.error
        if out_bytes < 0:
            raise ArgsError("negative out_bytes")
        try:
            self._decompress(out_bytes, write_fn)
        except MSPackError as exc:
            self.error = exc
            raise

    def _deliver(self, upto: int, write_fn) -> int:
        """Write history[served:upto] to the caller; returns count."""
        lo = self.served - self.origin
        hi = upto - self.origin
        if hi > lo:
            write_fn(bytes(self.history[lo:hi]))
            self.served = upto
        return max(0, hi - lo)

    def _grow(self, n: int) -> None:
        need = (self.cursor - self.origin) + n - len(self.history)
        if need > 0:
            self.history.extend(bytes(need))

    def _match_copy(self, offset: int, length: int) -> None:
        """Copy `length` bytes from ring offset `offset`, in linear
        history coordinates (see lzx.py for the ring->linear mapping).
        """
        wsize = self.window_size
        lap_pos = self.cursor % wsize
        self._grow(length)
        rel = self.cursor - self.origin
        if offset > lap_pos:
            if (offset - lap_pos) > wsize:
                raise DecrunchError("match offset beyond window boundaries")
            if offset > wsize:
                # ring aliasing: tail region already overwritten this lap
                first = min(length, offset - lap_pos)
                lz_fill(self.history, rel, offset - wsize, first)
                if length > first:
                    lz_fill(self.history, rel + first, offset,
                            length - first)
                self.cursor += length
                return
        lz_fill(self.history, rel, offset, length)
        self.cursor += length

    def _slide(self) -> None:
        """Drop history bytes that are both delivered and out of match
        reach; amortised so slicing is rare."""
        wsize = self.window_size
        droppable = min(self.served, self.cursor - wsize) - self.origin
        if droppable > 2 * wsize:
            del self.history[:droppable]
            self.origin += droppable

    def _decompress(self, out_bytes: int, write_fn) -> None:
        bits = self.bits
        wsize = self.window_size

        # flush stored-up bytes
        take = min(self.flushable - self.served, out_bytes)
        if take > 0:
            self._deliver(self.served + take, write_fn)
            out_bytes -= take
        if out_bytes == 0:
            return

        coder = self.coder
        sel_model = self.selector_model

        while (self.flushable - self.served) < out_bytes:
            if self.at_frame_start:
                coder.begin_frame()
                self.at_frame_start = False

            # decode until the frame ends, the window laps, or we have
            # enough bytes for the caller
            lap_end = self.cursor - (self.cursor % wsize) + wsize
            stop = min(self.cursor + self.frame_todo, lap_end,
                       self.served + out_bytes)
            wrap_flushed = False

            while self.cursor < stop:
                selector = sel_model.decode(coder)
                if selector < 4:
                    byte = self.literal_models[selector].decode(coder)
                    self._grow(1)
                    self.history[self.cursor - self.origin] = byte
                    self.cursor += 1
                    self.frame_todo -= 1
                    continue

                if selector == 4:
                    slot = self.match3_model.decode(coder)
                    extra = bits.read_many(EXTRA_BITS[slot])
                    offset = POSITION_BASE[slot] + extra + 1
                    length = 3
                elif selector == 5:
                    slot = self.match4_model.decode(coder)
                    extra = bits.read_many(EXTRA_BITS[slot])
                    offset = POSITION_BASE[slot] + extra + 1
                    length = 4
                elif selector == 6:
                    slot = self.matchv_len_model.decode(coder)
                    extra = bits.read_many(LENGTH_EXTRA[slot])
                    length = LENGTH_BASE[slot] + extra + 5
                    slot = self.matchv_model.decode(coder)
                    extra = bits.read_many(EXTRA_BITS[slot])
                    offset = POSITION_BASE[slot] + extra + 1
                else:
                    raise DecrunchError(f"bad selector {selector}")

                self.frame_todo -= length

                if (self.cursor % wsize) + length > wsize:
                    # match destination wraps the window (window < frame
                    # size): the whole lap must be flushed mid-match; a
                    # caller that hasn't asked for that much is an error
                    # (qtmd.c:356-380)
                    self._match_copy(offset, length)
                    pending = lap_end - self.served
                    if pending > out_bytes:
                        raise DecrunchError(
                            "window-wrap flush larger than request")
                    self._deliver(lap_end, write_fn)
                    out_bytes -= pending
                    wrap_flushed = True
                    break
                self._match_copy(offset, length)

            # everything decoded so far is deliverable (qtmd.c sets
            # o_end after the symbol loop, wrap case included)
            self.flushable = self.cursor

            if self.frame_todo > FRAME_SIZE or self.frame_todo < 0:
                raise DecrunchError("overshot frame alignment")

            if self.frame_todo == 0:
                # realign to a byte, scan for the 0xFF trailer
                if bits.bits_left & 7:
                    bits.remove(bits.bits_left & 7)
                while bits.read(8) != 0xFF:
                    pass
                self.at_frame_start = True
                self.frame_todo = FRAME_SIZE

            if not wrap_flushed and self.cursor == lap_end:
                avail = self.flushable - self.served
                if avail >= out_bytes:
                    break
                out_bytes -= self._deliver(self.flushable, write_fn)

            self._slide()

        if out_bytes:
            self._deliver(self.served + out_bytes, write_fn)
        self._slide()


# compatibility alias for the Quantum encoder (compress/qtm_e.py)
_Model = AdaptiveModel
