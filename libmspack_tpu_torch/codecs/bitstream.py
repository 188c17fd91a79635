"""Bitstream readers (L1 primitive).

Faithful re-expression of the reference's 32-bit bit-register semantics
(reference: libmspack/mspack/readbits.h) in Python. Two bit orders exist:

* MSB-first over 16-bit little-endian units (LZX: readbits.h + lzxd.c:86-91)
  or 16-bit big-endian units (Quantum: qtmd.c:30-35),
* LSB-first over single bytes (MSZIP/deflate, KWAJ-LZH: mszipd.c:23-26).

The register is exactly 32 bits wide. MSB order injects new bits just
below the ones already present, peeks from the top; LSB order injects
above the ones present, peeks from the bottom. At end of input the feed
fakes two zero bytes once, then errors (reference: readbits.h:192-214) —
this "soft EOF" is load-bearing: decoders routinely over-ensure bits they
never consume at stream end.

These classes are the *scalar* reference implementation used by the
streaming codec layer; the vectorized JAX equivalents live in
`libmspack_tpu.ops.bitstream_jax` and operate on whole arrays of cursors.

Copied from ``libmspack_tpu/codecs/bitstream.py`` so that the port imports nothing
of the JAX package; the copy differs in nothing else.
"""
from __future__ import annotations

from ..errors import ReadError

_MASK32 = 0xFFFFFFFF


class ByteFeed:
    """Buffered byte supply with the reference's soft-EOF behavior.

    `reader` is a callable read(n)->bytes (normally a driver-wrapped
    source, e.g. the CAB CFDATA block reader).
    """

    __slots__ = ("_reader", "_buf", "_pos", "_soft_eof_used", "chunk")

    def __init__(self, reader, chunk: int = 65536):
        self._reader = reader
        self._buf = b""
        self._pos = 0
        self._soft_eof_used = False
        self.chunk = chunk

    def _refill(self) -> None:
        data = self._reader(self.chunk)
        if data:
            self._buf = data
            self._pos = 0
            return
        if self._soft_eof_used:
            raise ReadError("out of input bytes")
        # fake two zero bytes so final over-reads succeed once
        self._soft_eof_used = True
        self._buf = b"\x00\x00"
        self._pos = 0

    def next_byte(self) -> int:
        if self._pos >= len(self._buf):
            self._refill()
        b = self._buf[self._pos]
        self._pos += 1
        return b

    def next_bytes(self, n: int) -> bytes:
        """Read up to n bytes from the current buffer (refilling if empty)."""
        if self._pos >= len(self._buf):
            self._refill()
        chunk = self._buf[self._pos : self._pos + n]
        self._pos += len(chunk)
        return chunk

    @property
    def hit_end(self) -> bool:
        return self._soft_eof_used


class _BitReaderBase:
    __slots__ = ("feed", "bit_buffer", "bits_left")

    def __init__(self, feed: ByteFeed):
        self.feed = feed
        self.bit_buffer = 0
        self.bits_left = 0

    def align_byte(self) -> None:
        """Drop bits to the next byte boundary."""
        n = self.bits_left & 7
        if n:
            self.remove(n)


class MSBBitReader(_BitReaderBase):
    """MSB-first bit register fed 16 bits at a time.

    `unit_order` selects how the two bytes form the 16-bit unit:
    'le' = (b1<<8)|b0 (LZX), 'be' = (b0<<8)|b1 (Quantum).
    """

    __slots__ = ("unit_order",)

    def __init__(self, feed: ByteFeed, unit_order: str = "le"):
        super().__init__(feed)
        self.unit_order = unit_order

    def _read_unit(self) -> None:
        b0 = self.feed.next_byte()
        b1 = self.feed.next_byte()
        data = (b1 << 8) | b0 if self.unit_order == "le" else (b0 << 8) | b1
        self.bit_buffer = (self.bit_buffer | (data << (16 - self.bits_left))) & _MASK32
        self.bits_left += 16

    def ensure(self, n: int) -> None:
        while self.bits_left < n:
            self._read_unit()

    def peek(self, n: int) -> int:
        return self.bit_buffer >> (32 - n)

    def remove(self, n: int) -> None:
        self.bit_buffer = (self.bit_buffer << n) & _MASK32
        self.bits_left -= n

    def read(self, n: int) -> int:
        self.ensure(n)
        v = self.bit_buffer >> (32 - n)
        self.bit_buffer = (self.bit_buffer << n) & _MASK32
        self.bits_left -= n
        return v

    def read_many(self, n: int) -> int:
        """Read 0..32 bits, possibly more than ensurable at once
        (reference: readbits.h:143-153 READ_MANY_BITS)."""
        val = 0
        needed = n
        while needed > 0:
            if self.bits_left <= 16:
                self._read_unit()
            run = min(self.bits_left, needed)
            val = (val << run) | (self.bit_buffer >> (32 - run))
            self.remove(run)
            needed -= run
        return val


class LSBBitReader(_BitReaderBase):
    """LSB-first bit register fed one byte at a time (deflate order)."""

    def _read_byte(self) -> None:
        b = self.feed.next_byte()
        self.bit_buffer = (self.bit_buffer | (b << self.bits_left)) & _MASK32
        self.bits_left += 8

    def ensure(self, n: int) -> None:
        while self.bits_left < n:
            self._read_byte()

    def peek(self, n: int) -> int:
        return self.bit_buffer & ((1 << n) - 1)

    def remove(self, n: int) -> None:
        self.bit_buffer >>= n
        self.bits_left -= n

    def read(self, n: int) -> int:
        self.ensure(n)
        v = self.bit_buffer & ((1 << n) - 1)
        self.bit_buffer >>= n
        self.bits_left -= n
        return v
