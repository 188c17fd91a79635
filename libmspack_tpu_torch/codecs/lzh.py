"""KWAJ method-3 LZH decoder (L2 codec).

Format semantics (reference: libmspack/mspack/kwajd.c:365-570):

* MSB-first bitstream, bytes injected one at a time.
* 5 Huffman trees: MATCHLEN1/MATCHLEN2 (16 syms), LITLEN (32),
  OFFSET (64), LITERAL (256); table bits = 9.
* header: six 4-bit tree-encoding type selectors (only 5 used), then
  each tree's code lengths in one of 4 encodings.
* body: alternating literal-run / match states over a 4 KiB LZSS-style
  ring window pre-filled with 0x20.
* no EOF marker: the stream just ends. Bit reads are guarded — fake
  zero bits are allowed in, but consuming any of them ends the stream
  cleanly (kwajd.c:394-414).

Copied from ``libmspack_tpu/codecs/lzh.py`` so that the port imports nothing
of the JAX package; the copy differs in nothing else.
"""
from __future__ import annotations

from ..errors import DataFormatError, ReadError
from .huffman import HuffTable

TABLEBITS = 9
MATCHLEN1_SYMS = 16
MATCHLEN2_SYMS = 16
LITLEN_SYMS = 32
OFFSET_SYMS = 64
LITERAL_SYMS = 256

_MASK32 = 0xFFFFFFFF


class _LZHBits:
    """MSB bit reader with KWAJ's fake-bit EOF guard.

    `input_end` is 0 while real input remains; after EOF it holds the
    number of fake bits injected so far. A decode step that leaves
    bits_left below input_end has consumed fake bits -> end of stream.
    """

    __slots__ = ("read_fn", "bit_buffer", "bits_left", "input_end",
                 "_buf", "_pos", "chunk")

    def __init__(self, read_fn, chunk=2048):
        self.read_fn = read_fn
        self.bit_buffer = 0
        self.bits_left = 0
        self.input_end = 0
        self._buf = b""
        self._pos = 0
        self.chunk = chunk

    def _next_byte(self) -> int:
        if self._pos >= len(self._buf):
            if self.input_end:
                self.input_end += 8
                self._buf = b"\x00"
            else:
                data = self.read_fn(self.chunk)
                if data:
                    self._buf = data
                else:
                    self.input_end = 8
                    self._buf = b"\x00"
            self._pos = 0
        b = self._buf[self._pos]
        self._pos += 1
        return b

    def ensure(self, n: int) -> None:
        while self.bits_left < n:
            b = self._next_byte()
            self.bit_buffer = (self.bit_buffer | (b << (24 - self.bits_left))) & _MASK32
            self.bits_left += 8

    def peek(self, n: int) -> int:
        return self.bit_buffer >> (32 - n)

    def remove(self, n: int) -> None:
        self.bit_buffer = (self.bit_buffer << n) & _MASK32
        self.bits_left -= n

    def read(self, n: int) -> int:
        self.ensure(n)
        v = self.peek(n)
        self.remove(n)
        return v

    @property
    def ended(self) -> bool:
        """True once any fake bits have been consumed."""
        return bool(self.input_end) and self.bits_left < self.input_end


class _EndOfStream(Exception):
    pass


def _read_safe(bits: _LZHBits, n: int) -> int:
    v = bits.read(n)
    if bits.ended:
        raise _EndOfStream
    return v


def _read_huffsym_safe(bits: _LZHBits, table: HuffTable) -> int:
    try:
        v = table.decode(bits)
    except Exception:
        raise DataFormatError("bad huffman symbol in LZH stream")
    if bits.ended:
        raise _EndOfStream
    return v


def _read_lens(bits: _LZHBits, tree_type: int, numsyms: int) -> bytearray:
    """Read one tree's code lengths in one of the 4 encodings
    (reference: kwajd.c:505-547)."""
    lens = bytearray(numsyms)
    if tree_type == 0:
        c = {16: 4, 32: 5, 64: 6, 256: 8}.get(numsyms, 0)
        for i in range(numsyms):
            lens[i] = c
    elif tree_type == 1:
        c = _read_safe(bits, 4)
        lens[0] = c
        for i in range(1, numsyms):
            if _read_safe(bits, 1) == 0:
                lens[i] = c
            elif _read_safe(bits, 1) == 0:
                c += 1
                lens[i] = c & 0xFF
            else:
                c = _read_safe(bits, 4)
                lens[i] = c
    elif tree_type == 2:
        c = _read_safe(bits, 4)
        lens[0] = c
        for i in range(1, numsyms):
            sel = _read_safe(bits, 2)
            if sel == 3:
                c = _read_safe(bits, 4)
            else:
                c = (c + sel - 1) & 0xFFFFFFFF
            lens[i] = c & 0xFF
    elif tree_type == 3:
        for i in range(numsyms):
            lens[i] = _read_safe(bits, 4)
    return lens


def _build_tree(bits: _LZHBits, tree_type: int, numsyms: int) -> HuffTable:
    lens = _read_lens(bits, tree_type, numsyms)
    try:
        return HuffTable(numsyms, TABLEBITS, lens, lsb=False)
    except Exception:
        raise DataFormatError("failed to build LZH huffman table")


def decompress(read_fn, write_fn) -> None:
    """Decode a KWAJ-LZH stream: read_fn(n)->bytes, write_fn(bytes)."""
    bits = _LZHBits(read_fn)
    window = bytearray(b"\x20" * 4096)
    pos = 0
    lit_run = 0

    try:
        types = [_read_safe(bits, 4) for _ in range(6)]
        matchlen1 = _build_tree(bits, types[0], MATCHLEN1_SYMS)
        matchlen2 = _build_tree(bits, types[1], MATCHLEN2_SYMS)
        litlen = _build_tree(bits, types[2], LITLEN_SYMS)
        offset_t = _build_tree(bits, types[3], OFFSET_SYMS)
        literal = _build_tree(bits, types[4], LITERAL_SYMS)

        out = bytearray()
        while not bits.input_end:
            length = _read_huffsym_safe(bits, matchlen2 if lit_run else matchlen1)
            if length > 0:
                length += 2
                lit_run = 0
                offs = _read_huffsym_safe(bits, offset_t) << 6
                offs |= _read_safe(bits, 6)
                for _ in range(length):
                    b = window[(pos + 4096 - offs) & 4095]
                    window[pos] = b
                    out.append(b)
                    pos = (pos + 1) & 4095
            else:
                length = _read_huffsym_safe(bits, litlen) + 1
                lit_run = 0 if length == 32 else 1
                for _ in range(length):
                    j = _read_huffsym_safe(bits, literal)
                    window[pos] = j
                    out.append(j)
                    pos = (pos + 1) & 4095
    except _EndOfStream:
        pass
    write_fn(bytes(out))
