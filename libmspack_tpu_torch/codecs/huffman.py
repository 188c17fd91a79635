"""Canonical Huffman decode tables (L1 primitive).

Builds the reference's hybrid decode structure (reference:
libmspack/mspack/readhuff.h:83-176): a direct `2^nbits` lookup for codes
of length <= nbits, plus binary-tree overflow nodes for longer codes (up
to 16 bits). Table entries < nsyms are leaves; entries >= nsyms are
internal node indices whose children live at table[2n] / table[2n+1].

The LSB variant stores bit-reversed indices so that deflate's LSB-first
bit order indexes the same physical table.

`decode_symbol_*` mirror READ_HUFFSYM (readhuff.h:39-66): ensure 16
bits, one table probe, optional tree walk, then remove len(sym) bits.

Copied from ``libmspack_tpu/codecs/huffman.py`` so that the port imports nothing
of the JAX package; the copy differs in nothing else.
"""
from __future__ import annotations

from ..errors import DecrunchError
from .bitstream import LSBBitReader, MSBBitReader

HUFF_MAXBITS = 16


def _bitrev(value: int, nbits: int) -> int:
    out = 0
    for _ in range(nbits):
        out = (out << 1) | (value & 1)
        value >>= 1
    return out


def make_decode_table(nsyms: int, nbits: int, lengths, lsb: bool) -> list | None:
    """Build a decode table; returns None on invalid (over/under-subscribed) code.

    lengths: sequence of code lengths per symbol (0 = absent).
    Table size is (1 << nbits) + nsyms * 2.
    """
    table = [0] * ((1 << nbits) + nsyms * 2)
    pos = 0
    table_mask = 1 << nbits
    bit_mask = table_mask >> 1

    # direct-mapped fill for short codes
    for bit_num in range(1, nbits + 1):
        for sym in range(nsyms):
            if lengths[sym] != bit_num:
                continue
            leaf = _bitrev(pos >> (nbits - bit_num), bit_num) if lsb else pos
            pos += bit_mask
            if pos > table_mask:
                return None  # table overrun
            if lsb:
                step = 1 << bit_num
                for i in range(bit_mask):
                    table[leaf + i * step] = sym
            else:
                for i in range(bit_mask):
                    table[leaf + i] = sym
        bit_mask >>= 1

    if pos == table_mask:
        return table

    # mark remaining direct entries unused
    for i in range(pos, table_mask):
        leaf = _bitrev(i, nbits) if lsb else i
        table[leaf] = 0xFFFF

    next_symbol = max(table_mask >> 1, nsyms)

    pos <<= 16
    table_mask <<= 16
    bit_mask = 1 << 15

    for bit_num in range(nbits + 1, HUFF_MAXBITS + 1):
        for sym in range(nsyms):
            if lengths[sym] != bit_num:
                continue
            if pos >= table_mask:
                return None  # table overflow
            prefix = pos >> 16
            leaf = _bitrev(prefix, nbits) if lsb else prefix
            for fill in range(bit_num - nbits):
                if table[leaf] == 0xFFFF:
                    table[next_symbol << 1] = 0xFFFF
                    table[(next_symbol << 1) + 1] = 0xFFFF
                    table[leaf] = next_symbol
                    next_symbol += 1
                leaf = table[leaf] << 1
                if (pos >> (15 - fill)) & 1:
                    leaf += 1
            table[leaf] = sym
            pos += bit_mask
        bit_mask >>= 1

    return table if pos == table_mask else None


class HuffTable:
    """A built decode table plus the metadata needed to decode symbols."""

    __slots__ = ("table", "lengths", "nsyms", "nbits", "lsb", "empty")

    def __init__(self, nsyms: int, nbits: int, lengths, lsb: bool,
                 allow_empty: bool = False):
        self.nsyms = nsyms
        self.nbits = nbits
        self.lengths = list(lengths)
        self.lsb = lsb
        self.empty = False
        table = make_decode_table(nsyms, nbits, self.lengths, lsb)
        if table is None:
            if allow_empty and not any(self.lengths):
                # empty tree: tolerated, but decoding from it is an error
                # (reference: lzxd.c:111-125 BUILD_TABLE_MAYBE_EMPTY)
                self.empty = True
                self.table = []
                return
            raise DecrunchError("failed to build huffman table")
        self.table = table

    def decode(self, bits) -> int:
        """Decode one symbol from an MSB or LSB bit reader."""
        if self.empty:
            raise DecrunchError("symbol needed but huffman tree is empty")
        bits.ensure(HUFF_MAXBITS)
        sym = self.table[bits.peek(self.nbits)]
        if sym >= self.nsyms:
            if self.lsb:
                sym = self._traverse_lsb(bits, sym)
            else:
                sym = self._traverse_msb(bits, sym)
        bits.remove(self.lengths[sym])
        return sym

    def _traverse_msb(self, bits: MSBBitReader, sym: int) -> int:
        idx = 1 << (32 - self.nbits)
        while True:
            idx >>= 1
            if idx == 0:
                raise DecrunchError("out of bits decoding huffman symbol")
            sym = self.table[(sym << 1) | (1 if bits.bit_buffer & idx else 0)]
            if sym < self.nsyms:
                return sym

    def _traverse_lsb(self, bits: LSBBitReader, sym: int) -> int:
        idx = self.nbits - 1
        while True:
            idx += 1
            if idx > HUFF_MAXBITS:
                raise DecrunchError("out of bits decoding huffman symbol")
            sym = self.table[(sym << 1) | ((bits.bit_buffer >> idx) & 1)]
            if sym < self.nsyms:
                return sym
