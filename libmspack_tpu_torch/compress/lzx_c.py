"""LZX compressor — uncompressed-block encoder (compress path, stage 1).

The reference ships no LZX compressor at all (reference: lzxc.c:18 is a
stub). This encoder emits valid LZX streams using only UNCOMPRESSED
blocks (block type 3), which every LZX decoder must accept. It is the
foundation of the compress path: correct framing, reset intervals,
DELTA chunk headers, and per-frame byte ranges (for CAB CFDATA blocks
and CHM ResetTables). Entropy-coded (VERBATIM) block support layers on
top in lzx_opt.

Bitstream format notes (mirrors codecs/lzx.py, reference lzxd.c):
* bits pack MSB-first into 16-bit little-endian units;
* an uncompressed block is: 3-bit type, 24-bit length, align-to-16
  (1-16 bits: a full extra unit if already aligned), then 12 raw bytes
  of R0/R1/R2, then the raw data bytes;
* a 1-bit "intel E8 header" (0 here) precedes the first block and the
  first block after every reset interval;
* odd-length uncompressed blocks are followed by a pad byte if another
  block follows.

Copied from ``libmspack_tpu/compress/lzx_c.py`` so that the port imports nothing
of the JAX package; the copy differs in nothing else.
"""
from __future__ import annotations

FRAME_SIZE = 32768


class LzxBitWriter:
    """MSB-first bit packer over 16-bit little-endian units."""

    def __init__(self):
        self.out = bytearray()
        self._pending = 0
        self._count = 0

    def write_bits(self, value: int, nbits: int) -> None:
        self._pending = (self._pending << nbits) | (value & ((1 << nbits) - 1))
        self._count += nbits
        while self._count >= 16:
            unit = (self._pending >> (self._count - 16)) & 0xFFFF
            self.out += unit.to_bytes(2, "little")
            self._count -= 16
        self._pending &= (1 << self._count) - 1

    def align16(self) -> None:
        """Pad exactly as lzxd's uncompressed-block alignment consumes:
        1-16 bits (a whole unit if already aligned)."""
        pad = 16 - self._count if self._count else 16
        self.write_bits(0, pad)

    def write_bytes(self, data: bytes) -> None:
        assert self._count == 0, "byte write while bit-unaligned"
        self.out += data

    @property
    def bit_aligned(self) -> bool:
        return self._count == 0


def compress_stored(data: bytes, reset_interval: int = 0,
                    is_delta: bool = False) -> tuple[bytes, list[int]]:
    """Encode `data` as an LZX stream of uncompressed blocks.

    reset_interval is in frames (0 = never reset, CAB style).
    Returns (stream_bytes, frame_offsets): frame_offsets[i] is the byte
    offset in the stream where frame i's input begins (the CHM
    ResetTable / CAB CFDATA carve points).
    """
    w = LzxBitWriter()
    offsets = []
    nframes = (len(data) + FRAME_SIZE - 1) // FRAME_SIZE
    if nframes == 0:
        nframes = 1  # zero-length stream still gets one (empty) block
    for i in range(nframes):
        frame = data[i * FRAME_SIZE : (i + 1) * FRAME_SIZE]
        offsets.append(len(w.out))
        if is_delta:
            w.write_bits(0, 16)  # chunk size field (skipped by decoder)
        if i == 0 or (reset_interval and i % reset_interval == 0):
            w.write_bits(0, 1)   # no intel E8 filesize
        w.write_bits(3, 3)       # LZX_BLOCKTYPE_UNCOMPRESSED
        w.write_bits(len(frame), 24)
        w.align16()
        w.write_bytes(b"\x01\x00\x00\x00" * 3)  # R0 = R1 = R2 = 1
        w.write_bytes(frame)
        if (len(frame) & 1) and i + 1 < nframes:
            w.write_bytes(b"\x00")  # realign pad before next block header
    return bytes(w.out), offsets
