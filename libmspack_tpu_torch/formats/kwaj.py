"""KWAJ archive driver (L3): MS-DOS COMPRESS.EXE variants.

Header semantics (reference: libmspack/mspack/kwajd.c:151-332):

* signature "KWAJ\\xD1\\x27\\xF0\\x88", 16-bit compression method,
  16-bit data offset, 16-bit optional-header flags.
* optional headers in order: 32-bit uncompressed length, 2 unknown
  bytes, length-prefixed unknown section, 8.3 filename (<=9 incl NUL)
  and extension (<=4 incl NUL), length-prefixed extra text.
* methods: 0 none (copy), 1 xor 0xFF, 2 SZDD-LZSS (QBASIC mode!),
  3 LZH, 4 MSZIP (length-prefixed CK frames).

Copied from ``libmspack_tpu/formats/kwaj.py`` so that the port imports
nothing of the JAX package; the copy differs in nothing else. The JAX
package decodes KWAJ with the scalar codecs only, and so does the port.
"""
from __future__ import annotations

import dataclasses
import os

from ..codecs import lzh, lzss
from ..codecs.mszip import MszipDecompressor
from ..errors import DataFormatError, ReadError, SignatureError
from ..system import (BytesSink, FileSink, PathOrBytes, Sink, open_source,
                      read_exact)

SIGNATURE = bytes([0x4B, 0x57, 0x41, 0x4A, 0x88, 0xF0, 0x27, 0xD1])

COMP_NONE = 0
COMP_XOR = 1
COMP_SZDD = 2
COMP_LZH = 3
COMP_MSZIP = 4

HDR_HASLENGTH = 0x01
HDR_HASUNKNOWN1 = 0x02
HDR_HASUNKNOWN2 = 0x04
HDR_HASFILENAME = 0x08
HDR_HASFILEEXT = 0x10
HDR_HASEXTRATEXT = 0x20

INPUT_SIZE = 2048


@dataclasses.dataclass
class KwajHeader:
    comp_type: int
    data_offset: int
    headers: int
    length: int = 0
    filename: str | None = None
    extra: bytes | None = None


def _read_sz_field(src, maxlen: int) -> str:
    """Read a NUL-terminated string of at most `maxlen` bytes (incl NUL),
    repositioning the source just past the terminator
    (reference: kwajd.c:215-239)."""
    start = src.tell()
    buf = src.read(maxlen)
    if len(buf) < 2:
        raise ReadError("truncated KWAJ filename field")
    nul = buf.find(b"\x00")
    if nul < 0:
        if len(buf) == maxlen:
            raise DataFormatError("KWAJ filename not NUL terminated")
        # EOF with no terminator: reference drops the final copied byte
        # (the fn-- at kwajd.c:224 assumes it removed a NUL)
        out = buf[:-1]
        i = len(buf)
    else:
        out = buf[:nul]
        i = nul
    src.seek(start + i + 1, os.SEEK_SET)
    return out.decode("latin-1")


class KwajDecompressor:
    """Pythonic equivalent of mskwaj_decompressor (mspack.h:2045-2244)."""

    def open(self, path: PathOrBytes) -> "KwajFile":
        src = open_source(path)
        buf = read_exact(src, 14)
        if buf[0:4] != SIGNATURE[0:4] or buf[4:8] != SIGNATURE[4:8]:
            raise SignatureError("not a KWAJ file")
        hdr = KwajHeader(
            comp_type=int.from_bytes(buf[8:10], "little"),
            data_offset=int.from_bytes(buf[10:12], "little"),
            headers=int.from_bytes(buf[12:14], "little"),
        )
        if hdr.headers & HDR_HASLENGTH:
            hdr.length = int.from_bytes(read_exact(src, 4), "little")
        if hdr.headers & HDR_HASUNKNOWN1:
            read_exact(src, 2)
        if hdr.headers & HDR_HASUNKNOWN2:
            n = int.from_bytes(read_exact(src, 2), "little")
            src.seek(n, os.SEEK_CUR)
        if hdr.headers & (HDR_HASFILENAME | HDR_HASFILEEXT):
            name = ""
            if hdr.headers & HDR_HASFILENAME:
                name = _read_sz_field(src, 9)
            if hdr.headers & HDR_HASFILEEXT:
                name += "." + _read_sz_field(src, 4)
            hdr.filename = name
        if hdr.headers & HDR_HASEXTRATEXT:
            n = int.from_bytes(read_exact(src, 2), "little")
            hdr.extra = read_exact(src, n)
        return KwajFile(src, hdr)

    def extract(self, file: "KwajFile", output) -> None:
        file.extract(output)

    def decompress(self, input_path: PathOrBytes, output) -> None:
        self.extract(self.open(input_path), output)

    def decompress_bytes(self, data: PathOrBytes) -> bytes:
        sink = BytesSink()
        self.decompress(data, sink)
        return sink.getvalue()


class KwajFile:
    def __init__(self, src, header: KwajHeader):
        self.source = src
        self.header = header

    @property
    def filename(self):
        return self.header.filename

    def extract(self, output) -> None:
        hdr = self.header
        self.source.seek(hdr.data_offset)
        sink = output if isinstance(output, Sink) else FileSink(output)
        try:
            if hdr.comp_type in (COMP_NONE, COMP_XOR):
                while True:
                    chunk = self.source.read(INPUT_SIZE)
                    if not chunk:
                        break
                    if hdr.comp_type == COMP_XOR:
                        chunk = bytes(b ^ 0xFF for b in chunk)
                    sink.write(chunk)
            elif hdr.comp_type == COMP_SZDD:
                data = self.source.read(-1)
                sink.write(lzss.decompress(data, lzss.MODE_QBASIC))
            elif hdr.comp_type == COMP_LZH:
                lzh.decompress(self.source.read, sink.write)
            elif hdr.comp_type == COMP_MSZIP:
                zip_ = MszipDecompressor(self.source.read, INPUT_SIZE)
                zip_.decompress_kwaj(sink.write)
            else:
                raise DataFormatError(
                    f"unknown KWAJ compression method {hdr.comp_type}")
        finally:
            if sink is not output and hasattr(sink, "close"):
                sink.close()
