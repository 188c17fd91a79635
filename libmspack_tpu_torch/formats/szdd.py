"""SZDD archive driver (L3): MS-DOS COMPRESS.EXE/EXPAND.EXE format.

Header semantics (reference: libmspack/mspack/szddd.c:137-216):

* normal: 8-byte signature "SZDD\\x88\\xF0\\x27\\x33", byte 0x41 ('A'),
  missing filename character, 32-bit uncompressed length; data at 14.
* QBasic: 8-byte signature "SZ \\x88\\xF0\\x27\\x33\\xD1", 32-bit
  length; data at 12; LZSS QBASIC mode.

Copied from ``libmspack_tpu/formats/szdd.py``; the engines differ:
``"cuda"`` (the default) and ``"torch"`` decode the LZSS stream with the
port's device tensor ops on ``device`` (``ops/lzss.py``, the port of the
JAX package's ``engine="jax"``, ``ops/lzss_jax.py``: SZDD has no
hand-written kernel, so both names take that one path); ``"native"`` is the C++ engine
(``native.lzss_decompress``), ``"auto"`` is ``"native"`` when it builds,
and ``"scalar"`` the Python codec. All are bit-exact.
"""
from __future__ import annotations

import dataclasses

from .._device import DEVICE_ENGINES, resolve_device, resolve_engine
from ..codecs import lzss
from ..errors import DataFormatError, SignatureError
from ..system import (BytesSink, FileSink, PathOrBytes, Sink, open_source,
                      read_exact)

SIGNATURE_EXPAND = bytes([0x53, 0x5A, 0x44, 0x44, 0x88, 0xF0, 0x27, 0x33])
SIGNATURE_QBASIC = bytes([0x53, 0x5A, 0x20, 0x88, 0xF0, 0x27, 0x33, 0xD1])

FMT_NORMAL = 0
FMT_QBASIC = 1


@dataclasses.dataclass
class SzddHeader:
    format: int
    missing_char: int
    length: int
    data_offset: int


class SzddDecompressor:
    """Pythonic equivalent of msszdd_decompressor (mspack.h:1792-1965)."""

    def __init__(self, engine: str = "cuda", device="cuda"):
        self.engine = resolve_engine(engine)
        self.device = resolve_device(device) \
            if self.engine in DEVICE_ENGINES else None

    def open(self, path: PathOrBytes) -> "SzddFile":
        src = open_source(path)
        sig = read_exact(src, 8)
        if sig == SIGNATURE_EXPAND:
            rest = read_exact(src, 6)
            if rest[0] != 0x41:
                raise DataFormatError("SZDD: bad mode byte")
            hdr = SzddHeader(FMT_NORMAL, rest[1],
                             int.from_bytes(rest[2:6], "little"), 14)
        elif sig == SIGNATURE_QBASIC:
            rest = read_exact(src, 4)
            hdr = SzddHeader(FMT_QBASIC, 0,
                             int.from_bytes(rest, "little"), 12)
        else:
            raise SignatureError("not an SZDD file")
        return SzddFile(src, hdr, self.engine, self.device)

    def extract(self, file: "SzddFile", output) -> None:
        file.extract(output)

    def decompress(self, input_path: PathOrBytes, output) -> None:
        self.extract(self.open(input_path), output)

    def decompress_bytes(self, data: PathOrBytes) -> bytes:
        sink = BytesSink()
        self.decompress(data, sink)
        return sink.getvalue()


class SzddFile:
    def __init__(self, src, header: SzddHeader, engine: str = "scalar",
                 device=None):
        self.source = src
        self.header = header
        self.engine = engine
        self.device = device

    @property
    def length(self) -> int:
        return self.header.length

    @property
    def missing_char(self) -> int:
        return self.header.missing_char

    def extract(self, output) -> None:
        self.source.seek(self.header.data_offset)
        data = self.source.read(-1)
        mode = lzss.MODE_EXPAND if self.header.format == FMT_NORMAL \
            else lzss.MODE_QBASIC
        if self.engine in DEVICE_ENGINES:
            from ..ops import lzss as lzss_ops
            out = lzss_ops.decompress(data, mode, self.device)
        elif self.engine == "native":
            from .. import native
            out = native.lzss_decompress(data, mode)
        else:
            out = lzss.decompress(data, mode)
        sink = output if isinstance(output, Sink) else FileSink(output)
        try:
            sink.write(out)
        finally:
            if sink is not output and hasattr(sink, "close"):
                sink.close()
