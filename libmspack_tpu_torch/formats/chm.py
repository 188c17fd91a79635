"""CHM (ITSF helpfile) driver (L3).

Container semantics (reference: libmspack/mspack/chmd.c, chm.h):

* ITSF header (versions 1-3) + header-section table; HS0 gives file
  length, HS1 describes the PMGL/PMGI directory (chunk size, density,
  index root, first/last PMGL).
* directory entries are (name, section, offset, length) tuples with
  7-bit variable-length ENCINT integers.
* section 0 = raw bytes at sec0.offset; section 1 = one LZX stream
  with random access via the ResetTable system file (byte offsets of
  every reset interval) or a SpanInfo fallback.
* fast_find descends PMGI index chunks, binary-searches quickref
  entries, then scans linearly; names compare case-insensitively as
  UTF-8 (chmd.c:862-898).
* extraction keeps the LZX state and only rewinds on backtrack.

Copied from ``libmspack_tpu/formats/chm.py``: the directory parsing, the
section-1 plan from ControlData and the ResetTable, and the scalar and
``engine="native"`` paths are the reference driver's. Under
``engine="cuda"`` (the default) the whole MSCompressed section is decoded
once, the first time a section-1 file is extracted, and every file is
served from it: the ResetTable offsets cut the LZX stream into
reset-interval chunks, each a fresh LZX stream (chmd.c:1172-1183) on one
K3 lane of ``CudaLzxEngine``. The engine declines on an intel E8 header
(its state is stream-global) and on a flagged chunk; the driver declines a
section it cannot cut into chunks (no usable plan, no reset offsets for a
section longer than one interval, chunks that do not add up to the
section). Every decline is counted by reason in the engine's
``declines`` and noted in ``fallback_reasons``; the section then takes the
native path, and the scalar path if that fails too. Under strict mode
(``strict=True``, or the environment variable ``MSPACK_TPU_STRICT`` set, as
in the reference) a decline raises ``FallbackError`` instead. The engine's
trace budget, not a chunk-size limit,
bounds a launch.

Under ``engine="torch"`` (the JAX package's ``"jax"`` engine, its XLA-level
ops as PyTorch tensor ops) the section is cut into the same chunks and
each decoded by ``ops/lzx.lzx_stream_decode`` on ``device``, as the JAX
package's ``_sec1_bytes_device`` does. A section it cannot plan or decode
takes the scalar path (as in the JAX package); the decline is counted by
reason in ``torch_declines``, noted in ``fallback_reasons`` and raises
``FallbackError`` under strict mode. The JAX package's ``"jax"`` and
``"tpu"`` engines are the port's ``"torch"`` and ``"cuda"``.
"""
from __future__ import annotations

import collections
import os
from typing import List, Optional

from .._device import (DEVICE_ENGINES, new_declines, note_fallback,
                       resolve_device, resolve_engine, strict_mode)
from ..codecs import lzx as lzx_mod
from ..codecs.lzx import LzxDecompressor
from ..errors import (ArgsError, DataFormatError, DecrunchError, MSPackError,
                      ReadError, SeekError, SignatureError)
from ..system import (FileSink, PathOrBytes, Sink, open_source, read_exact,
                      source_length)

GUIDS = bytes([
    0x10, 0xFD, 0x01, 0x7C, 0xAA, 0x7B, 0xD0, 0x11,
    0x9E, 0x0C, 0x00, 0xA0, 0xC9, 0x22, 0xE6, 0xEC,
    0x11, 0xFD, 0x01, 0x7C, 0xAA, 0x7B, 0xD0, 0x11,
    0x9E, 0x0C, 0x00, 0xA0, 0xC9, 0x22, 0xE6, 0xEC,
])

CONTENT_NAME = "::DataSpace/Storage/MSCompressed/Content"
CONTROL_NAME = "::DataSpace/Storage/MSCompressed/ControlData"
SPANINFO_NAME = "::DataSpace/Storage/MSCompressed/SpanInfo"
RTABLE_NAME = ("::DataSpace/Storage/MSCompressed/Transform/"
               "{7FC28940-9D31-11D0-9B27-00A0C91E9C7C}/InstanceData/ResetTable")

FRAME_SIZE = lzx_mod.FRAME_SIZE
ENCINT_MAX_BYTES = 9


class ChmSection:
    def __init__(self, chm: "ChmHeader", sid: int):
        self.chm = chm
        self.id = sid


class ChmSec0(ChmSection):
    def __init__(self, chm):
        super().__init__(chm, 0)
        self.offset = 0


class ChmSec1(ChmSection):
    def __init__(self, chm):
        super().__init__(chm, 1)
        self.content: Optional[ChmFile] = None
        self.control: Optional[ChmFile] = None
        self.spaninfo: Optional[ChmFile] = None
        self.rtable: Optional[ChmFile] = None


class ChmFile:
    __slots__ = ("filename", "section", "offset", "length")

    def __init__(self, filename: str, section: ChmSection, offset: int,
                 length: int):
        self.filename = filename
        self.section = section
        self.offset = offset
        self.length = length

    def __repr__(self):
        return (f"<ChmFile {self.filename!r} sec={self.section.id if self.section else '?'} "
                f"off={self.offset} len={self.length}>")


class ChmHeader:
    def __init__(self, source_ref: PathOrBytes):
        self.source_ref = source_ref
        self.filename = source_ref if isinstance(source_ref, str) else None
        self.version = 0
        self.timestamp = 0
        self.language = 0
        self.length = 0
        self.dir_offset = 0
        self.chunk_size = 0
        self.density = 0
        self.depth = 0
        self.index_root = 0
        self.num_chunks = 0
        self.first_pmgl = 0
        self.last_pmgl = 0
        self.files: List[ChmFile] = []
        self.sysfiles: List[ChmFile] = []
        self.sec0 = ChmSec0(self)
        self.sec1 = ChmSec1(self)
        self._chunk_cache: dict[int, bytes] = {}

    def open_stream(self):
        return open_source(self.source_ref)


def _read_encint(buf: bytes, pos: int, end: int) -> tuple[int, int]:
    """ENCINT parse (reference: chmd.c:1444-1463). Returns (value, newpos);
    raises DataFormatError on truncation.

    Quirk preserved: with 64-bit off_t the reference reads at most 9
    bytes and stops *without error* even if the continuation bit is
    still set (the `i++` in the loop condition makes the bad-last-byte
    check unreachable); any further continuation bytes are left to be
    misparsed as the next field, exactly as the reference does."""
    result = 0
    c = 0x80
    i = 0
    while c & 0x80:
        i += 1
        if i > ENCINT_MAX_BYTES:
            break
        if pos >= end:
            raise DataFormatError("truncated ENCINT")
        c = buf[pos]
        pos += 1
        result = (result << 7) | (c & 0x7F)
    return result, pos


def _utf8_chars(b: bytes):
    """Decode UTF-8 the reference's lenient way (chmd.c:862-879)."""
    i = 0
    n = len(b)
    while i < n:
        x = b[i]
        i += 1
        if x < 0x80:
            yield x
        elif 0xC2 <= x < 0xE0 and i < n:
            yield ((x & 0x1F) << 6) | (b[i] & 0x3F)
            i += 1
        elif 0xE0 <= x < 0xF0 and i + 1 < n:
            yield ((x & 0x0F) << 12) | ((b[i] & 0x3F) << 6) | (b[i + 1] & 0x3F)
            i += 2
        elif 0xF0 <= x <= 0xF5 and i + 2 < n:
            c = (((x & 0x07) << 18) | ((b[i] & 0x3F) << 12)
                 | ((b[i + 1] & 0x3F) << 6) | (b[i + 2] & 0x3F))
            yield 0xFFFD if c > 0x10FFFF else c
            i += 3
        else:
            yield 0xFFFD


def _compare(s1: bytes, s2: bytes) -> int:
    """Case-insensitive UTF-8 compare (reference: chmd.c:883-898)."""
    it1, it2 = _utf8_chars(s1), _utf8_chars(s2)
    for c1, c2 in zip(it1, it2):
        if c1 == c2:
            continue
        l1 = ord(chr(c1).lower()[0]) if c1 <= 0x10FFFF else c1
        l2 = ord(chr(c2).lower()[0]) if c2 <= 0x10FFFF else c2
        if l1 != l2:
            return l1 - l2
    return len(s1) - len(s2)


class _DecompState:
    def __init__(self):
        self.chm: Optional[ChmHeader] = None
        self.length = 0
        self.offset = 0
        self.inoffset = 0
        self.lzx: Optional[LzxDecompressor] = None
        self.insrc = None
        self.outsink = None


class ChmDecompressor:
    """Pythonic equivalent of mschm_decompressor (mspack.h:1577-1724)."""

    def __init__(self, message=None, engine: str = "cuda", device="cuda",
                 strict=None):
        self.message = message or (lambda s: None)
        self.engine = resolve_engine(engine)
        self.device = resolve_device(device) \
            if self.engine in DEVICE_ENGINES else None
        self.strict = strict_mode(strict)
        self.fallback_reasons: dict[str, str] = {}
        self.cuda_engine = None    # lazy CudaLzxEngine
        # engine="torch": the ops' declines, by reason, and phase times (ms)
        self.torch_declines: collections.Counter = collections.Counter()
        self.torch_timings: dict[str, float] = {}
        self._scratch_out = None   # warm decode arena (native.Scratch)
        self._d: Optional[_DecompState] = None
        self._sec1_cache: tuple | None = None  # (chm, bytes)
        self.last_error = 0

    # -- open ------------------------------------------------------------

    def open(self, path: PathOrBytes) -> ChmHeader:
        return self._real_open(path, entire=True)

    def fast_open(self, path: PathOrBytes) -> ChmHeader:
        """Read only the bare headers; use fast_find for lookups."""
        return self._real_open(path, entire=False)

    def _real_open(self, path, entire: bool) -> ChmHeader:
        src = open_source(path)
        chm = ChmHeader(path)
        try:
            self._read_headers(src, chm, entire)
        except DataFormatError:
            if chm.files or chm.sysfiles:
                self.message("WARNING; contents are corrupt")
                return chm
            raise
        return chm

    def close(self, chm: ChmHeader) -> None:
        if self._d is not None and self._d.chm is chm:
            self._d = None

    def _read_headers(self, src, chm: ChmHeader, entire: bool) -> None:
        """reference: chmd.c:254-532."""
        buf = read_exact(src, 0x38)
        if buf[0:4] != b"ITSF":
            raise SignatureError("no ITSF signature")
        if buf[0x18:0x38] != GUIDS:
            raise SignatureError("incorrect GUIDs")
        chm.version = int.from_bytes(buf[4:8], "little")
        chm.timestamp = int.from_bytes(buf[0x10:0x14], "big")
        chm.language = int.from_bytes(buf[0x14:0x18], "little")
        if chm.version > 3:
            self.message("WARNING; CHM version > 3")

        hst = read_exact(src, 0x28)
        offset_hs0 = int.from_bytes(hst[0x00:0x08], "little")
        chm.dir_offset = int.from_bytes(hst[0x10:0x18], "little")
        chm.sec0.offset = int.from_bytes(hst[0x20:0x28], "little")
        for v in (offset_hs0, chm.dir_offset, chm.sec0.offset):
            if v >= 1 << 63:
                raise DataFormatError("negative 64-bit offset")

        src.seek(offset_hs0)
        hs0 = read_exact(src, 0x18)
        chm.length = int.from_bytes(hs0[0x08:0x10], "little")
        if chm.length >= 1 << 63:
            raise DataFormatError("negative file length")

        filelen = source_length(src)
        if chm.length > filelen:
            self.message("WARNING; file possibly truncated by %d bytes"
                         % (chm.length - filelen))
        elif chm.length < filelen:
            self.message("WARNING; possible %d extra bytes at end of file"
                         % (filelen - chm.length))

        src.seek(chm.dir_offset)
        hs1 = read_exact(src, 0x54)
        chm.dir_offset = src.tell()
        chm.chunk_size = int.from_bytes(hs1[0x10:0x14], "little")
        chm.density = int.from_bytes(hs1[0x14:0x18], "little")
        chm.depth = int.from_bytes(hs1[0x18:0x1C], "little")
        chm.index_root = int.from_bytes(hs1[0x1C:0x20], "little")
        chm.first_pmgl = int.from_bytes(hs1[0x20:0x24], "little")
        chm.last_pmgl = int.from_bytes(hs1[0x24:0x28], "little")
        chm.num_chunks = int.from_bytes(hs1[0x2C:0x30], "little")

        if chm.version < 3:
            chm.sec0.offset = chm.dir_offset + chm.chunk_size * chm.num_chunks

        if chm.sec0.offset > chm.length:
            raise DataFormatError("content section begins after file end")
        if chm.chunk_size < 0x14 + 2:
            raise DataFormatError("chunk size too small")
        if chm.num_chunks == 0:
            raise DataFormatError("no chunks")
        if chm.num_chunks > 100000:
            raise DataFormatError("more than 100,000 chunks")
        if chm.chunk_size > 8192:
            raise DataFormatError("chunk size over 8192")
        if chm.chunk_size * chm.num_chunks > chm.length:
            raise DataFormatError("chunks larger than entire file")
        if chm.chunk_size != 4096:
            self.message("WARNING; chunk size is not 4096")
        if chm.first_pmgl != 0:
            self.message("WARNING; first PMGL chunk is not zero")
        if chm.first_pmgl > chm.last_pmgl:
            raise DataFormatError("first pmgl after last pmgl")
        if chm.index_root != 0xFFFFFFFF and chm.index_root >= chm.num_chunks:
            raise DataFormatError("index_root outside valid range")

        if not entire:
            return

        if chm.first_pmgl:
            src.seek(chm.first_pmgl * chm.chunk_size, os.SEEK_CUR)
        num = chm.last_pmgl - chm.first_pmgl + 1
        errors = 0
        for _ in range(num):
            chunk = read_exact(src, chm.chunk_size)
            if chunk[0:4] != b"PMGL":
                continue
            qr = int.from_bytes(chunk[4:8], "little")
            if qr < 2:
                self.message("WARNING; PMGL quickref area is too small")
            if qr > chm.chunk_size - 0x14:
                self.message("WARNING; PMGL quickref area is too large")
            pos = 0x14
            end = chm.chunk_size - 2
            num_entries = int.from_bytes(chunk[end : end + 2], "little")
            try:
                while num_entries > 0:
                    num_entries -= 1
                    name_len, pos = _read_encint(chunk, pos, end)
                    name_len &= 0xFFFFFFFF  # reference stores in unsigned int
                    if name_len > end - pos:
                        raise DataFormatError("name overruns chunk")
                    name = chunk[pos : pos + name_len]
                    pos += name_len
                    section, pos = _read_encint(chunk, pos, end)
                    section &= 0xFFFFFFFF
                    offset, pos = _read_encint(chunk, pos, end)
                    length, pos = _read_encint(chunk, pos, end)

                    if name_len < 2 or not name[0] or not name[1]:
                        continue
                    if offset == 0 and length == 0 and \
                            name_len > 0 and name[-1:] == b"/":
                        continue
                    if section > 1:
                        self.message("invalid section number '%u'." % section)
                        continue
                    fi = ChmFile(name.decode("latin-1"),
                                 chm.sec0 if section == 0 else chm.sec1,
                                 offset, length)
                    if name[0:2] == b"::":
                        sname = fi.filename
                        if sname == CONTENT_NAME:
                            chm.sec1.content = fi
                        elif sname == CONTROL_NAME:
                            chm.sec1.control = fi
                        elif sname == SPANINFO_NAME:
                            chm.sec1.spaninfo = fi
                        elif sname == RTABLE_NAME:
                            chm.sec1.rtable = fi
                        chm.sysfiles.insert(0, fi)
                    else:
                        chm.files.append(fi)
            except DataFormatError:
                errors += 1
        if errors:
            raise DataFormatError("bad encint before all entries could be read")

    # -- fast find -------------------------------------------------------

    def fast_find(self, chm: ChmHeader, filename: str) -> Optional[ChmFile]:
        """reference: chmd.c:543-632. Returns None if not found."""
        src = chm.open_stream()
        fname = filename.encode("latin-1") if isinstance(filename, str) \
            else filename

        result = None
        if chm.index_root < chm.num_chunks:
            n = chm.index_root
            while True:
                chunk = self._read_chunk(chm, src, n)
                res = self._search_chunk(chm, chunk, fname)
                if res is None or res[0] <= 0:
                    result = res
                    break
                if chunk[3:4] == b"L":
                    result = res
                    break
                p, end = res[1], res[2]
                n, p = _read_encint(chunk, p, end)
        else:
            n = chm.first_pmgl
            while n <= chm.last_pmgl:
                chunk = self._read_chunk(chm, src, n)
                res = self._search_chunk(chm, chunk, fname)
                if res is not None and res[0] > 0:
                    result = res
                    break
                nxt = int.from_bytes(chunk[0x10:0x14], "little")
                if n == nxt:
                    break
                n = nxt

        if result is None or result[0] == 0:
            return None
        if result[0] < 0:
            raise DataFormatError("bad chunk while searching")
        found, p, end, chunk = result
        section, p = _read_encint(chunk, p, end)
        offset, p = _read_encint(chunk, p, end)
        length, p = _read_encint(chunk, p, end)
        return ChmFile(filename, chm.sec0 if section == 0 else chm.sec1,
                       offset, length)

    def _read_chunk(self, chm: ChmHeader, src, n: int) -> bytes:
        if n >= chm.num_chunks:
            raise DataFormatError("chunk number out of range")
        cached = chm._chunk_cache.get(n)
        if cached is not None:
            return cached
        src.seek(chm.dir_offset + n * chm.chunk_size)
        buf = read_exact(src, chm.chunk_size)
        if not (buf[0:3] == b"PMG" and buf[3] in (0x4C, 0x49)):
            raise SeekError("bad directory chunk signature")
        chm._chunk_cache[n] = buf
        return buf

    def _search_chunk(self, chm: ChmHeader, chunk: bytes, fname: bytes):
        """reference: chmd.c:704-842.

        Returns (found, pos, end, chunk): found 1 = entry found with pos
        at its data, 0 = not found, -1 = format error."""
        is_pmgl = chunk[3] == 0x4C
        entries_off = 0x14 if is_pmgl else 0x0C

        qr_size = int.from_bytes(chunk[4:8], "little")
        start = chm.chunk_size - 2
        end = chm.chunk_size - qr_size
        num_entries = int.from_bytes(chunk[start : start + 2], "little")
        qr_density = 1 + (1 << chm.density)
        qr_entries = (num_entries + qr_density - 1) // qr_density

        if num_entries == 0:
            return (-1, 0, 0, chunk)
        if qr_size > chm.chunk_size:
            return (-1, 0, 0, chunk)
        if qr_entries * 2 > start - end:
            self.message("WARNING; more quickrefs than quickref space")
            qr_entries = 0

        try:
            if qr_entries > 0:
                L, R = 0, qr_entries - 1
                cmp = 1
                M = 0
                while L <= R:
                    M = (L + R) >> 1
                    qroff = int.from_bytes(
                        chunk[start - (M << 1) : start - (M << 1) + 2],
                        "little") if M else 0
                    p = entries_off + qroff
                    name_len, p = _read_encint(chunk, p, end)
                    name_len &= 0xFFFFFFFF
                    if name_len > end - p:
                        return (-1, 0, 0, chunk)
                    cmp = _compare(fname, chunk[p : p + name_len])
                    if cmp == 0:
                        break
                    elif cmp < 0:
                        if M:
                            R = M - 1
                        else:
                            return (0, 0, 0, chunk)
                    else:
                        L = M + 1
                else:
                    M = (L + R) >> 1
                if cmp == 0:
                    p += name_len
                    return (1, p, end, chunk)
                qroff = int.from_bytes(
                    chunk[start - (M << 1) : start - (M << 1) + 2],
                    "little") if M else 0
                p = entries_off + qroff
                num_entries -= M * qr_density
                if num_entries > qr_density:
                    num_entries = qr_density
            else:
                p = entries_off

            result_p = None
            while num_entries > 0:
                num_entries -= 1
                name_len, p = _read_encint(chunk, p, end)
                name_len &= 0xFFFFFFFF
                if name_len > end - p:
                    return (-1, 0, 0, chunk)
                cmp = _compare(fname, chunk[p : p + name_len])
                p += name_len
                if cmp == 0:
                    return (1, p, end, chunk)
                if cmp < 0:
                    break
                if is_pmgl:
                    for _ in range(3):
                        while p < end and (chunk[p] & 0x80):
                            p += 1
                        p += 1
                else:
                    result_p = p
                    while p < end and (chunk[p] & 0x80):
                        p += 1
                    p += 1
            if is_pmgl:
                return (0, 0, 0, chunk)
            return (1, result_p, end, chunk) if result_p is not None \
                else (0, 0, 0, chunk)
        except DataFormatError:
            return (-1, 0, 0, chunk)

    # -- extract ---------------------------------------------------------

    def extract(self, file: ChmFile, output) -> None:
        """reference: chmd.c:906-1046."""
        if file is None or file.section is None:
            raise ArgsError("no file / no section")
        chm = file.section.chm

        d = self._d
        if d is None or d.chm is not chm:
            d = _DecompState()
            d.chm = chm
            d.insrc = chm.open_stream()
            self._d = d

        sink = output if isinstance(output, Sink) else FileSink(output)
        try:
            if not file.length:
                return
            if file.section.id == 0:
                d.insrc.seek(chm.sec0.offset + file.offset)
                length = file.length
                maxlen = chm.length - d.insrc.tell()
                if length > maxlen:
                    self.message("WARNING; file is %d bytes longer than CHM "
                                 "file" % (length - maxlen))
                todo = length
                while todo > 0:
                    chunk = d.insrc.read(min(512, todo))
                    if not chunk:
                        raise ReadError("EOF in section 0 file")
                    sink.write(chunk)
                    todo -= len(chunk)
            else:
                self._extract_sec1(d, file, sink)
        finally:
            if sink is not output and hasattr(sink, "close"):
                sink.close()

    def _extract_sec1(self, d: _DecompState, file: ChmFile, sink) -> None:
        if self.engine in ("native", "cuda", "torch"):
            if self.engine == "torch":
                blob = self._sec1_bytes_torch(d)
            else:
                blob = self._sec1_bytes_cuda(d) if self.engine == "cuda" \
                    else None
                if blob is None:
                    blob = self._sec1_bytes_native(d)
            if blob is not None:
                if file.offset + file.length > len(blob):
                    raise DecrunchError("file beyond decoded section")
                sink.write(blob[file.offset : file.offset + file.length])
                return
        if d.lzx is None or file.offset < d.offset:
            d.lzx = None
            self._init_decomp(d, file)

        if file.offset > d.length:
            raise DecrunchError("file offset beyond stream length")

        d.insrc.seek(d.inoffset)

        def skip_write(data: bytes) -> None:
            d.offset += len(data)

        writing = {"sink": None}

        def write_fn(data: bytes) -> None:
            d.offset += len(data)
            if writing["sink"] is not None:
                writing["sink"].write(data)

        # redirect LZX reads through d.insrc at d.inoffset
        try:
            skip = file.offset - d.offset
            if skip:
                d.lzx.decompress(skip, write_fn)
            length = file.length
            maxlen = d.length - file.offset
            if length > maxlen:
                self.message("WARNING; file is %d bytes longer than "
                             "compressed section" % (length - maxlen))
                length = maxlen + 1  # decompress but still error out
            writing["sink"] = sink
            d.lzx.decompress(length, write_fn)
        except MSPackError:
            d.lzx = None
            raise
        finally:
            d.inoffset = d.insrc.tell()

    def _sec1_plan(self, d: _DecompState):
        """Shared decode plan for the whole-section fast paths: returns
        (stream, window_bits, reset_interval, reset_offsets, length) or
        None when the scalar path is needed."""
        chm = d.chm
        sec = chm.sec1
        if sec.content is None:
            sec.content = self.fast_find(chm, CONTENT_NAME)
        if sec.control is None:
            sec.control = self.fast_find(chm, CONTROL_NAME)
        if (sec.content is None or sec.control is None
                or sec.control.length != 0x1C):
            return None
        data = self._read_sys_file(d, sec.control)
        if data[4:8] != b"LZXC":
            return None
        version = int.from_bytes(data[8:12], "little")
        mult = FRAME_SIZE if version == 2 else 1
        if version not in (1, 2):
            return None
        reset_interval = int.from_bytes(data[0x0C:0x10], "little") * mult
        window_size = int.from_bytes(data[0x10:0x14], "little") * mult
        window_bits = {0x8000: 15, 0x10000: 16, 0x20000: 17,
                       0x40000: 18, 0x80000: 19, 0x100000: 20,
                       0x200000: 21}.get(window_size)
        if window_bits is None or reset_interval == 0                 or reset_interval % FRAME_SIZE:
            return None
        res = self._read_reset_table(d, sec, 0)
        reset_offsets = None
        if res is not None:
            length, _ = res
            length += reset_interval - 1
            length &= -reset_interval
            reset_offsets = self._read_reset_offsets(
                d, sec, reset_interval // FRAME_SIZE,
                (length + reset_interval - 1) // reset_interval)
        else:
            length = self._read_spaninfo(d, sec)
        d.insrc.seek(chm.sec0.offset + sec.content.offset)
        stream = d.insrc.read(sec.content.length)
        return stream, window_bits, reset_interval, reset_offsets, length

    def sec1_chunk_plan(self, chm: ChmHeader):
        """Section 1 as independent reset-interval chunks, for
        external shard engines (parallel/mesh.decode_chm_sharded).
        The ResetTable IS the shard grid (chmd.c:1147-1175). Returns
        (chunks, sizes, window_bits) or None when no usable grid
        exists. Chunk-parallel callers must decline when intel E8
        fires (stream-global state, lzxd.c:707-713)."""
        d = _DecompState()
        d.chm = chm
        d.insrc = chm.open_stream()
        try:
            plan = self._sec1_plan(d)
            if plan is None:
                return None
            (stream, window_bits, reset_interval, reset_offsets,
             length) = plan
            if not reset_offsets:
                if length > reset_interval:
                    return None
                reset_offsets = [0]
            chunks, sizes = [], []
            for i, off in enumerate(reset_offsets):
                end = (reset_offsets[i + 1]
                       if i + 1 < len(reset_offsets) else len(stream))
                size = min(reset_interval, length - i * reset_interval)
                if size <= 0:
                    break
                chunks.append(stream[off:end])
                sizes.append(size)
            return chunks, sizes, window_bits
        except MSPackError:
            return None
        finally:
            if hasattr(d.insrc, "close"):
                d.insrc.close()

    def _cuda_engine(self):
        if self.cuda_engine is None:
            from ..parallel.cuda_pipeline import CudaLzxEngine
            self.cuda_engine = CudaLzxEngine(self.device)
        return self.cuda_engine

    def _decline(self, reason):
        """Count a decline of the driver's own; returns None."""
        self._cuda_engine().declines[reason] += 1

    def _sec1_bytes_cuda(self, d: _DecompState) -> bytes | None:
        """The whole section through ``CudaLzxEngine``, one lane per
        reset-interval chunk, cached; None declines (noted in
        ``fallback_reasons``; ``FallbackError`` under strict)."""
        if self._sec1_cache is not None and self._sec1_cache[0] is d.chm:
            return self._sec1_cache[1]
        eng = self._cuda_engine()
        before = dict(eng.declines)
        out = self._sec1_decode_cuda(d)
        if out is None:
            note_fallback(self, "chm_lzx_cuda", new_declines(eng, before))
        return out

    def _sec1_decode_cuda(self, d: _DecompState) -> bytes | None:
        chm = d.chm
        try:
            plan = self._sec1_plan(d)
        except MSPackError as e:
            return self._decline(f"section-1 plan: {type(e).__name__}")
        if plan is None:
            return self._decline("no section-1 plan")
        stream, window_bits, reset_interval, reset_offsets, length = plan
        if not reset_offsets:
            if length > reset_interval:
                return self._decline("no reset offsets past one interval")
            reset_offsets = [0]
        chunks, sizes = [], []
        for i, off in enumerate(reset_offsets):
            end = (reset_offsets[i + 1] if i + 1 < len(reset_offsets)
                   else len(stream))
            size = min(reset_interval, length - i * reset_interval)
            if size <= 0:
                break
            chunks.append(stream[off:end])
            sizes.append(size)
        if sum(sizes) != length:
            return self._decline("reset table lacks chunks")
        outs = self._cuda_engine().decode_streams(chunks, sizes, window_bits,
                                                  decline_on_intel=True)
        if outs is None:
            return None
        out = b"".join(outs)
        self._sec1_cache = (chm, out)
        return out

    def _sec1_bytes_torch(self, d: _DecompState) -> bytes | None:
        """The whole section through the tensor ops, one
        ``lzx_stream_decode`` per reset-interval chunk (each a fresh
        stream, chmd.c:1172-1183), cached; None declines (noted in
        ``fallback_reasons``; ``FallbackError`` under strict)."""
        if self._sec1_cache is not None and self._sec1_cache[0] is d.chm:
            return self._sec1_cache[1]
        declined = collections.Counter()
        out = self._sec1_decode_torch(d, declined)
        if out is None:
            self.torch_declines.update(declined)
            note_fallback(self, "chm_lzx_torch", declined)
        return out

    def _sec1_decode_torch(self, d: _DecompState, declined) -> bytes | None:
        from ..ops.lzx import lzx_stream_decode

        chm = d.chm
        try:
            plan = self._sec1_plan(d)
        except MSPackError as e:
            declined[f"section-1 plan: {type(e).__name__}"] += 1
            return None
        if plan is None:
            declined["no section-1 plan"] += 1
            return None
        stream, window_bits, reset_interval, reset_offsets, length = plan
        if not reset_offsets:
            reset_offsets = [0]
        parts = []
        for i, off in enumerate(reset_offsets):
            end = (reset_offsets[i + 1] if i + 1 < len(reset_offsets)
                   else len(stream))
            size = min(reset_interval, length - i * reset_interval)
            if size <= 0:
                break
            part = lzx_stream_decode(stream[off:end], window_bits, size,
                                     device=self.device, declines=declined,
                                     timings=self.torch_timings)
            if part is None:
                return None
            parts.append(part)
        out = b"".join(parts)
        if len(out) != length:
            declined["chunks do not add up to the section"] += 1
            return None
        self._sec1_cache = (chm, out)
        return out

    def _sec1_bytes_native(self, d: _DecompState) -> bytes | None:
        """Decode the whole MSCompressed section once with the native
        LZX engine and cache it; None falls back to the scalar path."""
        chm = d.chm
        if self._sec1_cache is not None and self._sec1_cache[0] is chm:
            return self._sec1_cache[1]
        try:
            from .. import native
            plan = self._sec1_plan(d)
            if plan is None:
                return None
            stream, window_bits, reset_interval, reset_offsets, length = plan
            if self._scratch_out is None:
                self._scratch_out = native.Scratch()
            out = self._scratch_out.get(max(length, 1))[:length]
            rframes = reset_interval // FRAME_SIZE
            if reset_offsets and len(reset_offsets) > 1:
                # reset points are independent decode chunks: thread them
                # (the ResetTable IS the parallel shard grid, SURVEY §2.4)
                sizes = [min(reset_interval, length - i * reset_interval)
                         for i in range(len(reset_offsets))]
                ok, intel = native.lzx_chunks_into(stream, reset_offsets,
                                                   window_bits, rframes,
                                                   out, sizes)
                if ok and intel:
                    # intel E8 curpos / frame counter / intel_started are
                    # stream-global in the reference (lzxd.c:707-713);
                    # chunk-local decode would diverge — redo sequentially
                    ok = native.lzx_decode_into(stream, len(stream),
                                                window_bits, rframes, out,
                                                length)
                if not ok:
                    return None
            elif not native.lzx_decode_into(stream, len(stream),
                                            window_bits, rframes, out,
                                            length):
                return None
            self._sec1_cache = (chm, out)
            return out
        except MSPackError:
            return None
        except Exception:
            return None

    def _init_decomp(self, d: _DecompState, file: ChmFile) -> None:
        """reference: chmd.c:1072-1186."""
        chm = d.chm
        sec = chm.sec1
        if sec.content is None:
            sec.content = self.fast_find(chm, CONTENT_NAME)
        if sec.content is None or sec.content.section is None:
            raise DataFormatError("no Content system file")
        if sec.control is None:
            sec.control = self.fast_find(chm, CONTROL_NAME)
        if sec.control is None or sec.control.section is None:
            raise DataFormatError("no ControlData system file")

        if sec.control.length != 0x1C:
            raise DataFormatError("ControlData file is wrong size")
        data = self._read_sys_file(d, sec.control)
        if data[4:8] != b"LZXC":
            raise SignatureError("no LZXC signature")
        version = int.from_bytes(data[8:12], "little")
        if version == 1:
            reset_interval = int.from_bytes(data[0x0C:0x10], "little")
            window_size = int.from_bytes(data[0x10:0x14], "little")
        elif version == 2:
            reset_interval = int.from_bytes(data[0x0C:0x10], "little") * FRAME_SIZE
            window_size = int.from_bytes(data[0x10:0x14], "little") * FRAME_SIZE
        else:
            raise DataFormatError("bad controldata version")

        window_bits = {0x8000: 15, 0x10000: 16, 0x20000: 17, 0x40000: 18,
                       0x80000: 19, 0x100000: 20, 0x200000: 21}.get(window_size)
        if window_bits is None:
            raise DataFormatError("bad controldata window size")
        if reset_interval == 0 or reset_interval % FRAME_SIZE:
            raise DataFormatError("bad controldata reset interval")

        entry = file.offset // reset_interval
        entry *= reset_interval // FRAME_SIZE

        res = self._read_reset_table(d, sec, entry)
        if res is not None:
            length, offset = res
            length += reset_interval - 1
            length &= -reset_interval
        else:
            entry = 0
            offset = 0
            length = self._read_spaninfo(d, sec)

        d.inoffset = chm.sec0.offset + sec.content.offset + offset
        d.offset = entry * FRAME_SIZE
        d.length = length
        remaining = length - d.offset

        d.insrc.seek(d.inoffset)
        d.lzx = LzxDecompressor(d.insrc.read, window_bits,
                                reset_interval // FRAME_SIZE,
                                remaining, False, 4096,
                                message=self.message)

    def _read_reset_table(self, d: _DecompState, sec: ChmSec1,
                          entry: int):
        """reference: chmd.c:1195-1267. Returns (length, offset) or None."""
        chm = d.chm
        if sec.rtable is None:
            sec.rtable = self.fast_find(chm, RTABLE_NAME)
        if sec.rtable is None or sec.rtable.section is None:
            return None
        if sec.rtable.length < 0x28 or sec.rtable.length > 1000000:
            return None
        try:
            data = self._read_sys_file(d, sec.rtable)
        except MSPackError:
            return None
        if int.from_bytes(data[0x20:0x24], "little") != FRAME_SIZE:
            return None
        length = int.from_bytes(data[0x10:0x18], "little")
        if length >= 1 << 63:
            return None
        entrysize = int.from_bytes(data[0x08:0x0C], "little")
        num_entries = int.from_bytes(data[0x04:0x08], "little")
        table_offset = int.from_bytes(data[0x0C:0x10], "little")
        pos = table_offset + entry * entrysize
        if entry < num_entries and pos <= sec.rtable.length - entrysize:
            if entrysize == 4:
                offset = int.from_bytes(data[pos : pos + 4], "little")
            elif entrysize == 8:
                offset = int.from_bytes(data[pos : pos + 8], "little")
                if offset >= 1 << 63:
                    return None
            else:
                return None
            return (length, offset)
        return None

    def _read_reset_offsets(self, d: _DecompState, sec: ChmSec1,
                            step: int, n_chunks: int):
        """Compressed-stream byte offsets of every reset point (entries
        0, step, 2*step, ... of the ResetTable). None when the table
        cannot vouch for them (then the sequential path runs)."""
        if step <= 0 or n_chunks <= 0:
            return None
        try:
            data = self._read_sys_file(d, sec.rtable)
        except MSPackError:
            return None
        entrysize = int.from_bytes(data[0x08:0x0C], "little")
        num_entries = int.from_bytes(data[0x04:0x08], "little")
        table_offset = int.from_bytes(data[0x0C:0x10], "little")
        if entrysize not in (4, 8):
            return None
        offsets = []
        prev = -1
        for k in range(n_chunks):
            entry = k * step
            pos = table_offset + entry * entrysize
            if entry >= num_entries or pos > len(data) - entrysize:
                return None
            off = int.from_bytes(data[pos:pos + entrysize], "little")
            if off >= 1 << 63 or off <= prev:
                return None
            offsets.append(off)
            prev = off
        return offsets

    def _read_spaninfo(self, d: _DecompState, sec: ChmSec1) -> int:
        """reference: chmd.c:1275-1315."""
        chm = d.chm
        if sec.spaninfo is None:
            sec.spaninfo = self.fast_find(chm, SPANINFO_NAME)
        if sec.spaninfo is None or sec.spaninfo.section is None:
            raise DataFormatError("no SpanInfo system file")
        if sec.spaninfo.length != 8:
            raise DataFormatError("SpanInfo file is wrong size")
        data = self._read_sys_file(d, sec.spaninfo)
        length = int.from_bytes(data, "little")
        if length >= 1 << 63 or length <= 0:
            raise DataFormatError("output length is invalid")
        return length

    def _read_sys_file(self, d: _DecompState, file: ChmFile) -> bytes:
        if file is None or file.section is None or file.section.id != 0:
            raise DataFormatError("system file not in section 0")
        d.insrc.seek(d.chm.sec0.offset + file.offset)
        return read_exact(d.insrc, file.length)
