"""CAB archive driver (L3): Microsoft Cabinet files.

Container semantics (reference: libmspack/mspack/cabd.c, cab.h):

* CFHEADER / CFFOLDER / CFFILE / CFDATA little-endian structures with
  optional reserved areas and prev/next cabinet names.
* folders are independent compressed streams (NONE/MSZIP/QUANTUM/LZX);
  files are byte ranges inside a folder's uncompressed stream.
* data blocks are <=32768 bytes uncompressed, with a per-block XOR
  checksum; blocks may split across cabinet files in a set and are
  reassembled transparently; Quantum blocks get a 0xFF trailer byte
  injected so the decoder can realign (cabd.c:1327-1332).
* extraction keeps decoder state between calls and only rewinds when a
  requested offset precedes the current position (cabd.c:1141-1177).
* salvage / fix-mszip params relax validation for corrupt archives.

Copied from ``libmspack_tpu/formats/cab.py``: the parsing, search, merge,
block reading, checksums, scalar extraction and ``engine="native"`` paths
are the reference driver's. Engines:

* ``"cuda"`` (the default): an MSZIP, LZX or Quantum folder is decoded
  whole on ``device`` the first time one of its files is extracted, and
  every file is served from that folder's bytes: MSZIP by
  ``CudaMszipEngine`` (K1), LZX by ``CudaLzxEngine`` (K3; CAB LZX never
  resets, cabd.c:1249-1250, so a folder is one stream), Quantum by
  ``CudaQtmEngine`` (K4; one stream per folder, a 0xFF after every
  block). Salvage mode, fix-MSZIP mode on an MSZIP folder, NONE folders,
  a folder whose blocks cannot be collected (bad checksum, missing 'CK')
  and a folder the engine declines take the scalar path, which raises the
  reference's error where there is one. The last two are noted in
  ``fallback_reasons``; under strict mode (``strict=True``, or the
  environment variable ``MSPACK_TPU_STRICT`` set, as in the reference)
  they raise ``FallbackError`` instead, as does an MSZIP folder the engine
  had to re-decode on the host;
* ``"torch"``: the JAX package's ``"jax"`` engine (its XLA-level ops)
  as PyTorch tensor ops on ``device``: an MSZIP folder (not in fix-MSZIP
  mode) through ``ops/inflate.inflate_folder``, an LZX folder through
  ``ops/lzx.lzx_stream_decode``, each decoded whole and cached as under
  ``"cuda"``. Quantum and NONE folders, salvage and fix-MSZIP take the
  scalar path, as in the JAX package. A folder the ops decline (or whose
  blocks cannot be collected) takes the scalar path too; the decline is
  counted by reason in ``torch_declines`` and noted in
  ``fallback_reasons``, and raises ``FallbackError`` under strict mode. A
  Quantum folder, which no tensor op decodes, is noted the same way;
* ``"native"``: the multithreaded C++ engine (``native/``), as in the
  reference driver; ``"auto"`` is ``"native"`` when it builds, else
  ``"scalar"``;
* ``"scalar"``: the Python codecs only.

The JAX package's ``"jax"`` and ``"tpu"`` engines are the port's
``"torch"`` and ``"cuda"``.

Spans (``tracing``): ``mspack.cab.open`` and ``mspack.cab.extract`` around
the two calls; inside them ``mspack.cab.parse`` (the header and file walk),
``mspack.cab.collect`` (a folder's CFDATA blocks read and checked for the
CUDA engine) and ``mspack.cab.write`` (a file's bytes into its sink from
the decoded folder).

The collect (``collect_mszip_frames``, ``collect_raw_blocks``) walks and
checks a folder that lies in one cabinet in one native call
(``native.cab_walk``); salvage mode, a folder over several cabinets and
any folder the walk refuses are read by the block reader, as in the
reference driver. ``collect_routes`` counts the folders of each route
(``collect_native``, ``collect_python``). An MSZIP folder's frames come
without their 'CK' signature, as every engine takes them (the JAX
package's keep it).
"""
from __future__ import annotations

import collections
import os
from typing import Callable, List, Optional

from .._device import (DEVICE_ENGINES, new_declines, note_fallback,
                       resolve_device, resolve_engine, strict_mode)
from ..codecs.lzx import LzxDecompressor
from ..codecs.mszip import MszipDecompressor
from ..codecs.qtm import QtmDecompressor
from ..errors import (ArgsError, ChecksumError, DataFormatError, DecrunchError,
                      MSPackError, ReadError, SignatureError)
from ..system import (FileSink, PathOrBytes, Sink, open_source, read_exact,
                      source_length)
from ..tracing import span, spanned

# structure sizes / offsets (reference: cab.h:15-45)
CFHEAD_SIZEOF = 0x24
CFHEADEXT_SIZEOF = 4
CFFOLD_SIZEOF = 8
CFFILE_SIZEOF = 16
CFDATA_SIZEOF = 8

COMPTYPE_MASK = 0x000F
COMPTYPE_NONE = 0
COMPTYPE_MSZIP = 1
COMPTYPE_QUANTUM = 2
COMPTYPE_LZX = 3

FLAG_PREV_CABINET = 0x0001
FLAG_NEXT_CABINET = 0x0002
FLAG_RESERVE_PRESENT = 0x0004

CONTINUED_FROM_PREV = 0xFFFD
CONTINUED_TO_NEXT = 0xFFFE
CONTINUED_PREV_AND_NEXT = 0xFFFF

BLOCKMAX = 32768
INPUTMAX = BLOCKMAX + 6144
INPUTMAX_SALVAGE = 65535
FOLDERMAX = 65535
LENGTHMAX = BLOCKMAX * FOLDERMAX

# set_param() names (reference: mspack.h:931-943)
PARAM_SEARCHBUF = 0
PARAM_FIXMSZIP = 1
PARAM_DECOMPBUF = 2
PARAM_SALVAGE = 3


class CabFolderData:
    """One cabinet span of a folder (reference: cab.h:127-131)."""

    __slots__ = ("cab", "offset")

    def __init__(self, cab: "Cabinet", offset: int):
        self.cab = cab
        self.offset = offset


class CabFolder:
    __slots__ = ("comp_type", "num_blocks", "data", "merge_prev", "merge_next")

    def __init__(self, comp_type: int, num_blocks: int,
                 data: List[CabFolderData]):
        self.comp_type = comp_type
        self.num_blocks = num_blocks
        self.data = data          # list of spans across the cabinet set
        self.merge_prev: Optional[CabFile] = None
        self.merge_next: Optional[CabFile] = None

    @property
    def compression_name(self) -> str:
        return {0: "none", 1: "mszip", 2: "quantum", 3: "lzx"}.get(
            self.comp_type & COMPTYPE_MASK, "unknown")


class CabFile:
    __slots__ = ("filename", "length", "offset", "folder", "attribs",
                 "time_h", "time_m", "time_s", "date_d", "date_m", "date_y")

    def __init__(self, filename: str, length: int, offset: int,
                 folder: Optional[CabFolder], attribs: int,
                 time_field: int, date_field: int):
        self.filename = filename
        self.length = length
        self.offset = offset
        self.folder = folder
        self.attribs = attribs
        self.time_h = time_field >> 11
        self.time_m = (time_field >> 5) & 0x3F
        self.time_s = (time_field << 1) & 0x3E
        self.date_d = date_field & 0x1F
        self.date_m = (date_field >> 5) & 0xF
        self.date_y = (date_field >> 9) + 1980

    def __repr__(self):
        return f"<CabFile {self.filename!r} len={self.length} off={self.offset}>"


class Cabinet:
    def __init__(self, source_ref: PathOrBytes):
        self.source_ref = source_ref       # path or bytes, reopenable
        self.filename = source_ref if isinstance(source_ref, str) else None
        self.base_offset = 0
        self.length = 0
        self.set_id = 0
        self.set_index = 0
        self.flags = 0
        self.header_resv = 0
        self.block_resv = 0
        self.prevname: Optional[str] = None
        self.previnfo: Optional[str] = None
        self.nextname: Optional[str] = None
        self.nextinfo: Optional[str] = None
        self.folders: List[CabFolder] = []
        self.files: List[CabFile] = []
        self.prevcab: Optional[Cabinet] = None
        self.nextcab: Optional[Cabinet] = None
        self.next: Optional[Cabinet] = None   # search-result chain

    def open_stream(self):
        return open_source(self.source_ref)


def _read_string(src, permit_empty: bool) -> str:
    """NUL-terminated string, max 256 bytes (reference: cabd.c:506-546)."""
    base = src.tell()
    buf = src.read(256)
    if len(buf) <= 0:
        raise ReadError("EOF reading string")
    i = buf.find(b"\x00")
    if i < 0 or (i == 0 and not permit_empty):
        raise DataFormatError("bad string in cabinet header")
    src.seek(base + i + 1, os.SEEK_SET)
    return buf[:i].decode("latin-1")


def _checksum(data: bytes, cksum: int = 0) -> int:
    """CAB per-block XOR checksum (reference: cabd.c:1462-1479).

    numpy-vectorized on host; the device version is
    ops.checksum.cab_checksum."""
    import numpy as np

    full = len(data) & ~3
    if full:
        words = np.frombuffer(data, np.uint8, full).view("<u4")
        cksum ^= int(np.bitwise_xor.reduce(words))
    rem = len(data) - full
    ul = 0
    if rem == 3:
        ul = (data[full] << 16) | (data[full + 1] << 8) | data[full + 2]
    elif rem == 2:
        ul = (data[full] << 8) | data[full + 1]
    elif rem == 1:
        ul = data[full]
    return cksum ^ ul


class _DecompState:
    """Persistent per-folder decompression state (reference: cab.h:95-110)."""

    def __init__(self):
        self.folder: Optional[CabFolder] = None
        self.span_idx = 0
        self.offset = 0            # uncompressed offset within folder
        self.block = 0
        self.outlen = 0
        self.comp_type = 0
        self.decomp = None         # codec instance
        self.insrc = None          # current span's open Source
        self.incab: Optional[Cabinet] = None
        self.inbuf = b""
        self.inpos = 0
        self.read_error: Optional[MSPackError] = None
        self.outsink = None        # None = skip/discard phase


class CabDecompressor:
    """Pythonic equivalent of mscab_decompressor (mspack.h:957-1180)."""

    def __init__(self, message: Callable[[str], None] | None = None,
                 engine: str = "cuda", device="cuda", strict=None):
        self.searchbuf_size = 32768
        self.fix_mszip = False
        self.buf_size = 4096
        self.salvage = False
        self.message = message or (lambda s: None)
        self.engine = resolve_engine(engine)
        self.device = resolve_device(device) \
            if self.engine in DEVICE_ENGINES else None
        # strict: a folder that engine="cuda" declines raises FallbackError
        # instead of taking the scalar path; fallback_reasons keeps why
        # each device path declined, {path: "FallbackError: msg"}
        self.strict = strict_mode(strict)
        self.fallback_reasons: dict[str, str] = {}
        # folders whose CFDATA blocks were collected by the native walk
        # ("collect_native") or the block reader ("collect_python")
        self.collect_routes: collections.Counter = collections.Counter()
        self.cuda_engine = None       # lazy CudaMszipEngine (host phase B)
        self.cuda_lzx_engine = None   # lazy CudaLzxEngine
        self.cuda_qtm_engine = None   # lazy CudaQtmEngine
        # engine="torch": the ops' declines over all folders, by reason,
        # and their phase times (ms)
        self.torch_declines: collections.Counter = collections.Counter()
        self.torch_timings: dict[str, float] = {}
        self._scratch_out = None   # warm decode arena (native.Scratch)
        self._scratch_in = None    # warm staging arena
        self._img_cache = None     # (Cabinet, np image view)
        self._d: Optional[_DecompState] = None
        self._folder_cache: tuple | None = None  # (folder, bytes or None)
        self.last_error = 0

    # -- parameters ------------------------------------------------------

    def set_param(self, param: int, value: int) -> None:
        if param == PARAM_SEARCHBUF:
            if value < 4:
                raise ArgsError("searchbuf < 4")
            self.searchbuf_size = value
        elif param == PARAM_FIXMSZIP:
            self.fix_mszip = bool(value)
        elif param == PARAM_DECOMPBUF:
            if value < 4:
                raise ArgsError("decompbuf < 4")
            self.buf_size = value
        elif param == PARAM_SALVAGE:
            self.salvage = bool(value)
        else:
            raise ArgsError(f"unknown param {param}")

    # -- open / headers --------------------------------------------------

    def open(self, path: PathOrBytes) -> Cabinet:
        with span("mspack.cab.open"):
            src = open_source(path)
            cab = Cabinet(path)
            with span("mspack.cab.parse"):
                self._read_headers(src, cab, 0, quiet=False)
        return cab

    def close(self, cab: Cabinet) -> None:
        if self._d is not None and self._d.folder is not None:
            if any(self._d.folder is f for f in cab.folders):
                self._d = None

    def _read_headers(self, src, cab: Cabinet, offset: int, quiet: bool) -> None:
        """reference: cabd.c:319-504."""
        cab.base_offset = offset
        src.seek(offset)
        buf = read_exact(src, CFHEAD_SIZEOF)
        if buf[0:4] != b"MSCF":
            raise SignatureError("no MSCF signature")
        cab.length = int.from_bytes(buf[0x08:0x0C], "little")
        cab.set_id = int.from_bytes(buf[0x20:0x22], "little")
        cab.set_index = int.from_bytes(buf[0x22:0x24], "little")
        cfhead_file_offset = int.from_bytes(buf[0x10:0x14], "little")
        num_folders = int.from_bytes(buf[0x1A:0x1C], "little")
        num_files = int.from_bytes(buf[0x1C:0x1E], "little")
        if num_folders == 0:
            if not quiet:
                self.message("no folders in cabinet.")
            raise DataFormatError("no folders in cabinet")
        if num_files == 0:
            if not quiet:
                self.message("no files in cabinet.")
            raise DataFormatError("no files in cabinet")
        if buf[0x19] != 1 and buf[0x18] != 3:
            if not quiet:
                self.message("WARNING; cabinet version is not 1.3")
        cab.flags = int.from_bytes(buf[0x1E:0x20], "little")

        folder_resv = 0
        if cab.flags & FLAG_RESERVE_PRESENT:
            ext = read_exact(src, CFHEADEXT_SIZEOF)
            cab.header_resv = int.from_bytes(ext[0:2], "little")
            folder_resv = ext[2]
            cab.block_resv = ext[3]
            if cab.header_resv > 60000 and not quiet:
                self.message("WARNING; reserved header > 60000.")
            if cab.header_resv:
                src.seek(cab.header_resv, os.SEEK_CUR)

        if cab.flags & FLAG_PREV_CABINET:
            cab.prevname = _read_string(src, False)
            cab.previnfo = _read_string(src, True)
        if cab.flags & FLAG_NEXT_CABINET:
            cab.nextname = _read_string(src, False)
            cab.nextinfo = _read_string(src, True)

        for _ in range(num_folders):
            fbuf = read_exact(src, CFFOLD_SIZEOF)
            if folder_resv:
                src.seek(folder_resv, os.SEEK_CUR)
            data_off = offset + int.from_bytes(fbuf[0:4], "little")
            fol = CabFolder(
                comp_type=int.from_bytes(fbuf[6:8], "little"),
                num_blocks=int.from_bytes(fbuf[4:6], "little"),
                data=[CabFolderData(cab, data_off)])
            cab.folders.append(fol)

        cffile_offset = src.tell() - cab.base_offset

        err = self._read_files(src, cab, num_folders, num_files)

        if cffile_offset != cfhead_file_offset:
            if not quiet:
                self.message("WARNING; atypical files offset in header")
            if self.salvage and cfhead_file_offset < cab.length:
                try:
                    src.seek(cfhead_file_offset + cab.base_offset)
                except MSPackError:
                    pass
                else:
                    err2 = self._read_files(src, cab, num_folders, num_files)
                    err = err or err2

        if err:
            if self.salvage and cab.files:
                if not quiet:
                    self.message("WARNING; ignoring error while salvaging")
            else:
                raise err
        if not cab.files:
            raise DataFormatError("no files found in cabinet")

    def _read_files(self, src, cab: Cabinet, num_folders: int,
                    num_files: int) -> Optional[MSPackError]:
        """reference: cabd.c:548-643. Returns (not raises) the first error
        so salvage mode can keep partial listings."""
        for _ in range(num_files):
            try:
                buf = read_exact(src, CFFILE_SIZEOF)
            except MSPackError as e:
                return e
            length = int.from_bytes(buf[0:4], "little")
            f_offset = int.from_bytes(buf[4:8], "little")
            fidx = int.from_bytes(buf[8:10], "little")
            date_field = int.from_bytes(buf[10:12], "little")
            time_field = int.from_bytes(buf[12:14], "little")
            attribs = int.from_bytes(buf[14:16], "little")

            folder = None
            merge_role = None
            if fidx < CONTINUED_FROM_PREV:
                if fidx < num_folders and fidx < len(cab.folders):
                    folder = cab.folders[fidx]
            else:
                if fidx in (CONTINUED_TO_NEXT, CONTINUED_PREV_AND_NEXT):
                    folder = cab.folders[-1]
                    merge_role = "next"
                if fidx in (CONTINUED_FROM_PREV, CONTINUED_PREV_AND_NEXT):
                    folder = cab.folders[0]
                    merge_role = "prev" if merge_role is None else "both"

            try:
                name = _read_string(src, False)
            except MSPackError as e:
                if self.salvage:
                    continue
                return e
            if folder is None:
                if self.salvage:
                    continue
                return DataFormatError("invalid folder index")

            file = CabFile(name, length, f_offset, folder, attribs,
                           time_field, date_field)
            if merge_role in ("next", "both"):
                fol = cab.folders[-1]
                if fol.merge_next is None:
                    fol.merge_next = file
            if merge_role in ("prev", "both"):
                fol = cab.folders[0]
                if fol.merge_prev is None:
                    fol.merge_prev = file
            cab.files.append(file)
        return None

    # -- search ----------------------------------------------------------

    def search(self, path: PathOrBytes) -> Optional[Cabinet]:
        """Scan a file for embedded cabinets (reference: cabd.c:656-855).

        Returns the first cabinet found, with further ones chained via
        .next; None if no cabinets were found. The byte scan itself is
        TPU-batchable (ops.search) but runs on host here.
        """
        src = open_source(path)
        flen = source_length(src)
        firstcab: Optional[Cabinet] = None
        link: Optional[Cabinet] = None
        firstlen = 0

        offset = 0
        chunk = max(self.searchbuf_size, 64)
        while offset < flen:
            # find next 'MSCF' at/after offset
            pos = self._find_signature(src, offset, flen, chunk)
            if pos is None:
                break
            caboff = pos
            try:
                hdr = (src.seek(caboff), read_exact(src, 20))[1]
            except MSPackError:
                break
            cablen = int.from_bytes(hdr[8:12], "little")
            foffset = int.from_bytes(hdr[16:20], "little")
            if caboff == 0:
                firstlen = cablen
            offset = caboff + 4
            if (foffset < cablen and (caboff + foffset) < (flen + 32)
                    and ((caboff + cablen) < (flen + 32) or self.salvage)):
                cab = Cabinet(path)
                try:
                    self._read_headers(src, cab, caboff, quiet=(caboff > 0))
                except MSPackError:
                    pass
                else:
                    if link is None:
                        firstcab = cab
                    else:
                        link.next = cab
                    link = cab
                    offset = caboff + cablen

        if firstlen and firstlen != flen and \
                (firstcab is None or firstcab.base_offset == 0):
            if firstlen < flen:
                self.message("WARNING; possible %d extra bytes at end of file."
                             % (flen - firstlen))
            else:
                self.message("WARNING; file possibly truncated by %d bytes."
                             % (firstlen - flen))
        return firstcab

    @staticmethod
    def _find_signature(src, start: int, flen: int, chunk: int) -> Optional[int]:
        pos = start
        tail = b""
        while pos < flen:
            src.seek(pos)
            data = src.read(chunk)
            if not data:
                return None
            hay = tail + data
            i = hay.find(b"MSCF")
            if i >= 0:
                return pos - len(tail) + i
            tail = hay[-3:] if len(hay) >= 3 else hay
            pos += len(data)
        return None

    # -- merge -----------------------------------------------------------

    def append(self, cab: Cabinet, nextcab: Cabinet) -> None:
        self._merge(cab, nextcab)

    def prepend(self, cab: Cabinet, prevcab: Cabinet) -> None:
        self._merge(prevcab, cab)

    def _merge(self, lcab: Cabinet, rcab: Cabinet) -> None:
        """reference: cabd.c:879-1015."""
        if lcab is None or rcab is None or lcab is rcab:
            raise ArgsError("bad merge args")
        if lcab.nextcab is not None or rcab.prevcab is not None:
            raise ArgsError("cabinets already joined")
        c = lcab.prevcab
        while c:
            if c is rcab:
                raise ArgsError("circular cabinet chain")
            c = c.prevcab
        c = rcab.nextcab
        while c:
            if c is lcab:
                raise ArgsError("circular cabinet chain")
            c = c.nextcab

        if lcab.set_id != rcab.set_id:
            self.message("WARNING; merged cabinets with differing Set IDs.")
        if lcab.set_index > rcab.set_index:
            self.message("WARNING; merged cabinets with odd order.")

        lfol = lcab.folders[-1]
        rfol = rcab.folders[0]

        if lfol.merge_next is None or rfol.merge_prev is None:
            lcab.nextcab = rcab
            rcab.prevcab = lcab
            merged_folders = lcab.folders + rcab.folders
            merged_files = lcab.files + rcab.files
        else:
            if not self._can_merge_folders(lfol, rfol):
                raise DataFormatError("folders cannot be merged")
            lcab.nextcab = rcab
            rcab.prevcab = lcab
            # append rfol's data span(s) to lfol
            lfol.data.extend(rfol.data)
            lfol.num_blocks += rfol.num_blocks - 1
            if rfol.merge_next is None or rfol.merge_next.folder is not rfol:
                lfol.merge_next = rfol.merge_next
            merged_folders = lcab.folders + rcab.folders[1:]
            # drop rfol's duplicate files, repoint none (they're dropped)
            merged_files = lcab.files + [f for f in rcab.files
                                         if f.folder is not rfol]

        # all cabinets in the chain share the same lists
        c = lcab
        while c.prevcab:
            c = c.prevcab
        while c:
            c.files = merged_files
            c.folders = merged_folders
            c = c.nextcab

    def _can_merge_folders(self, lfol: CabFolder, rfol: CabFolder) -> bool:
        """reference: cabd.c:1018-1067."""
        if lfol.comp_type != rfol.comp_type:
            return False
        if (lfol.num_blocks + rfol.num_blocks) > FOLDERMAX:
            return False
        lfi, rfi = lfol.merge_next, rfol.merge_prev
        if lfi is None or rfi is None:
            return False

        # collect the chains: files of lfol from lfi on; rfol files from rfi
        def chain(first: CabFile, cab_files: List[CabFile], folder: CabFolder):
            try:
                start = next(i for i, f in enumerate(cab_files) if f is first)
            except StopIteration:
                return []
            return [f for f in cab_files[start:] if f.folder is folder]

        lfiles = [f for f in self._files_of(lfol, lfi)]
        rfiles = [f for f in self._files_of(rfol, rfi)]

        matching = len(lfiles) <= len(rfiles) and all(
            l.offset == r.offset and l.length == r.length
            for l, r in zip(lfiles, rfiles))
        if matching:
            return True

        matching = False
        for l in lfiles:
            found = any(l.offset == r.offset and l.length == r.length
                        for r in rfiles)
            if found:
                matching = True
            else:
                self.message("WARNING; merged file %s not listed in both "
                             "cabinets" % l.filename)
        return matching

    @staticmethod
    def _files_of(folder: CabFolder, first: CabFile) -> List[CabFile]:
        # walk the owning cabinet's file list from `first`
        cab = folder.data[0].cab
        files = cab.files
        out = []
        seen = False
        for f in files:
            if f is first:
                seen = True
            if seen and f.folder is folder:
                out.append(f)
        return out

    # -- extract ---------------------------------------------------------

    @spanned("mspack.cab.extract")
    def extract(self, file: CabFile, output) -> None:
        """reference: cabd.c:1075-1214."""
        if file is None:
            raise ArgsError("no file")
        fol = file.folder

        if file.offset > LENGTHMAX:
            raise DataFormatError("file offset beyond 2GB")
        filelen = file.length
        if filelen > LENGTHMAX - file.offset:
            if self.salvage:
                filelen = LENGTHMAX - file.offset
            else:
                raise DataFormatError("file beyond 2GB limit")

        if fol is None or fol.merge_prev is not None:
            self.message('ERROR; file "%s" cannot be extracted, '
                         "cabinet set is incomplete" % file.filename)
            raise DecrunchError("cabinet set is incomplete")

        if not self.salvage:
            maxlen = fol.num_blocks * BLOCKMAX
            if file.offset > maxlen or filelen > maxlen - file.offset:
                self.message('ERROR; file "%s" cannot be extracted, '
                             "cabinet set is incomplete" % file.filename)
                raise DecrunchError("file beyond folder data")

        # zero-length files never touch folder data (reference gates the
        # whole decompression on `if (filelen)`, cabd.c:1188-1206) —
        # salvage-mode hidden files may carry unusable folder pointers
        if filelen == 0:
            sink = output if isinstance(output, Sink) else FileSink(output)
            try:
                sink.write(b"")
            finally:
                if sink is not output and hasattr(sink, "close"):
                    sink.close()
            return

        # fast paths: decode the whole folder once (native thread pool or
        # the CUDA kernels), then serve every file from the cache. A file
        # that ends past the decoded bytes goes to the scalar path, whose
        # codec raises the reference's error for it.
        if not self.salvage:
            folder_bytes = self._folder_bytes(fol)
            if folder_bytes is not None and \
                    file.offset + filelen <= len(folder_bytes):
                sink = output if isinstance(output, Sink) else FileSink(output)
                try:
                    with span("mspack.cab.write"):
                        sink.write(folder_bytes[file.offset:
                                                file.offset + filelen])
                    return
                finally:
                    if sink is not output and hasattr(sink, "close"):
                        sink.close()

        d = self._d
        if (d is None or d.folder is not fol or d.offset > file.offset
                or d.decomp is None):
            d = self._init_folder_state(fol)

        sink = output if isinstance(output, Sink) else FileSink(output)
        try:
            if filelen:
                # skip-decode to the file's offset, discarding output
                d.outsink = None
                skip = file.offset - d.offset
                if skip:
                    self._run_decomp(d, skip)
                d.outsink = sink
                self._run_decomp(d, filelen)
        except MSPackError:
            self._d = None  # decoder state is poisoned
            raise
        finally:
            d.outsink = None
            if sink is not output and hasattr(sink, "close"):
                sink.close()

    def _folder_bytes(self, fol: CabFolder):
        """The whole folder's bytes from the engine's fast path, cached for
        the folder's other files (a decline is cached too); None sends the
        file to the scalar path."""
        if self._folder_cache is not None and self._folder_cache[0] is fol:
            return self._folder_cache[1]
        ct = fol.comp_type & COMPTYPE_MASK
        out = None
        if self.engine == "cuda":
            if ct in (COMPTYPE_QUANTUM, COMPTYPE_LZX) or (
                    ct == COMPTYPE_MSZIP and not self.fix_mszip):
                out = self._folder_bytes_cuda(fol, ct)
        elif self.engine == "torch":
            if ct == COMPTYPE_LZX or (ct == COMPTYPE_MSZIP
                                      and not self.fix_mszip):
                out = self._folder_bytes_torch(fol, ct)
            elif ct == COMPTYPE_QUANTUM:
                self.torch_declines["Quantum has no tensor-op path"] += 1
                note_fallback(self, "qtm_torch",
                              "Quantum has no tensor-op path")
        elif self.engine == "native":
            if not self.fix_mszip and ct <= COMPTYPE_LZX:
                out = self._folder_bytes_pipeline(fol)
            if out is None and ct in (COMPTYPE_QUANTUM, COMPTYPE_LZX):
                out = self._folder_bytes_lzx_native(fol)
            if out is None and ct == COMPTYPE_MSZIP and not self.fix_mszip:
                out = self._folder_bytes_fast(fol)
        else:
            return None
        self._folder_cache = (fol, out)
        return out

    def _cab_image(self, cab: Cabinet):
        """Zero-copy uint8 view over the cabinet image (memmap for
        paths, frombuffer for in-memory cabs); None when unavailable."""
        if self._img_cache is not None and self._img_cache[0] is cab:
            return self._img_cache[1]
        import numpy as np
        ref = cab.source_ref
        try:
            if isinstance(ref, str):
                img = np.memmap(ref, dtype=np.uint8, mode="r")
            elif isinstance(ref, (bytes, bytearray, memoryview)):
                img = np.frombuffer(ref, np.uint8)
            else:
                return None
        except (OSError, ValueError):
            return None
        self._img_cache = (cab, img)
        return img

    def _folder_bytes_pipeline(self, fol: CabFolder):
        """Whole-folder decode through the native cab pipeline (CFDATA
        walk + checksum + codec decode in one C call). None falls back
        to the per-codec native paths / scalar driver."""
        if len(fol.data) != 1 or fol.merge_prev or fol.merge_next:
            return None
        img = self._cab_image(fol.data[0].cab)
        if img is None:
            return None
        try:
            from .. import native
            if not native.available():
                return None
            if self._scratch_out is None:
                self._scratch_out = native.Scratch()
            out_cap = fol.num_blocks * BLOCKMAX
            out = self._scratch_out.get(max(out_cap, 1))
            ct = fol.comp_type & COMPTYPE_MASK
            stage = None
            if ct in (COMPTYPE_QUANTUM, COMPTYPE_LZX):
                if self._scratch_in is None:
                    self._scratch_in = native.Scratch()
                stage = self._scratch_in.get(
                    fol.num_blocks * (INPUTMAX + 1) or 1)
            offs = native.cab_pipeline(
                img, [fol.data[0].offset], [fol.num_blocks],
                [fol.comp_type], fol.data[0].cab.block_resv, out, stage)
        except Exception:
            return None
        if offs is None:
            return None
        return out[: offs[1]]

    def _folder_bytes_fast(self, fol: CabFolder):
        """Decode an entire MSZIP folder with the native engine. Returns
        None when it cannot reproduce reference semantics (then the
        scalar path runs instead)."""
        collected = self.collect_mszip_frames(fol)
        if collected is None:
            return None
        streams, sizes = collected
        try:
            from .. import native
            total = sum(sizes)
            if self._scratch_out is None:
                self._scratch_out = native.Scratch()
            buf = self._scratch_out.get(max(total, 1))
            if native.mszip_folder_into(streams, sizes, buf):
                return buf[:total]
        except Exception:
            return None
        return None

    def _folder_bytes_lzx_native(self, fol: CabFolder):
        """Whole-folder LZX or Quantum decode via the native engine. CAB
        LZX never resets (reference: cabd.c:1249-1250 passes
        reset_interval 0), so the folder is one sequential stream."""
        collected = self.collect_raw_blocks(fol)
        if collected is None:
            return None
        blocks, sizes = collected
        try:
            from .. import native
            if self._scratch_out is None:
                self._scratch_out = native.Scratch()
            if self._scratch_in is None:
                self._scratch_in = native.Scratch()
            total = sum(sizes)
            out = self._scratch_out.get(max(total, 1))[:total]
            ct = fol.comp_type & COMPTYPE_MASK
            csize = sum(len(b) for b in blocks)
            if ct == COMPTYPE_QUANTUM:
                # cabd injects a 0xFF realign trailer after every block
                # (reference: cabd.c:1327-1332)
                stage = self._scratch_in.get(csize + len(blocks) + 1)
                n = native.fill_from_chunks(stage, blocks, sep=0xFF)
                ok = native.qtm_decode_into(stage, n,
                                            (fol.comp_type >> 8) & 0x1F,
                                            out, total)
            else:
                stage = self._scratch_in.get(max(csize, 1))
                n = native.fill_from_chunks(stage, blocks)
                ok = native.lzx_decode_into(stage, n,
                                            (fol.comp_type >> 8) & 0x1F, 0,
                                            out, total)
            if not ok:
                return None
        except Exception:
            return None
        return out

    # -- engine="cuda" ---------------------------------------------------

    # codec -> (device path named in fallback_reasons, attribute, engine)
    _CUDA_PATHS = {
        COMPTYPE_MSZIP: ("mszip_cuda", "cuda_engine", "CudaMszipEngine"),
        COMPTYPE_LZX: ("lzx_cuda", "cuda_lzx_engine", "CudaLzxEngine"),
        COMPTYPE_QUANTUM: ("qtm_cuda", "cuda_qtm_engine", "CudaQtmEngine")}

    def _cuda(self, ct):
        """The lazily made CUDA engine of codec ``ct``."""
        from ..parallel import cuda_pipeline as cp

        _, attr, cls = self._CUDA_PATHS[ct]
        eng = getattr(self, attr)
        if eng is None:
            eng = getattr(cp, cls)(self.device)
            setattr(self, attr, eng)
        return eng

    def _folder_bytes_cuda(self, fol: CabFolder, ct: int):
        """One MSZIP, LZX or Quantum folder through the CUDA engine of its
        codec; None when its blocks cannot be collected or the engine
        declines (counted in the engine's ``declines``). Every decline, and
        an MSZIP folder the engine re-decoded on the host, is noted in
        ``fallback_reasons`` and raises ``FallbackError`` under strict."""
        path = self._CUDA_PATHS[ct][0]
        with span("mspack.cab.collect"):
            collected = self.collect_mszip_frames(fol) \
                if ct == COMPTYPE_MSZIP else self.collect_raw_blocks(fol)
        if collected is None:
            note_fallback(self, path, "CFDATA blocks could not be collected")
            return None
        eng = self._cuda(ct)
        before = dict(eng.declines)
        out = self._decode_cuda(eng, fol, ct, *collected)
        declined = new_declines(eng, before)
        if declined:
            note_fallback(self, path, declined)
        return out

    def _decode_cuda(self, eng, fol: CabFolder, ct: int, blocks, sizes):
        """The folder's bytes from ``eng``, or None where it declines
        (``blocks``: an MSZIP folder's frames without their CK)."""
        if ct == COMPTYPE_MSZIP:
            outs = eng.decode_folders([(blocks, sizes)])
            return None if outs is None else outs[0]
        wb = (fol.comp_type >> 8) & 0x1F
        if ct == COMPTYPE_LZX:
            outs = eng.decode_streams([b"".join(blocks)], [sum(sizes)], wb,
                                      frame_sizes=[[len(b) for b in blocks]])
            return None if outs is None else outs[0]
        # Quantum: cabd injects a 0xFF realign trailer after every block
        # (cabd.c:1327-1332)
        outs = eng.decode_streams([b"".join(b + b"\xff" for b in blocks)],
                                  [sum(sizes)], wb)
        if outs is None:
            return None
        if self._wrap_flush_fails(fol, eng.wrap_spans[0]):
            eng.declines["window-wrap flush across a file edge"] += 1
            return None
        return outs[0]

    # -- engine="torch" --------------------------------------------------

    def _folder_bytes_torch(self, fol: CabFolder, ct: int):
        """One MSZIP or LZX folder through the tensor ops (the JAX
        package's ``_folder_bytes_fast`` and ``_folder_bytes_lzx_device``);
        None when its blocks cannot be collected or the ops decline, noted
        in ``fallback_reasons`` (``FallbackError`` under strict)."""
        from ..ops.inflate import inflate_folder
        from ..ops.lzx import lzx_stream_decode

        path = "mszip_torch" if ct == COMPTYPE_MSZIP else "lzx_torch"
        collected = self.collect_mszip_frames(fol) \
            if ct == COMPTYPE_MSZIP else self.collect_raw_blocks(fol)
        if collected is None:
            note_fallback(self, path, "CFDATA blocks could not be collected")
            return None
        blocks, sizes = collected
        declined = collections.Counter()
        if ct == COMPTYPE_MSZIP:
            out = inflate_folder(blocks, sizes,
                                 device=self.device, declines=declined,
                                 timings=self.torch_timings)
        else:
            # CAB LZX never resets (cabd.c:1249-1250): one fresh stream
            out = lzx_stream_decode(b"".join(blocks),
                                    (fol.comp_type >> 8) & 0x1F, sum(sizes),
                                    device=self.device, declines=declined,
                                    timings=self.torch_timings)
        if out is None:
            self.torch_declines.update(declined)
            note_fallback(self, path, declined)
        return out

    @staticmethod
    def _wrap_flush_fails(fol: CabFolder, spans) -> bool:
        """Whether the reference codec could fail on this folder where a
        whole-folder decode does not. A Quantum match that crosses a window
        lap end makes the codec deliver the whole lap mid-match, and it
        fails when the caller's request ends inside that lap (qtmd.c:
        356-380, codecs/qtm.py:309-322). Requests end at file edges, so
        that happens only where a file edge lies after such a match's
        start and before its lap end. ``spans``: (starts, lap ends)."""
        import numpy as np

        starts, lap_ends = spans
        if not len(starts):
            return False
        files = [f for f in fol.data[0].cab.files if f.folder is fol]
        edges = np.unique([e for f in files
                           for e in (f.offset, f.offset + f.length)])
        k = np.searchsorted(edges, starts, side="right")
        inside = k < len(edges)
        return bool((edges[k[inside]] < lap_ends[inside]).any())

    def collect_raw_blocks(self, fol: CabFolder):
        """Read and checksum-validate all CFDATA blocks of a folder.
        Returns ([block_bytes...], [uncomp_sizes]) or None."""
        return self._collect(fol, False)

    def collect_mszip_frames(self, fol: CabFolder):
        """Read and validate all CFDATA blocks of an MSZIP folder.

        Returns ([frame_bytes_without_CK, ...], [uncomp_sizes]) or None if
        anything needs the scalar path (checksum failure, missing CK)."""
        return self._collect(fol, True)

    def _collect(self, fol: CabFolder, mszip: bool):
        """A folder's blocks from one native walk where it follows them
        exactly, else from the block reader a block at a time; counted in
        ``collect_routes`` as ``collect_native`` or ``collect_python``."""
        walked = self._collect_native(fol, mszip)
        if walked is not None:
            self.collect_routes["collect_native"] += 1
            return walked
        self.collect_routes["collect_python"] += 1
        collected = self._collect_blocks(fol)
        if mszip and collected is not None:
            # every frame must start with the CK signature for the fast
            # path (the scalar path handles realign-scanning of damaged
            # streams)
            frames, sizes = collected
            if any(f[:2] != b"CK" for f in frames):
                return None
            return [f[2:] for f in frames], sizes
        return collected

    def _collect_native(self, fol: CabFolder, mszip: bool):
        """The folder's blocks (MSZIP frames without their CK) and sizes
        from ``native.cab_walk``; None where the block reader has to
        read them: salvage mode (it accepts what the walk refuses), a
        folder over several cabinets or merged with another, no image or
        no native library, and every folder the walk refuses. The walk
        always checks the checksums, so a bad one in fix-MSZIP mode reaches
        the reader, which warns and goes on."""
        if self.salvage or len(fol.data) != 1 or fol.merge_prev or \
                fol.merge_next:
            return None
        cab = fol.data[0].cab
        img = self._cab_image(cab)
        if img is None:
            return None
        from .. import native
        if not native.available():
            return None
        walked = native.cab_walk(
            img, fol.data[0].offset, fol.num_blocks,
            COMPTYPE_MSZIP if mszip else fol.comp_type & COMPTYPE_MASK,
            cab.block_resv)
        if walked is None:
            return None
        offs, lens, sizes = (a.tolist() for a in walked)
        skip = 2 if mszip else 0
        src = cab.source_ref if isinstance(cab.source_ref, bytes) \
            else memoryview(img)
        return [bytes(src[o + skip:o + n]) for o, n in zip(offs, lens)], \
            sizes

    def _collect_blocks(self, fol: CabFolder):
        """Every CFDATA block of the folder through ``_read_block``:
        ([block_bytes...], [uncomp_sizes]), or None on its first error."""
        d = _DecompState()
        d.folder = fol
        d.comp_type = fol.comp_type
        d.incab = fol.data[0].cab
        try:
            d.insrc = fol.data[0].cab.open_stream()
            d.insrc.seek(fol.data[0].offset)
        except MSPackError:
            return None
        blocks = []
        sizes = []
        try:
            for _ in range(fol.num_blocks):
                prev = d.outlen
                self._read_block(d)
                blocks.append(d.inbuf)
                sizes.append(d.outlen - prev)
        except MSPackError:
            return None  # scalar path will surface the exact error
        return blocks, sizes

    def _init_folder_state(self, fol: CabFolder) -> _DecompState:
        d = _DecompState()
        self._d = d
        d.folder = fol
        d.span_idx = 0
        d.offset = 0
        d.block = 0
        d.outlen = 0
        d.comp_type = fol.comp_type
        d.incab = fol.data[0].cab
        d.insrc = fol.data[0].cab.open_stream()
        d.insrc.seek(fol.data[0].offset)
        d.inbuf = b""
        d.inpos = 0
        d.read_error = None

        ct = fol.comp_type & COMPTYPE_MASK
        read_fn = self._make_block_reader(d)
        if ct == COMPTYPE_NONE:
            d.decomp = None
            d.read_fn = read_fn
        elif ct == COMPTYPE_MSZIP:
            d.decomp = MszipDecompressor(read_fn, self.buf_size,
                                         repair_mode=self.fix_mszip,
                                         message=self.message)
        elif ct == COMPTYPE_QUANTUM:
            d.decomp = QtmDecompressor(read_fn, (fol.comp_type >> 8) & 0x1F,
                                       self.buf_size)
        elif ct == COMPTYPE_LZX:
            d.decomp = LzxDecompressor(read_fn, (fol.comp_type >> 8) & 0x1F,
                                       0, 0, False, self.buf_size,
                                       message=self.message)
        else:
            self._d = None
            raise DataFormatError(f"unknown compression type {ct}")
        return d

    def _run_decomp(self, d: _DecompState, n: int) -> None:
        def write_fn(data: bytes) -> None:
            d.offset += len(data)
            if d.outsink is not None:
                d.outsink.write(data)

        ct = d.comp_type & COMPTYPE_MASK
        try:
            if ct == COMPTYPE_NONE:
                todo = n
                while todo > 0:
                    chunk = d.read_fn(min(todo, self.buf_size))
                    if not chunk:
                        raise ReadError("out of data in 'none' folder")
                    write_fn(chunk)
                    todo -= len(chunk)
            else:
                d.decomp.decompress(n, write_fn)
        except ReadError:
            # a READ error from the codec means the block reader ran dry
            # or failed; surface the recorded cause (reference maps
            # MSPACK_ERR_READ back to self->read_error, cabd.c:1196-1206)
            if d.read_error is not None:
                raise d.read_error
            raise

    # -- block reader (cabd_sys_read equivalent) -------------------------

    def _make_block_reader(self, d: _DecompState):
        def read_fn(n: int) -> bytes:
            out = bytearray()
            todo = n
            while todo > 0:
                avail = len(d.inbuf) - d.inpos
                if avail:
                    take = min(avail, todo)
                    out += d.inbuf[d.inpos : d.inpos + take]
                    d.inpos += take
                    todo -= take
                    continue
                # out of data: next block
                d.block += 1
                if d.block > d.folder.num_blocks:
                    if not self.salvage:
                        d.read_error = DataFormatError(
                            "ran out of CAB input blocks")
                    break
                self._read_block(d)
                if (d.comp_type & COMPTYPE_MASK) == COMPTYPE_QUANTUM:
                    d.inbuf += b"\xFF"
                if d.block >= d.folder.num_blocks:
                    if (d.comp_type & COMPTYPE_MASK) == COMPTYPE_LZX:
                        d.decomp.set_output_length(d.outlen)
            return bytes(out)

        return read_fn

    def _read_block(self, d: _DecompState) -> None:
        """reference: cabd.c:1362-1460 (split blocks across cabinets)."""
        ignore_cksum = self.salvage or (
            self.fix_mszip
            and (d.comp_type & COMPTYPE_MASK) == COMPTYPE_MSZIP)
        ignore_blocksize = self.salvage

        block = bytearray()
        while True:
            try:
                hdr = read_exact(d.insrc, CFDATA_SIZEOF)
            except MSPackError as e:
                d.read_error = e
                raise
            if d.incab.block_resv:
                d.insrc.seek(d.incab.block_resv, os.SEEK_CUR)

            length = int.from_bytes(hdr[4:6], "little")
            uncomp = int.from_bytes(hdr[6:8], "little")
            full_len = len(block) + length
            if full_len > INPUTMAX:
                if not ignore_blocksize or full_len > INPUTMAX_SALVAGE:
                    d.read_error = DataFormatError("block size > CAB_INPUTMAX")
                    raise d.read_error
            if uncomp > BLOCKMAX and not ignore_blocksize:
                d.read_error = DataFormatError("block size > CAB_BLOCKMAX")
                raise d.read_error

            try:
                data = read_exact(d.insrc, length)
            except MSPackError as e:
                d.read_error = e
                raise

            cksum = int.from_bytes(hdr[0:4], "little")
            if cksum:
                sum2 = _checksum(data, 0)
                if _checksum(hdr[4:8], sum2) != cksum:
                    if not ignore_cksum:
                        d.read_error = ChecksumError("bad block checksum")
                        raise d.read_error
                    self.message("WARNING; bad block checksum found")

            block += data

            if uncomp:
                d.outlen += uncomp
                d.inbuf = bytes(block)
                d.inpos = 0
                return

            # split block: continue into the next cabinet of the set
            d.span_idx += 1
            if d.span_idx >= len(d.folder.data):
                self.message("WARNING; ran out of cabinets in set. "
                             "Are any missing?")
                d.read_error = DataFormatError("ran out of cabinets in set")
                raise d.read_error
            span = d.folder.data[d.span_idx]
            d.incab = span.cab
            d.insrc = span.cab.open_stream()
            d.insrc.seek(span.offset)
