"""OAB (Exchange Offline Address Book .LZX) driver (L3).

Format semantics (reference: libmspack/mspack/oabd.c, oab.h):

* full download (version 3.1): per-block {flags, csize, dsize, crc};
  flags=0 copy, flags=1 LZX DELTA block (window sized from dsize,
  2^17..2^25, no reference data); CRC-32 (initial 0xFFFFFFFF, no final
  inversion) over each block's output.
* incremental patch (version 3.2): per-block {csize, dsize, ssize,
  crc}; the base file provides ssize bytes of LZX reference data and
  the window is round32k(ssize)+dsize.
* trailing padding after each compressed block is consumed via the
  block's declared csize budget.

Copied from ``libmspack_tpu/formats/oab.py``: the full download and the
incremental patch loops, the scalar block decode with its padding rule and
the ``engine="native"`` block decode are the reference driver's. Engines:

* ``"cuda"`` (the default): every OAB block is an independent LZX DELTA
  stream, so a file's blocks are K3 lanes side by side. The driver reads
  block headers, payloads and (in a patch) reference data ahead, up to the
  first bad or short block or ``READ_AHEAD`` decoded bytes; groups the LZX
  blocks by window; decodes each group in one
  ``CudaLzxEngine.decode_streams(..., is_delta=True, refs=...,
  per_lane=True)`` call (windows 2^17..2^25, the reference data at the
  window's tail); and writes the blocks in file order, stored blocks
  copied, each decoded block followed by its CRC check on the host (the
  bytes are there after host phase B), as the scalar path writes and then
  checks. A block whose lane declines (flagged, an E8 header) takes the
  scalar path, which writes what the reference writes and raises the
  reference's error. The first bad or short block goes, with the rest of
  the file, to the reference loop, which raises there. So for a header
  error, a short read or a CRC mismatch at block k, blocks 0..k-1 are in
  the sink and the scalar path's error class follows. Declines are counted
  in the engine's ``declines`` and noted in ``fallback_reasons``; under
  strict mode (``strict=True``, or the environment variable
  ``MSPACK_TPU_STRICT`` set, as in the reference) a block that leaves the
  device raises ``FallbackError`` instead;
* ``"torch"``: the JAX package's ``"jax"`` engine (its XLA-level ops) as
  PyTorch tensor ops on ``device``: each LZX block, in the reference loop,
  decoded whole by ``ops/lzx.lzx_stream_decode(..., is_delta=True,
  ref_data=...)``, then its CRC checked on the host before it is written,
  as the JAX package does. A block the ops decline takes the scalar path;
  the decline is counted by reason in ``torch_declines``, noted in
  ``fallback_reasons`` and raises ``FallbackError`` under strict mode;
* ``"native"``: the C++ engine per block, as in the reference driver;
  ``"auto"`` is ``"native"`` when it builds, else ``"scalar"``;
* ``"scalar"``: the Python codec only.

The JAX package's ``"jax"`` and ``"tpu"`` engines are the port's
``"torch"`` and ``"cuda"``. Its ``tpu`` engine declines windows above 2^18
to the host; the port serves them on K3, held to the JAX ``scalar`` path's
bytes.

Spans (``tracing``): ``mspack.oab.decompress`` around ``decompress`` and
``mspack.oab.decompress_incremental`` around ``decompress_incremental``;
inside either, under ``engine="cuda"``, ``mspack.oab.read`` (the
read-ahead) and ``mspack.oab.write`` (the batch's blocks written in file
order with their CRC checks, whose host time is ``timings["crc_ms"]``),
once a batch. In a patch, ``mspack.oab.read`` holds ``mspack.oab.base``:
the batch's reference data read from the base in one read, once the
batch's headers and payloads are read, each block given its slice; its
host time is ``timings["base_ms"]`` and the bytes the blocks took
``timings["base_bytes"]``.
"""
from __future__ import annotations

import collections
import time

from .._device import DEVICE_ENGINES, note_fallback, resolve_device, \
    resolve_engine, strict_mode
from ..codecs.lzx import LzxDecompressor
from ..errors import (ArgsError, ChecksumError, DataFormatError, ReadError,
                      SignatureError)
from ..ops.crc32 import crc32_raw
from ..system import (BytesSink, FileSink, PathOrBytes, Sink, open_source,
                      read_exact)
from ..tracing import add_ms, span, spanned

OABHEAD_SIZEOF = 0x10
OABBLK_SIZEOF = 0x10
PATCHHEAD_SIZEOF = 0x1C
PATCHBLK_SIZEOF = 0x10
READ_AHEAD = 1 << 28    # decoded bytes of one batch of blocks (engine="cuda")


class _Block:
    """One block read ahead: where its header starts in the file, its
    fields, window, payload and reference data."""

    __slots__ = ("hdr_pos", "flags", "csize", "dsize", "crc",
                 "window_bits", "payload", "ssize", "ref")

    def __init__(self, **kw):
        for k, v in kw.items():
            setattr(self, k, v)


class OabDecompressor:
    """Pythonic equivalent of msoab_decompressor (mspack.h:2255-2376)."""

    def __init__(self, message=None, engine: str = "cuda", device="cuda",
                 strict=None):
        self.buf_size = 4096
        self.message = message or (lambda s: None)
        self.engine = resolve_engine(engine)
        self.device = resolve_device(device) \
            if self.engine in DEVICE_ENGINES else None
        self.strict = strict_mode(strict)
        self.fallback_reasons: dict[str, str] = {}
        self.cuda_engine = None   # lazy CudaLzxEngine
        # engine="cuda": decode_streams calls, blocks by outcome, CRC times
        self.stats: collections.Counter = collections.Counter()
        self.timings: dict[str, float] = {}
        # engine="torch": the ops' declines, by reason (phase times go to
        # timings)
        self.torch_declines: collections.Counter = collections.Counter()
        self._scratch = None

    def set_param(self, param: int, value: int) -> None:
        if param == 0 and value >= 16:   # MSOABD_PARAM_DECOMPBUF
            self.buf_size = value
        else:
            raise ArgsError("bad OAB param")

    # -- full download ---------------------------------------------------

    @spanned("mspack.oab.decompress")
    def decompress(self, input_: PathOrBytes, output) -> None:
        """reference: oabd.c:103-232."""
        src = open_source(input_)
        hdr = read_exact(src, OABHEAD_SIZEOF)
        if (int.from_bytes(hdr[0:4], "little") != 3
                or int.from_bytes(hdr[4:8], "little") != 1):
            raise SignatureError("not an OAB full download (v3.1)")
        block_max = int.from_bytes(hdr[8:12], "little")
        target_size = int.from_bytes(hdr[12:16], "little")

        sink = output if isinstance(output, Sink) else FileSink(output)
        try:
            if self.engine == "cuda":
                target_size = self._run_cuda(src, None, sink, block_max,
                                             target_size)
            while target_size:
                blk = read_exact(src, OABBLK_SIZEOF)
                blk_flags = int.from_bytes(blk[0:4], "little")
                blk_csize = int.from_bytes(blk[4:8], "little")
                blk_dsize = int.from_bytes(blk[8:12], "little")
                blk_crc = int.from_bytes(blk[12:16], "little")

                if blk_dsize > block_max or blk_dsize > target_size \
                        or blk_flags > 1:
                    raise DataFormatError("bad OAB block header")

                if not blk_flags:
                    if blk_dsize != blk_csize:
                        raise DataFormatError("uncompressed block size mismatch")
                    sink.write(read_exact(src, blk_dsize))
                else:
                    window_bits = 17
                    while window_bits < 25 and (1 << window_bits) < blk_dsize:
                        window_bits += 1
                    self._decode_block(src, sink, blk_csize, blk_dsize,
                                       blk_crc, window_bits, None)
                target_size -= blk_dsize
        finally:
            if sink is not output and hasattr(sink, "close"):
                sink.close()

    # -- incremental patch -----------------------------------------------

    @spanned("mspack.oab.decompress_incremental")
    def decompress_incremental(self, input_: PathOrBytes, base: PathOrBytes,
                               output) -> None:
        """reference: oabd.c:234-373."""
        src = open_source(input_)
        basesrc = open_source(base)
        hdr = read_exact(src, PATCHHEAD_SIZEOF)
        if (int.from_bytes(hdr[0:4], "little") != 3
                or int.from_bytes(hdr[4:8], "little") != 2):
            raise SignatureError("not an OAB incremental patch (v3.2)")
        block_max = int.from_bytes(hdr[8:12], "little")
        target_size = int.from_bytes(hdr[16:20], "little")
        if block_max < PATCHBLK_SIZEOF:
            block_max = PATCHBLK_SIZEOF

        sink = output if isinstance(output, Sink) else FileSink(output)
        try:
            if self.engine == "cuda":
                target_size = self._run_cuda(src, basesrc, sink, block_max,
                                             target_size)
            while target_size:
                blk = read_exact(src, PATCHBLK_SIZEOF)
                blk_csize = int.from_bytes(blk[0:4], "little")
                blk_dsize = int.from_bytes(blk[4:8], "little")
                blk_ssize = int.from_bytes(blk[8:12], "little")
                blk_crc = int.from_bytes(blk[12:16], "little")

                if blk_dsize > block_max or blk_dsize > target_size \
                        or blk_ssize > block_max:
                    raise DataFormatError("bad patch block header")

                window_size = ((blk_ssize + 32767) & ~32767) + blk_dsize
                window_bits = 17
                while window_bits < 25 and (1 << window_bits) < window_size:
                    window_bits += 1

                ref_data = basesrc.read(blk_ssize) if blk_ssize else b""
                if len(ref_data) < blk_ssize:
                    raise ReadError("base file too short for reference data")
                self._decode_block(src, sink, blk_csize, blk_dsize,
                                   blk_crc, window_bits, ref_data)
                target_size -= blk_dsize
        finally:
            if sink is not output and hasattr(sink, "close"):
                sink.close()

    # -- engine="cuda" ---------------------------------------------------

    def _run_cuda(self, src, basesrc, sink, block_max: int,
                  target_size: int) -> int:
        """Decode and write every block it can through K3, batch after
        batch; returns the bytes still to decode. ``src`` (and ``basesrc``)
        then stand at the first block it did not take, for the reference
        loop."""
        while target_size:
            with span("mspack.oab.read"):
                blocks, stopped = self._read_ahead(src, basesrc, block_max,
                                                   target_size)
            outs = self._decode_batch(blocks)
            with span("mspack.oab.write"):
                for blk, out in zip(blocks, outs):
                    self._write_block(sink, blk, out)
                    target_size -= blk.dsize
            if stopped or not blocks:
                break
        return target_size

    def _read_ahead(self, src, basesrc, block_max: int, target_size: int):
        """(blocks, stopped): the next blocks whose headers are valid and
        whose payloads and reference data are whole, in file order, up to
        ``READ_AHEAD`` decoded bytes. ``stopped``: the block after them is
        bad or short; ``src`` and ``basesrc`` are put back to its start."""
        blocks, total, stopped = [], 0, False
        while target_size and total < READ_AHEAD:
            hdr_pos = src.tell()
            blk = self._read_block(src, block_max, target_size,
                                   basesrc is not None)
            if blk is None:
                src.seek(hdr_pos)
                stopped = True
                break
            blk.hdr_pos = hdr_pos
            blocks.append(blk)
            total += blk.dsize
            target_size -= blk.dsize
        if basesrc is not None and blocks:
            with span("mspack.oab.base", self.timings, "base_ms"):
                kept = self._read_base(src, basesrc, blocks)
            if kept < len(blocks):
                del blocks[kept:]
                stopped = True
        return blocks, stopped

    @staticmethod
    def _read_block(src, block_max: int, target_size: int, patch: bool):
        """One block's header and payload read whole, or None where the
        reference loop would raise or decode a short payload (the header
        tests are the reference's, above). A patch block's reference data
        is read after the batch's walk (``_read_base``)."""
        hdr = src.read(OABBLK_SIZEOF)
        if len(hdr) < OABBLK_SIZEOF:
            return None
        f = [int.from_bytes(hdr[i:i + 4], "little") for i in (0, 4, 8, 12)]
        if not patch:
            flags, csize, dsize, crc = f
            if dsize > block_max or dsize > target_size or flags > 1 \
                    or (not flags and dsize != csize):
                return None
            window_size, ssize = dsize, 0
        else:
            csize, dsize, ssize, crc = f
            flags = 1
            if dsize > block_max or dsize > target_size or ssize > block_max:
                return None
            window_size = ((ssize + 32767) & ~32767) + dsize
        window_bits = 17
        while window_bits < 25 and (1 << window_bits) < window_size:
            window_bits += 1
        payload = src.read(csize)
        if len(payload) < csize:
            return None
        return _Block(flags=flags, csize=csize, dsize=dsize, crc=crc,
                      window_bits=window_bits, payload=payload, ssize=ssize,
                      ref=None)

    def _read_base(self, src, basesrc, blocks) -> int:
        """The blocks' reference data in one read from the base, each block
        given its slice; returns how many blocks got theirs whole. Where the
        base ends short of block k's, ``src`` and ``basesrc`` are put back
        to block k's header and reference data, as the reference loop,
        which raises there, reads them."""
        base_pos = basesrc.tell()
        data = memoryview(basesrc.read(sum(b.ssize for b in blocks)))
        at = 0
        for k, blk in enumerate(blocks):
            if at + blk.ssize > len(data):
                src.seek(blk.hdr_pos)
                basesrc.seek(base_pos + at)
                break
            blk.ref = data[at:at + blk.ssize]
            at += blk.ssize
        else:
            k = len(blocks)
        self.timings["base_bytes"] = self.timings.get("base_bytes", 0) + at
        return k

    def _decode_batch(self, blocks):
        """Each block's bytes from K3: None for a stored block and for an
        LZX block whose lane declined."""
        if self.cuda_engine is None:
            from ..parallel.cuda_pipeline import CudaLzxEngine
            self.cuda_engine = CudaLzxEngine(self.device)
        outs = [None] * len(blocks)
        groups: dict[int, list[int]] = {}
        for i, b in enumerate(blocks):
            if b.flags:
                groups.setdefault(b.window_bits, []).append(i)
        for wb, idx in groups.items():
            self.stats["engine calls"] += 1
            got = self.cuda_engine.decode_streams(
                [blocks[i].payload for i in idx],
                [blocks[i].dsize for i in idx], wb, is_delta=True,
                refs=[blocks[i].ref or b"" for i in idx], per_lane=True)
            for i, out in zip(idx, got):
                outs[i] = out
        return outs

    def _write_block(self, sink, blk: _Block, out) -> None:
        """Block ``blk`` into the sink: a stored block's bytes, or K3's
        bytes and then their CRC checked, as the scalar path writes a block
        and checks it (a mismatch raises ``ChecksumError``); a block whose
        lane declined goes through the scalar path, which raises the
        reference's error."""
        if not blk.flags:
            sink.write(blk.payload)
            self.stats["stored blocks"] += 1
            return
        if out is not None:
            t0 = time.perf_counter()
            crc = crc32_raw(out)
            add_ms(self.timings, "crc_ms", t0)
            sink.write(out)
            if crc != blk.crc:
                raise ChecksumError("OAB block CRC mismatch")
            self.stats["device blocks"] += 1
            return
        note_fallback(self, "oab_lzx_cuda",
                      f"block at file offset {blk.hdr_pos} declined "
                      f"({dict(self.cuda_engine.declines)})")
        self.stats["scalar blocks"] += 1
        self._decode_block(open_source(blk.payload), sink, blk.csize,
                           blk.dsize, blk.crc, blk.window_bits, blk.ref)

    # -- helpers ---------------------------------------------------------

    def _decode_block(self, src, sink, csize: int, dsize: int, crc: int,
                      window_bits: int, ref_data: bytes | None) -> None:
        if self.engine == "torch":
            stream = src.read(csize)
            if len(stream) == csize and self._decode_block_torch(
                    sink, stream, dsize, crc, window_bits, ref_data):
                return
            # the ops declined: re-feed the bytes to the scalar path
            src = open_source(stream)
        if self.engine == "native":
            # whole-block decode on the native engine; fall through to
            # the scalar path on any shortfall
            stream = src.read(csize)
            if len(stream) == csize:
                from .. import native
                if self._scratch is None:
                    self._scratch = native.Scratch()
                out = self._scratch.get(max(dsize, 1))[:dsize]
                if native.lzx_decode_into(stream, csize, window_bits, 0,
                                          out, dsize, is_delta=True,
                                          ref_data=ref_data):
                    if crc32_raw(out) != crc:
                        raise ChecksumError("OAB block CRC mismatch")
                    sink.write(out)
                    return
            # native path declined: re-feed the bytes to the scalar path
            src = open_source(stream)
        budget = {"left": csize}

        def read_fn(n: int) -> bytes:
            n = min(n, budget["left"])
            data = src.read(n)
            budget["left"] -= len(data)
            return data

        crc_state = {"crc": 0xFFFFFFFF}

        def write_fn(data: bytes) -> None:
            crc_state["crc"] = crc32_raw(data, crc_state["crc"])
            sink.write(data)

        lzx = LzxDecompressor(read_fn, window_bits, 0, dsize,
                              is_delta=True, input_buffer_size=self.buf_size,
                              message=self.message)
        if ref_data is not None:
            lzx.set_reference_data(ref_data)
        lzx.decompress(dsize, write_fn)

        # consume trailing padding within the block's compressed budget
        while budget["left"]:
            if not read_fn(min(self.buf_size, budget["left"])):
                raise ReadError("EOF consuming block padding")

        if crc_state["crc"] != crc:
            raise ChecksumError("OAB block CRC mismatch")

    def _decode_block_torch(self, sink, stream, dsize: int, crc: int,
                            window_bits: int, ref_data) -> bool:
        """One whole LZX DELTA block through ``lzx_stream_decode``, its CRC
        checked before the bytes are written (a mismatch raises
        ``ChecksumError``, as the JAX package's ``"jax"`` engine does);
        False when the ops decline (noted, ``FallbackError`` under
        strict)."""
        from ..ops.lzx import lzx_stream_decode

        declined = collections.Counter()
        try:
            out = lzx_stream_decode(stream, window_bits, dsize,
                                    is_delta=True, ref_data=ref_data,
                                    device=self.device, declines=declined,
                                    timings=self.timings)
        except (IndexError, OverflowError) as e:
            # the host header walk on a malformed block (a stored block
            # past the data, a stored R above 2^31 - 1); the JAX engine
            # catches these too
            declined[type(e).__name__] += 1
            out = None
        if out is None:
            self.torch_declines.update(declined)
            self.stats["scalar blocks"] += 1
            note_fallback(self, "oab_lzx_torch", declined)
            return False
        t0 = time.perf_counter()
        ok = crc32_raw(out) == crc
        add_ms(self.timings, "crc_ms", t0)
        if not ok:
            raise ChecksumError("OAB block CRC mismatch")
        sink.write(out)
        self.stats["device blocks"] += 1
        return True

    def decompress_bytes(self, data: PathOrBytes) -> bytes:
        sink = BytesSink()
        self.decompress(data, sink)
        return sink.getvalue()

    def decompress_incremental_bytes(self, patch: PathOrBytes,
                                     base: PathOrBytes) -> bytes:
        sink = BytesSink()
        self.decompress_incremental(patch, base, sink)
        return sink.getvalue()
