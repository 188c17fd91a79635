"""MSZIP decoder (L2 codec): RFC1951 inflate inside 'CK' frames.

Format semantics (reference: libmspack/mspack/mszipd.c, mszip.h):

* LSB-first bitstream; 32 KiB frames, each starting at a byte-aligned
  'CK' signature which is *scanned* for (mszipd.c:407-414).
* History survives across frames: match distances may reach into the
  previous frame's bytes. This distinguishes MSZIP from independent
  per-block deflate.
* Repair mode ("FIXMSZIP") zero-fills a failed frame and continues.
* KWAJ variant: frames carry a 16-bit length prefix instead of being
  scanned, and the stream ends at a zero length (mszipd.c:462-495).

Architecture: unlike the reference's pull-streaming inner loop, this
decoder uses the framework's engine shape (shared with the native C++
and device pipelines): **phase A** tokenises a whole deflate stream
into a flat command list + literal staging buffer, **phase B** replays
the commands into a linear history buffer using overlap-safe slice
copies. Commands are (literal_run, copy_len, copy_dist) triples — the
canonical LZ command form — so phase B never branches per byte.

Copied from ``libmspack_tpu/codecs/mszip.py`` so that the port imports nothing
of the JAX package; the copy differs in nothing else.
"""
from __future__ import annotations

from ..errors import DataFormatError, DecrunchError, MSPackError, ReadError
from .bitstream import ByteFeed, LSBBitReader
from .huffman import HuffTable

FRAME_SIZE = 32768
LITERAL_MAXSYMBOLS = 288
LITERAL_TABLEBITS = 9
DISTANCE_MAXSYMBOLS = 32
DISTANCE_TABLEBITS = 6

# match lengths for literal codes 257..285 (RFC1951 3.2.5)
LIT_LENGTHS = (3, 4, 5, 6, 7, 8, 9, 10, 11, 13, 15, 17, 19, 23, 27,
               31, 35, 43, 51, 59, 67, 83, 99, 115, 131, 163, 195, 227, 258)
LIT_EXTRABITS = (0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 2, 2,
                 2, 2, 3, 3, 3, 3, 4, 4, 4, 4, 5, 5, 5, 5, 0)
DIST_OFFSETS = (1, 2, 3, 4, 5, 7, 9, 13, 17, 25, 33, 49, 65, 97, 129, 193,
                257, 385, 513, 769, 1025, 1537, 2049, 3073, 4097, 6145, 8193,
                12289, 16385, 24577)
DIST_EXTRABITS = (0, 0, 0, 0, 1, 1, 2, 2, 3, 3, 4, 4, 5, 5, 6,
                  6, 7, 7, 8, 8, 9, 9, 10, 10, 11, 11, 12, 12, 13, 13)
BITLEN_ORDER = (16, 17, 18, 0, 8, 7, 9, 6, 10, 5, 11, 4, 12, 3, 13, 2, 14, 1, 15)

FIXED_LITERAL_LENS = bytes([8] * 144 + [9] * 112 + [7] * 24 + [8] * 8)
FIXED_DISTANCE_LENS = bytes([5] * 32)


def lz_fill(history: bytearray, cursor: int, dist: int, n: int) -> None:
    """Overlap-safe copy of n bytes from `dist` back onto `cursor`
    (pattern doubling when dist < n). The framework's shared phase-B
    copy primitive."""
    src = cursor - dist
    if dist >= n:
        history[cursor : cursor + n] = history[src : src + n]
        return
    history[cursor : cursor + dist] = history[src : cursor]
    filled = dist
    while filled < n:
        take = min(filled, n - filled)
        history[cursor + filled : cursor + filled + take] = \
            history[cursor : cursor + take]
        filled += take


def replay_commands(history: bytearray, cursor: int, commands, staging,
                    limit: int) -> int:
    """Phase B: apply LZ commands to `history` starting at `cursor`.

    Each command is (literal_run, copy_len, copy_dist); literal bytes
    come sequentially from `staging`. Copies are overlap-safe slice
    fills. Raises DecrunchError if output would pass `limit`. Returns
    the new cursor.
    """
    staged = 0
    for lit_run, copy_len, dist in commands:
        if cursor + lit_run + copy_len > limit:
            raise DecrunchError("frame overflow")
        if lit_run:
            history[cursor : cursor + lit_run] = \
                staging[staged : staged + lit_run]
            staged += lit_run
            cursor += lit_run
        if copy_len:
            lz_fill(history, cursor, dist, copy_len)
            cursor += copy_len
    return cursor


class MszipDecompressor:
    """Streaming MSZIP decoder over a read(n)->bytes input callable."""

    def __init__(self, read_fn, input_buffer_size: int = 2048,
                 repair_mode: bool = False, message=None):
        input_buffer_size = max(2, (input_buffer_size + 1) & -2)
        self.bits = LSBBitReader(ByteFeed(read_fn, chunk=input_buffer_size))
        # linear history: one frame of back-reference reach + the
        # frame being decoded. The tail is slid down between frames.
        self.history = bytearray(2 * FRAME_SIZE)
        self.repair_mode = repair_mode
        self.message = message or (lambda s: None)
        self._pending = b""  # decoded bytes not yet handed to the caller
        self.error: MSPackError | None = None

    # -- phase A: deflate stream -> command list ---------------------------

    def _read_dynamic_lens(self):
        """Parse a dynamic-block header into (lit_lens, dist_lens)."""
        bits = self.bits
        nlit = bits.read(5) + 257
        ndist = bits.read(5) + 1
        npre = bits.read(4) + 4
        if nlit > LITERAL_MAXSYMBOLS or ndist > DISTANCE_MAXSYMBOLS:
            raise DecrunchError("too many symbols in dynamic header")

        pre_lens = bytearray(19)
        for i in range(npre):
            pre_lens[BITLEN_ORDER[i]] = bits.read(3)
        pre = HuffTable(19, 7, pre_lens, lsb=True)

        lens = bytearray(nlit + ndist)
        fill_pos = 0
        prev = 0
        while fill_pos < len(lens):
            sym = pre.decode(bits)
            if sym < 16:
                lens[fill_pos] = prev = sym
                fill_pos += 1
                continue
            if sym == 16:
                run, value = bits.read(2) + 3, prev
            elif sym == 17:
                run, value = bits.read(3) + 3, 0
            elif sym == 18:
                run, value = bits.read(7) + 11, 0
            else:
                raise DecrunchError(f"invalid bit-length code {sym}")
            if fill_pos + run > len(lens):
                raise DecrunchError("bitlen RLE overruns table")
            lens[fill_pos : fill_pos + run] = bytes([value]) * run
            fill_pos += run

        lit_lens = bytes(lens[:nlit]) + bytes(LITERAL_MAXSYMBOLS - nlit)
        dist_lens = bytes(lens[nlit:]) + bytes(DISTANCE_MAXSYMBOLS - ndist)
        return lit_lens, dist_lens

    def _tokenize_huff_block(self, lit: HuffTable, dist: HuffTable,
                             commands: list, staging: bytearray) -> None:
        """Decode one Huffman-coded block into commands + staging."""
        bits = self.bits
        append_lit = staging.append
        emit = commands.append
        lit_run = 0
        while True:
            sym = lit.decode(bits)
            if sym < 256:
                append_lit(sym)
                lit_run += 1
                continue
            if sym == 256:
                if lit_run:
                    emit((lit_run, 0, 0))
                return
            slot = sym - 257
            if slot >= 29:
                raise DecrunchError("out-of-range literal code")
            extra = LIT_EXTRABITS[slot]
            copy_len = LIT_LENGTHS[slot] + (bits.read(extra) if extra else 0)
            dslot = dist.decode(bits)
            if dslot >= 30:
                raise DecrunchError("out-of-range distance code")
            extra = DIST_EXTRABITS[dslot]
            copy_dist = DIST_OFFSETS[dslot] + \
                (bits.read(extra) if extra else 0)
            emit((lit_run, copy_len, copy_dist))
            lit_run = 0

    def _tokenize_stored_block(self, commands: list,
                               staging: bytearray) -> None:
        """Stored block: realign, length check, raw bytes to staging."""
        bits = self.bits
        bits.align_byte()
        header = bytearray()
        while bits.bits_left >= 8:
            if len(header) == 4:
                raise DecrunchError("too many bits in bit buffer")
            header.append(bits.peek(8))
            bits.remove(8)
        if bits.bits_left != 0:
            raise DecrunchError("unaligned bit buffer")
        while len(header) < 4:
            header.append(bits.feed.next_byte())
        length = header[0] | (header[1] << 8)
        if length != (~(header[2] | (header[3] << 8)) & 0xFFFF):
            raise DecrunchError("stored block length complement mismatch")
        taken = 0
        while taken < length:
            chunk = bits.feed.next_bytes(length - taken)
            if not chunk:
                raise ReadError("EOF in stored block")
            staging.extend(chunk)
            taken += len(chunk)
        if length:
            commands.append((length, 0, 0))

    # -- frame assembly -----------------------------------------------------

    def _decode_frame(self) -> int:
        """Decode one complete deflate stream into history[FRAME_SIZE:].

        Returns the number of bytes produced (<= FRAME_SIZE). On error,
        whatever was produced before the failure is already in place
        (needed by repair mode); the exception carries a `produced`
        attribute with that count.
        """
        bits = self.bits
        cursor = FRAME_SIZE
        limit = 2 * FRAME_SIZE
        try:
            while True:
                final = bits.read(1)
                kind = bits.read(2)
                commands: list = []
                staging = bytearray()
                if kind == 0:
                    self._tokenize_stored_block(commands, staging)
                elif kind == 1:
                    lit = HuffTable(LITERAL_MAXSYMBOLS, LITERAL_TABLEBITS,
                                    FIXED_LITERAL_LENS, lsb=True)
                    dist = HuffTable(DISTANCE_MAXSYMBOLS, DISTANCE_TABLEBITS,
                                     FIXED_DISTANCE_LENS, lsb=True)
                    self._tokenize_huff_block(lit, dist, commands, staging)
                elif kind == 2:
                    lit_lens, dist_lens = self._read_dynamic_lens()
                    lit = HuffTable(LITERAL_MAXSYMBOLS, LITERAL_TABLEBITS,
                                    lit_lens, lsb=True)
                    dist = HuffTable(DISTANCE_MAXSYMBOLS, DISTANCE_TABLEBITS,
                                     dist_lens, lsb=True)
                    self._tokenize_huff_block(lit, dist, commands, staging)
                else:
                    raise DecrunchError(f"bad deflate block type {kind}")
                cursor = replay_commands(self.history, cursor, commands,
                                         staging, limit)
                if final:
                    return cursor - FRAME_SIZE
        except (DecrunchError, DataFormatError, ReadError) as exc:
            exc.produced = cursor - FRAME_SIZE  # type: ignore[attr-defined]
            raise

    def _slide(self, produced: int) -> bytes:
        """Hand back the frame's bytes and slide history for the next."""
        frame = bytes(self.history[FRAME_SIZE : FRAME_SIZE + produced])
        if produced:
            keep = self.history[produced : FRAME_SIZE + produced]
            self.history[:FRAME_SIZE] = keep
        return frame

    # -- public entry points ---------------------------------------------

    def decompress(self, out_bytes: int, write_fn) -> None:
        """CAB entry point: decode out_bytes, scanning 'CK' per frame."""
        if self.error:
            raise self.error
        if out_bytes < 0:
            raise MSPackError("negative out_bytes")

        # hand out bytes left over from the previous frame first
        if self._pending:
            take = min(len(self._pending), out_bytes)
            write_fn(self._pending[:take])
            self._pending = self._pending[take:]
            out_bytes -= take

        bits = self.bits
        while out_bytes > 0:
            # scan (byte-aligned) for the next 'CK' signature
            bits.align_byte()
            seen_c = False
            while True:
                byte = bits.read(8)
                if seen_c and byte == 0x4B:
                    break
                seen_c = byte == 0x43
            try:
                produced = self._decode_frame()
            except (DecrunchError, DataFormatError) as exc:
                if not self.repair_mode:
                    self.error = DecrunchError(str(exc))
                    raise self.error from exc
                # salvage: keep what decoded, zero-fill the remainder
                produced = getattr(exc, "produced", 0)
                self.message("MSZIP error, %u bytes of data lost."
                             % (FRAME_SIZE - produced))
                tail = self.history
                for i in range(FRAME_SIZE + produced, 2 * FRAME_SIZE):
                    tail[i] = 0
                produced = FRAME_SIZE

            frame = self._slide(produced)
            take = min(out_bytes, produced)
            write_fn(frame[:take])
            self._pending = frame[take:]
            out_bytes -= take

    def decompress_kwaj(self, write_fn) -> None:
        """KWAJ entry point: 16-bit-length-prefixed CK frames until len==0."""
        bits = self.bits
        while True:
            bits.align_byte()
            block_len = bits.read(8) | (bits.read(8) << 8)
            if block_len == 0:
                break
            if bits.read(8) != 0x43 or bits.read(8) != 0x4B:
                raise DataFormatError("missing CK signature in KWAJ block")
            produced = self._decode_frame()
            write_fn(self._slide(produced))
