"""LZX / LZX DELTA decoder (L2 codec) — used by CAB, CHM and OAB.

Format semantics (reference: libmspack/mspack/lzxd.c, lzx.h):

* MSB-first bitstream of 16-bit little-endian units.
* 32 KiB frames; the bitstream realigns to 16 bits at each frame end;
  an optional reset interval fully re-initialises entropy state every
  N frames (the random-access / parallel-shard grid).
* Block types: VERBATIM, ALIGNED (extra 8-symbol aligned-offset tree),
  UNCOMPRESSED (byte-aligned raw bytes + literal R0-R2 values).
* 4 Huffman trees (pretree 20 / maintree 256+8*slots / length 250 /
  aligned 8); main+length code lengths are delta-coded via the pretree
  with run codes 17/18/19.
* Match offsets use position slots + extra bits + a 3-entry
  repeated-offset LRU.
* E8 call-translation post-pass on frames < 32768 when an "intel
  filesize" header was present.
* DELTA extension: window 2^17..2^25, reference data pre-loaded at the
  window tail, extra match-length escape for matches up to 33024.

Architecture: the framework's two-phase engine shape (shared with the
native C++ and device pipelines) instead of the reference's fused
pull loop. **Phase A** tokenises each 32 KiB frame into a flat command
list (literal_run, copy_len, copy_dist) plus a literal staging buffer;
**phase B** replays the commands into a *linear* sliding history
buffer with overlap-safe slice copies. The reference's ring-buffer
reads map onto linear history distances: a ring read at offset `mo`
is linear distance `mo` while the source hasn't been overwritten, and
distance `mo - window_size` for the aliased region when `mo` exceeds
the window (reachable with w15 position slots).

Copied from ``libmspack_tpu/codecs/lzx.py`` so that the port imports nothing
of the JAX package; the copy differs in nothing else.
"""
from __future__ import annotations

from ..errors import ArgsError, DecrunchError, MSPackError
from .bitstream import ByteFeed, MSBBitReader
from .huffman import HuffTable
from .mszip import replay_commands

MIN_MATCH = 2
MAX_MATCH = 257
NUM_CHARS = 256
BLOCK_VERBATIM = 1
BLOCK_ALIGNED = 2
BLOCK_UNCOMPRESSED = 3
PRETREE_NUM_ELEMENTS = 20
ALIGNED_NUM_ELEMENTS = 8
NUM_PRIMARY_LENGTHS = 7
NUM_SECONDARY_LENGTHS = 249

PRETREE_MAXSYMBOLS = PRETREE_NUM_ELEMENTS
PRETREE_TABLEBITS = 6
MAINTREE_MAXSYMBOLS = NUM_CHARS + 290 * 8
MAINTREE_TABLEBITS = 12
LENGTH_MAXSYMBOLS = NUM_SECONDARY_LENGTHS + 1
LENGTH_TABLEBITS = 12
ALIGNED_MAXSYMBOLS = ALIGNED_NUM_ELEMENTS
ALIGNED_TABLEBITS = 7
LENTABLE_SAFETY = 64  # run-length decoding may overrun by up to this

FRAME_SIZE = 32768

# number of position slots for window_bits 15..25 (lzxd.c:209-211)
POSITION_SLOTS = (30, 32, 34, 36, 38, 42, 50, 66, 98, 162, 290)

# extra bits per position slot: 0,0,0,0,1,1,2,2,... capped at 17 (>=36)
EXTRA_BITS = tuple(0 if i < 4 else min((i // 2) - 1, 17)
                   for i in range(290 + 1))


def _make_position_base():
    base = []
    offset = 0
    for i in range(290):
        base.append(offset)
        offset += 1 << EXTRA_BITS[i]
    return tuple(base)


POSITION_BASE = _make_position_base()


class LzxDecompressor:
    """Streaming LZX decoder over a read(n)->bytes input callable."""

    def __init__(self, read_fn, window_bits: int, reset_interval: int,
                 output_length: int = 0, is_delta: bool = False,
                 input_buffer_size: int = 4096, message=None):
        if is_delta:
            if not (17 <= window_bits <= 25):
                raise ArgsError("LZX DELTA window must be 2^17..2^25")
        else:
            if not (15 <= window_bits <= 21):
                raise ArgsError("LZX window must be 2^15..2^21")
        if reset_interval < 0 or output_length < 0:
            raise ArgsError("reset interval / output length < 0")

        self.bits = MSBBitReader(
            ByteFeed(read_fn, chunk=max(2, input_buffer_size)),
            unit_order="le")
        self.window_size = 1 << window_bits
        # linear history: the first window_size bytes stand for the
        # "virtual pre-stream" (zeros, or DELTA reference data at the
        # tail); decoded bytes append after them. Slid between frames.
        self.history = bytearray(self.window_size)
        self.cursor = 0           # absolute output position decoded
        self.origin = -self.window_size  # absolute position of history[0]
        self.delivered = 0        # total bytes handed to the caller
        self.length = output_length
        self.ref_data_size = 0
        self.frame = 0            # frame counter
        self.frame_base = 0       # absolute position of current frame
        self.reset_interval = reset_interval
        self.intel_filesize = 0
        self.intel_started = False
        self.num_offsets = POSITION_SLOTS[window_bits - 15] << 3
        self.is_delta = is_delta
        self.error: MSPackError | None = None
        self.message = message or (lambda s: None)
        self._warned = False
        self._pending = b""       # decoded frame bytes not yet handed out

        self.maintree_lens = [0] * (MAINTREE_MAXSYMBOLS + LENTABLE_SAFETY)
        self.length_lens = [0] * (LENGTH_MAXSYMBOLS + LENTABLE_SAFETY)
        self._trees: dict = {}
        self.length_empty = False
        self._reset_entropy()

    # -- state management --------------------------------------------------

    def _reset_entropy(self) -> None:
        """Reset the per-reset-interval entropy state (lzxd.c:421-438)."""
        self.rep_offsets = [1, 1, 1]
        self.header_read = False
        self.block_remaining = 0
        self.block_type = 0
        self.block_length = 0
        for i in range(MAINTREE_MAXSYMBOLS):
            self.maintree_lens[i] = 0
        for i in range(LENGTH_MAXSYMBOLS):
            self.length_lens[i] = 0

    def set_reference_data(self, data: bytes | None) -> None:
        """Pre-load DELTA reference data at the top of the window
        (reference: lzxd.c:348-382)."""
        if not self.is_delta:
            raise ArgsError("only LZX DELTA streams support reference data")
        if self.delivered:
            raise ArgsError("too late to set reference data")
        size = len(data) if data else 0
        if size > self.window_size:
            raise ArgsError("reference data longer than window")
        self.ref_data_size = size
        if size:
            self.history[self.window_size - size : self.window_size] = data

    def set_output_length(self, out_bytes: int) -> None:
        if out_bytes > 0:
            self.length = out_bytes

    # -- phase A helpers: tree decoding -------------------------------------

    def _read_delta_lens(self, lens: list, first: int, last: int) -> None:
        """Delta-coded code lengths via the pretree
        (reference: lzxd.c:138-183)."""
        bits = self.bits
        pre_lens = [bits.read(4) for _ in range(PRETREE_NUM_ELEMENTS)]
        pretree = HuffTable(PRETREE_MAXSYMBOLS, PRETREE_TABLEBITS,
                            pre_lens, lsb=False)
        pos = first
        while pos < last:
            sym = pretree.decode(bits)
            if sym == 17:
                run = bits.read(4) + 4
                lens[pos : pos + run] = [0] * run
                pos += run
            elif sym == 18:
                run = bits.read(5) + 20
                lens[pos : pos + run] = [0] * run
                pos += run
            elif sym == 19:
                run = bits.read(1) + 4
                sym = pretree.decode(bits)
                # sym may be 17..19 on malformed streams: a single +17
                # wrap then an unsigned-char store, exactly like the
                # reference (lzxd.c lens[] is unsigned char; values
                # > 16 are then ignored by make_decode_table)
                value = lens[pos] - sym
                if value < 0:
                    value += 17
                value &= 0xFF
                lens[pos : pos + run] = [value] * run
                pos += run
            else:
                value = lens[pos] - sym
                if value < 0:
                    value += 17
                lens[pos] = value & 0xFF
                pos += 1

    def _build_trees(self, aligned: bool) -> None:
        bits = self.bits
        trees = self._trees
        if aligned:
            align_lens = [bits.read(3) for _ in range(8)]
            trees["aligned"] = HuffTable(
                ALIGNED_MAXSYMBOLS, ALIGNED_TABLEBITS, align_lens, lsb=False)

        self._read_delta_lens(self.maintree_lens, 0, 256)
        self._read_delta_lens(self.maintree_lens, 256,
                              NUM_CHARS + self.num_offsets)
        trees["main"] = HuffTable(
            MAINTREE_MAXSYMBOLS, MAINTREE_TABLEBITS,
            self.maintree_lens[:MAINTREE_MAXSYMBOLS], lsb=False)
        if self.maintree_lens[0xE8] != 0:
            self.intel_started = True

        self._read_delta_lens(self.length_lens, 0, NUM_SECONDARY_LENGTHS)
        trees["length"] = HuffTable(
            LENGTH_MAXSYMBOLS, LENGTH_TABLEBITS,
            self.length_lens[:LENGTH_MAXSYMBOLS], lsb=False,
            allow_empty=True)
        self.length_empty = trees["length"].empty

    # -- phase A: symbol stream -> commands ----------------------------------

    def _begin_block(self) -> None:
        """Parse a block header; build trees / read raw R values."""
        bits = self.bits
        # realign after an odd-sized uncompressed block
        if (self.block_type == BLOCK_UNCOMPRESSED
                and (self.block_length & 1)):
            bits.feed.next_byte()

        self.block_type = bits.read(3)
        hi, lo = bits.read(16), bits.read(8)
        self.block_remaining = self.block_length = (hi << 8) | lo

        if self.block_type == BLOCK_ALIGNED:
            self._build_trees(aligned=True)
        elif self.block_type == BLOCK_VERBATIM:
            self._build_trees(aligned=False)
        elif self.block_type == BLOCK_UNCOMPRESSED:
            self.intel_started = True
            # align to a 16-bit boundary, dropping 1-16 bits
            if bits.bits_left == 0:
                bits.ensure(16)
            bits.bits_left = 0
            bits.bit_buffer = 0
            raw = bytes(bits.feed.next_byte() for _ in range(12))
            self.rep_offsets = [
                int.from_bytes(raw[k : k + 4], "little") for k in (0, 4, 8)]
        else:
            raise DecrunchError("bad block type")

    def _match_offset(self, slot: int, aligned_block: bool) -> int:
        """Resolve a position slot to a match offset, updating the
        repeated-offset LRU (lzxd.c:565-585)."""
        bits = self.bits
        reps = self.rep_offsets
        if slot == 0:
            return reps[0]
        if slot == 1:
            reps[0], reps[1] = reps[1], reps[0]
            return reps[0]
        if slot == 2:
            reps[0], reps[2] = reps[2], reps[0]
            return reps[0]
        extra = 17 if slot >= 36 else EXTRA_BITS[slot]
        offset = POSITION_BASE[slot] - 2
        if extra >= 3 and aligned_block:
            if extra > 3:
                offset += bits.read(extra - 3) << 3
            offset += self._trees["aligned"].decode(bits)
        elif extra:
            offset += bits.read(extra)
        reps[2] = reps[1]
        reps[1] = reps[0]
        reps[0] = offset
        return offset

    def _tokenize_span(self, span: int, commands: list,
                       staging: bytearray) -> int:
        """Decode Huffman symbols until `span` output bytes are covered
        (the final match may overrun). Returns bytes actually covered.
        """
        bits = self.bits
        wsize = self.window_size
        aligned_block = self.block_type == BLOCK_ALIGNED
        main = self._trees["main"]
        length_tree = self._trees["length"]
        cursor = self.cursor
        produced = 0
        lit_run = 0
        emit = commands.append
        append_lit = staging.append

        while produced < span:
            element = main.decode(bits)
            if element < NUM_CHARS:
                append_lit(element)
                lit_run += 1
                produced += 1
                continue
            element -= NUM_CHARS

            copy_len = element & NUM_PRIMARY_LENGTHS
            if copy_len == NUM_PRIMARY_LENGTHS:
                if self.length_empty:
                    raise DecrunchError(
                        "LENGTH symbol needed but tree is empty")
                copy_len += length_tree.decode(bits)
            copy_len += MIN_MATCH

            offset = self._match_offset(element >> 3, aligned_block)

            # DELTA long-match escape (lzxd.c:588-611)
            if copy_len == MAX_MATCH and self.is_delta:
                bits.ensure(3)
                if bits.peek(1) == 0:
                    bits.remove(1)
                    copy_len += bits.read(8)
                elif bits.peek(2) == 2:
                    bits.remove(2)
                    copy_len += bits.read(10) + 0x100
                elif bits.peek(3) == 6:
                    bits.remove(3)
                    copy_len += bits.read(12) + 0x500
                else:
                    bits.remove(3)
                    copy_len += bits.read(15)

            dest = cursor + produced
            lap_pos = dest % wsize
            if lap_pos + copy_len > wsize:
                raise DecrunchError("match ran over window wrap")

            if offset > lap_pos:
                # source lies behind the window wrap point
                if (offset > self.delivered
                        and (offset - lap_pos) > self.ref_data_size):
                    raise DecrunchError("match offset beyond LZX stream")
                tail_run = offset - lap_pos
                if tail_run > wsize:
                    raise DecrunchError(
                        "match offset beyond window boundaries")
                if offset > wsize:
                    # ring aliasing: the tail region was overwritten by
                    # this lap, so the first tail_run bytes read at
                    # linear distance offset - wsize, the rest at offset
                    first = min(copy_len, tail_run)
                    emit((lit_run, first, offset - wsize))
                    lit_run = 0
                    if copy_len > first:
                        emit((0, copy_len - first, offset))
                else:
                    emit((lit_run, copy_len, offset))
                    lit_run = 0
            else:
                emit((lit_run, copy_len, offset))
                lit_run = 0
            produced += copy_len

        if lit_run:
            emit((lit_run, 0, 0))
        return produced

    # -- main drive loop -----------------------------------------------------

    def decompress(self, out_bytes: int, write_fn) -> None:
        if self.error:
            raise self.error
        if out_bytes < 0:
            raise ArgsError("negative out_bytes")
        try:
            self._decompress(out_bytes, write_fn)
        except MSPackError as exc:
            self.error = exc
            raise

    def _decompress(self, out_bytes: int, write_fn) -> None:
        bits = self.bits
        wsize = self.window_size

        # flush stored-up bytes first
        if self._pending:
            take = min(len(self._pending), out_bytes)
            write_fn(self._pending[:take])
            self._pending = self._pending[take:]
            self.delivered += take
            out_bytes -= take
        if out_bytes == 0:
            return

        end_frame = (self.delivered + out_bytes) // FRAME_SIZE + 1

        while self.frame < end_frame:
            # reset interval
            if self.reset_interval and \
                    (self.frame % self.reset_interval) == 0:
                if self.block_remaining and not self._warned:
                    # format error; best effort (lzxd.c:424-431)
                    self.message("WARNING; invalid reset interval detected "
                                 "during LZX decompression")
                    self._warned = True
                self._reset_entropy()

            # LZX DELTA has a 16-bit chunk size before each frame
            if self.is_delta:
                bits.ensure(16)
                bits.remove(16)

            if not self.header_read:
                header = bits.read(1)
                value = (bits.read(16) << 16) | bits.read(16) if header else 0
                self.intel_filesize = (value - 0x100000000
                                       if value & 0x80000000 else value)
                self.header_read = True

            frame_size = FRAME_SIZE
            if self.length and (self.length - self.delivered) < frame_size:
                frame_size = self.length - self.delivered

            # phase A: tokenize the frame; phase B: replay immediately
            # per span so tokenizer guards see up-to-date history.
            frame_todo = self.frame_base + frame_size - self.cursor
            while frame_todo > 0:
                if self.block_remaining == 0:
                    self._begin_block()

                span = min(self.block_remaining, frame_todo)
                self.block_remaining -= span

                if self.block_type in (BLOCK_VERBATIM, BLOCK_ALIGNED):
                    commands: list = []
                    staging = bytearray()
                    covered = self._tokenize_span(span, commands, staging)
                elif self.block_type == BLOCK_UNCOMPRESSED:
                    staging = bytearray()
                    while len(staging) < span:
                        chunk = bits.feed.next_bytes(span - len(staging))
                        if not chunk:
                            raise DecrunchError("EOF in uncompressed block")
                        staging.extend(chunk)
                    commands = [(span, 0, 0)]
                    covered = span
                else:
                    raise DecrunchError("bad block type")

                rel = self.cursor - self.origin
                need = rel + covered - len(self.history)
                if need > 0:
                    self.history.extend(bytes(need))
                replay_commands(self.history, rel, commands, staging,
                                len(self.history))
                self.cursor += covered
                frame_todo -= covered

                # did the final match overrun the span?
                overrun = covered - span
                if overrun > 0:
                    if overrun > self.block_remaining:
                        raise DecrunchError("overrun went past end of block")
                    self.block_remaining -= overrun

            # streams don't extend over frame boundaries
            if (self.cursor - self.frame_base) != frame_size:
                raise DecrunchError("decode beyond output frame limits")

            # re-align bitstream to 16 bits
            if bits.bits_left > 0:
                bits.ensure(16)
            if bits.bits_left & 15:
                bits.remove(bits.bits_left & 15)

            # check that we've used all of the previous frame first
            if self._pending:
                raise DecrunchError("previous frame not fully consumed")

            # E8 call translation (reference: lzxd.c:706-733)
            rel = self.frame_base - self.origin
            frame_data = self.history[rel : rel + frame_size]
            if (self.intel_started and self.intel_filesize
                    and self.frame < 32768 and frame_size > 10):
                frame_data = _e8_transform(frame_data, self.delivered,
                                           self.intel_filesize)

            take = min(out_bytes, frame_size)
            write_fn(bytes(frame_data[:take]))
            self._pending = bytes(frame_data[take:])
            self.delivered += take
            out_bytes -= take

            self.frame_base += frame_size
            self.frame += 1

            # slide history, keeping one window of back-reference reach
            excess = (self.cursor - self.origin) - 2 * wsize
            if excess > 0:
                del self.history[:excess]
                self.origin += excess

        if out_bytes:
            raise DecrunchError("bytes left to output")


def _e8_transform(data: bytearray, offset: int, filesize: int) -> bytearray:
    """Undo the E8 call-instruction translation on one frame.

    Scalar reference version; the vectorized pass is ops.e8.
    """
    out = bytearray(data)
    end = len(out) - 10
    pos = 0
    curpos = offset
    while pos < end:
        if out[pos] != 0xE8:
            pos += 1
            curpos += 1
            continue
        pos += 1
        abs_off = int.from_bytes(out[pos : pos + 4], "little", signed=True)
        if -curpos <= abs_off < filesize:
            rel_off = abs_off - curpos if abs_off >= 0 else abs_off + filesize
            out[pos : pos + 4] = (rel_off & 0xFFFFFFFF).to_bytes(4, "little")
        pos += 4
        curpos += 5
    return out
