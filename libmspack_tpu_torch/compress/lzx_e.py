"""LZX entropy encoder — VERBATIM / ALIGNED / UNCOMPRESSED blocks.

The reference ships no LZX compressor (reference: lzxc.c:18 is a stub);
this is a from-scratch encoder built against the format semantics our
decoder (codecs/lzx.py, reference lzxd.c) pins down:

* MSB-first bitstream of 16-bit little-endian units; 32 KiB output
  frames with a 16-bit realign at every frame end (lzxd.c:694-697);
* one block per frame: 3-bit type + 24-bit length, then for ALIGNED the
  8x3-bit aligned-offset tree, then main/length trees delta-coded
  against the previous block's lengths via a 20-symbol pretree with run
  codes 17/18/19 (lzxd.c:138-183);
* matches: main element 256 + (position_slot << 3) + min(len-2, 7),
  secondary LENGTH symbol for len >= 9, position slot + verbatim extra
  bits (low 3 via the aligned tree in ALIGNED blocks), R0/R1/R2
  repeated-offset LRU (lzxd.c:565-585);
* reset intervals re-initialise R0-R2 and all tree state every N frames
  (the CHM ResetTable / random-access grid) — matches never cross a
  reset boundary so every reset point stays independently decodable;
* LZX DELTA: 16-bit chunk-size field before each frame, reference data
  addressable beyond the stream start (offset > pos reads the window
  tail, lzxd.c:622-628), match lengths up to 33024 via the escape after
  length 257 (lzxd.c:588-611).

Huffman code lengths are optimal length-limited (package-merge); all
trees are emitted Kraft-complete because the decoder's
make_decode_table rejects under-subscribed tables (readhuff.h:83-176),
padding a partner symbol when only one symbol is in use.

The native C++ port of this encoder is msp_lzx_encode (native/
msp_native.cpp); it follows the same algorithm so the bitstreams agree.

Copied from ``libmspack_tpu/compress/lzx_e.py`` so that the port imports nothing
of the JAX package; the copy differs in nothing else.
"""
from __future__ import annotations

from bisect import bisect_right

from ..codecs.lzx import (EXTRA_BITS, FRAME_SIZE, POSITION_BASE,
                          POSITION_SLOTS)
from .lzx_c import LzxBitWriter

MIN_MATCH = 2
MAX_MATCH = 257          # non-delta cap; delta escapes extend to 33024
MAX_MATCH_DELTA = 257 + 32767
NUM_CHARS = 256
NUM_PRIMARY = 7
NUM_SECONDARY = 249
PRETREE_LEN_LIMIT = 15   # pretree lengths are stored in 4 bits
TREE_LEN_LIMIT = 16      # delta codes are mod-17 -> lengths 0..16
ALIGNED_LEN_LIMIT = 7    # aligned lengths are stored in 3 bits


# ----------------------------------------------------------------------
# Huffman construction


def make_lengths(freqs: list[int], limit: int) -> list[int]:
    """Optimal length-limited code lengths (package-merge), always
    Kraft-complete: a lone used symbol gets a dummy partner so the
    decoder's table builder accepts the tree."""
    n = len(freqs)
    used = [i for i in range(n) if freqs[i] > 0]
    lens = [0] * n
    if not used:
        return lens
    if len(used) == 1:
        lens[used[0]] = 1
        partner = used[0] + 1 if used[0] + 1 < n else used[0] - 1
        lens[partner] = 1
        return lens
    if len(used) > (1 << limit):
        raise ValueError("alphabet cannot fit the length limit")

    # package-merge: coins[level] sorted by weight; merge pairwise
    items = sorted((freqs[s], s) for s in used)
    packages: list[tuple[int, tuple]] = [(w, (s,)) for w, s in items]
    solution: list[tuple] = []
    # we need (len(used) - 1) * 2 coins from the final level
    level_list = packages
    for _ in range(limit - 1):
        merged = []
        for i in range(0, len(level_list) - 1, 2):
            w = level_list[i][0] + level_list[i + 1][0]
            syms = level_list[i][1] + level_list[i + 1][1]
            merged.append((w, syms))
        level_list = sorted(packages + merged)
    take = 2 * (len(used) - 1)
    for w, syms in level_list[:take]:
        solution.append(syms)
    for syms in solution:
        for s in syms:
            lens[s] += 1
    return lens


def canonical_codes(lens: list[int]) -> list[int]:
    """Canonical MSB-first codes matching make_decode_table's
    (length asc, symbol asc) assignment (readhuff.h:83-176)."""
    max_len = max(lens) if lens else 0
    bl_count = [0] * (max_len + 1)
    for l in lens:
        if l:
            bl_count[l] += 1
    code = 0
    next_code = [0] * (max_len + 2)
    for l in range(1, max_len + 1):
        code = (code + bl_count[l - 1]) << 1
        next_code[l] = code
    codes = [0] * len(lens)
    for sym in range(len(lens)):
        l = lens[sym]
        if l:
            codes[sym] = next_code[l]
            next_code[l] += 1
    return codes


# ----------------------------------------------------------------------
# Tree-length (pretree) emission


def _len_ops(prev: list[int], new: list[int], first: int, last: int):
    """The run/delta op stream _read_lens consumes (lzxd.c:138-183).
    Yields (pretree_symbol, extra_value, extra_bits) triples; code 19 is
    followed by a second pretree symbol carried in extra_value with
    extra_bits == -1 as a marker."""
    ops = []
    x = first
    while x < last:
        v = new[x]
        run = 1
        while x + run < last and new[x + run] == v:
            run += 1
        if v == 0:
            while run >= 20:
                t = min(run, 51)
                ops.append((18, t - 20, 5))
                run -= t
                x += t
            while run >= 4:
                t = min(run, 19)
                ops.append((17, t - 4, 4))
                run -= t
                x += t
        while run >= 4:
            if run == 8:
                t = 4
            elif run >= 5:
                t = 5
            else:
                t = 4
            z = (prev[x] - v) % 17
            ops.append((19, t - 4, 1))
            ops.append((z, 0, -1))
            run -= t
            x += t
        while run > 0:
            ops.append(((prev[x] - v) % 17, 0, 0))
            run -= 1
            x += 1
    return ops


def write_lens(w: LzxBitWriter, prev: list[int], new: list[int],
               first: int, last: int) -> None:
    ops = _len_ops(prev, new, first, last)
    freqs = [0] * 20
    for sym, _, _ in ops:
        freqs[sym] += 1
    plens = make_lengths(freqs, PRETREE_LEN_LIMIT)
    pcodes = canonical_codes(plens)
    for i in range(20):
        w.write_bits(plens[i], 4)
    for sym, extra, ebits in ops:
        w.write_bits(pcodes[sym], plens[sym])
        if ebits > 0:
            w.write_bits(extra, ebits)


def lens_cost(prev: list[int], new: list[int], first: int, last: int) -> int:
    """Bit cost of write_lens without emitting."""
    ops = _len_ops(prev, new, first, last)
    freqs = [0] * 20
    extra = 0
    for sym, _, ebits in ops:
        freqs[sym] += 1
        if ebits > 0:
            extra += ebits
    plens = make_lengths(freqs, PRETREE_LEN_LIMIT)
    return 80 + sum(plens[s] * f for s, f in enumerate(freqs)) + extra


# ----------------------------------------------------------------------
# Match finding

_HASH_SHIFT = 6
_HASH_MASK = (1 << 17) - 1


def _hash3(a: int, b: int, c: int) -> int:
    return ((a << (2 * _HASH_SHIFT)) ^ (b << _HASH_SHIFT) ^ c) & _HASH_MASK


class _Matcher:
    """Greedy hash-chain matcher over (ref_data + data)."""

    def __init__(self, buf: bytes, max_chain: int = 64):
        self.buf = buf
        self.max_chain = max_chain
        self.head: dict[int, int] = {}
        self.prev: list[int] = [0] * len(buf)

    def insert(self, pos: int) -> None:
        buf = self.buf
        if pos + 2 >= len(buf):
            return
        h = _hash3(buf[pos], buf[pos + 1], buf[pos + 2])
        self.prev[pos] = self.head.get(h, -1)
        self.head[h] = pos

    def longest(self, pos: int, limit: int, max_dist, max_len: int):
        """Best (length, distance) with length >= 3, or (0, 0).
        max_dist may be an int or a predicate taking the distance."""
        buf = self.buf
        if pos + 2 >= limit:
            return 0, 0
        h = _hash3(buf[pos], buf[pos + 1], buf[pos + 2])
        cand = self.head.get(h, -1)
        best_len, best_dist = 0, 0
        chain = self.max_chain
        cap = min(max_len, limit - pos)
        while cand >= 0 and chain > 0:
            dist = pos - cand
            ok = max_dist(dist) if callable(max_dist) else dist <= max_dist
            if not ok:
                break
            chain -= 1
            if buf[cand + best_len] == buf[pos + best_len] if best_len < cap else False:
                l = 0
                while l < cap and buf[cand + l] == buf[pos + l]:
                    l += 1
                if l > best_len:
                    best_len, best_dist = l, dist
                    if l >= cap:
                        break
            elif best_len == 0:
                l = 0
                while l < cap and buf[cand + l] == buf[pos + l]:
                    l += 1
                if l >= 3:
                    best_len, best_dist = l, dist
                    if l >= cap:
                        break
            cand = self.prev[cand]
        if best_len < 3:
            return 0, 0
        return best_len, best_dist


def _match_len(buf: bytes, a: int, b: int, cap: int) -> int:
    l = 0
    while l < cap and buf[a + l] == buf[b + l]:
        l += 1
    return l


# ----------------------------------------------------------------------
# Tokens: (0, byte) literal | (1, length, slot012) rep | (2, length, dist)


def _slot_for(formatted: int, num_slots: int) -> int:
    s = bisect_right(POSITION_BASE, formatted, 0, num_slots) - 1
    return s


class LzxEncoder:
    """One LZX stream (CAB folder / CHM section / OAB block)."""

    def __init__(self, window_bits: int, reset_interval: int = 0,
                 is_delta: bool = False, max_chain: int = 64,
                 block_frames: int = 32, intel_filesize: int = 0):
        lo, hi = (17, 25) if is_delta else (15, 21)
        if not (lo <= window_bits <= hi):
            raise ValueError("bad LZX window bits")
        self.block_frames = max(1, block_frames)
        self.window_bits = window_bits
        self.window_size = 1 << window_bits
        self.reset_interval = reset_interval
        self.is_delta = is_delta
        # nonzero: write the intel E8 header (lzxd.c:446-452 bit=1 +
        # 32-bit filesize). NOTE: the encoder does NOT apply the forward
        # E8 transform — decoders will "untransform" raw data, which is
        # exactly what E8 decode-parity tests need (every engine must
        # garble identically, pinned by the reference oracle).
        self.intel_filesize = intel_filesize
        self.max_chain = max_chain
        self.num_slots = POSITION_SLOTS[window_bits - 15]
        self.num_offsets = self.num_slots << 3
        self.max_formatted = POSITION_BASE[self.num_slots - 1] + \
            (1 << EXTRA_BITS[self.num_slots - 1]) - 1

    # -- token generation ------------------------------------------------

    def _dist_ok(self, dist: int, pos_buf: int, origin: int) -> bool:
        """Is a match at this distance decodable at any pull granularity?

        Beyond the in-window distance (pos % window), the decoder only
        accepts offsets covered by DELTA reference data or already
        handed-out output (lzxd.c:622-628); the handed-out counter can
        lag the decode position by up to two frames, hence the 65536
        safety margin on wrapped in-stream sources."""
        pos_data = pos_buf - origin
        wp = pos_data % self.window_size
        if dist <= wp:
            return True
        if origin:
            # reference data sits at the window tail; OAB sizes the
            # window to hold ref+data so it is never overwritten
            return dist <= wp + origin
        return dist <= pos_data - 65536

    def _tokenize_frame(self, buf: bytes, matcher: _Matcher, pos: int,
                        frame_end: int, chunk_start: int, origin: int,
                        R: list[int]):
        """Greedy tokens for buf[pos:frame_end]; chunk_start is the reset
        boundary in buf coordinates (matches must not reach before it,
        except into DELTA reference data at buf[:origin])."""
        tokens = []
        max_match = MAX_MATCH_DELTA if self.is_delta else MAX_MATCH
        wlimit = self.window_size - 2
        max_fmt = self.max_formatted
        while pos < frame_end:
            cap = min(max_match, frame_end - pos)
            # repeated offsets first: cheap to encode
            best_rep_len, best_rep = 0, -1
            for ri in range(3):
                d = R[ri]
                if (d <= pos - chunk_start and d <= wlimit
                        and self._dist_ok(d, pos, origin)):
                    l = _match_len(buf, pos - d, pos, cap)
                    if l > best_rep_len:
                        best_rep_len, best_rep = l, ri
            l, d = matcher.longest(
                pos, frame_end,
                lambda dist: dist <= pos - chunk_start and dist <= wlimit
                and dist + 2 <= max_fmt and self._dist_ok(dist, pos, origin),
                cap)
            if best_rep_len >= 2 and best_rep_len + 1 >= l:
                length = best_rep_len
                tokens.append((1, length, best_rep))
                if best_rep == 1:
                    R[0], R[1] = R[1], R[0]
                elif best_rep == 2:
                    R[0], R[2] = R[2], R[0]
                for p in range(pos, pos + length):
                    matcher.insert(p)
                pos += length
            elif l >= 3 and (l >= 4 or d < 4096):
                tokens.append((2, l, d))
                R[2] = R[1]
                R[1] = R[0]
                R[0] = d
                for p in range(pos, pos + l):
                    matcher.insert(p)
                pos += l
            else:
                tokens.append((0, buf[pos]))
                matcher.insert(pos)
                pos += 1
        return tokens

    # -- block emission ---------------------------------------------------

    def _freqs(self, tokens):
        fmain = [0] * (NUM_CHARS + self.num_offsets)
        flen = [0] * NUM_SECONDARY
        falign = [0] * 8
        verb_extra = 0
        align_extra = 0
        for t in tokens:
            if t[0] == 0:
                fmain[t[1]] += 1
                continue
            length = t[1]
            if t[0] == 1:
                slot = t[2]
            else:
                fmt = t[2] + 2
                slot = _slot_for(fmt, self.num_slots)
                extra = EXTRA_BITS[slot]
                if extra >= 3:
                    falign[(fmt - POSITION_BASE[slot]) & 7] += 1
                    align_extra += extra - 3
                else:
                    align_extra += extra
                verb_extra += extra
            lh = min(length - MIN_MATCH, NUM_PRIMARY)
            fmain[NUM_CHARS + (slot << 3) + lh] += 1
            if lh == NUM_PRIMARY:
                sec = min(length - MIN_MATCH - NUM_PRIMARY, NUM_SECONDARY - 1)
                flen[sec] += 1
            if self.is_delta and length >= MAX_MATCH:
                ex = length - MAX_MATCH
                eb = 9 if ex < 0x100 else 12 if ex < 0x500 else \
                    15 if ex < 0x1500 else 18
                verb_extra += eb
                align_extra += eb
        return fmain, flen, falign, verb_extra, align_extra

    def _emit_block_group(self, w: LzxBitWriter, frames, prev_main,
                          prev_len, R_before: list[int],
                          more_blocks: bool, offsets: list[int],
                          first_of_chunk: bool) -> bool:
        """Emit ONE block covering `frames` (list of (tokens, data)
        tuples, one per 32 KiB output frame — trees amortise across the
        whole block). Per-frame obligations (offsets list, DELTA chunk
        fields, 16-bit realign at frame ends) are handled here. Returns
        True if an UNCOMPRESSED block was chosen (caller restores R)."""
        all_tokens = [t for toks, _ in frames for t in toks]
        block_len = sum(len(d) for _, d in frames)
        fmain, flen, falign, verb_extra, align_extra = self._freqs(all_tokens)
        mlens = make_lengths(fmain, TREE_LEN_LIMIT)
        llens = make_lengths(flen, TREE_LEN_LIMIT)

        body = sum(mlens[s] * f for s, f in enumerate(fmain) if f)
        body += sum(llens[s] * f for s, f in enumerate(flen) if f)
        tree_cost = (lens_cost(prev_main, mlens, 0, 256)
                     + lens_cost(prev_main, mlens, 256,
                                 NUM_CHARS + self.num_offsets)
                     + lens_cost(prev_len, llens, 0, NUM_SECONDARY))
        alens = make_lengths(falign, ALIGNED_LEN_LIMIT)
        if not any(alens):
            alens = [3] * 8  # decoder builds the tree unconditionally
        acost = sum(alens[s] * f for s, f in enumerate(falign) if f)
        verb_bits = 3 + 24 + tree_cost + body + verb_extra
        alig_bits = 3 + 24 + 24 + tree_cost + body + align_extra + acost
        unc_bits = 3 + 24 + 16 + 8 * (12 + block_len + (block_len & 1))
        stored = unc_bits < min(verb_bits, alig_bits)

        def frame_prologue(idx: int):
            """offset bookkeeping + DELTA chunk field + intel bit."""
            offsets.append(len(w.out))
            patch = None
            if self.is_delta:
                assert w.bit_aligned
                patch = len(w.out)
                w.write_bits(0, 16)
            if idx == 0 and first_of_chunk:
                if self.intel_filesize:
                    w.write_bits(1, 1)
                    w.write_bits((self.intel_filesize >> 16) & 0xFFFF, 16)
                    w.write_bits(self.intel_filesize & 0xFFFF, 16)
                else:
                    w.write_bits(0, 1)  # no intel E8 filesize
            return patch

        def frame_epilogue(patch):
            if not w.bit_aligned:
                w.align16()
            if patch is not None:
                chunk = len(w.out) - patch - 2
                w.out[patch:patch + 2] = chunk.to_bytes(2, "little")

        if stored:
            patch = frame_prologue(0)
            w.write_bits(3, 3)
            w.write_bits(block_len, 24)
            w.align16()
            for r in R_before:
                w.write_bytes(r.to_bytes(4, "little"))
            w.write_bytes(frames[0][1])
            frame_epilogue(patch)
            for toks, d in frames[1:]:
                patch = frame_prologue(-1)
                w.write_bytes(d)
                frame_epilogue(patch)
            if (block_len & 1) and more_blocks:
                w.write_bytes(b"\x00")
            return True

        aligned = alig_bits < verb_bits
        acodes = canonical_codes(alens)
        mcodes = canonical_codes(mlens)
        lcodes = canonical_codes(llens)
        first = True
        for toks, _ in frames:
            patch = frame_prologue(0 if first else -1)
            if first:
                w.write_bits(2 if aligned else 1, 3)
                w.write_bits(block_len, 24)
                if aligned:
                    for i in range(8):
                        w.write_bits(alens[i], 3)
                write_lens(w, prev_main, mlens, 0, 256)
                write_lens(w, prev_main, mlens, 256,
                           NUM_CHARS + self.num_offsets)
                write_lens(w, prev_len, llens, 0, NUM_SECONDARY)
                prev_main[:] = mlens
                prev_len[:] = llens
                first = False
            self._emit_tokens(w, toks, aligned, mcodes, mlens, lcodes,
                              llens, acodes, alens)
            frame_epilogue(patch)
        if len(w.out) & 1:
            w.write_bytes(b"\x00")
        return False

    def _emit_tokens(self, w, tokens, aligned, mcodes, mlens, lcodes,
                     llens, acodes, alens) -> None:
        for t in tokens:
            if t[0] == 0:
                w.write_bits(mcodes[t[1]], mlens[t[1]])
                continue
            length = t[1]
            enc_len = min(length, MAX_MATCH)
            lh = min(enc_len - MIN_MATCH, NUM_PRIMARY)
            if t[0] == 1:
                slot = t[2]
                extra = 0
                fmt = 0
            else:
                fmt = t[2] + 2
                slot = _slot_for(fmt, self.num_slots)
                extra = EXTRA_BITS[slot]
            sym = NUM_CHARS + (slot << 3) + lh
            w.write_bits(mcodes[sym], mlens[sym])
            if lh == NUM_PRIMARY:
                sec = enc_len - MIN_MATCH - NUM_PRIMARY
                w.write_bits(lcodes[sec], llens[sec])
            if t[0] == 2:
                val = fmt - POSITION_BASE[slot]
                if extra >= 3 and aligned:
                    if extra > 3:
                        w.write_bits(val >> 3, extra - 3)
                    w.write_bits(acodes[val & 7], alens[val & 7])
                elif extra:
                    w.write_bits(val, extra)
            if self.is_delta and length >= MAX_MATCH:
                ex = length - MAX_MATCH
                if ex < 0x100:
                    w.write_bits(0, 1)
                    w.write_bits(ex, 8)
                elif ex < 0x100 + 0x400:
                    w.write_bits(2, 2)
                    w.write_bits(ex - 0x100, 10)
                elif ex < 0x500 + 0x1000:
                    w.write_bits(6, 3)
                    w.write_bits(ex - 0x500, 12)
                else:
                    w.write_bits(7, 3)
                    w.write_bits(ex, 15)

    # -- stream -----------------------------------------------------------

    def compress(self, data: bytes,
                 ref_data: bytes = b"") -> tuple[bytes, list[int]]:
        """Encode data; returns (stream, per-frame byte offsets).

        ref_data (DELTA only) is addressable before the stream start
        exactly as lzxd preloads it at the window tail. Frames group
        into multi-frame blocks (up to block_frames, never across a
        reset boundary) so tree overhead amortises."""
        if ref_data and not self.is_delta:
            raise ValueError("reference data needs a DELTA stream")
        origin = len(ref_data)
        buf = ref_data + data
        matcher = _Matcher(buf, self.max_chain)
        for p in range(origin):
            matcher.insert(p)

        w = LzxBitWriter()
        offsets: list[int] = []
        nframes = max(1, (len(data) + FRAME_SIZE - 1) // FRAME_SIZE)
        prev_main = [0] * (NUM_CHARS + self.num_offsets)
        prev_len = [0] * NUM_SECONDARY
        R = [1, 1, 1]

        if not data:
            # zero-length stream: single empty uncompressed block
            if self.is_delta:
                w.write_bits(0, 16)
            offsets.append(0)
            w.write_bits(0, 1)
            w.write_bits(3, 3)
            w.write_bits(0, 24)
            w.align16()
            for r in R:
                w.write_bytes(r.to_bytes(4, "little"))
            return bytes(w.out), offsets

        ri = self.reset_interval
        i = 0
        while i < nframes:
            chunk_start_frame = i if (i == 0 or (ri and i % ri == 0)) else None
            # i always lands on a chunk start or block boundary; compute
            # the chunk this block belongs to
            if i == 0 or (ri and i % ri == 0):
                prev_main = [0] * (NUM_CHARS + self.num_offsets)
                prev_len = [0] * NUM_SECONDARY
                R = [1, 1, 1]
                chunk_start = i * FRAME_SIZE
                first_of_chunk = True
            # frames in this block: up to block_frames, not past the
            # chunk end or the stream end
            if ri:
                chunk_end = min(nframes, (i // ri + 1) * ri)
            else:
                chunk_end = nframes
            bend = min(i + self.block_frames, chunk_end)

            R_snapshot = list(R)
            cstart = origin + chunk_start if chunk_start else 0
            frames = []
            for k in range(i, bend):
                fstart = k * FRAME_SIZE
                fend = min(fstart + FRAME_SIZE, len(data))
                toks = self._tokenize_frame(
                    buf, matcher, origin + fstart, origin + fend, cstart,
                    origin, R)
                frames.append((toks, data[fstart:fend]))
            stored = self._emit_block_group(
                w, frames, prev_main, prev_len, R_snapshot,
                bend < nframes, offsets, first_of_chunk)
            if stored:
                R = R_snapshot
            first_of_chunk = False
            i = bend
        return bytes(w.out), offsets


def compress(data: bytes, window_bits: int, reset_interval: int = 0,
             is_delta: bool = False, ref_data: bytes = b"",
             max_chain: int = 64, block_frames: int = 32,
             engine: str = "auto") -> tuple[bytes, list[int]]:
    """Encode one LZX stream. engine: "auto" prefers the native C++
    encoder (msp_lzx_encode, ~50x faster, same algorithm), "python"
    forces this module's reference implementation."""
    if engine == "auto":
        try:
            from .. import native
            r = native.lzx_encode(data, window_bits, reset_interval,
                                  is_delta, ref_data, max_chain,
                                  block_frames)
            if r is not None:
                return r
        except Exception:
            pass
    return LzxEncoder(window_bits, reset_interval, is_delta, max_chain,
                      block_frames).compress(data, ref_data=ref_data)
