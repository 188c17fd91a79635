"""K3: LZX phase A — one token trace per stream, with resumable state.

PyTorch counterpart of ``libmspack_tpu/ops/pallas_lzx.py``. A batch is an
``(L, nbytes)`` uint8 tensor of independent LZX streams (a CAB folder, a
CHM reset-interval chunk, an OAB DELTA block), their byte lengths, their
target output positions and their history budgets (DELTA reference bytes
before the stream; 0 otherwise). ``lzx_phase_a`` returns, on the streams'
device:

* ``tok``, ``litw``: int32 ``(L, tcap)``, lane-major, each lane's tokens of
  this call compacted from column 0 in the TPU kernel's format
  (``pallas_lzx.py:39-45``). Columns past the lane's count are undefined
  on the GPU and NOP (-1) on the CPU.
* ``cnt``: int32 ``(8, L)``. Row 0 err (0 ok, 1 bad data, 2 token cap),
  row 1 output position reached, row 2 tokens written by this call, row 3
  input bytes consumed, row 4 ``intel_started``, row 5 ``intel_filesize``,
  row 6 how a row given ``frame_sizes`` decoded (0 serially, not split;
  ``SPLIT_DONE`` a warp per frame; else the ``SPLIT_*`` bits of why its
  split failed and it decoded serially in the same call), row 7 zero.
  Rows 0, 1, 4 and 5 mean what the TPU kernel's do. Row 3 is this port's
  own cursor (bytes, from the stream's start), not the TPU kernel's
  32-bit refill cursor. A split row's row 2 may count one literal token
  more a frame edge than the serial decode's: a run of literals is cut
  there.
* with ``return_state=True`` or a ``state`` passed in, also ``state``:
  uint8 ``(L, STATE_BYTES)``, each lane's whole decoder state
  (``STATE_DTYPE``, the ``lz::State`` record of ``csrc/lzx_core.cuh``).
  The decoder updates the record in place; passing it back with the same
  streams resumes every lane where it stopped. Targets other than a
  stream's total length must be multiples of 32 KiB.

``tcap`` bounds the tokens per lane and call. Every token carries at least
one output byte, so ``tcap`` = the bytes a call decodes is always enough.

A CUDA tensor runs the hand-written kernel (``csrc/lzx.cu``, one warp per
stream, or per 32 KiB frame for rows given ``frame_sizes``, rows copied to
4-byte alignment first where they are not); a CPU
tensor runs ``lzx_phase_a_plain``, a straightforward Python decoder of the same
format, counts and state record. ``LAUNCHES`` counts both. Inside
``shadow.active()`` a launch on a card also runs the plain version on CPU
copies of its inputs and keeps the difference (``ops/shadow.py``).
"""
from __future__ import annotations

import numpy as np
import torch

from .. import kernels
from .._device import resolve_device
from . import shadow
from .cuda_inflate import pack_streams

TOK_NOP = -1
TOK_LIT = 0x20000000
TOK_MATCH = 0x40000000
TOK_REP = 0x10000000    # a frame lane's symbolic repeat match (join only)

FRAME = 32768
NPRE = 20
NLEN = 250
NALN = 8
SAFETY = 64
POSITION_SLOTS = (30, 32, 34, 36, 38, 42, 50, 66, 98, 162, 290)
MAIN_MAX = 256 + (POSITION_SLOTS[-1] << 3)

# the lz::State record of csrc/lzx_core.cuh, field for field
STATE_DTYPE = np.dtype([
    ("bitpos", "<i8"), ("outpos", "<i8"),
    ("r0", "<u4"), ("r1", "<u4"), ("r2", "<u4"),
    ("block_type", "<i4"), ("block_remaining", "<i4"),
    ("block_length", "<i4"), ("header_read", "<i4"),
    ("intel_started", "<i4"), ("intel_filesize", "<i4"),
    ("length_empty", "<i4"), ("err", "<i4"), ("rtag", "<i4"),
    ("main_count", "<u2", (17,)), ("len_count", "<u2", (17,)),
    ("aln_count", "<u2", (17,)),
    ("main_sym", "<u2", (MAIN_MAX,)), ("len_sym", "<u2", (NLEN,)),
    ("aln_sym", "<u2", (NALN,)),
    ("main_lens", "u1", (MAIN_MAX + SAFETY,)),
    ("len_lens", "u1", (NLEN + SAFETY,)), ("aln_lens", "u1", (NALN,)),
], align=True)
STATE_BYTES = STATE_DTYPE.itemsize
_SCALARS = ("bitpos", "outpos", "r0", "r1", "r2", "rtag", "block_type",
            "block_remaining", "block_length", "header_read",
            "intel_started", "intel_filesize", "length_empty", "err")
# lz::FrameEnd: a frame lane's end scalars and token count
FRAME_END_DTYPE = np.dtype([
    ("bitpos", "<i8"), ("outpos", "<i8"),
    ("r0", "<u4"), ("r1", "<u4"), ("r2", "<u4"), ("rtag", "<u4"),
    ("block_type", "<i4"), ("block_remaining", "<i4"),
    ("block_length", "<i4"), ("header_read", "<i4"),
    ("intel_started", "<i4"), ("intel_filesize", "<i4"),
    ("length_empty", "<i4"), ("err", "<i4"), ("ntok", "<i4"),
    ("pad", "<i4")], align=True)
# the seam: what a frame's end and the next frame's seed must agree on
_SEAM = ("bitpos", "outpos", "block_type", "block_remaining",
         "block_length", "header_read", "intel_started", "intel_filesize",
         "length_empty")
# counts row 6 of a split stream: SPLIT_DONE, or the bits of why its split
# failed and it decoded serially (lzx_core.cuh)
SPLIT_DONE, SPLIT_SEED, SPLIT_FRAME, SPLIT_SEAM, SPLIT_CHECK, SPLIT_CAP = (
    1, 2, 4, 8, 16, 32)
# each bit's name: the header walk failed (a block count other than the
# frame count among its causes), a frame lane flagged or stopped short, a
# seam disagrees, a symbolic offset failed its checks, the token cap
SPLIT_REASONS = {SPLIT_SEED: "seed", SPLIT_FRAME: "frame",
                 SPLIT_SEAM: "seam", SPLIT_CHECK: "check", SPLIT_CAP: "cap"}
# The fewest CFDATA blocks a stream splits at: below it one warp decodes
# the stream faster than the split's three extra passes (measured on the
# card, PERF.md).
MIN_SPLIT_FRAMES = 2

LAUNCHES = {"cuda": 0, "plain": 0}

__all__ = ["lzx_phase_a", "lzx_phase_a_plain", "pack_streams",
           "from_jax_batch", "word_aligned", "LAUNCHES", "STATE_BYTES",
           "STATE_DTYPE"]


def from_jax_batch(stream_grid):
    """``pallas_lzx.pack_streams``'s ``(W, SL, LN)`` uint32 word grid ->
    ``(streams, lens)`` for all ``SL * LN`` lanes; each lane's length is
    the whole padded row, which decodes the same since both read zeros
    past a stream's end."""
    g = np.asarray(stream_grid, np.uint32)
    words = g.reshape(g.shape[0], -1).T.astype("<u4")
    streams = np.ascontiguousarray(words).view(np.uint8)
    lens = np.full(streams.shape[0], streams.shape[1], np.int32)
    return torch.from_numpy(streams.copy()), torch.from_numpy(lens)


def word_aligned(streams):
    """``streams`` with every row on a 4-byte boundary, as the bit readers
    of K3 and K4 load 32-bit words: the tensor itself when its rows are,
    else a copy with each row padded to a multiple of 4 bytes."""
    if streams.data_ptr() % 4 == 0 and streams.stride(0) % 4 == 0:
        return streams
    L, width = streams.shape
    out = torch.zeros((L, (width + 3) & ~3), dtype=torch.uint8,
                      device=streams.device)
    out[:, :width] = streams
    return out


def _check_batch(streams, lens, out_lens, hists, window_bits, is_delta,
                 state):
    if streams.dtype != torch.uint8 or streams.dim() != 2:
        raise ValueError("streams must be a 2-D uint8 tensor")
    if streams.stride(1) != 1:
        raise ValueError("streams rows must be contiguous")
    L = streams.shape[0]
    for name, t in (("lens", lens), ("out_lens", out_lens),
                    ("hists", hists)):
        if t.dtype != torch.int32 or t.shape != (L,) or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous int32 ({L},)")
        if t.device != streams.device:
            raise ValueError(f"{name} is on {t.device}, streams on "
                             f"{streams.device}")
    lo, hi = (17, 25) if is_delta else (15, 21)
    if not lo <= window_bits <= hi:
        raise ValueError(f"window_bits {window_bits} outside {lo}..{hi}")
    if state is not None and (state.dtype != torch.uint8
                              or state.shape != (L, STATE_BYTES)
                              or not state.is_contiguous()
                              or state.device != streams.device):
        raise ValueError(f"state must be a contiguous uint8 "
                         f"({L}, {STATE_BYTES}) on {streams.device}")
    if L and streams.device.type == "cpu" and int(lens.max()) > \
            streams.shape[1]:
        raise ValueError("a stream length exceeds the row width")


def lzx_phase_a(streams, lens, out_lens, hists, window_bits, *,
                is_delta=False, tcap, state=None, return_state=False,
                device=None, frame_sizes=None):
    """Phase A on a batch (see the module docstring). ``device`` moves the
    batch there first; by default it runs where ``streams`` lies. A CUDA
    tensor launches K3 or raises. ``frame_sizes``: per row None or its
    CFDATA payload lengths; such a row of a fresh, non-DELTA call with no
    state asked for decodes a warp per frame (``split_rows``)."""
    if device is not None:
        dev = resolve_device(device)
        streams, lens, out_lens, hists = (
            t.to(dev) for t in (streams, lens, out_lens, hists))
        if state is not None:
            state = state.to(dev)
    _check_batch(streams, lens, out_lens, hists, window_bits, is_delta,
                 state)
    want_state = return_state or state is not None
    if want_state:
        frame_sizes = None
    if streams.device.type == "cpu":
        LAUNCHES["plain"] += 1
        out = lzx_phase_a_plain(streams, lens, out_lens, hists, window_bits,
                                is_delta=is_delta, tcap=tcap, state=state,
                                frame_sizes=frame_sizes)
        return out if want_state else out[:3]
    if streams.device.type != "cuda":
        raise ValueError(f"unsupported device {streams.device}")
    host = shadow.inputs(streams, lens, out_lens, hists, state)
    L = streams.shape[0]
    dev = streams.device
    streams = word_aligned(streams)
    lib = kernels.lib()
    if lib.msp_k3_state_bytes() != STATE_BYTES:
        raise RuntimeError("lz::State and STATE_DTYPE differ in size")
    fresh = state is None
    if fresh:
        state = torch.empty((L, STATE_BYTES), dtype=torch.uint8, device=dev)
    tok = torch.empty((L, tcap), dtype=torch.int32, device=dev)
    litw = torch.empty((L, tcap), dtype=torch.int32, device=dev)
    cnt = torch.empty((8, L), dtype=torch.int32, device=dev)
    split = split_rows(frame_sizes, L, is_delta, fresh)
    with torch.cuda.device(dev):
        if split:
            rc = _launch_split(lib, streams, lens, out_lens, hists, L,
                               window_bits, state, tok, litw, tcap, cnt,
                               split)
        else:
            rc = lib.msp_k3_lzx(
                streams.data_ptr(), streams.stride(0), lens.data_ptr(),
                out_lens.data_ptr(), hists.data_ptr(), L, window_bits,
                int(bool(is_delta)), int(fresh), state.data_ptr(),
                tok.data_ptr(), litw.data_ptr(), tcap, cnt.data_ptr(),
                torch.cuda.current_stream().cuda_stream)
    kernels.check(rc, "K3 lzx")
    LAUNCHES["cuda"] += 1
    if host is not None:
        shadow.record("k3_lzx", (tok, litw, cnt, state), lzx_phase_a_plain(
            *host[:4], window_bits, is_delta=is_delta, tcap=tcap,
            state=host[4], frame_sizes=frame_sizes))
    return (tok, litw, cnt, state) if want_state else (tok, litw, cnt)


def split_meta(split, L):
    """``lz::make_split``'s int32 table of the split rows: (meta, S, F)."""
    rows = sorted(split)
    nfs = [len(split[i]) for i in rows]
    first = np.concatenate([[0], np.cumsum(nfs)]).astype(np.int64)
    F = int(first[-1])
    fstream = np.repeat(np.arange(len(rows)), nfs)
    fstart = np.concatenate([split[i] for i in rows])
    if fstart.max(initial=0) >= 1 << 31:
        raise ValueError("a CFDATA start beyond 2^31 bytes")
    split_of = np.full(L, -1, np.int64)
    split_of[rows] = np.arange(len(rows))
    meta = np.concatenate([rows, first, fstream, fstart, split_of])
    return meta.astype(np.int32), len(rows), F


def _launch_split(lib, streams, lens, out_lens, hists, L, window_bits,
                  state, tok, litw, tcap, cnt, split):
    """K3's split launch sequence (``csrc/lzx.cu:msp_k3_lzx_split``); its
    scratch (a seed record and a FRAME-token row a frame) is freed to the
    allocator in stream order."""
    if lib.msp_k3_frame_end_bytes() != FRAME_END_DTYPE.itemsize:
        raise RuntimeError("lz::FrameEnd and FRAME_END_DTYPE differ in size")
    meta, S, F = split_meta(split, L)
    dev = streams.device
    meta = torch.from_numpy(meta).to(dev)
    seeds = torch.empty((F, STATE_BYTES), dtype=torch.uint8, device=dev)
    ends = torch.empty((F, FRAME_END_DTYPE.itemsize), dtype=torch.uint8,
                       device=dev)
    ftok = torch.empty((F, FRAME), dtype=torch.int32, device=dev)
    flitw = torch.empty((F, FRAME), dtype=torch.int32, device=dev)
    flags = torch.empty(S, dtype=torch.int32, device=dev)
    return lib.msp_k3_lzx_split(
        streams.data_ptr(), streams.stride(0), lens.data_ptr(),
        out_lens.data_ptr(), hists.data_ptr(), L, window_bits,
        state.data_ptr(), tok.data_ptr(), litw.data_ptr(), tcap,
        cnt.data_ptr(), meta.data_ptr(), S, F, seeds.data_ptr(),
        ends.data_ptr(), ftok.data_ptr(), flitw.data_ptr(), flags.data_ptr(),
        torch.cuda.current_stream().cuda_stream)


# ---------------------------------------------------------------- plain --

class _DataError(Exception):
    pass


class _TokenCap(Exception):
    pass


def _build(lens, n):
    """(count, sym, left) of the canonical code of lens[:n], as
    lzx_core.cuh:build: lengths above 16 are no code; left is the unused
    code space out of 2^16, -1 when over-subscribed (sym then None)."""
    count = [0] * 17
    for v in lens[:n]:
        if v <= 16:
            count[v] += 1
    count[0] = 0
    left = 1
    for n_ in range(1, 17):
        left = (left << 1) - count[n_]
        if left < 0:
            return count, None, -1
    offs = [0] * 17
    for n_ in range(1, 16):
        offs[n_ + 1] = offs[n_] + count[n_]
    sym = {}
    for s, v in enumerate(lens[:n]):
        if 1 <= v <= 16:
            sym[offs[v]] = s
            offs[v] += 1
    return count, sym, left


def _lut(count, sym):
    """16-bit peek -> (length << 16) | symbol for a complete code."""
    lut = np.zeros(1 << 16, np.int64)
    code = index = 0
    for n in range(1, 17):
        for k in range(count[n]):
            lo = code << (16 - n)
            lut[lo:lo + (1 << (16 - n))] = (n << 16) | sym[index + k]
            code += 1
        index += count[n]
        code <<= 1
    return lut.tolist()


class _Lane:
    """One stream's decode on one state record: lzx_core.cuh in Python."""

    def __init__(self, src, rec, hist, window_bits, is_delta, tcap):
        self.src, self.n = src, len(src)
        self.rec = rec
        self.hist, self.delta, self.tcap = hist, is_delta, tcap
        self.wbits = window_bits
        self.num_offsets = POSITION_SLOTS[window_bits - 15] << 3
        for f in _SCALARS:
            setattr(self, f, int(rec[f]))
        self.main_lens = rec["main_lens"].tolist()
        self.len_lens = rec["len_lens"].tolist()
        self.aln_lens = rec["aln_lens"].tolist()
        # lookup tables of the trees last built, as the record holds them
        self.luts = {}
        for t in ("main", "len", "aln"):
            count = rec[f"{t}_count"].tolist()
            if sum(count):
                self.luts[t] = _lut(count, rec[f"{t}_sym"].tolist())
        self.toks, self.litws = [], []
        self.word = self.cnt = 0
        self.upos = self.buf = self.nbits = 0

    # -- bits: MSB first over 16-bit little-endian units, zeros past the end

    def fill(self):
        src, n = self.src, self.n
        while self.nbits <= 48:
            p = self.upos
            u = (src[p] if p < n else 0) | ((src[p + 1] if p + 1 < n else 0)
                                            << 8)
            self.upos = p + 2
            self.buf = (self.buf << 16) | u
            self.nbits += 16

    def peek(self, k):
        if self.nbits < k:
            self.fill()
        return self.buf >> (self.nbits - k)

    def drop(self, k):
        self.nbits -= k
        self.buf &= (1 << self.nbits) - 1

    def take(self, k):
        if k == 0:
            return 0
        v = self.peek(k)
        self.drop(k)
        return v

    def tell(self):
        return self.upos * 8 - self.nbits

    def seek(self, p):
        self.upos = (p >> 4) << 1
        self.buf = self.nbits = 0
        if p & 15:
            self.fill()
            self.drop(p & 15)

    def byte_at(self, p):
        return self.src[p] if p < self.n else 0

    # -- tokens -----------------------------------------------------------

    def emit(self, tok, litw):
        if len(self.toks) >= self.tcap:
            raise _TokenCap
        self.toks.append(tok)
        self.litws.append(litw - (1 << 32) if litw >= 1 << 31 else litw)

    def flush(self):
        if self.cnt:
            self.emit(TOK_LIT | self.cnt, self.word)
            self.word = self.cnt = 0

    def literal(self, v):
        self.word |= v << (8 * self.cnt)
        self.cnt += 1
        if self.cnt == 4:
            self.flush()

    # -- trees ------------------------------------------------------------

    def set_tree(self, name, lens, n):
        """Build a tree into the record; returns its left code space."""
        count, sym, left = _build(lens, n)
        self.rec[f"{name}_count"] = count
        if sym is not None:
            arr = self.rec[f"{name}_sym"]
            for k, s in sym.items():
                arr[k] = s
            if left == 0:
                self.luts[name] = _lut(count, sym)
        return left

    def decode(self, lut):
        v = lut[self.peek(16)]
        self.drop(v >> 16)
        return v & 0xFFFF

    def read_lens(self, lens, first, last):
        plens = [self.take(4) for _ in range(NPRE)]
        count, sym, left = _build(plens, NPRE)
        if left != 0:
            raise _DataError("pretree")
        pre = _lut(count, sym)
        pos = first
        while pos < last:
            s = self.decode(pre)
            run, value = 1, 0
            if s == 17:
                run = self.take(4) + 4
            elif s == 18:
                run = self.take(5) + 20
            else:
                if s == 19:
                    run = self.take(1) + 4
                    s = self.decode(pre)
                value = lens[pos] - s
                if value < 0:
                    value += 17
                value &= 0xFF
            lens[pos:pos + run] = [value] * run
            pos += run

    def begin_block(self):
        if self.block_type == 3 and self.block_length & 1:
            self.seek(self.tell() + 8)
        self.block_type = self.take(3)
        hi = self.take(16)
        self.block_remaining = self.block_length = (hi << 8) | self.take(8)
        if self.block_type == 3:
            self.intel_started = 1
            self.rtag = 0
            q = (((self.tell() >> 4) + 1) << 4) >> 3
            r = [self.byte_at(q + k) for k in range(12)]
            self.r0, self.r1, self.r2 = (
                r[k] | r[k + 1] << 8 | r[k + 2] << 16 | r[k + 3] << 24
                for k in (0, 4, 8))
            self.seek((q + 12) * 8)
            return
        if self.block_type not in (1, 2):
            raise _DataError("bad block type")
        if self.block_type == 2:
            self.aln_lens = [self.take(3) for _ in range(NALN)]
            if self.set_tree("aln", self.aln_lens, NALN) != 0:
                raise _DataError("aligned tree")
        self.read_lens(self.main_lens, 0, 256)
        self.read_lens(self.main_lens, 256, 256 + self.num_offsets)
        if self.set_tree("main", self.main_lens, MAIN_MAX) != 0:
            raise _DataError("main tree")
        if self.main_lens[0xE8]:
            self.intel_started = 1
        self.read_lens(self.len_lens, 0, NLEN - 1)
        self.length_empty = int(not any(self.len_lens[:NLEN]))
        if self.set_tree("len", self.len_lens, NLEN) != 0 and \
                not self.length_empty:
            raise _DataError("length tree")

    # -- symbols ----------------------------------------------------------

    def match(self, sym, fbase, fend):
        elem = sym - 256
        ln = elem & 7
        if ln == 7:
            if self.length_empty:
                raise _DataError("LENGTH symbol from an empty tree")
            ln += self.decode(self.luts["len"])
        ln += 2
        slot = elem >> 3
        t = self.rtag
        symbol = slot < 3 and (t >> slot) & 1
        if slot == 0:
            off = self.r0
        elif slot == 1:
            off = self.r1
            self.r1, self.r0 = self.r0, off
            self.rtag = (t & 4) | ((t & 1) << 1) | ((t >> 1) & 1)
        elif slot == 2:
            off = self.r2
            self.r2, self.r0 = self.r0, off
            self.rtag = (t & 2) | ((t & 1) << 2) | ((t >> 2) & 1)
        else:
            extra = 17 if slot >= 36 else (slot >> 1) - 1
            if slot < 38:
                base = (2 + (slot & 1)) << ((slot >> 1) - 1)
            else:
                base = 524288 + (slot - 38) * 131072
            off = base - 2
            if extra >= 3 and self.block_type == 2:
                if extra > 3:
                    off += self.take(extra - 3) << 3
                off += self.decode(self.luts["aln"])
            else:
                off += self.take(extra)
            self.r2, self.r1, self.r0 = self.r1, self.r0, off
            self.rtag = (t << 1) & 6
        if self.delta and ln == 257:
            e = self.peek(3)
            if e >> 2 == 0:
                self.drop(1)
                ln += self.take(8)
            elif e >> 1 == 2:
                self.drop(2)
                ln += self.take(10) + 0x100
            elif e == 6:
                self.drop(3)
                ln += self.take(12) + 0x500
            else:
                self.drop(3)
                ln += self.take(15)
        wsize = 1 << self.wbits
        lap = self.outpos & (wsize - 1)
        if lap + ln > wsize:
            raise _DataError("match over the window wrap")
        if ln > self.block_remaining or self.outpos + ln > fend:
            raise _DataError("match past the block or frame")
        if symbol:   # checked by the join
            self.flush()
            self.emit(TOK_REP | ln, off << 16 | (self.outpos - fbase))
            self.outpos += ln
            self.block_remaining -= ln
            return
        first = ln
        if off > lap:
            if off > fbase and off - lap > self.hist:
                raise _DataError("match offset beyond the stream")
            if off - lap > wsize:
                raise _DataError("match offset beyond the window")
            if off > wsize and ln > off - lap:
                first = off - lap
        self.flush()
        if off > lap and off > wsize:
            self.emit(TOK_MATCH | first, off - wsize)
            if first < ln:
                self.emit(TOK_MATCH | (ln - first), off)
        else:
            self.emit(TOK_MATCH | ln, off)
        self.outpos += ln
        self.block_remaining -= ln

    def run_to(self, fbase, fend, stop):
        """Decode up to ``stop`` inside the frame [fbase, fend)."""
        while self.outpos < stop:
            if self.block_remaining == 0:
                self.begin_block()
                continue
            if self.block_type == 3:
                k = min(stop - self.outpos, self.block_remaining)
                q = self.tell() >> 3
                for j in range(k):
                    self.literal(self.byte_at(q + j))
                self.seek((q + k) * 8)
                self.outpos += k
                self.block_remaining -= k
                continue
            sym = self.decode(self.luts["main"])
            if sym < 256:
                self.literal(sym)
                self.outpos += 1
                self.block_remaining -= 1
                continue
            self.match(sym, fbase, fend)

    def read_intel_header(self):
        v = 0
        if self.take(1):
            hi = self.take(16)
            v = (hi << 16) | self.take(16)
            v = v - (1 << 32) if v & 0x80000000 else v
        self.intel_filesize = v
        self.header_read = 1

    def run(self, target):
        while self.outpos < target:
            fbase = self.outpos
            fend = min(fbase + FRAME, target)
            if self.delta:
                self.take(16)
            if not self.header_read:
                self.read_intel_header()
            self.run_to(fbase, fend, fend)
            if self.block_type != 3:
                self.seek((self.tell() + 15) & ~15)
        self.flush()

    def put_seed(self, seeds, k, bitpos, outpos, remaining):
        """seeds[k]: this lane's trees and block state at a frame start,
        R0-R2 as the input symbols (lzx_core.cuh:put_seed)."""
        seeds[k] = self.rec
        seed = seeds[k:k + 1]
        for f in _SCALARS:
            seed[f] = getattr(self, f)
        seed["main_lens"] = self.main_lens
        seed["len_lens"] = self.len_lens
        seed["aln_lens"] = self.aln_lens
        seed["bitpos"], seed["outpos"] = bitpos, outpos
        seed["block_remaining"], seed["err"] = remaining, 0
        seed["r0"], seed["r1"], seed["r2"], seed["rtag"] = 0, 1, 2, 7

    def decode_to(self, target):
        """-> the counts column (err, outpos, ntok, cursor, intel_started,
        intel_filesize); writes the state back to the record."""
        if self.err == 0 and self.outpos < target:
            self.seek(self.bitpos)
            try:
                self.run(target)
            except _DataError:
                self.err = 1
            except _TokenCap:
                self.err = 2
            self.bitpos = self.tell()
        rec = self.rec
        for f in _SCALARS:
            rec[f] = getattr(self, f)
        rec["main_lens"] = self.main_lens
        rec["len_lens"] = self.len_lens
        rec["aln_lens"] = self.aln_lens
        return (self.err, self.outpos, len(self.toks), (self.bitpos + 7) >> 3,
                self.intel_started, self.intel_filesize)


def _new_state(L):
    """L fresh state records (lz::init), as a CPU uint8 tensor."""
    arr = np.zeros(L, STATE_DTYPE)
    arr["r0"] = arr["r1"] = arr["r2"] = 1
    return torch.from_numpy(arr.view(np.uint8).reshape(L, STATE_BYTES))


def split_rows(frame_sizes, L, is_delta=False, fresh=True):
    """{row: its frames' CFDATA starts (bytes)} of the rows that decode
    split: those given at least MIN_SPLIT_FRAMES CFDATA payload lengths,
    in a fresh non-DELTA launch. The one rule left to the kernel needs the
    output length: its header walk fails a row whose block count is not
    its frame count, which then decodes serially (``SPLIT_SEED``)."""
    if frame_sizes is None or is_delta or not fresh:
        return {}
    if len(frame_sizes) != L:
        raise ValueError(f"frame_sizes must have {L} entries")
    return {i: np.concatenate([[0], np.cumsum(fs[:-1])]).astype(np.int64)
            for i, fs in enumerate(frame_sizes)
            if fs is not None and len(fs) >= MIN_SPLIT_FRAMES}


def _seed_walk(src, total, hist, wbits, fstart):
    """split_seed of lzx_core.cuh: the seeds of a stream's frames, or None
    where the walk fails."""
    nf = len(fstart)
    if nf < 1 or nf != -(-total // FRAME) or fstart[0] != 0:
        return None
    seeds = np.zeros(nf, STATE_DTYPE)
    seeds["r0"] = seeds["r1"] = seeds["r2"] = 1
    lane = _Lane(src, seeds[:1].copy()[0], hist, wbits, False, 1 << 62)
    nxt, o = 1, 0
    try:
        lane.read_intel_header()
        while o < total:
            lane.begin_block()
            e = o + lane.block_length
            if e == o:
                continue
            hf, raw = o // FRAME, lane.tell() >> 3
            while nxt * FRAME < min(e, total):
                lane.put_seed(seeds, nxt, int(fstart[nxt]) * 8, nxt * FRAME,
                              e - nxt * FRAME)
                nxt += 1
            if e >= total:
                break
            j = e // FRAME
            lane.outpos, lane.block_remaining = e, 0
            if lane.block_type == 3:
                g = (e - 1) // FRAME
                lane.seek(8 * (raw + e - o if g <= hf
                               else int(fstart[g]) + e - g * FRAME))
            elif e % FRAME == 0:
                lane.seek(int(fstart[j]) * 8)
            else:
                fbase = j * FRAME
                lane.outpos, lane.block_remaining = o, e - o
                if j != hf:
                    lane.seek(int(fstart[j]) * 8)
                    lane.outpos, lane.block_remaining = fbase, e - fbase
                lane.rtag = 7
                lane.run_to(fbase, min(fbase + FRAME, total), e)
                if lane.outpos != e:
                    return None
            if e % FRAME == 0 and nxt == j:
                lane.put_seed(seeds, nxt, lane.tell(), e, 0)
                nxt += 1
            o = e
    except (_DataError, _TokenCap):
        return None
    return seeds if nxt == nf else None


def _split_plain(src, total, hist, wbits, fstart, cap):
    """One stream through the split passes of lzx_core.cuh, in order:
    ``(flags, tok, litw, counts rows 0-5)``; flags 0 when the frames'
    trace is the stream's, else its SPLIT_* bits (and no trace)."""
    seeds = _seed_walk(src, total, hist, wbits, fstart)
    if seeds is None:
        return SPLIT_SEED, None, None, None
    nf = len(seeds)
    ends = np.zeros(nf, FRAME_END_DTYPE)
    parts = []
    for k in range(nf):
        lane = _Lane(src, seeds[k:k + 1].copy()[0], hist, wbits, False, FRAME)
        lane.decode_to(min((k + 1) * FRAME, total))
        for f in FRAME_END_DTYPE.names[:-2]:
            ends[f][k] = getattr(lane, f)
        ends["ntok"][k] = len(lane.toks)
        parts.append((lane.toks, lane.litws))
    wsize = 1 << wbits
    flags, off, rin = 0, 0, [1, 1, 1]
    tok, litw = [], []
    for k, (toks, litws) in enumerate(parts):
        E = ends[k]
        fbase = k * FRAME
        fail = 0
        if E["err"] or E["outpos"] != min(fbase + FRAME, total):
            fail |= SPLIT_FRAME
        if k and any(ends[f][k - 1] != seeds[f][k] for f in _SEAM):
            fail |= SPLIT_SEAM
        if off + len(toks) > cap:
            fail |= SPLIT_CAP
        if not fail:
            for v, w in zip(toks, litws):
                if v & TOK_REP:
                    ln, o = v & 0xFFFFF, rin[(w >> 16) & 3]
                    lap = (fbase + (w & 0xFFFF)) & (wsize - 1)
                    if o > lap and ((o > fbase and o - lap > hist)
                                    or o - lap > wsize
                                    or (o > wsize and ln > o - lap)):
                        fail |= SPLIT_CHECK
                    v = TOK_MATCH | ln
                    w = o - wsize if o > lap and o > wsize else o
                    w = w - (1 << 32) if w >= 1 << 31 else w
                tok.append(v)
                litw.append(w)
        flags |= fail
        rin = [rin[int(E[f"r{i}"])] if (int(E["rtag"]) >> i) & 1
               else int(E[f"r{i}"]) for i in range(3)]
        off += len(toks)
    if flags:
        return flags, None, None, None
    last = ends[-1]
    return 0, tok, litw, (0, int(last["outpos"]), off,
                          (int(last["bitpos"]) + 7) >> 3,
                          int(last["intel_started"]),
                          int(last["intel_filesize"]))


def lzx_phase_a_plain(streams, lens, out_lens, hists, window_bits, *,
                      is_delta=False, tcap, state=None, frame_sizes=None):
    """Plain version of K3 on CPU tensors: same outputs and state record,
    with NOP (-1) tokens and zero litwords past each lane's count. Returns
    ``(tok, litw, cnt, state)``; a passed ``state`` is updated in place.
    ``frame_sizes`` splits rows as ``lzx_phase_a`` does (counts row 6)."""
    L = streams.shape[0]
    split = split_rows(frame_sizes, L, is_delta, state is None)
    if state is None:
        state = _new_state(L)
    recs = state.numpy().view(STATE_DTYPE).reshape(L)
    src = streams.numpy()
    tok = np.full((L, tcap), TOK_NOP, np.int32)
    litw = np.zeros((L, tcap), np.int32)
    cnt = np.zeros((8, L), np.int32)
    for i in range(L):
        data = src[i, :int(lens[i])].tobytes()
        flags = None
        if i in split:
            flags, toks, litws, col = _split_plain(
                data, int(out_lens[i]), int(hists[i]), window_bits,
                split[i], tcap)
            if not flags:
                cnt[:6, i] = col
                cnt[6, i] = SPLIT_DONE
                tok[i, :len(toks)] = toks
                litw[i, :len(litws)] = litws
                continue
        lane = _Lane(data, recs[i], int(hists[i]), window_bits,
                     bool(is_delta), tcap)
        cnt[:6, i] = lane.decode_to(int(out_lens[i]))
        if flags:
            cnt[6, i] = flags
        n = len(lane.toks)
        tok[i, :n] = lane.toks
        litw[i, :n] = lane.litws
    return (torch.from_numpy(tok), torch.from_numpy(litw),
            torch.from_numpy(cnt), state)


# ---------------------------------------------------------------- bench --

def bench_stream(data, window_bits):
    """``pallas_lzx.py:1299-1310``: the native encoder, or the Python one
    where the native engine does not build."""
    from .. import native
    if native.available():
        r = native.lzx_encode(data, window_bits, 0)
        if r is not None:
            return r[0]
    from ..compress.lzx_e import LzxEncoder
    return LzxEncoder(window_bits).compress(data)[0]


def bench_inputs(n_lanes=1024, chunk_kb=64, window_bits=16, cache_dir=None):
    """``pallas_lzx.py:1323-1331``'s inputs: ``n_lanes`` chunks of
    ``chunk_kb`` KiB of the bench corpus, each one LZX stream. Returns
    ``(datas, streams)``; ``cache_dir`` keeps the streams
    (``_bench.encoded``)."""
    from . import _bench
    datas = _bench.chunks(n_lanes, chunk_kb)
    streams = _bench.encoded(f"lzx{window_bits}", datas,
                             lambda d: bench_stream(d, window_bits),
                             cache_dir)
    return datas, streams


def launch_config(dev, L):
    """K3's launch at ``L`` streams (``_bench.launch_line``)."""
    from . import _bench
    if dev.type != "cuda":
        return None
    return _bench.launch_line(dev, L, 32,
                              kernels.launch_info("msp_k3_launch_info"))


def bench_entry(n_lanes=1024, chunk_kb=64, window_bits=16, device="cuda",
                reps=3, cache_dir=None):
    """The port of ``pallas_lzx.py:1313-1378``: K3 on ``n_lanes``
    independent LZX chunks in one launch, on ``device``, with the token cap
    ``chunk_kb * 1024 + 4096``. Returns the JAX entry's keys
    (``max_steps`` is the most tokens of a lane, counts row 2),
    ``bytes_in`` and ``tokens`` (the streams' bytes and all lanes'
    tokens), ``plain_max_abs_err`` (the sampled lanes, state records
    included,
    against ``lzx_phase_a_plain`` on their inputs), ``launch`` and
    ``peak_bytes`` (``_bench`` says how each time is taken)."""
    from ..parallel.cuda_pipeline import resolve_lzx
    from . import _bench

    dev = resolve_device(device)
    datas, streams = bench_inputs(n_lanes, chunk_kb, window_bits, cache_dir)
    out_lens = torch.tensor([len(d) for d in datas], dtype=torch.int32)
    hists = torch.zeros(n_lanes, dtype=torch.int32)
    tcap = chunk_kb * 1024 + 4096

    def with_upload(state=False):
        s, lens = pack_streams(streams)
        out = lzx_phase_a(s, lens, out_lens, hists, window_bits, tcap=tcap,
                          return_state=state, device=dev)
        return (s, lens) + out[:2] + (out[2].cpu(),) + out[3:]

    _bench.reset_peak(dev)
    s, lens, tok, litw, cnt, state = with_upload(state=True)
    lanes = _bench.sampled(n_lanes)
    got = (tok[lanes].cpu(), litw[lanes].cpu(), cnt[:, lanes],
           state[lanes].cpu())
    del tok, litw, state
    replayed = [None if cnt[0, i] or cnt[1, i] != out_lens[i] else
                resolve_lzx(got[0][k:k + 1].numpy(), got[1][k:k + 1].numpy(),
                            [len(datas[i])], cnt[4, i:i + 1].numpy(),
                            cnt[5, i:i + 1].numpy(), window_bits,
                            n_threads=1)
                for k, i in enumerate(lanes)]
    exact = [None if r is None else r[0].tobytes() for r in replayed] == \
        [datas[i] for i in lanes]
    plain = lzx_phase_a_plain(s[lanes], lens[lanes], out_lens[lanes],
                              hists[lanes], window_bits, tcap=tcap)
    up_ms = _bench.host_ms(with_upload, reps)
    sd, ld, od, hd = (t.to(dev) for t in (s, lens, out_lens, hists))
    ms = _bench.device_ms(lambda: lzx_phase_a(sd, ld, od, hd, window_bits,
                                              tcap=tcap), dev, reps)
    total = int(out_lens.sum())
    return _bench.result(
        "k3_lzx", "pallas_lzx.phase_a",
        f"{n_lanes} lanes x {chunk_kb} KiB chunks, window 2^{window_bits}, "
        "bench corpus", dev, total, ms, reps, lanes=n_lanes,
        mb_per_s_with_upload=total / up_ms / 1e3,
        errors=int((cnt[0] != 0).sum()),
        out_ok=int((cnt[1] == out_lens).sum()),
        sampled_bit_exact=bool(exact), max_steps=int(cnt[2].max()),
        bytes_in=int(lens.sum()), tokens=int(cnt[2].sum()),
        plain_max_abs_err=shadow.difference(got, plain), tcap=tcap,
        launch=launch_config(dev, n_lanes), peak_bytes=_bench.peak(dev))
