"""K1: DEFLATE phase A — one token trace per stream.

PyTorch counterpart of ``libmspack_tpu/ops/pallas_inflate.py``. A batch is
an ``(L, nbytes)`` uint8 tensor of raw deflate streams (MSZIP frames
without 'CK'), their byte lengths and their history budgets (0 for a
folder's first frame, 32768 after). ``inflate_phase_a`` returns, on the
streams' device:

* ``tok``, ``litw``: int32 ``(L, tcap)``, lane-major, each lane's tokens
  compacted from column 0 in the TPU kernel's format
  (``pallas_inflate.py:55-61``). Columns past the lane's count are
  undefined on the GPU and NOP (-1) on the CPU.
* ``cnt``: int32 ``(8, L)``. Row 0 err (0 ok, 1 bad data, 2 token cap),
  row 1 output bytes, row 2 tokens, row 3 input words consumed.

``tcap`` bounds the tokens per lane. Every token carries at least one
output byte, so a lane that decodes to at most ``tcap`` bytes never hits
the cap: with ``tcap`` = the frame's expected size, a lane flagged err 2
has overrun that size and is bad either way.

A CUDA tensor runs the hand-written kernel (``csrc/inflate.cu``); a CPU
tensor runs ``inflate_phase_a_plain``, a straightforward Python decoder
of the same format. ``LAUNCHES`` counts both. Inside
``shadow.active()`` a launch on a card also runs the plain version on CPU
copies of its inputs and keeps the difference (``ops/shadow.py``).
"""
from __future__ import annotations

import numpy as np
import torch

from .. import kernels
from .._device import resolve_device
from . import shadow

TOK_NOP = -1
TOK_LIT = 0x20000000
TOK_MATCH = 0x40000000

NLIT = 288      # literal/length symbols
NDIST = 30      # distance symbols with a meaning (HDIST may name 32)
FRAME_MAX = 32768

BITLEN_ORDER = (16, 17, 18, 0, 8, 7, 9, 6, 10, 5,
                11, 4, 12, 3, 13, 2, 14, 1, 15)

FIXED_LIT_LENS = [8] * 144 + [9] * 112 + [7] * 24 + [8] * 8
FIXED_DIST_LENS = [5] * 32  # codes 30/31 exist but are invalid on use

# warps per block of the K1 launch, one stream per warp: small blocks
# spread a few hundred lanes over more SMs (swept by chip_smoke.py; PERF.md)
K1_WARPS = 1

LAUNCHES = {"cuda": 0, "plain": 0}


def canonical_keys(lens, nsyms):
    """``(len << 16) | rank`` per symbol (-1 for unused) plus the
    ``first`` and ``limit`` rows of the canonical code, as the TPU kernel
    tabulates them."""
    cnt = [0] * 16
    for n in lens:
        if n:
            cnt[n] += 1
    first = [0] * 16
    limit = [0] * 16
    for n in range(1, 16):
        first[n] = (first[n - 1] + cnt[n - 1]) << 1
        limit[n] = first[n] + cnt[n]
    keys = np.full(nsyms, -1, np.int32)
    nxt = list(first)
    for s, n in enumerate(lens):
        if n:
            keys[s] = (n << 16) | (nxt[n] - first[n])
            nxt[n] += 1
    return keys, np.array(first, np.int32), np.array(limit, np.int32)


FIXED_LIT_KEYS = canonical_keys(FIXED_LIT_LENS, NLIT)
FIXED_DIST_KEYS = canonical_keys(FIXED_DIST_LENS[:NDIST], NDIST)


def pack_streams(frames):
    """Frames (bytes) -> ``(streams uint8 (L, nbytes), lens int32 (L,))``
    on the CPU, zero-padded to the longest frame."""
    width = max((len(f) for f in frames), default=0) or 1
    arr = np.zeros((len(frames), width), np.uint8)
    for i, f in enumerate(frames):
        arr[i, :len(f)] = np.frombuffer(f, np.uint8)
    lens = np.array([len(f) for f in frames], np.int32)
    return torch.from_numpy(arr), torch.from_numpy(lens)


def from_jax_batch(stream_grid, hist_grid):
    """The TPU kernel's packed batch -> this module's.

    ``stream_grid`` is ``pallas_inflate.pack_streams``'s ``(W, SL, LN)``
    uint32 word grid and ``hist_grid`` the ``(SL, LN)`` history grid of
    ``pallas_inflate.inflate_phase_a``. Returns ``(streams, lens, hists)``
    for all ``SL * LN`` lanes; each lane's length is the whole padded row,
    which decodes the same since both read zeros past a stream's end."""
    g = np.asarray(stream_grid, np.uint32)
    words = g.reshape(g.shape[0], -1).T.astype("<u4")
    streams = np.ascontiguousarray(words).view(np.uint8)
    lens = np.full(streams.shape[0], streams.shape[1], np.int32)
    hists = np.asarray(hist_grid, np.int32).reshape(-1)
    return (torch.from_numpy(streams.copy()), torch.from_numpy(lens),
            torch.from_numpy(hists.copy()))


def _check_batch(streams, lens, hists):
    if streams.dtype != torch.uint8 or streams.dim() != 2:
        raise ValueError("streams must be a 2-D uint8 tensor")
    if streams.stride(1) != 1:
        raise ValueError("streams rows must be contiguous")
    L = streams.shape[0]
    for name, t in (("lens", lens), ("hists", hists)):
        if t.dtype != torch.int32 or t.shape != (L,) or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous int32 ({L},)")
        if t.device != streams.device:
            raise ValueError(f"{name} is on {t.device}, streams on "
                             f"{streams.device}")
    if L and streams.device.type == "cpu" and int(lens.max()) > \
            streams.shape[1]:
        raise ValueError("a stream length exceeds the row width")


def inflate_phase_a(streams, lens, hists, *, tcap=FRAME_MAX, device=None,
                    warps=K1_WARPS):
    """Phase A on a batch (see the module docstring). ``device`` moves the
    batch there first; by default it runs where ``streams`` lies. A CUDA
    tensor launches K1 (one warp per stream, ``warps`` per block) or
    raises."""
    if device is not None:
        dev = resolve_device(device)
        streams, lens, hists = (t.to(dev) for t in (streams, lens, hists))
    _check_batch(streams, lens, hists)
    if streams.device.type == "cpu":
        LAUNCHES["plain"] += 1
        return inflate_phase_a_plain(streams, lens, hists, tcap=tcap)
    if streams.device.type != "cuda":
        raise ValueError(f"unsupported device {streams.device}")
    host = shadow.inputs(streams, lens, hists)
    L = streams.shape[0]
    dev = streams.device
    tok = torch.empty((L, tcap), dtype=torch.int32, device=dev)
    litw = torch.empty((L, tcap), dtype=torch.int32, device=dev)
    cnt = torch.empty((8, L), dtype=torch.int32, device=dev)
    lib = kernels.lib()
    with torch.cuda.device(dev):
        rc = lib.msp_k1_inflate(
            streams.data_ptr(), streams.stride(0), lens.data_ptr(),
            hists.data_ptr(), L, tok.data_ptr(), litw.data_ptr(), tcap,
            cnt.data_ptr(), warps, torch.cuda.current_stream().cuda_stream)
    kernels.check(rc, "K1 inflate")
    LAUNCHES["cuda"] += 1
    if host is not None:
        shadow.record("k1_inflate", (tok, litw, cnt),
                      inflate_phase_a_plain(*host, tcap=tcap), rows=4)
    return tok, litw, cnt


# ---------------------------------------------------------------- plain --

_LEN_BASE = [3, 4, 5, 6, 7, 8, 9, 10, 11, 13, 15, 17, 19, 23, 27, 31,
             35, 43, 51, 59, 67, 83, 99, 115, 131, 163, 195, 227, 258]
_LEN_EXTRA = [0] * 8 + [1] * 4 + [2] * 4 + [3] * 4 + [4] * 4 + [5] * 4 + [0]
_DIST_BASE = [1, 2, 3, 4, 5, 7, 9, 13, 17, 25, 33, 49, 65, 97, 129, 193,
              257, 385, 513, 769, 1025, 1537, 2049, 3073, 4097, 6145,
              8193, 12289, 16385, 24577]
_DIST_EXTRA = [0, 0, 0, 0] + [e for e in range(1, 14) for _ in (0, 1)]


class _DataError(Exception):
    pass


class _TokenCap(Exception):
    pass


def _build(lengths):
    """(count, symbol) of a canonical code; raises on over-subscription."""
    count = [0] * 16
    for n in lengths:
        count[n] += 1
    left = 1
    for n in range(1, 16):
        left = (left << 1) - count[n]
        if left < 0:
            raise _DataError("over-subscribed code")
    offs = [0] * 16
    for n in range(1, 15):
        offs[n + 1] = offs[n] + count[n]
    symbol = [0] * len(lengths)
    for s, n in enumerate(lengths):
        if n:
            symbol[offs[n]] = s
            offs[n] += 1
    return count, symbol


_FIXED = (_build(FIXED_LIT_LENS), _build(FIXED_DIST_LENS[:NDIST]))


class _Decoder:
    """One stream, LSB-first, zeros past its end."""

    def __init__(self, src: bytes, hist: int, tcap: int):
        self.src, self.n = src, len(src)
        self.pos = self.buf = self.nbits = 0
        self.hist, self.tcap = hist, tcap
        self.out = 0
        self.toks: list[int] = []
        self.litws: list[int] = []

    def need(self, k):
        while self.nbits < k:
            v = self.src[self.pos] if self.pos < self.n else 0
            self.pos += 1
            self.buf |= v << self.nbits
            self.nbits += 8

    def take(self, k):
        self.need(k)
        v = self.buf & ((1 << k) - 1)
        self.buf >>= k
        self.nbits -= k
        return v

    def emit(self, tok, litw):
        if len(self.toks) >= self.tcap:
            raise _TokenCap
        self.toks.append(tok)
        self.litws.append(litw - (1 << 32) if litw >= 1 << 31 else litw)

    def decode(self, table):
        count, symbol = table
        self.need(15)
        bits = self.buf
        code = first = index = 0
        for n in range(1, 16):
            code |= bits & 1
            bits >>= 1
            c = count[n]
            if code - c < first:
                self.buf >>= n
                self.nbits -= n
                return symbol[index + code - first]
            index += c
            first = (first + c) << 1
            code <<= 1
        raise _DataError("Huffman miss")

    def stored(self):
        self.take(self.nbits & 7)
        ln, nln = self.take(16), self.take(16)
        if ln ^ 0xFFFF != nln:
            raise _DataError("stored LEN/NLEN mismatch")
        while ln:
            k = min(ln, 4)
            self.emit(TOK_LIT | k, self.take(8 * k))
            self.out += k
            ln -= k

    def dynamic(self):
        nlen = self.take(5) + 257
        ndist = self.take(5) + 1
        ncode = self.take(4) + 4
        cl = [0] * 19
        for i in range(ncode):
            cl[BITLEN_ORDER[i]] = self.take(3)
        cltab = _build(cl)
        lens = []
        prev = 0
        while len(lens) < nlen + ndist:
            sym = self.decode(cltab)
            if sym < 16:
                lens.append(sym)
                prev = sym
                continue
            if sym == 16:
                rep, val = 3 + self.take(2), prev
            elif sym == 17:
                rep, val = 3 + self.take(3), 0
            else:
                rep, val = 11 + self.take(7), 0
            if len(lens) + rep > nlen + ndist:
                raise _DataError("code-length run overflows")
            lens.extend([val] * rep)
        return _build(lens[:nlen]), _build(lens[nlen:])

    def codes(self, lit, dist):
        litword = litcnt = 0
        while True:
            sym = self.decode(lit)
            if sym < 256:
                litword |= sym << (8 * litcnt)
                self.out += 1
                litcnt += 1
                if litcnt == 4:
                    self.emit(TOK_LIT | 4, litword)
                    litword = litcnt = 0
                continue
            if sym == 256:
                if litcnt:
                    self.emit(TOK_LIT | litcnt, litword)
                return
            slot = sym - 257
            if slot >= 29:
                raise _DataError("length slot >= 29")
            mlen = _LEN_BASE[slot] + self.take(_LEN_EXTRA[slot])
            ds = self.decode(dist)
            if ds >= 30:
                raise _DataError("distance symbol >= 30")
            d = _DIST_BASE[ds] + self.take(_DIST_EXTRA[ds])
            if d > self.out + self.hist:
                raise _DataError("distance beyond history")
            self.emit(TOK_MATCH | (litcnt << 25) | (mlen << 16) | (d - 1),
                      litword)
            litword = litcnt = 0
            self.out += mlen

    def run(self):
        """-> (err, outbytes, ntok, words consumed)."""
        err = 0
        try:
            while True:
                final = self.take(1)
                kind = self.take(2)
                if kind == 0:
                    self.stored()
                elif kind == 1:
                    self.codes(*_FIXED)
                elif kind == 2:
                    self.codes(*self.dynamic())
                else:
                    raise _DataError("block type 3")
                if final:
                    break
        except _DataError:
            err = 1
        except _TokenCap:
            err = 2
        used = self.pos * 8 - self.nbits
        return err, self.out, len(self.toks), (used + 31) >> 5


def inflate_phase_a_plain(streams, lens, hists, *, tcap=FRAME_MAX):
    """Plain version of K1 on CPU tensors: same outputs, with NOP (-1)
    tokens and zero litwords past each lane's count."""
    L = streams.shape[0]
    src = streams.numpy()
    tok = np.full((L, tcap), TOK_NOP, np.int32)
    litw = np.zeros((L, tcap), np.int32)
    cnt = np.zeros((8, L), np.int32)
    for i in range(L):
        dec = _Decoder(src[i, :int(lens[i])].tobytes(), int(hists[i]), tcap)
        cnt[:4, i] = dec.run()
        n = len(dec.toks)
        tok[i, :n] = dec.toks
        litw[i, :n] = dec.litws
    return torch.from_numpy(tok), torch.from_numpy(litw), torch.from_numpy(cnt)


# ---------------------------------------------------------------- bench --

def bench_inputs(n=1024, kb=32):
    """``tools/bench_kernels.py:27-35``'s inputs: ``n`` chunks of ``kb``
    KiB of the bench corpus, each compressed alone by zlib level 6 (raw
    deflate, no history). Returns ``(frames, raws)``."""
    import zlib

    from ._bench import chunks

    raws = chunks(n, kb)
    frames = []
    for raw in raws:
        co = zlib.compressobj(6, zlib.DEFLATED, -15)
        frames.append(co.compress(raw) + co.flush())
    return frames, raws


def bench_tcap(kb):
    """The token cap of the bench (``tools/bench_kernels.py:36``)."""
    return ((kb * 1024 // 2 + 2048 + 127) // 128) * 128


def launch_config(dev, L, warps=K1_WARPS):
    """K1's launch at ``L`` streams (``_bench.launch_line``)."""
    from . import _bench
    if dev.type != "cuda":
        return None
    return _bench.launch_line(dev, -(-L // warps), 32 * warps,
                              kernels.launch_info("msp_k1_launch_info",
                                                  warps))


def replay(tok, litw, sizes):
    """Lanes' traces (int32 numpy ``(k, T)`` rows, no history) resolved
    into bytes by the native resolver: a list of bytes, None where it
    fails."""
    from .. import native

    tok = np.ascontiguousarray(tok, np.int32)
    litw = np.ascontiguousarray(litw, np.int32)
    out = []
    for i, n in enumerate(sizes):
        buf = np.zeros(max(n, 1), np.uint8)
        r = native.resolve_traces(tok[i:i + 1], litw[i:i + 1], [0], [1],
                                  [n], buf, [0, n], 1)
        out.append(buf[:n].tobytes() if r == 0 else None)
    return out


def bench_entry(n=1024, kb=32, device="cuda", reps=3):
    """The port of ``tools/bench_kernels.py:21-79``
    (``bench_inflate_phase_a``): K1 on ``n`` frames of ``kb`` KiB at
    once, on ``device``. Returns the JAX entry's keys (``max_steps`` is
    the most tokens of a lane, counts row 2), ``bytes_in`` and ``tokens``
    (the streams' bytes and all lanes' tokens), ``plain_max_abs_err`` (the
    sampled lanes against ``inflate_phase_a_plain`` on their inputs,
    ``shadow.difference``), ``launch`` and ``peak_bytes`` (``_bench``
    says how each time is taken)."""
    from . import _bench

    dev = resolve_device(device)
    frames, raws = bench_inputs(n, kb)
    tcap = bench_tcap(kb)
    sizes = np.array([len(r) for r in raws])
    total = int(sizes.sum())
    hists = torch.zeros(n, dtype=torch.int32)

    def with_upload():
        s, lens = pack_streams(frames)
        tok, litw, cnt = inflate_phase_a(s, lens, hists, tcap=tcap,
                                         device=dev)
        return s, lens, tok, litw, cnt.cpu()

    _bench.reset_peak(dev)
    s, lens, tok, litw, cnt = with_upload()
    lanes = _bench.sampled(n)
    got = (tok[lanes].cpu(), litw[lanes].cpu(), cnt[:, lanes])
    del tok, litw
    exact = replay(got[0].numpy(), got[1].numpy(),
                   sizes[lanes].tolist()) == [raws[i] for i in lanes]
    plain = inflate_phase_a_plain(s[lanes], lens[lanes], hists[lanes],
                                  tcap=tcap)
    up_ms = _bench.host_ms(with_upload, reps)
    sd, ld, hd = (t.to(dev) for t in (s, lens, hists))
    ms = _bench.device_ms(lambda: inflate_phase_a(sd, ld, hd, tcap=tcap),
                          dev, reps)
    return _bench.result(
        "k1_inflate", "pallas_inflate.phase_a",
        f"{n} lanes x {kb} KiB frames, bench corpus, zlib level 6", dev,
        total, ms, reps, lanes=n,
        mb_per_s_with_upload=total / up_ms / 1e3,
        errors=int((cnt[0] != 0).sum()),
        out_ok=int((cnt[1].numpy() == sizes).sum()),
        sampled_bit_exact=bool(exact), max_steps=int(cnt[2].max()),
        bytes_in=int(lens.sum()), tokens=int(cnt[2].sum()),
        plain_max_abs_err=shadow.difference(got, plain, rows=4),
        tcap=tcap, launch=launch_config(dev, n), peak_bytes=_bench.peak(dev))
