"""K4: Quantum phase A — one token trace per stream, with resumable state.

PyTorch counterpart of ``libmspack_tpu/ops/pallas_qtm.py``. A batch is an
``(L, nbytes)`` uint8 tensor of independent Quantum streams (CAB folders,
each block followed by the 0xFF trailer the CAB reader injects,
cabd.c:1327-1332), their byte lengths and their target output positions.
``qtm_phase_a`` returns, on the streams' device:

* ``tok``, ``litw``: int32 ``(L, tcap)``, lane-major, each lane's tokens of
  this call compacted from column 0 in the TPU kernel's format
  (``pallas_qtm.py:39-42``, which is ``pallas_lzx.py``'s). Columns past
  the lane's count are undefined on the GPU and NOP (-1) on the CPU.
* ``cnt``: int32 ``(8, L)``. Row 0 err (0 ok, 1 bad data, 2 token cap),
  row 1 output position reached, row 2 tokens written by this call, row 3
  input bytes consumed, row 4 matches of this call whose destination
  crossed a window lap end (the reference codec's window-wrap flush,
  ``codecs/qtm.py:309-322``). Rows 0 and 1 mean what the TPU kernel's do;
  rows 2-4 are this port's own.
* with ``return_state=True`` or a ``state`` passed in, also ``state``:
  uint8 ``(L, STATE_BYTES)``, each lane's whole decoder state
  (``STATE_DTYPE``, the ``qt::State`` record of ``csrc/qtm_core.cuh``).
  The decoder updates the record in place; passing it back with the same
  streams resumes every lane where it stopped. Targets other than a
  stream's total length must be multiples of 32 KiB.

``tcap`` bounds the tokens per lane and call. Every token carries at least
one output byte, so ``tcap`` = the bytes a call decodes is always enough.

A CUDA tensor runs the hand-written kernel (``csrc/qtm.cu``, one warp per
stream, rows copied to 4-byte alignment first where they are not); a CPU
tensor runs ``qtm_phase_a_plain``, a straightforward Python decoder of the same
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
from .cuda_lzx import (TOK_LIT, TOK_MATCH, TOK_NOP, from_jax_batch,
                       word_aligned)

FRAME = 32768
NT = 9
TROWS = 65
# each model's first symbol; selector, literal 0-3, match3, match4,
# variable-length position, length (qtm_core.cuh:init)
MODEL_STARTS = (0, 0, 64, 128, 192, 0, 0, 0, 0)

MODEL_DTYPE = np.dtype([
    ("entries", "<i4"), ("rescales_left", "<i4"),
    ("sym", "<u2", (TROWS,)), ("cum", "<u2", (TROWS,)),
], align=True)
# the qt::State record of csrc/qtm_core.cuh, field for field
STATE_DTYPE = np.dtype([
    ("bitpos", "<i8"), ("outpos", "<i8"), ("frame_todo", "<i4"),
    ("err", "<i4"), ("H", "<u2"), ("L", "<u2"), ("C", "<u2"),
    ("pad", "<u2"), ("m", MODEL_DTYPE, (NT,)),
], align=True)
STATE_BYTES = STATE_DTYPE.itemsize

LAUNCHES = {"cuda": 0, "plain": 0}

__all__ = ["qtm_phase_a", "qtm_phase_a_plain", "pack_streams",
           "from_jax_batch", "model_sizes", "LAUNCHES", "STATE_BYTES",
           "STATE_DTYPE"]


def model_sizes(window_bits):
    """Entries of the nine models (``pallas_qtm.py:117-119``)."""
    span = window_bits * 2
    return (7, 64, 64, 64, 64, min(span, 24), min(span, 36), span, 27)


def _check_batch(streams, lens, out_lens, window_bits, state):
    if streams.dtype != torch.uint8 or streams.dim() != 2:
        raise ValueError("streams must be a 2-D uint8 tensor")
    if streams.stride(1) != 1:
        raise ValueError("streams rows must be contiguous")
    L = streams.shape[0]
    for name, t in (("lens", lens), ("out_lens", out_lens)):
        if t.dtype != torch.int32 or t.shape != (L,) or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous int32 ({L},)")
        if t.device != streams.device:
            raise ValueError(f"{name} is on {t.device}, streams on "
                             f"{streams.device}")
    if not 10 <= window_bits <= 21:
        raise ValueError(f"window_bits {window_bits} outside 10..21")
    if state is not None and (state.dtype != torch.uint8
                              or state.shape != (L, STATE_BYTES)
                              or not state.is_contiguous()
                              or state.device != streams.device):
        raise ValueError(f"state must be a contiguous uint8 "
                         f"({L}, {STATE_BYTES}) on {streams.device}")
    if L and streams.device.type == "cpu" and int(lens.max()) > \
            streams.shape[1]:
        raise ValueError("a stream length exceeds the row width")


def qtm_phase_a(streams, lens, out_lens, window_bits, *, tcap, state=None,
                return_state=False, device=None):
    """Phase A on a batch (see the module docstring). ``device`` moves the
    batch there first; by default it runs where ``streams`` lies. A CUDA
    tensor launches K4 or raises."""
    if device is not None:
        dev = resolve_device(device)
        streams, lens, out_lens = (t.to(dev) for t in (streams, lens,
                                                       out_lens))
        if state is not None:
            state = state.to(dev)
    _check_batch(streams, lens, out_lens, window_bits, state)
    want_state = return_state or state is not None
    if streams.device.type == "cpu":
        LAUNCHES["plain"] += 1
        out = qtm_phase_a_plain(streams, lens, out_lens, window_bits,
                                tcap=tcap, state=state)
        return out if want_state else out[:3]
    if streams.device.type != "cuda":
        raise ValueError(f"unsupported device {streams.device}")
    host = shadow.inputs(streams, lens, out_lens, state)
    L = streams.shape[0]
    dev = streams.device
    streams = word_aligned(streams)
    lib = kernels.lib()
    if lib.msp_k4_state_bytes() != STATE_BYTES:
        raise RuntimeError("qt::State and STATE_DTYPE differ in size")
    fresh = state is None
    if fresh:
        state = torch.empty((L, STATE_BYTES), dtype=torch.uint8, device=dev)
    tok = torch.empty((L, tcap), dtype=torch.int32, device=dev)
    litw = torch.empty((L, tcap), dtype=torch.int32, device=dev)
    cnt = torch.empty((8, L), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        rc = lib.msp_k4_qtm(
            streams.data_ptr(), streams.stride(0), lens.data_ptr(),
            out_lens.data_ptr(), L, window_bits, int(fresh),
            state.data_ptr(), tok.data_ptr(), litw.data_ptr(), tcap,
            cnt.data_ptr(), torch.cuda.current_stream().cuda_stream)
    kernels.check(rc, "K4 qtm")
    LAUNCHES["cuda"] += 1
    if host is not None:
        shadow.record("k4_qtm", (tok, litw, cnt, state), qtm_phase_a_plain(
            *host[:3], window_bits, tcap=tcap, state=host[3]))
    return (tok, litw, cnt, state) if want_state else (tok, litw, cnt)


# ---------------------------------------------------------------- plain --

EXTRA_BITS = tuple((0 if i < 2 else i - 2) >> 1 for i in range(42))
POSITION_BASE = tuple(sum(1 << e for e in EXTRA_BITS[:i]) for i in range(42))
LENGTH_EXTRA = tuple((0 if i < 2 else i - 2) >> 2 for i in range(26)) + (0,)
LENGTH_BASE = tuple(sum(1 << e for e in LENGTH_EXTRA[:i])
                    for i in range(26)) + (254,)


class _DataError(Exception):
    pass


class _TokenCap(Exception):
    pass


class _Lane:
    """One stream's decode on one state record: qtm_core.cuh in Python.
    The stream is MSB-first over bytes (16-bit big-endian units read MSB
    first are the bytes in order), zeros past its end."""

    def __init__(self, src, rec, window_bits, tcap):
        # zeros past the end: a decode stops within a few symbols of its
        # 16-bit soft end of input, far inside this padding
        self.src = src + b"\0" * 64
        self.nbits = len(src) * 8
        self.rec, self.tcap = rec, tcap
        self.wsize = 1 << window_bits
        self.pos = int(rec["bitpos"])
        self.outpos = int(rec["outpos"])
        self.frame_todo = int(rec["frame_todo"])
        self.err = int(rec["err"])
        self.H, self.L, self.C = int(rec["H"]), int(rec["L"]), int(rec["C"])
        self.models = [(int(m["entries"]), [int(m["rescales_left"])],
                        m["sym"].tolist(), m["cum"].tolist())
                       for m in rec["m"]]
        self.toks, self.litws = [], []
        self.word = self.cnt = self.wraps = 0

    def take(self, k):
        if k == 0:
            return 0
        p = self.pos
        w = int.from_bytes(self.src[p >> 3:(p >> 3) + 4], "big")
        self.pos = p + k
        return (w >> (32 - (p & 7) - k)) & ((1 << k) - 1)

    def emit(self, tok, litw):
        if len(self.toks) >= self.tcap:
            raise _TokenCap
        self.toks.append(tok)
        self.litws.append(litw - (1 << 32) if litw >= 1 << 31 else litw)

    def flush(self):
        if self.cnt:
            self.emit(TOK_LIT | self.cnt, self.word)
            self.word = self.cnt = 0

    def get_symbol(self, k):
        entries, rl, sym, cum = self.models[k]
        H, L, C = self.H, self.L, self.C
        span = ((H - L) & 0xFFFF) + 1
        total = cum[0]
        symf = (((((C - L) & 0xFFFF) + 1) * total - 1) // span) & 0xFFFF
        i = 1
        while i < entries and cum[i] > symf:
            i += 1
        s = sym[i - 1]
        hi = (L + (cum[i - 1] * span) // total - 1) & 0xFFFF
        lo = (L + (cum[i] * span) // total) & 0xFFFF
        for j in range(i):
            cum[j] += 8
        if cum[0] > 3800:
            _update(entries, rl, sym, cum)
        code = C
        while True:
            if (lo & 0x8000) != (hi & 0x8000):
                if (lo & 0x4000) and not (hi & 0x4000):
                    code ^= 0x4000
                    lo &= 0x3FFF
                    hi |= 0x4000
                else:
                    break
            lo = (lo << 1) & 0xFFFF
            hi = ((hi << 1) | 1) & 0xFFFF
            code = ((code << 1) | self.take(1)) & 0xFFFF
        self.H, self.L, self.C = hi, lo, code
        return s

    def run(self, target):
        wsize = self.wsize
        limit = self.nbits + 16
        while self.outpos < target:
            if self.frame_todo == FRAME:
                self.H, self.L = 0xFFFF, 0
                self.C = self.take(16)
            sel = self.get_symbol(0)
            if sel < 4:
                v = self.get_symbol(1 + sel)
                self.word |= v << (8 * self.cnt)
                self.cnt += 1
                self.outpos += 1
                self.frame_todo -= 1
                if self.cnt == 4 or self.frame_todo == 0 or \
                        self.outpos >= target:
                    self.flush()
            else:
                if sel == 4:
                    slot, ln = self.get_symbol(5), 3
                elif sel == 5:
                    slot, ln = self.get_symbol(6), 4
                elif sel == 6:
                    ls = self.get_symbol(8)
                    ln = LENGTH_BASE[ls] + self.take(LENGTH_EXTRA[ls]) + 5
                    slot = self.get_symbol(7)
                else:
                    raise _DataError("bad selector")
                off = POSITION_BASE[slot] + self.take(EXTRA_BITS[slot]) + 1
                lap = self.outpos & (wsize - 1)
                if off > lap and off - lap > wsize:
                    raise _DataError("offset beyond the window")
                self.frame_todo -= ln
                if self.frame_todo < 0:
                    raise _DataError("overshot frame alignment")
                self.flush()
                if lap + ln > wsize:
                    self.wraps += 1
                if off > lap and off > wsize:
                    first = min(ln, off - lap)
                    self.emit(TOK_MATCH | first, off - wsize)
                    if first < ln:
                        self.emit(TOK_MATCH | (ln - first), off)
                else:
                    self.emit(TOK_MATCH | ln, off)
                self.outpos += ln
            if self.frame_todo == 0:
                self.pos = (self.pos + 7) & ~7
                while True:
                    if self.pos >= self.nbits:
                        raise _DataError("no trailer before the end")
                    if self.take(8) == 0xFF:
                        break
                self.frame_todo = FRAME
            if self.pos > limit:
                raise _DataError("out of input")

    def decode_to(self, target):
        """-> the counts column (err, outpos, ntok, cursor, wraps); writes
        the state back to the record."""
        if self.err == 0 and self.outpos < target:
            try:
                self.run(target)
            except _DataError:
                self.err = 1
            except _TokenCap:
                self.err = 2
        rec = self.rec
        for f in ("outpos", "frame_todo", "err", "H", "L", "C"):
            rec[f] = getattr(self, f)
        rec["bitpos"] = self.pos
        for m, (_, rl, sym, cum) in zip(rec["m"], self.models):
            m["rescales_left"] = rl[0]
            m["sym"] = sym
            m["cum"] = cum
        return (self.err, self.outpos, len(self.toks), (self.pos + 7) >> 3,
                self.wraps)


def _update(n, rl, sym, cum):
    """qtm_core.cuh:model_update on lists; ``rl`` is [rescales_left]."""
    rl[0] -= 1
    if rl[0]:
        for i in range(n - 1, -1, -1):
            cum[i] >>= 1
            if cum[i] <= cum[i + 1]:
                cum[i] = cum[i + 1] + 1
        return
    rl[0] = 50
    for i in range(n):
        cum[i] = ((cum[i] - cum[i + 1]) + 1) >> 1
    for i in range(n - 1):
        for j in range(i + 1, n):
            if cum[i] < cum[j]:
                cum[i], cum[j] = cum[j], cum[i]
                sym[i], sym[j] = sym[j], sym[i]
    for i in range(n - 1, -1, -1):
        cum[i] += cum[i + 1]


def _new_state(L, window_bits):
    """L fresh state records (qt::init), as a CPU uint8 tensor."""
    arr = np.zeros(L, STATE_DTYPE)
    arr["frame_todo"] = FRAME
    for k, (n, start) in enumerate(zip(model_sizes(window_bits),
                                       MODEL_STARTS)):
        m = arr["m"][:, k]
        m["entries"] = n
        m["rescales_left"] = 4
        m["sym"][:, :n + 1] = start + np.arange(n + 1)
        m["cum"][:, :n + 1] = n - np.arange(n + 1)
    return torch.from_numpy(arr.view(np.uint8).reshape(L, STATE_BYTES))


def qtm_phase_a_plain(streams, lens, out_lens, window_bits, *, tcap,
                      state=None):
    """Plain version of K4 on CPU tensors: same outputs and state record,
    with NOP (-1) tokens and zero litwords past each lane's count. Returns
    ``(tok, litw, cnt, state)``; a passed ``state`` is updated in place."""
    L = streams.shape[0]
    if state is None:
        state = _new_state(L, window_bits)
    recs = state.numpy().view(STATE_DTYPE).reshape(L)
    src = streams.numpy()
    tok = np.full((L, tcap), TOK_NOP, np.int32)
    litw = np.zeros((L, tcap), np.int32)
    cnt = np.zeros((8, L), np.int32)
    for i in range(L):
        lane = _Lane(src[i, :int(lens[i])].tobytes(), recs[i], window_bits,
                     tcap)
        cnt[:5, i] = lane.decode_to(int(out_lens[i]))
        n = len(lane.toks)
        tok[i, :n] = lane.toks
        litw[i, :n] = lane.litws
    return (torch.from_numpy(tok), torch.from_numpy(litw),
            torch.from_numpy(cnt), state)


# ---------------------------------------------------------------- bench --

def bench_stream(data, window_bits):
    """``pallas_qtm.py:901-912``: the native encoder's frames, each
    followed by the 0xFF trailer the CAB reader injects; the Python encoder
    where the native engine does not build."""
    from .. import native
    if native.available():
        frames = native.qtm_encode(data, window_bits)
        if frames is not None:
            return b"".join(p + b"\xff" for p in frames)
    from ..compress import qtm_e
    return b"".join(p + b"\xff" for p in qtm_e.compress(data, window_bits))


def bench_inputs(n_lanes=1024, chunk_kb=24, window_bits=15, cache_dir=None):
    """``pallas_qtm.py:925-932``'s inputs: ``n_lanes`` chunks of
    ``chunk_kb`` KiB of the bench corpus, each one Quantum stream. Returns
    ``(datas, streams)``; ``cache_dir`` keeps the streams
    (``_bench.encoded``)."""
    from . import _bench
    datas = _bench.chunks(n_lanes, chunk_kb)
    streams = _bench.encoded(f"qtm{window_bits}", datas,
                             lambda d: bench_stream(d, window_bits),
                             cache_dir)
    return datas, streams


def bench_tcap(out_lens):
    """The token cap of the bench (``pallas_qtm.py:934``)."""
    return ((max(out_lens) * 2 + 2048 + 127) // 128) * 128


def launch_config(dev, L):
    """K4's launch at ``L`` streams (``_bench.launch_line``)."""
    from . import _bench
    if dev.type != "cuda":
        return None
    return _bench.launch_line(dev, L, 32,
                              kernels.launch_info("msp_k4_launch_info"))


def bench_entry(n_lanes=1024, chunk_kb=24, window_bits=15, device="cuda",
                reps=2, cache_dir=None):
    """The port of ``pallas_qtm.py:914-972``: K4 on ``n_lanes``
    independent Quantum streams in one launch, on ``device``. Returns the
    JAX entry's keys (``max_steps`` is the most tokens of a lane, counts
    row 2) and, as K1's and K3's entries do, ``mb_per_s_with_upload``;
    ``bytes_in`` and ``tokens`` (the streams' bytes and all lanes'
    tokens), ``plain_max_abs_err`` (the sampled lanes, state records
    included,
    against ``qtm_phase_a_plain`` on their inputs), ``launch`` and
    ``peak_bytes`` (``_bench`` says how each time is taken)."""
    from ..parallel.cuda_pipeline import resolve_lzx
    from . import _bench

    dev = resolve_device(device)
    datas, streams = bench_inputs(n_lanes, chunk_kb, window_bits, cache_dir)
    out_lens = torch.tensor([len(d) for d in datas], dtype=torch.int32)
    tcap = bench_tcap([len(d) for d in datas])

    def with_upload(state=False):
        s, lens = pack_streams(streams)
        out = qtm_phase_a(s, lens, out_lens, window_bits, tcap=tcap,
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
                            [len(datas[i])], [0], [0], window_bits,
                            n_threads=1)
                for k, i in enumerate(lanes)]
    exact = [None if r is None else r[0].tobytes() for r in replayed] == \
        [datas[i] for i in lanes]
    plain = qtm_phase_a_plain(s[lanes], lens[lanes], out_lens[lanes],
                              window_bits, tcap=tcap)
    up_ms = _bench.host_ms(with_upload, reps)
    sd, ld, od = (t.to(dev) for t in (s, lens, out_lens))
    ms = _bench.device_ms(lambda: qtm_phase_a(sd, ld, od, window_bits,
                                              tcap=tcap), dev, reps)
    total = int(out_lens.sum())
    return _bench.result(
        "k4_qtm", "pallas_qtm.phase_a",
        f"{n_lanes} lanes x {chunk_kb} KiB folders, window 2^{window_bits}, "
        "bench corpus", dev, total, ms, reps, lanes=n_lanes,
        mb_per_s_with_upload=total / up_ms / 1e3,
        errors=int((cnt[0] != 0).sum()),
        out_ok=int((cnt[1] == out_lens).sum()),
        sampled_bit_exact=bool(exact), max_steps=int(cnt[2].max()),
        bytes_in=int(lens.sum()), tokens=int(cnt[2].sum()),
        plain_max_abs_err=shadow.difference(got, plain), tcap=tcap,
        launch=launch_config(dev, n_lanes), peak_bytes=_bench.peak(dev))
