"""K2: phase B on the device — the token copy machine.

PyTorch counterpart of ``libmspack_tpu/ops/pallas_resolve.py``. It turns
K1 traces into bytes. The TPU kernel wrote each lane into its own 32 KiB
slot and copied lane i-1's slot in as lane i's history; here the output
is one contiguous uint8 buffer with lane i at the prefix sum of the lane
sizes, and a lane whose hist flag is set continues the chain of the lane
before it, so its history is the bytes before it (back to its chain's
first lane). The bytes of a lane and its count are what the TPU kernel
gives; the layout is this module's.

A CUDA tensor runs the hand-written kernel (``csrc/resolve.cu``) in two
passes: every lane at once into a scratch of uint16 values (bytes, and
markers for bytes before the lane), then chain by chain into the bytes.
A CPU tensor runs ``resolve_frames_plain``, a per-token replay, which both
passes are held to. ``LAUNCHES`` counts both, once per call.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from .. import kernels
from .cuda_inflate import TOK_MATCH

LAUNCHES = {"cuda": 0, "plain": 0}
# the most bytes a lane may hold: the TPU kernel's slot
# (pallas_resolve.py:40-41) and MSZIP's frame
LANE_MAX = 32768


def _layout(out_lens, hist_flags):
    """-> (byte offset of each lane and the total, int64 (L+1,);
    first lane of each chain and L, int32 (C+1,))."""
    lens = np.asarray(out_lens, np.int64)
    off = np.zeros(len(lens) + 1, np.int64)
    np.cumsum(lens, out=off[1:])
    starts = np.flatnonzero(np.asarray(hist_flags) == 0)
    if len(lens) and (len(starts) == 0 or starts[0] != 0):
        starts = np.concatenate([[0], starts])
    chains = np.concatenate([starts, [len(lens)]]).astype(np.int32)
    return off, chains


def _chain_bytes(off, chains):
    """Each lane's bytes before it in its chain, capped at 32768 (the
    farthest a match reaches): int32 (L,)."""
    first = np.repeat(off[chains[:-1]], np.diff(chains))
    return np.minimum(off[:-1] - first, LANE_MAX).astype(np.int32)


def _slots(lens):
    """Each lane's slot in pass 1's scratch and the total, int64 (L+1,):
    the lane sizes rounded up to 8 values (16 bytes), summed."""
    off = np.zeros(len(lens) + 1, np.int64)
    np.cumsum((np.asarray(lens, np.int64) + 7) & ~7, out=off[1:])
    return off


def resolve_frames_device(tok, litw, ntok, out_lens, hist_flags, marks=None):
    """Resolve K1 traces into bytes where ``tok`` lies.

    tok, litw: int32 ``(L, T)`` lane-major traces; ntok: int32 ``(L,)``
    tokens per lane (K1's counts row 2), on the same device. out_lens and
    hist_flags: per-lane sizes (each at most 32768) and chain flags
    (sequences or CPU tensors). Returns ``(bytes uint8 (sum(out_lens),),
    counts int32 (L,))``; a lane's count equals its size when its trace
    resolved to exactly that many bytes, and is -1 when a match reached
    before its chain's start. Bytes that no token writes are 0. On the
    card, a list ``marks`` receives three CUDA events: before pass 1,
    between the passes and after pass 2."""
    L = tok.shape[0]
    for name, t in (("tok", tok), ("litw", litw)):
        if t.dtype != torch.int32 or t.dim() != 2 or t.stride(1) != 1:
            raise ValueError(f"{name} must be int32 (L, T) with "
                             "contiguous rows")
    if litw.shape != tok.shape or litw.stride() != tok.stride():
        raise ValueError("litw must match tok's shape and strides")
    if ntok.dtype != torch.int32 or ntok.shape != (L,) or \
            not ntok.is_contiguous():
        raise ValueError(f"ntok must be a contiguous int32 ({L},)")
    if not (tok.device == litw.device == ntok.device):
        raise ValueError("tok, litw and ntok must share a device")
    lens = np.asarray(out_lens, np.int32).reshape(-1)
    flags = np.asarray(hist_flags, np.int32).reshape(-1)
    if lens.shape != (L,) or flags.shape != (L,):
        raise ValueError(f"out_lens and hist_flags need {L} entries")
    if L and (int(lens.max()) > LANE_MAX or int(lens.min()) < 0):
        raise ValueError(f"a lane size is outside 0..{LANE_MAX}")
    off, chains = _layout(lens, flags)
    if tok.device.type == "cpu":
        LAUNCHES["plain"] += 1
        return resolve_frames_plain(tok, litw, ntok, lens, flags)
    if tok.device.type != "cuda":
        raise ValueError(f"unsupported device {tok.device}")
    dev = tok.device
    woff = _slots(lens)
    lens_d, off_d, woff_d, avail_d, chains_d = (
        torch.from_numpy(a).to(dev)
        for a in (lens, off, woff, _chain_bytes(off, chains), chains))
    # pass 1's values: 2 bytes per output byte (uint16 in int16's storage)
    work = torch.empty(int(woff[-1]), dtype=torch.int16, device=dev)
    out = torch.empty(int(off[-1]), dtype=torch.uint8, device=dev)
    counts = torch.empty(L, dtype=torch.int32, device=dev)
    lib = kernels.lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        _mark(marks)
        rc = lib.msp_k2_pass1(
            tok.data_ptr(), litw.data_ptr(), tok.stride(0), ntok.data_ptr(),
            lens_d.data_ptr(), woff_d.data_ptr(), avail_d.data_ptr(), L,
            int(lens.max()) if L else 0, work.data_ptr(), counts.data_ptr(),
            stream)
        kernels.check(rc, "K2 pass 1")
        _mark(marks)
        rc = lib.msp_k2_pass2(
            work.data_ptr(), woff_d.data_ptr(), lens_d.data_ptr(),
            off_d.data_ptr(), chains_d.data_ptr(), len(chains) - 1,
            out.data_ptr(), stream)
        kernels.check(rc, "K2 pass 2")
        _mark(marks)
    LAUNCHES["cuda"] += 1
    return out, counts


def _mark(marks):
    if marks is not None:
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        marks.append(ev)


def resolve_frames_plain(tok, litw, ntok, out_lens, hist_flags):
    """Plain version of K2 on CPU tensors: replay each token in order."""
    lens = np.asarray(out_lens, np.int64)
    off, chains = _layout(lens, hist_flags)
    out = bytearray(int(off[-1]))
    counts = np.zeros(len(lens), np.int32)
    tokn, litn, nt = tok.numpy(), litw.numpy(), ntok.numpy()
    for c in range(len(chains) - 1):
        lo = int(off[chains[c]])
        for lane in range(chains[c], chains[c + 1]):
            start = dst = int(off[lane])
            end = start + int(lens[lane])
            bad = False
            n = min(int(nt[lane]), tokn.shape[1])
            for v, w in zip(tokn[lane, :n].tolist(), litn[lane, :n].tolist()):
                if dst >= end:
                    break
                if v < 0:
                    continue
                if v < TOK_MATCH:
                    nl, ln, dist = v & 7, 0, 1
                else:
                    nl, ln, dist = (v >> 25) & 3, (v >> 16) & 0x1FF, \
                        (v & 0x7FFF) + 1
                for k in range(min(nl, end - dst)):
                    out[dst + k] = (w >> (8 * k)) & 0xFF if k < 4 else 0
                d = dst + nl
                if ln and d < end:
                    if d - dist < lo:
                        bad = True
                        break
                    m = min(ln, end - d)
                    if dist >= m:
                        out[d:d + m] = out[d - dist:d - dist + m]
                    else:
                        pat = out[d - dist:d]
                        out[d:d + m] = (pat * (m // dist + 1))[:m]
                dst = d + ln
            counts[lane] = -1 if bad else dst - start
    return (torch.from_numpy(np.frombuffer(out, np.uint8).copy()),
            torch.from_numpy(counts))


# ---------------------------------------------------------------- bench --

def launch_config(dev, L, nchains, maxlen):
    """K2's two launches (``_bench.launch_line``): pass 1 at ``L`` lanes
    of at most ``maxlen`` bytes, pass 2 at ``nchains`` chains."""
    from . import _bench
    if dev.type != "cuda":
        return None
    return {"pass1": _bench.launch_line(dev, L, 32, kernels.launch_info(
                "msp_k2_launch_info", 1, maxlen)),
            "pass2": _bench.launch_line(dev, nchains, 1024,
                                        kernels.launch_info(
                                            "msp_k2_launch_info", 2, 0))}


def bench_entry(n_frames=256, device="cuda", reps=2):
    """The port of ``pallas_resolve.py:262-322``: K1 on ``n_frames``
    32 KiB frames of the bench corpus (``cuda_inflate.bench_inputs``),
    then K2 on their traces with every hist flag 0, on ``device``. ``ms``
    is K2 alone (both passes, between the events ``marks`` records, so the
    lane layout's upload is outside), mean of ``reps``. Returns the JAX
    entry's keys, ``max_steps`` and ``tokens`` (the most tokens of a lane
    and all lanes' tokens), ``plain_max_abs_err`` (the sampled lanes' bytes and
    counts against ``resolve_frames_plain`` on their traces),
    ``k1_plain_max_abs_err`` (K1's sampled lanes against its plain
    version), ``launch`` and ``peak_bytes``."""
    from .._device import resolve_device
    from . import _bench, shadow
    from . import cuda_inflate as ci

    dev = resolve_device(device)
    frames, raws = ci.bench_inputs(n_frames, 32)
    tcap = ci.bench_tcap(32)
    sizes = [len(r) for r in raws]
    flags = [0] * n_frames
    s, lens = ci.pack_streams(frames)
    hists = torch.zeros(n_frames, dtype=torch.int32)
    _bench.reset_peak(dev)
    tok, litw, cnt = ci.inflate_phase_a(s, lens, hists, tcap=tcap,
                                        device=dev)
    lanes = _bench.sampled(n_frames)
    cnth = cnt.cpu()
    rows = (tok[lanes].cpu(), litw[lanes].cpu(), cnth[:, lanes])
    k1_err = shadow.difference(rows, ci.inflate_phase_a_plain(
        s[lanes], lens[lanes], hists[lanes], tcap=tcap), rows=4)
    ntok = cnt[2].contiguous()
    out, counts = resolve_frames_device(tok, litw, ntok, sizes, flags)
    outh, counts = out.cpu().numpy(), counts.cpu()
    off, _ = _layout(sizes, flags)
    got = [outh[off[i]:off[i + 1]].tobytes() for i in lanes]
    exact = got == [raws[i] for i in lanes]
    pb, pc = resolve_frames_plain(*rows[:2], rows[2][2].contiguous(),
                                  [sizes[i] for i in lanes], [0] * len(lanes))
    err = max(int((counts[lanes] - pc).abs().max()),
              int(np.abs(np.frombuffer(b"".join(got), np.uint8).astype(int)
                         - pb.numpy().astype(int)).max()))
    times = []

    def k2():
        marks = [] if dev.type == "cuda" else None
        t0 = time.perf_counter()
        resolve_frames_device(tok, litw, ntok, sizes, flags, marks=marks)
        if marks:
            marks[-1].synchronize()
            times.append(marks[0].elapsed_time(marks[-1]))
        else:
            times.append((time.perf_counter() - t0) * 1e3)

    for _ in range(reps):
        k2()
    total = sum(sizes)
    return _bench.result(
        "k2_resolve", "pallas_resolve.phase_b",
        f"{n_frames} lanes x 32 KiB frames, hist flags 0, two passes",
        dev, total, sum(times) / reps, reps, lanes=n_frames,
        errors=int((cnth[0] != 0).sum()),
        cnt_ok=int((counts.numpy() == np.asarray(sizes)).sum()),
        sampled_bit_exact=bool(exact), max_steps=int(cnth[2].max()),
        tokens=int(cnth[2].sum()), plain_max_abs_err=err,
        k1_plain_max_abs_err=k1_err,
        launch=launch_config(dev, n_frames, n_frames, max(sizes)),
        peak_bytes=_bench.peak(dev))
