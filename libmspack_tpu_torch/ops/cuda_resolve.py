"""K2: phase B on the device — the token copy machine.

PyTorch counterpart of ``libmspack_tpu/ops/pallas_resolve.py``. It turns
K1 traces into bytes. The TPU kernel wrote each lane into its own 32 KiB
slot and copied lane i-1's slot in as lane i's history; here the output
is one contiguous uint8 buffer with lane i at the prefix sum of the lane
sizes, and a lane whose hist flag is set continues the chain of the lane
before it, so its history is the bytes before it (back to its chain's
first lane). The bytes of a lane and its count are what the TPU kernel
gives; the layout is this module's.

A CUDA tensor runs the hand-written kernel (``csrc/resolve.cu``); a CPU
tensor runs ``resolve_frames_plain``, a per-token replay. ``LAUNCHES``
counts both.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import kernels
from .cuda_inflate import TOK_MATCH

LAUNCHES = {"cuda": 0, "plain": 0}


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


def resolve_frames_device(tok, litw, ntok, out_lens, hist_flags):
    """Resolve K1 traces into bytes where ``tok`` lies.

    tok, litw: int32 ``(L, T)`` lane-major traces; ntok: int32 ``(L,)``
    tokens per lane (K1's counts row 2), on the same device. out_lens and
    hist_flags: per-lane sizes and chain flags (sequences or CPU tensors).
    Returns ``(bytes uint8 (sum(out_lens),), counts int32 (L,))``; a lane's
    count equals its size when its trace resolved to exactly that many
    bytes, and is -1 when a match reached before its chain's start."""
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
    off, chains = _layout(lens, flags)
    if tok.device.type == "cpu":
        LAUNCHES["plain"] += 1
        return resolve_frames_plain(tok, litw, ntok, lens, flags)
    if tok.device.type != "cuda":
        raise ValueError(f"unsupported device {tok.device}")
    dev = tok.device
    lens_d = torch.from_numpy(lens).to(dev)
    off_d = torch.from_numpy(off).to(dev)
    chains_d = torch.from_numpy(chains).to(dev)
    out = torch.empty(int(off[-1]), dtype=torch.uint8, device=dev)
    counts = torch.empty(L, dtype=torch.int32, device=dev)
    lib = kernels.lib()
    with torch.cuda.device(dev):
        rc = lib.msp_k2_resolve(
            tok.data_ptr(), litw.data_ptr(), tok.stride(0), ntok.data_ptr(),
            lens_d.data_ptr(), off_d.data_ptr(), chains_d.data_ptr(),
            len(chains) - 1, out.data_ptr(), counts.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    kernels.check(rc, "K2 resolve")
    LAUNCHES["cuda"] += 1
    return out, counts


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
