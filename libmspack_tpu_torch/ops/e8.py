"""Vectorized E8 call translation (device pass).

PyTorch counterpart of ``libmspack_tpu/ops/e8.py``, an XLA op of the JAX
package. LZX preprocesses x86 code: E8 (call) instructions' absolute
targets are converted to/from relative. The scalar decoder walks each
frame byte by byte because a translated E8's 4 operand bytes must not
themselves be treated as E8 leaders (reference: lzxd.c:706-733).

Device formulation: E8 leaders claim 5 bytes; a byte is a *real* leader
iff it is 0xE8 and not within the 4-byte shadow of a previous real
leader. From a real leader at i the next one is the first candidate at
i+5 or later, so the leaders are the orbit of the first candidate under
that jump, found by pointer doubling in log2 rounds: exact, like the
scalar loop.
"""
from __future__ import annotations

import numpy as np
import torch

from .._device import resolve_device

__all__ = ["e8_transform", "e8_decode_frame"]


def _i32(x):
    """int64 values wrapped to int32 (the JAX op's int32 arithmetic)."""
    return ((x + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)


def e8_transform(frame, curpos0: int, filesize: int, decode: bool = True):
    """Apply the E8 transform to one frame (uint8 tensor, length >= 11).

    curpos0: stream offset of frame[0]; filesize: the intel filesize.
    decode=True undoes the translation (decompressor side); False applies
    it (compressor side). Returns a new tensor on the frame's device."""
    n = frame.shape[0]
    dev = frame.device
    idx = torch.arange(n, device=dev)
    cand = (frame == 0xE8) & (idx < n - 10)
    # next_cand[i] = the first candidate >= i (a reverse running minimum)
    cand_pos = torch.where(cand, idx, n)
    next_cand = torch.flip(torch.cummin(torch.flip(cand_pos, (0,)), 0)
                           .values, (0,))

    first = next_cand[0]
    jump = next_cand[torch.clamp(idx + 5, max=n - 1)]
    max_leaders = n // 5 + 1
    n_doublings = max(1, max_leaders - 1).bit_length()
    jumps = [jump]
    for _ in range(n_doublings - 1):
        jumps.append(jumps[-1][torch.clamp(jumps[-1], max=n - 1)])
    ranks = torch.arange(max_leaders, device=dev)
    lead = first.expand(max_leaders).clone()
    for k in range(n_doublings):
        bit = (ranks >> k) & 1
        lead = torch.where(bit == 1,
                           jumps[k][torch.clamp(lead, max=n - 1)], lead)
    valid = lead < n

    def b(o):
        return frame[torch.clamp(lead + o, max=n - 1)].to(torch.int64)

    word = _i32(b(1) | (b(2) << 8) | (b(3) << 16) | (b(4) << 24))
    curpos = curpos0 + lead
    if decode:
        ok = (word >= -curpos) & (word < filesize)
        rel = torch.where(word >= 0, word - curpos, word + filesize)
    else:
        ok = (word >= -curpos) & (word < filesize)
        # encoder direction mirrors the MS tool: translate when in range
        rel = torch.where(word >= 0, word + curpos, word - filesize)
    new = torch.where(ok, rel, word)

    out = frame.clone()
    at = lead[valid]
    for o in range(4):
        out[at + 1 + o] = ((new[valid] >> (8 * o)) & 0xFF).to(torch.uint8)
    return out


def e8_decode_frame(frame_bytes: bytes, offset: int, filesize: int,
                    device="cuda") -> bytes:
    """Host convenience wrapper: one frame's bytes through
    ``e8_transform`` on ``device``."""
    arr = torch.from_numpy(np.frombuffer(frame_bytes, np.uint8).copy())
    out = e8_transform(arr.to(resolve_device(device)), offset, filesize)
    return out.cpu().numpy().tobytes()
