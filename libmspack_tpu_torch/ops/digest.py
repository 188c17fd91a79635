"""Device-resident output digests.

PyTorch counterpart of ``libmspack_tpu/ops/digest.py``. Where decode output
stays on the card, a correctness check need not pull megabytes over the
host link: each lane's output is digested on the device -- CRC-32 as a
GF(2) product (``ops/crc32``) -- and 4 bytes per lane come back. No path
of either package calls it yet: every driver's bytes reach the host before
they are checked (ROADMAP Queue 1).

Convention (the JAX module's): the device digests the lane's FULL padded
row with bytes past the lane's length zeroed (one uniform batch, no ragged
shapes); the host advances its expectation over the same zero padding
(``digest_expect``). The register is raw CRC-32 (init 0xFFFFFFFF, no final
inversion), as the OAB block CRCs (oabd.c:197, crc32.h:9-15).
"""
from __future__ import annotations

import numpy as np
import torch

from .crc32 import crc32_device_batch, crc32_raw

__all__ = ["frame_digests", "digest_expect", "verify_frames"]


def frame_digests(out_u8, lengths) -> np.ndarray:
    """uint8 ``(L, S)`` tensor of per-lane outputs -> (L,) uint32 raw CRCs
    over each lane's row with bytes >= lengths[i] zeroed. Only L x 4 bytes
    cross to the host."""
    _, s = out_u8.shape
    col = torch.arange(s, device=out_u8.device)[None, :]
    lens = torch.as_tensor(np.asarray(lengths, np.int64)).to(
        out_u8.device)[:, None]
    masked = torch.where(col < lens, out_u8, torch.zeros_like(out_u8))
    return crc32_device_batch(masked).cpu().numpy().astype(np.uint32)


def digest_expect(data: bytes, padded_to: int) -> int:
    """Host-side expectation matching frame_digests for a lane padded to
    ``padded_to`` bytes: CRC the real bytes, then the zero padding."""
    d = crc32_raw(data)
    pad = padded_to - len(data)
    if pad > 0:
        d = crc32_raw(bytes(pad), d)
    return d


def verify_frames(out_u8, lengths, expected: list[bytes]) -> bool:
    """True iff every lane's device output matches its expected bytes --
    without pulling the outputs to the host."""
    s = int(out_u8.shape[1])
    got = frame_digests(out_u8, lengths)
    return all(int(got[i]) == digest_expect(exp, s)
               for i, exp in enumerate(expected))
