"""Vectorized 'MSCF' signature scan (device pass).

PyTorch counterpart of ``libmspack_tpu/ops/search.py``, an XLA op of the
JAX package. The reference scans byte by byte with a 20-byte state
machine (reference: cabd.c:750-846, hot loop :756). On the device the
candidate scan is one vectorized 4-byte compare over the whole buffer;
candidate plausibility (header fields) is then checked on the host
exactly as the driver does.
"""
from __future__ import annotations

import numpy as np
import torch

from .._device import resolve_device

__all__ = ["find_signatures", "signature_positions"]


def find_signatures(data):
    """A bool mask of the positions where b'MSCF' begins (uint8 tensor)."""
    n = data.shape[0]
    mask = ((data == 0x4D) & (torch.roll(data, -1) == 0x53)
            & (torch.roll(data, -2) == 0x43) & (torch.roll(data, -3) == 0x46))
    # positions within 3 bytes of the end can't hold a full signature
    return mask & (torch.arange(n, device=data.device) < n - 3)


def signature_positions(data: bytes, device="cuda") -> list[int]:
    """Host wrapper: all byte offsets of 'MSCF' in ``data``, scanned on
    ``device``."""
    if len(data) < 4:
        return []
    arr = torch.from_numpy(np.frombuffer(data, np.uint8).copy())
    mask = find_signatures(arr.to(resolve_device(device)))
    return torch.nonzero(mask).flatten().tolist()
