"""CAB per-block checksum on the device.

PyTorch counterpart of ``libmspack_tpu/ops/checksum.py``, which XLA
computes outside any Pallas kernel. The CAB CFDATA checksum XORs the block
as little-endian u32 words, with a tail rule for the last 1-3 bytes
(reference: cabd.c:1462-1479). The XOR reduction is a pairwise tree of
``torch.bitwise_xor`` over int64 words (torch has no XOR reduction), log2
of the words deep; exact, as every step is. No path of either package
calls it yet: the CAB drivers check CFDATA blocks on the host, where the
blocks are read (``formats/cab.py::_checksum``).
"""
from __future__ import annotations

import numpy as np
import torch

from .._device import resolve_device

__all__ = ["cab_checksum", "cab_checksum_padded", "xor_reduce"]


def xor_reduce(x):
    """The XOR of the last axis of an integer tensor, by halves."""
    while x.shape[-1] > 1:
        if x.shape[-1] & 1:
            x = torch.cat([x, torch.zeros_like(x[..., :1])], -1)
        x = torch.bitwise_xor(x[..., 0::2], x[..., 1::2])
    if x.shape[-1] == 0:
        return torch.zeros(x.shape[:-1], dtype=x.dtype, device=x.device)
    return x[..., 0]


def cab_checksum_padded(data, length: int, init: int = 0):
    """Checksum of ``data[:length]``, ``data`` a uint8 tensor zero-padded to
    a multiple of 4 (at least ``length`` rounded up), as an int64 scalar
    tensor on its device.

    Tail rule: 3 remaining bytes pack as b0<<16|b1<<8|b2, 2 as b0<<8|b1, 1
    as b0 -- big-endian-ish, unlike the u32 body."""
    full = length // 4
    shifts = torch.tensor([0, 8, 16, 24], dtype=torch.int64,
                          device=data.device)
    words = (data[:full * 4].reshape(-1, 4).to(torch.int64) << shifts).sum(1)
    body = xor_reduce(words)
    tail = data[full * 4:length].to(torch.int64)
    rem = int(tail.numel())
    if rem:
        tail = (tail << torch.tensor([8 * (rem - 1 - k) for k in range(rem)],
                                     dtype=torch.int64,
                                     device=data.device)).sum()
    else:
        tail = torch.zeros((), dtype=torch.int64, device=data.device)
    return body ^ tail ^ init


def cab_checksum(data: bytes, init: int = 0, device="cuda") -> int:
    """Host wrapper, bit-exact vs formats.cab._checksum."""
    n = len(data)
    arr = np.zeros((n + 3) // 4 * 4, np.uint8)
    arr[:n] = np.frombuffer(data, np.uint8)
    t = torch.from_numpy(arr).to(resolve_device(device))
    return int(cab_checksum_padded(t, n, init))
