"""LZSS decode as device tensor ops (SZDD's ``engine="cuda"``).

PyTorch counterpart of ``libmspack_tpu/ops/lzss_jax.py`` (the JAX
package's ``engine="jax"`` for SZDD, an XLA op). The scalar reference walks
the stream byte by byte (``codecs/lzss.py`` <- lzssd.c); here:

Phase A (structure): an LZSS stream is control-byte groups -- a control
byte then 8 items of 1 (literal) or 2 (match) bytes -- so a group's length
is a function of its control byte, ``9 + popcount(~cb & 0xFF)``. The
positions of all control bytes are the orbit of 0 under that step, found
by pointer doubling (log2 rounds of gathers); the items' offsets and output
lengths are then prefix sums.

Phase B: each match is a constant distance in the output (the window
position folds into it; a source before the output reads the 0x20
pre-fill) and ``ops.match_resolve.resolve`` resolves all bytes at once.

Unlike the JAX op, whose shapes are static (the output sized for the worst
case), the output is sized by the decoded length, read back once.
MSHELP mode inverts control bytes; QBASIC starts at another window
position.
"""
from __future__ import annotations

import numpy as np
import torch

from .._device import resolve_device
from ..codecs.lzss import MODE_MSHELP, MODE_QBASIC, WINDOW_SIZE
from .match_resolve import resolve

__all__ = ["decompress"]

_POPCNT8 = np.unpackbits(np.arange(256, dtype=np.uint8)[:, None],
                         axis=1).sum(1).astype(np.int64)


def _decode(data, n: int, mode: int, max_groups: int):
    """``data``: uint8 tensor, the stream zero-padded past ``n``. Returns
    the decoded bytes as a uint8 tensor on its device."""
    dev = data.device
    size = data.shape[0]
    invert = 0xFF if mode == MODE_MSHELP else 0x00
    init_pos = WINDOW_SIZE - (18 if mode == MODE_QBASIC else 16)
    popcnt = torch.from_numpy(_POPCNT8).to(dev)

    cb = (data ^ invert).to(torch.int64)
    step = 9 + popcnt[255 - cb]
    idx = torch.arange(size, dtype=torch.int64, device=dev)
    # orbit of 0 under step: jumps[k] moves 2^k groups on
    n_doublings = max(1, max_groups - 1).bit_length()
    jumps = [(idx + step).clamp(max=size - 1)]
    for _ in range(n_doublings - 1):
        jumps.append(jumps[-1][jumps[-1]])
    ranks = torch.arange(max_groups, dtype=torch.int64, device=dev)
    gpos = torch.zeros(max_groups, dtype=torch.int64, device=dev)
    for k, jump in enumerate(jumps):
        gpos = torch.where(((ranks >> k) & 1) == 1, jump[gpos], gpos)
    valid_group = gpos < n

    # each group: its control byte and 8 items
    flags = (cb[gpos][:, None] >> torch.arange(8, device=dev)) & 1
    is_lit = flags == 1
    item_size = torch.where(is_lit, 1, 2)
    item_pos = gpos[:, None] + torch.cumsum(item_size, 1) - item_size + 1
    b0 = data[item_pos.clamp(max=size - 1)].to(torch.int64)
    b1 = data[(item_pos + 1).clamp(max=size - 1)].to(torch.int64)
    mlen = (b1 & 0x0F) + 3
    mpos = b0 | ((b1 & 0xF0) << 4)
    # truncation (lzssd.c ENSURE_BYTES): an item counts only if all its
    # bytes are inside the stream
    item_ok = valid_group[:, None] & (item_pos + item_size - 1 <= n - 1)
    flat_len = torch.where(item_ok, torch.where(is_lit, 1, mlen), 0) \
        .reshape(-1)
    out_start = torch.cumsum(flat_len, 0) - flat_len
    total = int(flat_len.sum())

    # match distance: d = ((window position - mpos - 1) mod 4096) + 1
    winpos = (init_pos + out_start) % WINDOW_SIZE
    dist = ((winpos - mpos.reshape(-1) - 1) % WINDOW_SIZE) + 1
    tok_id = torch.repeat_interleave(
        torch.arange(flat_len.shape[0], device=dev), flat_len)
    bpos = torch.arange(total, dtype=torch.int64, device=dev)
    ptr = torch.where(is_lit.reshape(-1)[tok_id], bpos, bpos - dist[tok_id])
    return resolve(ptr, b0.reshape(-1)[tok_id].to(torch.uint8), fill=0x20)


def decompress(data: bytes, mode: int = 0, device="cuda") -> bytes:
    """Bit-exact LZSS decode of a whole stream on ``device``."""
    n = len(data)
    if n == 0:
        return b""
    # worst case: every group is 9 bytes (a control byte and 8 literals)
    max_groups = n // 9 + 2
    arr = np.zeros(n + 32, np.uint8)
    arr[:n] = np.frombuffer(data, np.uint8)
    t = torch.from_numpy(arr).to(resolve_device(device))
    return _decode(t, n, mode, max_groups).cpu().numpy().tobytes()
