"""Vectorized bitstream views: the next N bits at every bit position.

PyTorch counterpart of ``libmspack_tpu/ops/bitview.py``, an XLA op of the
JAX package. For EVERY bit position of a byte buffer at once it computes
the value of the next N bits, the tensor form of the scalar bit register
(codecs/bitstream.py): the decode step is evaluated at all positions and
the true chain linked by pointer doubling (``ops/inflate.py``,
``ops/lzx.py``).

Bit orders match the reference formats:
* LSB ("deflate order", mszipd.c:23-26): bit k of the stream is bit
  (k&7) of byte k>>3; an n-bit read yields bits [p, p+n) with the
  earliest bit in the LSB.
* MSB over 16-bit little-endian units (lzxd.c:86-91): the stream is a
  sequence of u16 units (b1<<8|b0); bits are consumed from the MSB of
  each unit.

uint32 values are held in int64 tensors (PyTorch's uint32 has few ops on
the card), masked to 32 bits where the JAX op's uint32 arithmetic wraps.
``take`` is ``jnp.take``'s indexing rule, which the ops keep where an
index can leave its array: negative indices down to ``-n`` wrap, and any
other out-of-range index reads a fill value instead of trapping.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["take", "pad_to", "peek_lsb", "peek_msb16", "bitrev_table",
           "U32_FILL", "I32_FILL", "U8_FILL", "I8_FILL"]

# jnp.take's fill values: the dtype's largest value (unsigned) or its most
# negative one (signed)
U32_FILL = 0xFFFFFFFF
I32_FILL = -(1 << 31)
U8_FILL = 0xFF
I8_FILL = -128


def take(x, idx, fill):
    """``jnp.take(x, idx)`` on a 1-D tensor: ``x[idx]`` where
    ``-n <= idx < n`` (negative indices wrap), ``fill`` elsewhere."""
    n = x.shape[0]
    i = torch.where(idx < 0, idx + n, idx)
    got = x.index_select(0, i.clamp(0, n - 1).reshape(-1)).reshape(i.shape)
    return torch.where((i >= 0) & (i < n), got, fill)


def pad_to(data, extra: int = 8):
    """Append zero bytes so peeks beyond the end read zeros (the
    reference's soft-EOF fakes trailing zero bytes, readbits.h:198-208)."""
    return torch.cat([data, data.new_zeros(extra)])


def _byte(data, idx):
    return take(data, idx, U8_FILL).to(torch.int64)


def peek_lsb(data, positions, nbits: int):
    """LSB-first n-bit peek (n <= 24) at each bit position.

    data: uint8 tensor padded with >= 4 trailing bytes; positions: integer
    bit offsets. Returns the values as int64."""
    positions = positions.to(torch.int64)
    byte = positions >> 3
    sh = positions & 7
    word = (_byte(data, byte) | (_byte(data, byte + 1) << 8)
            | (_byte(data, byte + 2) << 16) | (_byte(data, byte + 3) << 24))
    return (word >> sh) & ((1 << nbits) - 1)


def peek_msb16(data, positions, nbits: int):
    """MSB-first n-bit peek (n <= 17) over 16-bit LE units (LZX order).

    Bit position p means: p bits have been consumed from the MSB side of
    the unit stream. Unit u = data[2u+1]<<8 | data[2u]."""
    positions = positions.to(torch.int64)
    unit = positions >> 4
    used = positions & 15

    def u16(k):
        return _byte(data, unit * 2 + k) | (_byte(data, unit * 2 + k + 1) << 8)

    u0, u1, u2 = u16(0), u16(2), u16(4)
    # a 32-bit window from the unit boundary, MSB first; consumed bits are
    # shifted out and refilled from u2
    win_hi = (u0 << 16) | u1
    win = ((win_hi << used) & 0xFFFFFFFF) | torch.where(
        used > 0, u2 >> (16 - used), torch.zeros_like(u2))
    return (win >> (32 - nbits)) & ((1 << nbits) - 1)


def bitrev_table(nbits: int):
    """numpy bit-reversal LUT for nbits-wide values (host-built once)."""
    n = 1 << nbits
    v = np.arange(n, dtype=np.uint32)
    r = np.zeros(n, dtype=np.uint32)
    for _ in range(nbits):
        r = (r << 1) | (v & 1)
        v >>= 1
    return r
