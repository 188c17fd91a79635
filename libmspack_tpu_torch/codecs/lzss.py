"""LZSS decoder (L2 codec) — SZDD / KWAJ / HLP / QBasic variants.

Format semantics (reference: libmspack/mspack/lzssd.c, lzss.h):

* 4 KiB ring window pre-filled with 0x20 (spaces).
* start position: 4096-16, or 4096-18 in QBASIC mode.
* control byte of 8 flags, LSB first; flag=1 -> literal byte,
  flag=0 -> match of (12-bit window position, 4-bit length+3).
* MSHELP mode inverts the control byte.
* the stream ends wherever input ends — mid-structure is fine; all
  bytes written so far stand.

This scalar implementation is the correctness reference; the batched
two-phase TPU path (control-byte parse -> parallel match resolution)
lives in libmspack_tpu.ops.lzss_jax.

Copied from ``libmspack_tpu/codecs/lzss.py`` so that the port imports nothing
of the JAX package; the copy differs in nothing else. The port's batched
device path is ``ops/lzss.py``.
"""
from __future__ import annotations

WINDOW_SIZE = 4096
WINDOW_FILL = 0x20

MODE_EXPAND = 0  # SZDD / KWAJ
MODE_MSHELP = 1  # .HLP topic blocks
MODE_QBASIC = 2  # QBasic 4.5 'SZ ' variant

_MODES = (MODE_EXPAND, MODE_MSHELP, MODE_QBASIC)


def decompress(data: bytes, mode: int = MODE_EXPAND, max_out: int | None = None) -> bytes:
    """Decode an LZSS stream from a byte buffer.

    `max_out` optionally truncates output (used by drivers that know the
    declared uncompressed length).
    """
    if mode not in _MODES:
        raise ValueError(f"bad LZSS mode {mode}")

    window = bytearray(bytes([WINDOW_FILL]) * WINDOW_SIZE)
    pos = WINDOW_SIZE - (18 if mode == MODE_QBASIC else 16)
    invert = 0xFF if mode == MODE_MSHELP else 0x00

    out = bytearray()
    i = 0
    n = len(data)
    mask_limit = WINDOW_SIZE - 1

    while True:
        if i >= n:
            break
        c = data[i] ^ invert
        i += 1
        for bit in range(8):
            if c & (1 << bit):
                if i >= n:
                    return _trim(out, max_out)
                b = data[i]
                i += 1
                window[pos] = b
                out.append(b)
                pos = (pos + 1) & mask_limit
            else:
                if i >= n:
                    return _trim(out, max_out)
                mpos = data[i]
                i += 1
                if i >= n:
                    return _trim(out, max_out)
                mpos |= (data[i] & 0xF0) << 4
                length = (data[i] & 0x0F) + 3
                i += 1
                for _ in range(length):
                    b = window[mpos]
                    window[pos] = b
                    out.append(b)
                    pos = (pos + 1) & mask_limit
                    mpos = (mpos + 1) & mask_limit
            if max_out is not None and len(out) >= max_out:
                return _trim(out, max_out)
    return _trim(out, max_out)


def _trim(out: bytearray, max_out: int | None) -> bytes:
    if max_out is not None and len(out) > max_out:
        del out[max_out:]
    return bytes(out)
