"""LZSS compressor (greedy) + SZDD/KWAJ container writers.

The reference ships only compressor *stubs* (reference: szddc.c,
kwajc.c, system.c:39-48 returns version 0 for all encoders); this
implementation exceeds reference capability. Output is decodable by the
reference decoder (verified by the oracle round-trip tests).

Encoding is the exact dual of codecs/lzss.py: 4 KiB ring window
pre-seeded with 0x20, start position 4096-16 (EXPAND) or 4096-18
(QBASIC); control byte of 8 LSB-first flags; literal (flag=1) or match
(flag=0) = 12-bit absolute window position + 4-bit length-3.

Copied from ``libmspack_tpu/compress/lzss_c.py`` so that the port imports
nothing of the JAX package; the copy differs in nothing else.
"""
from __future__ import annotations

from ..codecs.lzss import (MODE_EXPAND, MODE_MSHELP, MODE_QBASIC, WINDOW_FILL,
                           WINDOW_SIZE)

MIN_MATCH = 3
MAX_MATCH = 18
_MASK = WINDOW_SIZE - 1


def compress(data: bytes, mode: int = MODE_EXPAND) -> bytes:
    """Greedy LZSS encode of `data`."""
    window = bytearray(bytes([WINDOW_FILL]) * WINDOW_SIZE)
    pos = WINDOW_SIZE - (18 if mode == MODE_QBASIC else 16)
    invert = 0xFF if mode == MODE_MSHELP else 0x00

    out = bytearray()
    i = 0
    n = len(data)

    # map from byte value -> list of window positions (simple index)
    heads: list[list[int]] = [[] for _ in range(256)]
    for w in range(WINDOW_SIZE):
        heads[WINDOW_FILL].append(w)

    def window_put(b: int) -> None:
        nonlocal pos
        old = window[pos]
        lst = heads[old]
        # cheap removal: positions are appended in increasing write order;
        # stale entries are filtered at match time instead
        window[pos] = b
        heads[b].append(pos)
        if len(lst) > 64:
            del lst[0 : len(lst) - 64]
        pos = (pos + 1) & _MASK

    def find_match(at: int) -> tuple[int, int]:
        """Return (window_pos, length>=MIN_MATCH) or (-1, 0)."""
        if at + MIN_MATCH > n:
            return -1, 0
        first = data[at]
        best_len = 0
        best_pos = -1
        limit = min(MAX_MATCH, n - at)
        for cand in reversed(heads[first][-64:]):
            if window[cand] != first:
                continue  # stale
            # never allow the match to read bytes at/after current write
            # position; byte-serial decode overlap with `pos` itself is
            # legal LZ77 but we keep the encoder conservative
            length = 1
            while length < limit:
                w = (cand + length) & _MASK
                if w == pos:
                    break
                if window[w] != data[at + length]:
                    break
                length += 1
            if length > best_len:
                best_len = length
                best_pos = cand
                if length == limit:
                    break
        if best_len >= MIN_MATCH:
            return best_pos, best_len
        return -1, 0

    while i < n:
        flags = 0
        unit = bytearray()
        for bit in range(8):
            if i >= n:
                break
            mpos, mlen = find_match(i)
            if mlen >= MIN_MATCH:
                unit.append(mpos & 0xFF)
                unit.append(((mpos >> 4) & 0xF0) | (mlen - MIN_MATCH))
                for _ in range(mlen):
                    window_put(data[i])
                    i += 1
            else:
                flags |= 1 << bit
                unit.append(data[i])
                window_put(data[i])
                i += 1
        out.append(flags ^ invert)
        out.extend(unit)
    return bytes(out)


def szdd_compress(data: bytes, missing_char: int = 0) -> bytes:
    """Produce a complete SZDD file (normal EXPAND variant)."""
    header = (bytes([0x53, 0x5A, 0x44, 0x44, 0x88, 0xF0, 0x27, 0x33, 0x41,
                     missing_char])
              + len(data).to_bytes(4, "little"))
    return header + compress(data, MODE_EXPAND)


def kwaj_compress(data: bytes, method: int = 2, filename: str | None = None,
                  include_length: bool = True) -> bytes:
    """Produce a complete KWAJ file using method 0 (none), 1 (xor),
    2 (SZDD-LZSS, QBASIC window offsets), or 4 (MSZIP)."""
    flags = 0
    opt = b""
    if include_length:
        flags |= 0x01
        opt += len(data).to_bytes(4, "little")
    if filename:
        name, _, ext = filename.partition(".")
        if name:
            flags |= 0x08
            opt += name.encode("latin-1")[:8] + b"\x00"
        if ext:
            flags |= 0x10
            opt += ext.encode("latin-1")[:3] + b"\x00"
    data_offset = 14 + len(opt)
    header = (bytes([0x4B, 0x57, 0x41, 0x4A, 0x88, 0xF0, 0x27, 0xD1])
              + method.to_bytes(2, "little")
              + data_offset.to_bytes(2, "little")
              + flags.to_bytes(2, "little") + opt)
    if method == 0:
        body = data
    elif method == 1:
        body = bytes(b ^ 0xFF for b in data)
    elif method == 2:
        body = compress(data, MODE_QBASIC)
    elif method == 4:
        from . import mszip_c
        body = mszip_c.compress_kwaj(data)
    else:
        raise ValueError("kwaj_compress supports methods 0-2 and 4")
    return header + body
