"""OAB writer (compress path) — full downloads and incremental patches.

The reference has no OAB compressor (reference: oabc.c stub). Blocks
use the entropy-coded LZX DELTA encoder (lzx_e) — incremental patches
reference the base file for real delta savings — or raw copies; CRCs
use the format's un-inverted CRC-32.

Copied from ``libmspack_tpu/compress/oab_c.py`` so that the port imports
nothing of the JAX package; the copy differs in nothing else.
"""
from __future__ import annotations

from ..formats.oab import crc32_raw
from . import lzx_e


def write_oab(data: bytes, block_size: int = 65536,
              compress: bool = True) -> bytes:
    """Build a v3.1 full-download OAB file."""
    out = bytearray()
    out += (3).to_bytes(4, "little")
    out += (1).to_bytes(4, "little")
    out += block_size.to_bytes(4, "little")
    out += len(data).to_bytes(4, "little")
    for i in range(0, max(len(data), 1), block_size):
        chunk = data[i : i + block_size]
        if not chunk and data:
            break
        if compress:
            wb = 17
            while wb < 25 and (1 << wb) < len(chunk):
                wb += 1
            stream, _ = lzx_e.compress(chunk, wb, is_delta=True)
            crc = crc32_raw(chunk)
            out += (1).to_bytes(4, "little")
            out += len(stream).to_bytes(4, "little")
            out += len(chunk).to_bytes(4, "little")
            out += crc.to_bytes(4, "little")
            out += stream
        else:
            out += (0).to_bytes(4, "little")
            out += len(chunk).to_bytes(4, "little")
            out += len(chunk).to_bytes(4, "little")
            out += crc32_raw(chunk).to_bytes(4, "little")
            out += chunk
    return bytes(out)


def write_oab_patch(target: bytes, base: bytes,
                    block_size: int = 65536) -> bytes:
    """Build a v3.2 incremental patch that produces `target` when applied
    to `base`. Uses stored LZX blocks (no cross-references into the base
    yet — correct output, no delta savings until the entropy encoder)."""
    out = bytearray()
    out += (3).to_bytes(4, "little")
    out += (2).to_bytes(4, "little")
    out += block_size.to_bytes(4, "little")
    out += len(base).to_bytes(4, "little")
    out += len(target).to_bytes(4, "little")
    out += crc32_raw(base).to_bytes(4, "little")
    out += crc32_raw(target).to_bytes(4, "little")
    bpos = 0
    for i in range(0, max(len(target), 1), block_size):
        chunk = target[i : i + block_size]
        if not chunk and target:
            break
        ssize = min(block_size, len(base) - bpos) if bpos < len(base) else 0
        ref = base[bpos : bpos + ssize]
        bpos += ssize
        wsz = ((ssize + 32767) & ~32767) + len(chunk)
        wb = 17
        while wb < 25 and (1 << wb) < wsz:
            wb += 1
        stream, _ = lzx_e.compress(chunk, wb, is_delta=True, ref_data=ref)
        out += len(stream).to_bytes(4, "little")
        out += len(chunk).to_bytes(4, "little")
        out += ssize.to_bytes(4, "little")
        out += crc32_raw(chunk).to_bytes(4, "little")
        out += stream
    return bytes(out)
