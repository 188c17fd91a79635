"""Frozen archive writers: the layouts of the program's
``compress/cab_c.py`` (``write_cab``) and ``compress/oab_c.py``
(``write_oab``), over the benchmark's own encoders (``encoders.py``).

Besides the archive, each writer returns the bytes that a codec's kernel
reads and writes for it: ``{codec: [compressed payload bytes, plaintext
bytes]}``. Those are the counts of the kernel rooflines, taken from the
archive and not from any trace the program makes.
"""
from __future__ import annotations

import dataclasses
import zlib

import numpy as np

from . import encoders

BLOCKMAX = 32768
INPUTMAX = BLOCKMAX + 6144            # CAB's largest CFDATA payload


@dataclasses.dataclass
class Folder:
    codec: str                        # none, mszip, lzx or quantum
    window_bits: int
    files: list                       # [(name, bytes)]


def cab_checksum(data: bytes, ck: int = 0) -> int:
    """The CFDATA block checksum (MS-CAB; cabd.c:1462-1479)."""
    full = len(data) & ~3
    if full:
        ck ^= int(np.bitwise_xor.reduce(
            np.frombuffer(data, np.uint8, full).view("<u4")))
    rem = data[full:]
    ul = 0
    for b in rem:
        ul = (ul << 8) | b
    return ck ^ ul


def encode_folder(folder: Folder) -> tuple[int, list]:
    """(CFFOLDER compression type, [(payload, plaintext size)])."""
    data = b"".join(d for _, d in folder.files)
    sizes = [min(BLOCKMAX, len(data) - i)
             for i in range(0, len(data), BLOCKMAX)]
    if folder.codec == "none":
        return 0, [(data[i * BLOCKMAX:(i + 1) * BLOCKMAX], s)
                   for i, s in enumerate(sizes)]
    if folder.codec == "mszip":
        return 1, list(zip(encoders.deflate_frames(data), sizes))
    if folder.codec == "quantum":
        payloads = encoders.qtm_encode(data, folder.window_bits)
        if any(len(p) > INPUTMAX for p in payloads):
            raise ValueError("Quantum block exceeds CAB's input limit")
        return 2 | (folder.window_bits << 8), list(zip(payloads, sizes))
    if folder.codec == "lzx":
        # a block's trees span up to 32 frames; where one frame then
        # codes past CAB's block limit (incompressible bytes under trees
        # built for text), the folder is coded a block a frame, each
        # frame with trees of its own, as a CAB writer must
        for block_frames in (32, 1):
            stream, offs = encoders.lzx_encode(data, folder.window_bits,
                                               block_frames=block_frames)
            ends = offs[1:] + [len(stream)]
            if all(b - a <= INPUTMAX for a, b in zip(offs, ends)):
                break
        else:
            raise ValueError("LZX frame exceeds CAB's input limit")
        return 3 | (folder.window_bits << 8), [
            (stream[a:b], s) for a, b, s in zip(offs, ends, sizes)]
    raise ValueError(f"unknown codec {folder.codec!r}")


def write_cab(folders: list[Folder], encoded=None) -> tuple[bytes, dict]:
    """One cabinet (version 1.3, no reserve, one set) and its kernel byte
    counts by codec; ``encoded``: each folder's ``encode_folder``, where the
    caller encoded them already."""
    if encoded is None:
        encoded = [encode_folder(f) for f in folders]
    counts: dict = {}
    for f, (_, blocks) in zip(folders, encoded):
        c = counts.setdefault(f.codec, [0, 0])
        c[0] += sum(len(p) for p, _ in blocks)
        c[1] += sum(s for _, s in blocks)
    date = ((2026 - 1980) << 9) | (8 << 5) | 17
    time = 12 << 11
    cffiles = bytearray()
    for fidx, f in enumerate(folders):
        offset = 0
        for name, data in f.files:
            cffiles += len(data).to_bytes(4, "little")
            cffiles += offset.to_bytes(4, "little")
            cffiles += fidx.to_bytes(2, "little")
            cffiles += date.to_bytes(2, "little")
            cffiles += time.to_bytes(2, "little")
            cffiles += (0x20).to_bytes(2, "little")
            cffiles += name.encode("latin-1") + b"\x00"
            offset += len(data)
    file_offset = 0x24 + 8 * len(folders)
    data_start = file_offset + len(cffiles)
    cfdata = bytearray()
    folder_offsets = []
    for _, blocks in encoded:
        folder_offsets.append(data_start + len(cfdata))
        for payload, size in blocks:
            if len(payload) > INPUTMAX:
                raise ValueError("CFDATA block exceeds CAB's input limit")
            tail = len(payload).to_bytes(2, "little") + \
                size.to_bytes(2, "little")
            ck = cab_checksum(tail, cab_checksum(payload, 0))
            cfdata += ck.to_bytes(4, "little") + tail + payload
    out = bytearray(b"MSCF")
    for v in (0, data_start + len(cfdata), 0, file_offset, 0):
        out += v.to_bytes(4, "little")
    out += bytes([3, 1])
    for v in (len(folders), sum(len(f.files) for f in folders), 0, 0x0622,
              0):
        out += v.to_bytes(2, "little")
    for (ct, blocks), off in zip(encoded, folder_offsets):
        out += off.to_bytes(4, "little")
        out += len(blocks).to_bytes(2, "little")
        out += ct.to_bytes(2, "little")
    return bytes(out + cffiles + cfdata), counts


def crc32_raw(data: bytes) -> int:
    """OAB's block CRC: CRC-32 from 0xFFFFFFFF with no final inversion."""
    return zlib.crc32(data) ^ 0xFFFFFFFF


def oab_block(chunk: bytes) -> bytes:
    """One compressed block of a full download: its header and one LZX
    DELTA stream, the window the smallest power of two from 2^17 that holds
    the block."""
    wb = 17
    while wb < 25 and (1 << wb) < len(chunk):
        wb += 1
    stream, _ = encoders.lzx_encode(chunk, wb, is_delta=True)
    head = b"".join(v.to_bytes(4, "little") for v in
                    (1, len(stream), len(chunk), crc32_raw(chunk)))
    return head + stream


def write_oab(blocks: list[bytes], block_max: int,
              target_size: int) -> bytes:
    """A version 3.1 full download from ``oab_block``'s blocks."""
    head = b"".join(v.to_bytes(4, "little")
                    for v in (3, 1, block_max, target_size))
    return head + b"".join(blocks)
