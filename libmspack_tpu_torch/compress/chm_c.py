"""CHM compressor / helpfile writer (compress path).

The reference documents a CHM compressor API but ships only a stub
(reference: chmc.c, mspack.h:1418-1568); this writer exceeds reference
capability. Produces ITSF v2 files: PMGL directory chunks with real
quickref entries, an entropy-coded LZX section 1 (lzx_e), and the four MSCompressed system files
(Content / ControlData / SpanInfo / ResetTable) that decoders need for
random access.

Copied from ``libmspack_tpu/compress/chm_c.py`` so that the port imports nothing
of the JAX package; the copy differs in nothing else.
"""
from __future__ import annotations

import functools
import struct

from ..formats.chm import (CONTENT_NAME, CONTROL_NAME, RTABLE_NAME,
                           SPANINFO_NAME, _compare)
from . import lzx_e

CHUNK_SIZE = 4096
FRAME_SIZE = 32768


def _u2(v):
    return v.to_bytes(2, "little")


def _u4(v):
    return (v & 0xFFFFFFFF).to_bytes(4, "little")


def _u8(v):
    return v.to_bytes(8, "little")


def _guid(s: str) -> bytes:
    a, b, c, d, e = s.split("-")
    return (struct.pack("<IHH", int(a, 16), int(b, 16), int(c, 16))
            + bytes.fromhex(d) + bytes.fromhex(e))


GUID1 = _guid("7C01FD10-7BAA-11D0-9E0C-00A0C922E6EC")
GUID2 = _guid("7C01FD11-7BAA-11D0-9E0C-00A0C922E6EC")
GUID3 = _guid("5D02926A-212E-11D0-9DF9-00A0C922E6EC")


def _encint(v: int) -> bytes:
    out = bytearray([v & 0x7F])
    v >>= 7
    while v:
        out.insert(0, 0x80 | (v & 0x7F))
        v >>= 7
    return bytes(out)


def _entry(name: bytes, section: int, offset: int, length: int) -> bytes:
    return (_encint(len(name)) + name + _encint(section)
            + _encint(offset) + _encint(length))


def _build_chunks(entries: list[bytes], density: int = 2) -> list[bytes]:
    """Pack directory entries into PMGL chunks with quickref offsets."""
    qr_density = 1 + (1 << density)
    chunks = []
    i = 0
    while i < len(entries) or not chunks:
        # fit as many entries as possible, leaving room for quickrefs
        group: list[bytes] = []
        size = 0
        while i < len(entries):
            e = entries[i]
            n = len(group) + 1
            qr_entries = (n + qr_density - 1) // qr_density
            overhead = 0x14 + 2 + 2 * max(0, qr_entries - 1)
            if size + len(e) + overhead > CHUNK_SIZE:
                break
            group.append(e)
            size += len(e)
            i += 1
        body = b"".join(group)
        n = len(group)
        qr_entries = (n + qr_density - 1) // qr_density
        # quickref offsets for M=1..qr_entries-1: entry M*qr_density's offset
        qr = bytearray()
        pos_of = []
        acc = 0
        for e in group:
            pos_of.append(acc)
            acc += len(e)
        for m in range(1, qr_entries):
            qr = bytearray(_u2(pos_of[m * qr_density])) + qr
        free = CHUNK_SIZE - 0x14 - len(body)
        chunk = (b"PMGL" + _u4(free) + _u4(0)
                 + _u4(0xFFFFFFFF) + _u4(0xFFFFFFFF)  # prev/next: fixed later
                 + body
                 + b"\x00" * (free - 2 - len(qr))
                 + bytes(qr)
                 + _u2(n))
        assert len(chunk) == CHUNK_SIZE
        chunks.append(chunk)
        if i >= len(entries):
            break
    # fix prev/next links
    fixed = []
    for idx, ch in enumerate(chunks):
        prev = idx - 1 if idx > 0 else 0xFFFFFFFF
        nxt = idx + 1 if idx + 1 < len(chunks) else 0xFFFFFFFF
        fixed.append(ch[:0x0C] + _u4(prev) + _u4(nxt) + ch[0x14:])
    return fixed


def write_chm(files: list[tuple[str, bytes]], window_bits: int = 16,
              reset_frames: int = 2, density: int = 2,
              language: int = 0x409) -> bytes:
    """Build a complete CHM with all member files LZX-compressed in
    section 1."""
    # section 1 content. The stream itself is padded out to a whole
    # reset interval: decoders round the ResetTable's "dishonest"
    # uncompressed length up to the next reset interval
    # (reference: chmd.c:1153-1157) and expect those frames to decode.
    content = b"".join(d for _, d in files)
    interval_bytes = reset_frames * FRAME_SIZE
    padded_len = max(interval_bytes,
                     (len(content) + interval_bytes - 1)
                     // interval_bytes * interval_bytes)
    padded = content + b"\x00" * (padded_len - len(content))
    stream, frame_offsets = lzx_e.compress(padded, window_bits,
                                           reset_interval=reset_frames)
    # ResetTable wants an entry per frame (byte offset into the stream);
    # only offsets at reset boundaries are valid decode entry points, but
    # the table carries every frame offset
    nframes = len(frame_offsets)

    rtable = (_u4(2) + _u4(nframes) + _u4(8) + _u4(0x28)
              + _u8(len(content)) + _u8(len(stream)) + _u4(FRAME_SIZE)
              + _u4(0)
              + b"".join(_u8(off) for off in frame_offsets))
    controldata = (_u4(0x18) + b"LZXC" + _u4(2)
                   + _u4(reset_frames)
                   + _u4((1 << window_bits) // FRAME_SIZE)
                   + _u4(0) + _u4(0))
    spaninfo = _u8(len(content))

    # section 0 layout: system files then nothing else
    sec0_files = [
        (CONTENT_NAME, stream),
        (CONTROL_NAME, controldata),
        (SPANINFO_NAME, spaninfo),
        (RTABLE_NAME, rtable),
    ]
    sec0_entries = []
    off = 0
    for name, data in sec0_files:
        sec0_entries.append((name.encode("latin-1"), 0, off, len(data)))
        off += len(data)
    sec0_data = b"".join(d for _, d in sec0_files)

    sec1_entries = []
    off = 0
    for name, data in files:
        sec1_entries.append((name.encode("latin-1"), 1, off, len(data)))
        off += len(data)

    all_entries = sec0_entries + sec1_entries
    all_entries.sort(key=functools.cmp_to_key(
        lambda a, b: _compare(a[0], b[0])))
    encoded = [_entry(*e) for e in all_entries]

    chunks = _build_chunks(encoded, density)

    hdr_len = 0x58
    hs0_len = 0x18
    hs1_len = 0x54
    dir_offset = hdr_len + hs0_len + hs1_len
    # note: the LZX stream lives inside sec0 as the Content system file
    total_len = dir_offset + CHUNK_SIZE * len(chunks) + len(sec0_data)

    hdr = (b"ITSF" + _u4(2) + _u4(hdr_len) + _u4(1) + _u4(0)
           + _u4(language) + GUID1 + GUID2
           + _u8(hdr_len) + _u8(hs0_len)
           + _u8(hdr_len + hs0_len) + _u8(hs1_len))
    hs0 = _u4(0x1FE) + _u4(0) + _u8(total_len) + _u4(0) + _u4(0)
    hs1 = (b"ITSP" + _u4(1) + _u4(hs1_len) + _u4(0x0A)
           + _u4(CHUNK_SIZE) + _u4(density) + _u4(1)
           + _u4(0xFFFFFFFF)              # no PMGI index root
           + _u4(0) + _u4(len(chunks) - 1)
           + _u4(0xFFFFFFFF) + _u4(len(chunks))
           + _u4(language) + GUID3
           + _u4(hs1_len) + _u4(0xFFFFFFFF) + _u4(0xFFFFFFFF)
           + _u4(0xFFFFFFFF))
    assert len(hdr) == hdr_len and len(hs0) == hs0_len and len(hs1) == hs1_len
    return hdr + hs0 + hs1 + b"".join(chunks) + sec0_data
