"""A seeded batch of Quantum streams that covers what K4 must get right:
windows 2^10, 2^11, 2^12, 2^16 and 2^21; matches that wrap the 1 KiB
window; a stream long enough (over 2400 selector decodes) that every
model's halving rescale and the selector's fifth-rescale exchange sort
fire; literal-heavy random data and runs of one byte; a multi-frame
stream whose 0xFF trailer scan skips padding bytes; streams that end
mid-frame; a request for 0 bytes; and corrupt streams (a match that
overshoots its frame, a stream cut short inside its second frame).

Two errors of the reference codec cannot be reached by any stream, so the
batch has no case for them: a selector above 6 (the selector model's
alphabet is 0-6) and an offset beyond the window (the position slots of
a window of 2^w bytes reach exactly 2^w back); for the same reason a
Quantum match never takes the ring-alias split that LZX matches can.

Streams come from the port's copy of the encoder (``compress/qtm_e``,
native or Python), one payload per 32 KiB frame, each followed by the
0xFF trailer the CAB reader injects (cabd.c:1327-1332). Each valid case's
bytes are the reference codec's (``codecs/qtm.py``) on the same stream.
The tests and ``chip_smoke.py`` feed this batch to K4 and to its plain
version.
"""
from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np
import torch

from .codecs.qtm import QtmDecompressor
from .compress import qtm_e
from .errors import MSPackError

FRAME = 32768
# small enough for one interpreted call of the TPU kernel in the tests
SMALL = 1500
# the small window-2^10 cases, at the head of the batch
SMALL_NAMES = ("w10_text", "w10_wrap", "w10_literal_heavy", "w10_rle")


@dataclass
class QtmCase:
    name: str
    stream: bytes
    out_len: int
    window_bits: int
    raw: bytes | None = None    # the reference codec's bytes; None: corrupt


def scalar_decode(stream, out_len, window_bits):
    """The reference codec's bytes in one request, or None on its error."""
    pos = [0]

    def rd(n):
        b = stream[pos[0]:pos[0] + n]
        pos[0] += len(b)
        return b

    out = bytearray()
    try:
        QtmDecompressor(rd, window_bits).decompress(out_len, out.extend)
    except MSPackError:
        return None
    return bytes(out)


def folder_stream(payloads, pad=None):
    """A CAB folder's stream: each frame payload and its 0xFF trailer;
    ``pad`` maps a frame index to bytes put between payload and trailer."""
    pad = pad or {}
    return b"".join(p + pad.get(i, b"") + b"\xff"
                    for i, p in enumerate(payloads))


def encode(data, window_bits):
    return folder_stream(qtm_e.compress(data, window_bits))


def in_repo_text(n):
    """Text of this package's own sources, repeated to n bytes."""
    here = os.path.dirname(os.path.abspath(__file__))
    parts = []
    for name in ("codecs/qtm.py", "compress/qtm_e.py", "csrc/qtm_core.cuh"):
        with open(os.path.join(here, name), "rb") as fh:
            parts.append(fh.read())
    text = b"".join(parts)
    return (text * (1 + n // len(text)))[:n]


def overshoot_stream():
    """One frame of 32766 literals, then a length-3 match: the match
    overshoots the frame end (codecs/qtm.py:329-330)."""
    enc = qtm_e.QtmEncoder(16)
    coder = qtm_e._FrameCoder()
    for k in range(FRAME - 2):
        enc._encode_literal(coder, k & 0x3F)
    assert enc._encode_match(coder, 3, 1)
    return folder_stream([coder.finish()])


def qtm_edge_batch(seed=0, big=1 << 17):
    """The cases, valid ones first, ``SMALL_NAMES`` at the head. ``big``
    sizes the larger encoder-made streams (the smoke run passes more)."""
    rng = np.random.RandomState(seed)
    cases = []

    def add(name, stream, out_len, wb, valid=True):
        raw = scalar_decode(stream, out_len, wb)
        if valid and raw is None:
            raise AssertionError(f"{name}: the reference codec rejects it")
        if not valid and raw is not None:
            raise AssertionError(f"{name}: the reference codec accepts it")
        cases.append(QtmCase(name, stream, out_len, wb, raw))

    # window 2^10, small: one interpreted TPU-kernel call in the tests
    text = in_repo_text(4 * big)
    add("w10_text", encode(text[:SMALL], 10), SMALL, 10)
    period = bytes(rng.randint(0, 256, 300, np.uint8))
    wrap = (period * 6)[:SMALL]
    add("w10_wrap", encode(wrap, 10), SMALL, 10)
    noise = bytes(rng.randint(0, 256, SMALL, np.uint8))
    add("w10_literal_heavy", encode(noise, 10), SMALL, 10)
    add("w10_rle", encode(b"\x5a" * SMALL, 10), SMALL, 10)

    # windows 2^11, 2^12, 2^16 and 2^21; streams that end mid-frame
    add("w11_text", encode(text[:9000], 11), 9000, 11)
    add("w12_mixed", encode(text[:5000] + noise + text[:5000], 12),
        10000 + SMALL, 12)
    add("w16_text", encode(text[:big], 16), big, 16)
    add("w21_text", encode(text[:big + 777], 21), big + 777, 21)
    # the 1 KiB window wrapped many times over several frames
    add("w10_wrap_frames", encode(text[:3 * FRAME + 100], 10),
        3 * FRAME + 100, 10)
    # over 2400 selector decodes of mostly literals: the halving rescale
    # and the fifth-rescale exchange sort fire in every model they reach
    many = bytes(rng.randint(0, 256, 4000, np.uint8)) + text[:8000]
    add("rescales", encode(many, 12), len(many), 12)
    # a trailer scan that skips padding bytes after each payload
    two = text[:2 * FRAME + 5000]
    add("trailer_padding", folder_stream(qtm_e.compress(two, 16),
                                         {0: b"\0\0\0", 1: b"\x01"}),
        len(two), 16)
    add("empty_request", cases[-1].stream, 0, 16)

    # corrupt streams
    add("frame_overshoot", overshoot_stream(), FRAME + 1, 16, valid=False)
    payloads = qtm_e.compress(two, 16)
    cut = folder_stream(payloads)[:len(payloads[0]) + 1
                                  + len(payloads[1]) // 2]
    add("truncated", cut, len(two), 16, valid=False)
    return cases


def wrap_flush_files():
    """The files of a window-2^10 Quantum folder where the reference
    codec fails and a whole-folder decode does not: periodic data makes
    matches cross the window's lap ends at 1024 and 2048, and files end at
    1000 and 2020, inside those matches. Extracting the third file, the
    codec must deliver the whole lap mid-match while the request ends
    before it, and raises "window-wrap flush larger than request"
    (codecs/qtm.py:309-322); so do the later files' requests. Returns
    ``(files, window_bits)`` for a cabinet writer's ``FolderSpec``."""
    rng = np.random.RandomState(5)
    data = bytes(rng.randint(0, 256, 200, np.uint8)) * 15
    files, o = [], 0
    for i, n in enumerate((300, 450, 250, 1020, 980)):
        files.append((f"f{i}.bin", data[o:o + n]))
        o += n
    return files, 10


def groups(cases):
    """Lane indices grouped by window: one launch each."""
    out: dict = {}
    for i, c in enumerate(cases):
        out.setdefault(c.window_bits, []).append(i)
    return out


def inputs(cases):
    """K4's batch for the cases as CPU tensors: (streams, lens, target
    output sizes)."""
    from .ops.cuda_qtm import pack_streams

    s, lens = pack_streams([c.stream for c in cases])
    tg = torch.tensor([c.out_len for c in cases], dtype=torch.int32)
    return s, lens, tg


def resolve(cases, tok, litw, cnt):
    """Resolve each lane's trace with the engine's host phase B
    (``cuda_pipeline.resolve_lzx`` with no E8). ``cases`` share one
    window; ``tok``, ``litw``: int32 numpy ``(L, T)``; ``cnt``: the
    ``(8, L)`` counts. Returns a list of bytes, or None where the lane is
    flagged or the resolver fails."""
    from .parallel.cuda_pipeline import resolve_lzx

    wb = cases[0].window_bits
    out = []
    for i, c in enumerate(cases):
        if cnt[0, i] != 0 or cnt[1, i] != c.out_len:
            out.append(None)
            continue
        got = resolve_lzx(tok[i:i + 1], litw[i:i + 1], [c.out_len], [0],
                          [0], wb, n_threads=1)
        out.append(None if got is None else got[0].tobytes())
    return out
