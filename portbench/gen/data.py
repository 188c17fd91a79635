"""Seeded plaintext for the benchmark's archives.

Each file is drawn as a run of segments, each segment of one kind:

* ``text``: words of a seeded word list, Zipf-distributed, with spaces,
  punctuation and line breaks (documentation, INF and manifest files,
  address-book names);
* ``records``: fixed-width little-endian binary records whose fields take
  few values (tables, indexes, property records);
* ``noise``: the bench corpus's low-entropy noise (2 KiB of values below 64,
  repeated four times) and byte ramps;
* ``random``: incompressible bytes (resources that were compressed before
  they were packed: images, signatures, certificates).

A configuration gives the share of each kind under ``assumed.mix``; the
segment sizes are drawn between ``assumed.segment_bytes``. The same seed
and stream index give the same bytes on any host.
"""
from __future__ import annotations

import numpy as np

KINDS = ("text", "records", "noise", "random")
_WORDS = 4096
_PUNCT = np.frombuffer(b"     .,\n", np.uint8)


def rng_for(seed: int, *stream: int) -> np.random.Generator:
    """An independent generator for (seed, stream...): files drawn in any
    order, on any thread, get the same bytes."""
    return np.random.Generator(np.random.PCG64(
        np.random.SeedSequence([seed & (2**63 - 1), *stream])))


class Vocabulary:
    """A seeded word list: 4096 words of 2-12 lowercase letters, most
    frequent first. The words' lengths are the same for every seed, their
    letters are the seed's."""

    def __init__(self, seed: int):
        lens = rng_for(0, 0x70CAB).integers(2, 13, _WORDS)
        letters = rng_for(seed, 0x70CAB).integers(
            ord("a"), ord("z") + 1, int(lens.sum()), dtype=np.uint8)
        self.blob = letters
        self.starts = np.concatenate([[0], np.cumsum(lens)[:-1]])
        self.lens = lens
        p = 1.0 / np.arange(1, _WORDS + 1)
        self.p = p / p.sum()


def _text(rng, n: int, vocab: Vocabulary) -> np.ndarray:
    words = rng.choice(_WORDS, size=n // 4 + 8, p=vocab.p)
    lens = vocab.lens[words] + 1
    ends = np.cumsum(lens)
    keep = int(np.searchsorted(ends, n)) + 1
    words, lens = words[:keep], lens[:keep]
    total = int(lens.sum())
    out = np.empty(total, np.uint8)
    # each word's letters, then one separator byte
    starts = np.concatenate([[0], np.cumsum(lens)[:-1]])
    idx = np.arange(total) - np.repeat(starts, lens)
    src = np.repeat(vocab.starts[words], lens) + idx
    is_sep = idx == np.repeat(lens - 1, lens)
    out[~is_sep] = vocab.blob[src[~is_sep]]
    out[is_sep] = _PUNCT[rng.integers(0, len(_PUNCT), int(is_sep.sum()))]
    return out[:n]


def _records(rng, n: int) -> np.ndarray:
    """32-byte records: an increasing id, a type of 8, a small count, two
    flag bytes, an increasing timestamp, a code of 32, an offset in 4 KiB
    pages, a small field and a reference to a recent record."""
    k = n // 32 + 1
    rec = np.zeros(k, dtype=[("id", "<u4"), ("type", "<u2"),
                             ("count", "<u2"), ("flags", "u1", 2),
                             ("pad", "<u2"), ("time", "<u4"),
                             ("a", "<u4"), ("b", "<u4"), ("c", "<u2"),
                             ("ref", "<u4"), ("end", "<u2")])
    base = int(rng.integers(0, 1 << 20))
    rec["id"] = base + np.arange(k)
    rec["type"] = rng.integers(0, 8, k)
    rec["count"] = rng.integers(0, 16, k)
    rec["flags"] = rng.integers(0, 4, (k, 2))
    rec["time"] = 0x60000000 + np.sort(rng.integers(0, 1 << 16, k))
    rec["a"] = rng.integers(0, 32, k) * 37 + 1000
    rec["b"] = rng.integers(0, 16, k) * 4096
    rec["c"] = rng.integers(0, 3, k)
    rec["ref"] = rec["id"] - rng.integers(1, 64, k)
    rec["end"] = 0xFFFF
    return rec.view(np.uint8)[:n]


def _noise(rng, n: int) -> np.ndarray:
    """Alternating 8 KiB of the bench corpus's noise (2 KiB below 64,
    repeated four times) and 8 KiB of byte ramps."""
    parts, got = [], 0
    while got < n:
        noise = rng.integers(0, 64, 2048, dtype=np.uint8)
        parts += [np.tile(noise, 4), np.tile(np.arange(256, dtype=np.uint8),
                                              32)]
        got += 16384
    return np.concatenate(parts)[:n]


def file_bytes(seed: int, stream: tuple, n: int, mix: dict,
               segment_bytes: tuple, vocab: Vocabulary) -> bytes:
    """``n`` bytes of segments, their kinds in the shares of ``mix``. The
    kinds and sizes of a stream's segments are the same for every seed
    (drawn from ``stream`` alone), so every seed asks the same work of
    the decoders; the seed orders them and draws their bytes."""
    shape = rng_for(0, *stream)
    kinds = [k for k in KINDS if mix.get(k, 0) > 0]
    p = np.array([mix[k] for k in kinds], float)
    p /= p.sum()
    lo, hi = segment_bytes
    segments, total = [], 0
    while total < n:
        size = min(int(shape.integers(lo, hi + 1)), n - total)
        segments.append((kinds[int(shape.choice(len(kinds), p=p))], size))
        total += size
    rng = rng_for(seed, *stream)
    out = np.empty(n, np.uint8)
    pos = 0
    for j in rng.permutation(len(segments)):
        kind, size = segments[j]
        if kind == "text":
            seg = _text(rng, size, vocab)
        elif kind == "records":
            seg = _records(rng, size)
        elif kind == "noise":
            seg = _noise(rng, size)
        else:
            seg = np.frombuffer(rng.bytes(size), np.uint8)
        out[pos:pos + size] = seg
        pos += size
    return out.tobytes()
