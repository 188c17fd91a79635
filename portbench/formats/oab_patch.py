"""Exchange Offline Address Book incremental patches ([MS-OXOAB], version
3.2; reference decoder libmspack oabd.c:234-373).

Each item's base is the configuration's plaintext in blocks of
``block_max`` bytes, drawn as ``oab``'s full downloads are; its target is
the base with ``assumed.edit_bytes`` bytes changed at a seeded offset in
every ``assumed.edit_every`` bytes (``edited``). The patch codes each
target block as one LZX DELTA stream whose reference data is the base
block at the same offset, so ``ulSourceSize`` = ``ulTargetSize``.

The layout is written here, from the specification, and not by the
program's ``compress/oab_c.py``: the header {3, 2, ulBlockMax,
ulSourceSize, ulTargetSize, ulSourceCRC, ulTargetCRC}, then each block's
{ulPatchSize, ulTargetSize, ulSourceSize, ulCRC} and its stream. The
reference loop reads block k's reference data from the base right after
block k-1's. The item's expected file is the target, made in numpy from
the base: the patch applied to the base gives it, whatever decodes it.
"""
from __future__ import annotations

import dataclasses
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from ..gen import Item, data, encoders
from ..gen.archives import crc32_raw


@dataclasses.dataclass
class PatchItem(Item):
    """An ``Item`` whose ``bases`` hold the base file of each patch in
    ``inputs``."""
    bases: list


def edited(base: bytes, rng, every: int, width: int) -> bytes:
    """``base`` with ``width`` bytes of ``rng``'s drawing at a seeded offset
    in each whole ``every`` bytes."""
    out = np.frombuffer(base, np.uint8).copy()
    n = len(out) // every
    starts = np.arange(n) * every + rng.integers(0, every - width + 1, n)
    at = (starts[:, None] + np.arange(width)).ravel()
    out[at] = rng.integers(0, 256, at.size, dtype=np.uint8)
    return out.tobytes()


def window_bits(ssize: int, dsize: int) -> int:
    """The block's LZX window: the smallest power of two from 2^17 that
    holds its reference data, rounded up to 32 KiB, and its output, as
    the reference decoder sizes it."""
    size = ((ssize + 32767) & ~32767) + dsize
    wb = 17
    while wb < 25 and (1 << wb) < size:
        wb += 1
    return wb


def patch_block(chunk: bytes, ref: bytes) -> bytes:
    """One block of a patch: its header and the LZX DELTA stream that
    gives ``chunk`` from the reference data ``ref``."""
    stream, _ = encoders.lzx_encode(chunk, window_bits(len(ref), len(chunk)),
                                    is_delta=True, ref=ref)
    head = b"".join(v.to_bytes(4, "little") for v in
                    (len(stream), len(chunk), len(ref), crc32_raw(chunk)))
    return head + stream


def write_patch(blocks: list[bytes], block_max: int, base: bytes,
                target: bytes) -> bytes:
    """A version 3.2 patch from ``patch_block``'s blocks."""
    head = b"".join(v.to_bytes(4, "little") for v in
                    (3, 2, block_max, len(base), len(target),
                     crc32_raw(base), crc32_raw(target)))
    return head + b"".join(blocks)


def build(config, traffic, seed: int, threads: int) -> list:
    assumed = config["assumed"]
    vocab = data.Vocabulary(seed)
    mix, seg = assumed["mix"], tuple(assumed["segment_bytes"])
    every, width = assumed["edit_every"], assumed["edit_bytes"]
    size, block = config["target_bytes"], config["block_max"]
    nblocks = -(-size // block)

    def one(job):
        item, b = job
        n = min(block, size - b * block)
        ref = data.file_bytes(seed, (5, item, b), n, mix, seg, vocab)
        chunk = edited(ref, data.rng_for(seed, 6, item, b), every, width)
        return ref, chunk, patch_block(chunk, ref)

    jobs = [(i, b) for i in range(traffic["pool_items"])
            for b in range(nblocks)]
    with ThreadPoolExecutor(threads) as pool:
        done = list(pool.map(one, jobs))
    items = []
    for i in range(traffic["pool_items"]):
        part = done[i * nblocks:(i + 1) * nblocks]
        base = b"".join(r for r, _, _ in part)
        target = b"".join(c for _, c, _ in part)
        blocks = [blk for _, _, blk in part]
        stream_bytes = sum(len(blk) - 16 for blk in blocks)
        items.append(PatchItem([write_patch(blocks, block, base, target)],
                               [{"oab": target}],
                               {"lzx": [stream_bytes, len(target)]},
                               [base]))
    return items
