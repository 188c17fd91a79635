"""Exchange Offline Address Book full downloads ([MS-OXOAB], version 3.1):
the configuration's plaintext size in blocks of ``block_max`` bytes, each
block one LZX DELTA stream."""
from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor

from ..gen import Item, archives, data


def build(config, traffic, seed: int, threads: int) -> list:
    assumed = config["assumed"]
    vocab = data.Vocabulary(seed)
    mix, seg = assumed["mix"], tuple(assumed["segment_bytes"])
    size, block = config["target_bytes"], config["block_max"]
    nblocks = -(-size // block)

    def one(job):
        item, b = job
        n = min(block, size - b * block)
        chunk = data.file_bytes(seed, (2, item, b), n, mix, seg, vocab)
        return chunk, archives.oab_block(chunk)

    jobs = [(i, b) for i in range(traffic["pool_items"])
            for b in range(nblocks)]
    with ThreadPoolExecutor(threads) as pool:
        done = list(pool.map(one, jobs))
    items = []
    for i in range(traffic["pool_items"]):
        part = done[i * nblocks:(i + 1) * nblocks]
        plain = b"".join(c for c, _ in part)
        blocks = [blk for _, blk in part]
        stream_bytes = sum(len(blk) - 16 for blk in blocks)
        items.append(Item([archives.write_oab(blocks, block, size)],
                          [{"oab": plain}],
                          {"lzx": [stream_bytes, len(plain)]}))
    return items
