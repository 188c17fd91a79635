"""Cabinets as makecab writes them (MS-CAB): the traffic's own layout
(``cabinets``), or ``archives_per_item`` cabinets that cycle over the
configuration's kinds of cabinet (``cabinets``); every folder filled from
the seed and split into files."""
from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor

from ..gen import Item, archives, data


def _layout(config, traffic, item: int) -> list:
    """The cabinets of one item of the pool: a list of folder lists. The
    configuration's kinds take turns over the pool's cabinets, so that a
    pool of one cabinet an item holds every kind too."""
    if "cabinets" in traffic:
        return traffic["cabinets"]
    kinds, per = config["cabinets"], traffic["archives_per_item"]
    return [kinds[(item * per + j) % len(kinds)] for j in range(per)]


def _split(n: int, files: int) -> list:
    """File sizes of a folder of n bytes: one file, or a first file of
    3/5 of the folder (+17, so no edge falls on a 32 KiB block) and the
    rest spread over the others."""
    if files == 1:
        return [n]
    first = n * 3 // 5 + 17
    rest = n - first
    sizes = [rest // (files - 1)] * (files - 1)
    sizes[-1] += rest - sum(sizes)
    return [first] + sizes


def build(config, traffic, seed: int, threads: int) -> list:
    assumed = config["assumed"]
    vocab = data.Vocabulary(seed)
    mix, seg = assumed["mix"], tuple(assumed["segment_bytes"])
    jobs = []        # (cabinet number, folder number, spec)
    layouts = [_layout(config, traffic, item)
               for item in range(traffic["pool_items"])]
    per = len(layouts[0])
    for item, layout in enumerate(layouts):
        for j, cabinet in enumerate(layout):
            c = item * per + j
            fi = 0
            for spec in cabinet:
                for _ in range(spec.get("count", 1)):
                    jobs.append((c, fi, spec))
                    fi += 1

    def one(job):
        c, fi, spec = job
        blob = data.file_bytes(seed, (1, c, fi), spec["bytes"], mix, seg,
                               vocab)
        files, at = [], 0
        for k, size in enumerate(_split(len(blob), spec.get("files", 2))):
            files.append((f"c{c:04d}_{spec['codec']}_{fi}_{k}.bin",
                          blob[at:at + size]))
            at += size
        folder = archives.Folder(spec["codec"],
                                 config["window_bits"][spec["codec"]], files)
        return c, fi, folder, archives.encode_folder(folder)

    # the largest folders first, so that no long encode starts last
    order = sorted(jobs, key=lambda j: -j[2]["bytes"])
    by_cab: dict = {}
    with ThreadPoolExecutor(threads) as pool:
        for c, fi, folder, enc in pool.map(one, order):
            by_cab.setdefault(c, []).append((fi, folder, enc))
    pool_items = []
    for item in range(traffic["pool_items"]):
        inputs, expected, kbytes = [], [], {}
        for c in range(item * per, (item + 1) * per):
            parts = sorted(by_cab[c], key=lambda p: p[0])
            folders = [f for _, f, _ in parts]
            cab, counts = archives.write_cab(folders,
                                             [e for _, _, e in parts])
            inputs.append(cab)
            expected.append(dict(kv for f in folders for kv in f.files))
            for codec, (r, w) in counts.items():
                kb = kbytes.setdefault(codec, [0, 0])
                kb[0] += r
                kb[1] += w
        pool_items.append(Item(inputs, expected, kbytes))
    return pool_items
