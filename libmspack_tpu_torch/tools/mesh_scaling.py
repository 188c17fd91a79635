"""Scaling curve of the sharded cabinet decode: the port of
``tools/mesh_scaling.py``.

    python -m libmspack_tpu_torch.tools.mesh_scaling [--sizes 1,2,4,8]
                                                     [--out PATH]

Decodes the JAX tool's cabinet (4 MSZIP folders of 64 KiB of seeded
text: 8 frames) with ``mesh.decode_cab_sharded`` over groups of 1, 2, 4
and 8 ranks (``multihost.spawn``), each run checked bit-exact, and
reports the best of two timed runs per size: ``seconds`` (the slowest
rank's, between ``torch.cuda.synchronize`` calls inside the ranks, so
process start is not counted), ``mb_per_s``, ``speedup`` and
``efficiency``. Every rank first decodes the cabinet once under
``ops/shadow.active()``, which holds each K1 launch to its plain version
on the same inputs; the timed runs repeat those inputs.

A group uses NCCL where every rank has a card of its own, else gloo; each
row says whether its ranks shared a card. Ranks that share one card (or
the CPU) measure the communication pattern, not scaling: they take turns
on one device. Prints the JSON object; writes a file only to ``--out``.
"""
from __future__ import annotations

import argparse
import json
import random
import sys
import time

import torch

from .._device import resolve_device


def cabinet():
    """``(cabinet bytes, {member: bytes})``: ``tools/mesh_scaling.py:38-
    57``'s cabinet."""
    from ..compress import cab_c

    rng = random.Random(7)
    text = (b"The quick brown fox jumps over the lazy dog. " * 60
            + bytes(rng.randrange(64) for _ in range(2048)))
    folder_blob = (text * ((64 << 10) // len(text) + 1))[:64 << 10]
    folders, expects = [], {}
    for k in range(4):
        name = f"f{k}.bin"
        folders.append(cab_c.FolderSpec([(name, folder_blob)], "mszip"))
        expects[name] = folder_blob
    return cab_c.write_cab(folders=folders), expects


def _rank(dev, cab_bytes, expects, reps):
    """One rank: a shadow-checked decode, then ``reps`` timed ones."""
    from ..entry import _launches
    from ..ops import shadow
    from ..parallel import mesh as pmesh

    m = pmesh.default_mesh(device=dev)
    with shadow.active() as errs:
        ok = pmesh.decode_cab_sharded(m, cab_bytes) == expects
    best = float("inf")
    for _ in range(reps):
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        out = pmesh.decode_cab_sharded(m, cab_bytes)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        best = min(best, time.perf_counter() - t0)
        ok = ok and out == expects
    return {"bit_exact": bool(ok), "seconds": best,
            "launches": _launches(), "declines": dict(m.declines),
            "max_abs_err": dict(errs)}


def run(sizes=(1, 2, 4, 8), device="cuda", timeout_s: float = 600.0) -> dict:
    """The scaling rows at each world size of ``sizes``; raises where a
    rank is not bit-exact or the mesh declines. The result also holds the
    kernels' launches summed over every rank and size (``"launches"``)
    and their largest differences from the plain versions
    (``"max_abs_err"``)."""
    from ..entry import _build_first, _merge_errs
    from ..parallel import multihost

    dev = resolve_device(device)
    _build_first(dev)
    cab_bytes, expects = cabinet()
    total = sum(len(v) for v in expects.values())
    print(f"# cab: {len(expects)} mszip folders, {total / 1e6:.1f} MB out, "
          f"{len(cab_bytes) / 1e6:.1f} MB in", file=sys.stderr, flush=True)
    cards = torch.cuda.device_count() if dev.type == "cuda" else 0
    rows, launches, errs = [], {}, {}
    for n in sizes:
        own = dev.type == "cuda" and n <= cards
        backend = "nccl" if own else "gloo"
        ranks = multihost.spawn(_rank, n, backend, dev.type,
                                args=(cab_bytes, expects, 2),
                                timeout_s=timeout_s)
        bad = [r for r, res in enumerate(ranks)
               if not res["bit_exact"] or res["declines"]]
        if bad:
            raise AssertionError(f"mesh_scaling at {n} ranks: ranks {bad} "
                                 f"not bit-exact or declined: "
                                 f"{[ranks[r] for r in bad]}")
        for res in ranks:
            for k, c in res["launches"].items():
                tot = launches.setdefault(k, {})
                for key, v in c.items():
                    tot[key] = tot.get(key, 0) + v
            _merge_errs(errs, res["max_abs_err"])
        best = max(res["seconds"] for res in ranks)
        rows.append({"devices": n, "backend": backend,
                     "shared_card": (not own) if dev.type == "cuda" else None,
                     "seconds": best, "mb_per_s": total / best / 1e6})
        print(f"# {n} ranks on {backend}: {best:.4f}s "
              f"({total / best / 1e6:.1f} MB/s)", file=sys.stderr,
              flush=True)
    base = rows[0]["seconds"]
    for r in rows:
        r["speedup"] = base / r["seconds"]
        r["efficiency"] = base / r["seconds"] / r["devices"]
    if dev.type == "cuda":
        note = (f"{cards} card(s); ranks beyond the card count share a "
                "card over gloo and measure the communication pattern, "
                "not scaling")
    else:
        note = ("CPU ranks (plain versions): the rows measure the "
                "communication pattern, not device scaling")
    return {"note": note, "device": _device_name(dev),
            "corpus_mb": total / 1e6, "bit_exact": True, "rows": rows,
            "launches": launches, "max_abs_err": errs}


def _device_name(dev) -> str:
    if dev.type != "cuda":
        return "cpu"
    from .timing import card_line
    return card_line()


def main(argv=None, device="cuda") -> dict:
    ap = argparse.ArgumentParser(prog="mesh_scaling")
    ap.add_argument("--sizes", default="1,2,4,8",
                    help="world sizes, comma-separated")
    ap.add_argument("--out", help="also write the JSON object there")
    args = ap.parse_args(argv)
    doc = run(tuple(int(s) for s in args.sizes.split(",")), device)
    print(json.dumps(doc))
    if args.out:
        with open(args.out, "w") as fh:
            json.dump(doc, fh, indent=1)
    return doc


if __name__ == "__main__":
    main(sys.argv[1:])
