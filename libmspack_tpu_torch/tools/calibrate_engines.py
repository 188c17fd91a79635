"""Measure per-engine end-to-end decode rates on THIS host and write
libmspack_tpu_torch/calibration.json for workload-aware auto routing
(utils.choose_engine).

The CUDA kernels decode a corpus's folders many at once, but end to end
the host work around them and the host<->device link decide, and the
answer differs by codec. This tool measures, rather than assumes: it
times ``planner.extract_corpus`` under ``engine="native"`` and
``engine="cuda"`` on MSZIP, LZX (window 2^21) and Quantum (window 2^16)
corpora of one 1 MiB folder per cabinet, at two workload sizes, and
records per codec the crossover workload (null = CUDA never wins here).

    python -m libmspack_tpu_torch.tools.calibrate_engines [--out PATH]
        [--dry] [--sizes MIB ...]

``--dry`` prints the JSON and writes nothing; ``--sizes`` gives the
workloads in MiB (4 and 24 by default). Without a GPU the CUDA rates are
null.

Copied from ``tools/calibrate_engines.py``. Besides the imports: every
codec of the port's ``"cuda"`` planner is measured (the JAX tool measures
MSZIP, the only codec its ``"tpu"`` planner puts on the device), on a
corpus of many cabinets, built with the port's ``compress/`` from
``utils.build_corpus``'s bytes (``bench.py``'s); ``--out`` names the file
and ``--sizes`` the workloads.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

from .. import utils

SIZES_MB = (4, 24)
FOLDER_BYTES = 1 << 20
# codec -> (cab_c compression, window bits)
SETTINGS = {"mszip": ("mszip", 16), "lzx": ("lzx", 21),
            "quantum": ("quantum", 16)}


def build_cabinets(directory, codec, total, folder=FOLDER_BYTES):
    """``total`` bytes of ``utils.build_corpus`` as cabinets of one
    ``folder``-byte ``codec`` folder each, written into ``directory``;
    returns their paths. The encoders run on threads (they leave the
    interpreter lock)."""
    from concurrent.futures import ThreadPoolExecutor

    from ..compress import cab_c

    corpus = utils.build_corpus(total)
    comp, wb = SETTINGS[codec]

    def one(i):
        path = os.path.join(directory, f"cal_{codec}_{total}_{i:04d}.cab")
        blob = cab_c.write_cab(folders=[cab_c.FolderSpec(
            [(f"f{i}.bin", corpus[i * folder:(i + 1) * folder])], comp, wb)])
        with open(path, "wb") as fh:
            fh.write(blob)
        return path

    with ThreadPoolExecutor(min(8, os.cpu_count() or 1)) as pool:
        return list(pool.map(one, range((total + folder - 1) // folder)))


def _time_engine(paths, engine, reps=3):
    """(best MB/s of ``reps`` runs, output bytes)."""
    from ..parallel import planner
    best = None
    for _ in range(reps):
        t0 = time.perf_counter()
        outs = planner.extract_corpus(paths, engine=engine, strict=True)
        dt = time.perf_counter() - t0
        best = dt if best is None else min(best, dt)
    total = sum(len(b) for files in outs for b in files.values())
    return total / best / 1e6, total


def calibrate(sizes_mb=SIZES_MB, reps=3) -> dict:
    """The calibration table (``utils.engine_calibration``'s schema plus
    the measured ``rows``)."""
    import torch
    have_cuda = torch.cuda.is_available()
    cal = {"host": os.uname().nodename,
           "device": torch.cuda.get_device_name(0) if have_cuda else None}
    rows = []
    with tempfile.TemporaryDirectory() as td:
        for codec in SETTINGS:
            for mb in sizes_mb:
                paths = build_cabinets(td, codec, int(mb * (1 << 20)))
                nat, total = _time_engine(paths, "native", reps)
                cuda = None
                if have_cuda:
                    cuda, _ = _time_engine(paths, "cuda", reps)
                rows.append({"codec": codec, "bytes": total,
                             "cabinets": len(paths), "native_mb_s": nat,
                             "cuda_mb_s": cuda})
                print(f"# {codec} {mb} MiB: native {nat:.1f} MB/s, cuda "
                      f"{cuda if cuda else float('nan'):.1f} MB/s",
                      file=sys.stderr)
    cal["rows"] = rows
    cal["native_mb_s"], cal["cuda_mb_s_large"] = {}, {}
    cal["cuda_crossover_bytes"] = {}
    for codec in SETTINGS:
        mine = [r for r in rows if r["codec"] == codec]
        cal["native_mb_s"][codec] = mine[-1]["native_mb_s"]
        cal["cuda_mb_s_large"][codec] = mine[-1]["cuda_mb_s"]
        # crossover: smallest measured workload where the CUDA path wins;
        # null when it never does
        cal["cuda_crossover_bytes"][codec] = next(
            (r["bytes"] for r in mine
             if r["cuda_mb_s"] and r["cuda_mb_s"] > r["native_mb_s"]), None)
    return cal


def main(argv=None):
    p = argparse.ArgumentParser(prog="calibrate_engines")
    p.add_argument("--out", default=utils.CALIBRATION_PATH,
                   help="where to write the JSON")
    p.add_argument("--dry", action="store_true",
                   help="print the JSON, write nothing")
    p.add_argument("--sizes", type=float, nargs="+", default=SIZES_MB,
                   help="workloads in MiB")
    args = p.parse_args(argv)
    cal = calibrate(args.sizes)
    print(json.dumps(cal))
    if not args.dry:
        with open(args.out, "w") as fh:
            json.dump(cal, fh, indent=1)
        print(f"wrote {args.out}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
