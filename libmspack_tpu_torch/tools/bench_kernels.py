"""Per-kernel numbers on the card: the port of ``tools/bench_kernels.py``.

    python -m libmspack_tpu_torch.tools.bench_kernels [--out PATH]

Runs the four kernels' bench entries at the JAX package's shapes
(``cuda_inflate.bench_entry``: K1 on 1024 frames of 32 KiB;
``cuda_resolve``: K2 on 256 frames; ``cuda_lzx``: K3 on 1024 chunks of
64 KiB at window 2^16; ``cuda_qtm``: K4 on 1024 streams of 24 KiB at
2^15), prints one JSON line per entry, then one JSON object with the
card's name and power limit and every entry. It writes a file only where
``--out`` names one. An entry that raises stops the run: on the card a
failing kernel is never recorded as an error field and passed over.
It needs a card: the plain versions, Python decoders, would take minutes
at these shapes (``bench_entry(..., device="cpu")`` runs them small).
"""
from __future__ import annotations

import argparse
import json
import sys

from .._device import resolve_device

ENTRIES = ("cuda_inflate", "cuda_resolve", "cuda_lzx", "cuda_qtm")


def run(device="cuda") -> list[dict]:
    """Each module of ``ENTRIES`` as ``ops.<module>.bench_entry(device=
    device)``, printed as it finishes."""
    import importlib

    out = []
    for name in ENTRIES:
        mod = importlib.import_module(f"libmspack_tpu_torch.ops.{name}")
        e = mod.bench_entry(device=device)
        print(json.dumps(e), flush=True)
        out.append(e)
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(prog="bench_kernels")
    ap.add_argument("--out", help="also write the JSON object there")
    args = ap.parse_args(argv)
    from .timing import card_line
    dev = resolve_device("cuda")
    name, _, limit = card_line().partition(", ")
    doc = {"device": name, "power_limit": limit,
           "generated_by": "python -m libmspack_tpu_torch.tools."
                           "bench_kernels",
           "entries": run(dev)}
    print(json.dumps(doc))
    if args.out:
        with open(args.out, "w") as fh:
            json.dump(doc, fh, indent=1)
    return doc


if __name__ == "__main__":
    main(sys.argv[1:])
