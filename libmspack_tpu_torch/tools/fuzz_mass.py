"""Mass-corpus fuzz runner: the reference's PROTOS-C10 discipline
(reference: test/cabd_c10) applied to the full driver stack.

Generates valid archives for every format, then sweeps thousands of
mutations (bit flips, truncations, splices, garbage) through
open+extract of the port's drivers on one engine (by default
``engine="cuda"`` on ``device="cuda"``: the CUDA kernels). Pass criteria:
every archive either extracts or raises a clean MSPackError — no crash,
hang, or foreign exception; on a CUDA device ``torch.cuda.synchronize()``
after every archive raises nothing (a kernel that read past its input
leaves a sticky error there); and where the engine and the port's
``"scalar"`` engine both return a member's bytes, they are equal.
Error-class differences between the two engines are counted by class and
printed; they are not failures.

    python -m libmspack_tpu_torch.tools.fuzz_mass [rounds] [seed]
        [--engine cuda|native|scalar] [--device cuda|cpu] [--budget S]

Exit code 0 = clean sweep; prints a summary line per format.

Copied from ``tools/fuzz_mass.py``. Besides the imports: the engine and
device are arguments (``drive(kind, blob, engine, device)``), ``drive``
returns each member's bytes or error class and goes on past a member that
fails, the CHM comes from the port's ``chm_c.write_chm`` (the JAX tool
reads a sample file of the development host), the OAB from
``oab_c.write_oab``, and ``sweep`` adds the two rules above.
"""
from __future__ import annotations

import argparse
import collections
import random
import sys
import time

import libmspack_tpu_torch as m
from libmspack_tpu_torch.errors import MSPackError
from libmspack_tpu_torch.system import BytesSink


def _text(seed, n):
    rng = random.Random(seed)
    words = [bytes(rng.choices(b"abcdef the of lzx", k=rng.randint(3, 9)))
             for _ in range(40)]
    return b"".join(rng.choice(words) for _ in range(n // 2))[:n]


def build_archives():
    from libmspack_tpu_torch.compress import cab_c, chm_c, lzss_c, oab_c
    data = _text(7, 90000)
    arcs = {}
    arcs["cab"] = cab_c.write_cab(folders=[
        cab_c.FolderSpec([("a.txt", data[:40000])], "mszip"),
        cab_c.FolderSpec([("b.txt", data[40000:])], "lzx", 16),
        cab_c.FolderSpec([("q.txt", data[:20000])], "quantum", 15),
    ])
    arcs["szdd"] = lzss_c.szdd_compress(data[:30000])
    arcs["kwaj"] = lzss_c.kwaj_compress(data[:30000], method=2,
                                        filename="test.txt")
    arcs["chm"] = chm_c.write_chm([(f"/f{i}.txt", data[i * 9000:
                                                       (i + 1) * 9000])
                                   for i in range(8)])
    arcs["oab"] = oab_c.write_oab(data[:50000])
    return arcs


def drive(kind, blob, engine="cuda", device="cuda"):
    """Open + extract everything through ``engine``: a list with each
    member's bytes, or the name of the MSPackError class its extraction
    (or the open) raised. Any other exception propagates. KWAJ has no
    device route: it takes its only route whatever ``engine`` is."""
    kw = {} if engine != "cuda" else {"device": device}
    out = []

    def one(fn, *args):
        sink = BytesSink()
        try:
            fn(*args, sink)
        except MSPackError as e:
            out.append(type(e).__name__)
        else:
            out.append(sink.getvalue())

    try:
        if kind == "cab":
            d = m.create_cab_decompressor(engine=engine, **kw)
            cab = d.open(blob)
            for f in cab.files:
                one(d.extract, f)
        elif kind == "chm":
            d = m.create_chm_decompressor(engine=engine, **kw)
            chm = d.open(blob)
            for f in chm.files[:8]:
                one(d.extract, f)
        elif kind == "szdd":
            d = m.create_szdd_decompressor(engine=engine, **kw)
            hdr = d.open(blob)
            one(d.extract, hdr)
        elif kind == "kwaj":
            d = m.create_kwaj_decompressor()
            hdr = d.open(blob)
            one(d.extract, hdr)
        elif kind == "oab":
            d = m.create_oab_decompressor(engine=engine, **kw)
            one(d.decompress, blob)
    except MSPackError as e:
        out.append(type(e).__name__)
    return out


def mutate(rng, blob):
    b = bytearray(blob)
    kind = rng.randrange(4)
    if kind == 0:          # bit flips
        for _ in range(rng.randint(1, 16)):
            p = rng.randrange(len(b))
            b[p] ^= rng.randrange(1, 256)
    elif kind == 1:        # truncation
        b = b[:rng.randrange(1, len(b))]
    elif kind == 2:        # splice a shuffled window
        p = rng.randrange(len(b))
        n = min(len(b) - p, rng.randrange(1, 512))
        w = b[p:p + n]
        rng.shuffle(w)
        b[p:p + n] = w
    else:                  # zero a window
        p = rng.randrange(len(b))
        n = min(len(b) - p, rng.randrange(1, 2048))
        b[p:p + n] = bytes(n)
    return bytes(b)


def _sync(device):
    """Raise the sticky error a kernel left on a CUDA device, if any."""
    if str(device).startswith("cuda"):
        import torch
        torch.cuda.synchronize()


def sweep(kind, blob, rounds, seed, time_budget_s=None, engine="cuda",
          device="cuda"):
    """``rounds`` mutations of ``blob`` (or as many as ``time_budget_s``
    allows) through ``drive``. Returns a dict: ``done`` (rounds run),
    ``fails`` (foreign exceptions: (round, class, message)),
    ``cuda_errors`` (rounds after which the device raised; the sweep stops
    at the first), ``mismatches`` (rounds where a member's bytes differ
    from the scalar engine's) and ``class_diffs`` (a Counter of
    (engine's class, scalar's class) where they differ)."""
    rng = random.Random(seed)
    res = {"done": 0, "fails": [], "cuda_errors": [], "mismatches": [],
           "class_diffs": collections.Counter()}
    t0 = time.time()
    for i in range(rounds):
        if time_budget_s and time.time() - t0 > time_budget_s:
            break
        mut = mutate(rng, blob)
        res["done"] = i + 1
        try:
            got = drive(kind, mut, engine, device)
        except Exception as e:   # noqa: BLE001 - the failure signal
            res["fails"].append((i, type(e).__name__, str(e)[:80]))
            got = None
        try:
            _sync(device)
        except Exception as e:   # noqa: BLE001 - a sticky device error
            res["cuda_errors"].append((i, type(e).__name__, str(e)[:80]))
            break
        if got is None or engine == "scalar":
            continue
        want = drive(kind, mut, "scalar", "cpu")
        for a, b in zip(got, want):
            if isinstance(a, bytes) and isinstance(b, bytes):
                if a != b:
                    res["mismatches"].append(i)
            elif a != b:
                res["class_diffs"][(a if isinstance(a, str) else "bytes",
                                    b if isinstance(b, str) else "bytes")] \
                    += 1
        if len(got) != len(want):
            res["class_diffs"][("members", "members")] += 1
    return res


def main(argv=None):
    p = argparse.ArgumentParser(prog="fuzz_mass")
    p.add_argument("rounds", nargs="?", type=int, default=2000)
    p.add_argument("seed", nargs="?", type=int, default=0)
    p.add_argument("--engine", default="cuda",
                   choices=["cuda", "native", "scalar"])
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    p.add_argument("--budget", type=float, default=None,
                   help="seconds per format")
    args = p.parse_args(argv)
    arcs = build_archives()
    bad = 0
    for kind, blob in arcs.items():
        t0 = time.time()
        r = sweep(kind, blob, args.rounds, args.seed, args.budget,
                  args.engine, args.device)
        dt = time.time() - t0
        done = r["done"]
        print(f"{kind}: {done} mutations in {dt:.1f}s "
              f"({done/max(dt,1e-9):.0f}/s), {len(r['fails'])} foreign "
              f"exceptions, {len(r['cuda_errors'])} CUDA errors, "
              f"{len(r['mismatches'])} byte mismatches with scalar, "
              f"error-class differences {dict(r['class_diffs'])}",
              flush=True)
        for f in (r["fails"] + r["cuda_errors"])[:5]:
            print("   ", f, flush=True)
        bad += len(r["fails"]) + len(r["cuda_errors"]) + len(r["mismatches"])
    print("CLEAN SWEEP" if bad == 0 else f"{bad} FAILURES")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
