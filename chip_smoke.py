#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port's main path once on one GPU, and check it.

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero):
1. require a CUDA device; print the card's name and power limit;
2. build the kernels (nvcc, sm_90a) and print the build time;
3. K1 against its plain version on the edge-case batch
   (libmspack_tpu_torch/edge_cases.py): counts, tokens and resolved bytes
   must be equal;
4. K2 against its plain version on those traces: bytes and counts equal;
   then both kernels against their plain versions, and timed, at the
   shapes of the main path;
5. the slice: bench.py's 96 MiB MSZIP cabinet (four 24 MiB folders, 3072
   frames) extracted through create_cab_decompressor(engine="cuda"); the
   bytes must equal the corpus, K1 must have launched, nothing may decline;
   the JAX package's engine="native" on the same cabinet for comparison;
6. the same folders through CudaMszipEngine(phase_b="device"): bytes equal
   and K2 launched.

The next-to-last line is a JSON object with each kernel's launches on the
main path, its largest difference from the plain version and both times;
the last line is {"ok": true, "device": {...}}. It imports no JAX.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time

MB = 1 << 20


def card_line() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60, check=True)
    return r.stdout.strip().splitlines()[0]


def timed(fn, device, reps=1):
    """(result, best ms over reps): CUDA events on the card, the host
    clock on the CPU."""
    import torch
    best, out = float("inf"), None
    for _ in range(reps):
        if device.type == "cuda":
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            out = fn()
            b.record()
            b.synchronize()
            best = min(best, a.elapsed_time(b))
        else:
            t0 = time.perf_counter()
            out = fn()
            best = min(best, (time.perf_counter() - t0) * 1e3)
    return out, best


def k1_compare(cases, device, tcap):
    """K1 on ``device`` and its plain version on one batch; returns
    (device results on the CPU, plain results, max abs difference)."""
    import torch

    from libmspack_tpu_torch.ops import cuda_inflate as ci

    s, lens = ci.pack_streams([c.stream for c in cases])
    hists = torch.tensor([c.hist for c in cases], dtype=torch.int32)
    plain, plain_ms = timed(lambda: ci.inflate_phase_a_plain(
        s, lens, hists, tcap=tcap), torch.device("cpu"))
    sd, ld, hd = (t.to(device) for t in (s, lens, hists))
    dev, ms = timed(lambda: ci.inflate_phase_a(sd, ld, hd, tcap=tcap),
                    device, reps=3)
    dev = tuple(t.cpu() for t in dev)
    err = 0
    if not torch.equal(dev[2][:4], plain[2][:4]):
        raise AssertionError("K1 counts differ from the plain version")
    for i in range(len(cases)):
        n = int(plain[2][2, i])
        for a, b in ((dev[0], plain[0]), (dev[1], plain[1])):
            err = max(err, int((a[i, :n].long() - b[i, :n].long())
                               .abs().max()) if n else 0)
    return dev, plain, err, ms, plain_ms


def k2_compare(tok, litw, ntok, sizes, flags, device):
    import torch

    from libmspack_tpu_torch.ops import cuda_resolve as cr

    plain, plain_ms = timed(lambda: cr.resolve_frames_plain(
        tok, litw, ntok, sizes, flags), torch.device("cpu"))
    args = [t.to(device) for t in (tok, litw, ntok)]
    dev, ms = timed(lambda: cr.resolve_frames_device(*args, sizes, flags),
                    device, reps=3)
    dev = tuple(t.cpu() for t in dev)
    if not torch.equal(dev[1], plain[1]):
        raise AssertionError("K2 counts differ from the plain version")
    err = int((dev[0].int() - plain[0].int()).abs().max()) \
        if len(plain[0]) else 0
    return dev, err, ms, plain_ms


def extract_all(d, blob):
    from libmspack_tpu.system import BytesSink

    cab = d.open(blob)
    parts = []
    for f in cab.files:
        sink = BytesSink()
        d.extract(f, sink)
        parts.append(sink.getvalue())
    return b"".join(parts)


def run(device_name="cuda", total_mb=96, edge_frame=32768):
    """All phases after the device check; returns the kernels' JSON.

    ``run("cpu", total_mb=6, edge_frame=4096)`` rehearses every phase on
    the CPU, with the kernels' plain versions, before a run on the card."""
    import numpy as np
    import torch

    import bench
    import libmspack_tpu
    from libmspack_tpu_torch import create_cab_decompressor, kernels
    from libmspack_tpu_torch import edge_cases as ec
    from libmspack_tpu_torch.ops import cuda_inflate as ci
    from libmspack_tpu_torch.ops import cuda_resolve as cr
    from libmspack_tpu_torch.parallel.cuda_pipeline import CudaMszipEngine

    device = torch.device(device_name)
    # 2. build
    if device.type == "cuda":
        t0 = time.perf_counter()
        kernels.lib()
        print(f"build: {time.perf_counter() - t0:.3f} s "
              f"({kernels.build_info['path']})")
        for line in kernels.build_info["ptxas"].splitlines():
            if "registers" in line or "spill" in line:
                print("ptxas:", line.strip())

    # 3. K1 on the edge-case batch
    cases = ec.edge_case_batch(edge_frame, seed=0, variants=5)
    (tok, litw, cnt), plain, e1, ms, pms = k1_compare(cases, device,
                                                      edge_frame)
    want = {l0: b"".join(cases[i].raw for i in lanes)
            for l0, lanes in ec.folders_of(cases)}
    for res in ((tok, litw, cnt), plain):
        got = ec.resolve_valid(cases, res[0].numpy(), res[1].numpy(),
                               res[2].numpy())
        if got != want:
            raise AssertionError("edge batch: resolved bytes differ")
    flagged = [c.name for i, c in enumerate(cases) if int(cnt[0, i])]
    print(f"K1 edge batch: {len(cases)} frames equal to plain, flagged "
          f"{flagged}; kernel {ms:.3f} ms, plain {pms:.1f} ms")

    # 4. K2 on the same traces (valid lanes; corrupt ones resolve nothing)
    sizes = np.array([len(c.raw) if c.raw is not None else 0
                      for c in cases], np.int32)
    flags = np.array([int(c.chained) for c in cases], np.int32)
    (ob, counts), e2, ms, pms = k2_compare(tok, litw, cnt[2].contiguous(),
                                           sizes, flags, device)
    off = np.concatenate([[0], np.cumsum(sizes)])
    for i, c in enumerate(cases):
        if c.raw is not None and (
                bytes(ob[off[i]:off[i + 1]].numpy()) != c.raw
                or int(counts[i]) != len(c.raw)):
            raise AssertionError(f"K2 edge batch: lane {c.name}")
    print(f"K2 edge batch: equal to plain; kernel {ms:.3f} ms, plain "
          f"{pms:.1f} ms")

    # the main path's shapes: one folder per K1 launch (the driver), the
    # whole cabinet per K2 launch (phase 6)
    t0 = time.perf_counter()
    corpus = bench.build_corpus(total_mb * MB)
    blob = bench.build_cab(corpus, "mszip")
    print(f"cabinet: {len(corpus)} bytes in {len(blob)} bytes, built in "
          f"{time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    probe = libmspack_tpu.create_cab_decompressor()
    pcab = probe.open(blob)
    folders = []
    for fol in pcab.folders:
        frames, fsizes = probe.collect_mszip_frames(fol)
        folders.append(([f[2:] for f in frames], fsizes))
    nframes = sum(len(f) for f, _ in folders)
    print(f"host: open + collect_mszip_frames of {len(folders)} folders, "
          f"{nframes} frames: {(time.perf_counter() - t0) * 1e3:.1f} ms")
    fcases = [ec.Case("f", fr, 0 if j == 0 else 32768, None)
              for j, fr in enumerate(folders[0][0])]
    (tok, litw, cnt), plain, e, k1_ms, k1_plain_ms = k1_compare(
        fcases, device, ci.FRAME_MAX)
    e1 = max(e1, e)
    print(f"K1 one folder ({len(fcases)} frames): kernel {k1_ms:.3f} ms, "
          f"plain {k1_plain_ms:.1f} ms, equal")
    allc = [ec.Case("f", fr, 0 if j == 0 else 32768, None)
            for frs, _ in folders for j, fr in enumerate(frs)]
    s, lens = ci.pack_streams([c.stream for c in allc])
    hists = torch.tensor([c.hist for c in allc], dtype=torch.int32)
    sd, ld, hd = (t.to(device) for t in (s, lens, hists))
    if device.type == "cuda":
        for threads in (1, 8, 32, 64):
            _, t_ms = timed(lambda: ci.inflate_phase_a(
                sd, ld, hd, threads=threads), device, reps=3)
            print(f"K1 whole cabinet ({len(allc)} frames), {threads} "
                  f"threads/block: {t_ms:.3f} ms")
    tok, litw, cnt = (t.cpu() for t in ci.inflate_phase_a(sd, ld, hd))
    del sd, ld, hd, plain
    sizes = np.array([s for _, fs in folders for s in fs], np.int32)
    flags = np.array([int(j > 0) for frs, _ in folders
                      for j in range(len(frs))], np.int32)
    (ob, counts), e, k2_ms, k2_plain_ms = k2_compare(
        tok, litw, cnt[2].contiguous(), sizes, flags, device)
    e2 = max(e2, e)
    if bytes(ob.numpy()) != corpus:
        raise AssertionError("K2 whole cabinet: bytes differ")
    print(f"K2 whole cabinet ({nframes} frames, {len(folders)} chains): "
          f"kernel {k2_ms:.3f} ms, plain {k2_plain_ms:.1f} ms, equal")
    del tok, litw, cnt, ob

    # 5. the slice through the driver
    ci.LAUNCHES["cuda"] = 0
    runs = []
    for _ in range(4):
        d = create_cab_decompressor(engine="cuda", device=device)
        t0 = time.perf_counter()
        out = extract_all(d, blob)
        if device.type == "cuda":
            torch.cuda.synchronize()
        runs.append(time.perf_counter() - t0)
        if out != corpus:
            raise AssertionError("engine=cuda: extracted bytes differ")
        eng = d.cuda_engine
        if sum(eng.declines.values()) or d.fallback_reasons:
            raise AssertionError(f"declines {dict(eng.declines)}, "
                                 f"fallbacks {d.fallback_reasons}")
    k1_launches = ci.LAUNCHES["cuda"] if device.type == "cuda" else \
        ci.LAUNCHES["plain"]
    if k1_launches < 1:
        raise AssertionError("K1 never launched on the main path")
    mbs = [len(corpus) / t / 1e6 for t in runs]
    print(f"engine=cuda: {nframes} frames, cold {mbs[0]:.1f} MB/s, warm "
          f"best {max(mbs[1:]):.1f} MB/s, K1 launches {k1_launches}")
    print("engine=cuda phases of the last run (ms): " + ", ".join(
        f"{k} {v:.3f}" for k, v in sorted(eng.timings.items())))
    nat = []
    for _ in range(4):
        d = libmspack_tpu.create_cab_decompressor(engine="native")
        t0 = time.perf_counter()
        if extract_all(d, blob) != corpus:
            raise AssertionError("engine=native: bytes differ")
        nat.append(len(corpus) / (time.perf_counter() - t0) / 1e6)
    print(f"libmspack_tpu engine=native: cold {nat[0]:.1f} MB/s, warm best "
          f"{max(nat[1:]):.1f} MB/s")

    # 6. device phase B over the whole cabinet, and host phase B likewise
    cr.LAUNCHES["cuda"] = 0
    for pb in ("device", "host"):
        for rep in range(2):
            eng = CudaMszipEngine(device, phase_b=pb)
            t0 = time.perf_counter()
            outs = eng.decode_folders(folders)
            dt = time.perf_counter() - t0
            if outs is None or b"".join(outs) != corpus:
                raise AssertionError(f"phase_b={pb}: bytes differ")
            if sum(eng.declines.values()):
                raise AssertionError(f"phase_b={pb}: declines "
                                     f"{dict(eng.declines)}")
        print(f"CudaMszipEngine(phase_b={pb}), {len(folders)} folders in "
              f"one call: {len(corpus) / dt / 1e6:.1f} MB/s warm; phases "
              "(ms): " + ", ".join(f"{k} {v:.3f}"
                                   for k, v in sorted(eng.timings.items())))
        if pb == "device":
            k2_launches = cr.LAUNCHES["cuda"] if device.type == "cuda" \
                else cr.LAUNCHES["plain"]
    if k2_launches < 1:
        raise AssertionError("K2 never launched on the main path")
    return {"kernels": [
        {"name": "k1_inflate", "route": "cuda",
         "source": "libmspack_tpu_torch/csrc/inflate.cu",
         "replaces": "libmspack_tpu/ops/pallas_inflate.py:134",
         "launches": k1_launches, "max_abs_err": e1, "ms": k1_ms,
         "plain_ms": k1_plain_ms},
        {"name": "k2_resolve", "route": "cuda",
         "source": "libmspack_tpu_torch/csrc/resolve.cu",
         "replaces": "libmspack_tpu/ops/pallas_resolve.py:51",
         "launches": k2_launches, "max_abs_err": e2, "ms": k2_ms,
         "plain_ms": k2_plain_ms}]}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 1
    print(card_line())
    result = run("cuda")
    print(json.dumps(result))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
