"""K1 on a batch of frames, checked and timed: the port of
``tools/tpu_inflate_bench.py``.

    python -m libmspack_tpu_torch.tools.inflate_bench [n_frames] [frame_kb]

Builds ``n_frames`` raw deflate frames of ``frame_kb`` KiB (zlib level 6,
no history) from the reference's ``lzxd.c`` repeated, where the reference
sources are there (``native.reference.mspack_dir``), else from
``utils.bench_corpus``, and says which. Runs K1 on them, checks every
lane's counts and three lanes' bytes, and prints the first call's time
(which includes building the kernels), then the steady time per batch
with packing, upload and the counts' pull, as the JAX tool timed it, and
the device-resident time between CUDA events.
"""
from __future__ import annotations

import os
import sys
import time
import zlib

import numpy as np
import torch

from .._device import resolve_device


def make_frames(n, kb=32):
    """``(frames, raws, source)``: ``tools/tpu_inflate_bench.py:18-31``'s
    frames where ``lzxd.c`` of the reference is there, else the bench
    corpus's."""
    from ..native import reference
    from ..utils import bench_corpus

    src = reference.mspack_dir()
    path = None if src is None else os.path.join(src, "lzxd.c")
    if path and os.path.exists(path):
        with open(path, "rb") as fh:
            base = fh.read()
        source = path
    else:
        base = bench_corpus(1 << 20)
        source = "utils.bench_corpus (no reference lzxd.c)"
    base = base * (1 + (kb * 1024 * n) // len(base))
    raws = [base[i * kb * 1024:(i + 1) * kb * 1024] for i in range(n)]
    frames = []
    for raw in raws:
        co = zlib.compressobj(6, zlib.DEFLATED, -15)
        frames.append(co.compress(raw) + co.flush())
    return frames, raws, source


def main(argv=None, device="cuda") -> dict:
    """Run the tool; returns what it printed, as a dict."""
    from ..ops import _bench
    from ..ops import cuda_inflate as ci
    from . import devtime

    argv = sys.argv[1:] if argv is None else argv
    n = int(argv[0]) if len(argv) > 0 else 1024
    kb = int(argv[1]) if len(argv) > 1 else 32
    dev = resolve_device(device)
    devtime.warmup(dev)
    if dev.type == "cuda":
        from .timing import card_line
        print(card_line(), flush=True)
    else:
        print("cpu: plain version, host clock (no device times)", flush=True)
    frames, raws, source = make_frames(n, kb)
    total_out = sum(len(r) for r in raws)
    total_in = sum(len(f) for f in frames)
    print(f"{n} frames from {source}, in={total_in / 1e6:.1f} MB "
          f"out={total_out / 1e6:.1f} MB ratio={total_in / total_out:.3f}",
          flush=True)
    tcap = kb * 1024 + 2048
    hists = torch.zeros(n, dtype=torch.int32)

    def batch():
        s, lens = ci.pack_streams(frames)
        tok, litw, cnt = ci.inflate_phase_a(s, lens, hists, tcap=tcap,
                                            device=dev)
        return tok, litw, cnt.cpu()

    t0 = time.perf_counter()
    tok, litw, cnt = batch()
    first_s = time.perf_counter() - t0
    print(f"first call (build + run): {first_s:.3f}s", flush=True)
    sizes = np.array([len(r) for r in raws])
    errors = int((cnt[0] != 0).sum())
    out_ok = int((cnt[1].numpy() == sizes).sum())
    print("errors:", errors, "out_ok:", out_ok, "/", n, "max_steps:",
          int(cnt[2].max()), flush=True)
    lanes = _bench.sampled(n)
    got = ci.replay(tok[lanes].cpu().numpy(), litw[lanes].cpu().numpy(),
                    sizes[lanes].tolist())
    exact = {}
    for i, g in zip(lanes, got):
        exact[i] = g == raws[i]
        print(f"lane {i} bit-exact: {exact[i]}", flush=True)
    del tok, litw
    reps = 3
    t0 = time.perf_counter()
    for _ in range(reps):
        batch()
    dt = (time.perf_counter() - t0) / reps
    print(f"steady: {dt * 1e3:.3f} ms/batch -> {total_out / dt / 1e6:.1f} "
          f"MB/s phase A (pack, upload, K1, counts' pull)", flush=True)
    s, lens = ci.pack_streams(frames)
    sd, ld, hd = (t.to(dev) for t in (s, lens, hists))
    ms = _bench.device_ms(lambda: ci.inflate_phase_a(sd, ld, hd, tcap=tcap),
                          dev, reps)
    where = "device-resident" if dev.type == "cuda" else "plain version"
    print(f"{where}: {ms:.3f} ms/batch -> {total_out / ms / 1e3:.1f} MB/s "
          f"(mean of {reps})", flush=True)
    return {"source": source, "first_s": first_s, "errors": errors,
            "out_ok": out_ok, "bit_exact": exact, "steady_ms": dt * 1e3,
            "ms": ms}


if __name__ == "__main__":
    main()
