"""K3 on one CAB LZX folder: the serial decode (one warp) against the frame
split (a warp per 32 KiB frame), at a range of folder sizes.

Each folder is ``n`` frames of plaintext at window 2^21, coded by the
native encoder a block per ``block_frames`` frames and cut into one CFDATA
block a frame, as makecab writes LZX:21 folders. The plaintext is the
benchmark's cab_corpus mix (``portbench/gen``) where the repository root is
importable, else the bench corpus. For each size the tool checks that both
decodes give the folder's bytes, then times each (mean of ``reps`` device
launches, the folder already on the card) and prints one JSON line:
``serial_ms``, ``split_ms``, the ratio, and ``bound_ms``, the least time
the folder's compressed and plaintext bytes take at the HBM peak. With
``--passes`` it also prints each of the split's launches' device time from
a ``torch.profiler`` trace (seed, frame, join, serial).

Both of the port's encoders end every block on a frame edge, where the
seed walk reads only headers. ``--inside B1,B2,..`` times folders whose
blocks end inside frames instead: the plaintext tokenized by the port's
Python encoder and written in blocks of about B bytes each (cut at the
token nearest, ``lzx_edge_cases``), so that the seed walk decodes a frame
prefix for each such block end (``inside_ends`` in the line).

    python -m libmspack_tpu_torch.tools.k3_split_bench [--frames 2,4,64]
        [--block-frames 32] [--inside 12000,50000] [--reps 5] [--passes]
"""
from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from .. import native
from ..ops import _bench
from ..ops import cuda_lzx as cl
from ..parallel.cuda_pipeline import resolve_lzx

HBM_BYTES_PER_S = 3.35e12
WINDOW_BITS = 21


def plaintext(n: int, seed: int = 7) -> bytes:
    """n bytes of the benchmark's cab_corpus mix, or the bench corpus."""
    try:
        from portbench.gen import data
    except ImportError:
        return _bench.chunks(1, -(-n // 1024))[0][:n]
    mix = {"text": 0.35, "records": 0.35, "noise": 0.10, "random": 0.20}
    return data.file_bytes(seed, (3, n), n, mix, (4096, 65536),
                           data.Vocabulary(seed))


def folder(n_frames: int, block_frames: int = 32):
    """(plaintext, stream, CFDATA payload lengths) of one folder."""
    plain = plaintext(n_frames * cl.FRAME)
    stream, offs = native.lzx_encode(plain, WINDOW_BITS,
                                     block_frames=block_frames)
    ends = offs[1:] + [len(stream)]
    return plain, stream, [int(b - a) for a, b in zip(offs, ends)]


def folder_inside(n_frames: int, block_bytes: int):
    """(plaintext, stream, CFDATA payload lengths, blocks that end inside
    a frame) of one folder whose blocks hold about block_bytes each."""
    from .. import lzx_edge_cases as le
    from ..compress import lzx_e

    plain = plaintext(n_frames * cl.FRAME)
    enc = lzx_e.LzxEncoder(WINDOW_BITS)
    matcher, reps = lzx_e._Matcher(plain, enc.max_chain), [1, 1, 1]
    toks = []
    for k in range(n_frames):
        toks += enc._tokenize_frame(plain, matcher, k * cl.FRAME,
                                    (k + 1) * cl.FRAME, 0, 0, reps)
    w, part, pos, start, inside = le._Writer(WINDOW_BITS), [], 0, 0, 0
    for t in toks:
        part.append(t)
        pos += 1 if t[0] == 0 else t[1]
        if pos - start >= block_bytes or pos == len(plain):
            w.block(part)
            inside += pos % cl.FRAME != 0 and pos < len(plain)
            part, start = [], pos
    stream = w.getvalue()
    return plain, stream, le.frame_sizes(stream, w.frames, pos), inside


def decoded(tok, litw, cnt, n):
    """The folder's bytes from one launch's trace, or None where flagged."""
    cnt = cnt.cpu().numpy()
    if cnt[0, 0] or cnt[1, 0] != n:
        return None
    k = int(cnt[2, 0])
    got = resolve_lzx(tok[:, :k].cpu().numpy(), litw[:, :k].cpu().numpy(),
                      [n], cnt[4, :1], cnt[5, :1], WINDOW_BITS, n_threads=1)
    return None if got is None else got[0].tobytes()


def pass_ms(fn, launches, calls=3) -> list:
    """Device ms of each of the ``launches`` k3_lzx_kernel launches of the
    last of ``calls`` calls under one profiler, in order (a trace can miss
    the launches at its start)."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
            torch.cuda.synchronize()
    evs = sorted((e for e in prof.events()
                  if e.name.startswith("k3_lzx_kernel")
                  or "k3_lzx_kernel" in e.name.split("(")[0]),
                 key=lambda e: e.time_range.start)
    return [e.device_time_total / 1e3 for e in evs[-launches:]]


def measure(n_frames, block_frames=32, reps=5, passes=False, dev="cuda",
            block_bytes=None):
    dev = torch.device(dev)
    if block_bytes:
        plain, stream, sizes, inside = folder_inside(n_frames, block_bytes)
    else:
        (plain, stream, sizes), inside = folder(n_frames, block_frames), 0
    n = len(plain)
    s, lens = cl.pack_streams([stream])
    s, lens = s.to(dev), lens.to(dev)
    tg = torch.tensor([n], dtype=torch.int32, device=dev)
    hs = torch.zeros(1, dtype=torch.int32, device=dev)

    def serial():
        return cl.lzx_phase_a(s, lens, tg, hs, WINDOW_BITS, tcap=n)

    def split():
        return cl.lzx_phase_a(s, lens, tg, hs, WINDOW_BITS, tcap=n,
                              frame_sizes=[sizes])

    one, two = serial(), split()
    row6 = int(two[2][6, 0])
    ok = decoded(*one, n) == plain and decoded(*two, n) == plain
    out = {"frames": n_frames, "block_frames": block_frames,
           "block_bytes": block_bytes, "inside_ends": inside, "bytes": n,
           "compressed": len(stream), "ok": ok, "split_row6": row6,
           "serial_ms": _bench.device_ms(serial, dev, reps),
           "split_ms": _bench.device_ms(split, dev, reps),
           "bound_ms": (n + len(stream)) / HBM_BYTES_PER_S * 1e3}
    out["serial_over_split"] = out["serial_ms"] / out["split_ms"]
    if passes and dev.type == "cuda":
        # seed, frame, join and serial passes where the row split
        out["split_pass_ms"] = pass_ms(split, 4 if row6 else 1)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--frames", default="1,2,3,4,8,16,32,64,768")
    p.add_argument("--block-frames", type=int, default=32)
    p.add_argument("--reps", type=int, default=5)
    p.add_argument("--inside", default="",
                   help="block sizes in bytes, blocks ending inside frames")
    p.add_argument("--passes", action="store_true")
    p.add_argument("--device", default="cuda")
    a = p.parse_args(argv)
    sizes = [int(v) for v in a.inside.split(",") if v] or [None]
    ok = True
    for n in (int(v) for v in a.frames.split(",")):
        for bb in sizes:
            r = measure(n, a.block_frames, a.reps, a.passes, a.device, bb)
            ok = ok and r["ok"] and r["split_row6"] == cl.SPLIT_DONE
            print(json.dumps(r), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
