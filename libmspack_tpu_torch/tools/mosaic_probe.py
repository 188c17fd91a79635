"""P4: the mosaic probes: nine tiny (8, 128) int32 functions.

The port of ``tools/mosaic_probe.py``. On the TPU each probe bisected one
construct of the Mosaic compiler, and the tool printed whether it built
and ran. Here each is a kernel of one block, one thread per element
(``csrc/probes_mosaic.cu`` says what each computes), and ``name: OK``
means the kernel's output equals its plain version on the tool's seeded
input; the process exits non-zero on any FAIL. The tool's two probes that
never ran as written run here as the functions their bodies define:
``smem_scalar`` (unregistered) with its table as an input, and
``dma_row`` with its (64, 8, 128) source as an input (its call passed
neither).

Run on the card: ``python -m libmspack_tpu_torch.tools.mosaic_probe
[name ...]``. The probes are timed in turns (``timing.in_turns``) beside
``out.copy_(x)``, one launch that reads and writes x's bytes: the floor of
a one-launch kernel this size, and beside ``torch.zeros`` of the output,
the fill that each probe's call launches before its kernel; each probe's
excess over the floor is printed.
"""
from __future__ import annotations

import math
import sys

import numpy as np
import torch

from . import Record, int32, launch, on, tensor, wrap32
from .timing import header, in_turns

SL, LN = 8, 128
M32 = 0xFFFFFFFF
PROBES = ("reduce_pred", "cond_vec", "while22", "table_rw", "stage_store",
          "minscalar", "smem_scalar", "u64shift", "dma_row")
AUX_SHAPE = {"smem_scalar": None, "dma_row": (64, SL, LN)}
# dependent steps in one element: a block-wide reduce is a 10-level tree
CHAIN = {"reduce_pred": 10, "cond_vec": 11, "while22": 3, "table_rw": 2,
         "stage_store": 2, "minscalar": 11, "smem_scalar": 4, "u64shift": 3,
         "dma_row": 2}

SOURCE = "probes_mosaic.cu"
REPLACES = {f"p4_{n}": "tools/mosaic_probe.py:20" for n in PROBES}
REPLACES.update(p4_smem_scalar="tools/mosaic_probe.py:91",
                p4_dma_row="tools/mosaic_probe.py:139")
LAUNCHES = dict.fromkeys(REPLACES, 0)


def _reduce_pred(x, _):
    return x + 1 if bool((x > 0).any()) else torch.zeros_like(x)


def _cond_vec(x, _):
    return torch.where((x > 0).any() & (x >= 0) & (x < 8), x, -1)


def _while22(x, _):
    return torch.full_like(x, 3)


def _table_rw(x, _):
    return torch.where((x >= 0) & (x < 16), x, 0)


def _stage_store(x, _):
    t = int(x[0, 0])
    row, slot = math.fmod(t, 4), math.fmod(t // 4, 2)   # lax.rem truncates
    return x.clone() if row == 0 and slot == 0 else torch.zeros_like(x)


def _minscalar(x, _):
    return x + torch.where(x > 0, x, 99).min()


def _smem_scalar(x, sm):
    return wrap32(x.long() + sm[:4, 0].long().sum())


def _u64shift(x, _):
    lo = x.long() & M32
    hi = (lo * 3) & M32
    k = x.long() & 31
    ku = k.clamp(1, 31)
    mid = ((lo >> ku) | (hi << (32 - ku))) & M32
    return wrap32(torch.where(k == 0, lo, mid))


def _dma_row(x, hbm):
    t = int(x[0, 0])
    r, w = t % SL, t % 4
    out = torch.zeros_like(x)
    out[r] = hbm[w, r]
    return out


PLAIN = {n: globals()[f"_{n}"] for n in PROBES}


def probe(name, x, aux=None, device="cuda") -> torch.Tensor:
    """Probe ``name`` on x, int32 ``(8, 128)``; ``aux`` is smem_scalar's
    int32 table (at least 4 rows; column 0 is read) or dma_row's int32
    ``(64, 8, 128)`` source. Returns int32 ``(8, 128)``."""
    if name not in PROBES:
        raise ValueError(f"unknown probe {name!r}: one of {PROBES}")
    x = int32(x, "x", (SL, LN))
    if name in AUX_SHAPE:
        if aux is None:
            raise ValueError(f"{name} needs its aux input")
        aux = int32(aux, "aux", AUX_SHAPE[name])
        if name == "smem_scalar" and (aux.dim() != 2 or aux.shape[0] < 4):
            raise ValueError("smem_scalar's table must be 2-D, >= 4 rows")
        dev, (x, aux) = on(device, x, aux)
    else:
        dev, (x,) = on(device, x)
        aux = None
    if dev.type == "cpu":
        return PLAIN[name](x, aux)
    if aux is not None and aux.data_ptr() % 16:
        aux = aux.clone()   # dma_row copies 16-byte chunks
    out = torch.zeros((SL, LN), dtype=torch.int32, device=dev)
    launch(LAUNCHES, f"p4_{name}", "msp_p4_probe", dev, PROBES.index(name),
           x.data_ptr(), None if aux is None else aux.data_ptr(),
           0 if aux is None else aux.stride(0), out.data_ptr())
    return out


def inputs(seed=0):
    """The CLI's seeded inputs: ``(x, {name: aux})``. x[0, 0] = 16, so
    stage_store keeps x and dma_row reads row 0 of hbm[0]."""
    rng = np.random.RandomState(seed)
    x = rng.randint(-4, 20, (SL, LN)).astype(np.int32)
    x[0, 0] = 16
    aux = {"smem_scalar": rng.randint(-50, 50, (4, 2)).astype(np.int32),
           "dma_row": rng.randint(0, 1 << 30, (64, SL, LN)).astype(np.int32)}
    return tensor(x), {k: tensor(v) for k, v in aux.items()}


def main(argv=(), device="cuda") -> list[Record]:
    names = list(argv) or list(PROBES)
    dev, _ = on(device)
    print(header(dev), flush=True)
    x, aux = inputs()
    xd = x.to(dev)
    auxd = {k: v.to(dev) for k, v in aux.items()}
    floor_out = torch.empty_like(xd)
    runs = {name: lambda n=name: probe(n, xd, auxd.get(n), dev)
            for name in names}
    runs["copy_ floor"] = lambda: floor_out.copy_(xd)
    runs["zero fill"] = lambda: torch.zeros((SL, LN), dtype=torch.int32,
                                            device=dev)
    outs, times = in_turns(runs, dev, reps=32)
    floor = times["copy_ floor"]
    print(f"copy_ floor (8, 128) int32: {floor * 1e3:.3f} us/call; the "
          f"output's zero fill {times['zero fill'] * 1e3:.3f} us/call",
          flush=True)
    records = []
    for name in names:
        a, ms = aux.get(name), times[name]
        out = outs[name].cpu()
        ok = torch.equal(out, probe(name, x, a, "cpu"))
        print(f"{name}: {'OK' if ok else 'FAIL: differs from plain'}  "
              f"({ms * 1e3:.3f} us/call, {(ms - floor) * 1e3:.3f} us over "
              "the copy_ floor)", flush=True)
        nbytes = 8 * SL * LN + (16 * LN * 4 if name == "dma_row" else 0) + \
            (16 if name == "smem_scalar" else 0)
        records.append(Record(
            f"p4_{name}", "(8, 128)", ms, out,
            lambda n=name, a=a: probe(n, x, a, "cpu"), nbytes, CHAIN[name]))
    return records


if __name__ == "__main__":
    recs = main(sys.argv[1:])
    sys.exit(int(any(not torch.equal(r.out, r.plain()) for r in recs)))
