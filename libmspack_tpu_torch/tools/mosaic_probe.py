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

All nine probes have a Hopper redesign beside the faithful port
(``csrc/probes_mosaic_vec.cu``, ``probes_mosaic_core.cuh``):
``probe(..., design="vec")`` is one launch of 256 threads that writes
every element of its output (``p4_<name>_vec``), four elements a thread
with 16-byte loads and stores, block values by warp reductions, scratch in
registers. ``dma_row``'s redesign reads x[0, 0] alone; warp k writes
output row k, the source row (warp r) or zeros (the others).

Run on the card: ``python -m libmspack_tpu_torch.tools.mosaic_probe
[name ...]``. Both designs are timed in turns (``timing.in_turns``) beside
``out.copy_(x)``, one launch that reads and writes x's bytes: the floor of
a one-launch kernel this size, and beside ``torch.zeros`` of the output,
the fill that each faithful call launches before its kernel; each
probe's excess over the floor is printed. The redesigns then run on the
edge inputs of ``edges()``.
"""
from __future__ import annotations

import math
import sys

import numpy as np
import torch

from . import Record, int32, launch, on, tensor, wrap32
from .micro_gather import INT32_MAX, INT32_MIN, edge_records
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

DESIGNS = ("faithful", "vec")

SOURCE = "probes_mosaic.cu"
REPLACES = {f"p4_{n}{d}": "tools/mosaic_probe.py:20" for n in PROBES
            for d in ("", "_vec")}
REPLACES.update(p4_smem_scalar="tools/mosaic_probe.py:91",
                p4_smem_scalar_vec="tools/mosaic_probe.py:91",
                p4_dma_row="tools/mosaic_probe.py:139",
                p4_dma_row_vec="tools/mosaic_probe.py:139")
SOURCES = {f"p4_{n}_vec": "probes_mosaic_vec.cu" for n in PROBES}
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


# dma_row's slab where t rem 4 < 0. The JAX body copies hbm.at[pl.ds(w, 16),
# r] with w = lax.rem(t, 4), which truncates: on a TPU a negative start is
# out of range. Interpret mode, which the JAX package's tests run, reads a
# negative row index r modulo 8 (floor modulo) but wraps the negative start
# w to w + 64 and then clamps it so that 16 slabs fit in 64: slab 48. The
# port follows the JAX package as its tests run it.
DMA_NEG_SLAB = 64 - 16


def _dma_row(x, hbm):
    t = int(x[0, 0])
    w = int(math.fmod(t, 4))   # lax.rem truncates
    r, w = t % SL, w if w >= 0 else DMA_NEG_SLAB
    out = torch.zeros_like(x)
    out[r] = hbm[w, r]
    return out


PLAIN = {n: globals()[f"_{n}"] for n in PROBES}


def probe(name, x, aux=None, device="cuda", design="faithful"
          ) -> torch.Tensor:
    """Probe ``name`` on x, int32 ``(8, 128)``; ``aux`` is smem_scalar's
    int32 table (at least 4 rows; column 0 is read) or dma_row's int32
    ``(64, 8, 128)`` source. Returns int32 ``(8, 128)``. ``design="vec"``
    launches the redesign: one launch into ``torch.empty``, aux at any
    alignment."""
    if name not in PROBES:
        raise ValueError(f"unknown probe {name!r}: one of {PROBES}")
    if design not in DESIGNS:
        raise ValueError(f"design is one of {DESIGNS}")
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
    if design == "vec":   # writes every element of out
        out = torch.empty((SL, LN), dtype=torch.int32, device=dev)
        kernel, entry = f"p4_{name}_vec", "msp_p4_probe_vec"
    else:
        if aux is not None and aux.data_ptr() % 16:
            aux = aux.clone()   # dma_row copies 16-byte chunks
        out = torch.zeros((SL, LN), dtype=torch.int32, device=dev)
        kernel, entry = f"p4_{name}", "msp_p4_probe"
    launch(LAUNCHES, kernel, entry, dev, PROBES.index(name), x.data_ptr(),
           None if aux is None else aux.data_ptr(),
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


def edges(seed=1):
    """The redesigns' edge inputs, ``{name: [(label, unaligned, (x,) or
    (x, aux))]}`` on the CPU, for each probe: x[0, 0] = 16, -8, 3, 0, 4
    and -4 (stage_store's slot and row hit and miss), x <= 0
    everywhere (reduce_pred's 0, cond_vec's -1, minscalar's 99), x > 99
    everywhere (minscalar's least x, above the 99 it puts for x <= 0),
    int32's extremes in x and the table (every sum wraps), and x (and
    aux) one element off 16-byte alignment (``unaligned``: made so on the
    device, the element path); smem_scalar's table with row stride 3;
    dma_row's x[0, 0] = -1, -2 and -3 (a negative t rem 4: slab
    DMA_NEG_SLAB), 7 (row 7 of slab 3), INT32_MAX and INT32_MIN."""
    x, aux = inputs(seed)
    rng = np.random.RandomState(seed)
    xs = []
    for x00 in (16, -8, 3, 0, 4, -4):
        v = x.clone()
        v[0, 0] = x00
        xs.append((f"x[0, 0] = {x00}", False, v))
    xs.append(("x <= 0", False, -x.abs()))
    xs.append(("x > 99", False,
               tensor(rng.randint(100, 1 << 20, (SL, LN)).astype(np.int32))))
    ext = tensor(rng.randint(INT32_MIN, INT32_MAX + 1, (SL, LN),
                             dtype=np.int64).astype(np.int32))
    ext.view(-1)[:4] = torch.tensor([INT32_MAX, INT32_MIN, -1, 0])
    xs.append(("int32 extremes", False, ext))
    xs.append(("x unaligned", True, x))
    sm_ext = torch.tensor([[INT32_MAX, 1], [INT32_MAX, 2], [5, 3],
                           [INT32_MIN, 4]], dtype=torch.int32)
    cases = {}
    for name in PROBES:
        cases[name] = [(label, unaligned, (v,)) for label, unaligned, v
                       in xs]
    cases["smem_scalar"] = [
        (label, unaligned, (v, sm_ext if label == "int32 extremes"
                            else aux["smem_scalar"]))
        for label, unaligned, v in xs]
    sm3 = tensor(rng.randint(-50, 50, (5, 3)).astype(np.int32))
    cases["smem_scalar"].append(("table row stride 3", False, (x, sm3)))
    cases["dma_row"] = [(label, unaligned, (v, aux["dma_row"]))
                        for label, unaligned, v in xs]
    for x00 in (-1, -2, -3, 7, INT32_MAX, INT32_MIN):
        v = x.clone()
        v[0, 0] = x00
        cases["dma_row"].append((f"x[0, 0] = {x00}", False,
                                 (v, aux["dma_row"])))
    return cases


def nbytes(name) -> int:
    """What the function must move: x read and out written, and the
    table's four words (smem_scalar); for dma_row x[0, 0], one source row
    and out, for either design (the faithful kernel copies 16 rows)."""
    if name == "dma_row":
        return 4 + 4 * LN + 4 * SL * LN
    return 8 * SL * LN + (16 if name == "smem_scalar" else 0)


def edge_runs(dev, names=PROBES) -> list[Record]:
    """The redesigns of ``names`` on their inputs of ``edges()``."""
    records = []
    for name, cases in edges().items():
        if name in names:
            records += edge_records(
                dev, f"p4_{name}_vec", cases,
                lambda *a, n=name: probe(n, *a[:-1], device=a[-1],
                                         design="vec"),
                lambda *a, n=name: nbytes(n), CHAIN[name])
    return records


def main(argv=(), device="cuda") -> list[Record]:
    names = list(argv) or list(PROBES)
    dev, _ = on(device)
    print(header(dev), flush=True)
    x, aux = inputs()
    xd = x.to(dev)
    auxd = {k: v.to(dev) for k, v in aux.items()}
    floor_out = torch.empty_like(xd)
    runs = {}
    for name in names:
        for d in DESIGNS:
            runs[name, d] = lambda n=name, d=d: probe(n, xd, auxd.get(n),
                                                      dev, d)
    runs["copy_ floor"] = lambda: floor_out.copy_(xd)
    runs["zero fill"] = lambda: torch.zeros((SL, LN), dtype=torch.int32,
                                            device=dev)
    # while22's function as one PyTorch call (the library row)
    runs["full 3"] = lambda: torch.full((SL, LN), 3, dtype=torch.int32,
                                        device=dev)
    outs, times = in_turns(runs, dev, reps=32)
    floor = times["copy_ floor"]
    print(f"copy_ floor (8, 128) int32: {floor * 1e3:.3f} us/call; the "
          f"output's zero fill {times['zero fill'] * 1e3:.3f} us/call; "
          f"torch.full of 3 {times['full 3'] * 1e3:.3f} us/call",
          flush=True)
    records = []
    for (name, d), ms in ((k, v) for k, v in times.items()
                          if isinstance(k, tuple)):
        a = aux.get(name)
        out = outs[name, d].cpu()
        ok = torch.equal(out, probe(name, x, a, "cpu"))
        print(f"{name} {d}: {'OK' if ok else 'FAIL: differs from plain'}  "
              f"({ms * 1e3:.3f} us/call, {(ms - floor) * 1e3:.3f} us over "
              "the copy_ floor)", flush=True)
        records.append(Record(
            f"p4_{name}" + ("_vec" if d == "vec" else ""), "(8, 128)", ms,
            out, lambda n=name, a=a: probe(n, x, a, "cpu"), nbytes(name),
            CHAIN[name],
            library_ms=times["full 3"] if name == "while22" else None))
    return records + edge_runs(dev, names)


if __name__ == "__main__":
    recs = main(sys.argv[1:])
    sys.exit(int(any(not torch.equal(r.out, r.plain()) for r in recs)))
