"""P1: a per-lane table search, row sweep against whole-table compare.

The port of ``tools/micro_vec.py``. Per lane it fills a 288-row table and a
256-row window, then runs 64 dependent steps of key search and window
fetch (``csrc/probes_micro_vec.cu`` says what each step computes). Two
variants, as on the TPU: ``sweep`` walks the rows one by one (one thread
per lane; 0 when no row matches) and ``vec`` compares the whole table and
reduces (one warp per lane; -1 when no row matches). Each runs with its
tables in global memory or in shared memory, the TPU kernel's mechanisms,
and with ``tables="registers"``, the redesign for Hopper: one warp per
lane, each thread holding nine table rows in registers, a step nine warp
ballots and one window load (``csrc/probes_vec.cuh``). It also times
PyTorch's gathers, the library rows that stand where the tool timed XLA's.

Run on the card: ``python -m libmspack_tpu_torch.tools.micro_vec``. After
the tool's lines it prints each kernel's time at 0, 64 and 256 steps and
the slope, its cost a dependent step apart from the launch and the fill,
at 128 to 32768 lanes (``PER_STEP_LANES``): a slope that stays as lanes
are added is the step's latency, one that grows is the SM's instruction
rate.
"""
from __future__ import annotations

import sys

import numpy as np
import torch

from . import Record, launch, log2c, on, tensor
from .timing import header, time_ms

SL, LN = 8, 128
R_TAB = 288
R_WIN = 256
STEPS = 64
VARIANTS = ("sweep", "vec")
TABLES = ("global", "shared", "registers")
# per_step's lane counts: on the card, and small ones for the plain
# versions on the CPU
PER_STEP_LANES = {"cuda": (128, 1024, 8192, 32768), "cpu": (32, 256)}

SOURCE = "probes_micro_vec.cu"
REPLACES = {f"p1_{v}_{t}": "tools/micro_vec.py:83"
            for v in VARIANTS for t in TABLES}
LAUNCHES = dict.fromkeys(REPLACES, 0)


def search(variant="sweep", tables="global", device="cuda", shape=(SL, LN),
           steps=STEPS) -> torch.Tensor:
    """The tool's kernel: int32 ``(1, *shape)``, each lane's acc after
    ``steps`` steps (lane l is row * LN + column). ``tables`` places the
    tables in ``"global"`` or ``"shared"`` memory on the card, or the
    table's rows in ``"registers"`` (the warp-ballot search); on the CPU
    there is one plain version."""
    if variant not in VARIANTS or tables not in TABLES:
        raise ValueError(f"variant in {VARIANTS}, tables in {TABLES}")
    dev, _ = on(device)
    if dev.type == "cpu":
        return search_plain(variant, shape, steps)
    L = shape[0] * shape[1]
    out = torch.empty((1, *shape), dtype=torch.int32, device=dev)
    if tables == "registers":
        launch(LAUNCHES, f"p1_{variant}_{tables}", "msp_p1_registers", dev,
               VARIANTS.index(variant), L, steps, out.data_ptr())
        return out
    scratch = torch.empty((R_TAB + R_WIN) * L if tables == "global" else 1,
                          dtype=torch.int32, device=dev)
    launch(LAUNCHES, f"p1_{variant}_{tables}", "msp_p1_vec", dev,
           VARIANTS.index(variant), int(tables == "shared"), L, steps,
           scratch.data_ptr(), out.data_ptr())
    return out


def search_plain(variant="sweep", shape=(SL, LN),
                 steps=STEPS) -> torch.Tensor:
    """Plain version of ``search``, all lanes at once."""
    lane = torch.arange(shape[0] * shape[1], dtype=torch.int64)
    rows = torch.arange(R_TAB, dtype=torch.int64)[:, None]
    tab = (lane * 7 + rows * 13) & 0xFFFF
    win = lane + torch.arange(R_WIN, dtype=torch.int64)[:, None]
    acc = lane.clone()
    for t in range(steps):
        key = (acc * 5 + t) & 0xFFFF
        off = (acc + t) & (R_WIN - 1)
        sym = torch.where(tab == key, rows, -1).amax(0)
        if variant == "sweep":
            sym = sym.clamp(min=0)
        wv = win.gather(0, off[None])[0]
        acc = (acc + sym + wv) & 0x7FFF
    return acc.to(torch.int32).view(1, *shape)


def gather_bench(dev):
    """The tool's XLA gathers as PyTorch calls (library rows, not
    kernels): a flat take and a row-wise take_along_axis; small on the
    CPU."""
    small = dev.type == "cpu"
    rng = np.random.RandomState(0)
    n = 1 << (16 if small else 25)
    src = tensor(rng.randint(0, 1 << 20, n, dtype=np.int32)).to(dev)
    idx = src.clamp(0, n - 1).long()
    _, ms = time_ms(lambda: torch.take(src, idx), dev, reps=4)
    print(f"take flat: {n} elems in {ms:.1f} ms -> {n / ms / 1e3:.0f} "
          "M elem/s (torch.take)", flush=True)
    B, S = (16, 4096) if small else (1024, 65536)
    src2 = tensor(rng.randint(0, S, (B, S), dtype=np.int32)).to(dev)
    idx2 = src2.long()
    _, ms = time_ms(lambda: torch.gather(src2, 1, idx2), dev, reps=4)
    print(f"take_along_axis ({B},{S}): {B * S} elems in {ms:.1f} ms -> "
          f"{B * S / ms / 1e3:.0f} M elem/s (torch.gather)", flush=True)


def main(argv=(), device="cuda") -> list[Record]:
    dev, _ = on(device)
    print(header(dev), flush=True)
    records = []
    for variant in VARIANTS:
        for tables in TABLES:
            out, ms = time_ms(lambda: search(variant, tables, dev), dev)
            where, fetch = (
                ("table rows in registers", "one window load")
                if tables == "registers" else
                (f"{tables} tables", f"{R_WIN}-row fetch"))
            print(f"{variant} ({where}): {ms:.3f} ms/call, "
                  f"{ms / STEPS * 1e3:.2f} us/step ({R_TAB}-row probe + "
                  f"{fetch} per step)", flush=True)
            records.append(Record(
                f"p1_{variant}_{tables}", f"({SL}, {LN}) lanes", ms,
                out.cpu(), lambda v=variant: search_plain(v),
                nbytes=4 * SL * LN,
                # a step: the key, the search (the window load beside
                # it) and the sum
                chain=STEPS * (1 + log2c(R_TAB) + 1)))
    gather_bench(dev)
    for n in PER_STEP_LANES[dev.type]:
        per_step(dev, shape=(max(1, n // LN), min(n, LN)))
    return records


def per_step(dev, steps=(0, STEPS, 4 * STEPS), shape=(SL, LN)) -> dict:
    """``{(variant, tables): [ms at each of steps]}`` at ``shape``'s
    lanes, printed with the slope in ns a step."""
    out = {}
    for variant in VARIANTS:
        for tables in TABLES:
            ms = [time_ms(lambda s=s: search(variant, tables, dev, shape,
                                             s), dev)[1]
                  for s in steps]
            out[variant, tables] = ms
            slope = (ms[-1] - ms[0]) / (steps[-1] - steps[0]) * 1e6
            print(f"{variant} ({tables}), {shape[0] * shape[1]} lanes: "
                  + ", ".join(f"{s} steps {m:.4f} ms"
                              for s, m in zip(steps, ms))
                  + f"; {slope:.1f} ns/step", flush=True)
    return out


if __name__ == "__main__":
    main(sys.argv[1:])
