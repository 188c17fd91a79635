"""P6: the chained gather probes.

The port of ``tools/micro_gather2.py``: P5's mask-sum probe followed by
``(acc + idx) mod N`` (``masksum``), and T steps of a mock symbol from a
seed per lane, with an xor refill and a rotate (``symbol_step``);
``csrc/probes_micro_gather2.cu`` says what each computes. The tool's XLA
rounds (pointer doubling by take_along_axis, a flat take) are timed here
as PyTorch calls, the library rows.

Run on the card: ``python -m libmspack_tpu_torch.tools.micro_gather2
[all|mask|sym|xla]``
"""
from __future__ import annotations

import sys

import numpy as np
import torch

from . import Record, Work, int32, launch, on, tensor, wrap32
from .micro_gather import (M32, check_symbol_inputs, len_find_plain,
                           masksum_plain as _probe_plain, symbol_inputs)
from .timing import header, time_ms

N = 288

SOURCE = "probes_micro_gather2.cu"
REPLACES = {"p6_masksum": "tools/micro_gather2.py:25",
            "p6_symbol_step": "tools/micro_gather2.py:85"}
LAUNCHES = dict.fromkeys(REPLACES, 0)


def masksum(tab, idx, device="cuda") -> torch.Tensor:
    """``(tab[idx[l], l] + idx[l]) mod rows`` (floor modulo, the sum
    wrapping as int32) for each lane of idx, from an int32 ``(rows, L)``
    table; the probe is 0 where idx is not a row. Returns idx's shape."""
    tab, idx = int32(tab, "tab"), int32(idx, "idx")
    if tab.dim() != 2 or tab.shape[1] != idx.numel():
        raise ValueError("tab must be (rows, L) with L = idx.numel()")
    dev, (tab, idx) = on(device, tab, idx)
    if dev.type == "cpu":
        return masksum_plain(tab, idx)
    out = torch.empty_like(idx)
    launch(LAUNCHES, "p6_masksum", "msp_p6_masksum", dev, tab.data_ptr(),
           idx.data_ptr(), out.data_ptr(), tab.shape[0], idx.numel())
    return out


def masksum_plain(tab, idx):
    acc = _probe_plain(tab, idx).long()
    return torch.remainder(wrap32(acc + idx.long()).long(),
                           tab.shape[0]).to(torch.int32)


def symbol_step(meta, limit, stream, x, steps=64, device="cuda"):
    """``steps`` mock symbols per lane from the seed x (int32, L elements);
    meta, limit, stream as P5's ``symbol_step``. Returns int32 acc +
    bitbuf in x's shape."""
    meta, limit, stream = check_symbol_inputs(meta, limit, stream)
    x = int32(x, "x")
    if x.numel() != meta.shape[1]:
        raise ValueError("x must have L elements")
    dev, (meta, limit, stream, x) = on(device, meta, limit, stream, x)
    if dev.type == "cpu":
        return symbol_step_plain(meta, limit, stream, x, steps)
    out = torch.empty_like(x)
    launch(LAUNCHES, "p6_symbol_step", "msp_p6_symbol_step", dev,
           meta.data_ptr(), limit.data_ptr(), stream.data_ptr(), x.data_ptr(),
           out.data_ptr(), x.numel(), steps)
    return out


def symbol_step_plain(meta, limit, stream, x, steps=64, work: Work = None):
    """Plain version of ``symbol_step``; ``work`` tallies what it read and
    each lane's chain: a step is the refill (its word's row is the last
    step's acc), the length find, the meta load and the rotate."""
    lanes = torch.arange(meta.shape[1])
    words = stream.long() & M32
    bitbuf = x.flatten().long() & M32
    acc = x.flatten().long()
    for _ in range(steps):
        if work is not None:
            work.read("stream", stream, acc & 31)
        bitbuf = bitbuf ^ words[acc & 31, lanes]
        length, code = len_find_plain(bitbuf & 0x7FFF, limit, work)
        mi = (code + length * 7) % N
        m = meta[mi, lanes].long()
        if work is not None:
            work.read("meta", meta, mi)
            work.add(3)
        consume = (length + (m & 7)) & 31
        bitbuf = ((bitbuf >> consume) | (bitbuf << (32 - consume))) & M32
        acc = acc + m
    return wrap32(acc + bitbuf).view(x.shape)


def bench_masksum(dev, SL, LN) -> Record:
    rng = np.random.RandomState(4)
    L = SL * LN
    tab = tensor(rng.randint(0, N, (N, L), dtype=np.int32))
    idx = tensor(rng.randint(0, N, (SL, LN), dtype=np.int32))
    tabd, idxd = tab.to(dev), idx.to(dev)
    out, ms = time_ms(lambda: masksum(tabd, idxd, dev), dev, reps=32)
    il = idxd.long().view(1, L)
    _, lib_ms = time_ms(lambda: torch.remainder(
        torch.gather(tabd, 0, il).view(SL, LN) + idxd, N), dev, reps=32)
    print(f"mask-sum {N} x {L} lanes: {ms * 1e3:.1f} us/probe-step  "
          f"{L / ms / 1e3:.1f} M probe/s  (torch.gather + remainder "
          f"{lib_ms * 1e3:.1f} us)", flush=True)
    return Record("p6_masksum", f"{N} x {L}", ms, out.cpu(),
                  lambda: masksum(tab, idx, "cpu"),
                  nbytes=12 * L, chain=2,
                  library_ms=lib_ms)


def bench_symbol_step(dev, SL, LN, T=64) -> Record:
    L = SL * LN
    ins = symbol_inputs(L, 5)
    x = tensor(np.random.RandomState(6).randint(0, 100, (SL, LN),
                                                dtype=np.int32))
    insd = [t.to(dev) for t in (*ins, x)]
    out, ms = time_ms(lambda: symbol_step(*insd, T, dev), dev, reps=4)
    per_sym = ms / 1e3 / T
    print(f"symbol-step lanes={L}: {per_sym * 1e9:.0f} ns/step  "
          f"{L / per_sym / 1e6:.1f} M sym/s  (~{L * 4 / per_sym / 1e6:.0f} "
          "MB/s at 4B/sym)", flush=True)
    work = Work(L)
    symbol_step_plain(*ins, x, T, work)
    return Record("p6_symbol_step", f"{L} lanes x {T}", ms, out.cpu(),
                  lambda: symbol_step(*ins, x, T, "cpu"),
                  nbytes=work.nbytes() + 8 * L,   # and x read, out written
                  chain=work.chain())


def bench_library(dev):
    """The tool's XLA rounds as PyTorch calls (library rows); small
    shapes on the CPU."""
    small = dev.type == "cpu"
    rng = np.random.RandomState(7)
    for H, LN in ([(4096, 128)] if small else [(32768, 128), (32768, 1024)]):
        p = tensor(rng.randint(0, H, (H, LN), dtype=np.int32)).to(dev)
        pl_ = p.long()
        _, ms = time_ms(lambda: torch.gather(p, 0, pl_), dev, reps=8)
        print(f"torch.gather axis0 ({H},{LN}): {ms:.3f} ms/round  "
              f"{H * LN / ms / 1e6:.2f} G elem/s", flush=True)
    T, H = (1 << 16 if small else 1 << 20), 1 << 15
    tab = tensor(rng.randint(0, T, H, dtype=np.int32)).to(dev)
    i0 = tensor(rng.randint(0, H, T, dtype=np.int32)).long().to(dev)
    _, ms = time_ms(lambda: torch.take(tab, i0), dev, reps=8)
    print(f"torch.take flat {T} from {H}: {ms:.3f} ms  "
          f"{T / ms / 1e3:.1f} M probe/s", flush=True)


def main(argv=(), device="cuda") -> list[Record]:
    which = argv[0] if argv else "all"
    dev, _ = on(device)
    print(header(dev), flush=True)
    records = []
    if which in ("all", "mask"):
        records += [bench_masksum(dev, 8, 128), bench_masksum(dev, 8, 1024)]
    if which in ("all", "sym"):
        records += [bench_symbol_step(dev, 8, 1024),
                    bench_symbol_step(dev, 8, 2048)]
    if which in ("all", "xla"):
        bench_library(dev)
    return records


if __name__ == "__main__":
    main(sys.argv[1:])
