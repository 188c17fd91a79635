"""P6: the chained gather probes.

The port of ``tools/micro_gather2.py``: P5's mask-sum probe followed by
``(acc + idx) mod N`` (``masksum``), and T steps of a mock symbol from a
seed per lane, with an xor refill and a rotate (``symbol_step``);
``csrc/probes_micro_gather2.cu`` says what each computes. The tool's XLA
rounds (pointer doubling by take_along_axis, a flat take) are timed here
as PyTorch calls, the library rows.

Both kernels have a Hopper redesign beside the faithful port
(``csrc/probes_gather2_smem.cu``, ``probes_gather2_core.cuh``):
``masksum(..., design="vec")`` gives a thread four lanes, with 16-byte
loads and stores of idx and out and four direct loads of the table
(``p6_masksum_vec``), and ``symbol_step(..., design="smem")`` holds each
block's 32-row word window in shared memory, so the refill that the last
step's meta chose is one shared-memory load, and exits the length find at
bl = 1 where it can (``p6_symbol_step_smem``).

Run on the card: ``python -m libmspack_tpu_torch.tools.micro_gather2
[all|mask|sym|xla]``. ``mask`` times both mask-sums at the tool's shapes in
turns beside ``torch.gather`` + ``remainder`` and a ``copy_`` of idx (one
launch that moves the same bytes: the floor of a one-launch kernel this
size), ``sym`` both symbol steps; each then holds its redesign to the
plain version on the edge inputs (``masksum_edges``, ``symbol_edges``).
"""
from __future__ import annotations

import sys

import numpy as np
import torch

from . import Record, Work, int32, launch, on, tensor, wrap32
from .micro_gather import (INT32_MAX, INT32_MIN, M32, check_symbol_inputs,
                           edge_records, int32_draw as _int32,
                           len_find_plain, masksum_bytes,
                           masksum_plain as _probe_plain,
                           on_card as _on_card, symbol_inputs)
from .timing import header, in_turns, print_turns, time_ms

N = 288

SOURCE = "probes_micro_gather2.cu"
REPLACES = {"p6_masksum": "tools/micro_gather2.py:25",
            "p6_symbol_step": "tools/micro_gather2.py:85",
            "p6_masksum_vec": "tools/micro_gather2.py:25",
            "p6_symbol_step_smem": "tools/micro_gather2.py:85"}
SOURCES = {"p6_masksum_vec": "probes_gather2_smem.cu",
           "p6_symbol_step_smem": "probes_gather2_smem.cu"}
LAUNCHES = dict.fromkeys(REPLACES, 0)
SLOPE_STEPS = 256   # the symbol steps also timed at 0 and this many steps


def masksum(tab, idx, device="cuda", design="faithful") -> torch.Tensor:
    """``(tab[idx[l], l] + idx[l]) mod rows`` (floor modulo, the sum
    wrapping as int32) for each lane of idx, from an int32 ``(rows, L)``
    table; the probe is 0 where idx is not a row. Returns idx's shape.
    ``design="vec"`` launches the vectorised gather."""
    tab, idx = int32(tab, "tab"), int32(idx, "idx")
    if tab.dim() != 2 or tab.shape[1] != idx.numel() or tab.shape[0] < 1:
        raise ValueError("tab must be (rows >= 1, L) with L = idx.numel()")
    if design not in ("faithful", "vec"):
        raise ValueError("design is 'faithful' or 'vec'")
    dev, (tab, idx) = on(device, tab, idx)
    if dev.type == "cpu":
        return masksum_plain(tab, idx)
    out = torch.empty_like(idx)
    ptrs = (tab.data_ptr(), idx.data_ptr(), out.data_ptr(), tab.shape[0],
            idx.numel())
    if design == "vec":
        launch(LAUNCHES, "p6_masksum_vec", "msp_p6_masksum_vec", dev, *ptrs)
    else:
        launch(LAUNCHES, "p6_masksum", "msp_p6_masksum", dev, *ptrs)
    return out


def masksum_plain(tab, idx):
    acc = _probe_plain(tab, idx).long()
    return torch.remainder(wrap32(acc + idx.long()).long(),
                           tab.shape[0]).to(torch.int32)


def symbol_step(meta, limit, stream, x, steps=64, device="cuda",
                design="faithful"):
    """``steps`` mock symbols per lane from the seed x (int32, L elements);
    meta, limit, stream as P5's ``symbol_step``. Returns int32 acc +
    bitbuf in x's shape. ``design="smem"`` launches the step with its
    word window in shared memory."""
    meta, limit, stream = check_symbol_inputs(meta, limit, stream)
    x = int32(x, "x")
    if x.numel() != meta.shape[1]:
        raise ValueError("x must have L elements")
    if design not in ("faithful", "smem"):
        raise ValueError("design is 'faithful' or 'smem'")
    dev, (meta, limit, stream, x) = on(device, meta, limit, stream, x)
    if dev.type == "cpu":
        return symbol_step_plain(meta, limit, stream, x, steps)
    out = torch.empty_like(x)
    ptrs = (meta.data_ptr(), limit.data_ptr(), stream.data_ptr(),
            x.data_ptr(), out.data_ptr(), x.numel(), steps)
    if design == "smem":
        launch(LAUNCHES, "p6_symbol_step_smem", "msp_p6_symbol_smem", dev,
               *ptrs)
    else:
        launch(LAUNCHES, "p6_symbol_step", "msp_p6_symbol_step", dev, *ptrs)
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


def masksum_edges():
    """The vec mask-sum's edge inputs, ``(label, unaligned, (tab, idx))``
    on the CPU: a part-full block (100 lanes), L % 4 != 0 (8194), idx and
    tab one element off 16-byte alignment (``unaligned``: made so on the
    device), and tab near INT32_MAX (the sum wraps); each with idx -1, N,
    INT32_MIN, 0, N - 1 and INT32_MAX in its first lanes, the rest in [-3,
    N + 3), and tab in [-N, N) (sums on both sides of the one-compare
    modulo) or over all of int32."""
    rng = np.random.RandomState(8)
    specials = [-1, N, INT32_MIN, 0, N - 1, INT32_MAX]
    cases = []
    for label, L, unaligned, lo, hi in (
            ("100 lanes", 100, False, -N, N),
            ("8194 lanes", 8194, False, INT32_MIN, INT32_MAX + 1),
            ("8192 lanes, unaligned", 8192, True, -N, N),
            ("128 lanes, tab near INT32_MAX", 128, False,
             INT32_MAX - 2 * N, INT32_MAX + 1)):
        tab = _int32(rng, lo, hi, (N, L))
        idx = _int32(rng, -3, N + 3, L)
        idx[:len(specials)] = specials
        cases.append((label, unaligned, (tensor(tab), tensor(idx))))
    return cases


def symbol_edges():
    """The staged symbol step's edge inputs, ``(label, unaligned, (meta,
    limit, stream, x))`` on the CPU: 100 lanes (a part-full
    block), 8194 (L % 4 != 0), 8192 one element off 16-byte alignment, and
    all limits 0 (length 15, code 0 at every step). Elsewhere limit row 1
    cycles through 0, -5, 2^15, 2^20, 1 and 2 (never, always or half the
    time the early exit), row bl of the others lies in [-2, 2^bl + 2) (the
    long find stops at every length), meta and x span int32 (negative
    seeds, acc wraps) and the words uint32."""
    rng = np.random.RandomState(9)
    cases = []
    for label, L, unaligned in (("100 lanes", 100, False),
                                ("8194 lanes", 8194, False),
                                ("8192 lanes, unaligned", 8192, True),
                                ("128 lanes, all limits 0", 128, False)):
        meta = _int32(rng, INT32_MIN, INT32_MAX + 1, (N, L))
        limit = np.zeros((16, L), np.int32)
        if "limits 0" not in label:
            for bl in range(1, 15):
                limit[bl] = rng.randint(-2, (1 << bl) + 2, L)
            limit[1] = np.resize([0, -5, 1 << 15, 1 << 20, 1, 2], L)
        stream = rng.randint(0, 1 << 32, (32, L), dtype=np.uint64) \
            .astype(np.uint32)
        x = _int32(rng, INT32_MIN, INT32_MAX + 1, L)
        cases.append((label, unaligned, (tensor(meta), tensor(limit),
                                         tensor(stream), tensor(x))))
    return cases


def bench_masksum(dev, SL, LN) -> list[Record]:
    """Both mask-sums at (SL, LN) lanes in turns beside ``torch.gather`` +
    ``remainder`` (the library row) and ``out.copy_(idx)``, the floor of
    one launch that reads and writes idx's bytes; each design's excess
    over that floor."""
    rng = np.random.RandomState(4)
    L = SL * LN
    tab = tensor(rng.randint(0, N, (N, L), dtype=np.int32))
    idx = tensor(rng.randint(0, N, (SL, LN), dtype=np.int32))
    tabd, idxd = tab.to(dev), idx.to(dev)
    il = idxd.long().view(1, L)
    floor_out = torch.empty_like(idxd)
    runs = {"faithful": lambda: masksum(tabd, idxd, dev),
            "vec": lambda: masksum(tabd, idxd, dev, "vec"),
            "torch.gather + remainder": lambda: torch.remainder(
                torch.gather(tabd, 0, il).view(SL, LN) + idxd, N),
            "copy_ floor": lambda: floor_out.copy_(idxd)}
    outs, ms = in_turns(runs, dev, reps=32)
    print_turns(f"mask-sum {N} x {L} lanes", ms, dev)
    print(f"mask-sum {N} x {L} lanes: vec {L / ms['vec'] / 1e3:.1f} M "
          "probe/s", flush=True)
    return [Record(f"p6_masksum{'' if d == 'faithful' else '_vec'}",
                   f"{N} x {L}", ms[d], outs[d].cpu(),
                   lambda d=d: masksum(tab, idx, "cpu", d),
                   nbytes=12 * L, chain=2,
                   library_ms=ms["torch.gather + remainder"])
            for d in ("faithful", "vec")]


def bench_symbol_step(dev, SL, LN, T=64) -> list[Record]:
    """Both symbol steps at (SL, LN) lanes in turns, at T steps and, for
    each design's launch and fill apart from its cost a step, at 0 and
    SLOPE_STEPS steps."""
    L = SL * LN
    ins = symbol_inputs(L, 5)
    x = tensor(np.random.RandomState(6).randint(0, 100, (SL, LN),
                                                dtype=np.int32))
    insd = [t.to(dev) for t in (*ins, x)]
    designs = ("faithful", "smem")
    outs, ms = in_turns({(d, t): lambda d=d, t=t: symbol_step(*insd, t, dev, d)
                         for d in designs for t in (T, 0, SLOPE_STEPS)},
                        dev, reps=32)
    work = Work(L)
    symbol_step_plain(*ins, x, T, work)
    records = []
    for d in designs:
        per_sym = ms[d, T] / 1e3 / T
        step = (ms[d, SLOPE_STEPS] - ms[d, 0]) / SLOPE_STEPS
        print(f"symbol-step {d} lanes={L}: {ms[d, T]:.4f} ms, "
              f"{per_sym * 1e9:.0f} ns/step  {L / per_sym / 1e6:.1f} M sym/s "
              f" (~{L * 4 / per_sym / 1e6:.0f} MB/s at 4B/sym); launch and "
              f"fill {ms[d, 0] * 1e3:.2f} us, then {step * 1e6:.1f} ns a step "
              f"(0 and {SLOPE_STEPS} steps)", flush=True)
        records.append(Record(
            "p6_symbol_step" + ("" if d == "faithful" else "_smem"),
            f"{L} lanes x {T}", ms[d, T], outs[d, T].cpu(),
            lambda d=d: symbol_step(*ins, x, T, "cpu", d),
            nbytes=work.nbytes() + 8 * L,   # and x read, out written
            chain=work.chain()))
    return records


def edge_masksums(dev) -> list[Record]:
    """The vec mask-sum on each of ``masksum_edges()``."""
    return edge_records(dev, "p6_masksum_vec", masksum_edges(),
                        lambda tab, idx, d: masksum(tab, idx, d, "vec"),
                        masksum_bytes, 2)


def edge_symbol_steps(dev, T=64) -> list[Record]:
    """The staged symbol step, T steps, on each of ``symbol_edges()``."""
    records = []
    for label, unaligned, ins in symbol_edges():
        insd = _on_card(dev, ins, unaligned)
        out, ms = time_ms(lambda: symbol_step(*insd, T, dev, "smem"), dev,
                          reps=4)
        print(f"symbol-step smem, {label} x {T}: {ms:.4f} ms", flush=True)
        work = Work(ins[0].shape[1])
        symbol_step_plain(*ins, T, work)
        records.append(Record(
            "p6_symbol_step_smem", f"{label} x {T}", ms, out.cpu(),
            lambda ins=ins: symbol_step(*ins, T, "cpu"),
            nbytes=work.nbytes() + 8 * ins[0].shape[1], chain=work.chain(),
            edge=True))
    return records


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
        records += bench_masksum(dev, 8, 128) + bench_masksum(dev, 8, 1024)
        records += edge_masksums(dev)
    if which in ("all", "sym"):
        records += bench_symbol_step(dev, 8, 1024)
        records += bench_symbol_step(dev, 8, 2048)
        records += edge_symbol_steps(dev)
    if which in ("all", "xla"):
        bench_library(dev)
    return records


if __name__ == "__main__":
    main(sys.argv[1:])
