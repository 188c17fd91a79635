"""P2: the skeleton of a lane-parallel entropy decoder.

The port of ``tools/micro_skel.py``. One lane per stream row runs T steps
of stream refill through a 64-word window (16 lanes re-windowed per step),
a mock canonical decode (a 14-step length find and a 288-key sweep) and a
token row per step (``csrc/probes_micro_skel.cu`` says what each step
computes and where it follows JAX's integer semantics). A lane not yet
windowed reads a zero window, where the TPU kernel read uninitialised
VMEM, and a window copy started in a step is visible to that step's read,
as in Pallas interpret mode. As written, the mock decode never finds a key
(sym is always 0), so the outputs do not depend on the stream.

The kernel has a Hopper redesign beside the faithful port
(``csrc/probes_skel_vec.cu``, ``probes_skel_core.cuh``): ``skel(...,
design="vec")`` is one launch that writes all 256 token rows and cnt
(``p2_skel_vec``): its decode blocks take one lane a thread, and blocks
of the same grid zero the rows no step writes, 16 bytes a store.

Run on the card: ``python -m libmspack_tpu_torch.tools.micro_skel [L]
[steps]``. Both designs are timed in turns (``timing.in_turns``) beside
``out.copy_(seed)``, one launch that reads and writes the seed's L int32:
the floor of a one-launch kernel this size, and beside ``torch.zeros`` of
the token rows, the fill that each faithful call launches before its
kernel. The redesign then runs on the edge inputs of ``edges()``.
"""
from __future__ import annotations

import sys

import numpy as np
import torch

from . import Record, Work, int32, launch, log2c, on, tensor, wrap32
from .micro_gather import edge_records
from .timing import header, in_turns, print_turns

WIN = 64          # words per lane window
G = 16            # lanes re-windowed per step
NOUT = 256        # token rows
W = 4096          # stream words per lane in the tool's run
NKEYS = 288
M32 = 0xFFFFFFFF

SOURCE = "probes_micro_skel.cu"
REPLACES = {"p2_skel": "tools/micro_skel.py:118",
            "p2_skel_vec": "tools/micro_skel.py:118"}
SOURCES = {"p2_skel_vec": "probes_skel_vec.cu"}
LAUNCHES = dict.fromkeys(REPLACES, 0)


def skel(stream, seed, steps=64, device="cuda", design="faithful"):
    """The tool's kernel. stream: ``(L, W)`` uint32 words (or their int32
    bits), seed: int32 with L elements (the tool's ``(8, L // 8)``).
    Returns ``(out int32 (256, *seed.shape), cnt int32 seed.shape)``: row
    t mod 256 of out holds step t's sym + acc (rows past the last step 0),
    cnt = acc + the words each lane consumed. Needs steps + 64 <= W.
    ``design="vec"`` launches the redesign, one launch that writes every
    row."""
    stream = int32(stream, "stream")
    seed = int32(seed, "seed")
    if stream.dim() != 2 or seed.numel() != stream.shape[0]:
        raise ValueError("stream must be (L, W) with L = seed.numel()")
    if steps + WIN > stream.shape[1]:
        raise ValueError(f"steps + {WIN} must not exceed W "
                         f"({stream.shape[1]})")
    if design not in ("faithful", "vec"):
        raise ValueError("design is 'faithful' or 'vec'")
    dev, (stream, seed) = on(device, stream, seed)
    if dev.type == "cpu":
        return skel_plain(stream, seed, steps)
    cnt = torch.empty_like(seed)
    if design == "vec":
        out = torch.empty((NOUT, *seed.shape), dtype=torch.int32, device=dev)
        kernel, entry = "p2_skel_vec", "msp_p2_skel_vec"
    else:
        out = torch.zeros((NOUT, *seed.shape), dtype=torch.int32, device=dev)
        kernel, entry = "p2_skel", "msp_p2_skel"
    launch(LAUNCHES, kernel, entry, dev, stream.data_ptr(), stream.shape[1],
           seed.data_ptr(), seed.numel(), steps, G, WIN, out.data_ptr(),
           cnt.data_ptr())
    return out, cnt


def skel_plain(stream, seed, steps=64, work: Work = None):
    """Plain version of ``skel``, all lanes at once. ``work`` tallies the
    stream words it used and each lane's chain: a step is the refill, the
    length find, the key search and the consume."""
    L, nw = stream.shape
    lanes = torch.arange(L)
    words = stream.long() & M32
    bitlo = seed.flatten().long() & M32
    acc = seed.flatten().long()
    bithi, navail, wpos, base = (torch.zeros(L, dtype=torch.int64)
                                 for _ in range(4))
    windowed = torch.zeros(L, dtype=torch.bool)
    n = torch.arange(NKEYS)[:, None]
    keys = (n * 1315423911) & 0xFFFFF   # JAX's int32 product mod 2^20
    out = torch.zeros((NOUT, L), dtype=torch.int32)
    for t in range(steps):
        fresh = (torch.ones(L, dtype=torch.bool) if L <= G
                 else (lanes - t * G) % L < G)
        base = torch.where(fresh, wpos, base)
        windowed |= fresh
        off = wpos - base
        inwin = windowed & (off >= 0) & (off < WIN)
        w = torch.where(inwin, words[lanes, wpos.clamp(0, nw - 1)], 0)
        need = navail <= 31
        if work is not None:
            work.read("stream", stream.T, wpos.clamp(0, nw - 1),
                      inwin & need)
        bitlo = torch.where(need & (navail == 0), w, bitlo)
        top = need & (navail > 0)
        bithi = torch.where(top, bithi | (w >> torch.where(top, 32 - navail,
                                                           0)), bithi)
        navail = torch.where(need, navail + 32, navail)
        wpos = wpos + need.long()
        peek = bitlo & 0x7FFF
        length = torch.full((L,), 15, dtype=torch.int64)
        code = torch.zeros(L, dtype=torch.int64)
        for bl in range(1, 15):
            c = peek >> (15 - bl)
            hit = (c < (bl * 37) % 97) & (length == 15)
            length = torch.where(hit, bl, length)
            code = torch.where(hit, c, code)
        key = (length << 16) | code
        if work is not None:   # the compares in a row, at most a tree
            work.add(length.clamp(max=log2c(14)) + log2c(NKEYS) + 2)
        sym = torch.where(keys == key, n, 0).amax(0)
        consume = sym % 15 + 1
        bitlo = ((bitlo >> consume) | (bithi << (32 - consume))) & M32
        bithi = bithi >> consume
        navail = navail - consume
        out[t % NOUT] = wrap32(sym + acc)
        acc = acc + sym
    return (out.view(NOUT, *seed.shape),
            wrap32(acc + wpos).view(seed.shape))


def bound_inputs(stream, seed, T) -> tuple[int, int]:
    """A run's bytes (the stream words it uses and the seed read; out's
    rows and cnt written, 4 bytes each) and its chain (the longest lane's
    steps, and the count's store at T = 0), from the plain version's
    tally."""
    L = seed.numel()
    work = Work(L)
    skel_plain(stream, seed, T, work)
    return work.nbytes() + 4 * (L + NOUT * L + L), max(1, work.chain())


def edges(L=1024):
    """The redesign's edge inputs, ``(label, unaligned, (stream, seed),
    T)`` on the CPU, W = 4096, seeds over [-2^20, 2^20): 8 lanes (every
    lane re-windowed twice a step), 16 (G: all once), 100 (L % 4 != 0:
    the zero blocks store an element at a time) at T = 64; T = 0 (every
    row zeroed), 256 (no zero block) and 300 (rows overwritten) at L
    lanes; and the seed and stream as views one element off 16-byte
    alignment (``unaligned``: made so on the device)."""
    rng = np.random.RandomState(3)
    cases = []
    for label, n, T, unaligned in (
            ("L=8", 8, 64, False), ("L=16", 16, 64, False),
            ("L=100", 100, 64, False), (f"L={L}, T=0", L, 0, False),
            (f"L={L}, T=256", L, 256, False),
            (f"L={L}, T=300", L, 300, False),
            (f"L={L}, unaligned", L, 64, True)):
        stream = tensor(rng.randint(0, 1 << 30, (n, W)).astype(np.uint32))
        seed = tensor(rng.randint(-(1 << 20), 1 << 20, n).astype(np.int32))
        cases.append((label, unaligned, (stream, seed), T))
    return cases


def edge_runs(dev, L) -> list[Record]:
    """The redesign on its inputs of ``edges(L)``."""
    def flat(o, c):
        return torch.cat([o.flatten(), c.flatten()])

    records = []
    for label, unaligned, ins, T in edges(L):
        nb, chain = bound_inputs(*ins, T)
        records += edge_records(
            dev, "p2_skel_vec", [(label, unaligned, ins)],
            lambda st, sd, d, T=T: flat(*skel(st, sd, T, d, "vec")),
            lambda *_, nb=nb: nb, chain)
    return records


def main(argv=(), device="cuda") -> list[Record]:
    dev, _ = on(device)
    L = int(argv[0]) if argv else (64 if dev.type == "cpu" else 1024)
    T = int(argv[1]) if len(argv) > 1 else 64
    print(header(dev), flush=True)
    rng = np.random.RandomState(0)
    stream = tensor(rng.randint(0, 1 << 30, (L, W)).astype(np.uint32))
    seed = torch.zeros((8, L // 8), dtype=torch.int32)
    sd, seedd = stream.to(dev), seed.to(dev)
    floor_out = torch.empty_like(seedd)
    outs, times = in_turns(
        {"faithful": lambda: skel(sd, seedd, T, dev),
         "vec": lambda: skel(sd, seedd, T, dev, "vec"),
         "copy_ floor": lambda: floor_out.copy_(seedd),
         "zero fill": lambda: torch.zeros((NOUT, L), dtype=torch.int32,
                                          device=dev)}, dev, reps=32)
    print_turns(f"L={L}, T={T}", times, dev)
    for d in ("faithful", "vec"):
        per_step = times[d] / 1e3 / T
        print(f"L={L} {d}: {per_step * 1e6:.2f} us/step  "
              f"{L / per_step / 1e6:.1f} M lane-steps/s  "
              f"(~{L * 2.2 / per_step / 1e6:.0f} MB/s at 2.2 B/step)",
              flush=True)

    def plain():
        o, c = skel(stream, seed, T, "cpu")
        return torch.cat([o.flatten(), c.flatten()])

    nb, chain = bound_inputs(stream, seed, T)
    records = [Record("p2_skel" + ("" if d == "faithful" else "_vec"),
                      f"L={L}, T={T}", times[d],
                      torch.cat([outs[d][0].cpu().flatten(),
                                 outs[d][1].cpu().flatten()]),
                      plain, nb, chain)
               for d in ("faithful", "vec")]
    return records + edge_runs(dev, L)


if __name__ == "__main__":
    main(sys.argv[1:])
