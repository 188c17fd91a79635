"""P5: per-lane gathers, the primitives of an entropy decoder.

The port of ``tools/micro_gather.py``: a gather along either axis of an
(H, L) table (``dyngather``), a per-lane probe of a 288-row table by the
TPU's compare/select sweep (``masksum``), and 256 steps of a mock DEFLATE
symbol (``symbol_step``: refill, 14-compare length find, meta probe,
consume); ``csrc/probes_micro_gather.cu`` says what each computes. Tables
are ``(rows, L)``, lane l in column l. Beside each gather, PyTorch's own
call (``torch.gather``, ``torch.take``) is timed as the library row, as the
tool timed XLA's.

Each kernel has a Hopper redesign beside the faithful port:
``dyngather(..., axis=0, design="cluster")`` holds each tile of 4 columns
of the table in the shared memory of a thread-block cluster
(``p5_dyngather_axis0_cluster``), and ``symbol_step(..., design="smem")``
stages each block's tables in shared memory and finds the code length
without a branch (``p5_symbol_step_smem``; both
``csrc/probes_gather_cluster.cu``); ``dyngather(..., axis=1,
design="row")`` copies each row of the table into a block's shared memory
while it loads the indices (``p5_dyngather_axis1_row``), and
``masksum(..., design="vec")`` gives a thread four lanes on P6's
vectorised core (``p5_masksum_vec``; both ``csrc/probes_gather_row.cu``).
``probes_gather_core.cuh`` and ``probes_gather2_core.cuh`` hold their
functions.

Run on the card: ``python -m libmspack_tpu_torch.tools.micro_gather``.
It times the axis-0 designs at every shape the faithful kernel runs, the
axis-1 gathers and the mask-sums in turns beside ``torch.gather`` and a
``copy_`` of idx (one launch that moves the same bytes: the floor of a
one-launch kernel this size), both symbol steps, then each redesign on
edge inputs (a rank boundary that is no power of two, clamped indices, a
tail tile, unaligned inputs, a part-full block, L % 4 != 0, the widest
staged row), and at (32768, 128) both axis-0 gathers in turns: warm, with
the table out of L2, and with each element reading its own row, which
prices a random read from L2 and through the cluster's shared window
(``compare_in_turns``).
"""
from __future__ import annotations

import ctypes
import sys

import numpy as np
import torch

from . import Record, Work, int32, launch, log2c, on, tensor, wrap32
from .timing import header, in_turns, print_turns, time_cold_ms, time_ms

N = 288            # rows of a per-lane table
M32 = 0xFFFFFFFF
INT32_MIN, INT32_MAX = -(1 << 31), (1 << 31) - 1
GATHER_SHAPES = [(0, 8, 128), (0, 16, 128), (0, 32, 128), (0, 288, 128),
                 (0, 1024, 128), (0, 4096, 128), (0, 32768, 128),
                 (0, 288, 1024), (0, 1024, 1024)]
AXIS1_SHAPES = [(8, 128), (8, 1024), (64, 128)]
ROW_MAX = 12288    # the widest row the row gather stages (48 KiB)
MASKSUM_SHAPES = [(8, 128), (8, 1024)]
SYMBOL_LANES = 8 * 1024
SYMBOL_T = 256
COLD_SHAPE = (32768, 128)   # the axis-0 shape also timed in turns
# the redesigns' edge shapes (H, L): 41 rows a rank at 8 blocks, a ragged
# last rank, ranks with no rows and a tail tile, one row
EDGE_GATHERS = [(328, 8), (37, 12), (5, 3), (1, 12)]
EDGE_LANES = 100     # the staged symbol step with a part-full block

SOURCE = "probes_micro_gather.cu"
REPLACES = {"p5_dyngather_axis0": "tools/micro_gather.py:67",
            "p5_dyngather_axis1": "tools/micro_gather.py:82",
            "p5_masksum": "tools/micro_gather.py:132",
            "p5_symbol_step": "tools/micro_gather.py:206",
            "p5_dyngather_axis0_cluster": "tools/micro_gather.py:67",
            "p5_symbol_step_smem": "tools/micro_gather.py:206",
            "p5_dyngather_axis1_row": "tools/micro_gather.py:82",
            "p5_masksum_vec": "tools/micro_gather.py:132"}
SOURCES = {"p5_dyngather_axis0_cluster": "probes_gather_cluster.cu",
           "p5_symbol_step_smem": "probes_gather_cluster.cu",
           "p5_dyngather_axis1_row": "probes_gather_row.cu",
           "p5_masksum_vec": "probes_gather_row.cu"}
LAUNCHES = dict.fromkeys(REPLACES, 0)


def dyngather(t, i, axis, device="cuda", design="faithful",
              info: dict = None) -> torch.Tensor:
    """``take_along_axis(t, i, axis)`` for int32 ``(H, L)`` t and i; an
    index outside its axis is clamped to it. ``design="cluster"`` (axis 0
    only) launches the cluster gather, whose C entry picks the blocks a
    cluster from H, L and the card's SMs and fails (RuntimeError) where 8
    blocks cannot hold a tile; ``info`` (a dict) receives that count as
    ``info["cluster"]``. ``design="row"`` (axis 1 only) launches the row
    gather, which stages each row of t in a block's shared memory and
    refuses (ValueError) rows wider than ROW_MAX."""
    t, i = int32(t, "t"), int32(i, "i", t.shape)
    if t.dim() != 2 or axis not in (0, 1):
        raise ValueError("t must be 2-D and axis 0 or 1")
    if design not in ("faithful", "cluster", "row") or \
            (design == "cluster" and axis != 0) or \
            (design == "row" and axis != 1):
        raise ValueError("design is 'faithful', 'cluster' on axis 0 or "
                         "'row' on axis 1")
    H, L = t.shape
    if design == "row" and L > ROW_MAX:
        raise ValueError(f"the row gather stages rows of at most {ROW_MAX} "
                         f"elements, not {L}")
    dev, (t, i) = on(device, t, i)
    if dev.type == "cpu":
        return dyngather_plain(t, i, axis)
    out = torch.empty_like(t)
    if design == "cluster":
        S = ctypes.c_int(0)
        launch(LAUNCHES, "p5_dyngather_axis0_cluster",
               "msp_p5_dyngather_cluster", dev, t.data_ptr(), i.data_ptr(),
               out.data_ptr(), H, L, ctypes.addressof(S))
        if info is not None:
            info["cluster"] = S.value
    elif design == "row":
        launch(LAUNCHES, "p5_dyngather_axis1_row", "msp_p5_dyngather_row",
               dev, t.data_ptr(), i.data_ptr(), out.data_ptr(), H, L)
    else:
        launch(LAUNCHES, f"p5_dyngather_axis{axis}", "msp_p5_dyngather",
               dev, t.data_ptr(), i.data_ptr(), out.data_ptr(), H, L, axis)
    return out


def dyngather_plain(t, i, axis):
    H, L = t.shape
    if axis == 0:
        return t[i.long().clamp(0, H - 1), torch.arange(L)]
    return t[torch.arange(H)[:, None], i.long().clamp(0, L - 1)]


def masksum(tab, idx, device="cuda", design="faithful") -> torch.Tensor:
    """``tab[idx[l], l]`` for each lane l of idx (any shape, L elements)
    from an int32 ``(rows, L)`` table, 0 where idx is not a row; the
    faithful kernel sweeps every row as the TPU did, ``design="vec"``
    gives a thread four lanes and reads each lane's row directly. Returns
    idx's shape."""
    tab, idx = int32(tab, "tab"), int32(idx, "idx")
    if tab.dim() != 2 or tab.shape[1] != idx.numel():
        raise ValueError("tab must be (rows, L) with L = idx.numel()")
    if design not in ("faithful", "vec"):
        raise ValueError("design is 'faithful' or 'vec'")
    dev, (tab, idx) = on(device, tab, idx)
    if dev.type == "cpu":
        return masksum_plain(tab, idx)
    out = torch.empty_like(idx)
    ptrs = (tab.data_ptr(), idx.data_ptr(), out.data_ptr(), tab.shape[0],
            idx.numel())
    if design == "vec":
        launch(LAUNCHES, "p5_masksum_vec", "msp_p5_masksum_vec", dev, *ptrs)
    else:
        launch(LAUNCHES, "p5_masksum", "msp_p5_masksum", dev, *ptrs)
    return out


def masksum_plain(tab, idx):
    rows, L = tab.shape
    i = idx.flatten().long()
    got = tab[i.clamp(0, rows - 1), torch.arange(L)]
    return torch.where((i >= 0) & (i < rows), got, 0).view(idx.shape)


def check_symbol_inputs(meta, limit, stream):
    """(meta, limit, stream) as contiguous int32 of the shapes
    ``symbol_step`` takes; raises on others."""
    meta = int32(meta, "meta")
    L = meta.shape[1] if meta.dim() == 2 else -1
    if meta.shape != (N, L):
        raise ValueError(f"meta must be ({N}, L)")
    return (meta, int32(limit, "limit", (16, L)),
            int32(stream, "stream", (32, L)))


def symbol_step(meta, limit, stream, steps=SYMBOL_T, device="cuda",
                design="faithful"):
    """``steps`` mock DEFLATE symbols per lane: meta int32 ``(288, L)``,
    limit int32 ``(16, L)`` (rows 1-14 used), stream ``(32, L)`` uint32
    words (or their int32 bits). Returns each lane's sum of meta, int32
    ``(L,)`` (the tool's ``(8, L // 8)`` flattened). ``design="smem"``
    launches the staged step."""
    meta, limit, stream = check_symbol_inputs(meta, limit, stream)
    if design not in ("faithful", "smem"):
        raise ValueError("design is 'faithful' or 'smem'")
    dev, (meta, limit, stream) = on(device, meta, limit, stream)
    if dev.type == "cpu":
        return symbol_step_plain(meta, limit, stream, steps)
    L = meta.shape[1]
    out = torch.empty(L, dtype=torch.int32, device=dev)
    ptrs = (meta.data_ptr(), limit.data_ptr(), stream.data_ptr(),
            out.data_ptr(), L, steps)
    if design == "smem":
        launch(LAUNCHES, "p5_symbol_step_smem", "msp_p5_symbol_smem", dev,
               *ptrs)
    else:
        launch(LAUNCHES, "p5_symbol_step", "msp_p5_symbol_step", dev, *ptrs)
    return out


def len_find_plain(peek, limit, work: Work = None):
    """The mock canonical length find on all lanes: the first bl in 1..14
    with peek >> (15 - bl) below limit[bl], else (15, 0). ``work`` tallies
    the limits each lane compared and the compares in a row (at most a
    tree over all 14)."""
    length = torch.full_like(peek, 15)
    code = torch.zeros_like(peek)
    for bl in range(1, 15):
        c = peek >> (15 - bl)
        searching = length == 15
        if work is not None:
            work.read("limit", limit, bl, searching)
        hit = (c < limit[bl].long()) & searching
        length = torch.where(hit, bl, length)
        code = torch.where(hit, c, code)
    if work is not None:
        work.add(length.clamp(max=log2c(14)))
    return length, code


def symbol_step_plain(meta, limit, stream, steps=SYMBOL_T,
                      work: Work = None):
    """Plain version of ``symbol_step``; ``work`` tallies what it read and
    each lane's chain: a step is the refill, the length find, the meta
    load and the consume."""
    L = meta.shape[1]
    lanes = torch.arange(L)
    words = stream.long() & M32
    bitbuf, navail, widx, acc = (torch.zeros(L, dtype=torch.int64)
                                 for _ in range(4))
    for _ in range(steps):
        w = words[widx & 31, lanes]
        refill = navail < 32
        bitbuf = torch.where(refill, (bitbuf | (w << navail)) & M32, bitbuf)
        navail = (navail + 32).clamp(max=32)
        length, code = len_find_plain(bitbuf & 0x7FFF, limit, work)
        mi = (code + length * 7) % N
        m = meta[mi, lanes].long()
        if work is not None:
            work.read("stream", stream, widx & 31, refill)
            work.read("meta", meta, mi)
            work.add(3)
        consume = length + (m & 7)
        bitbuf = bitbuf >> consume
        navail = navail - consume
        widx = widx + 1
        acc = acc + m
    return wrap32(acc)


def bench_library(dev):
    """The tool's XLA gathers as PyTorch calls (library rows); small
    shapes on the CPU."""
    print("== library gathers (torch.gather, torch.take) ==", flush=True)
    rng = np.random.RandomState(0)
    shapes = [(288, 1024), (1024, 1024)] if dev.type == "cpu" else \
        [(32768, 128), (32768, 1024), (288, 1024), (1024, 1024)]
    for H, L in shapes:
        table = tensor(rng.randint(0, H, (H, L), dtype=np.int32)).to(dev)
        idx = tensor(rng.randint(0, H, (H, L), dtype=np.int32)).long().to(dev)
        _, ms = time_ms(lambda: torch.gather(table, 0, idx), dev)
        print(f"  gather axis0 ({H},{L}): {ms:.3f} ms  "
              f"{H * L / ms / 1e6:.2f} G elem/s", flush=True)
    table = torch.arange(32768, dtype=torch.int32, device=dev)
    idx = tensor(rng.randint(0, 32768, 1024, dtype=np.int32)).long().to(dev)
    _, ms = time_ms(lambda: torch.take(table, idx), dev)
    print(f"  flat take (1024 from 32768): {ms:.3f} ms "
          f"{1024 / ms / 1e3:.2f} M probe/s", flush=True)


def bench_gather(dev) -> list[Record]:
    """Each axis-0 shape of GATHER_SHAPES through the faithful kernel and
    the cluster gather, beside ``torch.gather``; at COLD_SHAPE both in
    turns (``compare_in_turns``); then the cluster gather's edge shapes
    (``edge_gathers``)."""
    print("== dynamic gather kernel ==", flush=True)
    rng = np.random.RandomState(1)
    records = []
    for axis, H, L in GATHER_SHAPES:
        if dev.type == "cpu" and H * L > 1 << 17:   # small on the CPU
            continue
        t = tensor(rng.randint(0, 100, (H, L), dtype=np.int32))
        i = tensor(rng.randint(0, H if axis == 0 else L, (H, L),
                               dtype=np.int32))
        td, id_ = t.to(dev), i.to(dev)
        out, ms = time_ms(lambda: dyngather(td, id_, axis, dev), dev)
        il = id_.long()
        _, lib_ms = time_ms(lambda: torch.gather(td, axis, il), dev)
        print(f"  dg axis{axis} ({H},{L}): {ms:.4f} ms  "
              f"{H * L / ms / 1e6:.2f} G elem/s  (torch.gather "
              f"{lib_ms:.4f} ms)", flush=True)
        records.append(Record(
            f"p5_dyngather_axis{axis}", f"({H},{L})", ms, out.cpu(),
            lambda t=t, i=i, a=axis: dyngather(t, i, a, "cpu"),
            nbytes=12 * H * L, chain=1, library_ms=lib_ms))
        info = {}
        out, ms = time_ms(
            lambda: dyngather(td, id_, 0, dev, "cluster", info), dev)
        print(f"  dg axis0 cluster ({H},{L}), {info.get('cluster')} blocks "
              f"a cluster: {ms:.4f} ms  {H * L / ms / 1e6:.2f} G elem/s",
              flush=True)
        records.append(Record(
            "p5_dyngather_axis0_cluster", f"({H},{L})", ms, out.cpu(),
            lambda t=t, i=i: dyngather(t, i, 0, "cpu"),
            nbytes=12 * H * L, chain=1, library_ms=lib_ms))
        if (H, L) == COLD_SHAPE and dev.type == "cuda":
            compare_in_turns(td, id_, dev)
    return records + edge_gathers(dev)


def edge_gathers(dev) -> list[Record]:
    """The cluster gather on EDGE_GATHERS, each with indices below 0 and
    past H (clamped) beside random ones, at H = 328 also each rank
    boundary 41 m and the row under it; (37, 12) once more with t and idx
    4 bytes off 16-byte alignment (the kernel's element paths)."""
    rng = np.random.RandomState(4)
    records = []
    for H, L, unaligned in [(H, L, False) for H, L in EDGE_GATHERS] + \
            [(37, 12, True)]:
        t = tensor(rng.randint(-1 << 31, 1 << 31, (H, L), dtype=np.int64)
                   .astype(np.int32))
        i = rng.randint(-3, H + 6, (H, L)).astype(np.int32)
        i.flat[:4] = [-3, 0, H - 1, H + 5]
        if H == 328:
            edges = [41 * m + d for m in range(1, 8) for d in (-1, 0)]
            i.flat[4:4 + len(edges)] = edges
        i = tensor(i)
        td, id_ = t.to(dev), i.to(dev)
        if unaligned:
            td, id_ = (torch.cat([torch.zeros(1, dtype=torch.int32,
                                              device=dev), x.flatten()])[1:]
                       .view(H, L) for x in (td, id_))
        info = {}
        out, ms = time_ms(
            lambda: dyngather(td, id_, 0, dev, "cluster", info), dev)
        label = f"({H},{L}) edges" + (", unaligned" if unaligned else "")
        print(f"  dg axis0 cluster {label}, {info.get('cluster')} blocks a "
              f"cluster: {ms:.4f} ms", flush=True)
        records.append(Record(
            "p5_dyngather_axis0_cluster", label, ms, out.cpu(),
            lambda t=t, i=i: dyngather(t, i, 0, "cpu"),
            nbytes=12 * H * L, chain=1))
    return records


def compare_in_turns(td, id_, dev, rounds=3) -> None:
    """The faithful and the cluster axis-0 gather in turns (ABBA, ``rounds``
    times; each line the mean per run): warm (as ``time_ms``) and with the
    table out of L2 (``time_cold_ms``) on the tool's random idx, and warm
    with each element reading its own row (idx = h: the faithful kernel's
    reads of t coalesce, the cluster kernel's stay in the block's own rows,
    in order). Random less own row, over the H L reads, is what a random
    4-byte read costs from L2 and through the cluster's shared window."""
    H, L = td.shape
    own = torch.arange(H, dtype=torch.int32, device=dev)[:, None] \
        .expand(H, L).contiguous()
    runs = {"faithful": lambda: dyngather(td, id_, 0, dev),
            "cluster": lambda: dyngather(td, id_, 0, dev, "cluster"),
            "faithful own row": lambda: dyngather(td, own, 0, dev),
            "cluster own row": lambda: dyngather(td, own, 0, dev, "cluster")}
    warm = None
    for kind, timer, names in (("warm", time_ms, list(runs)),
                               ("L2 cold", time_cold_ms, list(runs)[:2])):
        _, ms = in_turns({name: runs[name] for name in names}, dev, rounds,
                         timer=timer)
        warm = warm or ms
        print(f"  dg axis0 ({H},{L}) in turns, {kind}, mean of "
              f"{2 * rounds}: " + ", ".join(f"{k} {v:.4f} ms"
                                            for k, v in ms.items()),
              flush=True)
    for name in ("faithful", "cluster"):
        cost = warm[name] - warm[f"{name} own row"]
        print(f"  {name}: {H * L / 1e6:.2f} M random reads add {cost:.4f} "
              f"ms over own rows, {H * L / cost / 1e6:.1f} G reads/s",
              flush=True)


def int32_draw(rng, lo, hi, shape) -> np.ndarray:
    """int32 values drawn from [lo, hi), which may span all of int32."""
    return rng.randint(lo, hi, shape, dtype=np.int64).astype(np.int32)


def on_card(dev, inputs, unaligned):
    """The inputs on dev; ``unaligned``: each a view one element into a
    copy, so its data is 4 bytes off 16-byte alignment."""
    out = [t.to(dev) for t in inputs]
    if unaligned:
        out = [torch.cat([t.new_zeros(1), t.flatten()])[1:].view(t.shape)
               for t in out]
    return out


def bench_axis1(dev) -> list[Record]:
    """Each shape of AXIS1_SHAPES: the faithful and the row gather in
    turns (``timing.in_turns``) beside ``torch.gather`` (the library row)
    and ``out.copy_(i)``, the floor of one launch that reads and writes
    idx's bytes, with each design's excess over that floor; then the row
    gather on ``row_edges()``."""
    print("== axis-1 gather, in turns ==", flush=True)
    rng = np.random.RandomState(1)
    records = []
    for H, L in AXIS1_SHAPES:
        t = tensor(rng.randint(0, 100, (H, L), dtype=np.int32))
        i = tensor(rng.randint(0, L, (H, L), dtype=np.int32))
        td, id_ = t.to(dev), i.to(dev)
        il = id_.long()
        floor_out = torch.empty_like(id_)
        outs, ms = in_turns(
            {"faithful": lambda: dyngather(td, id_, 1, dev),
             "row": lambda: dyngather(td, id_, 1, dev, "row"),
             "torch.gather": lambda: torch.gather(td, 1, il),
             "copy_ floor": lambda: floor_out.copy_(id_)}, dev, reps=32)
        print_turns(f"  dg axis1 ({H},{L})", ms, dev)
        records += [Record(
            name, f"({H},{L})", ms[d], outs[d].cpu(),
            lambda t=t, i=i: dyngather(t, i, 1, "cpu"), nbytes=12 * H * L,
            chain=1, library_ms=ms["torch.gather"])
            for d, name in (("faithful", "p5_dyngather_axis1"),
                            ("row", "p5_dyngather_axis1_row"))]
    return records + edge_rows(dev)


def row_edges():
    """The row gather's edge inputs, ``(label, unaligned, (t, i))`` on the
    CPU: 25 quads a row, a block no whole warp (21, 100), L % 4 != 0
    (5, 130), rows narrower than a quad (7, 3), one row (1, 128), t and i
    one element off 16-byte alignment (``unaligned``: made so on the
    device), and the widest row a block stages (3, ROW_MAX); each with
    indices -3, -1, L and L + 5 (clamped), 0 and L - 1 in its first
    elements, the rest in [-3, L + 6), and t over all of int32."""
    rng = np.random.RandomState(10)
    cases = []
    for H, L, unaligned in ((21, 100, False), (5, 130, False),
                            (7, 3, False), (1, 128, False), (8, 128, True),
                            (3, ROW_MAX, False)):
        t = int32_draw(rng, INT32_MIN, INT32_MAX + 1, (H, L))
        i = int32_draw(rng, -3, L + 6, (H, L))
        i.flat[:6] = [-3, -1, L, L + 5, 0, L - 1]
        label = f"({H},{L})" + (" unaligned" if unaligned else "")
        cases.append((label, unaligned, (tensor(t), tensor(i))))
    return cases


def edge_records(dev, kernel, cases, fn, nbytes, chain) -> list[Record]:
    """``fn(*inputs, device)`` on each ``(label, unaligned, inputs)`` of
    ``cases`` (CPU tensors; ``unaligned``: made so on the device), timed
    with 4 calls a graph, as edge runs of ``kernel`` held to ``fn`` on the
    CPU inputs (the plain version); ``nbytes(*inputs)`` is a run's
    bytes."""
    records = []
    for label, unaligned, ins in cases:
        insd = on_card(dev, ins, unaligned)
        out, ms = time_ms(lambda: fn(*insd, dev), dev, reps=4)
        print(f"  {kernel}, {label}: {ms * 1e3:.3f} us", flush=True)
        records.append(Record(kernel, label, ms, out.cpu(),
                              lambda ins=ins: fn(*ins, "cpu"),
                              nbytes=nbytes(*ins), chain=chain, edge=True))
    return records


def edge_rows(dev) -> list[Record]:
    """The row gather on each of ``row_edges()``."""
    return edge_records(dev, "p5_dyngather_axis1_row", row_edges(),
                        lambda t, i, d: dyngather(t, i, 1, d, "row"),
                        lambda t, i: 12 * t.numel(), 1)


def bench_masksum(dev) -> list[Record]:
    """Each shape of MASKSUM_SHAPES: the faithful and the vec mask-sum in
    turns beside ``torch.gather`` and ``out.copy_(idx)`` (as
    ``bench_axis1``); then the vec mask-sum on ``masksum_edges()``."""
    print(f"== mask-sum probe ({N}-entry per-lane tables), in turns ==",
          flush=True)
    rng = np.random.RandomState(2)
    records = []
    for SL, LN in MASKSUM_SHAPES:
        L = SL * LN
        tab = tensor(rng.randint(0, N, (N, L), dtype=np.int32))
        idx = tensor(rng.randint(0, N, (SL, LN), dtype=np.int32))
        tabd, idxd = tab.to(dev), idx.to(dev)
        il = idxd.long().view(1, L)
        floor_out = torch.empty_like(idxd)
        outs, ms = in_turns(
            {"faithful": lambda: masksum(tabd, idxd, dev),
             "vec": lambda: masksum(tabd, idxd, dev, "vec"),
             "torch.gather": lambda: torch.gather(tabd, 0, il),
             "copy_ floor": lambda: floor_out.copy_(idxd)}, dev, reps=32)
        print_turns(f"  mask-sum {N} x {L} lanes", ms, dev)
        records += [Record(
            name, f"{N} x {L}", ms[d], outs[d].cpu(),
            lambda tab=tab, idx=idx: masksum(tab, idx, "cpu"),
            nbytes=12 * L, chain=1, library_ms=ms["torch.gather"])
            for d, name in (("faithful", "p5_masksum"),
                            ("vec", "p5_masksum_vec"))]
    return records + edge_masksums(dev)


def masksum_edges():
    """The vec mask-sum's edge inputs, ``(label, unaligned, (tab, idx))``
    on the CPU: a part-full block (100 lanes), L % 4 != 0 (8194), idx and
    tab one element off 16-byte alignment (``unaligned``: made so on the
    device), and the tool's 1024 lanes; each with idx -1, N, INT32_MIN,
    INT32_MAX, 0 and N - 1 in its first lanes, the rest in [-3, N + 3),
    and tab over all of int32."""
    rng = np.random.RandomState(11)
    specials = [-1, N, INT32_MIN, INT32_MAX, 0, N - 1]
    cases = []
    for label, L, unaligned in (("100 lanes", 100, False),
                                ("8194 lanes", 8194, False),
                                ("8192 lanes, unaligned", 8192, True),
                                ("1024 lanes", 1024, False)):
        tab = int32_draw(rng, INT32_MIN, INT32_MAX + 1, (N, L))
        idx = int32_draw(rng, -3, N + 3, L)
        idx[:len(specials)] = specials
        cases.append((label, unaligned, (tensor(tab), tensor(idx))))
    return cases


def masksum_bytes(tab, idx) -> int:
    """idx read, the rows it names read, out written: 4 bytes each."""
    i = idx.flatten().long()
    return 4 * (2 * i.numel() + int(((i >= 0) & (i < tab.shape[0])).sum()))


def edge_masksums(dev) -> list[Record]:
    """The vec mask-sum on each of ``masksum_edges()``."""
    return edge_records(dev, "p5_masksum_vec", masksum_edges(),
                        lambda tab, idx, d: masksum(tab, idx, d, "vec"),
                        masksum_bytes, 1)


def symbol_inputs(L, seed):
    """Seeded (meta, limit, stream) as the tool drew them."""
    rng = np.random.RandomState(seed)
    meta = rng.randint(0, 8, (N, L), dtype=np.int32)
    limit = rng.randint(1, 1 << 15, (16, L), dtype=np.int32)
    stream = rng.randint(0, 1 << 30, (32, L)).astype(np.uint32)
    return tensor(meta), tensor(limit), tensor(stream)


def bench_symbol_step(dev) -> list[Record]:
    """The tool's symbol step through the faithful kernel and the staged
    one, then the staged one on EDGE_LANES lanes; each with the bound of
    its run."""
    print("== mock symbol step ==", flush=True)
    T = SYMBOL_T
    records = []
    for L, design in ((SYMBOL_LANES, "faithful"), (SYMBOL_LANES, "smem"),
                      (EDGE_LANES, "smem")):
        ins = symbol_inputs(L, 3)
        insd = [t.to(dev) for t in ins]
        work = Work(L)
        symbol_step_plain(*ins, T, work)
        out, ms = time_ms(lambda: symbol_step(*insd, T, dev, design), dev)
        sym = T * L
        name = "p5_symbol_step" + ("" if design == "faithful" else "_smem")
        label = f"{L} lanes x {T}"
        print(f"  {name} {label}: {sym} symbols in {ms:.4f} ms = "
              f"{sym / ms / 1e3:.1f} M sym/s (~{sym * 4 / ms / 1e3:.0f} "
              f"MB/s at 4 B/sym), {ms * 1e6 / T:.0f} ns/step", flush=True)
        records.append(Record(name, label, ms, out.cpu(),
                              lambda ins=ins: symbol_step(*ins, T, "cpu"),
                              nbytes=work.nbytes() + 4 * L,
                              chain=work.chain()))
    return records


def main(argv=(), device="cuda") -> list[Record]:
    """The tool's runs."""
    dev, _ = on(device)
    print(header(dev), flush=True)
    bench_library(dev)
    records = bench_gather(dev)
    records += bench_axis1(dev)
    records += bench_masksum(dev)
    records += bench_symbol_step(dev)
    return records


if __name__ == "__main__":
    main(sys.argv[1:])
