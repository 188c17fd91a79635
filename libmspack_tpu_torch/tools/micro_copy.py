"""P3: a one-frame token copy machine for LZ match resolve.

The port of ``tools/micro_copy.py``, the prototype of the TPU's phase-B
resolver: tokens (kind, len, dist) in order, literal runs from a staged
literal array, matches copied from the frame in chunks of at most 128
elements by overlap-safe doubling (``csrc/probes_micro_copy.cu``). Two
kernels compute it: ``p3_copy``, the TPU kernel's token walk on one warp
per frame, as in K2, and ``p3_copy_par`` (``parallel=True``), a
block-parallel resolve with no serial walk: each position's immediate
source from scans over the tokens, then pointer jumping
(``csrc/probes_copy_core.cuh``). Measures tokens/s and bytes/s of each and
checks the frame against a byte-serial LZ77 replay, as the tool did.

Run on the card: ``python -m libmspack_tpu_torch.tools.micro_copy``. It
times both kernels on the tool's frame and on the edge cases of
``inputs()`` (no tokens: the launch with the frame's init and writes), and
returns a ``Record`` for each, which ``chip_smoke.py`` holds against the
plain version.
"""
from __future__ import annotations

import sys

import numpy as np
import torch

from . import Record, Work, int32, launch, log2c, on, tensor
from .timing import header, time_ms

FRAME = 32768
V = 128
ROWS = FRAME // V

SOURCE = "probes_micro_copy.cu"
REPLACES = {"p3_copy": "tools/micro_copy.py:85",
            "p3_copy_par": "tools/micro_copy.py:85"}
LAUNCHES = dict.fromkeys(REPLACES, 0)


def _check(seed, tok, nlit, nout):
    """Raise unless every read and write of the token walk stays inside
    ``lit`` (``nlit`` elements) and the frame (``nout``)."""
    kind, ln, dist = tok.long().unbind(1)
    start = seed.long() + torch.cumsum(ln, 0) - ln
    end = start + ln
    bad = torch.stack([
        (seed < 0).any(), (ln < 0).any(),
        ((kind != 0) & ((dist < 1) | (dist > start))).any(),
        (end > nout).any(), (seed.long() > nout).any(),
        torch.where(kind == 0, ln, 0).sum() > nlit])
    if bool(bad.any()):
        raise ValueError("tokens read or write outside lit or the frame: "
                         "need len >= 0, 1 <= dist <= position, and the "
                         "runs inside lit and the frame")


def resolve(seed, tok, lit, device="cuda", parallel=False):
    """The tool's kernel. seed: int32 ``(1,)``, the first position; tok:
    int32 ``(NT, 3)`` rows (kind, len, dist), kind 0 a literal run; lit:
    int32 ``(ROWS + 2, V)``, one element per byte. Returns ``(out int32
    (ROWS + 2, V), sc int32 (1,))``: the frame (0 where nothing was
    written) and the final position. ``parallel`` launches the
    block-parallel resolve instead of the token walk (the same
    function)."""
    seed = int32(seed, "seed", (1,))
    tok = int32(tok, "tok")
    lit = int32(lit, "lit")
    if tok.dim() != 2 or tok.shape[1] != 3:
        raise ValueError("tok must be (NT, 3)")
    dev, (seed, tok, lit) = on(device, seed, tok, lit)
    _check(seed, tok, lit.numel(), (ROWS + 2) * V)
    if dev.type == "cpu":
        return resolve_plain(seed, tok, lit)
    return _launch(dev, seed, tok, lit, parallel)


def _launch(dev, seed, tok, lit, parallel=False):
    """A kernel on checked tokens (the check syncs the device, so the
    timed loop of ``main`` calls this directly)."""
    sc = torch.empty(1, dtype=torch.int32, device=dev)
    ptrs = (seed.data_ptr(), tok.data_ptr(), tok.shape[0], lit.data_ptr())
    if parallel:   # it writes every element of the frame
        out = torch.empty((ROWS + 2, V), dtype=torch.int32, device=dev)
        launch(LAUNCHES, "p3_copy_par", "msp_p3_copy_par", dev, *ptrs,
               out.data_ptr(), sc.data_ptr(), out.numel())
    else:
        out = torch.zeros((ROWS + 2, V), dtype=torch.int32, device=dev)
        launch(LAUNCHES, "p3_copy", "msp_p3_copy", dev, *ptrs,
               out.data_ptr(), sc.data_ptr())
    return out, sc


def resolve_plain(seed, tok, lit, work=None):
    """Plain version of ``resolve``: the tokens in order, each match in
    the TPU kernel's chunks. ``work`` (a ``Work`` of one lane) gets the
    function's chain on this input: a scan of the tokens for their
    starts, a search over the positions for each one's token, its
    immediate source, the rounds of pointer jumping that the longest
    chain of copies needs (d copies: bit_length(d) rounds), and the
    write."""
    out = torch.zeros((ROWS + 2) * V, dtype=torch.int32)
    depth = torch.zeros((ROWS + 2) * V, dtype=torch.int64)
    litf = lit.flatten()
    dst, lsrc = int(seed[0]), 0
    for kind, ln, dist in tok.tolist():
        if kind == 0:
            out[dst:dst + ln] = litf[lsrc:lsrc + ln]
            lsrc += ln
        else:
            cur, rem, avail = dst, ln, dist
            while rem > 0:
                c = min(rem, V, avail)
                out[cur:cur + c] = out[cur - avail:cur - avail + c].clone()
                depth[cur:cur + c] = depth[cur - avail:cur - avail + c] + 1
                cur, rem, avail = cur + c, rem - c, avail + c
        dst += ln
    if work is not None:
        span = dst - int(seed[0])
        work.add(log2c(max(len(tok), 1)) + log2c(max(span, 1)) + 1
                 + int(depth.max()).bit_length() + 1)
    return out.view(ROWS + 2, V), torch.tensor([dst], dtype=torch.int32)


def make_tokens(seed=0):
    """The tool's frame (micro_copy.py:103-121): ``(tok (NT, 3), lit
    (ROWS + 2, V), bytes out)`` as numpy arrays."""
    rng = np.random.RandomState(seed)
    toks, dst = [], 0
    while True:
        if dst < 64 or rng.rand() < 0.55:
            ln = int(rng.randint(4, 60))
            toks.append((0, ln, 0))
        else:
            ln = int(rng.randint(3, min(60, V)))
            toks.append((1, ln, int(rng.randint(1, min(dst, 2000)))))
        dst += ln
        if dst > FRAME - 200:
            break
    lit = rng.randint(0, 255, (ROWS + 2, V)).astype(np.int32)
    return np.asarray(toks, np.int32), lit, dst


def inputs() -> dict:
    """The runs of ``main``, ``{name: (seed, tok (NT, 3), lit)}`` as ints
    and numpy arrays: the tool's frame, then the cases that pin the
    function down (the TPU kernel's chunk schedule past 128 elements and
    at dist 127-129, reads below ``seed``, empty and one-element tokens
    at a 1024-token tile's boundary, a chain of thousands of copies)."""
    tok, lit, _ = make_tokens()
    tok1, lit1, _ = make_tokens(seed=1)
    cases = {"tool_frame": (0, tok, lit), "tool_prefix": (0, tok1[:48], lit1)}
    # matches past 128 elements: the TPU kernel's chunks leave LZ77's copy
    cases["long_matches"] = (0, np.array(
        [(0, 300, 0), (1, 300, 200), (1, 260, 50), (0, 7, 0), (1, 129, 1)],
        np.int32), lit1)
    # matches that read below seed (those positions hold 0)
    cases["seed_below"] = (500, np.array(
        [(0, 100, 0), (1, 80, 550), (1, 200, 599), (0, 3, 0), (1, 40, 2)],
        np.int32), lit)
    cases["dist1_run"] = (0, np.array([(0, 5, 0), (1, 4000, 1)], np.int32),
                          lit)
    for d in (127, 128, 129):
        cases[f"dist{d}_len300"] = (0, np.array(
            [(0, 200, 0), (1, 300, d), (0, 9, 0)], np.int32), lit)
    # empty tokens of both kinds, beside the tile boundary
    zl = tok.copy()
    zl[1020:1030, 1] = 0
    zl[1020:1030:2, 0] = 0
    cases["zero_lengths"] = (0, zl, lit)
    # one-element tokens: each is a position's only owner
    cases["len_one"] = (3, np.array(
        [(0, 4, 0), (0, 1, 0), (1, 1, 2), (1, 1, 5), (0, 1, 0), (1, 3, 1),
         (1, 1, 7)], np.int32), lit)
    cases["empty"] = (7, np.zeros((0, 3), np.int32), lit)
    return cases


def lz77_replay(tok, lit):
    """A byte-serial LZ77 replay of the tokens from position 0."""
    win = np.zeros((ROWS + 2) * V, np.int32)
    litf = lit.reshape(-1)
    dst = lsrc = 0
    for k, ln, d in tok.tolist():
        if k == 0:
            win[dst:dst + ln] = litf[lsrc:lsrc + ln]
            lsrc += ln
        else:
            for i in range(ln):
                win[dst + i] = win[dst + i - d]
        dst += ln
    return win[:dst]


def main(argv=(), device="cuda") -> list[Record]:
    dev, _ = on(device)
    print(header(dev), flush=True)
    records = []
    for case, (pos, tok_np, lit_np) in inputs().items():
        seed = torch.tensor([pos], dtype=torch.int32)
        tok, lit = tensor(tok_np), tensor(lit_np)
        args = [t.to(dev) for t in (seed, tok, lit)]
        _check(*args[:2], lit.numel(), (ROWS + 2) * V)
        nt = len(tok_np)
        nlit = int(tok_np[tok_np[:, 0] == 0, 1].sum())
        nbytes_out = int(tok_np[:, 1].sum())
        work = Work(1)
        resolve_plain(seed, tok, lit, work)

        def plain(seed=seed, tok=tok, lit=lit):
            o, s = resolve(seed, tok, lit, "cpu")
            return torch.cat([o.flatten(), s])

        for kernel, parallel in (("p3_copy", False), ("p3_copy_par", True)):
            run = (lambda: resolve(*args, device=dev)) \
                if dev.type == "cpu" \
                else (lambda p=parallel: _launch(dev, *args, p))
            (out, sc), ms = time_ms(run, dev, reps=16)
            name = "resolve (block-parallel)" if parallel else "resolve"
            if case == "tool_frame":
                got = out.cpu().flatten()[:nbytes_out].numpy()
                print("correct:",
                      np.array_equal(got, lz77_replay(tok_np, lit_np)),
                      "sc:", int(sc[0]), nbytes_out, flush=True)
                print(f"{name}: {nt} tokens ({nbytes_out} B) per call: "
                      f"{ms:.3f} ms -> {nt / ms / 1e3:.2f} M tok/s, "
                      f"{nbytes_out / ms / 1e3:.1f} MB/s", flush=True)
            else:
                print(f"{name}, {case} ({nt} tokens, {nbytes_out} B): "
                      f"{ms:.4f} ms", flush=True)
            # tok and the literals read, the frame and sc written
            records.append(Record(
                kernel, f"{case}: {nt} tokens", ms,
                torch.cat([out.cpu().flatten(), sc.cpu()]), plain,
                nbytes=12 * nt + 4 * nlit + 4 * (ROWS + 2) * V + 8,
                chain=work.chain()))
    return records


if __name__ == "__main__":
    main(sys.argv[1:])
