"""P3: a one-frame token copy machine for LZ match resolve.

The port of ``tools/micro_copy.py``, the prototype of the TPU's phase-B
resolver: tokens (kind, len, dist) in order, literal runs from a staged
literal array, matches copied from the frame in chunks of at most 128
elements by overlap-safe doubling (``csrc/probes_micro_copy.cu``). One
warp per frame, as in K2. Measures tokens/s and bytes/s and checks the
frame against a byte-serial LZ77 replay, as the tool did.

Run on the card: ``python -m libmspack_tpu_torch.tools.micro_copy``
"""
from __future__ import annotations

import sys

import numpy as np
import torch

from . import Record, int32, launch, on, tensor
from .timing import header, time_ms

FRAME = 32768
V = 128
ROWS = FRAME // V

SOURCE = "probes_micro_copy.cu"
REPLACES = {"p3_copy": "tools/micro_copy.py:85"}
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


def resolve(seed, tok, lit, device="cuda"):
    """The tool's kernel. seed: int32 ``(1,)``, the first position; tok:
    int32 ``(NT, 3)`` rows (kind, len, dist), kind 0 a literal run; lit:
    int32 ``(ROWS + 2, V)``, one element per byte. Returns ``(out int32
    (ROWS + 2, V), sc int32 (1,))``: the frame (0 where nothing was
    written) and the final position."""
    seed = int32(seed, "seed", (1,))
    tok = int32(tok, "tok")
    lit = int32(lit, "lit")
    if tok.dim() != 2 or tok.shape[1] != 3:
        raise ValueError("tok must be (NT, 3)")
    dev, (seed, tok, lit) = on(device, seed, tok, lit)
    _check(seed, tok, lit.numel(), (ROWS + 2) * V)
    if dev.type == "cpu":
        return resolve_plain(seed, tok, lit)
    return _launch(dev, seed, tok, lit)


def _launch(dev, seed, tok, lit):
    """The kernel on checked tokens (the check syncs the device, so the
    timed loop of ``main`` calls this directly)."""
    out = torch.zeros((ROWS + 2, V), dtype=torch.int32, device=dev)
    sc = torch.empty(1, dtype=torch.int32, device=dev)
    launch(LAUNCHES, "p3_copy", "msp_p3_copy", dev, seed.data_ptr(),
           tok.data_ptr(), tok.shape[0], lit.data_ptr(), out.data_ptr(),
           sc.data_ptr())
    return out, sc


def resolve_plain(seed, tok, lit):
    """Plain version of ``resolve``: the tokens in order, each match in
    the TPU kernel's chunks."""
    out = torch.zeros((ROWS + 2) * V, dtype=torch.int32)
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
                cur, rem, avail = cur + c, rem - c, avail + c
        dst += ln
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
    tok_np, lit_np, nbytes_out = make_tokens()
    tok, lit = tensor(tok_np), tensor(lit_np)
    seed = torch.zeros(1, dtype=torch.int32)
    args = [t.to(dev) for t in (seed, tok, lit)]
    _check(*args[:2], lit.numel(), (ROWS + 2) * V)
    run = (lambda: resolve(*args, device=dev)) if dev.type == "cpu" else \
        (lambda: _launch(dev, *args))
    (out, sc), ms = time_ms(run, dev, reps=16)
    got = out.cpu().flatten()[:nbytes_out].numpy()
    print("correct:", np.array_equal(got, lz77_replay(tok_np, lit_np)),
          "sc:", int(sc[0]), nbytes_out, flush=True)
    nt = len(tok_np)
    print(f"resolve: {nt} tokens ({nbytes_out} B) per call: {ms:.3f} ms -> "
          f"{nt / ms / 1e3:.2f} M tok/s, {nbytes_out / ms / 1e3:.1f} MB/s",
          flush=True)

    def plain():
        o, s = resolve(seed, tok, lit, "cpu")
        return torch.cat([o.flatten(), s])

    nlit = int(tok_np[tok_np[:, 0] == 0, 1].sum())
    return [Record("p3_copy", f"{nt} tokens", ms,
                   torch.cat([out.cpu().flatten(), sc.cpu()]), plain,
                   nbytes=12 * nt + 4 * nlit + 4 * nbytes_out + 8, chain=nt)]


if __name__ == "__main__":
    main(sys.argv[1:])
