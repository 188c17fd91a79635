"""LZ match resolution by pointer doubling (device phase B).

PyTorch counterpart of ``libmspack_tpu/ops/match_resolve.py``, an XLA op
of the JAX package. After entropy decode every output byte is a literal or
a copy of an earlier output byte. Scalar decoders resolve copies byte by
byte (reference: lzxd.c:618-649, mszipd.c:270-296, lzssd.c:80-86); here all
bytes resolve at once:

    ptr[i] = i            if byte i is a literal
    ptr[i] = i - dist(i)  if byte i is inside a match
    ptr[i] < 0            reads pre-history (window fill / reference data)

Iterating ``ptr <- ptr[ptr]`` converges every chain to its root literal in
ceil(log2(longest chain)) rounds, each one gather. Overlapping matches
(dist < len) work because resolution is per byte. Output = ``lit[root]``,
with negative roots mapped into ``history`` or to ``fill``. The JAX
module's ``tokens_to_ptr`` serves only ``ops/lzx_jax.py``, which is not
ported (ROADMAP Queue 1 item 5).
"""
from __future__ import annotations

import torch

__all__ = ["resolve"]


def resolve(ptr, lit, history=None, fill: int = 0x20,
            rounds: int | None = None):
    """Resolve copy chains and materialise the output bytes.

    ptr: ``(N,)`` int64 as above; lit: ``(N,)`` uint8, the literal byte at
    literal positions (anything elsewhere); history: optional ``(H,)``
    uint8, index -k reads ``history[H - k]``; without it negative roots give
    ``fill`` (LZSS's window pre-fill 0x20)."""
    n = ptr.shape[0]
    if n == 0:
        return lit[:0]
    if rounds is None:
        rounds = max(1, n - 1).bit_length()
    p = ptr.to(torch.int64)
    for _ in range(rounds):
        p = torch.where(p >= 0, p[p.clamp(0, n - 1)], p)
    out = lit[p.clamp(0, n - 1)]
    if history is not None:
        h = history.shape[0]
        hist_val = history[(p + h).clamp(0, max(h - 1, 0))]
        return torch.where(p < 0, hist_val, out)
    return torch.where(p < 0, torch.full_like(out, fill), out)

