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
with negative roots mapped into ``history`` or to ``fill``.
``tokens_to_ptr`` expands a token stream into those pointers
(``ops/lzx.py``).
"""
from __future__ import annotations

import torch

__all__ = ["resolve", "tokens_to_ptr", "point_roots", "scatter_max_marks"]


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



def point_roots(ptr, N: int):
    """Pointer-double ``ptr`` (int64, length N) to its fixed points:
    ``ptr <- ptr[ptr]`` where ``ptr >= 0``, ceil(log2 N) rounds."""
    for _ in range(max(1, N - 1).bit_length()):
        ptr = torch.where(ptr >= 0, ptr[ptr.clamp(0, N - 1)], ptr)
    return ptr


def scatter_max_marks(n: int, idx, values):
    """``zeros(n).at[idx].max(values)``: the largest value landing on each
    of ``n`` slots (0 where none does)."""
    marks = torch.zeros(n, dtype=torch.int64, device=idx.device)
    return marks.scatter_reduce(0, idx, values, reduce="amax",
                                include_self=True)


def tokens_to_ptr(out_len: int, tok_out_start, tok_kind, tok_lit, tok_dist):
    """Expand a token stream into per-byte ``(ptr, lit)``.

    tok_out_start: ``(T,)`` output offset of each token (prefix sum of
    lengths); tok_kind: ``(T,)``, 0 literal, 1 match; tok_lit: literal
    bytes; tok_dist: match distances. Each output byte finds its covering
    token with a scatter-max: mark token starts, then a running maximum
    gives the token id of every byte."""
    dev = tok_out_start.device
    t = tok_out_start.shape[0]
    marks = scatter_max_marks(out_len + 1, tok_out_start.clamp(0, out_len),
                              torch.arange(t, device=dev) + 1)
    tok_id = (torch.cummax(marks[:out_len], 0).values - 1).clamp(0, t - 1)
    pos = torch.arange(out_len, device=dev)
    ptr = torch.where(tok_kind[tok_id] == 0, pos,
                      pos - tok_dist[tok_id].to(torch.int64))
    return ptr, tok_lit[tok_id]
