"""Multi-device decode over ``torch.distributed``: the port's mesh.

PyTorch counterpart of ``libmspack_tpu/parallel/mesh.py``. The reference
is strictly single-threaded (reference: mspack.h:122-156); scaling is the
framework's own design (SURVEY.md §2.4, §7 step 8).

The JAX module is single-controller SPMD over a ``jax.sharding.Mesh``.
Here a ``Mesh`` is a process group, one rank per process: every function
below is called collectively, by every rank of the group with the same
whole input, and returns the whole result on every rank. Each rank decodes
its shard on its own device (``Mesh.device``) and the results travel by
collectives: NCCL between GPUs, gloo on the CPU (gloo's collectives take
CPU tensors, so a gloo group on GPUs stages them through the host). Every
decision to decline is taken on gathered values or on the whole input, so
all ranks decline together.

Shard grid (what the formats make legal):
* MSZIP frames: phase A per rank (``decode_frames_sharded``: the tensor
  ops of ``ops/inflate.py``, then an all-gather of the tokens and the
  folder-wide phase B; ``decode_frames_ring``: K1, then a ring that hands
  each rank's 32 KiB output tail to the next, the only cross-frame state);
* LZX streams (CAB folders, CHM reset chunks): K3 lanes per rank and a
  local pointer-doubling resolve; a stream beyond ``LZX_MESH_CAP`` decodes
  in ``LZX_MESH_SEG`` segments through K3's state records
  (``ops/cuda_lzx.py``), window tails chaining phase B;
* Quantum streams: K4 lanes per rank, the same resolve.

On a CUDA device the rank launches K1, K3 and K4; on the CPU their plain
versions. Declines (``NeedFallback``) make the function return None, as in
the JAX module; each is counted in ``Mesh.declines`` by reason, and under
strict mode (``Mesh.strict``) raises ``FallbackError`` instead. The JAX
module's "interpret-mode budget" decline of Quantum streams above 4 KiB
holds on a CPU device only: on a card K4 takes any stream up to
``QTM_MESH_CAP``.
"""
from __future__ import annotations

import collections

import numpy as np
import torch
import torch.distributed as dist

from .._device import resolve_device, strict_mode
from ..errors import FallbackError
from ..ops import cuda_inflate as ci
from ..ops import cuda_lzx as cl
from ..ops import cuda_qtm as cq
from ..ops import inflate as ti
from ..ops.lzx import e8_untransform
from ..ops.match_resolve import point_roots, scatter_max_marks

__all__ = ["Mesh", "default_mesh", "all_gather", "sharded_phase_a",
           "decode_frames_sharded", "decode_frames_ring",
           "decode_lzx_streams_sharded", "decode_qtm_streams_sharded",
           "decode_cab_sharded", "decode_chm_sharded", "H_WIN",
           "LZX_MESH_CAP", "LZX_MESH_SEG", "MESH_RESOLVE_BUDGET",
           "QTM_MESH_CAP", "MAX_LANES"]

H_WIN = 32768                   # MSZIP window: the only cross-frame state
LZX_MESH_CAP = 128 * 1024       # per-launch LZX output budget on the mesh
LZX_MESH_SEG = 64 * 1024        # segment size for larger streams
MESH_RESOLVE_BUDGET = 64 << 20  # per-device resolve elements
QTM_MESH_CAP = 128 * 1024
MAX_LANES = 1024                # streams per rank (the TPU lane grid)
QTM_CPU_CAP = 4096              # the JAX module's interpreter budget

NeedFallback = ti.NeedFallback


class Mesh:
    """A process group as a decode mesh: its size, this process's rank and
    device, its backend, strict mode and the declines counted so far."""

    def __init__(self, group=None, device="cuda", strict=None):
        self.group = group if group is not None else dist.group.WORLD
        self.size = dist.get_world_size(self.group)
        self.rank = dist.get_rank(self.group)
        self.backend = dist.get_backend(self.group)
        self.device = resolve_device(device)
        if self.device.type == "cuda" and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        self.strict = strict_mode(strict)
        self.declines: collections.Counter = collections.Counter()

    def decline(self, path: str, e: NeedFallback):
        """Count a decline of ``path``; returns None, or raises
        ``FallbackError`` under strict mode."""
        self.declines[e.reason] += 1
        if self.strict:
            raise FallbackError(path, e.reason)
        return None


def default_mesh(n_devices: int | None = None, device="cuda",
                 strict=None) -> Mesh:
    """The first ``n_devices`` ranks of the default group (all of them by
    default) as a mesh. Every rank of the default group must call it; a
    rank outside the first ``n_devices`` gets None."""
    world = dist.get_world_size()
    if n_devices is None or n_devices == world:
        return Mesh(None, device, strict)
    group = dist.new_group(list(range(n_devices)))
    return Mesh(group, device, strict) if dist.get_rank() < n_devices \
        else None


# ---------------------------------------------------------------------------
# collectives
# ---------------------------------------------------------------------------

def _comm(mesh: Mesh, t):
    """``t`` where the backend takes it: the host for gloo."""
    t = t.contiguous()
    return t.cpu() if mesh.backend == "gloo" else t


def all_gather(mesh: Mesh, t):
    """Every rank's ``t`` (one shape and dtype on all ranks), stacked along
    a new first axis, on ``mesh.device``."""
    if mesh.size == 1:
        return t[None]
    c = _comm(mesh, t)
    out = [torch.empty_like(c) for _ in range(mesh.size)]
    dist.all_gather(out, c, group=mesh.group)
    return torch.stack(out).to(mesh.device)


def _ring_shift(mesh: Mesh, t):
    """Send ``t`` to the next rank and return the previous rank's (the
    JAX module's ``ppermute`` over ``(i, i + 1 mod n)``)."""
    if mesh.size == 1:
        return t
    c = _comm(mesh, t)
    got = torch.empty_like(c)

    def peer(r):
        r %= mesh.size
        return r if mesh.group is dist.group.WORLD \
            else dist.get_global_rank(mesh.group, r)

    ops = [dist.P2POp(dist.isend, c, peer(mesh.rank + 1), mesh.group),
           dist.P2POp(dist.irecv, got, peer(mesh.rank - 1), mesh.group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return got.to(mesh.device)


def _shard(seq, mesh: Mesh, per: int):
    """This rank's ``per`` items of ``seq``."""
    return seq[mesh.rank * per:(mesh.rank + 1) * per]


# ---------------------------------------------------------------------------
# MSZIP: phase A per rank, gathered phase B
# ---------------------------------------------------------------------------

def sharded_phase_a(mesh: Mesh, data, starts, lit_luts, dist_luts,
                    P_bits: int, R: int, S: int):
    """``ops/inflate._phase_a`` on this rank's frames of a ``(B, S)``
    batch (``data`` flat ``(B*S,)``, ``starts`` ``(B,)``, LUTs
    ``(B, 32768)``; B divisible by the mesh size), the outputs gathered
    onto every rank: the seven arrays of ``_phase_a`` for all B frames."""
    Bl = starts.shape[0] // mesh.size
    dev = mesh.device
    out = ti._phase_a(_shard(data, mesh, Bl * S).to(dev),
                      _shard(starts, mesh, Bl).to(dev),
                      _shard(lit_luts, mesh, Bl).to(dev),
                      _shard(dist_luts, mesh, Bl).to(dev), P_bits, R, S)
    gathered = []
    for t in out:
        g = all_gather(mesh, t if t.dtype != torch.bool
                       else t.to(torch.int32))
        g = g.reshape(-1, *t.shape[1:])
        gathered.append(g.to(torch.bool) if t.dtype == torch.bool else g)
    return tuple(gathered)


def decode_frames_sharded(mesh: Mesh, frames: list[bytes],
                          expected_sizes: list[int] | None = None
                          ) -> bytes | None:
    """A whole MSZIP folder: phase A over the ranks' frames, tokens
    gathered, folder-wide phase B on every rank. Bit-exact against the
    scalar codec; None where the tensor ops decline."""
    if not frames:
        return b""
    try:
        ndev = mesh.size
        nominal = len(frames)
        # a power of two, divisible by the mesh size
        B = max(ndev, 1 << max(0, nominal - 1).bit_length())
        B = ((B + ndev - 1) // ndev) * ndev
        frames = list(frames) + [ti._EMPTY_STREAM] * (B - nominal)
        S = ti._bucket(max(len(f) for f in frames) + 8, ti.S_BUCKETS)

        data = np.zeros((B, S), np.uint8)
        luts_l = np.zeros((B, 1 << 15), np.int32)
        luts_d = np.zeros((B, 1 << 15), np.int32)
        starts = np.zeros(B, np.int64)
        # single-deflate-block frames only on this path (the common case);
        # multi-block or stored frames fall back
        for i, f in enumerate(frames):
            data[i, : len(f)] = np.frombuffer(f, np.uint8)
            last, kind, *rest = ti._parse_block_header(f, 0)
            if kind != "huff" or not last:
                raise NeedFallback("multi-block/stored frame")
            luts_l[i], luts_d[i], starts[i] = rest

        (t_kind, t_outlen, t_dist, t_lit, _end, chain_inv,
         reached) = sharded_phase_a(
            mesh, torch.from_numpy(data.reshape(-1)),
            torch.from_numpy(starts), torch.from_numpy(luts_l),
            torch.from_numpy(luts_d), S * 8, ti.MAX_TOKENS, S)
        if bool(chain_inv.any()) or not bool(reached.all()):
            raise NeedFallback("invalid chain")

        live = (t_kind == 0) | (t_kind == 1)
        frame_lens = torch.where(live, t_outlen, 0).sum(dim=1).cpu().numpy()
        if expected_sizes is not None:
            exp = np.asarray(list(expected_sizes) + [0] * (B - nominal),
                             np.int64)
            if not np.array_equal(frame_lens, exp):
                raise NeedFallback("frame length mismatch")
        total = int(frame_lens.sum())
        if total == 0:
            return b""
        base = np.zeros(B, np.int64)
        base[1:] = np.cumsum(frame_lens)[:-1]
        n_out = max(256, 1 << (total - 1).bit_length())
        out, bad = ti._phase_b(t_kind, t_outlen, t_dist, t_lit,
                               torch.from_numpy(base), n_out)
        if bad:
            raise NeedFallback("bad source")
        return out[:total].cpu().numpy().tobytes()
    except NeedFallback as e:
        return mesh.decline("decode_frames_sharded", e)


# ---------------------------------------------------------------------------
# ring phase B: per-rank resolve with a send/recv window handoff
# ---------------------------------------------------------------------------

def _live_tokens(tok, cnt, valid):
    """K1/K3/K4 token rows ``(L, T)`` with the columns past each lane's
    count (undefined on the card) and the invalid lanes set to NOP."""
    col = torch.arange(tok.shape[1], device=tok.device)
    keep = (col[None, :] < cnt[2][:, None]) & valid[:, None]
    return torch.where(keep, tok, -1)


def _expand_mszip_tokens(tok, litw, flen, N: int):
    """K1 traces ``(L, T)`` (lane-major) -> per-byte ``(ptr, litv)`` over a
    length-N space whose first H_WIN positions are the ring window.

    Every output byte gets a back-pointer: literals point at themselves
    (litv holds the value), match bytes point dist back. Tokens are
    ``0x20000000|n`` packed literals and ``0x40000000|nl<<25|len<<16|
    (dist-1)`` with nl carried literals."""
    dev = tok.device
    L, T = tok.shape
    H = H_WIN
    v = tok.to(torch.int64)
    w = litw.to(torch.int64)
    live = v >= 0
    is_lit = live & (((v >> 29) & 1) == 1)
    is_mt = live & (((v >> 30) & 1) == 1)
    nlit = torch.where(is_lit, v & 7, torch.where(is_mt, (v >> 25) & 3, 0))
    mlen = torch.where(is_mt, (v >> 16) & 0x1FF, 0)
    tlen = nlit + mlen
    within = torch.cumsum(tlen, dim=1) - tlen
    flen = flen.to(torch.int64)
    base = H + torch.cumsum(flen, 0) - flen          # (L,)
    out_start = (base[:, None] + within).reshape(-1)
    tlen_f = tlen.reshape(-1)

    LT = L * T
    marks = scatter_max_marks(
        N + 1, torch.where(tlen_f > 0, out_start.clamp(0, N), N),
        torch.arange(LT, device=dev) + 1)
    tok_id = (torch.cummax(marks[:N], 0).values - 1).clamp(0, LT - 1)

    pos = torch.arange(N, device=dev)
    st = out_start[tok_id]
    vv = v.reshape(-1)[tok_id]
    ww = w.reshape(-1)[tok_id]
    nl = nlit.reshape(-1)[tok_id]
    dist_ = (vv & 0x7FFF) + 1
    b_off = pos - st
    lit_byte = b_off < nl
    litval = (ww >> (8 * b_off.clamp(0, 3))) & 0xFF
    # positions past the produced bytes have no covering token: they
    # self-point (back-pointers there would flag the roots<0 check)
    tot = H + flen.sum()
    ptr = torch.where((pos < H) | (pos >= tot), pos,
                      torch.where(lit_byte, pos, pos - dist_))
    litv = torch.where((pos >= H) & lit_byte & (pos < tot), litval, 0)
    return ptr, litv


def decode_frames_ring(mesh: Mesh, frames: list[bytes],
                       expected_sizes: list[int] | None = None
                       ) -> bytes | None:
    """A whole MSZIP folder with ring phase B: K1 on each rank's frames,
    then each rank pointer-doubles its bytes' back-pointers to their roots
    once; the ring of ``size`` steps only substitutes window values
    through the roots and hands the rank's 32 KiB output tail to the next
    rank. Bit-exact against the scalar codec; None where it declines."""
    if not frames:
        return b""
    try:
        ndev = mesh.size
        nominal = len(frames)
        if expected_sizes is not None and \
                any(s > 32768 for s in expected_sizes):
            raise NeedFallback("frame larger than the MSZIP window")
        Bl = (nominal + ndev - 1) // ndev      # frames per rank
        if Bl > MAX_LANES:
            raise NeedFallback("folder larger than the lane grid")
        B = Bl * ndev
        frames = list(frames) + [b""] * (B - nominal)
        dev = mesh.device

        g0 = mesh.rank * Bl
        streams, lens = ci.pack_streams(frames[g0:g0 + Bl])
        # a folder's first frame has no history, the others 32 KiB
        hists = torch.tensor([0 if g == 0 else 32768
                              for g in range(g0, g0 + Bl)], dtype=torch.int32)
        # padding lanes hold empty streams, which the kernel flags as
        # corrupt: mask them out of the error check
        valid = torch.tensor([g < nominal for g in range(g0, g0 + Bl)],
                             device=dev)
        maxsz = max(expected_sizes) if expected_sizes else 32768
        t_pad = min(18432, ((maxsz // 2 + 1536 + 255) // 256) * 256)
        N_loc = Bl * 32768 + H_WIN

        tok, litw, cnt = ci.inflate_phase_a(
            streams.to(dev), lens.to(dev), hists.to(dev), tcap=t_pad)
        errs = torch.where(valid, cnt[0], 0)
        flen = torch.where(valid, cnt[1], 0)
        tok = _live_tokens(tok, cnt, valid)
        ptr, litv = _expand_mszip_tokens(tok, litw, flen, N_loc)
        roots = point_roots(ptr, N_loc)
        litr = litv[roots.clamp(0, N_loc - 1)]
        inv = bool((errs != 0).any()) or bool((roots < 0).any())
        tot = H_WIN + int(flen.sum())
        start = min(max(tot - H_WIN, 0), N_loc - H_WIN)

        win = torch.zeros(H_WIN, dtype=torch.int64, device=dev)
        res = None
        for kdev in range(ndev):
            histv = win[roots.clamp(0, H_WIN - 1)]
            out = torch.where(roots < H_WIN, histv, litr)
            if kdev == mesh.rank:
                res = out
            win = _ring_shift(mesh, out[start:start + H_WIN])

        res = all_gather(mesh, res[H_WIN:].to(torch.uint8)).cpu().numpy()
        restot = all_gather(mesh, torch.tensor([tot - H_WIN], device=dev))
        flen_all = all_gather(mesh, flen).reshape(-1).cpu().numpy()
        if bool(all_gather(mesh, torch.tensor([int(inv)],
                                              device=dev)).any()):
            raise NeedFallback("kernel error / invalid chain")
        if expected_sizes is not None:
            exp = np.asarray(list(expected_sizes) + [0] * (B - nominal),
                             np.int64)
            if not np.array_equal(flen_all, exp):
                raise NeedFallback("frame length mismatch")
        restot = restot.reshape(-1).cpu().numpy()
        return b"".join(res[d, :restot[d]].tobytes() for d in range(ndev))
    except NeedFallback as e:
        return mesh.decline("decode_frames_ring", e)


# ---------------------------------------------------------------------------
# LZX and Quantum lanes
# ---------------------------------------------------------------------------

def _lanes_resolve(tok, litw, flen, Fl: int, WSIZE: int, stride: int,
                   N_loc: int, pfx=None):
    """Phase B of K3/K4 lane traces on the rank's device.

    tok/litw: (Fl, T) token rows (K3's format, which K4 shares); flen:
    (Fl,) produced byte counts. Each lane owns a [WSIZE prefix | output]
    region of length ``stride``; ``pfx`` (Fl, WSIZE), when given, fills
    the prefix with the previous segment's window tail (zeros otherwise).
    Returns (bytes over N_loc as int64, whether a root lies before its
    lane)."""
    dev = tok.device
    T = tok.shape[1]
    v = tok.to(torch.int64)
    live = v >= 0
    is_lit = live & (((v >> 29) & 1) == 1)
    is_mt = live & (((v >> 30) & 1) == 1)
    nlit = torch.where(is_lit, v & 7, 0)
    mlen = torch.where(is_mt, v & 0xFFFFF, 0)
    tlen = nlit + mlen
    within = torch.cumsum(tlen, dim=1) - tlen
    base = torch.arange(Fl, device=dev) * stride + WSIZE
    out_start = (base[:, None] + within).reshape(-1)
    tlen_f = tlen.reshape(-1)
    LT = Fl * T
    marks = scatter_max_marks(
        N_loc + 1, torch.where(tlen_f > 0, out_start.clamp(0, N_loc), N_loc),
        torch.arange(LT, device=dev) + 1)
    tok_id = (torch.cummax(marks[:N_loc], 0).values - 1).clamp(0, LT - 1)
    pos = torch.arange(N_loc, device=dev)
    st = out_start[tok_id]
    ww = litw.to(torch.int64).reshape(-1)[tok_id]
    nl = nlit.reshape(-1)[tok_id]
    b_off = pos - st
    lit_byte = b_off < nl
    litval = (ww >> (8 * b_off.clamp(0, 3))) & 0xFF
    in_pfx = (pos % stride) < WSIZE
    # bytes past a lane's produced length self-point (no covering token)
    flen_b = flen.to(torch.int64)[pos // stride]
    covered = ((pos % stride) - WSIZE) < flen_b
    ptr = torch.where(in_pfx | ~covered, pos,
                      torch.where(lit_byte, pos, pos - ww))
    litv = torch.where(~in_pfx & lit_byte & covered, litval, 0)
    if pfx is not None:
        pidx = (pos // stride) * WSIZE + (pos % stride).clamp(0, WSIZE - 1)
        litv = torch.where(in_pfx, pfx.reshape(-1).to(torch.int64)[pidx],
                           litv)
    roots = point_roots(ptr, N_loc)
    out = litv[roots.clamp(0, N_loc - 1)]
    return out, bool((roots < 0).any())


def _lane_batch(mesh: Mesh, streams, sizes):
    """The rank's lanes of ``streams`` (padded to a multiple of the mesh
    size): (Fl, padded sizes, packed streams, lengths, valid mask), on the
    rank's device."""
    nominal = len(streams)
    Fl = (nominal + mesh.size - 1) // mesh.size
    if Fl > MAX_LANES:
        raise NeedFallback("too many streams")
    F = Fl * mesh.size
    streams = list(streams) + [b""] * (F - nominal)
    sizes_p = list(sizes) + [0] * (F - nominal)
    s, lens = cl.pack_streams(_shard(streams, mesh, Fl))
    g0 = mesh.rank * Fl
    valid = torch.tensor([g < nominal for g in range(g0, g0 + Fl)],
                         device=mesh.device)
    return (Fl, sizes_p, s.to(mesh.device), lens.to(mesh.device), valid)


def decode_lzx_streams_sharded(mesh: Mesh, streams: list[bytes],
                               sizes: list[int], window_bits: int,
                               decline_on_intel: bool = False
                               ) -> list[bytes] | None:
    """Independent LZX streams over the ranks: each rank runs K3 on its
    lanes, then a local pointer-doubling resolve; the bytes are gathered.
    Streams larger than ``LZX_MESH_CAP`` decode in ``LZX_MESH_SEG``
    segments through K3's state records, window tails chaining phase B.

    Inputs must be WHOLE streams starting at output offset 0 (CAB folders;
    CHM reset chunks with ``decline_on_intel=True``): the E8 untransform
    applies on the host with curpos base 0 when flagged. Chunks of ONE
    sequential stream must pass ``decline_on_intel=True``: intel state is
    stream-global in the reference (lzxd.c:707-713)."""
    if not streams:
        return []
    try:
        if max(sizes) > LZX_MESH_CAP:
            return _decode_lzx_sharded_seg(mesh, streams, sizes,
                                           window_bits, decline_on_intel)
        return _decode_lzx_sharded_one(mesh, streams, sizes, window_bits,
                                       decline_on_intel)
    except NeedFallback as e:
        return mesh.decline("decode_lzx_streams_sharded", e)


def _gather_lanes(mesh: Mesh, *rows):
    """Each per-lane row gathered: numpy ``(size * Fl,)`` in lane order."""
    return [all_gather(mesh, r.to(torch.int64)).reshape(-1).cpu().numpy()
            for r in rows]


def _any_rank(mesh: Mesh, flag: bool) -> bool:
    return bool(all_gather(mesh, torch.tensor(
        [int(flag)], device=mesh.device)).any())


def _decode_lzx_sharded_one(mesh, streams, sizes, window_bits,
                            decline_on_intel):
    nominal = len(streams)
    Fl, sizes_p, s, lens, valid = _lane_batch(mesh, streams, sizes)
    WSIZE = 1 << window_bits
    cap = max(sizes)
    stride = WSIZE + cap
    N_loc = Fl * stride
    if N_loc > MESH_RESOLVE_BUDGET:
        raise NeedFallback("resolve buffer beyond budget")
    t_pad = ((cap + 4096 + 127) // 128) * 128
    dev = mesh.device
    out_lens = torch.tensor(_shard(sizes_p, mesh, Fl), dtype=torch.int32)
    hists = torch.zeros(Fl, dtype=torch.int32)

    tok, litw, cnt = cl.lzx_phase_a(s, lens, out_lens.to(dev), hists.to(dev),
                                    window_bits, tcap=t_pad)
    errs = torch.where(valid, cnt[0], 0)
    flen = torch.where(valid, cnt[1], 0)
    out, bad = _lanes_resolve(_live_tokens(tok, cnt, valid), litw, flen, Fl,
                              WSIZE, stride, N_loc)
    inv = bool((errs != 0).any()) or bad
    out = all_gather(mesh, out.to(torch.uint8)).cpu().numpy()
    flen, ifl, ifsz = _gather_lanes(mesh, flen, cnt[4], cnt[5])
    if _any_rank(mesh, inv):
        raise NeedFallback("kernel error / invalid chain")
    if not np.array_equal(flen[:nominal], np.asarray(sizes, np.int64)):
        raise NeedFallback("size mismatch")
    if decline_on_intel and ifl[:nominal].any() and ifsz[:nominal].any():
        raise NeedFallback("intel E8 state is stream-global")
    results = []
    for g in range(nominal):
        dd, j = g // Fl, g % Fl
        blob = out[dd, j * stride + WSIZE:
                   j * stride + WSIZE + sizes[g]].tobytes()
        if ifl[g] and ifsz[g]:
            blob = e8_untransform(blob, int(ifsz[g]))
        results.append(blob)
    return results


def _decode_lzx_sharded_seg(mesh, streams, sizes, window_bits,
                            decline_on_intel):
    """Segmented decode for streams beyond LZX_MESH_CAP: every launch
    advances each unfinished lane by <= LZX_MESH_SEG bytes (32 KiB frame
    aligned), K3's state record carried between launches on the rank's
    device, and each lane's previous window tail preloading the resolve
    prefix."""
    nominal = len(streams)
    Fl, sizes_p, s, lens, valid = _lane_batch(mesh, streams, sizes)
    F = Fl * mesh.size
    WSIZE = 1 << window_bits
    SEG = LZX_MESH_SEG
    stride = WSIZE + SEG
    N_loc = Fl * stride
    if N_loc > MESH_RESOLVE_BUDGET:
        raise NeedFallback("resolve buffer beyond budget")
    t_pad = ((SEG + 4096 + 127) // 128) * 128
    dev = mesh.device
    hists = torch.zeros(Fl, dtype=torch.int32, device=dev)
    mine = np.arange(mesh.rank * Fl, (mesh.rank + 1) * Fl)

    pos = np.zeros(F, np.int64)
    total = np.asarray(sizes_p, np.int64)
    parts = [bytearray() for _ in range(F)]
    tails = torch.zeros((Fl, WSIZE), dtype=torch.int64, device=dev)
    state = None
    ifl = np.zeros(F, np.int64)
    ifsz = np.zeros(F, np.int64)
    while (pos < total).any():
        targets = np.minimum(total, pos + SEG)
        tok, litw, cnt, state = cl.lzx_phase_a(
            s, lens, torch.from_numpy(targets[mine].astype(np.int32)).to(dev),
            hists, window_bits, tcap=t_pad, state=state, return_state=True)
        prev = torch.from_numpy(pos[mine]).to(dev)
        errs = torch.where(valid, cnt[0], 0)
        seg_flen = torch.where(valid, cnt[1] - prev, 0)
        out, bad = _lanes_resolve(_live_tokens(tok, cnt, valid), litw,
                                  seg_flen, Fl, WSIZE, stride, N_loc,
                                  pfx=tails)
        inv = bool((errs != 0).any()) or bad
        gathered = all_gather(mesh, out.to(torch.uint8)).cpu().numpy()
        segf, c4, c5 = _gather_lanes(mesh, seg_flen, cnt[4], cnt[5])
        if _any_rank(mesh, inv):
            raise NeedFallback("kernel error / invalid chain")
        for g in range(F):
            dd, j = g // Fl, g % Fl
            want = int(targets[g] - pos[g])
            if want == 0:
                continue
            if segf[g] != want:
                raise NeedFallback("segment length mismatch")
            parts[g].extend(gathered[dd, j * stride + WSIZE:
                                     j * stride + WSIZE + want].tobytes())
            ifl[g], ifsz[g] = c4[g], c5[g]
            if dd == mesh.rank:
                seg = out[j * stride + WSIZE:j * stride + WSIZE + want]
                tails[j] = torch.cat([tails[j], seg])[-WSIZE:]
        pos = targets
    if decline_on_intel and ifl[:nominal].any() and ifsz[:nominal].any():
        raise NeedFallback("intel E8 state is stream-global")
    results = []
    for g in range(nominal):
        blob = bytes(parts[g])
        if ifl[g] and ifsz[g]:
            blob = e8_untransform(blob, int(ifsz[g]))
        results.append(blob)
    return results


def decode_qtm_streams_sharded(mesh: Mesh, streams: list[bytes],
                               sizes: list[int], window_bits: int
                               ) -> list[bytes] | None:
    """Independent Quantum folder streams (0xFF trailers injected) over the
    ranks on K4: the same folder axis as LZX, no communication but the
    gather; phase B is the shared pointer-doubling resolve (the kernels
    emit one token format)."""
    if not streams:
        return []
    try:
        nominal = len(streams)
        if max(sizes) > QTM_MESH_CAP:
            raise NeedFallback("stream beyond mesh lane budget")
        if mesh.device.type == "cpu" and max(sizes) > QTM_CPU_CAP:
            # the plain K4 is a Python loop: the CPU mesh checks the
            # communication on tiny folders; a card takes any size
            raise NeedFallback("interpret-mode budget")
        Fl, sizes_p, s, lens, valid = _lane_batch(mesh, streams, sizes)
        WSIZE = 1 << window_bits
        cap = max(sizes)
        stride = WSIZE + cap
        N_loc = Fl * stride
        if N_loc > MESH_RESOLVE_BUDGET:
            raise NeedFallback("resolve buffer beyond budget")
        t_pad = ((cap * 2 + 4096 + 127) // 128) * 128
        dev = mesh.device
        out_lens = torch.tensor(_shard(sizes_p, mesh, Fl), dtype=torch.int32)
        tok, litw, cnt = cq.qtm_phase_a(s, lens, out_lens.to(dev),
                                        window_bits, tcap=t_pad)
        errs = torch.where(valid, cnt[0], 0)
        flen = torch.where(valid, cnt[1], 0)
        out, bad = _lanes_resolve(_live_tokens(tok, cnt, valid), litw, flen,
                                  Fl, WSIZE, stride, N_loc)
        inv = bool((errs != 0).any()) or bad
        out = all_gather(mesh, out.to(torch.uint8)).cpu().numpy()
        (flen,) = _gather_lanes(mesh, flen)
        if _any_rank(mesh, inv):
            raise NeedFallback("kernel error / invalid chain")
        if not np.array_equal(flen[:nominal], np.asarray(sizes, np.int64)):
            raise NeedFallback("size mismatch")
        return [out[g // Fl, (g % Fl) * stride + WSIZE:
                    (g % Fl) * stride + WSIZE + sizes[g]].tobytes()
                for g in range(nominal)]
    except NeedFallback as e:
        return mesh.decline("decode_qtm_streams_sharded", e)


# ---------------------------------------------------------------------------
# whole archives
# ---------------------------------------------------------------------------

def _member_bytes(files, folders, folder_bytes):
    """{filename: bytes} of every file, or None when a folder is missing
    or short."""
    out = {}
    for f in files:
        fi = next(i for i, fol in enumerate(folders) if fol is f.folder)
        blob = folder_bytes.get(fi)
        if blob is None or f.offset + f.length > len(blob):
            return None
        out[f.filename] = blob[f.offset:f.offset + f.length]
    return out


def decode_cab_sharded(mesh: Mesh, path_or_bytes) -> dict | None:
    """A whole cabinet over the mesh, one route per codec: MSZIP folders
    through the ring (frames over the ranks), LZX folders as independent
    K3 lane streams (segmented when large), Quantum folders as K4 lanes
    (the native engine where they decline: a decline, counted), NONE
    folders as raw copies. Returns {filename: bytes} for every member, or
    None where a folder declines."""
    from .. import native
    from ..formats.cab import COMPTYPE_MASK, CabDecompressor

    d = CabDecompressor(engine="scalar")
    cab = d.open(path_or_bytes)
    folder_bytes = {}
    lzx_jobs = {}   # wb -> [(fi, stream, size)]
    qtm_jobs = {}
    for fi, fol in enumerate(cab.folders):
        ct = fol.comp_type & COMPTYPE_MASK
        if ct > 3:
            return mesh.decline("decode_cab_sharded", NeedFallback(
                "unknown compression type"))
        if ct == 1:
            collected = d.collect_mszip_frames(fol)
            if collected is None:
                return mesh.decline("decode_cab_sharded", NeedFallback(
                    "CFDATA blocks could not be collected"))
            frames, sizes = collected
            blob = decode_frames_ring(mesh, frames, sizes)
            if blob is None:
                return None
            folder_bytes[fi] = blob
            continue
        collected = d.collect_raw_blocks(fol)
        if collected is None:
            return mesh.decline("decode_cab_sharded", NeedFallback(
                "CFDATA blocks could not be collected"))
        blocks, sizes = collected
        wb = (fol.comp_type >> 8) & 0x1F
        if ct == 0:
            folder_bytes[fi] = b"".join(blocks)
        elif ct == 3:
            lzx_jobs.setdefault(wb, []).append(
                (fi, b"".join(blocks), sum(sizes)))
        else:
            # cabd injects a 0xFF realign trailer after each block
            # (cabd.c:1327-1332)
            qtm_jobs.setdefault(wb, []).append(
                (fi, b"".join(b + b"\xff" for b in blocks), sum(sizes)))
    for wb, jobs in lzx_jobs.items():
        outs = decode_lzx_streams_sharded(
            mesh, [j[1] for j in jobs], [j[2] for j in jobs], wb)
        if outs is None:
            return None
        for (fi, _, _), blob in zip(jobs, outs):
            folder_bytes[fi] = blob
    for wb, jobs in qtm_jobs.items():
        outs = decode_qtm_streams_sharded(
            mesh, [j[1] for j in jobs], [j[2] for j in jobs], wb)
        if outs is None:
            # the host adaptive-arithmetic engine (folder axis)
            mesh.decline("decode_cab_sharded", NeedFallback(
                "Quantum folders on the native engine"))
            if not native.available():
                return None
            outs = [native.qtm_decode(stream, wb, total)
                    for _, stream, total in jobs]
            if any(o is None for o in outs):
                return None
        for (fi, _, _), blob in zip(jobs, outs):
            folder_bytes[fi] = blob
    return _member_bytes(cab.files, cab.folders, folder_bytes)


def decode_chm_sharded(mesh: Mesh, path_or_bytes) -> dict | None:
    """A whole CHM over the mesh: the ResetTable cuts section 1 into
    independent LZX reset-interval chunks (chmd.c:1147-1175: the
    checkpoint grid is the shard grid), each on a K3 lane; section 0
    members are raw copies. Returns {filename: bytes} for every listed
    member (content files only), or None where section 1 declines."""
    from ..formats.chm import ChmDecompressor
    from ..system import BytesSink

    d = ChmDecompressor(engine="scalar")
    chm = d.open(path_or_bytes)
    plan = d.sec1_chunk_plan(chm)
    sec1 = None
    if plan is not None:
        chunks, csizes, window_bits = plan
        outs = decode_lzx_streams_sharded(mesh, chunks, csizes, window_bits,
                                          decline_on_intel=True)
        if outs is not None:
            sec1 = b"".join(outs)
    out = {}
    for f in chm.files:
        if f.section is not None and f.section.id == 1:
            if sec1 is None or f.offset + f.length > len(sec1):
                return None
            out[f.filename] = sec1[f.offset:f.offset + f.length]
        else:
            s = BytesSink()
            d.extract(f, s)
            out[f.filename] = s.getvalue()
    return out
