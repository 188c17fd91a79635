"""Folder and stream decode on the GPU: the port's batched engines.

``CudaMszipEngine`` ports ``libmspack_tpu/parallel/tpu_pipeline.py::
TpuMszipEngine``: K1 phase A + host or device phase B for MSZIP folders.
``CudaLzxEngine`` ports ``TpuLzxEngine``: K3 phase A + host phase B for
independent LZX streams (CAB folders, CHM reset chunks, OAB DELTA blocks).
``CudaQtmEngine`` ports ``TpuQtmEngine``: K4 phase A + the same host phase
B for CAB Quantum folders.

MSZIP: the frames of whole folders are batched into lanes, one frame per
lane. K1 (``ops/cuda_inflate.py``) decodes each frame into a token trace;
phase B turns the traces into bytes, chaining the frames of a folder so
that matches reach into the frame before (reference mszipd.c:407-459):

* ``phase_b="host"``: the traces are pulled to the host and resolved by
  the native C++ resolver (``native.resolve_traces``);
* ``phase_b="device"``: K2 (``ops/cuda_resolve.py``) resolves them on the
  card and only the bytes cross to the host.

A folder with a flagged lane (corrupt frame, token cap, wrong size) is
re-decoded by the native engine, which reproduces the reference's error
semantics; a folder above the trace budget goes there directly. Every
such decline is counted in ``declines`` by reason.

With ``device="cpu"`` the same pipelines run the kernels' plain versions.

Each engine call is the span ``mspack.engine.decode`` (``timings`` key
``total_ms``); inside it, per launch, ``mspack.engine.pack`` (pack,
tensors, upload and the kernel's launch), ``.wait`` (the counts pull, where
the host blocks on the kernel), ``.pull`` (the trace or byte pulls),
``.resolve`` (host phase B, ``host_resolve_ms``) and ``.copy_out`` (the
bytes copied into each stream's or folder's own buffer).
"""
from __future__ import annotations

import collections
import contextlib
import time

import numpy as np
import torch

from .. import native
from .._device import resolve_device
from ..ops import cuda_inflate as ci
from ..ops import cuda_lzx as cl
from ..ops import cuda_qtm as cq
from ..ops import cuda_resolve as cr
from ..tracing import recording, span, spanned

FRAME_MAX = ci.FRAME_MAX
# Device memory for one launch's trace: tok + litw are 8 bytes per token,
# and a lane holds up to one token per output byte, so 1 GiB holds 128 MiB
# of LZX output. An MSZIP lane adds K2's scratch, 2 bytes per output byte:
# 1 GiB holds 3276 frames. Two launches are in flight at once.
TRACE_BUDGET = 1 << 30
MAX_LANES = TRACE_BUDGET // ((8 + 2) * FRAME_MAX)


def window_tails(refs, window_bits, width=None):
    """Each LZX stream's window before its first byte, as uint8 numpy
    ``(len(refs), width)``, the whole window (``2^window_bits``) by
    default: zeros, with the stream's DELTA reference data (if any) at the
    tail (lzxd.c:348-382). The segmented decodes carry these rows from one
    launch to the next."""
    width = 1 << window_bits if width is None else width
    hists = np.zeros((len(refs), width), np.uint8)
    for j, ref in enumerate(refs):
        if ref:
            hists[j, width - len(ref):] = np.frombuffer(ref, np.uint8)
    return hists


def resolve_lzx(tok, litw, sizes, iflags, ifszs, window_bits, hists=None,
                n_threads=None):
    """LZX phase B on the host: ``native.lzx_resolve_traces`` of each
    lane's trace (int32 numpy ``(L, T)``, rows as K3 writes them) into one
    arena, with the E8 untransform where rows 4-5 (``iflags``, ``ifszs``)
    ask for it, and the window before each stream ending with its
    ``hists`` entry (one bytes-like per lane: DELTA reference data or the
    tail a previous segment left; zeros when None). K3 flags a match that
    reaches further back than a lane's history (``lzx_core.cuh:426``), so
    no lane needs more of its window than that. Returns each lane's bytes
    as numpy views, or None on the resolver's error."""
    offs = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int64)
    arena = np.empty(max(int(offs[-1]), 1), np.uint8)
    r = native.lzx_resolve_traces(
        np.ascontiguousarray(tok, np.int32),
        np.ascontiguousarray(litw, np.int32), [int(s) for s in sizes],
        [int(v) for v in iflags], [int(v) for v in ifszs], window_bits,
        arena, [int(o) for o in offs], n_threads, hists=hists)
    if r != 0:
        return None
    return [arena[offs[j]:offs[j + 1]] for j in range(len(sizes))]


def segment_targets(totals, seg):
    """The launches of a segmented LZX decode: yields ``(pos, targets)``,
    each lane's output position before and after the launch, in steps of
    ``seg`` bytes until every lane reaches its total."""
    totals = np.asarray(totals, np.int64)
    pos = np.zeros_like(totals)
    while (pos < totals).any():
        targets = np.minimum(totals, pos + seg)
        yield pos, targets
        pos = targets


class _Engine:
    """Device, decline counts and phase timings shared by the engines.

    ``timings`` (ms, summed over calls): ``total_ms`` and
    ``host_resolve_ms`` on the host clock, always; ``upload_ms``, the
    kernels' ``k1_ms``/``k2_ms``/``k3_ms``/``k4_ms``, ``trace_pull_ms``
    and ``bytes_pull_ms`` on CUDA events, which the card records only
    while a ``torch.profiler`` records (the CPU times them on the host
    clock always)."""

    def __init__(self, device):
        self.device = resolve_device(device)
        # both accumulate over calls; a caller clears them to read one run
        self.declines: collections.Counter = collections.Counter()
        self.timings: dict[str, float] = {}
        self._streams = None

    # -- timing: CUDA events on the card while a profiler records, the
    # host clock on the CPU ---------------------------------------------

    def _mark(self):
        if self.device.type != "cuda":
            return time.perf_counter()
        if not recording():
            return None
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    def _add(self, name, a, b):
        """Adds the time between marks ``a`` and ``b``; nothing where
        either was taken with no profiler recording."""
        if a is None or b is None:
            return
        if self.device.type != "cuda":
            ms = (b - a) * 1e3
        else:
            # an event recorded just after a synchronous pull may not have
            # completed yet, and elapsed_time refuses it
            b.synchronize()
            ms = a.elapsed_time(b)
        self.timings[name] = self.timings.get(name, 0.0) + ms

    @staticmethod
    def _wait(cnt):
        """The counts on the host, once the kernel has written them."""
        with span("mspack.engine.wait"):
            return cnt.cpu().numpy()

    def _on(self, k):
        """The stream of launch slot k (two, alternating), as a context."""
        if self.device.type != "cuda":
            return contextlib.nullcontext()
        if self._streams is None:
            self._streams = [torch.cuda.Stream(self.device)
                             for _ in range(2)]
        return torch.cuda.stream(self._streams[k % 2])


class CudaMszipEngine(_Engine):
    """Batched MSZIP folder decode through K1 and host or device phase B."""

    def __init__(self, device="cuda", phase_b: str = "host"):
        if phase_b not in ("host", "device"):
            raise ValueError(f"phase_b must be host or device: {phase_b}")
        super().__init__(device)
        self.phase_b = phase_b
        # the folders of the last call that K1 declined (flagged, or above
        # the trace budget) and the native engine decoded again
        self.redecoded: list[int] = []

    # -- public ----------------------------------------------------------

    @spanned("mspack.engine.decode", "total_ms")
    def decode_folders(self, folders, n_threads=None, per_folder=False):
        """folders: [(frames without 'CK', sizes)] as native.mszip_folders
        takes them. Returns the bytes of each folder, or None when a
        flagged folder fails its native re-decode as well (the caller's
        scalar path then raises the reference's error); with
        ``per_folder`` always the list, None only in such folders."""
        offsets = np.zeros(len(folders) + 1, np.int64)
        np.cumsum([sum(s) for _, s in folders], out=offsets[1:])
        n = int(offsets[-1])
        if self.phase_b == "device" and self.device.type == "cuda":
            # page-locked, so that device phase B's bytes land in place at
            # the link's rate (a pull into pageable memory runs ~20x slower)
            out = torch.empty(n, dtype=torch.uint8, pin_memory=True).numpy()
        else:
            out = np.empty(n, np.uint8)
        failed = set()
        # two-deep pipeline: batch k+1's pack, upload and K1 are queued on
        # the other stream before batch k's counts, trace pull and resolve
        inflight = []
        for k, batch in enumerate(self._split_on_folders(folders, failed)):
            inflight.append(self._launch(k, batch, folders))
            if len(inflight) > 1:
                self._finish(inflight.pop(0), folders, out, offsets, failed,
                             n_threads)
        for h in inflight:
            self._finish(h, folders, out, offsets, failed, n_threads)
        self.redecoded = sorted(failed)
        lost = set()
        for fi in self.redecoded:
            blob = native.mszip_folder(*folders[fi], n_threads)
            if blob is None:
                if not per_folder:
                    return None
                lost.add(fi)
                continue
            out[offsets[fi]:offsets[fi + 1]] = np.frombuffer(blob, np.uint8)
        with span("mspack.engine.copy_out"):
            return [None if i in lost
                    else out[offsets[i]:offsets[i + 1]].tobytes()
                    for i in range(len(folders))]

    # -- batching --------------------------------------------------------

    def _split_on_folders(self, folders, failed):
        """Greedy batches of <= MAX_LANES lanes, folders kept whole."""
        batches, cur, lanes = [], [], 0
        for fi, (frames, _) in enumerate(folders):
            n = len(frames)
            if n == 0:
                continue
            if n > MAX_LANES:
                self.declines["folder above trace budget"] += 1
                failed.add(fi)
                continue
            if lanes + n > MAX_LANES:
                batches.append(cur)
                cur, lanes = [], 0
            cur.append(fi)
            lanes += n
        if cur:
            batches.append(cur)
        return batches

    def _launch(self, k, batch, folders):
        """Pack, upload and launch K1 for one batch; nothing waits."""
        with span("mspack.engine.pack"):
            frames = [f for fi in batch for f in folders[fi][0]]
            sizes = [s for fi in batch for s in folders[fi][1]]
            # history: 0 for a folder's first frame, 32768 for the rest
            hists = [0 if j == 0 else FRAME_MAX
                     for fi in batch for j in range(len(folders[fi][0]))]
            streams, lens = ci.pack_streams(frames)
            hist_t = torch.tensor(hists, dtype=torch.int32)
            tcap = max(1, max(sizes))
            with self._on(k):
                e0 = self._mark()
                streams, lens, hist_t = (t.to(self.device)
                                         for t in (streams, lens, hist_t))
                e1 = self._mark()
                tok, litw, cnt = ci.inflate_phase_a(streams, lens, hist_t,
                                                    tcap=tcap)
                e2 = self._mark()
        return dict(k=k, batch=batch, sizes=sizes, tok=tok, litw=litw,
                    cnt=cnt, marks=(e0, e1, e2))

    # -- phase B ---------------------------------------------------------

    def _finish(self, h, folders, out, offsets, failed, n_threads):
        with self._on(h["k"]):
            cnt = self._wait(h["cnt"])
            e0, e1, e2 = h["marks"]
            self._add("upload_ms", e0, e1)
            self._add("k1_ms", e1, e2)
            sizes = np.asarray(h["sizes"])
            n = len(sizes)
            bad = (cnt[0, :n] != 0) | (cnt[1, :n] != sizes)
            runs, lane = [], 0   # (folder, first lane, lanes)
            for fi in h["batch"]:
                nf = len(folders[fi][0])
                if bad[lane:lane + nf].any():
                    self.declines["flagged lane"] += 1
                    failed.add(fi)
                else:
                    runs.append((fi, lane, nf))
                lane += nf
            if not runs:
                return
            if self.phase_b == "device":
                if self._partial_mid_frame(runs, sizes):
                    self.declines["partial mid-folder frame"] += 1
                else:
                    self._resolve_device(h, runs, sizes, out, offsets,
                                         failed)
                    return
            self._resolve_host(h, runs, sizes, cnt, out, offsets, failed,
                               n_threads)

    @staticmethod
    def _partial_mid_frame(runs, sizes):
        """The TPU engine's device rule: every frame but a folder's last
        fills its 32 KiB (cabd emits full blocks but the last)."""
        return any((sizes[l0:l0 + nf - 1] != FRAME_MAX).any()
                   for _, l0, nf in runs)

    def _resolve_host(self, h, runs, sizes, cnt, out, offsets, failed,
                      n_threads):
        tmax = max(1, int(max(cnt[2, l0:l0 + nf].max()
                              for _, l0, nf in runs)))
        with span("mspack.engine.pull"):
            e0 = self._mark()
            tok = h["tok"][:, :tmax].contiguous().cpu().numpy()
            litw = h["litw"][:, :tmax].contiguous().cpu().numpy()
            self._add("trace_pull_ms", e0, self._mark())
        with span("mspack.engine.resolve", self.timings, "host_resolve_ms"):
            # the good folders of a batch are consecutive unless one between
            # them failed; resolve straight into place when they are
            starts = [int(offsets[fi]) for fi, _, _ in runs]
            ends = [int(offsets[fi + 1]) for fi, _, _ in runs]
            if all(s == e for s, e in zip(starts[1:], ends)):
                target = out[starts[0]:ends[-1]]
            else:
                target = np.empty(sum(e - s for s, e in zip(starts, ends)),
                                  np.uint8)
            rel = np.concatenate([[0], np.cumsum([e - s for s, e in
                                                  zip(starts, ends)])])
            fsizes = [int(s) for _, l0, nf in runs for s in sizes[l0:l0 + nf]]
            r = native.resolve_traces(tok, litw, [l0 for _, l0, _ in runs],
                                      [nf for _, _, nf in runs], fsizes,
                                      target, [int(x) for x in rel],
                                      n_threads)
            if r != 0:
                self.declines["host resolve error"] += 1
                failed.update(fi for fi, _, _ in runs)
            elif target.base is not out:
                for i, (s, e) in enumerate(zip(starts, ends)):
                    out[s:e] = target[rel[i]:rel[i + 1]]

    def _resolve_device(self, h, runs, sizes, out, offsets, failed):
        n = len(sizes)
        lens = np.zeros(n, np.int32)   # flagged folders resolve to nothing
        flags = np.zeros(n, np.int32)
        for _, l0, nf in runs:
            lens[l0:l0 + nf] = sizes[l0:l0 + nf]
            flags[l0 + 1:l0 + nf] = 1
        e0 = self._mark()
        ob, counts = cr.resolve_frames_device(h["tok"], h["litw"],
                                              h["cnt"][2], lens, flags)
        e1 = self._mark()
        counts = self._wait(counts)
        host = torch.from_numpy(out)
        pos = 0
        with span("mspack.engine.pull"):
            for fi, l0, nf in runs:
                size = int(offsets[fi + 1] - offsets[fi])
                if not np.array_equal(counts[l0:l0 + nf], lens[l0:l0 + nf]):
                    self.declines["device resolve count mismatch"] += 1
                    failed.add(fi)
                else:
                    host[offsets[fi]:offsets[fi + 1]].copy_(
                        ob[pos:pos + size])
                pos += size
        e2 = self._mark()
        self._add("k2_ms", e0, e1)
        self._add("bytes_pull_ms", e1, e2)


class _StreamEngine(_Engine):
    """Batching shared by the engines of independent streams, one per
    lane (K3's LZX, K4's Quantum): a batch decodes in one launch when its
    trace (lanes x the longest stream's output x 8 bytes) fits
    ``TRACE_BUDGET``; otherwise, or when a stream is longer than
    ``segment_bytes``, in frame-aligned segments through the kernel's
    state records. Two launches are in flight at once. Subclasses give
    ``_launch``, ``_finish`` and ``_segmented``."""

    TRACE_BUDGET = TRACE_BUDGET

    def __init__(self, device="cuda", segment_bytes: int | None = None):
        if segment_bytes is not None and (segment_bytes <= 0
                                          or segment_bytes % cl.FRAME):
            raise ValueError("segment_bytes must be a positive multiple "
                             f"of {cl.FRAME}")
        super().__init__(device)
        self.segment_bytes = segment_bytes
        self.n_decoded = 0   # streams decoded through the kernel
        self.lanes = 0       # lanes launched

    def _run(self, job):
        """Every batch of the plan, two-deep; False on the first decline."""
        ok = True
        inflight = []
        for k, (idxs, seg) in enumerate(self._plan(job["out_lens"])):
            if seg:
                while ok and inflight:
                    ok = self._finish(inflight.pop(0), job)
                ok = ok and self._segmented(idxs, seg, job)
            else:
                inflight.append(self._launch(k, idxs, job))
                if len(inflight) > 1:
                    ok = self._finish(inflight.pop(0), job)
            if not ok:
                break
        while ok and inflight:
            ok = self._finish(inflight.pop(0), job)
        return ok

    def _plan(self, out_lens):
        """[(lane indices, segment bytes or None)]: single launches whose
        trace fits the budget, then the streams that need segments."""
        cap = self.TRACE_BUDGET // 8   # token slots of one launch
        seg_lim = self.segment_bytes or cap
        plan, cur, cur_max, long_ = [], [], 0, []
        for i, n in enumerate(out_lens):
            n = max(int(n), 1)
            if n > seg_lim:
                long_.append(i)
                continue
            if cur and max(cur_max, n) * (len(cur) + 1) > cap:
                plan.append((cur, None))
                cur, cur_max = [], 0
            cur.append(i)
            cur_max = max(cur_max, n)
        if cur:
            plan.append((cur, None))
        if long_:
            seg = self.segment_bytes or max(
                cl.FRAME, cap // len(long_) // cl.FRAME * cl.FRAME)
            per = max(1, cap // seg)
            plan += [(long_[j:j + per], seg)
                     for j in range(0, len(long_), per)]
        return plan

    def _counts_ok(self, cnt, lanes, targets):
        """Row 0 clear and row 1 at its target on the given lanes."""
        if (cnt[0, lanes] != 0).any() or \
                (cnt[1, lanes] != np.asarray(targets)[lanes]).any():
            self.declines["flagged lane"] += 1
            return False
        return True

    def _pull(self, tok, litw, ntok):
        with span("mspack.engine.pull"):
            e0 = self._mark()
            tmax = max(1, int(ntok.max()))
            tok = tok[:, :tmax].contiguous().cpu().numpy()
            litw = litw[:, :tmax].contiguous().cpu().numpy()
            self._add("trace_pull_ms", e0, self._mark())
        return tok, litw

    def _resolve(self, tok, litw, sizes, iflags, ifszs, hists, job):
        """``resolve_lzx``, timed; a resolver error is a decline."""
        with span("mspack.engine.resolve", self.timings, "host_resolve_ms"):
            parts = resolve_lzx(tok, litw, sizes, iflags, ifszs,
                                job["window_bits"], hists, job["n_threads"])
        if parts is None:
            self.declines["host resolve error"] += 1
        return parts


class CudaLzxEngine(_StreamEngine):
    """Batched LZX stream decode through K3 and host phase B.

    Each stream is an independent fresh-entropy-state LZX stream: a CAB
    folder (CAB LZX never resets, cabd.c:1249-1250, so a folder is one
    stream), a CHM reset-interval chunk, or an OAB DELTA block. Streams
    batch onto lanes, one per lane; K3 (``ops/cuda_lzx.py``) emits each
    lane's token trace and the native C++ resolver
    (``native.lzx_resolve_traces``) turns the traces into bytes, with the
    E8 call-translation untransform (lzxd.c:706-733). In segments, window
    tails carry phase B across launches and E8 runs once at the end over
    the pre-transform bytes.

    ``decode_streams`` returns the bytes of every stream, or None when it
    declines (a flagged lane, an intel E8 header where chunks of one
    stream or DELTA blocks forbid it, a resolver error); the caller then
    takes its own fallback. With ``per_lane`` (independent streams, as OAB
    blocks are) it always returns the list, None only in the lanes that
    declined. Every decline is counted in ``declines``, once a launch.

    A CAB folder whose caller gives its CFDATA payload lengths
    (``frame_sizes``) decodes a warp per 32 KiB frame (``lzx_phase_a``
    picks the rows: ``cuda_lzx.split_rows``; a folder whose blocks are
    not one frame each decodes serially in the same call). ``timings``
    counts them: ``k3_split_streams``, ``k3_split_frames``,
    ``k3_split_bytes`` (output bytes the frame lanes decoded) and
    ``k3_split_fallbacks`` (split streams that decoded serially), and
    each fallback's first reason under ``k3_split_fallbacks_<reason>``
    (``cuda_lzx.SPLIT_REASONS``). A fallback is no decline.

    DELTA streams with reference data (OAB patch blocks) count in
    ``timings`` too: ``ref_bytes``, the reference bytes of the lanes that K3
    decoded and phase B resolved, and ``ref_lanes``, those lanes. K3 gets
    each lane's reference length as its history budget; the bytes stay on
    the host, where phase B reads them (``hists``)."""

    SPLIT_KEYS = ("k3_split_streams", "k3_split_frames", "k3_split_bytes",
                  "k3_split_fallbacks")

    @spanned("mspack.engine.decode", "total_ms")
    def decode_streams(self, streams, out_lens, window_bits, n_threads=None,
                       decline_on_intel=False, is_delta=False, refs=None,
                       per_lane=False, frame_sizes=None):
        """streams: list of bytes; out_lens: their decoded sizes; refs:
        DELTA reference data per stream (preloaded at the window tail,
        lzxd.c:348-382). ``decline_on_intel``: the streams are chunks of
        one stream (CHM section 1), whose E8 state is stream-global
        (lzxd.c:707-713), so an E8 header declines. ``frame_sizes``: each
        stream's CFDATA payload lengths (a CAB folder's), or None."""
        if not streams:
            return []
        declined = [None] * len(streams) if per_lane else None
        if not native.available():
            self.declines["native resolver unavailable"] += 1
            return declined
        lo, hi = (17, 25) if is_delta else (15, 21)
        if not lo <= window_bits <= hi:
            self.declines["window size outside LZX's"] += 1
            return declined
        job = dict(streams=streams, out_lens=list(out_lens),
                   window_bits=window_bits, n_threads=n_threads,
                   intel_declines=decline_on_intel or is_delta,
                   is_delta=is_delta, per_lane=per_lane,
                   refs=list(refs) if refs else [b""] * len(streams),
                   frame_sizes=frame_sizes,
                   outs=[None] * len(streams))
        # per_lane: a segmented batch that declines stops the run; its lanes
        # and those of the batches after it stay None
        return job["outs"] if self._run(job) or per_lane else None

    def _count_split(self, row6, sizes):
        """The split counters of a launch's lanes (counts row 6)."""
        row6 = np.asarray(row6)
        done = row6 == cl.SPLIT_DONE
        sizes = np.asarray(sizes, np.int64)
        add = (int(done.sum()), int((-(-sizes[done] // cl.FRAME)).sum()),
               int(sizes[done].sum()), int((row6 > cl.SPLIT_DONE).sum()))
        for key, v in zip(self.SPLIT_KEYS, add):
            self.timings[key] = self.timings.get(key, 0) + v
        for v in row6[row6 > cl.SPLIT_DONE]:
            key = "k3_split_fallbacks_" + cl.SPLIT_REASONS[int(v) & -int(v)]
            self.timings[key] = self.timings.get(key, 0) + 1

    def _count_refs(self, lanes, job):
        """``ref_bytes`` and ``ref_lanes`` of resolved lanes."""
        refs = [len(job["refs"][i]) for i in lanes if job["refs"][i]]
        if refs:
            for key, v in (("ref_bytes", sum(refs)), ("ref_lanes", len(refs))):
                self.timings[key] = self.timings.get(key, 0) + v

    # -- batching --------------------------------------------------------

    def _upload(self, idxs, job):
        """Streams, lengths and history budgets (DELTA reference bytes)
        of the lanes, on the device."""
        streams, lens = cl.pack_streams([job["streams"][i] for i in idxs])
        budgets = torch.tensor([len(job["refs"][i]) for i in idxs],
                               dtype=torch.int32)
        return tuple(t.to(self.device) for t in (streams, lens, budgets))

    def _launch(self, k, idxs, job):
        """Pack, upload and launch K3 for one batch; nothing waits."""
        with span("mspack.engine.pack"):
            sizes = [int(job["out_lens"][i]) for i in idxs]
            targets = torch.tensor(sizes, dtype=torch.int32)
            with self._on(k):
                e0 = self._mark()
                streams, lens, budgets = self._upload(idxs, job)
                targets = targets.to(self.device)
                e1 = self._mark()
                fs = job["frame_sizes"]
                tok, litw, cnt = cl.lzx_phase_a(
                    streams, lens, targets, budgets, job["window_bits"],
                    is_delta=job["is_delta"], tcap=max(1, max(sizes)),
                    frame_sizes=None if fs is None else [fs[i] for i in idxs])
                e2 = self._mark()
        self.lanes += len(idxs)
        return dict(k=k, idxs=idxs, sizes=sizes, tok=tok, litw=litw,
                    cnt=cnt, marks=(e0, e1, e2))

    # -- phase B ---------------------------------------------------------

    def _intel_lanes(self, cnt, job):
        """The lanes (columns of ``cnt``) whose E8 header the streams
        forbid, counted once."""
        e8 = (cnt[4] != 0) & (cnt[5] != 0) & job["intel_declines"]
        if e8.any():
            self.declines["intel E8 in chunked or DELTA streams"] += 1
        return e8

    @staticmethod
    def _tails(idxs, job):
        """The lanes' windows before their streams for a segmented decode,
        as wide as phase B reads back across segments: the reference data
        and the lane's own bytes, at most the window."""
        refs = [job["refs"][i] for i in idxs]
        reach = max(len(r) + int(job["out_lens"][i])
                    for r, i in zip(refs, idxs))
        return window_tails(refs, job["window_bits"],
                            min(1 << job["window_bits"], max(1, reach)))

    def _finish(self, h, job):
        """Phase B of one launch. Without ``per_lane`` any declined lane
        declines the call (False); with it only the lanes that passed are
        resolved and the others stay None."""
        idxs, sizes = h["idxs"], h["sizes"]
        n = len(idxs)
        with self._on(h["k"]):
            cnt = self._wait(h["cnt"])[:, :n]
            e0, e1, e2 = h["marks"]
            self._add("upload_ms", e0, e1)
            self._add("k3_ms", e1, e2)
            self._count_split(cnt[6], sizes)
            bad = (cnt[0] != 0) | (cnt[1] != np.asarray(sizes))
            if bad.any():
                self.declines["flagged lane"] += 1
            bad |= self._intel_lanes(cnt, job)
            if bad.any() and not job["per_lane"]:
                return False
            good = np.flatnonzero(~bad)
            if not len(good):
                return True
            tok, litw = self._pull(h["tok"], h["litw"], cnt[2, good])
            if len(good) < n:
                tok, litw = tok[good], litw[good]
            lanes = [idxs[j] for j in good]
            hists = [job["refs"][i] for i in lanes] if job["is_delta"] \
                else None
            parts = self._resolve(tok, litw, [sizes[j] for j in good],
                                  [int(v) for v in cnt[4, good]],
                                  [int(v) for v in cnt[5, good]], hists, job)
        if parts is None:
            return job["per_lane"]
        with span("mspack.engine.copy_out"):
            for part, i in zip(parts, lanes):
                job["outs"][i] = part.tobytes()
        self.n_decoded += len(good)
        self._count_refs(lanes, job)
        return True

    def _segmented(self, idxs, seg, job):
        """Decode in launches of <= seg bytes per lane (frame-aligned),
        the decoder state carried in the K3 state records; window tails
        chain phase B across segments and E8 runs once at the end (the
        window holds pre-transform bytes, lzxd.c:706-733)."""
        n = len(idxs)
        totals = np.array([int(job["out_lens"][i]) for i in idxs])
        parts = [np.empty(int(t), np.uint8) for t in totals]
        tails = self._tails(idxs, job)
        with span("mspack.engine.pack"):
            e0 = self._mark()
            streams, lens, budgets = self._upload(idxs, job)
            self._add("upload_ms", e0, self._mark())
        self.lanes += n
        state = None
        cnt = None
        for pos, targets in segment_targets(totals, seg):
            e0 = self._mark()
            tok, litw, cnt, state = cl.lzx_phase_a(
                streams, lens,
                torch.tensor(targets, dtype=torch.int32).to(self.device),
                budgets, job["window_bits"], is_delta=job["is_delta"],
                tcap=seg, state=state, return_state=True)
            cnt = self._wait(cnt)
            self._add("k3_ms", e0, self._mark())
            if not self._counts_ok(cnt, pos < totals, targets):
                return False
            tok, litw = self._pull(tok, litw, cnt[2])
            got = self._resolve(tok, litw, targets - pos, [0] * n, [0] * n,
                                tails, job)
            if got is None:
                return False
            with span("mspack.engine.copy_out"):
                for j in range(n):
                    if targets[j] > pos[j]:
                        parts[j][pos[j]:targets[j]] = got[j]
                        tails[j] = np.concatenate([tails[j], got[j]])[
                            -len(tails[j]):]
        if self._intel_lanes(cnt[:, :n], job).any():
            return False
        with span("mspack.engine.copy_out"):
            for j, i in enumerate(idxs):
                if cnt[4, j] and cnt[5, j]:
                    native.e8_decode_buf(parts[j], int(cnt[5, j]), 0)
                job["outs"][i] = parts[j].tobytes()
        self.n_decoded += n
        self._count_refs(idxs, job)
        return True


def wrap_spans(tok, base, window_bits):
    """The matches among one lane's compacted tokens (int32 numpy) whose
    destination crosses a window lap end: ``(starts, lap ends)``, int64
    output positions; ``base`` is the lane's position before its first
    token. These are the matches at which the reference Quantum codec
    delivers a whole lap mid-match (codecs/qtm.py:309-322)."""
    wsize = 1 << window_bits
    tok = tok.astype(np.int64)
    match = (tok & cl.TOK_MATCH) != 0
    lens = np.where(match, tok & 0xFFFFF, tok & 7)
    starts = base + np.cumsum(lens) - lens
    s = starts[match & ((starts % wsize) + lens > wsize)]
    return s, (s // wsize + 1) * wsize


class CudaQtmEngine(_StreamEngine):
    """Batched Quantum stream decode through K4 and host phase B.

    Each stream is a CAB Quantum folder with the 0xFF trailer after every
    block (cabd.c:1327-1332), one per lane. Quantum's adaptive models make
    a stream strictly sequential (qtmd.c:92-166), so streams are the
    parallel axis. K4 (``ops/cuda_qtm.py``) emits each lane's token trace
    in K3's format and the native LZX resolver with no E8
    (``native.lzx_resolve_traces``) is phase B. In segments the models,
    cursor and frame count stay in K4's state records between launches
    and window tails carry phase B across them.

    ``decode_streams`` returns the bytes of every stream, or None when it
    declines (a flagged lane, a resolver error); the caller's scalar path
    then raises the reference's error. With ``per_lane`` (CAB folders are
    independent streams) it always returns the list, None only in the
    lanes that declined. Every decline is counted in ``declines``, once a
    launch. ``wrap_spans`` holds, per stream of the last call, the
    ``wrap_spans`` of its matches that crossed a window lap end."""

    @spanned("mspack.engine.decode", "total_ms")
    def decode_streams(self, streams, out_lens, window_bits, n_threads=None,
                       per_lane=False):
        """streams: list of bytes; out_lens: their decoded sizes."""
        self.wrap_spans = [(np.zeros(0, np.int64),) * 2 for _ in streams]
        if not streams:
            return []
        declined = [None] * len(streams) if per_lane else None
        if not native.available():
            self.declines["native resolver unavailable"] += 1
            return declined
        if not 10 <= window_bits <= 21:
            self.declines["window size outside Quantum's"] += 1
            return declined
        job = dict(streams=streams, out_lens=list(out_lens),
                   window_bits=window_bits, n_threads=n_threads,
                   per_lane=per_lane, outs=[None] * len(streams))
        # per_lane: a segmented batch that declines stops the run; its lanes
        # and those of the batches after it stay None
        return job["outs"] if self._run(job) or per_lane else None

    def _upload(self, idxs, job):
        streams, lens = cq.pack_streams([job["streams"][i] for i in idxs])
        return streams.to(self.device), lens.to(self.device)

    def _launch(self, k, idxs, job):
        """Pack, upload and launch K4 for one batch; nothing waits."""
        with span("mspack.engine.pack"):
            sizes = [int(job["out_lens"][i]) for i in idxs]
            targets = torch.tensor(sizes, dtype=torch.int32)
            with self._on(k):
                e0 = self._mark()
                streams, lens = self._upload(idxs, job)
                targets = targets.to(self.device)
                e1 = self._mark()
                tok, litw, cnt = cq.qtm_phase_a(streams, lens, targets,
                                                job["window_bits"],
                                                tcap=max(1, max(sizes)))
                e2 = self._mark()
        self.lanes += len(idxs)
        return dict(k=k, idxs=idxs, sizes=sizes, tok=tok, litw=litw,
                    cnt=cnt, marks=(e0, e1, e2))

    def _note_wraps(self, i, tok, c, base, wb):
        """Add stream i's lap-crossing matches of one launch (its token row
        ``tok`` and counts column ``c``, output position ``base`` before
        it)."""
        if c[4]:
            s, e = wrap_spans(tok[:c[2]], base, wb)
            old = self.wrap_spans[i]
            self.wrap_spans[i] = (np.concatenate([old[0], s]),
                                  np.concatenate([old[1], e]))

    def _finish(self, h, job):
        """Phase B of one launch. Without ``per_lane`` a flagged lane
        declines the call (False); with it only the lanes that passed are
        resolved and the others stay None."""
        idxs, sizes = h["idxs"], h["sizes"]
        n = len(idxs)
        with self._on(h["k"]):
            cnt = self._wait(h["cnt"])[:, :n]
            e0, e1, e2 = h["marks"]
            self._add("upload_ms", e0, e1)
            self._add("k4_ms", e1, e2)
            bad = (cnt[0] != 0) | (cnt[1] != np.asarray(sizes))
            if bad.any():
                self.declines["flagged lane"] += 1
                if not job["per_lane"]:
                    return False
            good = np.flatnonzero(~bad)
            if not len(good):
                return True
            tok, litw = self._pull(h["tok"], h["litw"], cnt[2, good])
            if len(good) < n:
                tok, litw = tok[good], litw[good]
            parts = self._resolve(tok, litw, [sizes[j] for j in good],
                                  [0] * len(good), [0] * len(good), None,
                                  job)
        if parts is None:
            return job["per_lane"]
        with span("mspack.engine.copy_out"):
            for r, j in enumerate(good):
                self._note_wraps(idxs[j], tok[r], cnt[:, j], 0,
                                 job["window_bits"])
                job["outs"][idxs[j]] = parts[r].tobytes()
        self.n_decoded += len(good)
        return True

    def _segmented(self, idxs, seg, job):
        """Decode in launches of <= seg bytes per lane (frame-aligned),
        the decoder state carried in the K4 state records; window tails
        chain phase B across segments."""
        n = len(idxs)
        wb = job["window_bits"]
        totals = np.array([int(job["out_lens"][i]) for i in idxs])
        parts = [np.empty(int(t), np.uint8) for t in totals]
        tails = window_tails([b""] * n, wb)
        with span("mspack.engine.pack"):
            e0 = self._mark()
            streams, lens = self._upload(idxs, job)
            self._add("upload_ms", e0, self._mark())
        self.lanes += n
        state = None
        for pos, targets in segment_targets(totals, seg):
            e0 = self._mark()
            tok, litw, cnt, state = cq.qtm_phase_a(
                streams, lens,
                torch.tensor(targets, dtype=torch.int32).to(self.device),
                wb, tcap=seg, state=state, return_state=True)
            cnt = self._wait(cnt)
            self._add("k4_ms", e0, self._mark())
            if not self._counts_ok(cnt, pos < totals, targets):
                return False
            tok, litw = self._pull(tok, litw, cnt[2])
            got = self._resolve(tok, litw, targets - pos, [0] * n, [0] * n,
                                tails, job)
            if got is None:
                return False
            with span("mspack.engine.copy_out"):
                for j, i in enumerate(idxs):
                    if targets[j] > pos[j]:
                        self._note_wraps(i, tok[j], cnt[:, j], pos[j], wb)
                        parts[j][pos[j]:targets[j]] = got[j]
                        tails[j] = np.concatenate([tails[j], got[j]])[
                            -len(tails[j]):]
        with span("mspack.engine.copy_out"):
            for j, i in enumerate(idxs):
                job["outs"][i] = parts[j].tobytes()
        self.n_decoded += n
        return True
