"""MSZIP folder decode on the GPU: K1 phase A + host or device phase B.

Port of ``libmspack_tpu/parallel/tpu_pipeline.py::TpuMszipEngine``. The
frames of whole folders are batched into lanes, one frame per lane. K1
(``ops/cuda_inflate.py``) decodes each frame into a token trace; phase B
turns the traces into bytes, chaining the frames of a folder so that
matches reach into the frame before (reference mszipd.c:407-459):

* ``phase_b="host"``: the traces are pulled to the host and resolved by
  the native C++ resolver (``native.resolve_traces``);
* ``phase_b="device"``: K2 (``ops/cuda_resolve.py``) resolves them on the
  card and only the bytes cross to the host.

A folder with a flagged lane (corrupt frame, token cap, wrong size) is
re-decoded by the native engine, which reproduces the reference's error
semantics; a folder above the trace budget goes there directly. Every
such decline is counted in ``declines`` by reason.

With ``device="cpu"`` the same pipeline runs the kernels' plain versions.
"""
from __future__ import annotations

import collections
import contextlib
import time

import numpy as np
import torch

from .._device import resolve_device
from ..ops import cuda_inflate as ci
from ..ops import cuda_resolve as cr

FRAME_MAX = ci.FRAME_MAX
# Device memory for one launch's trace: tok + litw are 8 bytes per token,
# and a lane holds up to FRAME_MAX tokens (one per output byte at worst),
# so 1 GiB holds 4096 lanes. Two launches are in flight at once.
TRACE_BUDGET = 1 << 30
MAX_LANES = TRACE_BUDGET // (8 * FRAME_MAX)


class CudaMszipEngine:
    """Batched MSZIP folder decode through K1 and host or device phase B."""

    def __init__(self, device="cuda", phase_b: str = "host"):
        if phase_b not in ("host", "device"):
            raise ValueError(f"phase_b must be host or device: {phase_b}")
        self.device = resolve_device(device)
        self.phase_b = phase_b
        # both accumulate over calls; a caller clears them to read one run
        self.declines: collections.Counter = collections.Counter()
        self.timings: dict[str, float] = {}
        self._streams = None

    # -- timing: CUDA events on the card, the host clock on the CPU ------

    def _mark(self):
        if self.device.type == "cuda":
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            return ev
        return time.perf_counter()

    def _add(self, name, a, b, host=False):
        ms = (b - a) * 1e3 if host or self.device.type != "cuda" \
            else a.elapsed_time(b)
        self.timings[name] = self.timings.get(name, 0.0) + ms

    def _on(self, k):
        """The stream of launch slot k (two, alternating), as a context."""
        if self.device.type != "cuda":
            return contextlib.nullcontext()
        if self._streams is None:
            self._streams = [torch.cuda.Stream(self.device)
                             for _ in range(2)]
        return torch.cuda.stream(self._streams[k % 2])

    # -- public ----------------------------------------------------------

    def decode_folders(self, folders, n_threads=None):
        """folders: [(frames without 'CK', sizes)] as native.mszip_folders
        takes them. Returns the bytes of each folder, or None when a
        flagged folder fails its native re-decode as well (the caller's
        scalar path then raises the reference's error)."""
        from libmspack_tpu import native

        t0 = time.perf_counter()
        offsets = np.zeros(len(folders) + 1, np.int64)
        np.cumsum([sum(s) for _, s in folders], out=offsets[1:])
        out = np.empty(int(offsets[-1]), np.uint8)
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
        self._add("total_ms", t0, time.perf_counter(), host=True)
        for fi in sorted(failed):
            blob = native.mszip_folder(*folders[fi], n_threads)
            if blob is None:
                return None
            out[offsets[fi]:offsets[fi + 1]] = np.frombuffer(blob, np.uint8)
        return [out[offsets[i]:offsets[i + 1]].tobytes()
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
            cnt = h["cnt"].cpu().numpy()
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
        from libmspack_tpu import native

        tmax = max(1, int(max(cnt[2, l0:l0 + nf].max()
                              for _, l0, nf in runs)))
        e0 = self._mark()
        tok = h["tok"][:, :tmax].contiguous().cpu().numpy()
        litw = h["litw"][:, :tmax].contiguous().cpu().numpy()
        e1 = self._mark()
        self._add("trace_pull_ms", e0, e1)
        t0 = time.perf_counter()
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
                                  [nf for _, _, nf in runs], fsizes, target,
                                  [int(x) for x in rel], n_threads)
        if r != 0:
            self.declines["host resolve error"] += 1
            failed.update(fi for fi, _, _ in runs)
        elif target.base is not out:
            for i, (s, e) in enumerate(zip(starts, ends)):
                out[s:e] = target[rel[i]:rel[i + 1]]
        self._add("host_resolve_ms", t0, time.perf_counter(), host=True)

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
        obh = ob.cpu().numpy()
        counts = counts.cpu().numpy()
        e2 = self._mark()
        self._add("k2_ms", e0, e1)
        self._add("bytes_pull_ms", e1, e2)
        pos = 0
        for fi, l0, nf in runs:
            size = int(offsets[fi + 1] - offsets[fi])
            if not np.array_equal(counts[l0:l0 + nf], lens[l0:l0 + nf]):
                self.declines["device resolve count mismatch"] += 1
                failed.add(fi)
            else:
                out[offsets[fi]:offsets[fi + 1]] = obh[pos:pos + size]
            pos += size
