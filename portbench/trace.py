"""The traced run: ``torch.profiler`` over the window, reduced to device
intervals by name and to the benchmark's own host spans.

The benchmark wraps each call into a layer of the program in a
``record_function`` span (``Tracer.span``); the window itself is the span
``portbench.window``. The device's activity is every kernel, copy and fill
that CUPTI reports. Nothing here reads a timing the program makes.
"""
from __future__ import annotations

import contextlib
import json
import os
import re
import tempfile

from . import stats

WINDOW_SPAN = "portbench.window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
SPAN_CATS = ("user_annotation",)

# the program's kernels by the name the profiler gives them: the symbol up
# to its argument list, and the codec whose bytes it decodes
KERNELS = {
    "k1": ("k1_inflate_kernel", "mszip"),
    "k3": ("k3_lzx_kernel", "lzx"),
    "k4": ("k4_qtm_kernel", "quantum"),
}


def short_name(name: str) -> str:
    """A kernel's name without its argument list or template arguments'
    spelling: ``k3_lzx_kernel(unsigned char const*, ...)`` ->
    ``k3_lzx_kernel``."""
    base = re.split(r"[(<]", name, maxsplit=1)[0].strip()
    base = base.removeprefix("void ").rsplit("::", 1)[-1]
    return base or name


class Trace:
    """What a traced window left: device activity and host spans, in
    seconds on the trace's clock."""

    def __init__(self, device, spans, window):
        self.device = device            # [(name, start, end)]
        self.spans = spans              # [(name, start, end)]
        self.window = window            # (start, end)

    @classmethod
    def from_chrome(cls, events) -> "Trace":
        device, spans, window = [], [], None
        for e in events:
            if e.get("ph") != "X":
                continue
            a = float(e["ts"]) * 1e-6
            b = a + float(e.get("dur", 0)) * 1e-6
            cat = e.get("cat", "")
            if cat in DEVICE_CATS:
                device.append((e.get("name", ""), a, b))
            elif cat in SPAN_CATS:
                if e.get("name") == WINDOW_SPAN:
                    window = (a, b)
                else:
                    spans.append((e.get("name", ""), a, b))
        return cls(device, spans, window)

    @property
    def window_s(self) -> float:
        return self.window[1] - self.window[0] if self.window else 0.0

    def _in_window(self, rows):
        lo, hi = self.window
        return [(n, max(a, lo), min(b, hi)) for n, a, b in rows
                if b > lo and a < hi]

    @property
    def busy_s(self) -> float:
        """Seconds of the window in which something ran on the device."""
        return stats.covered([(a, b) for _, a, b in
                              self._in_window(self.device)])

    def kernel_seconds(self, symbol: str) -> float:
        """Summed device time of the kernels named ``symbol``."""
        return sum(b - a for n, a, b in self._in_window(self.device)
                   if short_name(n) == symbol)

    def device_ops(self, top=10) -> list:
        """The device operations that took most time: [[name, seconds]]."""
        tot: dict = {}
        for n, a, b in self._in_window(self.device):
            k = short_name(n)
            tot[k] = tot.get(k, 0.0) + (b - a)
        return [[k, v] for k, v in sorted(tot.items(), key=lambda kv: -kv[1])
                ][:top]

    def idle_gaps(self, top=10) -> list:
        """The longest stretches with nothing on the device, each named by
        the innermost benchmark span open at its middle (``harness`` where
        none is): [[name, seconds]]."""
        lo, hi = self.window
        gaps = sorted(stats.gaps([(x, y) for _, x, y in self.device],
                                 lo, hi), key=lambda g: g[0] - g[1])
        rows = []
        for a, b in gaps[:top]:
            mid = (a + b) / 2
            inner = [s for s in self.spans if s[1] <= mid <= s[2]]
            name = min(inner, key=lambda s: s[2] - s[1])[0] if inner \
                else "harness"
            rows.append([name, b - a])
        return rows


class Tracer:
    """Spans around the calls into the program's layers; a profiler over
    the window when tracing is on, and no cost when it is off."""

    def __init__(self, on: bool):
        self.on = on
        self._prof = None

    def span(self, name):
        if not self.on:
            return contextlib.nullcontext()
        import torch
        return torch.profiler.record_function(name)

    @contextlib.contextmanager
    def window(self):
        if not self.on:
            yield
            return
        import torch
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        with profile(activities=acts) as prof:
            with torch.profiler.record_function(WINDOW_SPAN):
                yield
            if torch.cuda.is_available():
                torch.cuda.synchronize()
        self._prof = prof

    def read(self) -> Trace | None:
        """The window's trace (once the window has closed), or None."""
        if self._prof is None:
            return None
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self._prof.export_chrome_trace(path)
            with open(path) as fh:
                events = json.load(fh).get("traceEvents", [])
        finally:
            os.unlink(path)
        self._prof = None
        return Trace.from_chrome(events)
