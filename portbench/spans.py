"""The program's own spans in a traced window: each layer's self time, and
the device's idle time put down to the span the host was in.

The port opens spans named ``mspack.<layer>.<step>`` while a profiler
records (``libmspack_tpu_torch/tracing.py``); they land in ``Trace.spans``
beside the benchmark's own, on the clock of the device's activity. A
layer's self time is the time its spans cover less the part of it that
spans of a lower layer cover. Every function returns None where the trace
holds no span it reads, as in a program that opens none.
"""
from __future__ import annotations

from portbench import stats

PROGRAM = "mspack."
ENGINE = "mspack.engine."
# the engine spans that metrics of their own cover
WAIT = "mspack.engine.wait"
ENGINE_OWN_METRICS = (WAIT, "mspack.engine.pull", "mspack.engine.resolve")


def _spans(trace, prefixes):
    """The window's spans whose names start with one of ``prefixes``, as
    ``(start, end)`` clipped to the window."""
    lo, hi = trace.window
    return stats.clip([(a, b) for n, a, b in trace.spans
                       if n.startswith(prefixes)], lo, hi)


def intersect(xs, ys) -> list:
    """The stretches that both sets of intervals cover, as sorted disjoint
    ``(start, end)``."""
    xs, ys = stats.union(xs), stats.union(ys)
    out, i, j = [], 0, 0
    while i < len(xs) and j < len(ys):
        a, b = max(xs[i][0], ys[j][0]), min(xs[i][1], ys[j][1])
        if b > a:
            out.append((a, b))
        if xs[i][1] < ys[j][1]:
            i += 1
        else:
            j += 1
    return out


def covered_s(trace, prefixes):
    """Seconds of the window under spans named ``prefixes``; None where
    there is none."""
    if trace is None or trace.window is None:
        return None
    iv = _spans(trace, prefixes)
    return stats.covered(iv) if iv else None


def self_s(trace, layer, lower=(ENGINE,)):
    """Seconds of the window under the ``layer`` spans and under no span
    named ``lower``; None where there is no ``layer`` span."""
    if trace is None or trace.window is None:
        return None
    mine = _spans(trace, layer)
    if not mine:
        return None
    return stats.covered(mine) - stats.covered(
        intersect(mine, _spans(trace, lower)))


def innermost(spans) -> list:
    """``(name, start, end)`` spans as sorted disjoint ``(start, end,
    name)`` pieces, each named by the innermost span open there: the one
    opened last (of two opened at once, the one that ends first). A span
    that outlasts the one it opened in names the time after that one's
    end too."""
    events = sorted([(a, 1, -b, i) for i, (_, a, b) in enumerate(spans)]
                    + [(b, 0, 0, i) for i, (_, _, b) in enumerate(spans)])
    out, stack, ended, at = [], [], set(), None
    for t, opens, _, i in events:
        if opens:
            if stack and t > at:
                out.append((at, t, spans[stack[-1]][0]))
            stack.append(i)
            at = t
            continue
        ended.add(i)
        if stack and stack[-1] == i:
            if t > at:
                out.append((at, t, spans[i][0]))
            at = t
            while stack and stack[-1] in ended:
                stack.pop()
    return out


def idle_by_span(trace):
    """Seconds of the window with nothing on the device, by the innermost
    program span open then (the key None: no program span open); None
    where the trace has no device activity or no program span."""
    if trace is None or trace.window is None or not trace.device:
        return None
    lo, hi = trace.window
    mine = [(n, max(a, lo), min(b, hi)) for n, a, b in trace.spans
            if n.startswith(PROGRAM) and b > lo and a < hi]
    if not mine:
        return None
    idle = stats.gaps([(a, b) for _, a, b in trace.device], lo, hi)
    out = {None: stats.covered(idle)}
    pieces = innermost(mine)
    i = 0
    for a, b in idle:
        while i < len(pieces) and pieces[i][1] <= a:
            i += 1
        j = i
        while j < len(pieces) and pieces[j][0] < b:
            s = min(b, pieces[j][1]) - max(a, pieces[j][0])
            name = pieces[j][2]
            out[name] = out.get(name, 0.0) + s
            out[None] -= s
            j += 1
    return out


def per_mb(run, seconds):
    """Milliseconds per MB (10^6 B) delivered in the window."""
    if seconds is None or not run.delivered_bytes:
        return None
    return seconds * 1e3 / (run.delivered_bytes / 1e6)


def per_archive(run, seconds):
    """Milliseconds per archive completed in the window."""
    n = sum(r["archives"] for r in run.items if r["ok"])
    if seconds is None or not n:
        return None
    return seconds * 1e3 / n
