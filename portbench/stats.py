"""The benchmark's arithmetic: percentiles, spreads, interval unions and
roofline shares. Plain Python, so the CPU tests hold it."""
from __future__ import annotations

import statistics

HBM_BYTES_PER_S = 3.35e12     # one H100 SXM's HBM3, NVIDIA's data sheet


def p95(values) -> float:
    """The 95th percentile, interpolated between order statistics (the
    ``inclusive`` method: numpy's default)."""
    values = list(values)
    if len(values) == 1:
        return float(values[0])
    return statistics.quantiles(values, n=20, method="inclusive")[18]


def spread(values) -> float:
    """The distance between the first and third quartile as a share of the
    median, quartiles as ``statistics.quantiles(values, n=4)`` gives them."""
    q = statistics.quantiles(values, n=4)
    return (q[2] - q[0]) / statistics.median(values)


def union(intervals) -> list:
    """The union of ``(start, end)`` intervals as sorted disjoint ones."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [tuple(i) for i in out]


def clip(intervals, lo, hi) -> list:
    return [(max(a, lo), min(b, hi)) for a, b in intervals
            if b > lo and a < hi]


def covered(intervals) -> float:
    """The length that a set of intervals covers, overlaps counted once."""
    return sum(b - a for a, b in union(intervals))


def gaps(intervals, lo, hi) -> list:
    """The stretches of [lo, hi] that no interval covers."""
    out, at = [], lo
    for a, b in union(clip(intervals, lo, hi)):
        if a > at:
            out.append((at, a))
        at = max(at, b)
    if hi > at:
        out.append((at, hi))
    return out


def roofline_pct(read_bytes: int, written_bytes: int,
                 kernel_seconds: float):
    """The least time the kernel's bytes take at the HBM peak, as a share
    (%) of its measured time; None where the kernel did not run."""
    if kernel_seconds <= 0 or read_bytes + written_bytes <= 0:
        return None
    return 100.0 * (read_bytes + written_bytes) / HBM_BYTES_PER_S \
        / kernel_seconds
