"""K3's share of its roofline: the least time its bytes take at the HBM
peak (the compressed payload read once and the plaintext written once, of
the codec's folders that the window completed, counted from the archives),
over K3's summed device time in the profiler's trace."""
from portbench import stats, trace

SYMBOL, CODEC = trace.KERNELS["k3"]


def read(run):
    if run.trace is None:
        return None
    r, w = run.kernel_bytes(CODEC)
    return stats.roofline_pct(r, w, run.trace.kernel_seconds(SYMBOL))
