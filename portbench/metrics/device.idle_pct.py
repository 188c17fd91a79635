"""The share of the traced window in which no kernel, copy or fill runs on
the card: the union of the profiler's device intervals."""


def read(run):
    t = run.trace
    if t is None or not t.window_s or not t.busy_s:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
