"""Seconds from the start of the run to the start of the window, less the
making of the inputs (the benchmark's work, timed apart): torch and the
card, the kernels' load (their build on a checkout's first run) and the
warm-up items."""


def read(run):
    return run.setup_s
