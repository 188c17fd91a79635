"""Plaintext bytes that the window's completed items delivered (10^6 B),
over the window's wall seconds."""


def read(run):
    return run.delivered_bytes / 1e6 / run.window_s
