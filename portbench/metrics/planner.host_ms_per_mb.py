"""The planner's host time (``Plan.timings``: the parse and the CFDATA
collect), summed over the window, per MB delivered."""


def read(run):
    if not run.has("parse_ms") or not run.delivered_bytes:
        return None
    return (run.total("parse_ms") + run.total("collect_ms")) \
        / (run.delivered_bytes / 1e6)
