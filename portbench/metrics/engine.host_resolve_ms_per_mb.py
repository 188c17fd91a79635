"""Host phase B (``timings["host_resolve_ms"]``, summed over every CUDA
engine), per MB delivered."""


def read(run):
    if not run.has("host_resolve_ms") or not run.delivered_bytes:
        return None
    return run.total("host_resolve_ms") / (run.delivered_bytes / 1e6)
