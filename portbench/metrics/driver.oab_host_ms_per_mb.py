"""The OAB driver's host time: the wall of ``decompress_bytes`` less the
growth of the engine's ``timings["total_ms"]``, per MB delivered."""


def read(run):
    if not run.has("total_ms") or not run.delivered_bytes:
        return None
    return run.total("driver_host_ms") / (run.delivered_bytes / 1e6)
