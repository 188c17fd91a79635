"""The OAB driver's reads of a patch's reference data from its base:
``timings["base_ms"]`` (host clock: each batch's one read of the base and
its slicing into the blocks' reference data) per MB delivered. None where
the program keeps no such counter."""


def read(run):
    if not run.has("base_ms") or not run.delivered_bytes:
        return None
    return run.total("base_ms") / (run.delivered_bytes / 1e6)
