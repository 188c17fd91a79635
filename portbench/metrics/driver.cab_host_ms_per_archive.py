"""The CAB driver's host time an archive: the wall of ``open`` and every
``extract``, less the growth of the CUDA engines' ``timings["total_ms"]``
over it; the mean over the window's archives."""


def read(run):
    if not run.has("total_ms"):
        return None
    n = sum(r["archives"] for r in run.items if r["ok"])
    return run.total("driver_host_ms") / n if n else None
