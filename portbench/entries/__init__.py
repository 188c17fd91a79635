"""The program's entry points that a cell's window drives, one module per
entry, found by the ``entry`` of a traffic mix. Each has
``make(ctx) -> run``, where ``run(item)`` returns the files it delivered
(``{name: bytes}`` per archive) and the program's counters for the item.
``ctx`` gives ``engine``, ``device``, ``span(name)`` (the benchmark's own
span around a call into a layer) and ``sync()``."""


def engine_timings(engines) -> dict:
    """The summed ``timings`` of the program's CUDA engines."""
    out: dict = {}
    for eng in engines:
        if eng is None:
            continue
        for k, v in eng.timings.items():
            out[k] = out.get(k, 0.0) + v
    return out
