"""One OAB incremental patch through the OAB driver: a new
``create_oab_decompressor(strict=True)`` and ``decompress_incremental``
of the item's patch against its base, into the caller's reused sink, as
``oab_full``'s entry writes a full download.

Its counters are the engines' ``timings`` and the driver's ``base_ms``
and ``base_bytes`` (the reads of reference data from the base), where the
program keeps them, and ``driver_host_ms``.
"""
from __future__ import annotations

import time

from . import engine_timings
from .oab_full import ReusedSink

DRIVER_KEYS = ("base_ms", "base_bytes")


def make(ctx):
    import libmspack_tpu_torch as port
    sinks: list = []

    def run(item):
        t0 = time.perf_counter()
        out, engines, driver = [], [], {}
        for k, (patch, base) in enumerate(zip(item.inputs, item.bases)):
            if k == len(sinks):
                sinks.append(ReusedSink())
            sink = sinks[k]
            # the header's target size (MS-OXOAB: version 3.2, ulBlockMax,
            # ulSourceSize, ulTargetSize)
            sink.reset(int.from_bytes(patch[16:20], "little"))
            d = port.create_oab_decompressor(engine=ctx.engine,
                                             device=ctx.device, strict=True)
            with ctx.span("oab.decompress_incremental"):
                d.decompress_incremental(patch, base, sink)
            out.append({"oab": sink.view()})
            engines.append(d.cuda_engine)
            for key in DRIVER_KEYS:
                if key in d.timings:
                    driver[key] = driver.get(key, 0.0) + d.timings[key]
        ctx.sync()
        counters = engine_timings(engines)
        counters["driver_host_ms"] = (time.perf_counter() - t0) * 1e3 \
            - counters.get("total_ms", 0.0)
        counters.update(driver)
        return out, counters

    return run
