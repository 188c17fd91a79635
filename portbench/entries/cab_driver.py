"""One cabinet through the CAB driver, as an installer or scanner unpacks
it: a new ``create_cab_decompressor(strict=True)``, ``open`` of the bytes,
``extract`` of every file into an in-memory sink."""
from __future__ import annotations

import time

from . import engine_timings


def make(ctx):
    import libmspack_tpu_torch as port
    from libmspack_tpu_torch.system import BytesSink

    def run(item):
        t0 = time.perf_counter()
        files_out = []
        engines = []
        for archive in item.inputs:
            d = port.create_cab_decompressor(engine=ctx.engine,
                                             device=ctx.device, strict=True)
            with ctx.span("cab.open"):
                cab = d.open(archive)
            files = {}
            with ctx.span("cab.extract"):
                for f in cab.files:
                    sink = BytesSink()
                    d.extract(f, sink)
                    files[f.filename] = sink.getvalue()
            files_out.append(files)
            engines += [d.cuda_engine, d.cuda_lzx_engine, d.cuda_qtm_engine]
        ctx.sync()
        counters = engine_timings(engines)
        counters["driver_host_ms"] = (time.perf_counter() - t0) * 1e3 \
            - counters.get("total_ms", 0.0)
        return files_out, counters

    return run
