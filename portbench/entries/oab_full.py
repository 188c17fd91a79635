"""One OAB full download through the OAB driver: a new
``create_oab_decompressor(strict=True)`` and ``decompress`` into an
in-memory sink.

The sink is the caller's, as a client's output file is: one buffer for
each archive position, grown once to the download's size and written
again by every later item, so the window does not page in a fresh
64 MiB buffer, and copy it once more, for every item (as
``decompress_bytes`` does). An item's files are views of that buffer,
valid until the next item; the harness copies those it keeps.
"""
from __future__ import annotations

import time

from . import engine_timings


class ReusedSink:
    """Writes into one buffer, sized by ``reset``, that later items
    overwrite."""

    def __init__(self):
        self.buf = bytearray()
        self.at = 0

    def reset(self, size: int) -> None:
        if size > len(self.buf):
            self.buf = bytearray(size)
        self.at = 0

    def write(self, data) -> int:
        """Past the header's target size the slice falls short and the
        assignment raises: the item fails."""
        src = memoryview(data).cast("B")
        memoryview(self.buf)[self.at:self.at + len(src)] = src
        self.at += len(src)
        return len(src)

    def view(self) -> memoryview:
        return memoryview(self.buf)[:self.at]


def make(ctx):
    import libmspack_tpu_torch as port
    sinks: list = []

    def run(item):
        t0 = time.perf_counter()
        out, engines = [], []
        for k, archive in enumerate(item.inputs):
            if k == len(sinks):
                sinks.append(ReusedSink())
            sink = sinks[k]
            # the header's target size (MS-OXOAB: version 3.1, ulBlockMax,
            # ulTargetSize)
            sink.reset(int.from_bytes(archive[12:16], "little"))
            d = port.create_oab_decompressor(engine=ctx.engine,
                                             device=ctx.device, strict=True)
            with ctx.span("oab.decompress"):
                d.decompress(archive, sink)
            out.append({"oab": sink.view()})
            engines.append(d.cuda_engine)
        ctx.sync()
        counters = engine_timings(engines)
        counters["driver_host_ms"] = (time.perf_counter() - t0) * 1e3 \
            - counters.get("total_ms", 0.0)
        return out, counters

    return run
