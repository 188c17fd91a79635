"""``planner.extract_corpus`` as its three steps over the item's
cabinets: ``plan_archives``, ``execute(strict=True)``, ``archive_files``."""
from __future__ import annotations

from . import engine_timings


def make(ctx):
    from libmspack_tpu_torch.parallel import planner

    def run(item):
        with ctx.span("planner.plan"):
            plan = planner.plan_archives(list(item.inputs))
        with ctx.span("planner.execute"):
            folders = planner.execute(plan, engine=ctx.engine,
                                      device=ctx.device, strict=True)
        with ctx.span("planner.files"):
            files = planner.archive_files(plan, folders)
        ctx.sync()
        counters = engine_timings(plan.engines.values())
        counters["parse_ms"] = plan.timings.get("parse_ms", 0.0)
        counters["collect_ms"] = plan.timings.get("collect_ms", 0.0)
        return files, counters

    return run
