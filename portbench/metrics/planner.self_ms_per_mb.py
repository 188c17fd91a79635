"""The planner's self time: the time under its ``mspack.planner.*`` spans
(the parse and collect of each archive, the blocks' joins, the file split,
the glue of ``execute``) less the part under the engines' spans, per MB
delivered."""
from portbench import spans


def read(run):
    return spans.per_mb(run, spans.self_s(run.trace, "mspack.planner."))
