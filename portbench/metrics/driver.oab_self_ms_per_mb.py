"""The OAB driver's self time: the time under its ``mspack.oab.*`` spans
(the read-ahead, the window groups, each batch's CRC checks and sink
writes) less the part under the engines' spans, per MB delivered."""
from portbench import spans


def read(run):
    return spans.per_mb(run, spans.self_s(run.trace, "mspack.oab."))
