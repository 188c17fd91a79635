"""The engines' self time: the time under their ``mspack.engine.*`` spans
less that under ``.wait``, ``.pull`` and ``.resolve``, which metrics of
their own cover: packing and uploading, the copies out, the glue; per MB
delivered."""
from portbench import spans


def read(run):
    return spans.per_mb(run, spans.self_s(run.trace, spans.ENGINE,
                                          lower=spans.ENGINE_OWN_METRICS))
