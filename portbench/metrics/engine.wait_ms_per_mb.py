"""The time under the engines' ``mspack.engine.wait`` spans, where the
host blocks on the counts of a K1, K3 or K4 launch, per MB delivered."""
from portbench import spans


def read(run):
    return spans.per_mb(run, spans.covered_s(run.trace, spans.WAIT))
