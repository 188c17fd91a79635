"""The CAB driver's self time: the time under its ``mspack.cab.*`` spans
(``open`` with its parse, ``extract`` with the CFDATA collect and each
file's write into its sink) less the part under the engines' spans, per
archive completed."""
from portbench import spans


def read(run):
    return spans.per_archive(run, spans.self_s(run.trace, "mspack.cab."))
