"""The share of the window's device-idle time in which no span of the
program (``mspack.*``) is open: idle time that no layer's span puts down
to the host work that causes it."""
from portbench import spans


def read(run):
    idle = spans.idle_by_span(run.trace)
    if idle is None:
        return None
    total = sum(idle.values())
    return 100.0 * idle[None] / total if total > 0 else 0.0
