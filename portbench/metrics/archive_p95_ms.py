"""The 95th percentile of the wall time of every archive completed in the
window, where each item is one archive."""
from portbench import stats


def read(run):
    walls = [r["wall_s"] * 1e3 for r in run.items if r["ok"]]
    if not walls:
        return None
    return stats.p95(walls)
