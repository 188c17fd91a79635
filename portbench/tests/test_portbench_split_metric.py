"""``engine.k3_split_pct``: read from the LZX engines' ``k3_split_bytes``
over the window's LZX plaintext, on the CPU (the kernels' plain versions);
absent where the program keeps no such counter."""
import types

import pytest

from portbench import run as harness


def _reader():
    return harness.metric_reader(harness.ROOT, "engine.k3_split_pct")


@pytest.mark.parametrize("cell, want", [("cab_corpus.per_archive", 100.0),
                                        ("cab_corpus.large_folders", 100.0),
                                        ("oab_full.blocks64k", 0.0)])
def test_split_share_in_a_traced_line(tiny_root, run_cell, cell, want):
    # long enough for per_archive's window to reach an LZX cabinet, and
    # for OAB's to end past the sampled items: run.py keeps the window's
    # last item as views of the reused sink, which a sampled item written
    # after it overwrites
    rc, res, _ = run_cell(tiny_root, cell, trace=1, engine="cuda",
                          seconds=1.0)
    assert rc == 0 and res["correct"]
    assert res["metrics"]["engine.k3_split_pct"]["value"] == \
        pytest.approx(want)


def test_no_counter_no_share():
    item = {"ok": True, "counters": {"total_ms": 1.0},
            "kernel_bytes": {"lzx": (10, 20)}}
    r = types.SimpleNamespace(items=[item])
    r.has = lambda k: harness.Run.has(r, k)
    r.total = lambda k: harness.Run.total(r, k)
    r.kernel_bytes = lambda c: harness.Run.kernel_bytes(r, c)
    assert _reader()(r) is None
    item["counters"]["k3_split_bytes"] = 5
    assert _reader()(r) == pytest.approx(25.0)
