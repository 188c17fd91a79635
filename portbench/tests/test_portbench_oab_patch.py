"""The ``oab_patch.daily`` cell at a tiny size on the CPU: its control and
a byte altered where the OAB driver delivers read ``correct`` false; a
traced run through the program reads its two metrics, which follow the
program's counters and are absent without them."""
import json
import os
import types

import pytest

from portbench import run as harness

from .conftest import TINY

CELL = "oab_patch.daily"


@pytest.fixture
def patch_root(tiny_root):
    """The tiny root with the patch cut to four blocks of 64 KiB."""
    path = os.path.join(tiny_root, "portbench", "configs", "oab_patch.json")
    with open(path) as fh:
        config = json.load(fh)
    config["target_bytes"] = 4 * TINY
    with open(path, "w") as fh:
        json.dump(config, fh)
    return tiny_root


def test_control_is_not_correct(patch_root, run_cell):
    rc, res, _ = run_cell(patch_root, CELL, extra=["--control"])
    assert rc == 0 and res["correct"] is False
    assert res["checks"]["bytes_wrong"]["value"] > 0


def test_a_byte_altered_in_the_driver_is_not_correct(patch_root, run_cell,
                                                     monkeypatch):
    from libmspack_tpu_torch.formats.oab import OabDecompressor
    real = OabDecompressor.decompress_incremental

    def faulty(self, patch, base, sink):
        real(self, patch, base, sink)
        sink.buf[sink.at // 2] ^= 0x40
    monkeypatch.setattr(OabDecompressor, "decompress_incremental", faulty)
    rc, res, _ = run_cell(patch_root, CELL)
    assert rc == 0 and res["correct"] is False
    assert res["checks"]["bytes_wrong"]["value"] > 0


def test_a_traced_run_reads_the_reference_metrics(patch_root, run_cell):
    rc, res, _ = run_cell(patch_root, CELL, trace=1, engine="cuda",
                          seconds=1.0)
    assert rc == 0 and res["correct"]
    m = res["metrics"]
    assert m["engine.ref_device_pct"]["value"] == pytest.approx(100.0)
    assert m["driver.oab_base_ms_per_mb"]["value"] > 0
    # metrics of other cells do not read this one
    assert "driver.oab_host_ms_per_mb" not in m and "k3_roofline" not in m


def _run_of(counters, plain_bytes=2_000_000):
    item = {"ok": True, "counters": counters, "plain_bytes": plain_bytes}
    r = types.SimpleNamespace(items=[item], delivered_bytes=plain_bytes)
    r.has = lambda k: harness.Run.has(r, k)
    r.total = lambda k: harness.Run.total(r, k)
    return r


@pytest.mark.parametrize("metric, counters, want", [
    ("driver.oab_base_ms_per_mb", {"base_ms": 3.0}, 1.5),
    ("engine.ref_device_pct", {"base_bytes": 400, "ref_bytes": 300}, 75.0),
    # no lane resolved with its reference data on the device
    ("engine.ref_device_pct", {"base_bytes": 400}, 0.0),
])
def test_readers_follow_the_counters(metric, counters, want):
    read = harness.metric_reader(harness.ROOT, metric)
    assert read(_run_of(counters)) == pytest.approx(want)


@pytest.mark.parametrize("metric", ["driver.oab_base_ms_per_mb",
                                    "engine.ref_device_pct"])
def test_readers_give_none_without_counters(metric):
    """As at a program that keeps no such counter."""
    read = harness.metric_reader(harness.ROOT, metric)
    assert read(_run_of({"total_ms": 1.0, "ref_bytes": 5})) is None


def test_same_seed_same_patch_and_one_day_of_edits(patch_root):
    from .test_portbench_gen import _pool
    a = _pool(patch_root, CELL, 2**31 + 5)
    b = _pool(patch_root, CELL, 2**31 + 5)
    c = _pool(patch_root, CELL, 2**31 + 6)
    assert [(i.inputs, i.bases) for i in a] == [(i.inputs, i.bases)
                                                 for i in b]
    assert a[0].inputs != c[0].inputs and a[0].bases != c[0].bases
    base, target = a[0].bases[0], a[0].expected[0]["oab"]
    changed = sum(x != y for x, y in zip(base, target)) / len(base)
    # 16 bytes in every 4 KiB, less the drawn bytes that equal the base's
    assert 0.0037 < changed <= 16 / 4096
