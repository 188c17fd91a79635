"""The benchmark's arithmetic and its last line."""
import statistics

import pytest

from portbench import check, stats, trace


def test_p95_interpolates_and_keeps_its_count():
    values = list(range(1, 101))
    assert stats.p95(values) == pytest.approx(95.05)
    assert stats.p95([7.0]) == 7.0
    # the 95th percentile of 175 archives leaves 9 beyond it
    xs = list(range(175))
    assert sum(x > stats.p95(xs) for x in xs) == 9


def test_spread_is_the_quartiles_over_the_median():
    v = [10.0, 10.0, 11.0, 12.0, 12.0, 13.0]
    q = statistics.quantiles(v, n=4)
    assert stats.spread(v) == pytest.approx((q[2] - q[0]) / 11.5)


def test_union_gaps_and_idle_share():
    iv = [(0.0, 1.0), (0.5, 2.0), (3.0, 4.0), (3.5, 3.6)]
    assert stats.union(iv) == [(0.0, 2.0), (3.0, 4.0)]
    assert stats.covered(iv) == pytest.approx(3.0)
    assert stats.gaps(iv, -1.0, 5.0) == [(-1.0, 0.0), (2.0, 3.0),
                                         (4.0, 5.0)]
    events = [
        {"ph": "X", "cat": "user_annotation", "name": trace.WINDOW_SPAN,
         "ts": 0, "dur": 10_000_000},
        {"ph": "X", "cat": "user_annotation", "name": "planner.plan",
         "ts": 0, "dur": 3_000_000},
        {"ph": "X", "cat": "kernel", "ts": 3_000_000, "dur": 2_000_000,
         "name": "k3_lzx_kernel(unsigned char const*, long, int)"},
        {"ph": "X", "cat": "kernel", "ts": 4_000_000, "dur": 2_000_000,
         "name": "void k4_qtm_kernel(unsigned char const*)"},
        {"ph": "X", "cat": "gpu_memcpy", "ts": 8_000_000, "dur": 1_000_000,
         "name": "Memcpy DtoH (Device -> Pageable)"},
        {"ph": "X", "cat": "cpu_op", "ts": 0, "dur": 5, "name": "aten::add"},
    ]
    t = trace.Trace.from_chrome(events)
    assert t.window_s == pytest.approx(10.0)
    assert t.busy_s == pytest.approx(4.0)
    assert t.kernel_seconds("k3_lzx_kernel") == pytest.approx(2.0)
    assert t.kernel_seconds("k4_qtm_kernel") == pytest.approx(2.0)
    assert t.device_ops()[2] == ["Memcpy DtoH", pytest.approx(1.0)]
    assert t.idle_gaps() == [["planner.plan", pytest.approx(3.0)],
                             ["harness", pytest.approx(2.0)],
                             ["harness", pytest.approx(1.0)]]


def test_roofline_counts_bytes_once_against_the_hbm_peak():
    # 3.35 GB read and written take 1 ms at the peak: 0.01 % of 10 s
    assert stats.roofline_pct(2_000_000_000, 1_350_000_000, 10.0) == \
        pytest.approx(0.01)
    assert stats.roofline_pct(1, 1, 0.0) is None


def test_bytes_wrong_counts_differences_and_lengths():
    assert check.bytes_wrong(b"abcd", b"abcd") == 0
    assert check.bytes_wrong(b"abXd", b"abcd") == 1
    assert check.bytes_wrong(b"ab", b"abcd") == 2
    assert check.bytes_wrong(None, b"abcd") == 4
    assert check.compare([{"a": b"1", "z": b"9"}], [{"a": b"2"}]) == \
        (1, 2, 2)


def test_last_line_schema(tiny_root, run_cell):
    rc, res, err = run_cell(tiny_root, "cab_corpus.per_archive")
    assert rc == 0
    assert list(res) == ["correct", "attempted", "failed", "metrics",
                         "device", "checks"]
    assert res["correct"] is True and res["failed"] == 0
    assert set(res["metrics"]) == {"out_mbps", "setup_s"}
    assert all(set(m) == {"value", "unit"} for m in res["metrics"].values())
    assert set(res["device"]) == {"platform", "kind", "count",
                                  "memory_peak_bytes"}
    assert res["checks"] == {k: {"value": 0, "limit": 0}
                             for k in check.LIMITS}
    tail = err.strip().splitlines()[-3:]
    assert tail == [f"check {k} 0 limit 0" for k in check.LIMITS]


def test_traced_line_has_the_cells_layer_metrics(tiny_root, run_cell):
    rc, res, _ = run_cell(tiny_root, "cab_corpus.batch64", trace=1,
                          engine="cuda", seconds=0.1)
    assert rc == 0 and res["correct"]
    # on the CPU the plain versions run: no device trace, so the device
    # metrics are left out, and the counters are there
    assert {"planner.host_ms_per_mb", "engine.host_resolve_ms_per_mb",
            "engine.transfer_ms_per_mb"} <= set(res["metrics"])
    assert not any(k.endswith("_roofline") or k == "device.idle_pct"
                   for k in res["metrics"])
    assert res["device"]["window_s"] > 0
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
    assert list(res)[-1] == "checks"


def test_the_archive_p95_is_read_in_the_traced_line(tiny_root, run_cell):
    rc, res, _ = run_cell(tiny_root, "cab_corpus.per_archive", trace=1)
    assert rc == 0 and res["correct"]
    p95 = res["metrics"]["driver.cab_archive_p95_ms"]
    assert p95["unit"] == "ms" and p95["value"] > 0


@pytest.mark.cuda
def test_a_cell_on_the_card(card, tiny_root, run_cell):
    rc, res, _ = run_cell(tiny_root, "cab_corpus.batch64", trace=1,
                          engine="cuda", device=None, seconds=1)
    assert rc == 0 and res["correct"]
    assert res["device"]["platform"] == "gpu"
    assert 0 < res["device"]["busy_s"] <= res["device"]["window_s"]
    for k in ("k1_roofline", "k3_roofline"):
        assert 0 < res["metrics"][k]["value"] <= 100
