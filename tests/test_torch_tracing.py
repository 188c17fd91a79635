"""The port's spans and timings (``libmspack_tpu_torch/tracing.py``) and
the benchmark's readers of them (``portbench/spans.py``).

Under ``torch.profiler`` the planner, the CAB and OAB drivers (a full
download and a v3.2 patch, whose base read nests in its read-ahead) and the
engines leave ``mspack.*`` spans in the trace, nested in their caller's;
with no profiler they enter no ``record_function`` and, on the card, make
no CUDA event. The timing keys that readers use keep their names either
way."""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import libmspack_tpu_torch as lt
from libmspack_tpu_torch import tracing
from libmspack_tpu_torch.compress import cab_c, oab_c
from libmspack_tpu_torch.formats.cab import CabDecompressor
from libmspack_tpu_torch.parallel import planner
from libmspack_tpu_torch.parallel.cuda_pipeline import CudaLzxEngine
from libmspack_tpu_torch.system import BytesSink
from portbench import spans, trace
from portbench.formats import oab_patch
from portbench.tests.conftest import make_tiny_root

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CALLER = trace.WINDOW_SPAN


def _text(seed, n):
    rng = np.random.RandomState(seed)
    words = [b"cabinet ", b"folder ", b"span ", b"trace ", b"lane "]
    return b"".join(words[i] for i in rng.randint(len(words), size=n))[:n]


def _cab():
    return cab_c.write_cab(folders=[
        cab_c.FolderSpec([("m1.txt", _text(1, 40_000)),
                          ("m2.txt", _text(2, 9_000))], "mszip"),
        cab_c.FolderSpec([("l1.txt", _text(3, 30_000))], "lzx", 16)])


def _oab():
    return oab_c.write_oab(_text(4, 3 * 8192 + 100), block_size=8192)


def _oab_patch():
    """A three-block v3.2 patch, each block's reference data the base block
    at its offset, as the benchmark's writer makes them; with its base."""
    base = _text(6, 3 * 8192)
    target = bytes(b ^ 1 if i % 4096 == 7 else b for i, b in enumerate(base))
    blocks = [oab_patch.patch_block(target[i:i + 8192], base[i:i + 8192])
              for i in range(0, len(base), 8192)]
    return oab_patch.write_patch(blocks, 8192, base, target), base, target


def _planner(blob):
    plan = planner.plan_archives([blob, blob])
    folders = planner.execute(plan, engine="cuda", device="cpu",
                              strict=True)
    files = planner.archive_files(plan, folders)
    assert files[0]["l1.txt"] == _text(3, 30_000)
    return plan


def _cab_extract(blob):
    d = lt.create_cab_decompressor(engine="cuda", device="cpu", strict=True)
    cab = d.open(blob)
    got = {}
    for f in cab.files:
        sink = BytesSink()
        d.extract(f, sink)
        got[f.filename] = sink.getvalue()
    assert got["m1.txt"] == _text(1, 40_000)
    return d


def _oab_decompress(blob):
    d = lt.create_oab_decompressor(engine="cuda", device="cpu", strict=True)
    sink = BytesSink()
    d.decompress(blob, sink)
    assert sink.getvalue() == _text(4, 3 * 8192 + 100)
    return d


def _oab_patch_decompress(blob):
    patch, base, target = blob
    d = lt.create_oab_decompressor(engine="cuda", device="cpu", strict=True)
    sink = BytesSink()
    d.decompress_incremental(patch, base, sink)
    assert sink.getvalue() == target
    return d


CALLS = {
    "planner": (_planner, _cab, {
        "mspack.planner.plan": ["mspack.planner.parse",
                                "mspack.planner.collect", "mspack.cab.open",
                                "mspack.cab.parse"],
        "mspack.planner.execute": ["mspack.planner.join",
                                   "mspack.engine.decode"],
        "mspack.planner.files": []}),
    "cab": (_cab_extract, _cab, {
        "mspack.cab.open": ["mspack.cab.parse"],
        "mspack.cab.extract": ["mspack.cab.collect", "mspack.cab.write",
                               "mspack.engine.decode"]}),
    "oab": (_oab_decompress, _oab, {
        "mspack.oab.decompress": ["mspack.oab.read", "mspack.oab.write",
                                  "mspack.engine.decode"]}),
    "oab_patch": (_oab_patch_decompress, _oab_patch, {
        "mspack.oab.decompress_incremental": [
            "mspack.oab.read", "mspack.oab.base", "mspack.oab.write",
            "mspack.engine.decode"],
        "mspack.oab.read": ["mspack.oab.base"]}),
}
ENGINE_STEPS = ["mspack.engine.pack", "mspack.engine.wait",
                "mspack.engine.pull", "mspack.engine.resolve",
                "mspack.engine.copy_out"]


def _traced(fn, blob, tmp_path):
    """``fn(blob)`` under a profiler, inside the caller's span; returns
    its result and the chrome trace's spans."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with torch.profiler.record_function(CALLER):
            got = fn(blob)
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as fh:
        return got, trace.Trace.from_chrome(json.load(fh)["traceEvents"])


def _inside(inner, outer):
    return outer[1] <= inner[1] and inner[2] <= outer[2]


@pytest.mark.parametrize("call", sorted(CALLS))
def test_spans_nest_inside_the_callers_span(call, tmp_path):
    fn, make, tops = CALLS[call]
    _, t = _traced(fn, make(), tmp_path)
    mine = [s for s in t.spans if s[0].startswith("mspack.")]
    assert mine and all(t.window[0] <= a <= b <= t.window[1]
                        for _, a, b in mine)
    for top, inner in tops.items():
        outers = [s for s in mine if s[0] == top]
        assert outers, top
        for name in inner:
            found = [s for s in mine if s[0] == name]
            assert found, name
            assert all(any(_inside(s, o) for o in outers) for s in found), \
                (name, top)
    decodes = [s for s in mine if s[0] == "mspack.engine.decode"]
    for name in ENGINE_STEPS:
        found = [s for s in mine if s[0] == name]
        assert found, name
        assert all(any(_inside(s, d) for d in decodes) for s in found)


def test_no_record_function_without_a_profiler(monkeypatch):
    calls = []
    real = torch.profiler.record_function

    def counting(name, *args):
        calls.append(name)
        return real(name, *args)

    monkeypatch.setattr(torch.profiler, "record_function", counting)
    assert tracing.span("mspack.x") is tracing.span("mspack.y")
    for fn, make, _ in CALLS.values():
        fn(make())
    assert calls == []
    timings = {}
    with tracing.span("mspack.x", timings, "x_ms"):
        pass
    assert calls == [] and timings["x_ms"] >= 0


@pytest.mark.parametrize("traced", [False, True])
def test_timing_keys_keep_their_names(traced, tmp_path):
    def run(_):
        plan = _planner(_cab())
        return plan, _cab_extract(_cab()), _oab_decompress(_oab())

    if traced:
        (plan, cab, oab), _ = _traced(run, None, tmp_path)
    else:
        plan, cab, oab = run(None)
    assert {"parse_ms", "collect_ms", "mszip_cuda_ms", "lzx_cuda_ms",
            "native_ms", "scalar_ms"} <= set(plan.timings)
    assert {"upload_ms", "k1_ms", "trace_pull_ms", "host_resolve_ms",
            "total_ms"} <= set(plan.engines["mszip"].timings)
    for eng in (plan.engines["lzx"], cab.cuda_lzx_engine,
                oab.cuda_engine):
        assert {"upload_ms", "k3_ms", "trace_pull_ms", "host_resolve_ms",
                "total_ms"} <= set(eng.timings)
    assert {"upload_ms", "k1_ms", "total_ms"} <= set(cab.cuda_engine.timings)
    assert oab.timings["crc_ms"] > 0
    assert oab.stats["device blocks"] == 4


def _synthetic():
    """A window of 10 s: planner spans with engine spans inside, and
    device activity with gaps under them and under no program span."""
    def x(name, a, b, cat="user_annotation"):
        return {"ph": "X", "cat": cat, "name": name, "ts": a * 1e6,
                "dur": (b - a) * 1e6}
    return trace.Trace.from_chrome([
        x(CALLER, 0, 10),
        x("planner.plan", 0, 3),               # the benchmark's own
        x("mspack.planner.plan", 0.25, 2.75),
        x("mspack.planner.parse", 0.5, 1.5),
        x("mspack.cab.open", 0.5, 1.0),
        x("mspack.planner.execute", 3, 8),
        x("mspack.engine.decode", 3.5, 7.5),
        x("mspack.engine.pack", 3.5, 4),
        x("mspack.engine.wait", 4, 5),
        x("mspack.engine.resolve", 5, 6),
        x("mspack.engine.copy_out", 6, 6.5),
        # an engine span that overlaps the planner's end
        x("mspack.engine.pull", 7.75, 8.25),
        x("k3_lzx_kernel(int)", 4, 5, "kernel"),
        x("Memcpy DtoH", 8.5, 9, "gpu_memcpy"),
    ])


def test_self_time_and_idle_attribution():
    t = _synthetic()
    # planner: 0.25-2.75 and 3-8 less the engine spans inside them
    # (3.5-7.5, 7.75-8): 7.5 - 4.25
    assert spans.self_s(t, "mspack.planner.") == pytest.approx(3.25)
    assert spans.covered_s(t, spans.WAIT) == pytest.approx(1.0)
    # engines: 3.5-7.5 and 7.75-8.25 less wait, resolve and pull
    assert spans.self_s(t, spans.ENGINE, lower=spans.ENGINE_OWN_METRICS) \
        == pytest.approx(2.0)
    assert spans.self_s(t, "mspack.oab.") is None
    assert spans.innermost([("a", 0, 4), ("b", 1, 2), ("c", 3, 5),
                            ("d", 3, 3.5)]) == [
        (0, 1, "a"), (1, 2, "b"), (2, 3, "a"), (3, 3.5, "d"), (3.5, 5, "c")]
    idle = spans.idle_by_span(t)
    # idle: 0-4, 5-8.5, 9-10 (8.5 s); under no program span: 0-0.25,
    # 2.75-3, 8.25-8.5 and 9-10
    assert sum(idle.values()) == pytest.approx(8.5)
    assert idle[None] == pytest.approx(1.75)
    assert idle["mspack.cab.open"] == pytest.approx(0.5)
    assert idle["mspack.planner.parse"] == pytest.approx(0.5)
    assert idle["mspack.planner.plan"] == pytest.approx(1.5)
    assert idle["mspack.planner.execute"] == pytest.approx(0.75)
    assert idle["mspack.engine.pack"] == pytest.approx(0.5)
    assert idle["mspack.engine.resolve"] == pytest.approx(1.0)
    assert idle["mspack.engine.pull"] == pytest.approx(0.5)
    assert "mspack.engine.wait" not in idle
    # the longest gap is named by the innermost span open at its middle
    assert t.idle_gaps(top=1) == [["mspack.planner.plan", 4.0]]
    # a trace of a program with no span of its own reads nothing
    bare = trace.Trace(t.device, [s for s in t.spans
                                  if not s[0].startswith("mspack.")],
                       t.window)
    assert spans.idle_by_span(bare) is None
    assert spans.self_s(bare, "mspack.planner.") is None
    assert spans.covered_s(bare, spans.WAIT) is None


def _new_metrics(cell):
    with open(os.path.join(REPO, "BENCHMARK.json")) as fh:
        bench = json.load(fh)
    new = {"planner.self_ms_per_mb", "driver.cab_self_ms_per_archive",
           "driver.oab_self_ms_per_mb", "engine.wait_ms_per_mb",
           "engine.self_ms_per_mb", "device.idle_unattributed_pct"}
    return {m["name"] for m in bench["per_layer"]
            if m["name"] in new and cell in m["workloads"]}


# one run of the harness on the CPU, in a process of its own: the harness
# refuses to report from a process that has loaded JAX, as this one has
RUN_ON_CPU = """
import sys
from portbench import run
sys.exit(run.main(sys.argv[2:], root=sys.argv[1], device="cpu",
                  engine="cuda"))
"""


@pytest.mark.parametrize("cell", ["cab_corpus.batch64", "oab_full.blocks64k",
                                  "cab_corpus.per_archive",
                                  "cab_corpus.large_folders"])
def test_traced_cpu_run_reports_the_cells_new_metrics(cell, tmp_path):
    root = make_tiny_root(tmp_path)
    r = subprocess.run(
        [sys.executable, "-c", RUN_ON_CPU, root, "--workload", cell,
         "--seed", "4294967311", "--seconds", "0.2", "--trace", "1"],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    res = json.loads(r.stdout.strip().splitlines()[-1])
    assert res["correct"]
    want = _new_metrics(cell)
    assert len(want) == 4
    # the CPU has no device trace: the device's share is left out
    assert want - {"device.idle_unattributed_pct"} <= set(res["metrics"])
    assert "device.idle_unattributed_pct" not in res["metrics"]
    assert all(res["metrics"][k]["value"] > 0 for k in want
               if k in res["metrics"])
    assert all(g[0].startswith("mspack.")
               for g in res["breakdown"]["idle_gaps"])


def _lzx_stream():
    blob = cab_c.write_cab(files=[("l.txt", _text(5, 60_000))],
                           compression="lzx", window_bits=16)
    d = CabDecompressor(engine="scalar")
    blocks, sizes = d.collect_raw_blocks(d.open(blob).folders[0])
    return b"".join(blocks), sum(sizes)


def test_engine_makes_no_cuda_event_without_a_profiler(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card here: the engine's CUDA events are the "
                    "card's")
    made = []
    real = torch.cuda.Event

    def counting(*args, **kw):
        made.append(1)
        return real(*args, **kw)

    monkeypatch.setattr(torch.cuda, "Event", counting)
    stream, size = _lzx_stream()
    want = _text(5, 60_000)
    eng = CudaLzxEngine(device="cuda")
    assert eng.decode_streams([stream], [size], 16) == [want]
    assert made == []
    assert {"total_ms", "host_resolve_ms"} <= set(eng.timings)
    assert not {"upload_ms", "k3_ms", "trace_pull_ms"} & set(eng.timings)
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        assert eng.decode_streams([stream], [size], 16) == [want]
    assert made
    assert {"upload_ms", "k3_ms", "trace_pull_ms"} <= set(eng.timings)
    assert all(eng.timings[k] > 0 for k in ("upload_ms", "k3_ms",
                                            "trace_pull_ms"))
