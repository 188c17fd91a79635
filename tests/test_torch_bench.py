"""The port's measurement path (libmspack_tpu_torch.bench, the kernels'
bench entries, tools.bench_kernels/inflate_bench/devtime/mesh_scaling/
scaling_model/cut_bisect, native.cab_mszip_pipeline) against the JAX
package's on the CPU.

The bench inputs must equal the JAX package's byte for byte: the corpus
and cabinets of ``bench.py``, and the frames and streams each JAX
``bench_entry`` builds, caught at its first kernel call (no Pallas kernel
runs here). Each port entry runs its plain version at a small shape and
must be bit-exact on its sampled lanes. Tolerance 0 throughout.
"""
import hashlib
import importlib.util
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import bench as jax_bench
from libmspack_tpu import utils as jax_utils
from libmspack_tpu.ops import pallas_inflate, pallas_lzx, pallas_qtm
from libmspack_tpu.ops import pallas_resolve
from libmspack_tpu_torch import bench, kernels, native, utils
from libmspack_tpu_torch.ops import cuda_inflate as ci
from libmspack_tpu_torch.ops import cuda_lzx as cl
from libmspack_tpu_torch.ops import cuda_qtm as cq
from libmspack_tpu_torch.ops import cuda_resolve as cr
from libmspack_tpu_torch.tools import (cut_bisect, devtime, inflate_bench,
                                       mesh_scaling, scaling_model)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOOLS = os.path.join(ROOT, "tools")


def _load_tool(name):
    spec = importlib.util.spec_from_file_location(
        f"_jax_tool_{name}", os.path.join(TOOLS, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class _Caught(Exception):
    pass


def _catch(monkeypatch, module, name, fn):
    """Replace ``module.name`` with a function that records its arguments
    and stops the caller."""
    seen = {}

    def stop(*args, **kw):
        seen["args"], seen["kw"] = args, kw
        raise _Caught

    monkeypatch.setattr(module, name, stop)
    with pytest.raises(_Caught):
        fn()
    return seen["args"], seen["kw"]


# -- the bench's inputs ------------------------------------------------------

@pytest.mark.parametrize("comp", ["mszip", "lzx", "quantum"])
def test_bench_cabinet_equals_jax(comp):
    corpus = bench.build_corpus(300_000)
    assert corpus == jax_bench.build_corpus(300_000)
    assert bench.build_cab(corpus, comp) == jax_bench.build_cab(corpus, comp)


def test_bench_corpus_equals_jax():
    for n in (1, 5000, 1 << 20):
        assert utils.bench_corpus(n) == jax_utils.bench_corpus(n)


def test_k1_inputs_equal_jax_bench_kernels(monkeypatch):
    bk = _load_tool("bench_kernels")
    args, kw = _catch(monkeypatch, pallas_inflate, "inflate_phase_a",
                      lambda: bk.bench_inflate_phase_a(n=6, kb=4))
    frames, raws = ci.bench_inputs(6, 4)
    assert list(args[0]) == frames
    assert kw["hists"] == [0] * 6 and kw["T_PAD"] == ci.bench_tcap(4)
    assert raws == [utils.bench_corpus(1 << 20)[i * 4096:(i + 1) * 4096]
                    for i in range(6)]


def test_k2_inputs_equal_jax_resolve_bench(monkeypatch):
    args, kw = _catch(monkeypatch, pallas_inflate, "inflate_phase_a",
                      lambda: pallas_resolve.bench_entry(5))
    frames, _ = ci.bench_inputs(5, 32)
    assert list(args[0]) == frames and kw["T_PAD"] == ci.bench_tcap(32)


def test_k3_inputs_equal_jax_lzx_bench(monkeypatch, tmp_path):
    args, kw = _catch(monkeypatch, pallas_lzx, "lzx_phase_a",
                      lambda: pallas_lzx.bench_entry(3, 8, 16))
    datas, streams = cl.bench_inputs(3, 8, 16)
    assert list(args[0]) == streams and list(args[1]) == \
        [len(d) for d in datas] and args[2] == 16
    assert kw["T_PAD"] == 8 * 1024 + 4096
    assert streams[1] == pallas_lzx._encode_for_bench(datas[1], 16)
    # the cache gives back the same streams
    assert cl.bench_inputs(3, 8, 16, tmp_path)[1] == streams
    assert cl.bench_inputs(3, 8, 16, tmp_path)[1] == streams
    assert len(list(tmp_path.iterdir())) == 1


def test_k4_inputs_equal_jax_qtm_bench(monkeypatch):
    args, kw = _catch(monkeypatch, pallas_qtm, "qtm_phase_a",
                      lambda: pallas_qtm.bench_entry(3, 6, 15))
    datas, streams = cq.bench_inputs(3, 6, 15)
    assert list(args[0]) == streams and list(args[1]) == \
        [len(d) for d in datas] and args[2] == 15
    assert kw["T_PAD"] == cq.bench_tcap([len(d) for d in datas])


# -- the bench entries on the CPU (plain versions) ---------------------------

JAX_KEYS = {
    "k1": {"kernel", "config", "bytes_out", "ms", "mb_per_s",
           "mb_per_s_with_upload", "errors", "out_ok", "sampled_bit_exact",
           "max_steps"},
    "k2": {"kernel", "config", "bytes_out", "ms", "mb_per_s", "errors",
           "cnt_ok", "sampled_bit_exact"},
    "k3": {"kernel", "config", "bytes_out", "ms", "mb_per_s",
           "mb_per_s_with_upload", "errors", "out_ok", "sampled_bit_exact",
           "max_steps"},
    "k4": {"kernel", "config", "bytes_out", "ms", "mb_per_s", "errors",
           "out_ok", "sampled_bit_exact", "max_steps"},
}
ENTRIES = {
    "k1": lambda: ci.bench_entry(4, 4, device="cpu"),
    "k2": lambda: cr.bench_entry(4, device="cpu"),
    "k3": lambda: cl.bench_entry(4, 4, device="cpu"),
    "k4": lambda: cq.bench_entry(4, 4, device="cpu"),
}


@pytest.mark.parametrize("k", sorted(ENTRIES))
def test_bench_entry_cpu(k):
    e = ENTRIES[k]()
    assert JAX_KEYS[k] <= set(e)
    assert e["errors"] == 0 and e["lanes"] == 4
    assert e.get("out_ok", e.get("cnt_ok")) == 4
    assert e["sampled_bit_exact"] is True
    assert e["plain_max_abs_err"] == 0
    assert e["device"].startswith("cpu") and e["launch"] is None
    json.dumps(e)


def test_bench_entry_refuses_missing_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        ci.bench_entry(4, 4)


def test_inflate_bench_tool_cpu(capsys):
    got = inflate_bench.main(["4", "4"], device="cpu")
    assert got["errors"] == 0 and got["out_ok"] == 4
    assert all(got["bit_exact"].values()) and len(got["bit_exact"]) == 3
    assert "bench_corpus" in got["source"]
    assert "lane 3 bit-exact: True" in capsys.readouterr().out


# -- native.cab_mszip_pipeline -----------------------------------------------

def test_cab_mszip_pipeline_matches_jax():
    from libmspack_tpu import native as jax_native
    from libmspack_tpu.compress import cab_c as jax_cab_c
    from libmspack_tpu_torch.formats.cab import CabDecompressor

    rng = np.random.RandomState(5)
    data1 = (b"alpha beta gamma " * 9000)[:120000]
    data2 = rng.randint(0, 256, 50000).astype(np.uint8).tobytes()
    cab = jax_cab_c.write_cab(folders=[
        jax_cab_c.FolderSpec([("a.txt", data1)], "mszip"),
        jax_cab_c.FolderSpec([("b.bin", data2)], "mszip")])
    parsed = CabDecompressor(engine="native").open(cab)
    args = ([f.data[0].offset for f in parsed.folders],
            [f.num_blocks for f in parsed.folders], parsed.block_resv)
    bad = bytearray(cab)
    bad[parsed.folders[0].data[0].offset + 8 + 10] ^= 0xFF
    for blob, ok in ((cab, True), (bytes(bad), False)):
        outs = []
        for mod in (native, jax_native):
            out = np.zeros(len(data1) + len(data2), np.uint8)
            offs = mod.cab_mszip_pipeline(np.frombuffer(blob, np.uint8),
                                          *args, out)
            outs.append((offs, out.tobytes() if offs else None))
        assert outs[0] == outs[1]
        if ok:
            assert outs[0] == ([0, len(data1), len(data1) + len(data2)],
                               data1 + data2)
        else:
            assert outs[0] == (None, None)


# -- scaling_model -----------------------------------------------------------

def test_scaling_projections_equal_jax():
    jsm = _load_tool("scaling_model")
    rates = {"k1_inflate": 3.1e10, "k3_lzx": 2.9e10, "k4_qtm": 8.5e9}
    jrates = {"pallas_inflate.phase_a": rates["k1_inflate"],
              "pallas_lzx.phase_a": rates["k3_lzx"],
              "pallas_qtm.phase_a": rates["k4_qtm"]}
    kw = dict(gather_elem_s=jsm.GATHER_ELEM_S, link_bytes_s=jsm.BW_ICI,
              link_lat_s=jsm.LAT_ICI)
    for total_mb in (256, 7):
        assert scaling_model.ring_projection(rates, total_mb, **kw) == \
            jsm.ring_projection(jrates, total_mb)
        for port, jax_name in (("k3_lzx", "pallas_lzx.phase_a"),
                               ("k4_qtm", "pallas_qtm.phase_a")):
            assert scaling_model.lanes_projection(rates, port, total_mb) \
                == jsm.lanes_projection(jrates, jax_name, total_mb)
    doc = {"entries": [{"kernel": k, "mb_per_s": v / 1e6}
                       for k, v in rates.items()]}
    assert scaling_model.rates_from(doc) == pytest.approx(rates)
    proj = scaling_model.project(rates, 1e9, scaling_model.given_link(
        450.0, 5.0))
    assert proj["parameters"]["link"].startswith("given, not measured")
    assert "conclusion" not in proj


def test_gather_rate_from_p5_records():
    from libmspack_tpu_torch.tools import Record
    recs = [Record(k, f"({h},{w})", 1.0, None, None, 12 * h * w, 1, lib)
            for k, h, w, lib in (("p5_dyngather_axis0", 8, 128, 0.001),
                                 ("p5_dyngather_axis0", 1024, 128, 0.01),
                                 ("p5_dyngather_axis1", 8, 4096, 0.0001))]
    assert scaling_model.gather_rate(recs) == pytest.approx(
        1024 * 128 / 1e-5)


# -- devtime -----------------------------------------------------------------

def test_devtime_time_chained_cpu():
    t = devtime.time_chained(lambda x: x + 1, torch.zeros(64), n=8,
                             min_delta=0.001)
    assert t > 0
    assert devtime.fetch(torch.arange(3) + 5) == 5.0


def test_devtime_grows_n_as_the_jax_loop(monkeypatch):
    """``tools/devtime.py:46-61``: n times max(2, min(16, min_delta /
    delta)) until delta > min_delta."""
    calls = []

    def fake(make_step, init, n):
        calls.append(n)
        return n * 1e-4

    monkeypatch.setattr(devtime, "chain_seconds", fake)
    per = devtime.time_chained(None, None, n=64, min_delta=1.0)
    assert [n for n in calls if n > 1] == [64] * 2 + [1024] * 2 + \
        [9216] * 2 + [18432] * 2
    assert per == pytest.approx(1e-4)
    assert devtime.next_n(64, 0.0064, 1.0, 1 << 22) == 1024
    assert devtime.next_n(1 << 21, 0.5, 1.0, 1 << 22) == 1 << 22


# -- cut_bisect --------------------------------------------------------------

def _csrc_digest():
    h = hashlib.sha256()
    for name in sorted(os.listdir(kernels.CSRC)):
        with open(os.path.join(kernels.CSRC, name), "rb") as fh:
            h.update(name.encode() + fh.read())
    return h.hexdigest()


def test_cut_bisect_twin(capsys):
    before = _csrc_digest()
    ok, line = cut_bisect.cut("int64_t used = b.tell();")
    assert ok and line.startswith("CUT[int64_t used = b.tell();]: "
                                  "compile OK")
    ok, line = cut_bisect.cut("namespace dc {")   # outside any function
    assert not ok and ": FAIL" in line
    assert cut_bisect.main(["no_such_marker_here"]) == 2
    assert "not found" in capsys.readouterr().err
    assert _csrc_digest() == before
    # the JAX tool fails on a missing marker the same way
    r = subprocess.run([sys.executable, os.path.join(TOOLS, "pa_bisect.py"),
                        "no_such_marker_here"], capture_output=True,
                       text=True, timeout=120, cwd=ROOT)
    assert r.returncode != 0 and "not found" in r.stderr


def test_cut_source_statement():
    text = ("DC_FN int f(int a) {\n  int b = a;\n  return b;\n}\n"
            "DC_FN void g() {\n  h();\n}\n")
    assert "  int b = a;\n  return {};  // CUT[int b]\n" in \
        cut_bisect.cut_source(text, "int b")
    assert "  h();\n  return;  // CUT[h()]\n" in \
        cut_bisect.cut_source(text, "h()")
    with pytest.raises(ValueError, match="not found"):
        cut_bisect.cut_source(text, "zzz")


# -- the bench's main() and the mesh scaling ---------------------------------

def test_bench_main_cpu(monkeypatch, tmp_path, capsys):
    monkeypatch.setattr(bench, "CACHE_DIR", str(tmp_path))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.delenv("MSPACK_REFERENCE", raising=False)
    bench.main(["--mb", "mszip=1,lzx=1,quantum=1", "--reps", "1"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    doc = json.loads(lines[0])
    assert set(doc) == {"metric", "value", "unit", "vs_baseline", "extra"}
    assert doc["metric"] == "mszip_decompress" and doc["unit"] == "GB/s"
    extra = doc["extra"]
    for row in ("mszip_decompress", "lzx_decompress", "qtm_decompress"):
        assert extra[row]["value"] > 0          # bit-exact, or it raises
        assert extra[row]["vs_baseline"] is None
        assert "no reference sources" in extra[row]["baseline"]
    for row in ("mszip_decompress_cuda", "k1_inflate", "k3_lzx", "k4_qtm",
                "mesh_1dev"):
        assert extra[row]["value"] is None
        assert extra[row]["reason"] == "no CUDA device"
    assert doc["value"] == extra["mszip_decompress"]["value"]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench.main(["--mb", "mszip=1,lzx=1,quantum=1", "--require-cuda"])
    assert sorted(os.listdir(tmp_path)) == [
        "torch_lzx_1_f24.cab", "torch_mszip_1_f24.cab",
        "torch_quantum_1_f6.cab"]


def test_mesh_scaling_gloo_cpu():
    doc = mesh_scaling.run((1, 2), device="cpu", timeout_s=180)
    assert doc["bit_exact"] and [r["devices"] for r in doc["rows"]] == [1, 2]
    assert all(r["backend"] == "gloo" and r["seconds"] > 0
               for r in doc["rows"])
    assert doc["rows"][0]["speedup"] == 1.0
    assert doc["launches"]["cuda_inflate"]["plain"] > 0
    assert doc["launches"]["cuda_inflate"]["cuda"] == 0


def test_measure_link_gloo_cpu():
    link = scaling_model.measure_link(iters=5, device="cpu")
    assert link["link_bytes_s"] > 0 and link["link_lat_s"] > 0
    assert link["how"].startswith("measured: gloo send/recv")
