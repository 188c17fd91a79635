"""The harness: cells and metrics found by name, and ``correct`` that
comes out false under the control and under each fault the cells can
have."""
import json
import os
import shutil
import subprocess
import sys

import pytest

from .conftest import REPO


def test_a_new_cell_config_and_metric_are_files_and_entries(tiny_root,
                                                            run_cell):
    pb = os.path.join(tiny_root, "portbench")
    shutil.copy(os.path.join(pb, "configs", "cab_corpus.json"),
                os.path.join(pb, "configs", "dummy_cfg.json"))
    with open(os.path.join(pb, "traffic", "tiny.json"), "w") as fh:
        json.dump({"entry": "cab_driver", "archives_per_item": 1,
                   "pool_items": 2, "check": {"items": 1, "among": 2}}, fh)
    with open(os.path.join(pb, "metrics", "dummy.archives.py"), "w") as fh:
        fh.write("def read(run):\n"
                 "    return float(sum(r['archives'] for r in run.items))\n")
    path = os.path.join(tiny_root, "BENCHMARK.json")
    with open(path) as fh:
        bench = json.load(fh)
    bench["configs"].append({"name": "dummy_cfg", "source": "test",
                             "file": "portbench/configs/dummy_cfg.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": "dummy_cfg.tiny", "config":
                               "dummy_cfg", "traffic": "tiny", "chips": 1,
                               "why": "test"})
    bench["per_layer"].append({"name": "dummy.archives", "unit": "count",
                               "better": "higher", "source": "host_clock",
                               "layer": "test", "moves": "out_mbps",
                               "workloads": ["dummy_cfg.tiny"]})
    with open(path, "w") as fh:
        json.dump(bench, fh)
    rc, res, _ = run_cell(tiny_root, "dummy_cfg.tiny", trace=1)
    assert rc == 0 and res["correct"]
    assert res["metrics"]["dummy.archives"]["value"] == res["attempted"]


def test_setup_s_leaves_out_making_the_inputs(tiny_root, run_cell,
                                             monkeypatch):
    import time

    from portbench.formats import cab
    real = cab.build

    def slow(*a, **k):
        time.sleep(3.0)
        return real(*a, **k)
    monkeypatch.setattr(cab, "build", slow)
    rc, res, err = run_cell(tiny_root, "cab_corpus.per_archive")
    assert rc == 0 and res["correct"]
    assert res["metrics"]["setup_s"]["value"] < 3.0
    assert "not counted" in err


def test_control_is_not_correct(tiny_root, run_cell):
    for workload in ("cab_corpus.batch64", "oab_full.blocks64k"):
        rc, res, err = run_cell(tiny_root, workload, extra=["--control"])
        assert rc == 0 and res["correct"] is False
        assert res["checks"]["bytes_wrong"]["value"] > 0


def _flip(files):
    name = next(iter(files[0]))
    data = bytearray(files[0][name])
    data[len(data) // 2] ^= 0x40
    files[0][name] = bytes(data)
    return files


def _half(files):
    return [f if i % 2 == 0 else {} for i, f in enumerate(files)]


def _unchanged(files):
    return [{n: bytes(len(b)) for n, b in f.items()} for f in files]


@pytest.mark.parametrize("fault", [_flip, _half, _unchanged])
def test_faults_in_the_planner_are_not_correct(tiny_root, run_cell,
                                                monkeypatch, fault):
    from libmspack_tpu_torch.parallel import planner
    real = planner.archive_files
    monkeypatch.setattr(planner, "archive_files",
                        lambda plan, fb: fault(real(plan, fb)))
    rc, res, _ = run_cell(tiny_root, "cab_corpus.batch64")
    assert rc == 0 and res["correct"] is False
    assert res["checks"]["files_wrong"]["value"] > 0


@pytest.mark.parametrize("fault", [_flip, _unchanged])
def test_faults_in_the_oab_driver_are_not_correct(tiny_root, run_cell,
                                                   monkeypatch, fault):
    from libmspack_tpu_torch.formats.oab import OabDecompressor
    real = OabDecompressor.decompress

    def faulty(self, data, sink):
        real(self, data, sink)
        got = fault([{"oab": bytes(sink.view())}])[0]["oab"]
        sink.buf[:sink.at] = got
    monkeypatch.setattr(OabDecompressor, "decompress", faulty)
    rc, res, _ = run_cell(tiny_root, "oab_full.blocks64k")
    assert rc == 0 and res["correct"] is False
    assert res["checks"]["bytes_wrong"]["value"] > 0


def test_the_oab_sink_is_reused_and_kept_items_are_copied(tiny_root,
                                                          run_cell):
    """Every item writes the same buffer; the sampled items' files are
    copied out of it, so the check reads each item's own bytes."""
    rc, res, err = run_cell(tiny_root, "oab_full.blocks64k", seconds=1.0)
    assert rc == 0 and res["correct"]
    assert res["attempted"] > 8
    assert "compared 3 files of 3 items" in err


class StepClock:
    """A ``time`` whose ``perf_counter`` moves one second a call, so that a
    window of ``--seconds 3`` holds exactly two items."""

    def __init__(self):
        self.now = 0.0

    def perf_counter(self):
        self.now += 1.0
        return self.now


def test_a_window_that_ends_on_a_sampled_item_is_correct(tiny_root,
                                                         run_cell,
                                                         monkeypatch):
    """The window's first item is not sampled and hands back views of the
    reused OAB sink; the second, its last, is sampled, kept as bytes of
    its own, and writes the sink again. The first item's views then hold
    the second's bytes and are not compared."""
    from portbench import run
    monkeypatch.setattr(run, "time", StepClock())
    monkeypatch.setattr(run, "sample", lambda seed, traffic: {1})
    rc, res, err = run_cell(tiny_root, "oab_full.blocks64k", seconds=3.0)
    assert rc == 0 and res["attempted"] == 2
    assert res["correct"], err
    assert "compared 1 files of 1 items" in err


def test_a_failing_item_is_counted_and_not_correct(tiny_root, run_cell,
                                                   monkeypatch):
    from libmspack_tpu_torch.formats.cab import CabDecompressor
    real, calls = CabDecompressor.extract, []

    def every_other_archive(self, file, output):
        calls.append(file)
        # two warm-up archives of eight files, then every other archive
        if len(calls) > 16 and (len(calls) - 1) // 8 % 2:
            raise RuntimeError("declined")
        return real(self, file, output)
    monkeypatch.setattr(CabDecompressor, "extract", every_other_archive)
    rc, res, err = run_cell(tiny_root, "cab_corpus.per_archive")
    assert rc == 0 and res["correct"] is False
    assert 0 < res["failed"] < res["attempted"]
    assert res["checks"]["items_failed"]["value"] == res["failed"]
    assert "failed item: RuntimeError: declined" in err


def test_no_card_no_result(tiny_root):
    """Without a card (this host) the command exits 2 and prints no
    result; so it does from a directory holding only BENCHMARK.json and
    the benchmark's files."""
    only = os.path.join(tiny_root, "only")
    os.makedirs(only)
    shutil.copy(os.path.join(REPO, "BENCHMARK.json"), only)
    shutil.copytree(os.path.join(REPO, "portbench"),
                    os.path.join(only, "portbench"),
                    ignore=shutil.ignore_patterns("_cache", "__pycache__"))
    for cwd, env_path in ((REPO, REPO), (only, "")):
        env = dict(os.environ, PYTHONPATH=env_path)
        r = subprocess.run([sys.executable, "-m", "portbench.run",
                            "--workload", "cab_corpus.batch64", "--seed",
                            "3000000000", "--seconds", "1", "--trace", "0"],
                           cwd=cwd, env=env, capture_output=True, text=True,
                           timeout=300)
        if cwd == REPO:
            import torch
            if torch.cuda.is_available():
                continue
            assert r.returncode == 2
        assert r.returncode != 0 and r.stdout.strip() == ""


def test_the_oab_sink_refuses_bytes_past_the_target_size():
    from portbench.entries.oab_full import ReusedSink
    sink = ReusedSink()
    sink.reset(8)
    sink.write(b"1234")
    with pytest.raises(ValueError):
        sink.write(b"56789")


MMAPPED_AFTER_A_LARGE_BUFFER = """
import ctypes, sys
sys.path.insert(0, {root!r})
from portbench.run import keep_freed_memory
kept = keep_freed_memory() if {keep} else False

class Info(ctypes.Structure):
    _fields_ = [(n, ctypes.c_size_t) for n in (
        "arena", "ordblks", "smblks", "hblks", "hblkhd", "usmblks",
        "fsmblks", "uordblks", "fordblks", "keepcost")]

libc = ctypes.CDLL(None)
libc.mallinfo2.restype = Info
libc.malloc.restype = ctypes.c_void_p
before = libc.mallinfo2().hblks
p = libc.malloc(256 << 20)
print(kept, libc.mallinfo2().hblks - before)
libc.free(ctypes.c_void_p(p))
"""


@pytest.mark.parametrize("keep", [True, False])
def test_the_card_run_allocates_large_buffers_from_the_heap(keep):
    """``keep_freed_memory`` stops glibc from mapping a large buffer of its
    own (which it would unmap on free, for the next item to fault in
    anew); without it the same buffer is mapped."""
    code = MMAPPED_AFTER_A_LARGE_BUFFER.format(root=REPO, keep=keep)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True).stdout.split()
    assert out == (["True", "0"] if keep else ["False", "1"])
