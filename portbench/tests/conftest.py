"""Fixtures of the benchmark's own tests: a copy of the benchmark's data
files at a tiny size, and the card (tests marked ``cuda`` skip without
one)."""
import json
import os
import shutil
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

TINY = 1 << 16


def pytest_configure(config):
    config.addinivalue_line("markers",
                            "cuda: needs a CUDA card (skips without one)")


def _edit(path, fn):
    with open(path) as fh:
        obj = json.load(fh)
    fn(obj)
    with open(path, "w") as fh:
        json.dump(obj, fh)


def make_tiny_root(dst) -> str:
    """``BENCHMARK.json`` and the benchmark's data files under ``dst``,
    every cell cut to a few archives of 64 KiB folders."""
    dst = str(dst)
    shutil.copy(os.path.join(REPO, "BENCHMARK.json"), dst)
    shutil.copytree(os.path.join(REPO, "portbench"),
                    os.path.join(dst, "portbench"),
                    ignore=shutil.ignore_patterns("_cache", "__pycache__",
                                                  "tests"))
    conf = os.path.join(dst, "portbench", "configs")
    traffic = os.path.join(dst, "portbench", "traffic")

    def cab(c):
        for cabinet in c["cabinets"]:
            for f in cabinet:
                f["bytes"] = TINY

    def oab(c):
        c["target_bytes"] = 4 * TINY

    _edit(os.path.join(conf, "cab_corpus.json"), cab)
    _edit(os.path.join(conf, "oab_full.json"), oab)

    def batch(t):
        t["archives_per_item"] = 3

    def per_archive(t):
        t["pool_items"] = 3
        t["check"] = {"items": 2, "among": 3}

    def large(t):
        for cabinet in t["cabinets"]:
            for f in cabinet:
                f["bytes"], f["count"] = 2 * TINY, 2

    _edit(os.path.join(traffic, "batch64.json"), batch)
    _edit(os.path.join(traffic, "per_archive.json"), per_archive)
    _edit(os.path.join(traffic, "large_folders.json"), large)
    return dst


@pytest.fixture
def tiny_root(tmp_path):
    return make_tiny_root(tmp_path)


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card here")
    return torch.device("cuda")


@pytest.fixture
def run_cell(capsys):
    """``run_cell(root, workload, seed, ...)``: one run of the harness in
    this process on the CPU; returns (exit code, the last stdout line as
    an object or None, standard error)."""
    from portbench import run

    def go(root, workload, seed=4294967311, seconds=0.3, trace=0,
           engine="native", device="cpu", extra=()):
        capsys.readouterr()
        rc = run.main(["--workload", workload, "--seed", str(seed),
                       "--seconds", str(seconds), "--trace", str(trace),
                       *extra], root=root, device=device, engine=engine)
        out, err = capsys.readouterr()
        lines = out.strip().splitlines()
        return rc, (json.loads(lines[-1]) if lines else None), err

    return go
