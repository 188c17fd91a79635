"""In a fresh interpreter: every module of the benchmark imports, one tiny
item runs on the CPU, no module of JAX, of the JAX package or the
top-level ``bench`` loads, and nothing under ``.bench_cache/`` is
opened."""
import json
import os
import subprocess
import sys
import textwrap

from .conftest import REPO

FORBIDDEN = {"jax", "jaxlib", "flax", "libmspack_tpu", "bench"}

SCRIPT = textwrap.dedent("""
    import importlib, json, os, pkgutil, sys
    sys.path.insert(0, {repo!r})
    opened = []

    def hook(event, args):
        if event == "open" and args and isinstance(args[0], (str, bytes)):
            opened.append(os.fsdecode(args[0]))
    sys.addaudithook(hook)

    import portbench
    from portbench import run
    names = [m.name for m in pkgutil.walk_packages(portbench.__path__,
                                                   "portbench.")
             if ".tests" not in m.name]
    for name in names:
        importlib.import_module(name)
    sys.path.insert(0, os.path.join({repo!r}, "portbench", "tests"))
    from conftest import make_tiny_root
    root = make_tiny_root({tmp!r})
    bench = run.load_json(os.path.join(root, "BENCHMARK.json"))
    for m in bench["end_to_end"] + bench["per_layer"]:
        run.metric_reader(root, m["name"])
    rc = run.main(["--workload", "cab_corpus.batch64", "--seed",
                   "4294967296", "--seconds", "0.05", "--trace", "1"],
                  root=root, device="cpu", engine="cuda")
    print(json.dumps({{"rc": rc, "modules": names,
                      "top": sorted({{m.split(".")[0]
                                      for m in sys.modules}}),
                      "opened": opened}}))
""")


def test_fresh_interpreter_imports_and_runs_clean(tmp_path):
    root = tmp_path / "root"
    root.mkdir()
    r = subprocess.run([sys.executable, "-c",
                        SCRIPT.format(repo=REPO, tmp=str(root))],
                       capture_output=True, text=True, timeout=600,
                       cwd=str(tmp_path))
    assert r.returncode == 0, r.stderr[-3000:]
    out = json.loads(r.stdout.strip().splitlines()[-1])
    assert out["rc"] == 0
    assert {"portbench.run", "portbench.check", "portbench.trace",
            "portbench.gen.encoders", "portbench.formats.cab",
            "portbench.entries.planner"} <= set(out["modules"])
    assert "libmspack_tpu_torch" in out["top"]
    assert not FORBIDDEN & set(out["top"])
    assert not [p for p in out["opened"] if ".bench_cache" in p]
    assert not [p for p in out["opened"]
                if os.path.basename(p).startswith(("BENCH_", "BENCHMARKS"))]
