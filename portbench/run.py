"""One run of one cell of the port's benchmark.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

From the root of a checkout. The run finds everything by name:
``BENCHMARK.json`` names the cell's configuration (``portbench/configs/``),
traffic mix (``portbench/traffic/<traffic>.json``) and metrics; the
configuration's ``format`` names the input builder
(``portbench/formats/``), the traffic's ``entry`` the program entry that
the window drives (``portbench/entries/``), and each metric is read by
``portbench/metrics/<metric>.py``. A cell or a metric is added with files
and entries in ``BENCHMARK.json``, and no edit here.

1. Set-up: glibc's allocator told to keep freed memory in its heap
   (``keep_freed_memory``), torch and the card (no card, or fewer than
   the cell asks for: exit 2, no result), the program's kernels (built into the program's own
   cache inside the checkout on a checkout's first run), the cell's pool of
   inputs made from the seed, and the warm-up items. ``setup_s`` is all of
   it but the inputs: making them is the benchmark's work, not the
   program's, and is timed apart.
2. Window: items back to back, cycling over the pool, one caller in a
   closed loop, until ``--seconds`` have passed; the item running then
   completes and counts. With ``--trace 1`` the profiler records it.
3. Once the window has closed: the device's memory peak, then the
   comparison (``check.py``) of the sampled items' files with the
   generator's plaintext, each compared number beside its limit as the
   last lines of standard error, and one JSON line as the last line of
   standard output.

``--control`` puts the check's control in the program's place (the
benchmark's own runs never pass it).
"""
from __future__ import annotations

import argparse
import gc
import importlib
import importlib.util
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = {"jax", "jaxlib", "flax", "libmspack_tpu", "bench"}


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def parse(argv):
    p = argparse.ArgumentParser(prog="portbench.run")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--control", action="store_true")
    return p.parse_args(argv)


def load_json(path):
    with open(path) as fh:
        return json.load(fh)


def metric_reader(root, name):
    path = os.path.join(root, "portbench", "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        f"portbench.metrics.{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def applies(metric, cell) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


class Run:
    """What metric readers read: the window's items, the set-up and window
    lengths, the trace of a traced run."""

    def __init__(self, cell, config, traffic):
        self.cell, self.config, self.traffic = cell, config, traffic
        self.items: list = []
        self.setup_s = 0.0
        self.window_s = 0.0
        self.trace = None

    @property
    def delivered_bytes(self) -> int:
        return sum(r["plain_bytes"] for r in self.items if r["ok"])

    def has(self, key) -> bool:
        return any(key in r["counters"] for r in self.items if r["ok"])

    def total(self, key) -> float:
        return sum(r["counters"].get(key, 0.0) for r in self.items
                   if r["ok"])

    def kernel_bytes(self, codec) -> tuple:
        r = w = 0
        for rec in self.items:
            if rec["ok"]:
                got = rec["kernel_bytes"].get(codec, (0, 0))
                r, w = r + got[0], w + got[1]
        return r, w


class Context:
    """What an entry is handed: the engine, the device, spans, sync."""

    def __init__(self, engine, device, tracer):
        self.engine, self.device = engine, device
        self.span = tracer.span

    def sync(self):
        if self.device == "cuda":
            import torch
            torch.cuda.synchronize()


def keep_freed_memory() -> bool:
    """Has glibc's allocator serve every request from its heap and keep
    what is freed there: no ``mmap`` and ``munmap`` of a large buffer, no
    trim. A long-running extraction process is tuned so; the program pulls
    hundreds of MB an item into fresh host buffers, and mapping and
    faulting those in anew took more than half of an OAB item's wall and
    moved its rate by a tenth and more from process to process. Returns
    whether the allocator took the settings (False where it is not
    glibc's)."""
    import ctypes
    try:
        mallopt = ctypes.CDLL(None).mallopt
    except (OSError, AttributeError):
        return False
    # M_MMAP_MAX, M_TRIM_THRESHOLD, M_TOP_PAD
    return all(mallopt(param, value) == 1 for param, value in
               ((-4, 0), (-1, 2**31 - 1), (-2, 64 << 20)))


def card_line() -> str:
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True,
                           text=True, timeout=20)
        return r.stdout.strip().replace("\n", "; ")
    except (OSError, subprocess.SubprocessError):
        return "nvidia-smi not readable"


def sample(seed, traffic) -> set:
    """The positions of the window's items whose files are kept for the
    comparison, drawn from the seed."""
    from portbench.gen import data
    spec = traffic["check"]
    rng = data.rng_for(seed, 3)
    return set(int(i) for i in rng.choice(spec["among"], spec["items"],
                                          replace=False))


def owned(files) -> list:
    """An item's files as bytes of their own: an entry may hand back views
    of a buffer that its next item writes again."""
    return [{n: bytes(b) if isinstance(b, memoryview) else b
             for n, b in f.items()} for f in files]


def main(argv=None, root=ROOT, device=None, engine="cuda") -> int:
    """One run; returns the exit code. ``device`` None is the card (and the
    check for it); the tests pass ``"cpu"``, which runs the program's plain
    versions of its kernels."""
    t_start = time.perf_counter()
    args = parse(argv)
    bench = load_json(os.path.join(root, "BENCHMARK.json"))
    cell = next((w for w in bench["workloads"] if w["name"] == args.workload),
                None)
    if cell is None:
        log(f"no workload {args.workload!r} in BENCHMARK.json")
        return 2
    conf_entry = next(c for c in bench["configs"] if c["name"] ==
                      cell["config"])
    config = load_json(os.path.join(root, conf_entry["file"]))
    traffic = load_json(os.path.join(root, "portbench", "traffic",
                                     f"{cell['traffic']}.json"))

    heap = keep_freed_memory() if device is None else False
    t = time.perf_counter()
    import torch
    t_torch = time.perf_counter() - t
    t = time.perf_counter()
    if device is None:
        if not torch.cuda.is_available() or \
                torch.cuda.device_count() < cell["chips"]:
            log(f"{cell['name']} needs {cell['chips']} CUDA device(s); "
                f"found {torch.cuda.device_count()}: no result")
            return 2
        device = "cuda"
        t_card = time.perf_counter() - t
        log(f"card: {card_line()}; allocator keeps freed memory: {heap}")
    else:
        t_card = time.perf_counter() - t
    try:
        importlib.import_module("libmspack_tpu_torch")
    except ImportError as e:
        log(f"the program (libmspack_tpu_torch) is not here: {e}")
        return 2

    from portbench import check, stats, trace
    from portbench.gen import encoders

    tracer = trace.Tracer(bool(args.trace))
    ctx = Context(engine, device, tracer)
    t = time.perf_counter()
    if device == "cuda":
        from libmspack_tpu_torch import kernels, native
        kernels.lib()
        native.lib()
    encoders.lib()
    t_build = time.perf_counter() - t

    t = time.perf_counter()
    threads = min(8, os.cpu_count() or 1)
    fmt = importlib.import_module(f"portbench.formats.{config['format']}")
    pool = fmt.build(config, traffic, args.seed, threads)
    t_inputs = time.perf_counter() - t
    plain = sum(it.plain_bytes for it in pool)
    packed = sum(it.input_bytes for it in pool)
    log(f"inputs: {len(pool)} items, {sum(len(i.inputs) for i in pool)} "
        f"archives, {plain} bytes of plaintext in {packed} "
        f"(compression ratio {plain / packed:.4f}), made in {t_inputs:.3f} s")

    entry = importlib.import_module(
        f"portbench.entries.{traffic['entry']}").make(ctx)
    if args.control:
        def entry(item):       # noqa: F811 -- the control replaces it
            return check.control(item), {}
    t = time.perf_counter()
    for i in range(traffic.get("warmup_items", 1)):
        entry(pool[i % len(pool)])
    ctx.sync()
    t_warm = time.perf_counter() - t
    run = Run(cell["name"], config, traffic)
    run.setup_s = time.perf_counter() - t_start - t_inputs
    log(f"set-up: {run.setup_s:.3f} s (torch imported {t_torch:.3f} s, "
        f"card found {t_card:.3f} s, kernels and encoders loaded or built "
        f"{t_build:.3f} s, warm-up {t_warm:.3f} s; the inputs' "
        f"{t_inputs:.3f} s not counted)")

    keep_at = sample(args.seed, traffic)
    kept, errors = [], []
    last = None
    with tracer.window():
        t0 = time.perf_counter()
        i = 0
        while True:
            item = pool[i % len(pool)]
            a = time.perf_counter()
            try:
                files, counters = entry(item)
                ok = True
            except Exception as e:     # a failed item delivers nothing
                files, counters, ok = None, {}, False
                errors.append(f"{type(e).__name__}: {e}")
            b = time.perf_counter()
            run.items.append({"ok": ok, "wall_s": b - a,
                              "archives": len(item.inputs),
                              "plain_bytes": item.plain_bytes,
                              "kernel_bytes": item.kernel_bytes,
                              "counters": counters})
            if ok and i in keep_at:
                kept.append((item, owned(files)))
                last = None
            elif ok:
                last = (item, files)
            i += 1
            if b - t0 >= args.seconds:
                break
        run.window_s = time.perf_counter() - t0

    peak = torch.cuda.max_memory_allocated() if device == "cuda" else 0
    del entry, files
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    run.trace = tracer.read()

    failed = sum(not r["ok"] for r in run.items)
    walls = sorted(r["wall_s"] * 1e3 for r in run.items if r["ok"])
    log(f"window: {run.window_s:.3f} s, {len(run.items)} items "
        f"({sum(r['archives'] for r in run.items)} archives), {failed} "
        f"failed; item wall ms: count {len(walls)}"
        + (f", min {walls[0]:.3f}, median {statistics.median(walls):.3f}, "
           f"p95 {stats.p95(walls):.3f}, max {walls[-1]:.3f}"
           if walls else ""))
    for e in errors[:5]:
        log(f"failed item: {e[:500]}")

    if last is not None:
        kept.append(last)
    checked = wrong = nbytes = 0
    for item, files in kept:
        c, w, n = check.compare(files, item.expected)
        checked, wrong, nbytes = checked + c, wrong + w, nbytes + n
    checks = {"items_failed": failed, "files_wrong": wrong,
              "bytes_wrong": nbytes}
    log(f"compared {checked} files of {len(kept)} items")
    correct = checked > 0 and all(v <= check.LIMITS[k]
                                  for k, v in checks.items())

    metrics = {}
    kind = "per_layer" if args.trace else "end_to_end"
    for m in bench[kind]:
        if not applies(m, cell["name"]):
            continue
        value = metric_reader(root, m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if device == "cuda" else device,
           "kind": torch.cuda.get_device_name(0) if device == "cuda"
           else "cpu",
           "count": cell["chips"], "memory_peak_bytes": peak}
    result = {"correct": correct, "attempted": len(run.items),
              "failed": failed, "metrics": metrics, "device": dev}
    if run.trace is not None:
        dev["busy_s"] = run.trace.busy_s
        dev["window_s"] = run.trace.window_s
        result["breakdown"] = {"device_ops": run.trace.device_ops(),
                               "idle_gaps": run.trace.idle_gaps()}
    result["checks"] = {k: {"value": v, "limit": check.LIMITS[k]}
                        for k, v in checks.items()}

    loaded = sorted({m.split(".")[0] for m in sys.modules} & FORBIDDEN)
    if loaded:
        log(f"modules that must not load were loaded: {loaded}: no result")
        return 3
    for k, v in checks.items():
        log(f"check {k} {v} limit {check.LIMITS[k]}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
