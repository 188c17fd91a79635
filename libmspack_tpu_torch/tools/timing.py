"""Timing for the probe tools: the port's counterpart of ``tools/devtime.py``.

The TPU tools timed a dependent chain of calls inside one jit, because
their host saw a call complete late and with much noise. On the card,
``time_ms`` captures ``reps`` calls in one CUDA graph and times a replay of
it with two CUDA events, so the time is the device's and not the Python
wrapper's (a probe kernel may take a few microseconds, less than the
wrapper's host time). On the CPU (the plain versions) it reads the host
clock, and ``header`` says so.
"""
from __future__ import annotations

import subprocess
import time

import torch

from . import CAPTURED


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60, check=True)
    return r.stdout.strip().splitlines()[0]


def header(dev: torch.device) -> str:
    """The first line a tool prints: what its times were taken on."""
    if dev.type == "cuda":
        return f"{card_line()} (CUDA events)"
    return "cpu: plain versions, host clock (no device times)"


def _detach(out):
    """Copies of a result's tensors, out of the graph's memory pool."""
    if isinstance(out, (tuple, list)):
        return type(out)(_detach(o) for o in out)
    return out.clone() if isinstance(out, torch.Tensor) else out


def time_cold_ms(fn, dev: torch.device, reps: int = 10, flush_mb: int = 128):
    """``(fn()'s result, ms per call)`` with ``flush_mb`` MiB written
    before each call, more than the card's L2 holds, so ``fn`` finds its
    inputs in device memory: a graph of ``reps`` (write, ``fn``) pairs
    timed as ``time_ms`` does, less a graph of the writes alone. Card
    only; ``fn`` runs (and counts) as in ``time_ms``."""
    buf = torch.empty(flush_mb << 20, dtype=torch.uint8, device=dev)
    _, flush = time_ms(lambda: buf.fill_(1), dev, reps)
    out, both = time_ms(lambda: (buf.fill_(1), fn())[1], dev, reps)
    return out, both - flush


def time_ms(fn, dev: torch.device, reps: int = 10, warmup: int = 1):
    """``(fn()'s result, ms per call)``: on the card the mean over
    ``reps`` calls after ``warmup`` calls (``fn`` must not synchronise the
    device); on the CPU one call. On the card the graph is replayed twice
    (a warm-up and the timed replay), so a probe kernel that ``fn``
    launches once runs, and is counted, ``warmup + 2 * reps`` times."""
    if dev.type != "cuda":
        t0 = time.perf_counter()
        out = fn()
        return out, (time.perf_counter() - t0) * 1e3
    out = None
    for _ in range(warmup):
        out = fn()
    with torch.cuda.device(dev):
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        CAPTURED.clear()
        with torch.cuda.graph(graph):
            for _ in range(reps):
                out = fn()
        recorded = CAPTURED[:]
        CAPTURED.clear()

        def replay():
            graph.replay()
            for counts, name in recorded:
                counts[name] += 1

        replay()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        replay()
        b.record()
        b.synchronize()
        return _detach(out), a.elapsed_time(b) / reps


def in_turns(runs: dict, dev: torch.device, rounds: int = 3, reps: int = 10,
             timer=time_ms):
    """``({name: its fn()'s result}, {name: mean ms per call})`` for the
    callables of ``runs``, each timed by ``timer`` (``time_ms`` or
    ``time_cold_ms``) in turns: ``rounds`` passes in order and back
    (ABBA), so each name is timed ``2 rounds`` times. On the CPU one pass
    in order."""
    names = list(runs)
    order = names + names[::-1] if dev.type == "cuda" else names
    got = {name: [] for name in names}
    outs = {}
    for _ in range(rounds if dev.type == "cuda" else 1):
        for name in order:
            outs[name], ms = timer(runs[name], dev, reps)
            got[name].append(ms)
    return outs, {name: sum(v) / len(v) for name, v in got.items()}


def print_turns(label: str, ms: dict, dev: torch.device) -> None:
    """Two lines of an ``in_turns`` timing (its default rounds) that has a
    ``"copy_ floor"`` run: each run's mean, then each other run's excess
    over the floor."""
    floor = ms["copy_ floor"]
    n = 6 if dev.type == "cuda" else 1
    print(f"{label}, mean of {n} in turns: " + ", ".join(
        f"{k} {v * 1e3:.3f} us" for k, v in ms.items()), flush=True)
    print(f"{label} over the copy_ floor: " + ", ".join(
        f"{k} {(v - floor) * 1e3:.3f} us" for k, v in ms.items()
        if k != "copy_ floor"), flush=True)
