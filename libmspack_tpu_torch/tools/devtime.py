"""Device time of a dependent chain of steps: the port of ``tools/devtime.py``.

The JAX module ran an op N times as a dependent chain inside one jit,
fetched one scalar, and grew N until the N-steps-against-none difference
outweighed its host's noise. Here ``time_chained`` runs the N steps on
the card between two CUDA events (the closing one synchronised before
``elapsed_time``), so the time is the device's and no fetch is in it; on
the CPU (plain versions) it reads the host clock. N grows as the JAX loop
grows it (``tools/devtime.py:46-61``). ``tools/timing.py`` replays a
CUDA graph instead, for probes of a few microseconds; a chain of kernel
launches that each take milliseconds needs none.

The JAX module's first-fetch retry loop and its compilation cache have no
counterpart: the card is local, and the kernels are built once into
``_build/``.
"""
from __future__ import annotations

import time

import torch

from .._device import resolve_device


def warmup(device="cuda") -> None:
    """The first call on ``device``: one small op, synchronised."""
    dev = resolve_device(device)
    x = torch.arange(128, device=dev) + 1
    fetch(x)


def fetch(x) -> float:
    """Wait for everything ``x`` depends on; return its first element."""
    if x.device.type == "cuda":
        torch.cuda.synchronize(x.device)
    return float(x.reshape(-1)[:1].float().sum())


def chain_seconds(make_step, init, n: int) -> float:
    """Seconds that ``n`` dependent steps ``x = make_step(x)`` from
    ``init`` take where ``init`` lies: CUDA events on the card, the host
    clock on the CPU."""
    x = init
    if init.device.type == "cuda":
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(n):
            x = make_step(x)
        b.record()
        b.synchronize()
        return a.elapsed_time(b) / 1e3
    t0 = time.perf_counter()
    for _ in range(n):
        x = make_step(x)
    fetch(x)
    return time.perf_counter() - t0


def next_n(n: int, delta: float, min_delta: float, max_n: int) -> int:
    """The chain length after a run whose difference was ``delta``
    seconds (``tools/devtime.py:60-61``)."""
    n *= max(2, min(16, int(min_delta / max(delta, 1e-3))))
    return min(n, max_n)


def time_chained(make_step, init, n=64, min_delta=1.0, max_n=1 << 22,
                 verbose=False) -> float:
    """Seconds per step of ``make_step`` (``x -> x``-like, each step
    depending on the one before), from chains of growing length on
    ``init``'s device: the best of two runs of ``n`` steps less the best
    of two of none, until that difference exceeds ``min_delta`` seconds
    or ``n`` reaches ``max_n``."""
    chain_seconds(make_step, init, 1)   # build and warm
    while True:
        t0 = min(chain_seconds(make_step, init, 0) for _ in range(2))
        tn = min(chain_seconds(make_step, init, n) for _ in range(2))
        delta = tn - t0
        if verbose:
            print(f"    n={n}: t0={t0:.3f}s tn={tn:.3f}s", flush=True)
        if delta > min_delta or n >= max_n:
            return max(delta, 1e-9) / n
        n = next_n(n, delta, min_delta, max_n)
