"""Shared helpers for the drivers: engine routing and the bench corpus.

Copied from ``libmspack_tpu/utils/__init__.py``. Besides the imports:
``resolve_engine`` is the port's own (``_device.py``), re-exported here;
routing is per codec, because the port's ``"cuda"`` planner decodes MSZIP,
LZX and Quantum on the card where the JAX ``"tpu"`` planner put only MSZIP
on the device, so the calibration holds a crossover per codec; the
calibration file is read on every call instead of cached in the module;
and ``bench_corpus`` has no candidate path of the development host, only
``MSPACK_BENCH_CORPUS`` and the synthetic corpus (``build_corpus``).
"""
from __future__ import annotations

import json
import os

from .._device import resolve_engine

__all__ = ["resolve_engine", "engine_calibration", "choose_engine",
           "bench_corpus", "build_corpus", "CODECS"]

CODECS = ("mszip", "lzx", "quantum")

CALIBRATION_PATH = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "calibration.json")


def engine_calibration() -> dict:
    """Measured per-engine throughput table for auto routing.

    Produced by ``python -m libmspack_tpu_torch.tools.calibrate_engines``
    on the target host, into ``libmspack_tpu_torch/calibration.json``;
    ``MSPACK_CALIBRATION=/path.json`` names another file. Schema::

      {"native_mb_s": {codec: float},        # end-to-end planner, host
       "cuda_mb_s_large": {codec: float|null},  # engine="cuda", largest
                                                 # workload measured
       "cuda_crossover_bytes": {codec: int|null}}  # the smallest workload
                                 # measured at which "cuda" won; null =
                                 # it never wins here

    for the codecs ``"mszip"``, ``"lzx"`` and ``"quantum"``. No file (or
    an unreadable one) is the empty table: "cuda" is never chosen."""
    path = os.environ.get("MSPACK_CALIBRATION") or CALIBRATION_PATH
    try:
        with open(path) as fh:
            cal = json.load(fh)
    except (OSError, ValueError):
        return {}
    return cal if isinstance(cal, dict) else {}


def choose_engine(workload_bytes: int, codec: str) -> str:
    """Workload-aware auto routing (planner scale), per codec.

    Picks ``"cuda"`` only when ``torch.cuda.is_available()`` AND the
    host's calibration says the end-to-end CUDA path wins for ``codec`` at
    this workload size (``cuda_crossover_bytes[codec]`` at or below it).
    Otherwise the native engine, or ``"scalar"`` where it does not
    build."""
    from .. import native
    if codec not in CODECS:
        raise ValueError(f"codec must be one of {CODECS}: {codec!r}")
    base = "native" if native.available() else "scalar"
    cross = (engine_calibration().get("cuda_crossover_bytes") or {}) \
        .get(codec)
    if cross is None or workload_bytes < cross:
        return base
    import torch
    return "cuda" if torch.cuda.is_available() else base


def build_corpus(n_bytes: int) -> bytes:
    """The synthetic bench corpus (``bench.py:40-50``, the same bytes): a
    mixed text / structured / noise blob, made from a seed."""
    import numpy as np
    rng = np.random.RandomState(7)
    parts = []
    text = (b"The quick brown fox jumps over the lazy dog. "
            b"Pack my box with five dozen liquor jugs. ") * 40
    while sum(map(len, parts)) < n_bytes:
        parts.append(text)
        parts.append(rng.randint(0, 64, 2048, dtype=np.uint8).tobytes() * 4)
        parts.append(bytes(np.arange(256, dtype=np.uint8)) * 32)
    return b"".join(parts)[:n_bytes]


def bench_corpus(n_bytes: int) -> bytes:
    """Compressible corpus for the library-shipped kernel bench entries:
    the file named by ``MSPACK_BENCH_CORPUS`` repeated to ``n_bytes``,
    else ``build_corpus(n_bytes)``."""
    env = os.environ.get("MSPACK_BENCH_CORPUS")
    if env:
        try:
            with open(env, "rb") as fh:
                base = fh.read()
            if base:
                return (base * (1 + n_bytes // len(base)))[:n_bytes]
        except OSError:
            pass
    return build_corpus(n_bytes)
