"""Spans and host-clock timings at the port's layer boundaries.

``span(name)`` opens ``torch.profiler.record_function(name)`` while a
``torch.profiler`` records, so the span lands in the profiler's trace on
the same clock as the card's kernels and copies; with no profiler it is
one shared no-op context, after one check of a module flag: a
``record_function`` enters the profiler's dispatcher whether or not
anything records. A recording profiler is the only switch: the engines
also make their CUDA events (``recording()``) only then.

Given a dict and a key, ``span`` adds its host-clock milliseconds to
``timings[key]`` whether or not a profiler records, as the drivers', the
planner's and the engines' ``timings`` have always been kept.
``add_ms`` does the same for a stretch too fine for a span of its own
(one OAB block's CRC).

The port's spans are named ``mspack.<layer>.<step>``: ``planner``,
``cab``, ``oab`` and ``engine``. They are coarse, one per call, batch,
archive or launch, never one per CFDATA block, MSZIP frame or OAB block.
"""
from __future__ import annotations

import contextlib
import functools
import time

import torch
import torch.autograd.profiler as _autograd_profiler

_OFF = contextlib.nullcontext()


def recording() -> bool:
    """Whether a ``torch.profiler`` records in this process."""
    return _autograd_profiler._is_profiler_enabled


def add_ms(timings: dict, key: str, t0: float) -> None:
    """Adds the host-clock milliseconds since ``t0`` (``perf_counter``)
    to ``timings[key]``."""
    timings[key] = timings.get(key, 0.0) + (time.perf_counter() - t0) * 1e3


def span(name: str, timings: dict | None = None, key: str | None = None):
    """A context: the span ``name`` while a profiler records, and the
    host-clock milliseconds added to ``timings[key]`` when both are
    given."""
    on = _autograd_profiler._is_profiler_enabled
    if timings is None:
        return torch.profiler.record_function(name) if on else _OFF
    return _Timed(name if on else None, timings, key)


def spanned(name: str, key: str | None = None):
    """A decorator: each call of the function inside ``span(name)``; for a
    method given ``key``, its host-clock milliseconds added to its
    object's ``timings[key]``."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kw):
            with span(name, args[0].timings if key else None, key):
                return fn(*args, **kw)
        return call
    return wrap


class _Timed:
    __slots__ = ("name", "timings", "key", "t0", "rf")

    def __init__(self, name, timings, key):
        self.name, self.timings, self.key = name, timings, key
        self.rf = None

    def __enter__(self):
        if self.name is not None:
            self.rf = torch.profiler.record_function(self.name)
            self.rf.__enter__()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        add_ms(self.timings, self.key, self.t0)
        if self.rf is not None:
            self.rf.__exit__(*exc)
        return False
