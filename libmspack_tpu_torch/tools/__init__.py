"""The probe tools P1-P6: the port of ``tools/micro_*.py`` and
``tools/mosaic_probe.py``.

On the TPU each tool timed one mechanism that a per-lane decoder is built
from: a table search, a stream refill, a token copy machine, a gather, a
compiler construct. Each module here keeps its tool's name and printed
lines, and runs its probes as hand-written CUDA kernels
(``csrc/probes_*.cu``, one file per tool, in the library that
``kernels.lib()`` builds)::

    python -m libmspack_tpu_torch.tools.micro_vec      # P1
    python -m libmspack_tpu_torch.tools.micro_skel     # P2 [L] [steps]
    python -m libmspack_tpu_torch.tools.micro_copy     # P3
    python -m libmspack_tpu_torch.tools.mosaic_probe   # P4 [name ...]
    python -m libmspack_tpu_torch.tools.micro_gather   # P5
    python -m libmspack_tpu_torch.tools.micro_gather2  # P6 [all|mask|sym|xla]

Each probe is a function on tensors with an explicit ``device``: the card,
unless ``device="cpu"`` asks for its plain PyTorch version (as the tests
do). ``device="cuda"`` without a GPU raises, and a kernel that fails to
build or launch raises: nothing falls back. Each module's ``main()`` runs
its tool's own shapes, prints, and returns one ``Record`` per run, which
``chip_smoke.py`` holds against the plain version. Inputs are made with
numpy from a seed.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np
import torch

from .. import kernels
from .._device import resolve_device


@dataclass
class Record:
    """One kernel run of a tool's ``main()``."""

    kernel: str       # its key in the module's LAUNCHES
    label: str        # the run's shape
    ms: float         # per call: CUDA events on the card, host clock on CPU
    out: torch.Tensor                   # the result, on the CPU
    plain: Callable[[], torch.Tensor]   # the plain version, CPU inputs
    nbytes: int       # the input elements this run's data needs (a
    #                   gather: the gathered ones), read once, and the
    #                   outputs, written once
    chain: int        # dependent steps within one lane (see Work)
    library_ms: Optional[float] = None  # one PyTorch call of the same
    #                                     function, where there is one
    edge: bool = False  # a run on an edge input: held to the plain
    #                     version, not the kernel's time at the tool's shape


class Work:
    """What a plain version's run needed, lane by lane, for a probe's
    bound: the table entries it read, each counted once however often it
    was read, and each lane's chain of dependent steps. An indexed load or
    an ALU stage is one step, a search over n values a tree of depth
    log2 n, and a loop that ends early counts only as far as the run's
    data took it. Tables are ``(rows, L)``, lane l in column l."""

    def __init__(self, lanes: int):
        self.masks: dict[str, torch.Tensor] = {}
        self.steps = torch.zeros(lanes, dtype=torch.int64)

    def read(self, name: str, table: torch.Tensor, rows, where=None):
        """Lane l read ``table[rows[l], l]`` (``rows`` an int or one per
        lane), on the lanes ``where`` is true (all if None)."""
        mask = self.masks.setdefault(
            name, torch.zeros(table.shape, dtype=torch.bool))
        lanes = torch.arange(table.shape[1])
        rows = torch.as_tensor(rows).expand(lanes.shape)
        if where is not None:
            rows, lanes = rows[where], lanes[where]
        mask[rows, lanes] = True

    def add(self, steps) -> None:
        """Lengthen each lane's chain by ``steps`` (an int or one per
        lane)."""
        self.steps += steps

    def nbytes(self) -> int:
        """4 bytes for each table entry read."""
        return 4 * sum(int(m.sum()) for m in self.masks.values())

    def chain(self) -> int:
        """The longest lane's dependent steps."""
        return int(self.steps.max())


def tensor(a) -> torch.Tensor:
    """A numpy array as a CPU tensor, uint32 words as int32 bits."""
    a = np.ascontiguousarray(a)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(a)


def int32(t: torch.Tensor, name: str, shape=None) -> torch.Tensor:
    """``t`` as a contiguous int32 tensor (uint32 words reinterpreted);
    raises on another dtype or, given ``shape``, another shape."""
    if t.dtype == torch.uint32:
        t = t.view(torch.int32)
    if t.dtype != torch.int32:
        raise ValueError(f"{name} must be int32 or uint32, not {t.dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, not "
                         f"{tuple(t.shape)}")
    return t.contiguous()


def on(device, *tensors):
    """``(torch.device, the tensors moved there)``; a CUDA device on a host
    without one raises."""
    dev = resolve_device(device)
    return dev, [t.to(dev) for t in tensors]


# Launches recorded into a CUDA graph while it is captured, as (counts,
# name): a capture runs nothing, so ``timing.time_ms`` counts them on each
# replay of the graph instead.
CAPTURED: list = []


def launch(counts: dict, name: str, entry: str, dev: torch.device,
           *args) -> None:
    """Call the kernel library's C entry point ``entry`` on the current
    stream of ``dev``, raise on a CUDA error, and count one launch of
    ``name`` (under graph capture, one on each replay)."""
    lib = kernels.lib()
    with torch.cuda.device(dev):
        rc = getattr(lib, entry)(*args,
                                 torch.cuda.current_stream().cuda_stream)
        capturing = torch.cuda.is_current_stream_capturing()
    kernels.check(rc, name)
    if capturing:
        CAPTURED.append((counts, name))
    else:
        counts[name] += 1


def wrap32(x: torch.Tensor) -> torch.Tensor:
    """An int64 tensor as int32, wrapping as int32 arithmetic does."""
    return ((x + (1 << 31)) % (1 << 32) - (1 << 31)).to(torch.int32)


def log2c(n: int) -> int:
    """Depth of a reduction tree over ``n`` values."""
    return max(1, math.ceil(math.log2(n)))
