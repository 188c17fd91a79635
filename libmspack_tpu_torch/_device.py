"""The explicit device and engine of the port's entry points."""
from __future__ import annotations

import torch

from .errors import ArgsError

ENGINES = ("cuda", "native", "scalar")


def resolve_device(device) -> torch.device:
    """``torch.device(device)``, refused where it cannot run: a CUDA device
    on a host without one raises instead of carrying on on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested but "
                           "torch.cuda.is_available() is False")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}: use cuda or cpu")
    return dev


def resolve_engine(engine: str) -> str:
    """A driver's engine: ``"cuda"``, ``"native"`` or ``"scalar"``;
    ``"auto"`` is the native host engine when it builds, else
    ``"scalar"``. The JAX package's ``"jax"`` and ``"tpu"`` engines are
    not ported (ROADMAP.md, Queue 1) and raise ``ArgsError``."""
    if engine == "auto":
        from . import native
        return "native" if native.available() else "scalar"
    if engine not in ENGINES:
        raise ArgsError(f"engine {engine!r} is not in the port: use one of "
                        f"{ENGINES} or 'auto' (ROADMAP.md, Queue 1)")
    return engine
