"""The explicit device, engine and strict mode of the port's entry points."""
from __future__ import annotations

import os

import torch

from .errors import ArgsError, FallbackError

ENGINES = ("cuda", "torch", "native", "scalar")
# the engines that decode on a device (and take the drivers' ``device``)
DEVICE_ENGINES = ("cuda", "torch")


def strict_mode(strict=None) -> bool:
    """A driver's strict mode: ``strict`` when given, else whether the
    environment variable ``MSPACK_TPU_STRICT`` is set to a non-empty value
    (the reference's switch, ``libmspack_tpu/formats/cab.py:225-229``)."""
    if strict is None:
        return bool(os.environ.get("MSPACK_TPU_STRICT"))
    return bool(strict)


def reason_text(reasons) -> str:
    """``reasons`` as text: a string as it is, a mapping of reason to count
    (as an engine's ``declines`` holds them) as "reason xN, ..."."""
    if isinstance(reasons, str):
        return reasons
    return ", ".join(f"{r} x{n}" if n > 1 else r
                     for r, n in sorted(reasons.items()))


def note_fallback(driver, path: str, reasons) -> None:
    """Record that the device path ``path`` of ``driver`` declined, for
    ``reasons`` (``reason_text``'s argument):
    ``driver.fallback_reasons[path]`` becomes ``"FallbackError:
    <message>"``, as the reference's ``{path: "Exc: msg"}``; under
    ``driver.strict`` the ``FallbackError`` is raised."""
    exc = FallbackError(path, reason_text(reasons) or "declined")
    driver.fallback_reasons[path] = f"{type(exc).__name__}: {exc}"
    if driver.strict:
        raise exc


def new_declines(engine, before) -> dict:
    """The declines ``engine`` counted since ``before`` (a copy of its
    ``declines`` taken earlier), by reason."""
    return {r: n - before.get(r, 0) for r, n in engine.declines.items()
            if n > before.get(r, 0)}


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


# the JAX package's engine names -> the port's
_PORT_NAMES = {"jax": "torch", "tpu": "cuda"}


def resolve_engine(engine: str) -> str:
    """A driver's engine: ``"cuda"`` (the hand-written kernels),
    ``"torch"`` (the JAX package's ``"jax"`` engine as PyTorch tensor
    ops), ``"native"`` or ``"scalar"``; ``"auto"`` is the native host
    engine when it builds, else ``"scalar"``. The JAX package's names
    ``"jax"`` and ``"tpu"`` raise ``ArgsError`` naming the port's
    ``"torch"`` and ``"cuda"``."""
    if engine == "auto":
        from . import native
        return "native" if native.available() else "scalar"
    if engine in _PORT_NAMES:
        raise ArgsError(f"engine {engine!r} is the JAX package's name: the "
                        f"port calls it {_PORT_NAMES[engine]!r}")
    if engine not in ENGINES:
        raise ArgsError(f"engine {engine!r} is not in the port: use one of "
                        f"{ENGINES} or 'auto'")
    return engine
