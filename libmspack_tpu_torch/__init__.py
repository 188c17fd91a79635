"""libmspack_tpu_torch: the PyTorch + CUDA port of libmspack_tpu.

The port decodes the same formats as ``libmspack_tpu`` (the JAX package,
which stays the reference) with the TPU kernels rewritten as hand-written
CUDA kernels for NVIDIA Hopper (``csrc/``, built by nvcc at first use).
It imports ``torch`` and never ``jax``; the layers of ``libmspack_tpu``
that need no jax (codecs, compressors, native engine, format parsing,
errors) are imported from there, not copied.

Ported so far: CAB MSZIP and LZX folder decode, and CHM section 1::

    d = create_cab_decompressor(engine="cuda")          # device="cuda"
    cab = d.open("archive.cab")
    for f in cab.files:
        d.extract(f, f.filename)

    c = create_chm_decompressor(engine="cuda")
    chm = c.open("help.chm")

``device="cpu"`` runs the same pipeline on the kernels' plain PyTorch
versions; ``device="cuda"`` on a host without a GPU raises.
"""
from __future__ import annotations

from libmspack_tpu.errors import (ArgsError, ChecksumError, CrunchError,
                                  DataFormatError, DecrunchError, Err,
                                  MSPackError, OpenError, ReadError,
                                  SeekError, SignatureError, WriteError)

__all__ = ["create_cab_decompressor", "create_chm_decompressor",
           "ArgsError", "ChecksumError", "CrunchError", "DataFormatError",
           "DecrunchError", "Err", "MSPackError", "OpenError", "ReadError",
           "SeekError", "SignatureError", "WriteError"]


def create_cab_decompressor(engine: str = "auto", device="cuda", **kw):
    """A CAB decompressor. ``engine="cuda"`` decodes MSZIP and LZX folders
    with the CUDA kernels on ``device``; other engines are the JAX
    package's (``"auto"`` still means the native host engine)."""
    from .formats.cab import CabDecompressor
    return CabDecompressor(engine=engine, device=device, **kw)


def create_chm_decompressor(engine: str = "auto", device="cuda", **kw):
    """A CHM decompressor. ``engine="cuda"`` decodes section 1 with the
    LZX kernel on ``device``; other engines are the JAX package's."""
    from .formats.chm import ChmDecompressor
    return ChmDecompressor(engine=engine, device=device, **kw)
