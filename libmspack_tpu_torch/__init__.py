"""libmspack_tpu_torch: the PyTorch + CUDA port of libmspack_tpu.

The port decodes the same formats as ``libmspack_tpu`` (the JAX package,
which stays the reference) with the TPU kernels rewritten as hand-written
CUDA kernels for NVIDIA Hopper (``csrc/``, built by nvcc at first use).
It imports ``torch`` and never ``jax``, and nothing of ``libmspack_tpu``:
the layers it shares with the JAX package (errors, I/O, scalar codecs,
compressors, the native C++ engine, format parsing) are its own copies,
each naming the file it was copied from.

Ported so far: CAB MSZIP, LZX and Quantum folder decode, and CHM section
1. The entry points run on the card unless the caller asks for the CPU::

    d = create_cab_decompressor()       # engine="cuda", device="cuda"
    cab = d.open("archive.cab")
    for f in cab.files:
        d.extract(f, f.filename)

    c = create_chm_decompressor()
    chm = c.open("help.chm")

``device="cpu"`` runs the same pipeline on the kernels' plain PyTorch
versions; ``device="cuda"`` on a host without a GPU raises.
``engine="native"`` (or ``"auto"``) is the C++ host engine and
``engine="scalar"`` the Python codecs.
"""
from __future__ import annotations

from .errors import (ArgsError, ChecksumError, CrunchError, DataFormatError,
                     DecrunchError, Err, MSPackError, OpenError, ReadError,
                     SeekError, SignatureError, WriteError)

__all__ = ["create_cab_decompressor", "create_chm_decompressor",
           "ArgsError", "ChecksumError", "CrunchError", "DataFormatError",
           "DecrunchError", "Err", "MSPackError", "OpenError", "ReadError",
           "SeekError", "SignatureError", "WriteError"]


def create_cab_decompressor(engine: str = "cuda", device="cuda", **kw):
    """A CAB decompressor. ``engine="cuda"`` decodes MSZIP, LZX and
    Quantum folders with the CUDA kernels on ``device``."""
    from .formats.cab import CabDecompressor
    return CabDecompressor(engine=engine, device=device, **kw)


def create_chm_decompressor(engine: str = "cuda", device="cuda", **kw):
    """A CHM decompressor. ``engine="cuda"`` decodes section 1 with the
    LZX kernel on ``device``."""
    from .formats.chm import ChmDecompressor
    return ChmDecompressor(engine=engine, device=device, **kw)
