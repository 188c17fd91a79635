"""libmspack_tpu_torch: the PyTorch + CUDA port of libmspack_tpu.

The port decodes the same formats as ``libmspack_tpu`` (the JAX package,
which stays the reference) with the TPU kernels rewritten as hand-written
CUDA kernels for NVIDIA Hopper (``csrc/``, built by nvcc at first use).
It imports ``torch`` and never ``jax``, and nothing of ``libmspack_tpu``:
the layers it shares with the JAX package (errors, I/O, scalar codecs,
compressors, the native C++ engine, format parsing) are its own copies,
each naming the file it was copied from.

Every format the JAX package decodes has a driver here: CAB (MSZIP, LZX
and Quantum folders), CHM section 1, OAB full downloads and incremental
patches, SZDD and KWAJ; HLP and LIT are stubs, as in the reference. The
entry points run on the card unless the caller asks for the CPU::

    d = create_cab_decompressor()       # engine="cuda", device="cuda"
    cab = d.open("archive.cab")
    for f in cab.files:
        d.extract(f, f.filename)

    c = create_chm_decompressor()
    chm = c.open("help.chm")

    o = create_oab_decompressor()       # every LZX block a K3 lane
    o.decompress("udetails.oab", "udetails.out")

    s = create_szdd_decompressor()      # LZSS as device tensor ops
    s.decompress("file.ex_", "file.exe")

``device="cpu"`` runs the same pipeline on the kernels' plain PyTorch
versions; ``device="cuda"`` on a host without a GPU raises.
``engine="native"`` (or ``"auto"``) is the C++ host engine and
``engine="scalar"`` the Python codecs. ``strict=True`` (or the
environment variable ``MSPACK_TPU_STRICT``) makes the CAB, CHM and OAB
drivers raise ``FallbackError`` where a device path declines.
"""
from __future__ import annotations

from .errors import (ArgsError, ChecksumError, CrunchError, DataFormatError,
                     DecrunchError, Err, FallbackError, MSPackError,
                     OpenError, ReadError, SeekError, SignatureError,
                     WriteError)

__version__ = "0.1.0"

__all__ = ["create_cab_decompressor", "create_chm_decompressor",
           "create_oab_decompressor", "create_szdd_decompressor",
           "create_kwaj_decompressor", "version",
           "ArgsError", "ChecksumError", "CrunchError", "DataFormatError",
           "DecrunchError", "Err", "FallbackError", "MSPackError",
           "OpenError", "ReadError", "SeekError", "SignatureError",
           "WriteError"]


def version(entity: str = "library") -> int:
    """Feature-version registry (reference: system.c:16-51 mspack_version),
    the JAX package's table (``libmspack_tpu/__init__.py:30-48``).

    Returns the supported version for an entity name, 0 if unsupported.
    """
    versions = {
        "library": 2,
        "system": 1,
        "cab_decoder": 2,
        "chm_decoder": 1,
        "szdd_decoder": 1,
        "kwaj_decoder": 1,
        "oab_decoder": 2,
        # the reference returns 0 for every compressor; we implement some
        "szdd_encoder": 1,
        "kwaj_encoder": 1,
        "cab_encoder": 1,
    }
    return versions.get(entity, 0)


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


def create_oab_decompressor(engine: str = "cuda", device="cuda", **kw):
    """An OAB decompressor. ``engine="cuda"`` decodes the LZX DELTA blocks
    of a file in batches on the LZX kernel and checks their CRCs with the
    device CRC op, on ``device``."""
    from .formats.oab import OabDecompressor
    return OabDecompressor(engine=engine, device=device, **kw)


def create_szdd_decompressor(engine: str = "cuda", device="cuda", **kw):
    """An SZDD decompressor. ``engine="cuda"`` decodes LZSS with device
    tensor ops (``ops/lzss.py``) on ``device``."""
    from .formats.szdd import SzddDecompressor
    return SzddDecompressor(engine=engine, device=device, **kw)


def create_kwaj_decompressor(engine: str = "auto", **kw):
    """A KWAJ decompressor. KWAJ has no device route (the JAX package
    decodes it with the scalar codecs only), so ``"auto"``, ``"native"``
    and ``"scalar"`` all take the scalar codecs and ``"cuda"`` and
    ``"torch"`` raise ``ArgsError``."""
    from ._device import DEVICE_ENGINES, resolve_engine
    from .formats.kwaj import KwajDecompressor
    if resolve_engine(engine) in DEVICE_ENGINES:
        raise ArgsError("KWAJ has no device route: use engine='auto'")
    return KwajDecompressor(**kw)
