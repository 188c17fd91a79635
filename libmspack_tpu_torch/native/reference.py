"""The reference C library, for the port bench's baseline.

The port's copy of the build in ``tests/oracle.py:23-36``: the
reference libmspack's sources and ``oracle_shim.c`` (the port's copy of
``tests/oracle_shim.c``), compiled by gcc into ``libmspack_tpu_torch/
_build/``, named by the sources' sha256. The reference's sources are not
part of this repository: ``MSPACK_REFERENCE`` names the directory that
holds a checkout of it (with ``libmspack/mspack/*.c``). Without it,
``mspack_dir()`` is None and ``missing()`` says why; a caller then has no
reference baseline.
"""
from __future__ import annotations

import ctypes
import os
import threading

from .. import kernels

ENV = "MSPACK_REFERENCE"
_SHIM = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                     "oracle_shim.c")
_lib = None
_LOCK = threading.Lock()


def mspack_dir() -> str | None:
    """The reference's ``libmspack/mspack`` source directory, or None."""
    root = os.environ.get(ENV)
    if not root:
        return None
    path = os.path.join(root, "libmspack", "mspack")
    return path if os.path.isdir(path) else None


def missing() -> str | None:
    """Why there is no reference build here, or None when there can be."""
    if mspack_dir() is not None:
        return None
    root = os.environ.get(ENV)
    if not root:
        return f"no reference sources ({ENV} is not set)"
    return f"no reference sources ({ENV}={root} has no libmspack/mspack)"


def lib() -> ctypes.CDLL:
    """The built reference; raises where it cannot be built."""
    global _lib
    if _lib is not None:
        return _lib
    src_dir = mspack_dir()
    if src_dir is None:
        raise RuntimeError(missing())
    with _LOCK:
        if _lib is None:
            srcs = sorted(os.path.join(src_dir, f)
                          for f in os.listdir(src_dir)
                          if f.endswith(".c") and f != "debug.c")
            so = os.path.join(kernels.BUILD_DIR, "reference_"
                              f"{kernels.source_tag(srcs + [_SHIM])}.so")
            if not os.path.exists(so):
                # 64-bit off_t, as the JAX package's oracle builds it
                kernels.compile_to(
                    ["gcc", "-O2", "-fPIC", "-shared", "-I", src_dir,
                     "-DSIZEOF_OFF_T=8", "-D_FILE_OFFSET_BITS=64"]
                    + srcs + [_SHIM], so)
            handle = ctypes.CDLL(so)
            handle.oracle_cab_extract_all.argtypes = [
                ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int, ctypes.c_int]
            handle.oracle_cab_extract_all.restype = ctypes.c_int
            _lib = handle
    return _lib


def cab_extract_all(cab_path: str, outdir: str) -> int:
    """Every member of a cabinet into ``outdir`` (one thread, the
    reference's only mode); returns its error code."""
    return lib().oracle_cab_extract_all(cab_path.encode(), outdir.encode(),
                                        0, 0)
