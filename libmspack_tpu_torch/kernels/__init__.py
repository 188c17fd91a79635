"""Build and load the port's CUDA kernels (K1 inflate, K2 resolve, K3 LZX).

The sources in ``libmspack_tpu_torch/csrc`` are compiled at first use by
``nvcc`` for Hopper (``sm_90a``) into one shared library with a plain C
interface, which ctypes loads. The library lives in
``libmspack_tpu_torch/_build/`` (git-ignored), named by the sha256 of the
sources, so an edit rebuilds and an unchanged tree reuses the last build.
Nothing here runs at import time: this module imports on hosts without a
CUDA toolkit, and only ``lib()`` needs one.

``host_twin()`` and ``host_twin_lzx()`` build the per-stream cores
(``deflate_core.cuh``, ``lzx_core.cuh``) with g++ instead, for the tests:
the same C++ the kernels run, on the CPU. Each twin is keyed by its own
header's sha256.
"""
from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import time

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "csrc")
BUILD_DIR = os.path.join(os.path.dirname(CSRC), "_build")

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-std=c++17", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_I64 = ctypes.c_int64

# C entry points: (argtypes) — every pointer and the stream as c_void_p
_SIGNATURES = {
    "msp_k1_inflate": [_P, _I64, _P, _P, _I, _P, _P, ctypes.c_int32, _P,
                       _I, _P],
    "msp_k2_resolve": [_P, _P, _I64, _P, _P, _P, _P, _I, _P, _P, _P],
    "msp_k3_lzx": [_P, _I64, _P, _P, _P, _I, _I, _I, _I, _P, _P, _P,
                   ctypes.c_int32, _P, _P],
}

_lib = None
build_info: dict = {}   # seconds, path and ptxas report of the last build


def _sources(patterns) -> list[str]:
    out = []
    for p in patterns:
        out.extend(sorted(glob.glob(os.path.join(CSRC, p))))
    return out


def _tag(paths) -> str:
    h = hashlib.sha256()
    for p in paths:
        h.update(os.path.basename(p).encode())
        with open(p, "rb") as fh:
            h.update(fh.read())
    return h.hexdigest()[:16]


def _compile(cmd: list[str], so: str) -> str:
    """Run a compiler into a temporary name, then move it to ``so`` (so
    concurrent builds never load a half-written library). Returns the
    compiler's stderr; raises with it on failure."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{so}.{os.getpid()}.tmp"
    r = subprocess.run(cmd + ["-o", tmp], capture_output=True, text=True)
    if r.returncode != 0:
        raise RuntimeError(f"kernel build failed: {' '.join(cmd)}\n"
                           f"{r.stderr}")
    os.replace(tmp, so)
    return r.stderr


def nvcc_path() -> str:
    cand = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(cand):
        raise RuntimeError("nvcc not found (PATH, /usr/local/cuda/bin): "
                           "the CUDA kernels cannot be built here")
    return cand


def lib():
    """The loaded kernel library, building it on first use."""
    global _lib
    if _lib is not None:
        return _lib
    srcs = _sources(["*.cu", "*.cuh"])
    so = os.path.join(BUILD_DIR, f"kernels_{_tag(srcs)}.so")
    t0 = time.perf_counter()
    log = ""
    if not os.path.exists(so):
        cus = [s for s in srcs if s.endswith(".cu")]
        log = _compile([nvcc_path()] + NVCC_FLAGS + cus, so)
    build_info.update(seconds=time.perf_counter() - t0, path=so,
                      ptxas=log)
    handle = ctypes.CDLL(so)
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(handle, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    handle.msp_cuda_error_string.argtypes = [_I]
    handle.msp_cuda_error_string.restype = ctypes.c_char_p
    handle.msp_k3_state_bytes.argtypes = []
    handle.msp_k3_state_bytes.restype = _I64
    _lib = handle
    return _lib


def _twin(header: str, define: str):
    """g++ build of one core header's host entry points (tests only).
    Raises if g++ is missing or the build fails."""
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ not found")
    src = os.path.join(CSRC, header)
    stem = header.split("_")[0]
    so = os.path.join(BUILD_DIR, f"{stem}_twin_{_tag([src])}.so")
    if not os.path.exists(so):
        _compile([gxx, "-O2", "-std=c++17", "-shared", "-fPIC",
                  f"-D{define}", "-x", "c++", src], so)
    return ctypes.CDLL(so)


def host_twin():
    """The DEFLATE core's twin: ``dc_inflate_host``, K1's launch."""
    handle = _twin("deflate_core.cuh", "DEFLATE_CORE_HOST_TWIN")
    handle.dc_inflate_host.argtypes = [_P, _I64, _P, _P, _I, _P, _P,
                                       ctypes.c_int32, _P]
    handle.dc_inflate_host.restype = ctypes.c_int
    return handle


def host_twin_lzx():
    """The LZX core's twin: ``lz_decode_host``, K3's launch, and
    ``lz_state_bytes``."""
    handle = _twin("lzx_core.cuh", "LZX_CORE_HOST_TWIN")
    handle.lz_decode_host.argtypes = _SIGNATURES["msp_k3_lzx"][:-1]
    handle.lz_decode_host.restype = ctypes.c_int
    handle.lz_state_bytes.argtypes = []
    handle.lz_state_bytes.restype = _I64
    return handle


def check(rc: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error code."""
    if rc != 0:
        msg = _lib.msp_cuda_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} at launch: {msg}")
