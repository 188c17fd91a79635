"""The benchmark's own encoders: ``encoders.cpp`` (a frozen copy of the
program's MSZIP, LZX and Quantum encoder entry points) built with g++ and
bound with ctypes.

The library is built at first use into ``portbench/_cache/``, named by the
sha256 of the source and the compiler flags, so every run in a checkout
after the first finds it built. Each call leaves the interpreter lock while
it encodes, so callers encode on threads.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(_HERE, "encoders.cpp")
CACHE_DIR = os.path.join(os.path.dirname(_HERE), "_cache")
FLAGS = ["-O2", "-std=c++17", "-shared", "-fPIC", "-pthread"]
FRAME = 32768

_lib = None
_lock = threading.Lock()


def library_path() -> str:
    h = hashlib.sha256(" ".join(FLAGS).encode())
    with open(SOURCE, "rb") as fh:
        h.update(fh.read())
    return os.path.join(CACHE_DIR, f"encoders_{h.hexdigest()[:16]}.so")


def lib():
    """The loaded encoder library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            so = library_path()
            if not os.path.exists(so):
                os.makedirs(CACHE_DIR, exist_ok=True)
                tmp = f"{so}.{os.getpid()}.tmp"
                r = subprocess.run(["g++", *FLAGS, SOURCE, "-o", tmp],
                                   capture_output=True, text=True)
                if r.returncode != 0:
                    raise RuntimeError(f"encoder build failed:\n{r.stderr}")
                os.replace(tmp, so)
            handle = ctypes.CDLL(so)
            P, U64, I64, I = (ctypes.c_void_p, ctypes.c_uint64,
                              ctypes.c_int64, ctypes.c_int)
            handle.msp_deflate_frames.argtypes = [P, I64, I, P, I64, P]
            handle.msp_deflate_frames.restype = I64
            handle.msp_lzx_encode.argtypes = [P, U64, I, I, I, P, U64, I, I,
                                              P, U64, P]
            handle.msp_lzx_encode.restype = I64
            handle.msp_qtm_encode.argtypes = [P, U64, I, I, P, U64, P]
            handle.msp_qtm_encode.restype = I64
            _lib = handle
    return _lib


def _frames(n: int) -> int:
    return max(1, (n + FRAME - 1) // FRAME)


def deflate_frames(data: bytes) -> list[bytes]:
    """MSZIP: one 'CK'-prefixed deflate frame per 32 KiB, history carried
    across frames."""
    nf = _frames(len(data))
    cap = len(data) + nf * 16 + 64
    out = np.empty(cap, np.uint8)
    offs = np.zeros(nf + 1, np.int64)
    r = lib().msp_deflate_frames(data, len(data), 1, out.ctypes.data, cap,
                                 offs.ctypes.data)
    if r != (nf if data else 0):
        raise RuntimeError(f"deflate encoder failed ({r})")
    return [out[offs[i]:offs[i + 1]].tobytes() for i in range(r)]


def lzx_encode(data: bytes, window_bits: int, is_delta: bool = False,
               ref: bytes = b"", block_frames: int = 32
               ) -> tuple[bytes, list[int]]:
    """One LZX stream (never reset) and the byte offset of each 32 KiB
    frame in it; each LZX block spans up to ``block_frames`` frames."""
    nf = _frames(len(data))
    cap = len(data) + 64 * nf + 4096
    out = np.empty(cap, np.uint8)
    offs = np.zeros(nf, np.uint64)
    r = lib().msp_lzx_encode(data, len(data), window_bits, 0,
                             1 if is_delta else 0, ref or None, len(ref),
                             64, block_frames, out.ctypes.data, cap,
                             offs.ctypes.data)
    if r < 0:
        raise RuntimeError(f"LZX encoder failed ({r})")
    return out[:r].tobytes(), [int(o) for o in offs]


def qtm_encode(data: bytes, window_bits: int) -> list[bytes]:
    """Quantum: one payload per 32 KiB frame (one CFDATA block each)."""
    nf = _frames(len(data))
    cap = len(data) + len(data) // 4 + 64 * nf + 4096
    out = np.empty(cap, np.uint8)
    offs = np.zeros(nf + 1, np.int64)
    r = lib().msp_qtm_encode(data, len(data), window_bits, 64,
                             out.ctypes.data, cap, offs.ctypes.data)
    if r < 0:
        raise RuntimeError(f"Quantum encoder failed ({r})")
    return [out[offs[i]:offs[i + 1]].tobytes() for i in range(r)]
