"""Error codes and exceptions for libmspack_tpu.

Mirrors the numeric error vocabulary of the reference public API
(reference: libmspack/mspack/mspack.h:484-507) so callers porting from
libmspack find the same failure taxonomy, expressed as Python exceptions.

Copied from ``libmspack_tpu/errors.py`` so that the port imports nothing
of the JAX package; the copy differs only in ``FallbackError``, the port's
strict-mode error.
"""
from __future__ import annotations

import enum


class Err(enum.IntEnum):
    """Numeric error codes, value-compatible with MSPACK_ERR_* ."""

    OK = 0
    ARGS = 1
    OPEN = 2
    READ = 3
    WRITE = 4
    SEEK = 5
    NOMEMORY = 6
    SIGNATURE = 7
    DATAFORMAT = 8
    CHECKSUM = 9
    CRUNCH = 10
    DECRUNCH = 11


class MSPackError(Exception):
    """Base exception; carries the numeric `Err` code."""

    code: Err = Err.DATAFORMAT

    def __init__(self, message: str = "", code: Err | None = None):
        super().__init__(message or self.__class__.__name__)
        if code is not None:
            self.code = Err(code)


class ArgsError(MSPackError):
    code = Err.ARGS


class OpenError(MSPackError):
    code = Err.OPEN


class ReadError(MSPackError):
    code = Err.READ


class WriteError(MSPackError):
    code = Err.WRITE


class SeekError(MSPackError):
    code = Err.SEEK


class MemoryError_(MSPackError):
    code = Err.NOMEMORY


class SignatureError(MSPackError):
    code = Err.SIGNATURE


class DataFormatError(MSPackError):
    code = Err.DATAFORMAT


class ChecksumError(MSPackError):
    code = Err.CHECKSUM


class CrunchError(MSPackError):
    code = Err.CRUNCH


class DecrunchError(MSPackError):
    code = Err.DECRUNCH


class FallbackError(DecrunchError):
    """Strict mode: a device path declined and would have handed its work
    to the host (the native engine or the scalar codecs). ``path`` names
    the device path, ``reason`` the decline."""

    def __init__(self, path: str, reason: str):
        super().__init__(f"{path} declined: {reason}")
        self.path = path
        self.reason = reason


_CODE_TO_EXC = {
    Err.ARGS: ArgsError,
    Err.OPEN: OpenError,
    Err.READ: ReadError,
    Err.WRITE: WriteError,
    Err.SEEK: SeekError,
    Err.NOMEMORY: MemoryError_,
    Err.SIGNATURE: SignatureError,
    Err.DATAFORMAT: DataFormatError,
    Err.CHECKSUM: ChecksumError,
    Err.CRUNCH: CrunchError,
    Err.DECRUNCH: DecrunchError,
}


def error_for(code: Err | int, message: str = "") -> MSPackError:
    """Build the exception matching a numeric error code."""
    code = Err(code)
    if code == Err.OK:
        raise ValueError("Err.OK is not an error")
    return _CODE_TO_EXC[code](message)
