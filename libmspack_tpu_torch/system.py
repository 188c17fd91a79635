"""Host I/O layer: the seam between archive drivers and byte storage.

The reference routes every byte through an `mspack_system` vtable
(reference: libmspack/mspack/mspack.h:285-455, system.c:104-240); tests
inject faults by overriding single vtable entries. Here the equivalent
seam is a pair of small protocols — `Source` (read/seek/tell) and `Sink`
(write) — with in-memory, file-backed, and hashing implementations.
Drivers and codecs only ever touch these, never `open()` directly, so
tests can inject failing or transforming backends the same way the
reference suite does (reference: libmspack/test/md5_fh.h:20-130).

Copied from ``libmspack_tpu/system.py`` so that the port imports nothing
of the JAX package; the copy differs in nothing else.
"""
from __future__ import annotations

import hashlib
import io
import os
from typing import Callable, Protocol, Union, runtime_checkable

from .errors import OpenError, ReadError, SeekError, WriteError


@runtime_checkable
class Source(Protocol):
    """Readable, seekable byte source."""

    def read(self, n: int = -1) -> bytes: ...
    def seek(self, pos: int, whence: int = os.SEEK_SET) -> int: ...
    def tell(self) -> int: ...


@runtime_checkable
class Sink(Protocol):
    """Writable byte sink."""

    def write(self, data: bytes) -> int: ...


PathOrBytes = Union[str, os.PathLike, bytes, bytearray, memoryview, Source]


class MemSource:
    """In-memory Source over a bytes-like object (zero-copy view)."""

    def __init__(self, data, name: str = "<memory>"):
        self._view = memoryview(data).cast("B")
        self._pos = 0
        self.name = name

    def __len__(self):
        return len(self._view)

    def read(self, n: int = -1) -> bytes:
        if n < 0:
            n = len(self._view) - self._pos
        chunk = self._view[self._pos : self._pos + n]
        self._pos += len(chunk)
        return bytes(chunk)

    def seek(self, pos: int, whence: int = os.SEEK_SET) -> int:
        if whence == os.SEEK_SET:
            new = pos
        elif whence == os.SEEK_CUR:
            new = self._pos + pos
        elif whence == os.SEEK_END:
            new = len(self._view) + pos
        else:
            raise SeekError(f"bad whence {whence}")
        if new < 0:
            raise SeekError(f"seek to {new}")
        self._pos = new
        return new

    def tell(self) -> int:
        return self._pos


class FileSource:
    """File-backed Source. Wraps errors into the MSPackError taxonomy."""

    def __init__(self, path):
        self.name = os.fspath(path)
        try:
            self._fh = open(self.name, "rb")
        except OSError as e:
            raise OpenError(f"cannot open {self.name}: {e}") from e

    def read(self, n: int = -1) -> bytes:
        try:
            return self._fh.read(n)
        except OSError as e:
            raise ReadError(str(e)) from e

    def seek(self, pos: int, whence: int = os.SEEK_SET) -> int:
        try:
            return self._fh.seek(pos, whence)
        except OSError as e:
            raise SeekError(str(e)) from e

    def tell(self) -> int:
        return self._fh.tell()

    def close(self):
        self._fh.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def open_source(obj: PathOrBytes) -> Source:
    """Coerce a path / bytes-like / Source into a Source."""
    if isinstance(obj, (bytes, bytearray, memoryview)):
        return MemSource(obj)
    if isinstance(obj, (str, os.PathLike)):
        return FileSource(obj)
    if isinstance(obj, Source):
        return obj
    raise OpenError(f"cannot open {type(obj).__name__} as a byte source")


def read_exact(src: Source, n: int) -> bytes:
    """Read exactly n bytes or raise ReadError (truncation)."""
    data = src.read(n)
    if len(data) != n:
        raise ReadError(f"wanted {n} bytes, got {len(data)}")
    return data


def read_at(src: Source, offset: int, n: int) -> bytes:
    src.seek(offset)
    return read_exact(src, n)


def source_length(src: Source) -> int:
    """Byte length of a source (reference: system.c:66-90 mspack_sys_filelen)."""
    pos = src.tell()
    end = src.seek(0, os.SEEK_END)
    src.seek(pos)
    return end


class BytesSink:
    """Accumulates written bytes in memory."""

    def __init__(self):
        self._buf = io.BytesIO()

    def write(self, data) -> int:
        return self._buf.write(data)

    def getvalue(self) -> bytes:
        return self._buf.getvalue()

    def __len__(self):
        return self._buf.getbuffer().nbytes


class FileSink:
    def __init__(self, path):
        self.name = os.fspath(path)
        try:
            self._fh = open(self.name, "wb")
        except OSError as e:
            raise OpenError(f"cannot open {self.name} for write: {e}") from e

    def write(self, data) -> int:
        try:
            return self._fh.write(data)
        except OSError as e:
            raise WriteError(str(e)) from e

    def close(self):
        self._fh.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class HashSink:
    """Hashes written bytes instead of storing them.

    The Pythonic port of the reference test backend that turns any
    write-open into an MD5 accumulator (reference: libmspack/test/md5_fh.h).
    """

    def __init__(self, algo: str = "md5"):
        self._h = hashlib.new(algo)
        self.length = 0

    def write(self, data) -> int:
        self._h.update(data)
        self.length += len(data)
        return len(data)

    def hexdigest(self) -> str:
        return self._h.hexdigest()


class NullSink:
    """Counts written bytes and discards them (skip-decode phase)."""

    def __init__(self):
        self.length = 0

    def write(self, data) -> int:
        self.length += len(data)
        return len(data)


MessageFn = Callable[[str], None]


def default_message(text: str) -> None:
    import sys

    print(text, file=sys.stderr)
