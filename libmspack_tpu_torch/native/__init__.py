"""Native host runtime: multithreaded C++ codec engine (ctypes).

Builds lazily on first use with g++ into ``libmspack_tpu_torch/_build/``
(git-ignored), named by the source's sha256, and is rebuilt when the
source changes.

Copied from ``libmspack_tpu/native/__init__.py`` so that the port imports
nothing of the JAX package; besides the imports, the build goes to the
port's build directory, every wrapper of the JAX module is here, and
``lzx_resolve_traces`` takes one history per lane, of any length,
instead of whole-window rows.
``FolderBatch``/``mszip_folders`` (``libmspack_tpu/native/__init__.py:
166-213``), ``lzx_decode`` (``:252-266``) and ``qtm_decode`` (``:510-517``)
serve the corpus planner (``parallel/planner.py``); ``cab_walk``, the
CFDATA walk of ``cab_pipeline`` alone, serves the CAB driver's collect
(``formats/cab.py``), which the planner calls.
"""
from __future__ import annotations

import ctypes
import os
import threading

from .. import kernels

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "msp_native.cpp")

_lib = None
_build_error: str | None = None
_LOCK = threading.Lock()


def _build() -> str:
    so = os.path.join(kernels.BUILD_DIR,
                      f"msp_native_{kernels.source_tag([_SRC])}.so")
    if not os.path.exists(so):
        kernels.compile_to(["g++", "-O3", "-march=native", "-std=c++17",
                            "-shared", "-fPIC", "-pthread", _SRC], so)
    return so


def lib():
    """The loaded engine, building it if needed. Raises on failure.
    Threads may call it at once (the smoke run's encoders do): one builds
    and loads, and the library is published only with its return types
    set."""
    global _lib, _build_error
    if _lib is not None:
        return _lib
    with _LOCK:
        if _lib is not None:
            return _lib
        if _build_error:
            raise RuntimeError(_build_error)
        try:
            lib_ = ctypes.CDLL(_build())
        except Exception as e:  # remember: don't retry every call
            _build_error = f"native engine unavailable: {e}"
            raise RuntimeError(_build_error) from e
        lib_.msp_mszip_folder.restype = ctypes.c_int
        lib_.msp_mszip_folders.restype = ctypes.c_int
        lib_.msp_lzx_decode.restype = ctypes.c_int
        lib_.msp_lzx_decode_ex.restype = ctypes.c_int
        lib_.msp_lzx_many.restype = ctypes.c_int
        lib_.msp_lzx_encode.restype = ctypes.c_int64
        lib_.msp_cab_mszip_pipeline.restype = ctypes.c_int
        lib_.msp_cab_pipeline.restype = ctypes.c_int
        lib_.msp_cab_walk.restype = ctypes.c_int
        lib_.msp_cab_walk.argtypes = [
            ctypes.c_void_p, ctypes.c_uint64, ctypes.c_int64, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int32)]
        lib_.msp_qtm_decode.restype = ctypes.c_int
        lib_.msp_qtm_encode.restype = ctypes.c_int64
        lib_.msp_resolve_trace.restype = ctypes.c_int
        lib_.msp_resolve_traces.restype = ctypes.c_int
        lib_.msp_lzx_resolve_trace.restype = ctypes.c_int
        lib_.msp_lzx_resolve_traces.restype = ctypes.c_int
        lib_.msp_e8_decode.restype = None
        lib_.msp_lzss.restype = ctypes.c_int64
        _lib = lib_
    return _lib


def available() -> bool:
    try:
        lib()
        return True
    except Exception:
        return False


def default_threads() -> int:
    return max(1, os.cpu_count() or 1)


class Scratch:
    """Grow-only reusable output arena.

    First-touch page faults on the target VMs are pathologically slow
    (~200 MB/s even with THP) while warm pages write at ~9 GB/s, so
    multi-GiB buffers must be faulted once and reused — never
    reallocated per call. Views returned by get() stay valid until the
    next get() that grows the arena; callers own the lifecycle (one
    Scratch per decompressor, its folder cache is the only consumer).
    """

    __slots__ = ("_buf",)
    _GRANULE = 1 << 26  # grow in 64 MiB steps

    def __init__(self):
        self._buf = None

    def get(self, n: int):
        """A uint8[n] view over warm, reused pages."""
        import numpy as np
        if self._buf is None or self._buf.size < n:
            size = max(self._GRANULE,
                       (n + self._GRANULE - 1) // self._GRANULE
                       * self._GRANULE)
            self._buf = np.empty(size, np.uint8)
        return self._buf[:n]


def fill_from_chunks(out, chunks, sep: int | None = None) -> int:
    """Copy byte chunks back-to-back into a warm numpy arena view
    (replaces b"".join for multi-GiB staging, which would fault a fresh
    allocation). sep inserts one separator byte after every chunk
    (Quantum's 0xFF realign trailer, reference: cabd.c:1327-1332).
    Returns the total length written."""
    import numpy as np
    off = 0
    for c in chunks:
        n = len(c)
        out[off:off + n] = np.frombuffer(c, np.uint8)
        off += n
        if sep is not None:
            out[off] = sep
            off += 1
    return off


def mszip_folder_into(frames: list[bytes], sizes: list[int], out,
                      n_threads: int | None = None) -> bool:
    """Decode one MSZIP folder (deflate streams, CK stripped) into a
    caller-provided uint8 numpy view sized sum(sizes).

    False if the engine flags anything the scalar path should handle
    (exact reference error semantics)."""
    L = lib()
    n = len(frames)
    if n == 0:
        return True
    total = sum(sizes)
    ptrs = (ctypes.c_char_p * n)(*frames)
    lens = (ctypes.c_uint64 * n)(*[len(f) for f in frames])
    szs = (ctypes.c_uint32 * n)(*sizes)
    r = L.msp_mszip_folder(
        ctypes.cast(ptrs, ctypes.POINTER(ctypes.c_char_p)), lens, szs,
        n, out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        ctypes.c_uint64(total), n_threads or default_threads())
    return r == 0


def mszip_folder(frames: list[bytes], sizes: list[int],
                 n_threads: int | None = None) -> bytes | None:
    """bytes-returning convenience wrapper over mszip_folder_into."""
    import numpy as np
    total = sum(sizes)
    out = np.empty(max(total, 1), np.uint8)
    if not mszip_folder_into(frames, sizes, out, n_threads):
        return None
    return out[:total].tobytes()


class FolderBatch:
    """Pre-staged ctypes arguments for repeated decode of the same
    folder set (benchmarks / hot loops) with a reusable output buffer."""

    def __init__(self, folders: list[tuple[list[bytes], list[int]]]):
        frames_flat: list[bytes] = []
        sizes_flat: list[int] = []
        folder_offsets = [0]
        out_offsets = [0]
        for frames, sizes in folders:
            frames_flat.extend(frames)
            sizes_flat.extend(sizes)
            folder_offsets.append(len(frames_flat))
            out_offsets.append(out_offsets[-1] + sum(sizes))
        n = len(frames_flat)
        self.n_folders = len(folders)
        self.total = out_offsets[-1]
        self.out_offsets = out_offsets
        self._keepalive = frames_flat
        self.ptrs = (ctypes.c_char_p * n)(*frames_flat)
        self.lens = (ctypes.c_uint64 * n)(*[len(f) for f in frames_flat])
        self.szs = (ctypes.c_uint32 * n)(*sizes_flat)
        self.foffs = (ctypes.c_int64 * len(folder_offsets))(*folder_offsets)
        self.ooffs = (ctypes.c_int64 * len(out_offsets))(*out_offsets)
        import numpy as np
        self.out = np.zeros(max(self.total, 1), np.uint8)

    def run(self, n_threads: int | None = None) -> bool:
        """Decode into self.out; True on success."""
        L = lib()
        r = L.msp_mszip_folders(
            ctypes.cast(self.ptrs, ctypes.POINTER(ctypes.c_char_p)),
            self.lens, self.szs, self.foffs, self.n_folders,
            self.out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            self.ooffs, n_threads or default_threads())
        return r == 0

    def views(self):
        """Zero-copy per-folder views into the output buffer."""
        mv = memoryview(self.out)
        return [mv[self.out_offsets[i] : self.out_offsets[i + 1]]
                for i in range(self.n_folders)]


def mszip_folders(folders: list[tuple[list[bytes], list[int]]],
                  n_threads: int | None = None) -> list[bytes] | None:
    """Decode many folders with one thread pool. None on any failure."""
    batch = FolderBatch(folders)
    if not batch.run(n_threads):
        return None
    return [bytes(v) for v in batch.views()]


def lzss_decompress(data: bytes, mode: int = 0,
                    max_out: int | None = None) -> bytes:
    L = lib()
    cap = max(len(data) * 9 + 16, 64)
    out = ctypes.create_string_buffer(cap)
    n = L.msp_lzss(data, len(data), mode, out, cap)
    res = out.raw[: int(n)]
    if max_out is not None:
        res = res[:max_out]
    return res


def _as_ptr(buf):
    """uint8 pointer for bytes or numpy views (zero-copy)."""
    if isinstance(buf, bytes):
        return buf
    import numpy as np
    arr = buf if isinstance(buf, np.ndarray) else np.frombuffer(buf, np.uint8)
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def lzx_decode_into(stream, stream_len: int, window_bits: int,
                    reset_interval: int, out, out_len: int,
                    is_delta: bool = False,
                    ref_data: bytes | None = None) -> bool:
    """Decode one LZX stream into a caller-provided uint8 numpy view.
    stream may be bytes or a numpy view (warm-arena staging)."""
    L = lib()
    r = L.msp_lzx_decode(
        _as_ptr(stream), ctypes.c_uint64(stream_len), window_bits,
        reset_interval, ctypes.c_int64(out_len), 1 if is_delta else 0,
        ref_data, len(ref_data) if ref_data else 0,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        ctypes.c_uint64(out.nbytes))
    return r == 0


def lzx_decode(stream: bytes, window_bits: int, reset_interval: int,
               out_len: int, is_delta: bool = False,
               ref_data: bytes | None = None) -> bytes | None:
    """Decode one LZX stream (folder / CHM section / OAB block).

    Returns None when the engine flags anything needing the scalar
    path's exact reference semantics."""
    import numpy as np
    out = np.empty(max(out_len, 1), np.uint8)
    if not lzx_decode_into(stream, len(stream), window_bits,
                           reset_interval, out, out_len, is_delta,
                           ref_data):
        return None
    return out[:out_len].tobytes()


def lzx_chunks_into(stream, chunk_offsets: list[int], window_bits: int,
                    reset_frames: int, out, chunk_out_lens: list[int],
                    n_threads: int | None = None) -> tuple[bool, bool]:
    """Decode the independent reset-interval chunks of one LZX stream in
    parallel (the CHM ResetTable / checkpoint grid, SURVEY §2.4):
    chunk i is stream[chunk_offsets[i]:chunk_offsets[i+1]] and decodes
    standalone because LZX state fully resets at reset points.

    Returns (ok, intel_fired). intel_fired means a chunk saw an intel
    E8 header with nonzero filesize AND a chunk set intel_started —
    state the reference keeps stream-global (lzxd.c:707-713) — so the
    caller MUST redo the stream sequentially (lzx_decode_into) for
    bit-exact output; chunk outputs are pre-E8 bytes in that case."""
    import numpy as np
    L = lib()
    n = len(chunk_offsets)
    arr = stream if isinstance(stream, np.ndarray) \
        else np.frombuffer(stream, np.uint8)
    base = arr.ctypes.data
    total_len = arr.nbytes
    P = ctypes.POINTER(ctypes.c_uint8)
    ptrs = (P * n)()
    slens = (ctypes.c_uint64 * n)()
    for i, off in enumerate(chunk_offsets):
        end = chunk_offsets[i + 1] if i + 1 < n else total_len
        if not (0 <= off <= end <= total_len):
            return False, False
        ptrs[i] = ctypes.cast(ctypes.c_void_p(base + off), P)
        slens[i] = end - off
    wbs = (ctypes.c_int * n)(*([window_bits] * n))
    ris = (ctypes.c_int * n)(*([reset_frames] * n))
    olens = (ctypes.c_int64 * n)(*chunk_out_lens)
    ooffs = (ctypes.c_int64 * (n + 1))()
    acc = 0
    for i, ol in enumerate(chunk_out_lens):
        ooffs[i] = acc
        acc += ol
    ooffs[n] = acc
    if acc > out.nbytes:
        return False, False
    intel = (ctypes.c_int32 * (2 * n))()
    r = L.msp_lzx_many(
        ctypes.cast(ptrs, ctypes.POINTER(P)), slens, wbs, ris, olens,
        n, out.ctypes.data_as(P), ooffs, n_threads or default_threads(),
        intel)
    if r != 0:
        return False, False
    started = any(intel[2 * i] for i in range(n))
    has_fsz = any(intel[2 * i + 1] for i in range(n))
    return True, started and has_fsz


def cab_walk(cab, data_offset: int, nblocks: int, codec: int,
             block_resv: int, verify: bool = True):
    """One folder's CFDATA walk alone, with no decode: its ``nblocks``
    blocks from ``data_offset`` in the cabinet image ``cab`` (bytes or a
    uint8 numpy view). Returns (payload offsets into ``cab``, payload
    lengths, uncompressed sizes) as numpy arrays, or None where a block is
    not one the walk follows exactly: a bad checksum (``verify``), a block
    split across cabinets, one over CAB's block or input limit, one past
    the image's end, an MSZIP block (``codec`` 1) without 'CK'."""
    import numpy as np
    offs = np.empty(nblocks, np.int64)
    lens = np.empty(nblocks, np.int32)
    ulens = np.empty(nblocks, np.int32)
    r = lib().msp_cab_walk(
        _as_ptr(cab), len(cab), data_offset, nblocks, codec, block_resv,
        1 if verify else 0,
        offs.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        lens.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        ulens.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
    return None if r else (offs, lens, ulens)


def cab_pipeline(cab, data_offsets: list[int], nblocks: list[int],
                 comp_types: list[int], block_resv: int, out, stage=None,
                 verify: bool = True,
                 n_threads: int | None = None) -> list[int] | None:
    """Whole-cabinet decode for any folder codec mix (NONE / MSZIP /
    Quantum / LZX): CFDATA walk + checksum + decode in one native call,
    folder-parallel. `stage` is a warm arena for making LZX/Quantum
    inputs contiguous (compressed-size bound; len(cab) always safe).
    Returns folder output offsets (n+1) or None to fall back."""
    L = lib()
    n = len(data_offsets)
    offs = (ctypes.c_int64 * n)(*data_offsets)
    nbl = (ctypes.c_int32 * n)(*nblocks)
    cts = (ctypes.c_uint32 * n)(*comp_types)
    foffs = (ctypes.c_int64 * (n + 1))()
    if stage is None:
        stage_ptr, stage_cap = None, 0
    else:
        stage_ptr = stage.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))
        stage_cap = stage.nbytes
    r = L.msp_cab_pipeline(
        _as_ptr(cab), ctypes.c_uint64(len(cab)), offs, nbl, cts, block_resv,
        n, 1 if verify else 0,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        ctypes.c_uint64(out.nbytes), foffs, stage_ptr,
        ctypes.c_uint64(stage_cap), n_threads or default_threads())
    if r != 0:
        return None
    return list(foffs)


def cab_mszip_pipeline(cab, data_offsets: list[int], nblocks: list[int],
                       block_resv: int, out, verify: bool = True,
                       n_threads: int | None = None) -> list[int] | None:
    """Whole-cabinet MSZIP decode: CFDATA walk + checksum + two-phase
    inflate in one native call, folder-parallel with no phase barrier.

    cab is the full cabinet image (bytes or numpy view); out a uint8
    numpy arena. Returns folder output offsets (n+1 entries) or None
    when the cabinet needs the python driver's exact semantics."""
    L = lib()
    n = len(data_offsets)
    offs = (ctypes.c_int64 * n)(*data_offsets)
    nbl = (ctypes.c_int32 * n)(*nblocks)
    foffs = (ctypes.c_int64 * (n + 1))()
    r = L.msp_cab_mszip_pipeline(
        _as_ptr(cab), ctypes.c_uint64(len(cab)), offs, nbl, block_resv,
        n, 1 if verify else 0,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        ctypes.c_uint64(out.nbytes), foffs, n_threads or default_threads())
    if r != 0:
        return None
    return list(foffs)


def deflate_frames(data: bytes,
                   cross_frame_history: bool = True) -> list[bytes] | None:
    """MSZIP 'CK' frames via the native deflate encoder (the project's
    own coder: lazy hash-chain matcher + length-limited Huffman +
    stored/fixed/dynamic choice; see msp_native.cpp)."""
    import numpy as np
    try:
        L = lib()
    except RuntimeError:
        return None
    n = len(data)
    if n == 0:
        return []
    nf = (n + 32767) // 32768
    cap = n + nf * 16 + 64
    out = np.empty(cap, np.uint8)
    offs = (ctypes.c_int64 * (nf + 1))()
    r = L.msp_deflate_frames(
        data, ctypes.c_int64(n), 1 if cross_frame_history else 0,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        ctypes.c_int64(cap), offs)
    if r != nf:
        return None
    return [out[offs[i]:offs[i + 1]].tobytes() for i in range(nf)]


def lzx_encode(data: bytes, window_bits: int, reset_interval: int = 0,
               is_delta: bool = False, ref_data: bytes = b"",
               max_chain: int = 64,
               block_frames: int = 32) -> tuple[bytes, list[int]] | None:
    """Entropy-encode one LZX stream (native port of compress/lzx_e).

    Returns (stream, per-frame byte offsets) or None on failure."""
    import numpy as np
    L = lib()
    nframes = max(1, (len(data) + 32767) // 32768)
    cap = len(data) + 64 * nframes + 4096
    out = np.empty(cap, np.uint8)
    offs = (ctypes.c_uint64 * nframes)()
    r = L.msp_lzx_encode(
        data, ctypes.c_uint64(len(data)), window_bits, reset_interval,
        1 if is_delta else 0, ref_data or None,
        ctypes.c_uint64(len(ref_data)), max_chain, block_frames,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        ctypes.c_uint64(cap), offs)
    if r < 0:
        return None
    return out[: int(r)].tobytes(), list(offs)


def qtm_decode_into(stream, stream_len: int, window_bits: int, out,
                    out_len: int) -> bool:
    """Decode one Quantum stream (0xFF block trailers included) into a
    caller-provided uint8 numpy view."""
    L = lib()
    r = L.msp_qtm_decode(_as_ptr(stream), ctypes.c_uint64(stream_len),
                         window_bits, ctypes.c_int64(out_len),
                         out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                         ctypes.c_uint64(out.nbytes))
    return r == 0


def qtm_decode(stream: bytes, window_bits: int, out_len: int) -> bytes | None:
    """Decode one Quantum stream (CAB folder with 0xFF block trailers)."""
    import numpy as np
    out = np.empty(max(out_len, 1), np.uint8)
    if not qtm_decode_into(stream, len(stream), window_bits, out, out_len):
        return None
    return out[:out_len].tobytes()


def qtm_encode(data: bytes, window_bits: int,
               max_chain: int = 64) -> list[bytes] | None:
    """Encode one Quantum stream (native port of compress/qtm_e).
    Returns per-frame payloads (one CAB CFDATA block each) or None."""
    import numpy as np
    L = lib()
    nframes = max(1, (len(data) + 32767) // 32768)
    # worst case ~8.3 bits/byte on the adaptive models + per-frame slack
    cap = len(data) + len(data) // 4 + 64 * nframes + 4096
    out = np.empty(cap, np.uint8)
    offs = (ctypes.c_int64 * (nframes + 1))()
    r = L.msp_qtm_encode(
        data, ctypes.c_uint64(len(data)), window_bits, max_chain,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        ctypes.c_uint64(cap), offs)
    if r < 0:
        return None
    return [out[offs[i] : offs[i + 1]].tobytes() for i in range(int(r))]


def lzx_resolve_traces(tok, litw, out_lens: list[int],
                       iflags: list[int], ifszs: list[int],
                       window_bits: int, out, out_offsets: list[int],
                       n_threads: int | None = None,
                       hists=None, e8_bases: list[int] | None = None
                       ) -> int:
    """Phase B for the LZX TPU entropy kernel: resolve per-lane token
    traces (ops/pallas_lzx.py format) into bytes + E8 untransform.

    tok/litw: contiguous (n_lanes, T) int32 arrays (device trace
    transposed). Each lane is an independent stream (CAB folder / CHM
    reset chunk / OAB block); distances may reach into a 2^window_bits
    zero prefix, or, with hists (one bytes-like per lane: DELTA reference
    data or a previous segment's window tail), into a prefix as long as
    the longest of them, each lane's at its end (the port's change: the
    JAX package's hists is one whole-window row per lane).
    iflags/ifszs: per-lane intel-E8 header flag and filesize (kernel
    counts rows 4/5). Returns 0 on success.
    """
    import numpy as np
    L = lib()
    n = len(out_lens)
    ol = (ctypes.c_uint32 * n)(*out_lens)
    ifl = (ctypes.c_int32 * n)(*iflags)
    ifs = (ctypes.c_int32 * n)(*ifszs)
    ooff = (ctypes.c_int64 * (n + 1))(*out_offsets)
    assert tok.dtype == np.int32 and tok.flags.c_contiguous
    assert litw.dtype == np.int32 and litw.flags.c_contiguous
    assert litw.shape == tok.shape
    P = ctypes.POINTER(ctypes.c_uint8)
    hptr = hlen = None
    prefix = 1 << window_bits
    if hists is not None:
        rows = [np.ascontiguousarray(np.frombuffer(h, np.uint8)
                                     if not isinstance(h, np.ndarray)
                                     else h, np.uint8) for h in hists]
        assert len(rows) == n and all(r.ndim == 1 for r in rows)
        prefix = min(prefix, max([1] + [r.size for r in rows]))
        hptr = (P * n)(*[r.ctypes.data_as(P) for r in rows])
        hlen = (ctypes.c_uint32 * n)(*[r.size for r in rows])
    eptr = None
    if e8_bases is not None:
        eptr = (ctypes.c_int64 * n)(*e8_bases)
    return L.msp_lzx_resolve_traces(
        tok.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        litw.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        ctypes.c_int64(tok.shape[1]), ctypes.c_int64(tok.shape[1]),
        ol, ifl, ifs, ctypes.c_int(n),
        ctypes.c_uint32(prefix),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), ooff,
        ctypes.c_int(n_threads or default_threads()), hptr, hlen, eptr)


def e8_decode_buf(buf, ifsz: int, base: int = 0) -> None:
    """In-place E8 untransform over a decoded uint8 numpy buffer."""
    import numpy as np
    L = lib()
    assert buf.dtype == np.uint8 and buf.flags.c_contiguous
    L.msp_e8_decode(buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                    ctypes.c_uint64(buf.size), ctypes.c_int32(ifsz),
                    ctypes.c_int64(base))


def resolve_traces(tok, litw, folder_lane0: list[int],
                   folder_nframes: list[int], sizes: list[int],
                   out, out_offsets: list[int],
                   n_threads: int | None = None) -> int:
    """Phase B for the TPU entropy kernel: resolve (lane, step) token
    traces (ops/pallas_inflate.py format) into folder bytes.

    tok/litw: contiguous int32 numpy arrays of shape (n_lanes, T)
    (i.e. the device output transposed so each lane's trace is one
    row). sizes is the flat per-frame output-size list, folder f's
    frames at sizes[sum(folder_nframes[:f]):...]. out is a uint8 numpy
    arena; out_offsets has n_folders+1 entries. Returns 0 on success.
    """
    import numpy as np
    L = lib()
    n_folders = len(folder_lane0)
    l0 = (ctypes.c_int32 * n_folders)(*folder_lane0)
    nf = (ctypes.c_int32 * n_folders)(*folder_nframes)
    sz = (ctypes.c_uint32 * len(sizes))(*sizes)
    soff = []
    acc = 0
    for n in folder_nframes:
        soff.append(acc)
        acc += n
    soffs = (ctypes.c_int64 * n_folders)(*soff)
    ooff = (ctypes.c_int64 * (n_folders + 1))(*out_offsets)
    assert tok.dtype == np.int32 and tok.flags.c_contiguous
    assert litw.dtype == np.int32 and litw.flags.c_contiguous
    assert litw.shape == tok.shape
    return L.msp_resolve_traces(
        tok.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        litw.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        ctypes.c_int64(tok.shape[1]), ctypes.c_int64(tok.shape[1]),
        l0, nf, sz, soffs, n_folders,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), ooff,
        n_threads or default_threads())
