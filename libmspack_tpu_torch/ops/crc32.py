"""CRC-32 as a GF(2) product on the device.

PyTorch counterpart of ``libmspack_tpu/ops/crc32.py`` (``crc32_device``,
``crc32_device_batch``), which XLA computes outside any Pallas kernel; here
``torch.matmul`` does the same. CRC is GF(2)-linear: with a zero register
(``crc0``), ``crc0(a || b) = A^|b| crc0(a) XOR crc0(b)``, where ``A`` advances
the register by one zero byte (reference: crc32.h:9-15; the register is raw,
init 0xFFFFFFFF and no final inversion, as OAB stores it, oabd.c:197).

* **Layout.** A block ``data`` with register ``init`` becomes whole chunks
  of C bytes: zeros, the 4 bytes ``u`` with ``crc0(u) = init``, then the
  data, so that ``crc(init, data) = crc0(zeros || u || data)`` (leading
  zeros leave a zero register at zero). No block needs a scalar tail.
* **Product.** A chunk's ``crc0`` is the parity of ``bits(chunk) @ P``, P
  ``(8C, 32)`` of 0/1, taken as eight products ``(N, C) @ (C, 32)``, one per
  bit plane, so the float copy of the data is 4 bytes a byte. Every count
  is at most 8C = 32768 < 2^24 and every input 0 or 1, so fp32 products
  and sums are exact whether or not TF32 or bf16 inputs are allowed
  (``torch.backends.cuda.matmul``): both hold 0 and 1 exactly and
  accumulate in fp32.
* **Combine.** A block's CRC is the XOR over its chunks j of
  ``A_C^p_j crc0(chunk_j)``, p_j the chunks after j: the powers
  ``A_C^(2^l)`` apply for the bits of p_j (log2 of the longest block's
  chunks steps of an ``(N, 32) @ (32, 32)`` product), then a segment sum
  of the bits per block (``index_add_``) and its parity. All on the device;
  4 bytes a block come back.

``P`` and the powers are made once per chunk size and process (``P`` by
the table recurrence of a zero byte, not by 8C CRCs), ``u`` once per init.

``crc32_raw`` is the host CRC (zlib) that the OAB driver checks each block
with: its bytes are on the host after host phase B, where zlib is quicker
than a copy to the card and the product (PERF.md). The device op waits for
a path that leaves the bytes on the card (ROADMAP Queue 1).
"""
from __future__ import annotations

import time
import zlib

import numpy as np
import torch

from .._device import resolve_device

CHUNK = 4096
ROWS = 4096          # chunks per product slice: 64 MiB of fp32 bit plane
_TABLE: np.ndarray | None = None
_MATS: dict = {}     # (chunk bytes, device) -> (P planes, [A_C^(2^l)^T])
_U: dict[int, bytes] = {}

__all__ = ["crc32_raw", "crc32_device", "crc32_device_batch", "crc32_blocks",
           "CHUNK"]


def crc32_raw(data: bytes, crc: int = 0xFFFFFFFF) -> int:
    """CRC-32 on the host, with initial value and NO final inversion
    (reference: crc32.h:9-15, oabd.c:197 starts at 0xffffffff)."""
    return (zlib.crc32(data, crc ^ 0xFFFFFFFF)) ^ 0xFFFFFFFF


def _table() -> np.ndarray:
    """The reflected CRC-32 table: crc0 of each single byte."""
    global _TABLE
    if _TABLE is None:
        t = np.arange(256, dtype=np.uint32)
        for _ in range(8):
            t = np.where(t & 1, (t >> 1) ^ np.uint32(0xEDB88320), t >> 1)
        _TABLE = t.astype(np.uint32)
    return _TABLE


def _bits(v) -> np.ndarray:
    """The 32 bits of each uint32 of ``v`` as float32 ``(..., 32)``."""
    v = np.asarray(v, np.uint32)
    return ((v[..., None] >> np.arange(32, dtype=np.uint32)) & 1) \
        .astype(np.float32)


def _gf2_square(m: np.ndarray) -> np.ndarray:
    return (m.astype(np.int64) @ m.astype(np.int64)) & 1


def _matrices(chunk_bytes: int, device: torch.device, levels: int):
    """(P as float32 ``(8, C, 32)``: P[k, b] = the bits of crc0 of a C-byte
    chunk whose only set bit is bit k of byte b; the transposed powers
    ``A_C^(2^l)`` for l < ``levels``, float32 ``(32, 32)``), on ``device``,
    cached."""
    key = (chunk_bytes, str(device))
    if key not in _MATS:
        t = _table()
        rows = np.empty((chunk_bytes, 8), np.uint32)
        reg = t[1 << np.arange(8)]         # the bit in the last byte
        for b in range(chunk_bytes - 1, -1, -1):
            rows[b] = reg
            reg = (reg >> 8) ^ t[reg & 0xFF]   # one more zero byte after
        p = _bits(rows).transpose(1, 0, 2)     # (8, C, 32)
        # A_C: column k is the register 1 << k after C zero bytes
        zeros = bytes(chunk_bytes)
        m = _bits([crc32_raw(zeros, 1 << k) for k in range(32)]).T
        _MATS[key] = (torch.from_numpy(np.ascontiguousarray(p)).to(device),
                      [m.astype(np.int64)], [])
    p, host, dev = _MATS[key]
    while len(host) < levels:
        host.append(_gf2_square(host[-1]))
    while len(dev) < levels:
        dev.append(torch.from_numpy(
            np.ascontiguousarray(host[len(dev)].T.astype(np.float32)))
            .to(device))
    return p, dev[:levels]


def init_prefix(init: int) -> bytes:
    """The 4 bytes u with crc0(u) = ``init``, so that crc(init, data) =
    crc0(u || data): the GF(2) system of the 32 unit messages, solved."""
    init &= 0xFFFFFFFF
    if init not in _U:
        cols = [crc32_raw((1 << j).to_bytes(4, "little"), 0)
                for j in range(32)]
        # Gaussian elimination on rows (column bits | unit j) over GF(2)
        rows = [(cols[j], 1 << j) for j in range(32)]
        basis: dict[int, tuple[int, int]] = {}
        for v, u in rows:
            for bit in range(31, -1, -1):
                if not (v >> bit) & 1:
                    continue
                if bit in basis:
                    bv, bu = basis[bit]
                    v, u = v ^ bv, u ^ bu
                else:
                    basis[bit] = (v, u)
                    break
        v, u = init, 0
        for bit in range(31, -1, -1):
            if (v >> bit) & 1:
                bv, bu = basis[bit]
                v, u = v ^ bv, u ^ bu
        _U[init] = u.to_bytes(4, "little")
    return _U[init]


def _crc_chunks(chunks, nchunks, timings=None):
    """CRC of each block laid out as consecutive chunk rows: ``chunks``
    uint8 ``(N, C)`` on the device, ``nchunks`` the rows of each block (a
    host list). Returns int64 ``(B,)`` on the device."""
    dev = chunks.device
    n, c = chunks.shape
    levels = max(1, max(nchunks, default=1) - 1).bit_length()
    p, powers = _matrices(c, dev, levels)
    marks = _Marks(dev, timings)
    bits = torch.empty((n, 32), dtype=torch.float32, device=dev)
    for s in range(0, n, ROWS):
        part = chunks[s:s + ROWS]
        acc = torch.zeros((part.shape[0], 32), dtype=torch.float32,
                          device=dev)
        for k in range(8):
            acc += ((part >> k) & 1).to(torch.float32) @ p[k]
        bits[s:s + ROWS] = (acc.to(torch.int32) & 1).to(torch.float32)
    marks.lap("crc_product_ms")
    counts = torch.tensor(nchunks, dtype=torch.int64).to(dev)
    owner = torch.repeat_interleave(
        torch.arange(len(nchunks), device=dev), counts)
    after = torch.cumsum(counts, 0)[owner] - 1 - \
        torch.arange(n, device=dev)
    for lvl, mt in enumerate(powers):
        moved = torch.remainder(bits @ mt, 2)
        bits = torch.where(((after >> lvl) & 1).bool()[:, None], moved, bits)
    sums = torch.zeros((len(nchunks), 32), dtype=torch.float32, device=dev)
    sums.index_add_(0, owner, bits)
    crc = ((sums.to(torch.int64) & 1)
           << torch.arange(32, device=dev)).sum(1)
    marks.lap("crc_combine_ms")
    return crc


class _Marks:
    """Adds the time since the last mark to ``timings[name]``: CUDA events
    on the card (synchronised at each mark), the host clock on the CPU;
    nothing when ``timings`` is None."""

    def __init__(self, device, timings):
        self.timings, self.device = timings, device
        self.last = self._now()

    def _now(self):
        if self.timings is None:
            return None
        if self.device.type == "cuda":
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            return ev
        return time.perf_counter()

    def lap(self, name):
        if self.timings is None:
            return
        now = self._now()
        if self.device.type == "cuda":
            now.synchronize()
            ms = self.last.elapsed_time(now)
        else:
            ms = (now - self.last) * 1e3
        self.timings[name] = self.timings.get(name, 0.0) + ms
        self.last = now


def _layout(blocks, inits, chunk_bytes, pinned: bool):
    """Host layout of ``blocks`` (bytes-like) with their registers: a uint8
    tensor ``(N, C)`` (in page-locked memory when ``pinned``, so that it
    crosses to the card at the link's rate) and the chunk rows of each
    block."""
    m = [(len(b) + 4 + chunk_bytes - 1) // chunk_bytes for b in blocks]
    out = torch.empty((sum(m), chunk_bytes), dtype=torch.uint8,
                      pin_memory=pinned)
    arr = out.numpy()
    row = 0
    for b, init, k in zip(blocks, inits, m):
        region = arr[row:row + k].reshape(-1)
        pad = k * chunk_bytes - len(b) - 4
        region[:pad] = 0
        region[pad:pad + 4] = np.frombuffer(init_prefix(init), np.uint8)
        region[pad + 4:] = np.frombuffer(b, np.uint8)
        row += k
    return out, m


def crc32_blocks(blocks, device="cuda", init: int = 0xFFFFFFFF,
                 chunk_bytes: int = CHUNK, timings=None) -> list[int]:
    """The raw CRC-32 of each host block (bytes-like), all in one product
    on ``device``. ``timings``: a dict that gains ``crc_upload_ms`` (the
    layout and its copy to the device), ``crc_product_ms`` and
    ``crc_combine_ms``."""
    dev = resolve_device(device)
    if not blocks:
        return []
    marks = _Marks(dev, timings)
    host, m = _layout(blocks, [init] * len(blocks), chunk_bytes,
                      dev.type == "cuda")
    chunks = host.to(dev, non_blocking=True)
    marks.lap("crc_upload_ms")
    return [int(v) for v in _crc_chunks(chunks, m, timings).cpu()]


def crc32_device(data, init: int = 0xFFFFFFFF, chunk_bytes: int = CHUNK,
                 device="cuda") -> int:
    """Bit-exact raw CRC-32 of ``data`` (bytes-like) computed on
    ``device``."""
    return crc32_blocks([data], device, init, chunk_bytes)[0]


def crc32_device_batch(blocks, chunk_bytes: int = CHUNK):
    """Raw CRC-32 (init 0xFFFFFFFF) of each whole row of a uint8 ``(B, S)``
    tensor, where it lies (the JAX op's rows are whole blocks too; its
    ``lengths`` is unused). Returns int64 ``(B,)`` (values below 2^32) on
    the rows' device."""
    dev = blocks.device
    b, s = blocks.shape
    m = (s + 4 + chunk_bytes - 1) // chunk_bytes
    chunks = torch.zeros((b, m * chunk_bytes), dtype=torch.uint8, device=dev)
    chunks[:, m * chunk_bytes - s - 4:m * chunk_bytes - s] = torch.tensor(
        list(init_prefix(0xFFFFFFFF)), dtype=torch.uint8, device=dev)
    chunks[:, m * chunk_bytes - s:] = blocks
    return _crc_chunks(chunks.reshape(b * m, chunk_bytes), [m] * b)
