"""CHM driver with ``engine="cuda"``: section 1 decodes on the GPU.

Subclass of ``libmspack_tpu.formats.chm.ChmDecompressor`` (directory
parsing, the section-1 plan from ControlData and the ResetTable, and the
scalar and native paths are the JAX package's). Under ``engine="cuda"``
the whole MSCompressed section is decoded once, the first time a section-1
file is extracted, and every file is served from it, as
``_sec1_bytes_tpu`` does (``chm.py:717-761``): the ResetTable offsets cut
the LZX stream into reset-interval chunks, each a fresh LZX stream
(chmd.c:1172-1183) on one K3 lane of ``CudaLzxEngine``. The engine
declines on an intel E8 header (its state is stream-global) and on a
flagged chunk; the driver declines a section it cannot cut into chunks
(no usable plan, no reset offsets for a section longer than one interval,
chunks that do not add up to the section). Every decline is counted by
reason in the engine's ``declines``; the section then takes the
reference's own native path (``chm.py:558-561``), and the scalar path if
that fails too. The engine's trace budget, not a chunk-size limit, bounds
a launch.
"""
from __future__ import annotations

from libmspack_tpu.errors import DecrunchError, MSPackError
from libmspack_tpu.formats import chm as _chm

from .._device import resolve_device


class ChmDecompressor(_chm.ChmDecompressor):
    """``mschm_decompressor`` with a CUDA engine (``engine="cuda"``)."""

    def __init__(self, message=None, engine: str = "auto", device="cuda"):
        super().__init__(message=message, engine=engine)
        self.device = resolve_device(device) if self.engine == "cuda" \
            else None
        self.cuda_engine = None   # lazy CudaLzxEngine

    def _extract_sec1(self, d, file, sink) -> None:
        if self.engine != "cuda":
            return super()._extract_sec1(d, file, sink)
        blob = self._sec1_bytes_cuda(d)
        if blob is None:
            blob = self._sec1_bytes_native(d)
        if blob is None:
            return super()._extract_sec1(d, file, sink)   # scalar path
        if file.offset + file.length > len(blob):
            raise DecrunchError("file beyond decoded section")
        sink.write(blob[file.offset:file.offset + file.length])

    def _engine(self):
        if self.cuda_engine is None:
            from ..parallel.cuda_pipeline import CudaLzxEngine
            self.cuda_engine = CudaLzxEngine(self.device)
        return self.cuda_engine

    def _decline(self, reason):
        """Count a decline of the driver's own; returns None."""
        self._engine().declines[reason] += 1

    def _sec1_bytes_cuda(self, d):
        """The whole section through ``CudaLzxEngine``, one lane per
        reset-interval chunk, cached; None declines."""
        chm = d.chm
        if self._sec1_cache is not None and self._sec1_cache[0] is chm:
            return self._sec1_cache[1]
        try:
            plan = self._sec1_plan(d)
        except MSPackError as e:
            return self._decline(f"section-1 plan: {type(e).__name__}")
        if plan is None:
            return self._decline("no section-1 plan")
        stream, window_bits, reset_interval, reset_offsets, length = plan
        if not reset_offsets:
            if length > reset_interval:
                return self._decline("no reset offsets past one interval")
            reset_offsets = [0]
        chunks, sizes = [], []
        for i, off in enumerate(reset_offsets):
            end = (reset_offsets[i + 1] if i + 1 < len(reset_offsets)
                   else len(stream))
            size = min(reset_interval, length - i * reset_interval)
            if size <= 0:
                break
            chunks.append(stream[off:end])
            sizes.append(size)
        if sum(sizes) != length:
            return self._decline("reset table lacks chunks")
        outs = self._engine().decode_streams(chunks, sizes, window_bits,
                                             decline_on_intel=True)
        if outs is None:
            return None
        out = b"".join(outs)
        self._sec1_cache = (chm, out)
        return out
