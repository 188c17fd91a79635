"""CAB driver with ``engine="cuda"``: MSZIP and LZX folders decode on the GPU.

Subclass of ``libmspack_tpu.formats.cab.CabDecompressor`` (the header
parsing, block reading, checksums and scalar codecs are the JAX
package's, which imports no jax for them). Under ``engine="cuda"``:

* an MSZIP or LZX folder is decoded whole on ``device`` the first time
  one of its files is extracted, and every file is served from that
  folder's bytes: MSZIP by ``CudaMszipEngine`` (K1), LZX by
  ``CudaLzxEngine`` (K3), one stream per folder since CAB LZX never
  resets (cabd.c:1249-1250). Salvage mode, fix-MSZIP mode, a file the
  reference rejects or serves without folder data, a folder whose blocks
  cannot be collected (bad checksum, missing 'CK') and a folder the
  engine declines take the scalar path, exactly as under ``engine="tpu"``;
* NONE folders take the scalar path;
* Quantum folders raise ``NotImplementedError``: their kernel is a later
  slice of the port (ROADMAP Queue 1 item 6).

Every other engine behaves as in the JAX package.
"""
from __future__ import annotations

from libmspack_tpu.formats import cab as _cab
from libmspack_tpu.system import FileSink, Sink

from .._device import resolve_device


class CabDecompressor(_cab.CabDecompressor):
    """``mscab_decompressor`` with a CUDA engine (``engine="cuda"``)."""

    def __init__(self, message=None, engine: str = "auto", device="cuda"):
        super().__init__(message=message, engine=engine)
        self.device = resolve_device(device) if self.engine == "cuda" \
            else None
        self.cuda_engine = None       # lazy CudaMszipEngine (host phase B)
        self.cuda_lzx_engine = None   # lazy CudaLzxEngine

    def extract(self, file, output) -> None:
        if self.engine != "cuda" or file is None or file.folder is None:
            return super().extract(file, output)
        ct = file.folder.comp_type & _cab.COMPTYPE_MASK
        if ct == _cab.COMPTYPE_QUANTUM:
            raise NotImplementedError(
                "engine='cuda' does not decode Quantum folders yet "
                "(ROADMAP Queue 1 item 6)")
        if (ct not in (_cab.COMPTYPE_MSZIP, _cab.COMPTYPE_LZX)
                or self.salvage
                or (ct == _cab.COMPTYPE_MSZIP and self.fix_mszip)
                or not self._served_from_folder(file)):
            return super().extract(file, output)
        data = self._folder_bytes_cuda(file.folder, ct)
        if data is None:
            return super().extract(file, output)
        self._serve(file, data, output)

    @staticmethod
    def _served_from_folder(file) -> bool:
        """True when the reference driver's checks (cab.py:591-622) all
        pass and the file has bytes: it is then a plain slice of its
        folder. Anything else goes to the base driver, which raises or
        writes the empty file as the reference does."""
        fol = file.folder
        end = file.offset + file.length
        return (fol.merge_prev is None and file.length > 0
                and end <= _cab.LENGTHMAX
                and end <= fol.num_blocks * _cab.BLOCKMAX)

    def _folder_bytes_cuda(self, fol, ct):
        """The folder's bytes through the CUDA engine of its codec, cached
        for the folder's other files; None sends it to the scalar path."""
        if self._folder_cache is not None and self._folder_cache[0] is fol:
            return self._folder_cache[1]
        from ..parallel.cuda_pipeline import CudaLzxEngine, CudaMszipEngine
        if ct == _cab.COMPTYPE_MSZIP:
            collected = self.collect_mszip_frames(fol)
            if collected is None:
                return None
            frames, sizes = collected
            if self.cuda_engine is None:
                self.cuda_engine = CudaMszipEngine(self.device)
            outs = self.cuda_engine.decode_folders(
                [([f[2:] for f in frames], sizes)])
        else:
            collected = self.collect_raw_blocks(fol)
            if collected is None:
                return None
            blocks, sizes = collected
            if self.cuda_lzx_engine is None:
                self.cuda_lzx_engine = CudaLzxEngine(self.device)
            outs = self.cuda_lzx_engine.decode_streams(
                [b"".join(blocks)], [sum(sizes)],
                (fol.comp_type >> 8) & 0x1F)
        if outs is None:
            return None
        self._folder_cache = (fol, outs[0])
        return outs[0]

    @staticmethod
    def _serve(file, data, output) -> None:
        """Write the file's slice of its folder's bytes to ``output``."""
        if file.offset + file.length > len(data):
            raise _cab.DecrunchError("file beyond decoded folder")
        sink = output if isinstance(output, Sink) else FileSink(output)
        try:
            sink.write(data[file.offset:file.offset + file.length])
        finally:
            if sink is not output and hasattr(sink, "close"):
                sink.close()
