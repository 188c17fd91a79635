"""CAB compressor / archive writer (compress path).

The reference's CAB compressor is a stub (reference: cabc.c:15-24);
this writer exceeds reference capability. Supported folder codecs:
NONE, MSZIP (zlib-deflated frames), QUANTUM (adaptive arithmetic via
qtm_e), LZX (entropy-coded via lzx_e; "lzx_stored" selects the
uncompressed-block encoder).

Layout (reference: cab.h:15-45 structure offsets):
CFHEADER + CFFOLDERs + CFFILEs + per-folder CFDATA block chains, with
the standard per-block XOR checksum.

Copied from ``libmspack_tpu/compress/cab_c.py`` so that the port imports nothing
of the JAX package; the copy differs in nothing else.
"""
from __future__ import annotations

from ..formats.cab import INPUTMAX, _checksum
from . import lzx_c, lzx_e, mszip_c, qtm_e

BLOCKMAX = 32768


def _dos_datetime(y=2026, mo=8, d=17, h=12, mi=0, s=0) -> tuple[int, int]:
    date = ((y - 1980) << 9) | (mo << 5) | d
    time = (h << 11) | (mi << 5) | (s >> 1)
    return date, time


class FolderSpec:
    def __init__(self, files: list[tuple[str, bytes]],
                 compression: str = "mszip", window_bits: int = 16,
                 intel_filesize: int = 0):
        self.files = files
        self.compression = compression
        self.window_bits = window_bits
        # LZX only: write the intel E8 header (test surface for E8
        # decode parity; the data is NOT forward-transformed)
        self.intel_filesize = intel_filesize


def _encode_folder_blocks(spec: FolderSpec) -> tuple[int, list[tuple[bytes, int]]]:
    """Returns (comp_type, [(payload, uncomp_size), ...])."""
    data = b"".join(d for _, d in spec.files)
    blocks: list[tuple[bytes, int]] = []
    if spec.compression == "none":
        comp_type = 0
        for i in range(0, len(data), BLOCKMAX):
            chunk = data[i : i + BLOCKMAX]
            blocks.append((chunk, len(chunk)))
    elif spec.compression == "mszip":
        comp_type = 1
        payloads = mszip_c.compress_frames(data)
        for i, p in enumerate(payloads):
            uncomp = min(BLOCKMAX, len(data) - i * BLOCKMAX)
            blocks.append((p, uncomp))
    elif spec.compression == "quantum":
        # one frame per CFDATA block; the reader injects the 0xFF
        # realign trailer after each block (reference: cabd.c:1327-1332)
        wb = max(10, min(spec.window_bits, 21))
        comp_type = 2 | (wb << 8)
        payloads = qtm_e.compress(data, wb)
        for i, p in enumerate(payloads):
            if len(p) > INPUTMAX:
                raise ValueError("Quantum block exceeds CAB input limit; "
                                 "use MSZIP/LZX for this data")
            uncomp = min(BLOCKMAX, len(data) - i * BLOCKMAX)
            blocks.append((p, uncomp))
    elif spec.compression in ("lzx", "lzx_stored"):
        comp_type = 3 | (spec.window_bits << 8)
        if spec.compression == "lzx":
            # CAB LZX never resets (reference: cabd.c:1249-1250)
            if spec.intel_filesize:
                stream, offsets = lzx_e.LzxEncoder(
                    spec.window_bits,
                    intel_filesize=spec.intel_filesize).compress(data)
            else:
                stream, offsets = lzx_e.compress(data, spec.window_bits)
        else:
            stream, offsets = lzx_c.compress_stored(data)
        for i, off in enumerate(offsets):
            end = offsets[i + 1] if i + 1 < len(offsets) else len(stream)
            uncomp = min(BLOCKMAX, len(data) - i * BLOCKMAX)
            blocks.append((stream[off:end], uncomp))
    else:
        raise ValueError(f"unsupported compression {spec.compression!r}")
    return comp_type, blocks


def write_cab(folders: list[FolderSpec] | None = None,
              files: list[tuple[str, bytes]] | None = None,
              compression: str = "mszip", window_bits: int = 16,
              set_id: int = 0x0622, set_index: int = 0) -> bytes:
    """Build a single complete cabinet. Either pass `folders`, or `files`
    (+compression) for a single-folder cab."""
    if folders is None:
        folders = [FolderSpec(files or [], compression, window_bits)]

    encoded = [_encode_folder_blocks(spec) for spec in folders]

    # CFFILE area
    date, time = _dos_datetime()
    cffiles = bytearray()
    for fidx, spec in enumerate(folders):
        offset = 0
        for name, data in spec.files:
            cffiles += len(data).to_bytes(4, "little")
            cffiles += offset.to_bytes(4, "little")
            cffiles += fidx.to_bytes(2, "little")
            cffiles += date.to_bytes(2, "little")
            cffiles += time.to_bytes(2, "little")
            cffiles += (0x20).to_bytes(2, "little")   # archive attribute
            cffiles += name.encode("latin-1") + b"\x00"
            offset += len(data)

    num_files = sum(len(s.files) for s in folders)
    header_size = 0x24
    folders_size = 8 * len(folders)
    file_offset = header_size + folders_size
    data_start = file_offset + len(cffiles)

    # CFDATA chains
    cfdata = bytearray()
    folder_offsets = []
    for comp_type, blocks in encoded:
        folder_offsets.append(data_start + len(cfdata))
        for payload, uncomp in blocks:
            hdr_tail = (len(payload).to_bytes(2, "little")
                        + uncomp.to_bytes(2, "little"))
            cksum = _checksum(hdr_tail, _checksum(payload, 0))
            cfdata += cksum.to_bytes(4, "little") + hdr_tail + payload

    cab_size = data_start + len(cfdata)

    out = bytearray()
    out += b"MSCF"
    out += (0).to_bytes(4, "little")
    out += cab_size.to_bytes(4, "little")
    out += (0).to_bytes(4, "little")
    out += file_offset.to_bytes(4, "little")
    out += (0).to_bytes(4, "little")
    out += bytes([3, 1])                          # version 1.3
    out += len(folders).to_bytes(2, "little")
    out += num_files.to_bytes(2, "little")
    out += (0).to_bytes(2, "little")              # flags
    out += set_id.to_bytes(2, "little")
    out += set_index.to_bytes(2, "little")
    for (comp_type, blocks), off in zip(encoded, folder_offsets):
        out += off.to_bytes(4, "little")
        out += len(blocks).to_bytes(2, "little")
        out += comp_type.to_bytes(2, "little")
    out += cffiles
    out += cfdata
    return bytes(out)
