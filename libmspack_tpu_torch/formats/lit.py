"""LIT (MS Reader eBook) driver — stub, matching reference status.

The reference declares mslit_compressor/mslit_decompressor but ships
only stubs (reference: litd.c:15-24, litc.c:15-24; des.h/sha.h are
empty placeholders reserved for the DRM decryption a LIT driver would
need). This module mirrors that status; the LZX codec LIT uses is
fully implemented in codecs/lzx.py.

Copied from ``libmspack_tpu/formats/lit.py`` so that the port imports
nothing of the JAX package; the copy differs in nothing else.
"""
from __future__ import annotations


class LitDecompressor:
    """Unimplemented, like the reference (litd.c)."""

    def __init__(self, *a, **kw):
        raise NotImplementedError(
            "LIT decompression is not implemented (reference parity: "
            "libmspack's mslit_decompressor is a stub)")


class LitCompressor:
    def __init__(self, *a, **kw):
        raise NotImplementedError(
            "LIT compression is not implemented (reference parity)")
