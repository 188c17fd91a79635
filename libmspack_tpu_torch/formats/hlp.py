"""HLP (Windows Help) driver — stub, matching reference status.

The reference declares the mshlp_compressor/mshlp_decompressor API but
ships only `/* todo */` stubs returning NULL (reference: hlpd.c:15-24,
hlpc.c:15-24, system.c:39-48 returns version 0 for HLPD/HLPC).
This module mirrors that: the API exists, constructors raise, and
`libmspack_tpu.version("hlp_decoder") == 0`.

The underlying LZSS codec HLP needs (MSHELP mode: inverted control
bytes) IS implemented — codecs/lzss.py MODE_MSHELP / ops/lzss_jax.py —
so a future driver only needs the .HLP container walk (|TOPIC blocks).

Copied from ``libmspack_tpu/formats/hlp.py`` so that the port imports
nothing of the JAX package; the copy differs in nothing else (the port's
``version("hlp_decoder")`` is 0 too, and its LZSS device path is
``ops/lzss.py``).
"""
from __future__ import annotations


class HlpDecompressor:
    """Unimplemented, like the reference (hlpd.c)."""

    def __init__(self, *a, **kw):
        raise NotImplementedError(
            "HLP decompression is not implemented (reference parity: "
            "libmspack's mshlp_decompressor is a stub)")


class HlpCompressor:
    def __init__(self, *a, **kw):
        raise NotImplementedError(
            "HLP compression is not implemented (reference parity)")
