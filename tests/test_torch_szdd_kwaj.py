"""SZDD, KWAJ, HLP and LIT through the port's drivers, held to the JAX
package's.

SZDD files (normal and QBasic) come from ``lzss_c``; the port's
``engine="cuda"`` runs its LZSS tensor ops (``ops/lzss.py``) on
``device="cpu"``, beside ``"native"`` and ``"scalar"``. KWAJ files are
built by hand here, one per compression method (none, xor, SZDD-LZSS, LZH,
MSZIP) with every optional header field. Tolerance: exact — equal bytes
and header fields to the JAX driver, on whole and on truncated streams.
The HLP and LIT stubs raise as the JAX stubs do, and ``version()`` gives
the JAX package's table.
"""
import numpy as np
import pytest

import libmspack_tpu as jax_pkg
from libmspack_tpu.formats import hlp as jax_hlp
from libmspack_tpu.formats import lit as jax_lit
from libmspack_tpu.formats.kwaj import KwajDecompressor as JaxKwaj
from libmspack_tpu.formats.szdd import SzddDecompressor as JaxSzdd
from libmspack_tpu.ops import lzss_jax

import chip_smoke
import libmspack_tpu_torch as lt
from libmspack_tpu_torch.codecs import lzss
from libmspack_tpu_torch.compress import lzss_c, mszip_c
from libmspack_tpu_torch.formats import hlp, lit, szdd
from libmspack_tpu_torch.ops import lzss as lzss_ops


def _data(n=6000, seed=0):
    rng = np.random.RandomState(seed)
    return (chip_smoke.build_corpus(n - 500)
            + rng.randint(0, 256, 500, np.uint8).tobytes())


def _szdd_files(data):
    qbasic = (szdd.SIGNATURE_QBASIC + len(data).to_bytes(4, "little")
              + lzss_c.compress(data, lzss.MODE_QBASIC))
    return {"normal": lzss_c.szdd_compress(data, missing_char=ord("x")),
            "qbasic": qbasic}


def _szdd_engines():
    return {"cuda": lt.create_szdd_decompressor(engine="cuda", device="cpu"),
            "native": lt.create_szdd_decompressor(engine="native"),
            "scalar": lt.create_szdd_decompressor(engine="scalar")}


@pytest.mark.parametrize("fmt", ["normal", "qbasic"])
def test_szdd_equals_jax_driver(fmt):
    data = _data()
    blob = _szdd_files(data)[fmt]
    jd = JaxSzdd(engine="scalar")
    want = jd.decompress_bytes(blob)
    assert want == data
    jh = jd.open(blob).header
    for name, d in _szdd_engines().items():
        f = d.open(blob)
        assert (f.header.format, f.length, f.missing_char) == \
            (jh.format, jh.length, jh.missing_char), name
        assert d.decompress_bytes(blob) == want, name
        # a stream cut inside a group: the bytes written so far stand
        cut = blob[:len(blob) - 7]
        assert d.decompress_bytes(cut) == jd.decompress_bytes(cut), name


@pytest.mark.parametrize("mode", [lzss.MODE_EXPAND, lzss.MODE_MSHELP,
                                  lzss.MODE_QBASIC])
def test_lzss_ops_equal_jax_op(mode):
    data = _data(3000, 1)
    stream = lzss_c.compress(data, mode)
    assert lzss_ops.decompress(stream, mode, "cpu") == data
    for cut in (1, 2, 10, len(stream) - 1):
        want = lzss.decompress(stream[:cut], mode)
        assert lzss_ops.decompress(stream[:cut], mode, "cpu") == want
        assert lzss_jax.decompress(stream[:cut], mode) == want
    assert lzss_ops.decompress(b"", mode, "cpu") == b""


def test_szdd_errors_equal_jax():
    for bad in (b"SZDD\x88\xf0\x27\x33\x42x\0\0\0\0", b"XXXXXXXXXXXXXX",
                b"SZDD"):
        want = pytest.raises(jax_pkg.MSPackError, JaxSzdd().open, bad)
        got = pytest.raises(lt.MSPackError, _szdd_engines()["cuda"].open,
                            bad)
        assert type(got.value).__name__ == type(want.value).__name__


class _MsbBits:
    """MSB-first bit writer for hand-made KWAJ LZH streams."""

    def __init__(self):
        self.bits = []

    def put(self, value, n):
        self.bits += [(value >> (n - 1 - i)) & 1 for i in range(n)]
        return self

    def getvalue(self):
        bits = self.bits + [0] * (-len(self.bits) % 8)
        return bytes(int("".join(map(str, bits[i:i + 8])), 2)
                     for i in range(0, len(bits), 8))


def _lzh_stream(data):
    """An LZH body (kwajd.c:365-570): MATCHLEN1 lengths written out
    (type 3), the other trees fixed (type 0); literal runs of up to 32
    bytes, each followed by a match back into them."""
    w = _MsbBits()
    for t in (3, 0, 0, 0, 0, 0):
        w.put(t, 4)
    for _ in range(16):
        w.put(4, 4)                 # MATCHLEN1: sixteen 4-bit codes
    pos = 0
    while pos < len(data):
        run = data[pos:pos + 32]
        w.put(0, 4)                 # MATCHLEN1 symbol 0: a literal run
        w.put(len(run) - 1, 5)      # LITLEN
        for b in run:
            w.put(b, 8)             # LITERAL
        pos += len(run)
        if len(run) == 32:
            continue                # the next run starts with MATCHLEN1
        w.put(5, 4)                 # MATCHLEN2 symbol 5: 7 bytes
        w.put(0, 6).put(20, 6)      # offset 20
        pos += 7
    return w.getvalue()


def _lzh_expect(data_runs):
    """What _lzh_stream(data) decodes to, by the LZSS-style window."""
    window = bytearray(b"\x20" * 4096)
    out, p, pos = bytearray(), 0, 0
    while pos < len(data_runs):
        run = data_runs[pos:pos + 32]
        for b in run:
            window[p] = b
            out.append(b)
            p = (p + 1) & 4095
        pos += len(run)
        if len(run) == 32:
            continue
        for _ in range(7):
            b = window[(p + 4096 - 20) & 4095]
            window[p] = b
            out.append(b)
            p = (p + 1) & 4095
        pos += 7
    return bytes(out)


def _kwaj_file(method, body, length):
    """A KWAJ header with every optional field (kwajd.c:151-332)."""
    opt = (length.to_bytes(4, "little") + b"\x01\x02"
           + (3).to_bytes(2, "little") + b"unk"
           + b"readme\x00" + b"txt\x00"
           + (5).to_bytes(2, "little") + b"extra")
    head = (bytes([0x4B, 0x57, 0x41, 0x4A, 0x88, 0xF0, 0x27, 0xD1])
            + method.to_bytes(2, "little")
            + (14 + len(opt)).to_bytes(2, "little")
            + (0x3F).to_bytes(2, "little"))
    return head + opt + body


def _kwaj_cases():
    data = _data(5000, 2)
    yield "none", _kwaj_file(0, data, len(data)), data
    yield "xor", _kwaj_file(1, bytes(b ^ 0xFF for b in data), len(data)), \
        data
    yield "szdd", _kwaj_file(2, lzss_c.compress(data, lzss.MODE_QBASIC),
                             len(data)), data
    runs = data[:3000]
    yield "lzh", _kwaj_file(3, _lzh_stream(runs), 0), _lzh_expect(runs)
    yield "mszip", _kwaj_file(4, mszip_c.compress_kwaj(data), len(data)), \
        data


@pytest.mark.parametrize("method", [m for m, _, _ in _kwaj_cases()])
def test_kwaj_equals_jax_driver(method):
    _, blob, data = next(c for c in _kwaj_cases() if c[0] == method)
    jd = JaxKwaj()
    jf = jd.open(blob)
    want = jd.decompress_bytes(blob)
    if method != "lzh":
        assert want == data
    assert want[:len(data) - 16] == data[:len(data) - 16]
    d = lt.create_kwaj_decompressor()
    f = d.open(blob)
    for field in ("comp_type", "data_offset", "headers", "length",
                  "filename", "extra"):
        assert getattr(f.header, field) == getattr(jf.header, field), field
    assert f.filename == "readme.txt"
    assert d.decompress_bytes(blob) == want
    cut = blob[:len(blob) - 5]
    assert _outcome(d, cut) == _outcome(jd, cut)


def _outcome(d, blob):
    """(bytes, None) or (None, error class name) of one decompress."""
    try:
        return d.decompress_bytes(blob), None
    except Exception as e:   # noqa: BLE001 - the class name is compared
        return None, type(e).__name__


def test_kwaj_has_no_device_route():
    with pytest.raises(lt.ArgsError, match="device route"):
        lt.create_kwaj_decompressor(engine="cuda")
    lt.create_kwaj_decompressor(engine="scalar")


def test_hlp_and_lit_stubs_raise_as_jax():
    for port, ref in ((hlp.HlpDecompressor, jax_hlp.HlpDecompressor),
                      (hlp.HlpCompressor, jax_hlp.HlpCompressor),
                      (lit.LitDecompressor, jax_lit.LitDecompressor),
                      (lit.LitCompressor, jax_lit.LitCompressor)):
        with pytest.raises(NotImplementedError) as want:
            ref()
        with pytest.raises(NotImplementedError) as got:
            port()
        assert str(got.value) == str(want.value)


def test_version_table_equals_jax():
    for entity in ("library", "system", "cab_decoder", "chm_decoder",
                   "szdd_decoder", "kwaj_decoder", "oab_decoder",
                   "szdd_encoder", "kwaj_encoder", "cab_encoder",
                   "hlp_decoder", "lit_decoder", "nonsense"):
        assert lt.version(entity) == jax_pkg.version(entity), entity
    assert lt.version() == 2


def test_szdd_entry_point_defaults():
    d = lt.create_szdd_decompressor(device="cpu")
    assert d.engine == "cuda"
    assert lt.create_szdd_decompressor(engine="auto").engine == "native"
    with pytest.raises(lt.ArgsError, match="the port calls it"):
        lt.create_szdd_decompressor(engine="jax")
