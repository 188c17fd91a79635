"""The drivers' ``engine="torch"`` against the JAX package's ``"jax"``.

``engine="torch"`` is the port of the JAX package's ``engine="jax"`` (its
XLA-level ops, ``ops/inflate.py`` and ``ops/lzx.py``), run here with
``device="cpu"``. Each archive goes through the port's driver and the JAX
package's ``"jax"`` and ``"scalar"`` drivers: the bytes must be equal and
the error classes equal by name. A folder or block the ops decline takes
the scalar path, counted in ``torch_declines`` and noted in
``fallback_reasons``; under strict mode it raises ``FallbackError``.
"""
import random

import pytest

import libmspack_tpu_torch as lt
from libmspack_tpu import create_szdd_decompressor as jax_szdd
from libmspack_tpu.compress import cab_c, chm_c, lzss_c, mszip_c, oab_c
from libmspack_tpu.formats.cab import CabDecompressor as JaxCab
from libmspack_tpu.formats.chm import ChmDecompressor as JaxChm
from libmspack_tpu.formats.oab import OabDecompressor as JaxOab
from libmspack_tpu.system import BytesSink as JaxSink
from libmspack_tpu_torch._device import resolve_engine
from libmspack_tpu_torch.system import BytesSink

CPU = "cpu"


def _extract(d, blob, sink_cls):
    """{filename: bytes or exception class name} of every member."""
    arc = d.open(blob)
    out = {}
    for f in arc.files:
        s = sink_cls()
        try:
            d.extract(f, s)
            out[f.filename] = s.getvalue()
        except Exception as e:   # compared by class name
            out[f.filename] = type(e).__name__
    return out


def _three(blob, jax_cls, port_factory, **kw):
    want = _extract(jax_cls(engine="jax"), blob, JaxSink)
    assert _extract(jax_cls(engine="scalar"), blob, JaxSink) == want
    d = port_factory(engine="torch", device=CPU, **kw)
    return want, _extract(d, blob, BytesSink), d


def _text(rng, n):
    words = [bytes(rng.choices(b"abcdefgh the of <p>", k=rng.randint(2, 8)))
             for _ in range(50)]
    return b"".join(rng.choice(words) for _ in range(n // 3))[:n]


def test_resolve_engine_torch():
    assert resolve_engine("torch") == "torch"
    for name, port in (("jax", "torch"), ("tpu", "cuda")):
        with pytest.raises(lt.ArgsError, match=f"the port calls it '{port}'"):
            resolve_engine(name)
    assert lt.create_cab_decompressor(engine="torch", device=CPU).device \
        .type == CPU
    with pytest.raises(lt.ArgsError):
        lt.create_kwaj_decompressor(engine="torch")
    # the planner has no tensor-op route: it refuses rather than run on
    # the host
    from libmspack_tpu_torch.parallel import planner
    blob = cab_c.write_cab(files=[("p.txt", b"planner " * 100)])
    with pytest.raises(lt.ArgsError, match="planner"):
        planner.extract_corpus([blob], engine="torch", device=CPU)


def test_cab_mszip_lzx_quantum_none():
    rng = random.Random(7)
    folders = [cab_c.FolderSpec([(f"{c}.bin", _text(rng, 50000 + 9000 * k)
                                  + bytes(rng.randrange(256)
                                          for _ in range(500)))], c)
               for k, c in enumerate(["mszip", "lzx", "quantum", "none"])]
    folders.append(cab_c.FolderSpec(
        [("a.txt", _text(rng, 30000)), ("b.txt", _text(rng, 20000))],
        "lzx", 21))
    blob = cab_c.write_cab(folders=folders)
    want, got, d = _three(blob, JaxCab, lt.create_cab_decompressor)
    assert got == want
    assert all(isinstance(v, bytes) for v in got.values())
    # Quantum has no tensor-op path: its folder took the scalar path
    assert dict(d.torch_declines) == {"Quantum has no tensor-op path": 1}
    assert list(d.fallback_reasons) == ["qtm_torch"]


def test_cab_declined_folder_and_strict(monkeypatch):
    """An MSZIP folder whose frames hold more deflate blocks than the ops
    walk declines on both packages; under strict it raises."""
    import zlib

    def many_blocks(data, *a, **kw):
        out = []
        for i in range(0, len(data), 32768):
            z = zlib.compressobj(9, zlib.DEFLATED, -15)
            chunk = data[i:i + 32768]
            s = b"".join(z.compress(chunk[j:j + 200])
                         + z.flush(zlib.Z_FULL_FLUSH)
                         for j in range(0, len(chunk), 200))
            out.append(b"CK" + s + z.flush())
        return out

    rng = random.Random(8)
    data = _text(rng, 40000)
    monkeypatch.setattr(mszip_c, "compress_frames", many_blocks)
    blob = cab_c.write_cab(files=[("m.txt", data)], compression="mszip")
    want, got, d = _three(blob, JaxCab, lt.create_cab_decompressor)
    assert got == want == {"m.txt": data}
    assert dict(d.torch_declines) == {"too many deflate blocks per frame": 1}
    strict = lt.create_cab_decompressor(engine="torch", device=CPU,
                                        strict=True)
    with pytest.raises(lt.FallbackError, match="too many deflate blocks"):
        _extract_strict(strict, blob)


def _extract_strict(d, blob):
    cab = d.open(blob)
    d.extract(cab.files[0], BytesSink())


def test_cab_corrupt_error_classes():
    rng = random.Random(9)
    data = _text(rng, 70000)
    for comp in ("mszip", "lzx"):
        blob = bytearray(cab_c.write_cab(files=[("x.bin", data)],
                                         compression=comp))
        for at in (len(blob) // 2, len(blob) - 40):
            bad = bytes(blob[:at]) + bytes([blob[at] ^ 0x5A]) \
                + bytes(blob[at + 1:])
            want, got, _ = _three(bad, JaxCab, lt.create_cab_decompressor)
            assert got == want, (comp, at)


def test_chm_section1():
    rng = random.Random(10)
    files = [("/a.html", _text(rng, 70000)), ("/b.html", _text(rng, 30000)),
             ("/c.txt", b"tiny")]
    blob = chm_c.write_chm(files, window_bits=16, reset_frames=2)
    want, got, d = _three(blob, JaxChm, lt.create_chm_decompressor)
    assert got == want
    assert got["/a.html"] == files[0][1] and not d.torch_declines
    assert d._sec1_cache is not None


def _oab_run(factory, fn, *args):
    sink_cls = BytesSink if factory is lt.create_oab_decompressor \
        else JaxSink
    s = sink_cls()
    d = factory(engine="torch", device=CPU) \
        if factory is lt.create_oab_decompressor else factory(engine=fn[1])
    try:
        getattr(d, fn[0])(*args, s)
        return s.getvalue(), None, d
    except Exception as e:
        return s.getvalue(), type(e).__name__, d


@pytest.mark.parametrize("case", ["full", "patch", "crc", "truncated"])
def test_oab(case):
    rng = random.Random(11)
    data = _text(rng, 150000)
    base = _text(rng, 90000)
    if case == "patch":
        blob, fn, extra = (oab_c.write_oab_patch(data, base, 65536),
                           "decompress_incremental", (base,))
    else:
        blob, fn, extra = oab_c.write_oab(data, 65536), "decompress", ()
    if case == "crc":
        # the second block's CRC field (header 16 bytes, then the blocks)
        second = 16 + 16 + int.from_bytes(blob[20:24], "little")
        blob = blob[:second + 12] + b"\x00\x00\x00\x00" + blob[second + 16:]
    elif case == "truncated":
        blob = blob[:len(blob) - 50]
    results = {}
    for engine in ("jax", "scalar"):
        out, err, _ = _oab_run(JaxOab, (fn, engine), blob, *extra)
        results[engine] = (out, err)
    port_out, port_err, d = _oab_run(lt.create_oab_decompressor, (fn,),
                                     blob, *extra)
    assert (port_out, port_err) == results["jax"]
    if case == "crc":
        # the JAX "jax" engine checks before it writes: block 0 only
        assert port_err == "ChecksumError" and port_out == data[:65536]
    if case in ("full", "patch"):
        assert port_out == data and port_err is None
        assert results["scalar"] == results["jax"]
        assert d.stats["device blocks"] == 3 and not d.torch_declines


def test_szdd():
    rng = random.Random(12)
    data = _text(rng, 20000)
    blob = lzss_c.szdd_compress(data)
    port = lt.create_szdd_decompressor(engine="torch", device=CPU)
    assert port.decompress_bytes(blob) == \
        jax_szdd(engine="jax").decompress_bytes(blob) == data
