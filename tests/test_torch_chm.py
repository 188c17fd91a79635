"""CHM section 1 through the port's driver: ``create_chm_decompressor(
engine="cuda")`` on ``device="cpu"`` (K3's plain version), one LZX lane per
ResetTable chunk.

CHMs come from the JAX package's writer (``compress/chm_c.write_chm``).
The port is held to ``libmspack_tpu``'s ``engine="tpu"`` (the Pallas
kernel in interpret mode) on a one-chunk CHM and to ``engine="native"``
and ``engine="scalar"`` on larger ones: equal bytes. An intel E8 header,
whose state is stream-global, is declined, counted and noted in
``fallback_reasons``, and the section then takes the reference's native
path, with the same bytes; under ``strict=True`` or
``MSPACK_TPU_STRICT=1`` it raises ``FallbackError`` instead.
"""
import numpy as np
import pytest

from libmspack_tpu.compress import chm_c, lzx_e
from libmspack_tpu.formats.chm import ChmDecompressor as JaxChmDecompressor
from libmspack_tpu.system import BytesSink as JaxBytesSink

import libmspack_tpu_torch as lt
from libmspack_tpu_torch.ops import cuda_lzx as cl
from libmspack_tpu_torch.system import BytesSink


def extract_all(d, blob):
    """Every file's bytes, each driver writing to its own package's
    sinks."""
    jax = isinstance(d, JaxChmDecompressor)
    chm = d.open(blob)
    got = {}
    for f in chm.files:
        sink = JaxBytesSink() if jax else BytesSink()
        d.extract(f, sink)
        got[f.filename] = sink.getvalue()
    return got


def _files(seed, sizes):
    rng = np.random.RandomState(seed)
    words = [b"<p>", b"help ", b"topic ", b"index ", b"chm ", b"</p>\n"]
    return [(f"/page{i}.html",
             b"".join(words[k] for k in rng.randint(len(words), size=n))[:n])
            for i, n in enumerate(sizes)]


def test_chm_matches_tpu_engine():
    files = _files(1, [2000, 1500, 900])
    blob = chm_c.write_chm(files)
    want = extract_all(JaxChmDecompressor(engine="scalar"), blob)
    assert [want[n] for n, _ in files] == [d for _, d in files]
    assert extract_all(JaxChmDecompressor(engine="tpu"), blob) == want
    before = cl.LAUNCHES["plain"]
    d = lt.create_chm_decompressor(engine="cuda", device="cpu")
    assert extract_all(d, blob) == want
    assert cl.LAUNCHES["plain"] == before + 1
    assert d.cuda_engine.lanes >= 1 and not d.cuda_engine.declines


def test_chm_chunks_one_lane_each():
    files = _files(2, [60_000, 120_000, 3_000, 90_000])
    blob = chm_c.write_chm(files, window_bits=16, reset_frames=2)
    want = extract_all(JaxChmDecompressor(engine="native"), blob)
    assert [want[n] for n, _ in files] == [d for _, d in files]
    d = lt.create_chm_decompressor(engine="cuda", device="cpu")
    assert extract_all(d, blob) == want
    chunks = JaxChmDecompressor().sec1_chunk_plan(d.open(blob))[0]
    assert len(chunks) == 5
    assert d.cuda_engine.lanes >= len(chunks)
    assert d.cuda_engine.n_decoded == len(chunks)
    assert not d.cuda_engine.declines


def _e8_chm(monkeypatch):
    """chm_c writes no E8 header; its encoder call is swapped for one
    that does, on every reset chunk."""
    def compress_e8(data, window_bits, reset_interval=0, **kw):
        return lzx_e.LzxEncoder(window_bits, reset_interval,
                                intel_filesize=1_000_000).compress(data)

    files = _files(3, [3000, 4000])
    files[1] = (files[1][0], files[1][1][:100] + b"\xe8\x10\x20\x00\x00"
                + files[1][1][105:])
    with monkeypatch.context() as m:
        m.setattr(chm_c.lzx_e, "compress", compress_e8)
        return files, chm_c.write_chm(files)


def test_chm_intel_e8_declined_counted_bytes_right(monkeypatch):
    files, blob = _e8_chm(monkeypatch)
    want = extract_all(JaxChmDecompressor(engine="scalar"), blob)
    d = lt.create_chm_decompressor(engine="cuda", device="cpu")
    assert extract_all(d, blob) == want
    assert want["/page1.html"] != files[1][1]   # E8 did translate
    assert d.cuda_engine.declines == {
        "intel E8 in chunked or DELTA streams": 1}
    assert "intel E8" in d.fallback_reasons["chm_lzx_cuda"]


@pytest.mark.parametrize("how", ["keyword", "environment"])
def test_chm_strict_mode_raises_on_intel_e8(how, monkeypatch):
    _, blob = _e8_chm(monkeypatch)
    if how == "environment":
        monkeypatch.setenv("MSPACK_TPU_STRICT", "1")
        d = lt.create_chm_decompressor(engine="cuda", device="cpu")
    else:
        d = lt.create_chm_decompressor(engine="cuda", device="cpu",
                                       strict=True)
    f = next(f for f in d.open(blob).files if f.filename == "/page0.html")
    with pytest.raises(lt.FallbackError, match="intel E8") as info:
        d.extract(f, BytesSink())
    assert info.value.path == "chm_lzx_cuda"


def test_chm_without_reset_offsets_declined_counted_bytes_right():
    """A ResetTable whose frame-size field is wrong gives no reset
    offsets (chmd.c:1195-1267), so a section longer than one reset
    interval cannot be cut into chunks: the driver declines, counts it,
    and the native path decodes the section whole."""
    files = _files(5, [50_000, 40_000, 70_000])
    blob = chm_c.write_chm(files, window_bits=16, reset_frames=2)
    # the ResetTable is the last system file: 160000 bytes padded to three
    # 64 KiB reset intervals, one 8-byte entry per 32 KiB frame
    nframes = 6
    rt = len(blob) - (0x28 + 8 * nframes)
    assert blob[rt:rt + 16] == (b"\x02\0\0\0" + bytes([nframes, 0, 0, 0])
                                + b"\x08\0\0\0\x28\0\0\0")
    assert blob[rt + 0x20:rt + 0x24] == (32768).to_bytes(4, "little")
    blob = blob[:rt + 0x20] + (16384).to_bytes(4, "little") + \
        blob[rt + 0x24:]
    want = extract_all(JaxChmDecompressor(engine="scalar"), blob)
    assert [want[n] for n, _ in files] == [d for _, d in files]
    before = cl.LAUNCHES["plain"]
    d = lt.create_chm_decompressor(engine="cuda", device="cpu")
    assert extract_all(d, blob) == want
    assert cl.LAUNCHES["plain"] == before
    assert d.cuda_engine.declines == {
        "no reset offsets past one interval": 1}


def test_other_engines_unchanged():
    files = _files(4, [500])
    blob = chm_c.write_chm(files)
    d = lt.create_chm_decompressor(engine="native")
    assert extract_all(d, blob) == dict(files)
    assert d.device is None and d.cuda_engine is None
