"""The slice's LZX half: CAB LZX folders through the port's driver and
``CudaLzxEngine``.

Cabinets come from the JAX package's writer. The port's ``engine="cuda"``
runs here with ``device="cpu"``, i.e. on K3's plain version, and is held
to ``libmspack_tpu``'s ``engine="tpu"`` (the Pallas kernel in interpret
mode, on small folders: larger ones it declines in interpret mode) and
``engine="scalar"``: equal bytes, and the same error class on a corrupt
folder. The engine's segmented decode is held to its one-launch decode.
"""
import numpy as np
import pytest

from libmspack_tpu.compress import cab_c
from libmspack_tpu.errors import MSPackError as JaxMSPackError
from libmspack_tpu.formats.cab import CabDecompressor as JaxCabDecompressor
from libmspack_tpu.system import BytesSink as JaxBytesSink

import libmspack_tpu_torch as lt
from libmspack_tpu_torch import lzx_edge_cases as le
from libmspack_tpu_torch.ops import cuda_lzx as cl
from libmspack_tpu_torch.parallel.cuda_pipeline import CudaLzxEngine
from libmspack_tpu_torch.system import BytesSink


def extract_all(d, blob):
    """Every file's bytes, each driver writing to its own package's
    sinks."""
    jax = isinstance(d, JaxCabDecompressor)
    cab = d.open(blob)
    got = {}
    for f in cab.files:
        sink = JaxBytesSink() if jax else BytesSink()
        d.extract(f, sink)
        got[f.filename] = sink.getvalue()
    return got


def _text(seed, n):
    rng = np.random.RandomState(seed)
    words = [b"folder ", b"stream ", b"cabinet ", b"lzx ", b"lane ",
             b"window "]
    return b"".join(words[i] for i in rng.randint(len(words), size=n))[:n]


def _e8_data(seed, n):
    """Text with E8 call opcodes in it, so that the E8 pass has work."""
    rng = np.random.RandomState(seed)
    d = bytearray(_text(seed, n))
    for p in range(5, n - 10, 61):
        d[p:p + 5] = b"\xe8" + int(rng.randint(1 << 16)).to_bytes(4,
                                                               "little")
    return bytes(d)


def test_cab_lzx_matches_tpu_and_scalar():
    small = [("s1.txt", _text(1, 2500)), ("s2.txt", _text(2, 1500))]
    e8 = [("e8.bin", _e8_data(3, 3000))]
    blob = cab_c.write_cab(folders=[
        cab_c.FolderSpec(small, "lzx", 16),
        cab_c.FolderSpec(e8, "lzx", 16, intel_filesize=2_000_000)])
    want = extract_all(JaxCabDecompressor(engine="scalar"), blob)
    assert want["s1.txt"] == small[0][1]
    assert extract_all(JaxCabDecompressor(engine="tpu"), blob) == want
    before = cl.LAUNCHES["plain"]
    d = lt.create_cab_decompressor(engine="cuda", device="cpu")
    assert extract_all(d, blob) == want
    assert cl.LAUNCHES["plain"] == before + 2     # one per folder
    eng = d.cuda_lzx_engine
    assert eng.n_decoded == 2 and not eng.declines
    assert {"upload_ms", "k3_ms", "trace_pull_ms", "host_resolve_ms",
            "total_ms"} <= set(eng.timings)


def test_cab_lzx_segmented_folders_match_scalar():
    rng = np.random.RandomState(4)
    big = _text(5, 200_000)
    blob = cab_c.write_cab(folders=[
        cab_c.FolderSpec([("big.txt", big), ("tail.txt", _text(6, 9000))],
                         "lzx", 16),
        cab_c.FolderSpec([("w21.txt", _text(7, 90_000))], "lzx", 21),
        cab_c.FolderSpec([("noise.bin", rng.randint(
            0, 256, 70_001, np.uint8).tobytes())], "lzx", 15),
        cab_c.FolderSpec([("e8.bin", _e8_data(8, 80_000))], "lzx", 17,
                         intel_filesize=12_345_678),
        cab_c.FolderSpec([("m.txt", _text(9, 40_000))], "mszip")])
    want = extract_all(JaxCabDecompressor(engine="scalar"), blob)
    assert want["big.txt"] == big
    d = lt.create_cab_decompressor(engine="cuda", device="cpu")
    d.cuda_lzx_engine = CudaLzxEngine("cpu", segment_bytes=65536)
    assert extract_all(d, blob) == want
    eng = d.cuda_lzx_engine
    assert eng.n_decoded == 4 and not eng.declines
    assert not d.cuda_engine.declines


def corrupt_lzx_cab():
    """An LZX cabinet whose first block starts with block type 0, its
    checksum cleared so that the block reads fine and phase A flags it."""
    blob = cab_c.write_cab(files=[("x.txt", _text(10, 5000))],
                           compression="lzx")
    cab = JaxCabDecompressor(engine="scalar").open(blob)
    off = cab.folders[0].data[0].offset
    b = bytearray(blob)
    b[off:off + 4] = b"\0\0\0\0"
    payload = off + 8 + cab.block_resv
    b[payload:payload + 2] = b"\0\0"   # no E8 header, block type 000
    return bytes(b)


def test_corrupt_lzx_folder_raises_like_tpu():
    blob = corrupt_lzx_cab()
    errors = []
    for d in (JaxCabDecompressor(engine="tpu"),
              lt.create_cab_decompressor(engine="cuda", device="cpu")):
        with pytest.raises((JaxMSPackError, lt.MSPackError)) as info:
            extract_all(d, blob)
        errors.append(type(info.value))
    # the port has its own copies of the error classes: same names
    assert issubclass(errors[0], JaxMSPackError)
    assert issubclass(errors[1], lt.MSPackError)
    assert errors[0].__name__ == errors[1].__name__
    assert d.cuda_lzx_engine.declines["flagged lane"] == 1


def _valid(key):
    cases = le.lzx_edge_batch(seed=0)
    return [cases[i] for i in le.groups(cases)[key]
            if cases[i].raw is not None]


@pytest.mark.parametrize("key", [(15, False), (16, False), (17, True)])
def test_engine_segments_equal_one_call(key):
    sub = _valid(key)
    args = ([c.stream for c in sub], [c.out_len for c in sub], key[0])
    kw = dict(is_delta=key[1], refs=[c.ref for c in sub])
    one = CudaLzxEngine("cpu")
    seg = CudaLzxEngine("cpu", segment_bytes=32768)
    want = one.decode_streams(*args, **kw)
    assert want == [c.raw for c in sub]
    assert seg.decode_streams(*args, **kw) == want
    assert not one.declines and not seg.declines
    assert one.lanes == seg.lanes == len(sub)


def test_engine_batches_within_the_trace_budget():
    sub = _valid((16, False))
    eng = CudaLzxEngine("cpu")
    eng.TRACE_BUDGET = 8 * 140_000   # one lane of 131072 bytes per launch
    before = cl.LAUNCHES["plain"]
    outs = eng.decode_streams([c.stream for c in sub],
                              [c.out_len for c in sub], 16)
    assert outs == [c.raw for c in sub]
    assert cl.LAUNCHES["plain"] - before == len(sub)


def test_engine_declines_intel_for_chunks():
    case = next(c for c in le.lzx_edge_batch(seed=0)
                if c.name == "e8_header")
    eng = CudaLzxEngine("cpu")
    assert eng.decode_streams([case.stream], [case.out_len], 15) == \
        [case.raw]
    assert eng.decode_streams([case.stream], [case.out_len], 15,
                              decline_on_intel=True) is None
    assert eng.declines == {"intel E8 in chunked or DELTA streams": 1}


def test_engine_declines_flagged_lane_and_bad_window():
    cases = le.lzx_edge_batch(seed=0)
    bad = next(c for c in cases if c.name == "offset_beyond_stream")
    good = next(c for c in cases if c.name == "verbatim")
    eng = CudaLzxEngine("cpu")
    assert eng.decode_streams([good.stream, bad.stream],
                              [good.out_len, bad.out_len], 15) is None
    assert eng.decode_streams([good.stream], [good.out_len], 22) is None
    assert eng.declines == {"flagged lane": 1,
                            "window size outside LZX's": 1}
    with pytest.raises(ValueError):
        CudaLzxEngine("cpu", segment_bytes=1000)


@pytest.mark.parametrize("segment_bytes", [None, 32768])
def test_engine_per_lane_declines_only_the_bad_lanes(segment_bytes):
    """``per_lane=True``: the lanes that pass keep their bytes and only the
    flagged or E8 lanes are None; in segments the declining batch's lanes
    are None. A window outside LZX's gives a None for every lane."""
    by_name = {c.name: c for c in le.lzx_edge_batch(seed=0)}
    # the last two are longer than 32768 bytes: one segmented batch
    sub = [by_name[n] for n in ("verbatim", "offset_beyond_stream",
                                "e8_header", "multi_frame",
                                "offset_past_frame_start")]
    eng = CudaLzxEngine("cpu", segment_bytes=segment_bytes)
    got = eng.decode_streams([c.stream for c in sub],
                             [c.out_len for c in sub], 15,
                             decline_on_intel=True, per_lane=True)
    good = sub[0].raw
    if segment_bytes is None:
        assert got == [good, None, None, sub[3].raw, None]
        assert eng.declines == {"flagged lane": 1,
                                "intel E8 in chunked or DELTA streams": 1}
    else:
        assert got == [good, None, None, None, None]
        assert eng.declines == {"flagged lane": 2,
                                "intel E8 in chunked or DELTA streams": 1}
    good = sub[0]
    assert eng.decode_streams([good.stream], [good.out_len], 22,
                              per_lane=True) == [None]
