"""The corpus planner, per-codec routing and the native wrappers it calls.

The port's ``planner.extract_corpus`` with ``engine="cuda", device="cpu"``
(the kernels' plain versions) and with ``engine="native"`` is held to the
JAX planner's ``engine="native"`` on a mixed corpus (MSZIP, LZX at 2^15 and
2^21, Quantum, NONE, and a folder spanning two cabinets), and to its
``engine="tpu"`` (Pallas in interpret mode) on an MSZIP-only corpus: equal
files, equal ``errors`` keys and error-class names. A Quantum folder whose
window-wrap flush the reference codec refuses is declined alone (its
window-mates stay on the device path) and raises ``FallbackError`` under
strict mode. ``choose_engine`` reads a calibration file named by
``MSPACK_CALIBRATION``. The native wrappers ``mszip_folders``,
``lzx_decode`` and ``qtm_decode`` equal the JAX package's.
"""
import json
import struct

import numpy as np
import pytest

from libmspack_tpu import native as jax_native
from libmspack_tpu.compress import cab_c as jax_cab_c
from libmspack_tpu.parallel import planner as jax_planner

import libmspack_tpu_torch as lt
from libmspack_tpu_torch import native, utils
from libmspack_tpu_torch import qtm_edge_cases as qe
from libmspack_tpu_torch.compress import cab_c
from libmspack_tpu_torch.parallel import planner

DATA = utils.build_corpus(400000)


def span_pair(data, compression, window_bits=16, cut=2):
    """Two cabinets of one set holding one folder between them: the
    folder's first ``cut`` blocks and the first half of block ``cut`` in
    the first (that half with an uncompressed size of 0, as a split block
    is stored, cabd.c:1412-1450), the rest in the second. The one file is
    continued to the next cabinet in the first (folder index 0xFFFE) and
    from the previous one in the second (0xFFFD); the second cabinet adds
    a NONE folder with a file of its own."""
    spec = cab_c.FolderSpec([("span.bin", data)], compression, window_bits)
    comp_type, blocks = cab_c._encode_folder_blocks(spec)
    payload, ulen = blocks[cut]
    half = len(payload) // 2
    first = blocks[:cut] + [(payload[:half], 0)]
    second = [(payload[half:], ulen)] + blocks[cut + 1:]
    tail = b"tail of the set " * 64

    def cab(flags, names, folders, files, set_index):
        strings = b"".join(n + b"\0" for n in names)
        cffiles = b"".join(
            struct.pack("<IIHHHH", length, off, fidx, 0x5111, 0x6000, 0x20)
            + name + b"\0" for name, length, off, fidx in files)
        head = 0x24 + len(strings)
        data_start = head + 8 * len(folders) + len(cffiles)
        cffolders, cfdata = b"", b""
        for ct, blks in folders:
            cffolders += struct.pack("<IHH", data_start + len(cfdata),
                                     len(blks), ct)
            for p, u in blks:
                tail_ = struct.pack("<HH", len(p), u)
                ck = cab_c._checksum(tail_, cab_c._checksum(p, 0))
                cfdata += struct.pack("<I", ck) + tail_ + p
        size = data_start + len(cfdata)
        return (b"MSCF" + struct.pack("<IIIIIBBHHHHH", 0, size, 0,
                                      head + 8 * len(folders), 0, 3, 1,
                                      len(folders), len(files), flags,
                                      0x0622, set_index)
                + strings + cffolders + cffiles + cfdata)

    a = cab(0x0002, [b"b.cab", b"disk2"], [(comp_type, first)],
            [(b"span.bin", len(data), 0, 0xFFFE)], 0)
    b = cab(0x0001, [b"a.cab", b"disk1"],
            [(comp_type, second), (0, [(tail, len(tail))])],
            [(b"span.bin", len(data), 0, 0xFFFD),
             (b"tail.txt", len(tail), 0, 1)], 1)
    return a, b, tail


def mixed_corpus():
    """Four cabinets: MSZIP + LZX 2^15; LZX 2^21 + Quantum + NONE; and a
    Quantum folder spanning the last two."""
    d = DATA
    one = cab_c.write_cab(folders=[
        cab_c.FolderSpec([("a.txt", d[:70000]), ("b.txt", d[70000:90000])],
                         "mszip"),
        cab_c.FolderSpec([("c.txt", d[90000:150000])], "lzx", 15)])
    two = cab_c.write_cab(folders=[
        cab_c.FolderSpec([("d.txt", d[150000:200000])], "lzx", 21),
        cab_c.FolderSpec([("e.txt", d[200000:240000])], "quantum", 16),
        cab_c.FolderSpec([("f.txt", d[240000:260000])], "none")])
    a, b, _ = span_pair(d[260000:360000], "quantum", 16)
    return [one, two, a, b]


def names(errors):
    return {k: type(e).__name__ for k, e in errors.items()}


def jax_native_run(corpus):
    errors = {}
    return jax_planner.extract_corpus(corpus, errors=errors,
                                      engine="native"), names(errors)


@pytest.mark.parametrize("engine", ["cuda", "native", "scalar"])
def test_mixed_corpus_matches_jax_planner(engine):
    corpus = mixed_corpus()
    want, want_err = jax_native_run(corpus)
    errors = {}
    got = planner.extract_corpus(corpus, errors=errors, engine=engine,
                                 device="cpu")
    assert got == want
    assert names(errors) == want_err
    # every whole folder decoded; each part of the spanning one, planned
    # alone (the planner merges no cabinets), refused
    assert got[0]["c.txt"] == DATA[90000:150000]
    assert got[1]["e.txt"] == DATA[200000:240000]
    assert got[3]["tail.txt"] == b"tail of the set " * 64
    assert set(want_err) == {(2, 0), (3, 0)}


def test_cuda_route_one_call_per_codec_group():
    plan = planner.plan_archives(mixed_corpus())
    planner.execute(plan, engine="cuda", device="cpu")
    # MSZIP once; LZX at 2^15 and 2^21; Quantum once (both at 2^16)
    assert dict(plan.calls) == {"mszip": 1, "lzx": 2, "quantum": 1}
    # every folder collected by the walk, but the two parts of the span
    assert plan.collect_routes == {"collect_native": 6, "collect_python": 2}
    assert plan.engines["lzx"].n_decoded == 2
    # e.txt's lane and the span's second part, which K4 flags
    assert plan.engines["quantum"].lanes == 2
    assert plan.engines["quantum"].n_decoded == 1
    for name in ("parse_ms", "collect_ms", "mszip_cuda_ms", "lzx_cuda_ms",
                 "quantum_cuda_ms", "scalar_ms"):
        assert plan.timings[name] >= 0
    # the span's first part cannot be collected: declines, each named
    assert "2:0" in plan.fallback_reasons["qtm_cuda"]
    assert "3:0" in plan.fallback_reasons["qtm_cuda window 2^16"]
    assert len(plan.fallback_reasons) == 2


def mszip_corpus():
    return [jax_cab_c.write_cab(folders=[
        jax_cab_c.FolderSpec([("x.txt", DATA[:40000])], "mszip"),
        jax_cab_c.FolderSpec([("y.txt", DATA[40000:50000])], "mszip")]),
        jax_cab_c.write_cab(files=[("z.txt", DATA[50000:60000])])]


def test_mszip_corpus_matches_jax_tpu_engine():
    corpus = mszip_corpus()
    want = jax_planner.extract_corpus(corpus, engine="tpu")
    plan = planner.plan_archives(corpus)
    got = planner.archive_files(
        plan, planner.execute(plan, engine="cuda", device="cpu",
                              strict=True))
    assert got == want
    assert plan.calls == {"mszip": 1}
    assert not plan.engines["mszip"].declines


def _corrupt(blob, how):
    """``blob`` with the first CFDATA block of its second folder made bad:
    its checksum wrong, or its payload garbled under a cleared checksum
    (the block reads fine and the codec fails), or the cabinet cut short
    inside that folder."""
    cab = lt.create_cab_decompressor(engine="scalar").open(blob)
    off = cab.folders[1].data[0].offset
    b = bytearray(blob)
    if how == "checksum":
        b[off] ^= 0x55
    elif how == "payload":
        b[off:off + 4] = bytes(4)
        for p in range(off + 8, off + 72, 3):
            b[p] ^= 0xA7
    else:
        b = b[:off + 200]
    return bytes(b)


@pytest.mark.parametrize("how", ["checksum", "payload", "truncated"])
@pytest.mark.parametrize("codec", ["mszip", "lzx", "quantum"])
def test_corrupt_folder_errors_match_jax(codec, how):
    d = DATA
    blob = _corrupt(cab_c.write_cab(folders=[
        cab_c.FolderSpec([("ok.txt", d[:50000])], "mszip"),
        cab_c.FolderSpec([("bad.txt", d[50000:120000])], codec, 16),
        cab_c.FolderSpec([("ok2.txt", d[120000:150000])], codec, 16)]), how)
    corpus = [blob, mszip_corpus()[1]]
    want, want_err = jax_native_run(corpus)
    for engine in ("cuda", "native"):
        errors = {}
        got = planner.extract_corpus(corpus, errors=errors, engine=engine,
                                     device="cpu")
        assert got == want, engine
        assert names(errors) == want_err, engine
    assert (0, 1) in want_err


def wrap_corpus():
    """A cabinet with the window-wrap flush folder and a clean Quantum
    folder of the same window, and a second cabinet with another."""
    files, wb = qe.wrap_flush_files()
    clean = [("g.bin", DATA[:3000])]
    return [cab_c.write_cab(folders=[cab_c.FolderSpec(clean, "quantum", wb),
                                     cab_c.FolderSpec(files, "quantum", wb)]),
            cab_c.write_cab(folders=[cab_c.FolderSpec(
                [("h.bin", DATA[5000:9000])], "quantum", wb)])], files


def test_wrap_flush_folder_declined_alone(monkeypatch):
    corpus, files = wrap_corpus()
    want, want_err = jax_native_run(corpus)
    plan = planner.plan_archives(corpus)
    got = planner.archive_files(
        plan, planner.execute(plan, engine="cuda", device="cpu"))
    # the declined folder takes the native engine, as the JAX planner does
    assert got == want and not want_err
    assert got[0] == dict(files, **{"g.bin": DATA[:3000]})
    eng = plan.engines["quantum"]
    assert plan.calls == {"quantum": 1} and eng.lanes == 3
    assert eng.declines == {"window-wrap flush across a file edge": 1}
    assert list(plan.fallback_reasons) == ["qtm_cuda window 2^10"]
    assert "archive:folder 0:1)" in plan.fallback_reasons[
        "qtm_cuda window 2^10"]
    with pytest.raises(lt.FallbackError, match="0:1"):
        planner.extract_corpus(corpus, engine="cuda", device="cpu",
                               strict=True)
    monkeypatch.setenv("MSPACK_TPU_STRICT", "1")
    with pytest.raises(lt.FallbackError):
        planner.extract_corpus(corpus, engine="cuda", device="cpu")


def test_flagged_lane_declined_alone():
    """A corrupt LZX folder among clean ones of its window: only its lane
    declines, the others stay on the device path."""
    d = DATA
    good = cab_c.write_cab(folders=[
        cab_c.FolderSpec([("l1.txt", d[:60000])], "lzx", 16),
        cab_c.FolderSpec([("l2.txt", d[60000:120000])], "lzx", 16)])
    bad = _corrupt(good, "payload")
    plan = planner.plan_archives([good, bad])
    errors = {}
    got = planner.archive_files(plan, planner.execute(
        plan, errors=errors, engine="cuda", device="cpu"))
    assert got[0] == {"l1.txt": d[:60000], "l2.txt": d[60000:120000]}
    eng = plan.engines["lzx"]
    assert plan.calls == {"lzx": 1} and eng.lanes == 4
    assert eng.n_decoded == 3
    assert "1:1" in plan.fallback_reasons["lzx_cuda window 2^16"]
    assert set(errors) == {(1, 1)}


def test_cuda_device_raises_without_gpu():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="is_available"):
        planner.extract_corpus(mszip_corpus(), engine="cuda")


@pytest.mark.parametrize("crossover,workload,want", [
    (None, 1 << 30, "native"),
    (1 << 20, 1 << 19, "native"),
    (1 << 20, 1 << 20, "cuda"),
])
@pytest.mark.parametrize("codec", ["mszip", "lzx", "quantum"])
def test_choose_engine_per_codec(codec, crossover, workload, want,
                                 monkeypatch, tmp_path):
    import torch
    others = {c: 0 for c in utils.CODECS if c != codec}
    path = tmp_path / "cal.json"
    path.write_text(json.dumps({
        "native_mb_s": dict.fromkeys(utils.CODECS, 500.0),
        "cuda_mb_s_large": dict.fromkeys(utils.CODECS, None),
        "cuda_crossover_bytes": {codec: crossover, **others}}))
    monkeypatch.setenv("MSPACK_CALIBRATION", str(path))
    assert utils.engine_calibration()["cuda_crossover_bytes"][codec] == \
        crossover
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert utils.choose_engine(workload, codec) == want
    # the other codecs win at any size; without a card never
    assert all(utils.choose_engine(1, c) == "cuda" for c in others)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert utils.choose_engine(workload, codec) == "native"


def test_auto_routes_each_codec(monkeypatch, tmp_path):
    """engine="auto": MSZIP calibrated to the card, LZX and Quantum not."""
    import torch
    path = tmp_path / "cal.json"
    path.write_text(json.dumps({"cuda_crossover_bytes": {
        "mszip": 1, "lzx": None, "quantum": None}}))
    monkeypatch.setenv("MSPACK_CALIBRATION", str(path))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    corpus = mixed_corpus()[:2]
    plan = planner.plan_archives(corpus)
    got = planner.archive_files(plan, planner.execute(
        plan, engine="auto", device="cpu"))
    assert got == jax_native_run(corpus)[0]
    assert plan.calls == {"mszip": 1}


def test_no_calibration_never_routes_to_card(monkeypatch, tmp_path):
    monkeypatch.setenv("MSPACK_CALIBRATION", str(tmp_path / "absent.json"))
    assert utils.engine_calibration() == {}
    assert utils.choose_engine(1 << 40, "lzx") == "native"


def test_bench_corpus(monkeypatch, tmp_path):
    import chip_smoke
    assert utils.bench_corpus(1 << 16) == chip_smoke.build_corpus(1 << 16)
    src = tmp_path / "seed.txt"
    src.write_bytes(b"abc")
    monkeypatch.setenv("MSPACK_BENCH_CORPUS", str(src))
    assert utils.bench_corpus(7) == b"abcabca"


# ---------------------------------------------------------------- native --

def _mszip_folders():
    """Three MSZIP folders as the CAB reader hands them over."""
    d = lt.create_cab_decompressor(engine="scalar")
    blob = cab_c.write_cab(folders=[
        cab_c.FolderSpec([("m", DATA[lo:hi])], "mszip")
        for lo, hi in ((0, 70000), (70000, 75000), (100000, 200000))])
    out = []
    for fol in d.open(blob).folders:
        out.append(d.collect_mszip_frames(fol))
    return out


@pytest.mark.parametrize("corrupt", [False, True])
def test_native_mszip_folders_matches_jax(corrupt):
    folders = _mszip_folders()
    if corrupt:
        frames, sizes = folders[1]
        folders[1] = ([b"\x07" + frames[0][1:]] + frames[1:], sizes)
    want = jax_native.mszip_folders(folders, 2)
    got = native.mszip_folders(folders, 2)
    assert got == want
    if corrupt:
        assert got is None
    else:
        assert b"".join(got) == DATA[:75000] + DATA[100000:200000]


@pytest.mark.parametrize("wb", [15, 17, 21])
def test_native_lzx_decode_matches_jax(wb):
    data = DATA[:150000]
    stream, _ = native.lzx_encode(data, wb)
    assert native.lzx_decode(stream, wb, 0, len(data)) == data == \
        jax_native.lzx_decode(stream, wb, 0, len(data))
    bad = stream[:len(stream) // 3]
    assert native.lzx_decode(bad, wb, 0, len(data)) == \
        jax_native.lzx_decode(bad, wb, 0, len(data))


@pytest.mark.parametrize("wb", [10, 16, 21])
def test_native_qtm_decode_matches_jax(wb):
    data = DATA[:90000]
    frames = native.qtm_encode(data, wb)
    stream = b"".join(f + b"\xff" for f in frames)
    assert native.qtm_decode(stream, wb, len(data)) == data == \
        jax_native.qtm_decode(stream, wb, len(data))
    bad = stream[:len(stream) // 2]
    assert native.qtm_decode(bad, wb, len(data)) == \
        jax_native.qtm_decode(bad, wb, len(data))


def test_cab_pipeline_unchanged_by_the_planner_route():
    """engine="native" goes through the whole-cabinet C pipeline: the
    archives' folders come back as views of its arena."""
    corpus = mixed_corpus()[:2]
    plan = planner.plan_archives(corpus)
    res = planner.execute(plan, engine="native")
    assert all(isinstance(v, np.ndarray) for v in res.values())
    assert plan.calls == {}
