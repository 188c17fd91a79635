"""K3's frame split: a CAB LZX folder decoded a warp per 32 KiB frame
(``lzx_phase_a(frame_sizes=...)``: the seed walk, the frame lanes and the
join of ``csrc/lzx_core.cuh``), held to the serial decode.

The plain version (``ops/cuda_lzx.py``) and the g++ twin of the kernel's
core run the split on folders from the benchmark's generator and on the
edge streams of ``lzx_edge_cases.lzx_split_batch``: the resolved bytes and
counts rows 0, 1, 3, 4 and 5 must equal the serial decode's, and the twin
must equal the plain version. A folder whose CFDATA blocks are not one
frame each, or whose frame is corrupt, falls back to the serial decode in
the same call and gives its result. The engine counts the split in its
``timings`` and never splits a DELTA stream, a CHM chunk or a call
without ``frame_sizes``.
"""
import numpy as np
import pytest
import torch

import libmspack_tpu_torch as lt
from libmspack_tpu_torch import kernels
from libmspack_tpu_torch import lzx_edge_cases as le
from libmspack_tpu_torch.compress import cab_c, chm_c, oab_c
from libmspack_tpu_torch.ops import cuda_lzx as cl
from libmspack_tpu_torch.parallel import planner
from libmspack_tpu_torch.parallel.cuda_pipeline import CudaLzxEngine
from libmspack_tpu_torch.system import BytesSink

FRAME = cl.FRAME


def _twin():
    try:
        return kernels.host_twin_lzx()
    except RuntimeError as e:
        pytest.skip(f"g++ build of the kernel core unavailable: {e}")


def twin_split(s, lens, tg, hs, wb, tcap, frame_sizes):
    """The twin's split launch sequence on CPU tensors."""
    twin = _twin()
    assert twin.lz_frame_end_bytes() == cl.FRAME_END_DTYPE.itemsize
    L = s.shape[0]
    meta, S, F = cl.split_meta(cl.split_rows(frame_sizes, L), L)
    meta = torch.from_numpy(meta)
    state = torch.empty((L, cl.STATE_BYTES), dtype=torch.uint8)
    tok = torch.full((L, tcap), -1, dtype=torch.int32)
    litw = torch.zeros((L, tcap), dtype=torch.int32)
    cnt = torch.zeros((8, L), dtype=torch.int32)
    seeds = torch.empty((F, cl.STATE_BYTES), dtype=torch.uint8)
    ends = torch.empty((F, cl.FRAME_END_DTYPE.itemsize), dtype=torch.uint8)
    ftok = torch.empty((F, FRAME), dtype=torch.int32)
    flitw = torch.empty((F, FRAME), dtype=torch.int32)
    flags = torch.empty(S, dtype=torch.int32)
    assert twin.lz_split_host(
        s.data_ptr(), s.stride(0), lens.data_ptr(), tg.data_ptr(),
        hs.data_ptr(), L, wb, state.data_ptr(), tok.data_ptr(),
        litw.data_ptr(), tcap, cnt.data_ptr(), meta.data_ptr(), S, F,
        seeds.data_ptr(), ends.data_ptr(), ftok.data_ptr(), flitw.data_ptr(),
        flags.data_ptr()) == 0
    return tok, litw, cnt


def twin_serial(s, lens, tg, hs, wb, tcap):
    """The twin's serial launch (one warp a stream) on CPU tensors."""
    twin = _twin()
    L = s.shape[0]
    state = torch.empty((L, cl.STATE_BYTES), dtype=torch.uint8)
    tok = torch.full((L, tcap), -1, dtype=torch.int32)
    litw = torch.zeros((L, tcap), dtype=torch.int32)
    cnt = torch.zeros((8, L), dtype=torch.int32)
    assert twin.lz_decode_host(
        s.data_ptr(), s.stride(0), lens.data_ptr(), tg.data_ptr(),
        hs.data_ptr(), L, wb, 0, 1, state.data_ptr(), tok.data_ptr(),
        litw.data_ptr(), tcap, cnt.data_ptr()) == 0
    return tok, litw, cnt


def run_split(impl, cases, frame_sizes):
    """(serial, split) outputs ``(tok, litw, cnt)`` of one window's cases."""
    s, lens, tg, hs = le.inputs(cases)
    wb = cases[0].window_bits
    tcap = max(c.out_len for c in cases)
    serial = cl.lzx_phase_a_plain(s, lens, tg, hs, wb, tcap=tcap)[:3]
    if impl == "twin":
        split = twin_split(s, lens, tg, hs, wb, tcap, frame_sizes)
    else:
        split = cl.lzx_phase_a(s, lens, tg, hs, wb, tcap=tcap,
                               frame_sizes=frame_sizes)
    return serial, split


def assert_like_serial(cases, serial, split, rows=(0, 1, 3, 4, 5)):
    for r in rows:
        assert torch.equal(split[2][r], serial[2][r]), r
    want = le.resolve(cases, *(t.numpy() for t in serial))
    got = le.resolve(cases, *(t.numpy() for t in split))
    assert got == want
    for g, c in zip(got, cases):
        assert g == c.raw, c.name


def generated(wb, block_frames, seed=5):
    """Folders of the benchmark's generator (its cab_corpus mix), coded
    as its CAB writer codes them: one CFDATA block a frame."""
    from portbench.gen import data, encoders

    mix = {"text": 0.35, "records": 0.35, "noise": 0.10, "random": 0.20}
    cases = []
    for k, n in enumerate((4 * FRAME + 1234, 3 * FRAME, 2 * FRAME + 1)):
        plain = data.file_bytes(seed, (wb, block_frames, k), n, mix,
                                (4096, 65536), data.Vocabulary(seed))
        s, offs = encoders.lzx_encode(plain, wb, block_frames=block_frames)
        cases.append(le.LzxCase(f"gen{k}", s, n, wb, raw=plain,
                                frame_sizes=le.frame_sizes(s, offs, n)))
    return cases


@pytest.mark.parametrize("impl", ["plain", "twin"])
@pytest.mark.parametrize("block_frames", [32, 1])
@pytest.mark.parametrize("wb", [15, 21])
def test_split_equals_serial_on_generated_folders(wb, block_frames, impl):
    cases = generated(wb, block_frames)
    serial, split = run_split(impl, cases, [c.frame_sizes for c in cases])
    assert (split[2][6] == cl.SPLIT_DONE).all()
    assert (serial[2][6] == 0).all()
    assert_like_serial(cases, serial, split)


def many_frames(kind):
    """A folder of more than 64 frames: the benchmark generator's at
    block_frames 1 or 32 (window 2^21), or the edge writer's with blocks
    ending inside frames and a repeat match opening every frame."""
    if kind == "writer":
        return le.lzx_split_many()
    from portbench.gen import data, encoders

    bf = int(kind[len("generated_bf"):])
    mix = {"text": 0.35, "records": 0.35, "noise": 0.10, "random": 0.20}
    n = 66 * FRAME - 999
    plain = data.file_bytes(9, (21, bf), n, mix, (4096, 65536),
                            data.Vocabulary(9))
    s, offs = encoders.lzx_encode(plain, 21, block_frames=bf)
    return le.LzxCase(f"gen_bf{bf}", s, n, 21, raw=plain,
                      frame_sizes=le.frame_sizes(s, offs, n))


@pytest.mark.parametrize("kind", ["generated_bf1", "generated_bf32",
                                  "writer"])
def test_split_join_at_several_frames_a_lane(kind):
    """More than 64 frames: the join's lanes each compose several frames'
    R transfers and token counts (frame k > 32). The twin's split equals
    the twin's serial decode (counts rows 0, 1, 3-5, the bytes) and the
    plain version's split (counts and tokens)."""
    case = many_frames(kind)
    assert len(case.frame_sizes) > 64 and case.out_len % FRAME
    s, lens, tg, hs = le.inputs([case])
    wb, tcap, fs = case.window_bits, case.out_len, [case.frame_sizes]
    serial = twin_serial(s, lens, tg, hs, wb, tcap)
    split = twin_split(s, lens, tg, hs, wb, tcap, fs)
    assert int(split[2][6, 0]) == cl.SPLIT_DONE
    assert_like_serial([case], serial, split)
    plain = cl.lzx_phase_a_plain(s, lens, tg, hs, wb, tcap=tcap,
                                 frame_sizes=fs)
    assert torch.equal(plain[2], split[2])
    k = int(split[2][2, 0])
    assert torch.equal(plain[0][0, :k], split[0][0, :k])
    assert torch.equal(plain[1][0, :k], split[1][0, :k])


@pytest.fixture(scope="module")
def edge_batch():
    return le.lzx_split_batch(seed=0)


@pytest.mark.parametrize("impl", ["plain", "twin"])
@pytest.mark.parametrize("name", [
    "split_blocks_inside_frames_w15", "split_blocks_inside_frames_w16",
    "split_stored_odd", "split_repeats_across_frames", "split_e8"])
def test_split_equals_serial_on_edge_streams(edge_batch, name, impl):
    case = next(c for c in edge_batch if c.name == name)
    assert case.out_len % FRAME and len(case.frame_sizes) >= 3
    serial, split = run_split(impl, [case], [case.frame_sizes])
    assert int(split[2][6, 0]) == cl.SPLIT_DONE
    assert_like_serial([case], serial, split)
    if name == "split_e8":   # the E8 header read by the seed walk
        assert int(split[2][5, 0]) == 5_000_000


def test_split_twin_equals_plain(edge_batch):
    cases = [c for c in edge_batch if c.window_bits == 16]
    fs = [c.frame_sizes for c in cases]
    _, plain = run_split("plain", cases, fs)
    _, twin = run_split("twin", cases, fs)
    assert torch.equal(plain[2], twin[2])
    for i in range(len(cases)):
        k = int(plain[2][2, i])
        assert torch.equal(plain[0][i, :k], twin[0][i, :k])
        assert torch.equal(plain[1][i, :k], twin[1][i, :k])


@pytest.mark.parametrize("impl", ["plain", "twin"])
def test_split_falls_back_where_blocks_are_not_frames(impl):
    """CFDATA sizes that cut the stream off its frame starts: every seam
    after the cut disagrees, and the stream decodes serially in the same
    call, with the serial decode's counts row for row."""
    cases = generated(16, 32)[:1]
    fs = list(cases[0].frame_sizes)
    fs[1] += 2
    fs[2] -= 2
    serial, split = run_split(impl, cases, [fs])
    row6 = int(split[2][6, 0])
    assert row6 > cl.SPLIT_DONE and row6 & (cl.SPLIT_SEAM | cl.SPLIT_FRAME)
    assert_like_serial(cases, serial, split, rows=(0, 1, 2, 3, 4, 5))


@pytest.mark.parametrize("impl", ["plain", "twin"])
def test_split_corrupt_frame_gives_the_serial_result(impl):
    cases = generated(16, 1)[:1]
    c = cases[0]
    at = sum(c.frame_sizes[:2])     # frame 2's block header
    bad = bytearray(c.stream)
    bad[at:at + 4] = b"\0\0\0\0"
    cases = [le.LzxCase(c.name, bytes(bad), c.out_len, 16,
                        frame_sizes=c.frame_sizes)]
    serial, split = run_split(impl, cases, [c.frame_sizes])
    assert int(serial[2][0, 0]) == 1      # the serial decode flags it
    assert int(split[2][6, 0]) > cl.SPLIT_DONE
    for r in range(6):
        assert torch.equal(split[2][r], serial[2][r]), r


def test_engine_counts_the_split_and_its_fallbacks():
    cases = generated(21, 32)
    eng = CudaLzxEngine("cpu")
    outs = eng.decode_streams([c.stream for c in cases],
                              [c.out_len for c in cases], 21,
                              frame_sizes=[c.frame_sizes for c in cases])
    assert outs == [c.raw for c in cases]
    t = eng.timings
    assert t["k3_split_streams"] == 3 and t["k3_split_fallbacks"] == 0
    assert t["k3_split_frames"] == 5 + 3 + 3
    assert t["k3_split_bytes"] == sum(c.out_len for c in cases)
    # sizes that cut off the frame starts: served serially, counted, no
    # decline
    fs = [list(c.frame_sizes) for c in cases]
    fs[0][1] += 2
    fs[0][2] -= 2
    eng = CudaLzxEngine("cpu")
    outs = eng.decode_streams([c.stream for c in cases],
                              [c.out_len for c in cases], 21,
                              frame_sizes=fs, per_lane=True)
    assert outs == [c.raw for c in cases]
    assert eng.timings["k3_split_streams"] == 2
    assert eng.timings["k3_split_fallbacks"] == 1
    assert not eng.declines
    assert sum(v for k, v in eng.timings.items()
               if k.startswith("k3_split_fallbacks_")) == 1
    # a block count other than the frame count: the header walk refuses
    # it, and it is counted under its reason
    fs = [list(c.frame_sizes) for c in cases]
    fs[0] = fs[0][:2] + [sum(fs[0][2:])]
    eng = CudaLzxEngine("cpu")
    outs = eng.decode_streams([c.stream for c in cases],
                              [c.out_len for c in cases], 21, frame_sizes=fs)
    assert outs == [c.raw for c in cases]
    assert eng.timings["k3_split_streams"] == 2
    assert eng.timings["k3_split_fallbacks"] == 1
    assert eng.timings["k3_split_fallbacks_seed"] == 1 and not eng.declines


def test_engine_never_splits_below_the_minimum():
    """A folder of fewer than MIN_SPLIT_FRAMES frames decodes serially."""
    short = [c for c in le.lzx_edge_batch(0) if c.window_bits == 15
             and c.raw is not None and 0 < c.out_len <= FRAME]
    assert len(short) > 4 and cl.MIN_SPLIT_FRAMES > 1
    eng = CudaLzxEngine("cpu")
    outs = eng.decode_streams([c.stream for c in short],
                              [c.out_len for c in short], 15,
                              frame_sizes=[[len(c.stream)] for c in short])
    assert outs == [c.raw for c in short]
    assert eng.timings["k3_split_streams"] == 0
    assert eng.timings["k3_split_fallbacks"] == 0
    # the op itself leaves such a row to the serial decode
    s, lens, tg, hs = le.inputs(short)
    cnt = cl.lzx_phase_a(s, lens, tg, hs, 15, tcap=int(tg.max()),
                         frame_sizes=[[len(c.stream)] for c in short])[2]
    assert (cnt[6] == 0).all()


def _cab_files(seed, n):
    rng = np.random.RandomState(seed)
    words = [b"cabinet ", b"frame ", b"warp ", b"seed ", b"join "]
    return b"".join(words[i] for i in rng.randint(len(words), size=n))[:n]


def test_cab_driver_and_planner_split_lzx_folders():
    files = [("a.txt", _cab_files(1, 3 * FRAME + 500)),
             ("b.bin", bytes(np.random.RandomState(2).randint(
                 0, 256, FRAME + 77, np.uint8)))]
    blob = cab_c.write_cab(folders=[cab_c.FolderSpec(files, "lzx", 21)])
    d = lt.create_cab_decompressor(engine="cuda", device="cpu", strict=True)
    cab = d.open(blob)
    got = {}
    for f in cab.files:
        sink = BytesSink()
        d.extract(f, sink)
        got[f.filename] = sink.getvalue()
    assert got == dict(files)
    t = d.cuda_lzx_engine.timings
    assert t["k3_split_streams"] == 1 and t["k3_split_fallbacks"] == 0
    assert t["k3_split_bytes"] == sum(len(b) for _, b in files)
    plan = planner.plan_archives([blob])
    out = planner.execute(plan, engine="cuda", device="cpu", strict=True)
    assert out[(0, 0)] == b"".join(b for _, b in files)
    t = plan.engines["lzx"].timings
    assert t["k3_split_streams"] == 1 and t["k3_split_frames"] == 5


def test_delta_chm_and_calls_without_sizes_never_split():
    cases = generated(17, 32)[:2]
    fs = [c.frame_sizes for c in cases]
    # a DELTA call with frame sizes, and a call without them
    eng = CudaLzxEngine("cpu")
    eng.decode_streams([c.stream for c in cases], [c.out_len for c in cases],
                       17, frame_sizes=fs, is_delta=True, per_lane=True)
    eng.decode_streams([c.stream for c in cases], [c.out_len for c in cases],
                       17)
    assert eng.timings["k3_split_streams"] == 0
    assert eng.timings["k3_split_fallbacks"] == 0
    # at the op: DELTA rows and resumed rows ignore frame_sizes
    s, lens, tg, hs = le.inputs(cases)
    for kw in ({"is_delta": True}, {"return_state": True}):
        cnt = cl.lzx_phase_a(s, lens, tg, hs, 17, tcap=int(tg.max()),
                             frame_sizes=fs, **kw)[2]
        assert (cnt[6] == 0).all()
    # an OAB full download (DELTA blocks) and a CHM's reset chunks
    oab = oab_c.write_oab(_cab_files(3, 3 * FRAME), block_size=2 * FRAME)
    d = lt.create_oab_decompressor(engine="cuda", device="cpu")
    d.decompress(oab, BytesSink())
    assert d.cuda_engine.timings["k3_split_streams"] == 0
    files = [(f"/p{i}.html", _cab_files(4 + i, n))
             for i, n in enumerate((70_000, 50_000))]
    blob = chm_c.write_chm(files, window_bits=16, reset_frames=2)
    d = lt.create_chm_decompressor(engine="cuda", device="cpu")
    h = d.open(blob)
    for f in h.files:
        d.extract(f, BytesSink())
    assert d.cuda_engine.n_decoded >= 2
    assert d.cuda_engine.timings["k3_split_streams"] == 0
