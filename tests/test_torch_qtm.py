"""K4 (Quantum phase A) of the PyTorch port against the JAX Pallas kernel.

The Quantum edge batch (libmspack_tpu_torch/qtm_edge_cases.py) goes through
the port's plain version and, for its small window-2^10 cases and the
window-wrap folder, through ``pallas_qtm.qtm_phase_a`` in interpret mode
(one interpreted call, shared by a module fixture), fed from the same
packed grid by ``from_jax_batch``. Tolerance: exact — the same tokens and
litwords in the same order (the TPU kernel's trace with its NOP steps
dropped) and counts rows 0 and 1 equal. On the whole batch the plain
version resolves to the reference codec's bytes and flags exactly the
streams the reference rejects, the g++ build of the kernel's C++ core
equals the plain version token for token and state byte for state byte,
and a decode in segments through the state record equals one launch.

Where the JAX package's engines disagree with the reference codec (a
window-wrap flush inside a file's request: ``engine="tpu"``, the Pallas
kernel's trace resolved, and ``engine="native"`` serve bytes the reference
refuses), the port follows the reference codec.
"""
import numpy as np
import pytest
import torch

from libmspack_tpu.compress import cab_c as jax_cab_c
from libmspack_tpu.formats.cab import CabDecompressor as JaxCabDecompressor
from libmspack_tpu.ops import pallas_qtm as pq
from libmspack_tpu.system import BytesSink as JaxBytesSink

import libmspack_tpu_torch as lt
from libmspack_tpu_torch import kernels
from libmspack_tpu_torch import lzx_edge_cases as le
from libmspack_tpu_torch import qtm_edge_cases as qe
from libmspack_tpu_torch.ops import cuda_qtm as cq
from libmspack_tpu_torch.parallel.cuda_pipeline import resolve_lzx, wrap_spans
from libmspack_tpu_torch.system import BytesSink


@pytest.fixture(scope="module")
def cases():
    return qe.qtm_edge_batch(seed=0)


def _window(cases, wb):
    return [cases[i] for i in qe.groups(cases)[wb]]


def _wrap_case():
    files, wb = qe.wrap_flush_files()
    data = b"".join(d for _, d in files)
    return qe.QtmCase("wrap_flush_folder", qe.encode(data, wb), len(data),
                      wb, data)


@pytest.fixture(scope="module")
def jax_run(cases):
    """The TPU kernel, interpreted, on the small window-2^10 cases and the
    window-wrap folder (SL=1, LN=128), at the T_PAD that
    TpuQtmEngine._launch_batch picks."""
    sub = [c for c in cases if c.name in qe.SMALL_NAMES] + [_wrap_case()]
    sizes = [c.out_len for c in sub]
    t_pad = max(4096, 1 << (max(sizes) * 2 + 2048 - 1).bit_length())
    streams = [c.stream for c in sub]
    tok, litw, cnt = pq.qtm_phase_a(streams, sizes, 10, SL=1, LN=128,
                                    T_PAD=t_pad, interpret=True)
    grid, _ = pq.pack_streams(streams, SL=1, LN=128)
    return sub, np.asarray(tok), np.asarray(litw), np.asarray(cnt), grid


def _jax_trace(jtok, jlitw, jcnt, i):
    """Lane i's tokens and litwords up to its end step, NOPs dropped."""
    end = int(jcnt[2, i]) + 1
    keep = jtok[:end, i] != cq.TOK_NOP
    return jtok[:end, i][keep], jlitw[:end, i][keep]


def test_plain_matches_jax_kernel(jax_run):
    sub, jtok, jlitw, jcnt, grid = jax_run
    n = len(sub)
    streams, lens = cq.from_jax_batch(grid)
    _, _, tg = qe.inputs(sub)
    before = cq.LAUNCHES["plain"]
    tok, litw, cnt = cq.qtm_phase_a(
        streams[:n].contiguous(), lens[:n].contiguous(), tg, 10,
        tcap=max(c.out_len for c in sub))
    assert cq.LAUNCHES["plain"] == before + 1
    cnt = cnt.numpy()
    np.testing.assert_array_equal(cnt[:2], jcnt[:2, :n])
    for i, c in enumerate(sub):
        k = int(cnt[2, i])
        jt, jl = _jax_trace(jtok, jlitw, jcnt, i)
        np.testing.assert_array_equal(tok[i, :k].numpy(), jt, c.name)
        np.testing.assert_array_equal(litw[i, :k].numpy(), jl, c.name)
        got = resolve_lzx(tok[i:i + 1, :k].numpy(), litw[i:i + 1, :k].numpy(),
                          [c.out_len], [0], [0], 10, n_threads=1)
        assert got[0].tobytes() == c.raw, c.name


def _extract(d, blob):
    """{name: bytes or the error class's name}, in directory order."""
    sink_cls = JaxBytesSink if isinstance(d, JaxCabDecompressor) \
        else BytesSink
    cab = d.open(blob)
    got = {}
    for f in cab.files:
        sink = sink_cls()
        try:
            d.extract(f, sink)
            got[f.filename] = sink.getvalue()
        except Exception as e:   # the class name is the point
            got[f.filename] = type(e).__name__
    return got


def test_window_wrap_flush_follows_reference(jax_run):
    """ROADMAP Queue 3: the JAX package's whole-folder engines serve every
    file of this folder, the reference codec refuses three of them."""
    sub, jtok, jlitw, jcnt, _ = jax_run
    files, wb = qe.wrap_flush_files()
    want_all = dict(files)
    blob = jax_cab_c.write_cab(folders=[jax_cab_c.FolderSpec(files,
                                                             "quantum", wb)])
    scalar = _extract(JaxCabDecompressor(engine="scalar"), blob)
    assert scalar == dict(want_all, **{n: "DecrunchError"
                                       for n in ("f2.bin", "f3.bin",
                                                 "f4.bin")})
    # the TPU engine's bytes: the Pallas trace of this folder, resolved
    i = [c.name for c in sub].index("wrap_flush_folder")
    jt, jl = _jax_trace(jtok, jlitw, jcnt, i)
    tpu = resolve_lzx(jt[None], jl[None], [sub[i].out_len], [0], [0], wb,
                      n_threads=1)[0].tobytes()
    assert tpu == b"".join(d for _, d in files)
    assert _extract(JaxCabDecompressor(engine="native"), blob) == want_all
    d = lt.create_cab_decompressor(engine="cuda", device="cpu")
    assert _extract(d, blob) == scalar
    assert d.cuda_qtm_engine.declines == {
        "window-wrap flush across a file edge": 1}
    starts, ends = d.cuda_qtm_engine.wrap_spans[0]
    assert list(starts) == [977, 2013] and list(ends) == [1024, 2048]


def _twin_launch(twin, s, lens, tg, wb, tcap, state=None):
    """The twin's K4 launch on CPU tensors; state None starts fresh."""
    L = s.shape[0]
    fresh = state is None
    if fresh:
        state = torch.empty((L, cq.STATE_BYTES), dtype=torch.uint8)
    tok = torch.full((L, tcap), -1, dtype=torch.int32)
    litw = torch.zeros((L, tcap), dtype=torch.int32)
    cnt = torch.zeros((8, L), dtype=torch.int32)
    assert twin.qt_decode_host(
        s.data_ptr(), s.stride(0), lens.data_ptr(), tg.data_ptr(), L, wb,
        int(fresh), state.data_ptr(), tok.data_ptr(), litw.data_ptr(), tcap,
        cnt.data_ptr()) == 0
    return tok, litw, cnt, state


def _twin():
    try:
        return kernels.host_twin_qtm()
    except RuntimeError as e:
        pytest.skip(f"g++ build of the kernel core unavailable: {e}")


@pytest.mark.parametrize("wb", [10, 11, 12, 16, 21])
def test_plain_and_twin_match_reference(cases, wb):
    sub = _window(cases, wb)
    s, lens, tg = qe.inputs(sub)
    tcap = max(1, max(c.out_len for c in sub))
    plain = cq.qtm_phase_a_plain(s, lens, tg, wb, tcap=tcap)
    got = qe.resolve(sub, *(t.numpy() for t in plain[:3]))
    for g, c, err in zip(got, sub, plain[2][0].tolist()):
        assert g == c.raw, c.name
        assert err == (0 if c.raw is not None else 1), c.name
    # row 4 counts the lap-crossing matches of the trace
    for i, c in enumerate(sub):
        k = int(plain[2][2, i])
        assert len(wrap_spans(plain[0][i, :k].numpy(), 0, wb)[0]) == \
            int(plain[2][4, i]), c.name
    twin = _twin()
    assert twin.qt_state_bytes() == cq.STATE_BYTES
    res = _twin_launch(twin, s, lens, tg, wb, tcap)
    for a, b in zip(res, plain):
        assert torch.equal(a, b)


def test_rescales_and_sorts_fire(cases):
    """The ``rescales`` stream runs the selector model through its fifth
    rescale (the exchange sort resets the countdown to 50) and halves
    literal models; the window-2^10 wrap makes row 4 count."""
    sub = _window(cases, 12)
    s, lens, tg = qe.inputs(sub)
    _, _, cnt, state = cq.qtm_phase_a_plain(s, lens, tg, 12,
                                            tcap=int(tg.max()))
    recs = state.numpy().view(cq.STATE_DTYPE).reshape(-1)
    i = [c.name for c in sub].index("rescales")
    left = recs[i]["m"]["rescales_left"]
    assert 4 < left[0] < 50          # selector: sorted, then halved
    assert min(left[1:5]) < 4        # a literal model halved
    w10 = _window(cases, 10)
    _, _, cnt, _ = cq.qtm_phase_a_plain(*qe.inputs(w10), 10,
                                        tcap=max(c.out_len for c in w10))
    assert int(cnt[4].sum()) > 0


@pytest.mark.parametrize("impl", ["plain", "twin"])
def test_segments_through_state_equal_one_launch(cases, impl):
    twin = _twin() if impl == "twin" else None
    for wb in (10, 16):
        sub = [c for c in _window(cases, wb) if c.raw is not None]
        s, lens, tg = qe.inputs(sub)

        def launch(targets, tcap, state):
            if twin is not None:
                return _twin_launch(twin, s, lens, targets, wb, tcap, state)
            return cq.qtm_phase_a(s, lens, targets, wb, tcap=tcap,
                                  state=state, return_state=True)

        one = launch(tg, max(1, max(c.out_len for c in sub)), None)
        tok, litw, state, n = le.segmented(launch, tg.numpy(), 32768)
        assert n > 1
        cnt = one[2].numpy()
        for i in range(len(sub)):
            k = int(cnt[2, i])
            assert np.array_equal(tok[i, :k], one[0][i, :k].numpy())
            assert np.array_equal(litw[i, :k], one[1][i, :k].numpy())
        assert qe.resolve(sub, tok, litw, cnt) == [c.raw for c in sub]
        # the records end identical: a segment edge is a frame start
        assert torch.equal(state, one[3])


def test_token_cap_flags_err2(cases):
    sub = _window(cases, 16)
    s, lens, tg = qe.inputs(sub)
    full = cq.qtm_phase_a(s, lens, tg, 16, tcap=int(tg.max()))[2][2]
    _, _, cnt = cq.qtm_phase_a(s, lens, tg, 16, tcap=64)
    assert (full > 64).sum() >= 2
    for i in range(len(sub)):
        if sub[i].raw is not None:
            assert int(cnt[0, i]) == (2 if int(full[i]) > 64 else 0)
        assert int(cnt[2, i]) <= 64


def test_constants_equal_jax():
    assert (cq.TOK_NOP, cq.TOK_LIT, cq.TOK_MATCH) == (
        pq.TOK_NOP, pq.TOK_LIT, pq.TOK_MATCH)
    assert (cq.NT, cq.TROWS, cq.FRAME) == (pq.NT, pq.TROWS, pq.FRAME)
    assert cq.MODEL_STARTS == pq._MODEL_STARTS
    for wb in range(10, 22):
        assert cq.model_sizes(wb) == pq._model_sizes(wb)
    assert cq.EXTRA_BITS == pq.EXTRA_BITS
    assert cq.POSITION_BASE == pq.POSITION_BASE
    assert cq.LENGTH_EXTRA == pq.LENGTH_EXTRA
    assert cq.LENGTH_BASE == pq.LENGTH_BASE


def test_cuda_device_raises_without_gpu(cases):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    s, lens, tg = qe.inputs(cases[:1])
    with pytest.raises(RuntimeError, match="cuda"):
        cq.qtm_phase_a(s, lens, tg, 10, tcap=8, device="cuda")


def test_wrapper_checks_inputs(cases):
    s, lens, tg = qe.inputs(cases[:1])
    with pytest.raises(ValueError):
        cq.qtm_phase_a(s, lens, torch.zeros(2, dtype=torch.int32), 10,
                       tcap=8)
    with pytest.raises(ValueError, match="window_bits"):
        cq.qtm_phase_a(s, lens, tg, 22, tcap=8)
    with pytest.raises(ValueError, match="state"):
        cq.qtm_phase_a(s, lens, tg, 10, tcap=8,
                       state=torch.zeros((1, 16), dtype=torch.uint8))
