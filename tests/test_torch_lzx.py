"""K3 (LZX phase A) of the PyTorch port against the JAX Pallas kernel.

The LZX edge batch (libmspack_tpu_torch/lzx_edge_cases.py) goes through
the port's plain version and, for its window-2^15 and DELTA groups, through
``pallas_lzx.lzx_phase_a`` in interpret mode (two interpreted calls, shared
by a module fixture), fed from the same packed grid by ``from_jax_batch``.
Tolerance: exact — counts rows 0, 1, 4 and 5 equal and equal bytes through
``replay_trace`` on every lane but the known faults of the TPU kernel
(ROADMAP Queue 3), where the port follows the reference codec:
``stored_odd_frame_cross`` (the TPU kernel reads a byte late),
``offset_past_frame_start`` and ``r0_above_2g_used`` (the TPU kernel
accepts what the reference rejects), and ``zero_length_verbatim`` and
``zero_length_aligned`` (the TPU kernel flags what the reference accepts).
On the whole batch the plain version resolves to the reference
codec's bytes, the g++ build of the kernel's C++ core equals the plain
version token for token and state byte for state byte, and a decode in
segments through the state record equals one launch.
"""
import numpy as np
import pytest
import torch

from libmspack_tpu.ops import pallas_lzx as plx
from libmspack_tpu_torch import kernels
from libmspack_tpu_torch import lzx_edge_cases as le
from libmspack_tpu_torch.ops import cuda_lzx as cl

JAX_GROUPS = [(15, False), (17, True)]
# lanes where the TPU kernel departs from the reference codec: its bytes
# differ, it accepts a stream the reference rejects, or it flags a stream
# the reference accepts
TPU_WRONG_BYTES = {"stored_odd_frame_cross"}
TPU_ACCEPTS = {"offset_past_frame_start", "r0_above_2g_used"}
TPU_FLAGS = {"zero_length_verbatim", "zero_length_aligned"}


@pytest.fixture(scope="module")
def cases():
    return le.lzx_edge_batch(seed=0)


def _group(cases, key):
    return [cases[i] for i in le.groups(cases)[key]]


@pytest.fixture(scope="module")
def jax_runs(cases):
    """The TPU kernel, interpreted, on each group of JAX_GROUPS, at the
    T_PAD that TpuLzxEngine._launch_batch picks."""
    out = {}
    for key in JAX_GROUPS:
        sub = _group(cases, key)
        sizes = [c.out_len for c in sub]
        t_pad = max(4096, 1 << (max(sizes) // 2 + 4096 - 1).bit_length())
        streams = [c.stream for c in sub]
        tok, litw, cnt = plx.lzx_phase_a(
            streams, sizes, key[0], hists=[len(c.ref) for c in sub],
            is_delta=key[1], T_PAD=t_pad, interpret=True)
        grid, _ = plx.pack_streams(streams)
        out[key] = (sub, np.asarray(tok), np.asarray(litw), np.asarray(cnt),
                    grid)
    return out


@pytest.mark.parametrize("key", JAX_GROUPS)
def test_plain_matches_jax_kernel(jax_runs, key):
    sub, jtok, jlitw, jcnt, grid = jax_runs[key]
    n = len(sub)
    streams, lens = cl.from_jax_batch(grid)
    _, _, tg, hs = le.inputs(sub)
    before = cl.LAUNCHES["plain"]
    tok, litw, cnt = cl.lzx_phase_a(
        streams[:n].contiguous(), lens[:n].contiguous(), tg, hs, key[0],
        is_delta=key[1], tcap=max(c.out_len for c in sub))
    assert cl.LAUNCHES["plain"] == before + 1
    cnt = cnt.numpy()
    # row 0: flagged exactly where the TPU kernel flags, class 1 where 1
    known = np.array([c.name in TPU_ACCEPTS | TPU_FLAGS for c in sub])
    np.testing.assert_array_equal((cnt[0] != 0)[~known],
                                  (jcnt[0, :n] != 0)[~known])
    assert (cnt[0][(jcnt[0, :n] == 1) & ~known] == 1).all()
    for i, c in enumerate(sub):
        if c.raw is None:
            assert cnt[0, i] == 1, c.name
            assert jcnt[0, i] == (0 if c.name in TPU_ACCEPTS else 1)
            continue
        if c.name in TPU_FLAGS:
            assert cnt[0, i] == 0 and jcnt[0, i] != 0, c.name
            got = plx.replay_trace(tok[i].numpy(), litw[i].numpy(),
                                   c.out_len, key[0], ref_data=c.ref)
            assert got == c.raw, c.name
            continue
        np.testing.assert_array_equal(cnt[[1, 4, 5], i],
                                      jcnt[[1, 4, 5], i], err_msg=c.name)
        ref = c.ref
        want = plx.replay_trace(jtok[:, i], jlitw[:, i], c.out_len, key[0],
                                ref_data=ref)
        got = plx.replay_trace(tok[i].numpy(), litw[i].numpy(), c.out_len,
                               key[0], ref_data=ref)
        if c.name in TPU_WRONG_BYTES:
            assert got != want
            assert got == c.raw
        else:
            assert got == want, c.name
            if not cnt[4, i] or not cnt[5, i]:
                assert got == c.raw, c.name


def _twin_launch(twin, s, lens, tg, hs, wb, delta, tcap, state=None):
    """The twin's K3 launch on CPU tensors; state None starts fresh."""
    L = s.shape[0]
    fresh = state is None
    if fresh:
        state = torch.empty((L, cl.STATE_BYTES), dtype=torch.uint8)
    tok = torch.full((L, tcap), -1, dtype=torch.int32)
    litw = torch.zeros((L, tcap), dtype=torch.int32)
    cnt = torch.zeros((8, L), dtype=torch.int32)
    assert twin.lz_decode_host(
        s.data_ptr(), s.stride(0), lens.data_ptr(), tg.data_ptr(),
        hs.data_ptr(), L, wb, int(delta), int(fresh), state.data_ptr(),
        tok.data_ptr(), litw.data_ptr(), tcap, cnt.data_ptr()) == 0
    return tok, litw, cnt, state


def _twin():
    try:
        return kernels.host_twin_lzx()
    except RuntimeError as e:
        pytest.skip(f"g++ build of the kernel core unavailable: {e}")


@pytest.mark.parametrize("key", [(15, False), (16, False), (21, False),
                                 (17, True), (25, True)])
def test_plain_and_twin_match_reference(cases, key):
    sub = _group(cases, key)
    s, lens, tg, hs = le.inputs(sub)
    tcap = max(c.out_len for c in sub)
    plain = cl.lzx_phase_a_plain(s, lens, tg, hs, key[0], is_delta=key[1],
                                 tcap=tcap)
    got = le.resolve(sub, *(t.numpy() for t in plain[:3]))
    for g, c in zip(got, sub):
        assert g == c.raw, c.name
    twin = _twin()
    assert twin.lz_state_bytes() == cl.STATE_BYTES
    res = _twin_launch(twin, s, lens, tg, hs, key[0], key[1], tcap)
    for a, b in zip(res, plain):
        assert torch.equal(a, b)


@pytest.mark.parametrize("impl", ["plain", "twin"])
@pytest.mark.parametrize("seg", [32768, 65536])
def test_segments_through_state_equal_one_launch(cases, impl, seg):
    twin = _twin() if impl == "twin" else None
    for key in ((15, False), (16, False), (21, False)):
        sub = [c for c in _group(cases, key) if c.raw is not None]
        s, lens, tg, hs = le.inputs(sub)

        def launch(targets, tcap, state):
            if twin is not None:
                return _twin_launch(twin, s, lens, targets, hs, key[0],
                                    False, tcap, state)
            return cl.lzx_phase_a(s, lens, targets, hs, key[0], tcap=tcap,
                                  state=state, return_state=True)

        one = launch(tg, max(c.out_len for c in sub), None)
        tok, litw, state, _ = le.segmented(launch, tg.numpy(), seg)
        cnt = one[2].numpy()
        got = le.resolve(sub, tok, litw, cnt)
        want = le.resolve(sub, one[0].numpy(), one[1].numpy(), cnt)
        for g, w, c in zip(got, want, sub):
            assert g == w == c.raw, c.name
        # the records end identical: a segment edge is a frame start
        assert torch.equal(state, one[3])


def test_token_cap_flags_err2(cases):
    sub = _group(cases, (16, False))
    s, lens, tg, hs = le.inputs(sub)
    full = cl.lzx_phase_a(s, lens, tg, hs, 16, tcap=max(tg))[2][2]
    _, _, cnt = cl.lzx_phase_a(s, lens, tg, hs, 16, tcap=64)
    assert (full > 64).sum() >= 2
    for i in range(len(sub)):
        assert int(cnt[0, i]) == (2 if int(full[i]) > 64 else 0)
        assert int(cnt[2, i]) <= 64


def test_constants_equal_jax():
    assert (cl.TOK_NOP, cl.TOK_LIT, cl.TOK_MATCH) == (
        plx.TOK_NOP, plx.TOK_LIT, plx.TOK_MATCH)
    assert cl.POSITION_SLOTS == plx.POSITION_SLOTS
    assert (cl.NPRE, cl.NLEN, cl.NALN) == (plx.NPRE, plx.NLEN, plx.NALN)


def test_cuda_device_raises_without_gpu(cases):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    s, lens, tg, hs = le.inputs(cases[:1])
    with pytest.raises(RuntimeError, match="cuda"):
        cl.lzx_phase_a(s, lens, tg, hs, 15, tcap=8, device="cuda")


def test_wrapper_checks_inputs(cases):
    s, lens, tg, hs = le.inputs(cases[:1])
    with pytest.raises(ValueError):
        cl.lzx_phase_a(s, lens, tg, torch.zeros(2, dtype=torch.int32), 15,
                       tcap=8)
    with pytest.raises(ValueError, match="window_bits"):
        cl.lzx_phase_a(s, lens, tg, hs, 22, tcap=8)
    with pytest.raises(ValueError, match="state"):
        cl.lzx_phase_a(s, lens, tg, hs, 15, tcap=8,
                       state=torch.zeros((1, 16), dtype=torch.uint8))
