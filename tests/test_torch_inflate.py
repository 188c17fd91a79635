"""K1 (DEFLATE phase A) of the PyTorch port against the JAX Pallas kernel.

The edge-case batch (libmspack_tpu_torch/edge_cases.py: stored, fixed,
dynamic and multi-block frames, distance-1 and length-258 matches, a frame
reaching a whole frame back, and one corrupt frame per error class) goes
through ``pallas_inflate.inflate_phase_a`` in interpret mode and through
the port's plain version, fed from the same packed grid by
``from_jax_batch``. Tolerance: exact — counts rows 0 and 1 equal on every
lane and equal bytes on every valid lane. The g++ build of the kernel's
C++ core is held to the plain version token for token.
"""
import numpy as np
import pytest
import torch

from libmspack_tpu.ops import pallas_inflate as pa
from libmspack_tpu_torch import edge_cases as ec
from libmspack_tpu_torch import kernels
from libmspack_tpu_torch.ops import cuda_inflate as ci

FRAME = 512    # small frames keep the interpreted kernel near 10 s
T_PAD = 768


@pytest.fixture(scope="module")
def batch():
    cases = ec.edge_case_batch(FRAME, seed=1)
    frames = [c.stream for c in cases]
    hists = [c.hist for c in cases]
    tok, litw, cnt = pa.inflate_phase_a(frames, hists=hists, T_PAD=T_PAD,
                                        interpret=True)
    grid, _ = pa.pack_streams(frames)
    hist_grid = np.zeros((8, 128), np.int32)
    hist_grid.reshape(-1)[:len(hists)] = hists
    streams, lens, hist_t = ci.from_jax_batch(grid, hist_grid)
    return dict(cases=cases, jax=(np.asarray(tok), np.asarray(litw),
                                  np.asarray(cnt)),
                port_in=(streams, lens, hist_t))


def test_plain_matches_jax_kernel(batch):
    jtok, jlitw, jcnt = batch["jax"]
    before = ci.LAUNCHES["plain"]
    tok, litw, cnt = ci.inflate_phase_a(*batch["port_in"], tcap=2 * FRAME)
    assert ci.LAUNCHES["plain"] == before + 1
    cnt = cnt.numpy()
    # every one of the 1024 lanes, the empty ones included
    np.testing.assert_array_equal(cnt[0], jcnt[0])
    np.testing.assert_array_equal(cnt[1], jcnt[1])
    cases = batch["cases"]
    assert {c.name for i, c in enumerate(cases) if cnt[0, i]} == {
        "block_type3", "distance_code30", "distance_beyond_history",
        "oversubscribed_table", "stored_len_nlen"}
    for i, c in enumerate(cases):
        if c.raw is None:
            continue
        hist = cases[i - 1].raw if c.chained else b""
        want = pa.replay_trace(jtok[:, i], jlitw[:, i], len(c.raw), hist)
        got = pa.replay_trace(tok[i].numpy(), litw[i].numpy(), len(c.raw),
                              hist)
        assert want == got == c.raw, c.name


@pytest.mark.parametrize("frame", [FRAME, 32768])
def test_host_twin_matches_plain(frame):
    try:
        twin = kernels.host_twin()
    except RuntimeError as e:
        pytest.skip(f"g++ build of the kernel core unavailable: {e}")
    cases = ec.edge_case_batch(frame, seed=2, variants=2)
    s, lens = ci.pack_streams([c.stream for c in cases])
    hists = torch.tensor([c.hist for c in cases], dtype=torch.int32)
    ptok, plitw, pcnt = ci.inflate_phase_a_plain(s, lens, hists, tcap=frame)
    L = len(cases)
    tok = torch.full((L, frame), -1, dtype=torch.int32)
    litw = torch.zeros((L, frame), dtype=torch.int32)
    cnt = torch.zeros((8, L), dtype=torch.int32)
    assert twin.dc_inflate_host(s.data_ptr(), s.stride(0), lens.data_ptr(),
                                hists.data_ptr(), L, tok.data_ptr(),
                                litw.data_ptr(), frame, cnt.data_ptr()) == 0
    assert torch.equal(cnt, pcnt)
    assert torch.equal(tok, ptok) and torch.equal(litw, plitw)
    got = ec.resolve_valid(cases, tok.numpy(), litw.numpy(), cnt.numpy())
    for l0, lanes in ec.folders_of(cases):
        assert got[l0] == b"".join(cases[i].raw for i in lanes)


def test_token_cap_flags_err2():
    cases = ec.edge_case_batch(FRAME, seed=3)[:5]
    s, lens = ci.pack_streams([c.stream for c in cases])
    hists = torch.zeros(len(cases), dtype=torch.int32)
    _, _, cnt = ci.inflate_phase_a(s, lens, hists, tcap=8)
    ntok_full = ci.inflate_phase_a(s, lens, hists)[2][2]
    for i in range(len(cases)):
        assert int(cnt[0, i]) == (2 if int(ntok_full[i]) > 8 else 0)
        assert int(cnt[2, i]) <= 8


def test_fixed_tables_equal_jax():
    for (keys, first, limit), lens, n in (
            (ci.FIXED_LIT_KEYS, pa.FIXED_LIT_LENS, pa.NLIT),
            (ci.FIXED_DIST_KEYS, pa.FIXED_DIST_LENS[:30], pa.NDIST)):
        jk, jf, jl = pa._canonical_keys(lens, n)
        np.testing.assert_array_equal(keys, jk)
        np.testing.assert_array_equal(first, jf)
        np.testing.assert_array_equal(limit, jl)


def test_constants_equal_jax():
    assert (ci.TOK_NOP, ci.TOK_LIT, ci.TOK_MATCH) == (
        pa.TOK_NOP, pa.TOK_LIT, pa.TOK_MATCH)
    assert (ci.NLIT, ci.NDIST) == (pa.NLIT, pa.NDIST)
    assert ci.BITLEN_ORDER == pa.BITLEN_ORDER
    assert ci.FIXED_LIT_LENS == pa.FIXED_LIT_LENS
    assert ci.FIXED_DIST_LENS == pa.FIXED_DIST_LENS


def test_cuda_device_raises_without_gpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    s, lens = ci.pack_streams([b"\x03\x00"])
    with pytest.raises(RuntimeError, match="cuda"):
        ci.inflate_phase_a(s, lens, torch.zeros(1, dtype=torch.int32),
                           device="cuda")


def test_wrapper_checks_inputs():
    s, lens = ci.pack_streams([b"\x03\x00"])
    with pytest.raises(ValueError):
        ci.inflate_phase_a(s, lens, torch.zeros(2, dtype=torch.int32))
    with pytest.raises(ValueError):
        ci.inflate_phase_a(s.int(), lens, torch.zeros(1, dtype=torch.int32))

