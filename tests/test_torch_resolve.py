"""K2 (device phase B) of the PyTorch port against the JAX Pallas kernel.

The port's phase A traces go through ``pallas_resolve.resolve_frames_device``
in interpret mode, with JAX's own 2 KiB slots (the same monkeypatch as
tests/test_pallas_resolve.py), and through the port's plain version.
Covered: the cross-frame history chain, mixed block types, distance-1 runs
and match tokens that carry pending literals. Tolerance: exact bytes and
counts.
"""
import zlib

import numpy as np
import pytest
import torch

from libmspack_tpu.ops import pallas_resolve as pr
from libmspack_tpu_torch.ops import cuda_inflate as ci
from libmspack_tpu_torch.ops import cuda_resolve as cr

F = 16 * 128  # JAX's slot with HROWS = OROWS = 16


@pytest.fixture
def small_slots(monkeypatch):
    monkeypatch.setattr(pr, "HROWS", 16)
    monkeypatch.setattr(pr, "OROWS", 16)


def deflate(raw, level=9, dict_=None):
    args = (level, zlib.DEFLATED, -15, 9, zlib.Z_DEFAULT_STRATEGY)
    co = zlib.compressobj(*args, dict_) if dict_ else zlib.compressobj(*args)
    return co.compress(raw) + co.flush()


def frames_and_traces():
    rng = np.random.RandomState(11)
    words = [b"alpha ", b"beta ", b"gamma ", b"delta ", b"epsilon "]
    text = b"".join(words[i] for i in rng.randint(0, 5, 2000))
    d0, d1 = text[:F], text[F:2 * F]
    raws = [
        d0,                                                   # chain head
        d1,                                                   # chained
        rng.randint(0, 256, 1000).astype(np.uint8).tobytes(),  # stored
        bytes([9]) * 700,                                     # dist-1 run
        (b"xyz" + bytes(rng.randint(97, 100, 5).astype(np.uint8))) * 90,
    ]
    frames = [deflate(d0), deflate(d1, dict_=d0), deflate(raws[2], 6),
              deflate(raws[3], 1), deflate(raws[4], 9)]
    hists = [0, 32768, 0, 0, 0]
    flags = [0, 1, 0, 0, 0]
    s, lens = ci.pack_streams(frames)
    tok, litw, cnt = ci.inflate_phase_a(
        s, lens, torch.tensor(hists, dtype=torch.int32), tcap=F)
    assert (cnt[0] == 0).all()
    assert [int(n) for n in cnt[1]] == [len(r) for r in raws]
    return raws, flags, tok, litw, cnt


def test_plain_matches_jax_copy_machine(small_slots):
    raws, flags, tok, litw, cnt = frames_and_traces()
    ntok = cnt[2].contiguous()
    # match tokens carrying pending literals are on the path
    matches = tok[tok >= ci.TOK_MATCH]
    assert ((matches >> 25) & 3).gt(0).any()
    sizes = [len(r) for r in raws]
    jout, jcnt = pr.resolve_frames_device(
        tok.numpy().T, litw.numpy().T, sizes, hist_flags=flags,
        interpret=True, n_steps=int(ntok.max()))
    jout, jcnt = np.asarray(jout), np.asarray(jcnt)
    before = cr.LAUNCHES["plain"]
    out, counts = cr.resolve_frames_device(tok, litw, ntok, sizes, flags)
    assert cr.LAUNCHES["plain"] == before + 1
    np.testing.assert_array_equal(counts.numpy(), jcnt[:len(raws)])
    off = np.concatenate([[0], np.cumsum(sizes)])
    for i, raw in enumerate(raws):
        got = bytes(out[off[i]:off[i + 1]].numpy())
        assert got == jout[i, :sizes[i]].tobytes() == raw, i


def test_plain_matches_native_resolver():
    from libmspack_tpu import native

    raws, flags, tok, litw, cnt = frames_and_traces()
    sizes = [len(r) for r in raws]
    out, counts = cr.resolve_frames_device(tok, litw, cnt[2].contiguous(),
                                           sizes, flags)
    arena = np.zeros(sum(sizes), np.uint8)
    offs = [0, sizes[0] + sizes[1]] + list(np.cumsum(sizes)[2:])
    assert native.resolve_traces(tok.numpy(), litw.numpy(), [0, 2, 3, 4],
                                 [2, 1, 1, 1], sizes, arena,
                                 [int(o) for o in offs], 1) == 0
    assert bytes(out.numpy()) == arena.tobytes() == b"".join(raws)
    assert counts.tolist() == sizes


def test_match_before_chain_start_flags_lane():
    tok = torch.full((2, 4), ci.TOK_NOP, dtype=torch.int32)
    tok[0, 0] = ci.TOK_LIT | 2
    tok[1, 0] = ci.TOK_MATCH | (3 << 16) | 2      # dist 3 > 2 bytes behind
    litw = torch.zeros((2, 4), dtype=torch.int32)
    litw[0, 0] = 0x4241
    out, counts = cr.resolve_frames_device(
        tok, litw, torch.tensor([1, 1], dtype=torch.int32), [2, 3], [0, 1])
    assert counts.tolist() == [2, -1]
    out, counts = cr.resolve_frames_device(
        tok, litw, torch.tensor([1, 1], dtype=torch.int32), [2, 3], [0, 0])
    assert counts.tolist() == [2, -1]


def test_wrapper_checks_inputs():
    tok = torch.zeros((2, 4), dtype=torch.int32)
    with pytest.raises(ValueError):
        cr.resolve_frames_device(tok, tok[:, :2], torch.zeros(
            2, dtype=torch.int32), [1, 1], [0, 0])
    with pytest.raises(ValueError):
        cr.resolve_frames_device(tok, tok, torch.zeros(
            2, dtype=torch.int32), [1], [0, 0])
