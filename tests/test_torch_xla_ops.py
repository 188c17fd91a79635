"""The port's XLA-level ops against the JAX package's, on the CPU.

``libmspack_tpu_torch/ops/{bitview,e8,search,inflate,lzx}.py`` and
``entry.py`` are PyTorch ports of the JAX package's ``ops/bitview.py``,
``ops/e8.py``, ``ops/search.py``, ``ops/inflate_jax.py``,
``ops/lzx_jax.py`` and ``__graft_entry__.py`` (XLA ops, no Pallas). The
same seeded inputs go through both; tolerance 0: every output is an
integer or a byte, and every decline carries the same message.
"""
import random
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libmspack_tpu import native as jax_native
from libmspack_tpu.codecs.lzx import _e8_transform
from libmspack_tpu.compress import lzx_c, lzx_e, mszip_c
from libmspack_tpu.ops import bitview as jbv
from libmspack_tpu.ops import e8 as je8
from libmspack_tpu.ops import inflate_jax as ij
from libmspack_tpu.ops import lzx_jax as lj
from libmspack_tpu.ops import search as jsearch
from libmspack_tpu_torch.ops import bitview, e8, search
from libmspack_tpu_torch.ops import inflate as ti
from libmspack_tpu_torch.ops import lzx as tl

CPU = "cpu"


def _t(a):
    return torch.from_numpy(np.array(a))


# ---------------------------------------------------------------- bitview --

def test_bitview_peeks_equal_jax():
    rng = np.random.RandomState(1)
    data = rng.randint(0, 256, 300, dtype=np.uint8)
    padded = np.asarray(jbv.pad_to(jnp.asarray(data)))
    assert np.array_equal(bitview.pad_to(_t(data)).numpy(), padded)
    pos = np.arange(0, 8 * 300, dtype=np.int32)
    for n in (1, 7, 15, 24):
        want = np.asarray(jbv.peek_lsb(jnp.asarray(padded), jnp.asarray(pos),
                                       n))
        got = bitview.peek_lsb(_t(padded), _t(pos), n).numpy()
        assert np.array_equal(got, want.astype(np.int64)), n
    for n in (1, 9, 16, 17):
        want = np.asarray(jbv.peek_msb16(jnp.asarray(padded),
                                         jnp.asarray(pos), n))
        got = bitview.peek_msb16(_t(padded), _t(pos), n).numpy()
        assert np.array_equal(got, want.astype(np.int64)), n
    for n in (1, 5, 15):
        assert np.array_equal(bitview.bitrev_table(n), jbv.bitrev_table(n))


def test_take_follows_jnp_take():
    x = np.arange(10, dtype=np.int32) * 3
    idx = np.array([0, 9, 10, 11, -1, -10, -11, 1 << 20], np.int32)
    want = np.asarray(jnp.take(jnp.asarray(x), jnp.asarray(idx)))
    got = bitview.take(_t(x), _t(idx), bitview.I32_FILL).numpy()
    assert np.array_equal(got, want)


# --------------------------------------------------------------------- e8 --

def _e8_frame(rng, n):
    frame = bytearray(rng.randrange(256) for _ in range(n))
    for _ in range(n // 12):
        frame[rng.randrange(n)] = 0xE8
    frame[0:3] = b"\xe8\xe8\xe8"     # leaders in each other's shadow
    return bytes(frame)


@pytest.mark.parametrize("decode", [True, False])
def test_e8_transform_equals_jax(decode):
    rng = random.Random(3)
    for n, curpos, filesize in ((11, 0, 100), (4000, 32768, 1 << 20),
                                (32768, 0, 12000000)):
        frame = _e8_frame(rng, n)
        want = np.asarray(je8.e8_transform(
            jnp.asarray(np.frombuffer(frame, np.uint8)), jnp.int32(curpos),
            jnp.int32(filesize), decode))
        got = e8.e8_transform(_t(np.frombuffer(frame, np.uint8).copy()),
                              curpos, filesize, decode).numpy()
        assert np.array_equal(got, want), (n, decode)
        if decode:
            assert e8.e8_decode_frame(frame, curpos, filesize, device=CPU) \
                == bytes(_e8_transform(bytearray(frame), curpos, filesize))


def test_signature_positions_equal_jax():
    rng = random.Random(4)
    data = bytearray(rng.randrange(256) for _ in range(5000))
    for at in (0, 17, 2500, 4996):
        data[at:at + 4] = b"MSCF"
    data[4998:] = b"MS"
    for blob in (bytes(data), b"MSC", b"MSCF"):
        assert search.signature_positions(blob, device=CPU) == \
            jsearch.signature_positions(blob)


# ---------------------------------------------------------------- inflate --

def _deflate(data, level=9, flush_every=None):
    z = zlib.compressobj(level, zlib.DEFLATED, -15)
    if flush_every is None:
        return z.compress(data) + z.flush()
    out = b""
    for i in range(0, len(data), flush_every):
        out += z.compress(data[i:i + flush_every]) + z.flush(
            zlib.Z_FULL_FLUSH)
    return out + z.flush()


@pytest.fixture(scope="module")
def batch():
    """Four frames of one phase-A batch: text, mixed, fixed huffman, and
    garbage with a valid fixed-huffman header (its chain goes invalid
    near the top bit positions)."""
    rng = random.Random(9)
    text = b"phase A parity " * 600
    mixed = bytes(rng.randrange(256) for _ in range(3000)) + text[:5000]
    zf = zlib.compressobj(9, zlib.DEFLATED, -15, 9, zlib.Z_FIXED)
    fixed = zf.compress(text[:4000]) + zf.flush()
    garbage = b"\x03" + bytes(rng.randrange(256) for _ in range(1000))
    frames = [_deflate(text), _deflate(mixed), fixed, garbage]
    S = 40960
    B = len(frames)
    data = np.zeros((B, S), np.uint8)
    lit = np.zeros((B, 1 << 15), np.int32)
    dist = np.zeros((B, 1 << 15), np.int32)
    starts = np.zeros(B, np.int32)
    for i, f in enumerate(frames):
        data[i, :len(f)] = np.frombuffer(f, np.uint8)
        want = ij._parse_block_header(f, 0)
        got = ti._parse_block_header(f, 0)
        assert want[:2] == got[:2] and want[4] == got[4]
        assert np.array_equal(want[2], got[2])
        assert np.array_equal(want[3], got[3])
        lit[i], dist[i], starts[i] = got[2], got[3], got[4]
    return data, starts, lit, dist, S


def test_inflate_phase_a_equals_jax(batch):
    data, starts, lit, dist, S = batch
    want = ij._phase_a(jnp.asarray(data.reshape(-1)), jnp.asarray(starts),
                       jnp.asarray(lit), jnp.asarray(dist), S * 8,
                       ij.MAX_TOKENS, S)
    got = ti._phase_a(_t(data.reshape(-1)), _t(starts), _t(lit), _t(dist),
                      S * 8, ti.MAX_TOKENS, S)
    for w, g in zip(want, got):
        assert np.array_equal(np.asarray(w), g.numpy())
    assert bool(got[5][3]) and not bool(got[5][:3].any())


def test_inflate_phase_b_equals_jax(batch):
    data, starts, lit, dist, S = batch
    tk, to, td, tlit = (t[:3] for t in ti._phase_a(
        _t(data.reshape(-1)), _t(starts), _t(lit), _t(dist), S * 8,
        ti.MAX_TOKENS, S)[:4])
    live = (tk == 0) | (tk == 1)
    lens = torch.where(live, to, 0).sum(dim=1).numpy()
    base = np.concatenate([[0], np.cumsum(lens)[:-1]]).astype(np.int32)
    N = 1 << int(lens.sum() - 1).bit_length()
    want = ij._phase_b(*(jnp.asarray(t.numpy()) for t in (tk, to, td, tlit)),
                       jnp.asarray(base), N)
    got = ti._phase_b(tk, to, td, tlit, _t(base), N)
    assert np.array_equal(np.asarray(want[0]), got[0].numpy())
    assert bool(want[1]) == got[1]


def _folder_cases():
    rng = random.Random(21)
    text = b"folder parity with history across frames " * 2000
    mixed = (text[:40000] + bytes(rng.randrange(256) for _ in range(9000))
             + text[:30000])
    frames = [f[2:] for f in mszip_c.compress_frames(mixed)]
    sizes = [min(32768, len(mixed) - 32768 * i) for i in range(len(frames))]
    multi = _deflate(text[:20000], flush_every=3000)
    stored = _deflate(bytes(rng.randrange(256) for _ in range(3000)), 0)
    many = _deflate(text[:30000], flush_every=200)   # > 64 blocks
    garbage = bytes(rng.randrange(256) for _ in range(700))
    return [("history", frames, sizes), ("multi-block", [multi], [20000]),
            ("stored", [stored], [3000]), ("mixed", [multi, stored], None),
            ("too-many-blocks", [many], [30000]),
            ("wrong-size", [multi], [19999]), ("garbage", [garbage], None),
            ("empty", [], None)]


@pytest.mark.parametrize("name,frames,sizes", _folder_cases(),
                         ids=[c[0] for c in _folder_cases()])
def test_inflate_folder_equals_jax(name, frames, sizes):
    want = ij.inflate_folder(frames, sizes)
    got = ti.inflate_folder(frames, sizes, device=CPU)
    assert got == want, name
    if frames and want is None:
        with pytest.raises(ij.NeedFallback) as je:
            ij._inflate_folder(frames, sizes)
        with pytest.raises(ti.NeedFallback) as te:
            ti._inflate_folder(frames, sizes, torch.device(CPU))
        assert str(te.value) == str(je.value)
        assert te.value.reason in ti.DECLINE_REASONS


# ------------------------------------------------------------------- lzx --

def _rep_serial(src, val):
    out_s, out_v = src.copy(), val.copy()
    for i in range(1, len(src)):
        for j in range(3):
            if src[i, j] >= 0:
                out_s[i, j] = out_s[i - 1, src[i, j]]
                out_v[i, j] = out_v[i - 1, src[i, j]]
    return out_s, out_v


def test_rep_scan_equals_serial_and_associative_scan():
    import jax

    rng = np.random.RandomState(5)
    T = 777
    perm = np.asarray(tl._PERM)
    src = perm[rng.randint(0, 4, T)]
    src[rng.rand(T) < 0.05] = -1
    val = rng.randint(1, 1 << 20, (T, 3)).astype(np.int64)
    s_src, s_val = tl.rep_scan(_t(src), _t(val))
    s_src, s_val = s_src.numpy(), s_val.numpy()
    w_src, w_val = _rep_serial(src, val)
    j_src, j_val = (np.asarray(a) for a in jax.lax.associative_scan(
        lj._rep_combine, (jnp.asarray(src.astype(np.int8)),
                          jnp.asarray(val.astype(np.int32)))))
    const = s_src < 0
    assert np.array_equal(s_src, w_src) and np.array_equal(s_src, j_src)
    assert np.array_equal(s_val[const], w_val[const])
    assert np.array_equal(s_val[const], j_val[const])


def _lzx_cases():
    rng = random.Random(13)
    words = [bytes(rng.choices(b"abcdefgh the of \x00", k=rng.randint(2, 8)))
             for _ in range(60)]

    def text(n):
        return b"".join(rng.choice(words) for _ in range(n // 3))[:n]

    cases = []
    for wb in (15, 16, 17, 18, 19, 20, 21):
        d = text(20000 + 1000 * wb)
        cases.append((f"wb{wb}", jax_native.lzx_encode(d, wb, 0)[0], wb, d,
                      {}))
    d = text(50000) + bytes(rng.randrange(256) for _ in range(10000))
    cases.append(("multi-block", lzx_e.compress(d, 16, block_frames=1)[0],
                  16, d, {}))
    d = bytes(rng.randrange(256) for _ in range(40001))
    cases.append(("uncompressed", lzx_c.compress_stored(d)[0], 16, d, {}))
    ref = text(60000)
    d = ref[500:40000] + text(9000)
    st = jax_native.lzx_encode(d, 17, 0, is_delta=True, ref_data=ref)[0]
    cases.append(("delta-ref", st, 17, d,
                  {"is_delta": True, "ref_data": ref}))
    d = bytes(rng.choice(b"\xe8\x00\x01\x02abc") for _ in range(30000))
    st = lzx_e.LzxEncoder(16, intel_filesize=1 << 20).compress(d)[0]
    cases.append(("e8", st, 16, d, {}))
    g = bytes(rng.randrange(256) for _ in range(4096))
    cases.append(("garbage", g, 16, None, {}))
    cases.append(("ff", b"\xff" * 4096, 16, None, {}))
    cases.append(("window", b"\x00" * 64, 25, None, {}))
    return cases


@pytest.mark.parametrize("name,stream,wb,data,kw", _lzx_cases(),
                         ids=[c[0] for c in _lzx_cases()])
def test_lzx_stream_decode_equals_jax(name, stream, wb, data, kw):
    n = len(data) if data is not None else 8192
    want = lj.lzx_stream_decode(stream, wb, n, **kw)
    got = tl.lzx_stream_decode(stream, wb, n, device=CPU, **kw)
    assert got == want, name
    if data is not None and name != "e8":
        assert got == data, name
    if want is None and 15 <= wb <= 21:
        with pytest.raises(lj.NeedFallback) as je:
            lj._run(stream, wb, n, False, b"")
        with pytest.raises(ti.NeedFallback) as te:
            tl._run(stream, wb, n, False, b"", torch.device(CPU))
        assert str(te.value) == str(je.value)
        assert te.value.reason in tl.DECLINE_REASONS


# ----------------------------------------------------------------- entry --

def test_entry_equals_jax_entry():
    import __graft_entry__ as graft
    from libmspack_tpu_torch import entry

    jfn, jargs = graft.entry()
    fn, args = entry.entry(device=CPU)
    for a, b in zip(jargs, args):
        assert np.array_equal(np.asarray(a), b.numpy())
    for w, g in zip(jfn(*jargs), fn(*args)):
        assert np.array_equal(np.asarray(w), g.numpy())
