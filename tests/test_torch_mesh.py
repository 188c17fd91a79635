"""The port's mesh (``parallel/mesh.py``) over gloo on the CPU.

Each group is a set of spawned processes (``multihost.spawn``, a join
timeout on every one): the ranks call the mesh functions collectively and
each returns the whole result. ``decode_frames_sharded`` (the tensor ops of
``ops/inflate.py``) is held to the JAX package's on its 8-device virtual
CPU mesh (``tests/conftest.py``); the ring, the LZX lanes (one launch and
segmented) and the Quantum lanes, which run K1, K3 and K4's plain versions
here, are held to the bytes the scalar codecs decode; ``dryrun_multichip``
decodes the JAX package's three dry-run cases over 8 ranks;
``decode_cab_multihost`` scatters a 4-codec cabinet over 2 ranks; and the
shadow check (``ops/shadow.py``) that holds each of the dry runs' kernel
launches on a card to the plain version measures differences as the
phases of ``chip_smoke.py`` do. Tolerance: exact bytes.
"""
import random

import pytest
import torch

from libmspack_tpu import native as jax_native
from libmspack_tpu.compress import mszip_c
from libmspack_tpu.parallel import mesh as jax_mesh
from libmspack_tpu_torch import entry
from libmspack_tpu_torch.ops import cuda_lzx, shadow
from libmspack_tpu_torch.parallel import multihost

TIMEOUT_S = 300


def _words(rng, alphabet, n):
    words = [bytes(rng.choices(alphabet, k=rng.randint(3, 9)))
             for _ in range(40)]
    return b"".join(rng.choice(words) for _ in range(n // 4))[:n]


def _mszip(data):
    frames = [f[2:] for f in mszip_c.compress_frames(data)]
    return frames, [min(32768, len(data) - 32768 * i)
                    for i in range(len(frames))]


@pytest.fixture(scope="module")
def inputs():
    rng = random.Random(23)
    sharded = (b"sharded decode test " * 300
               + bytes(rng.randrange(256) for _ in range(200))) * 30
    ring = (b"ppermute ring handoff " * 250
            + bytes(rng.randrange(256) for _ in range(300))) * 24
    lzx = [_words(rng, b"lzx lanes on K3 ", 9000 + 4000 * k)
           for k in range(11)]
    big = _words(rng, b"segmented through the state ", 150000)
    qtm = [_words(rng, b"quantum adaptive model ", 2200) for _ in range(4)]
    return {"sharded": sharded, "ring": ring, "lzx": lzx, "big": big,
            "qtm": qtm}


@pytest.fixture(scope="module")
def eight(inputs):
    """One 8-rank group running every mesh function on the inputs."""
    lzx = [jax_native.lzx_encode(d, 16, 0)[0] for d in inputs["lzx"]]
    big = jax_native.lzx_encode(inputs["big"], 16, 0)[0]
    qtm = [b"".join(p + b"\xff" for p in jax_native.qtm_encode(d, 15))
           for d in inputs["qtm"]]
    calls = [
        ("decode_frames_sharded", _mszip(inputs["sharded"])),
        ("decode_frames_ring", _mszip(inputs["ring"])),
        ("decode_lzx_streams_sharded",
         (lzx, [len(d) for d in inputs["lzx"]], 16)),
        ("decode_lzx_streams_sharded", ([big], [len(inputs["big"])], 16)),
        ("decode_qtm_streams_sharded",
         (qtm, [len(d) for d in inputs["qtm"]], 15)),
        ("decode_qtm_streams_sharded", ([qtm[0]], [5000], 15)),
        ("decode_frames_ring", ([b"\x07\xff" + b"\x00" * 40], [100])),
    ]
    ranks = multihost.spawn(multihost.mesh_calls, 8, "gloo", "cpu",
                            args=(calls,), timeout_s=TIMEOUT_S)
    for r in ranks[1:]:
        assert r == ranks[0]    # every rank returns the whole result
    return ranks[0]


def test_decode_frames_sharded_8_equals_jax(inputs, eight):
    frames, sizes = _mszip(inputs["sharded"])
    want = jax_mesh.decode_frames_sharded(jax_mesh.default_mesh(), frames,
                                          sizes)
    assert eight[0] == (want, {}) and want == inputs["sharded"]


def test_decode_frames_sharded_2_equals_jax():
    data = b"two device mesh " * 5000
    frames, _ = _mszip(data)
    want = jax_mesh.decode_frames_sharded(jax_mesh.default_mesh(2), frames)
    ranks = multihost.spawn(
        multihost.mesh_calls, 2, "gloo", "cpu",
        args=([("decode_frames_sharded", (frames,))],), timeout_s=TIMEOUT_S)
    assert [r[0][0] for r in ranks] == [want, want] and want == data


def test_decode_frames_ring(inputs, eight):
    assert eight[1] == (inputs["ring"], {})
    out, declines = eight[6]
    assert out is None and declines == {"kernel error / invalid chain": 1}


def test_decode_lzx_streams_sharded(inputs, eight):
    assert eight[2] == (inputs["lzx"], {})          # 11 streams, 2 a rank
    assert eight[3] == ([inputs["big"]], {})        # 150 KB in segments


def test_decode_qtm_streams_sharded(inputs, eight):
    assert eight[4] == (inputs["qtm"], {})
    # the CPU mesh keeps the JAX module's interpreter budget
    assert eight[5] == (None, {"interpret-mode budget": 1})


def test_dryrun_multichip_8():
    s = entry.dryrun_multichip(8, device="cpu", timeout_s=TIMEOUT_S)
    assert set(s["cases"]) == {"cab", "lzx_big", "chm"}
    assert s["launches"]["cuda_inflate"]["plain"] > 0
    assert s["launches"]["cuda_lzx"]["plain"] > 0
    # on the CPU the Quantum folder takes the native engine (counted)
    assert s["declines"] == {"interpret-mode budget": 8,
                             "Quantum folders on the native engine": 8}


@pytest.mark.parametrize("engine", ["cuda", "torch"])
def test_decode_cab_multihost_2(engine):
    s = entry.multihost_dryrun(2, device="cpu", engine=engine,
                               timeout_s=TIMEOUT_S)
    plain = {k: v["plain"] for k, v in s["launches"].items()}
    # engine="cuda" runs K1, K3 and K4's plain versions here; "torch" the
    # tensor ops and, for Quantum, the scalar codec
    assert all(plain.values()) if engine == "cuda" else \
        not any(plain.values())
    assert s["max_abs_err"] == {}     # shadow checks run on a card only


def test_shadow_difference():
    """``shadow.difference`` reads counts, state records and the tokens
    below the plain count; ``shadow.inputs`` copies only inside a block."""
    data = (b"shadow check of a stream kernel " * 300)[:8000]
    s, lens = cuda_lzx.pack_streams([jax_native.lzx_encode(data, 16, 0)[0]])
    out_lens = torch.tensor([len(data)], dtype=torch.int32)
    hists = torch.zeros(1, dtype=torch.int32)
    assert shadow.inputs(s) is None
    with shadow.active() as errs:
        host = shadow.inputs(s, lens, out_lens, hists, None)
        assert host[4] is None and torch.equal(host[0], s)
        assert host[0].data_ptr() != s.data_ptr()
    assert errs == {} and shadow.inputs(s) is None

    def run():
        return cuda_lzx.lzx_phase_a_plain(s, lens, out_lens, hists, 16,
                                          tcap=len(data))

    want, got = run(), run()
    assert shadow.difference(got, want) == 0
    n = int(want[2][2, 0])
    got[0][0, n:] = 12345               # past the count: undefined
    assert shadow.difference(got, want) == 0
    got[1][0, n - 1] += 7               # a live literal word
    assert shadow.difference(got, want) == 7
    got = run()
    got[2][1, 0] += 3                   # a count
    assert shadow.difference(got, want) == 3
    assert shadow.difference(got, want, rows=1) == 0
    got = run()
    got[3][0, 5] ^= 0x40                # a state record byte
    assert shadow.difference(got, want) == 0x40
