"""The port's device verification ops on the CPU: CRC-32 as a GF(2)
product (``ops/crc32.py``), the frame digests (``ops/digest.py``) and the
CAB block checksum (``ops/checksum.py``), plus the pointer-doubling match
resolver (``ops/match_resolve.py``).

Inputs are seeded numpy bytes of lengths 0, 1, 3, 4, 4097 and a few
larger ones. Tolerance: exact. Each op equals ``zlib.crc32`` through the
port's ``crc32_raw`` (raw register: init 0xFFFFFFFF, no final inversion),
the port's host checksum ``formats/cab.py::_checksum``, and the JAX
package's op on the same inputs.
"""
import numpy as np
import pytest
import torch

from libmspack_tpu.ops import checksum as jax_checksum
from libmspack_tpu.ops import crc32 as jax_crc32
from libmspack_tpu.ops import digest as jax_digest
from libmspack_tpu.ops import match_resolve as jax_mr

from libmspack_tpu_torch.formats.cab import _checksum
from libmspack_tpu_torch.formats.oab import crc32_raw
from libmspack_tpu_torch.ops import checksum, crc32, digest, match_resolve

LENGTHS = [0, 1, 3, 4, 4097, 12289, 70001]


def _bytes(n, seed=0):
    return np.random.RandomState(seed + n).randint(
        0, 256, n, np.uint8).tobytes()


@pytest.mark.parametrize("n", LENGTHS)
def test_crc32_device_equals_zlib_and_jax(n):
    data = _bytes(n)
    want = crc32_raw(data)
    assert crc32.crc32_device(data, device="cpu") == want
    assert jax_crc32.crc32_device(data) == want
    # any initial register, as crc32_raw chains it
    assert crc32.crc32_device(data, init=0x1234567, device="cpu") == \
        crc32_raw(data, 0x1234567)


@pytest.mark.parametrize("chunk", [64, 4096])
def test_crc32_blocks_one_product(chunk):
    blocks = [_bytes(n, 1) for n in LENGTHS]
    timings = {}
    got = crc32.crc32_blocks(blocks, "cpu", chunk_bytes=chunk,
                             timings=timings)
    assert got == [crc32_raw(b) for b in blocks]
    assert {"crc_upload_ms", "crc_product_ms", "crc_combine_ms"} <= \
        set(timings)


@pytest.mark.parametrize("width", [0, 1, 3, 4, 300, 4097])
def test_crc32_device_batch_equals_jax(width):
    rng = np.random.RandomState(2)
    rows = rng.randint(0, 256, (6, width), np.uint8)
    got = crc32.crc32_device_batch(torch.from_numpy(rows))
    assert got.dtype == torch.int64
    assert [int(v) for v in got] == [crc32_raw(r.tobytes()) for r in rows]
    assert [int(v) for v in crc32.crc32_device_batch(
        torch.from_numpy(rows), chunk_bytes=64)] == [int(v) for v in got]
    if width:
        want = np.asarray(jax_crc32.crc32_device_batch(rows))
        np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


def test_init_prefix_folds_the_register():
    for init in (0, 1, 0xFFFFFFFF, 0xDEADBEEF):
        u = crc32.init_prefix(init)
        assert len(u) == 4 and crc32_raw(u, 0) == init


def test_frame_digests_and_verify_frames_equal_jax():
    rng = np.random.RandomState(3)
    out = rng.randint(0, 256, (5, 4097), np.uint8)
    lens = [0, 1, 3, 4097, 2000]
    got = digest.frame_digests(torch.from_numpy(out), lens)
    want = np.asarray(jax_digest.frame_digests(out, lens))
    np.testing.assert_array_equal(got, want)
    expected = [out[i, :k].tobytes() for i, k in enumerate(lens)]
    assert [digest.digest_expect(e, 4097) for e in expected] == \
        [int(v) for v in got]
    assert digest.verify_frames(torch.from_numpy(out), lens, expected)
    expected[1] = b"\x00"
    assert not digest.verify_frames(torch.from_numpy(out), lens, expected)


@pytest.mark.parametrize("n", LENGTHS[:5] + [32768, 38912])
def test_cab_checksum_equals_host_and_jax(n):
    data = _bytes(n, 4)
    for init in (0, 0x9E3779B9):
        want = _checksum(data, init)
        assert checksum.cab_checksum(data, init, device="cpu") == want
        assert jax_checksum.cab_checksum(data, init) == want


def test_xor_reduce_batched():
    x = torch.from_numpy(np.random.RandomState(5).randint(
        0, 1 << 31, (3, 37)))
    want = [int(np.bitwise_xor.reduce(r)) for r in x.numpy()]
    assert checksum.xor_reduce(x).tolist() == want
    assert checksum.xor_reduce(x[:, :0]).tolist() == [0, 0, 0]


def test_match_resolve_equals_jax():
    rng = np.random.RandomState(6)
    n = 3000
    lit = rng.randint(0, 256, n).astype(np.uint8)
    # literals, overlapping copies and reads of the pre-history
    dist = rng.choice([0, 0, 1, 2, 7, 300, 2500], n)
    ptr = np.arange(n) - dist
    hist = rng.randint(0, 256, 4096).astype(np.uint8)
    for h in (None, hist):
        want = np.asarray(jax_mr.resolve(
            ptr.astype(np.int32), lit, None if h is None else h))
        got = match_resolve.resolve(
            torch.from_numpy(ptr), torch.from_numpy(lit),
            None if h is None else torch.from_numpy(h))
        np.testing.assert_array_equal(got.numpy(), want)


def test_cuda_device_raises_without_gpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="cuda"):
        crc32.crc32_device(b"abc")
    with pytest.raises(RuntimeError, match="cuda"):
        checksum.cab_checksum(b"abc")
