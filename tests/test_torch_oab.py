"""OAB through the port's driver: ``create_oab_decompressor(engine="cuda")``
on ``device="cpu"`` (K3's plain version and the CRC op's torch version),
``"native"`` and ``"scalar"``, held to the JAX package's ``OabDecompressor``.

Files come from the port's copy of ``oab_c`` (checked equal to the JAX
writer's bytes). Tolerance: exact. Full downloads and incremental patches
at window 2^17 and at 2^19 (above the JAX ``tpu`` engine's 2^18 limit)
equal the JAX ``scalar`` bytes, with the LZX blocks of a file reaching
``CudaLzxEngine.decode_streams`` once per window; one small file equals
the JAX ``tpu`` engine (one interpreted Pallas call). On a bad signature,
a bad block header, a truncated block and a CRC mismatch the port gives
the JAX ``scalar`` path's error class and partial output; a stored block
among LZX blocks is copied; an E8 header in one DELTA block makes its lane
decline, that block alone takes the scalar path, and strict mode raises
there instead.
"""
import os
import subprocess
import sys

import numpy as np
import pytest

from libmspack_tpu.compress import lzx_e as jax_lzx_e
from libmspack_tpu.compress import oab_c as jax_oab_c
from libmspack_tpu.formats.oab import OabDecompressor as JaxOab
from libmspack_tpu.system import BytesSink as JaxBytesSink

import chip_smoke
import libmspack_tpu_torch as lt
from libmspack_tpu_torch import lzx_edge_cases as le
from libmspack_tpu_torch.compress import oab_c
from libmspack_tpu_torch.formats.oab import crc32_raw
from libmspack_tpu_torch.system import BytesSink

E8_DECLINE = "intel E8 in chunked or DELTA streams"
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _data(n, seed):
    """The bench corpus with seeded noise spliced in."""
    rng = np.random.RandomState(seed)
    out = bytearray(chip_smoke.build_corpus(n))
    for p in rng.randint(0, max(1, n - 64), n // 2000):
        out[p:p + 16] = rng.randint(0, 256, 16, np.uint8).tobytes()
    return bytes(out)


def _engines():
    return [("cuda", lt.create_oab_decompressor(engine="cuda",
                                                device="cpu")),
            ("native", lt.create_oab_decompressor(engine="native")),
            ("scalar", lt.create_oab_decompressor(engine="scalar"))]


def _run(d, fn, *args):
    """(bytes in the sink, error class name or None) of one call; each
    driver writes to its own package's sink."""
    sink = JaxBytesSink() if isinstance(d, JaxOab) else BytesSink()
    try:
        getattr(d, fn)(*args, sink)
    except Exception as e:   # noqa: BLE001 - the class name is compared
        return sink.getvalue(), type(e).__name__
    return sink.getvalue(), None


def _blocks(oab, head):
    """The block records (16-byte header + payload) of an OAB file: a full
    download (``head`` 16, csize second) or a patch (0x1C, csize first)."""
    at = 4 if head == 16 else 0
    out, p = [], head
    while p < len(oab):
        csize = int.from_bytes(oab[p + at:p + at + 4], "little")
        out.append(oab[p:p + 16 + csize])
        p += 16 + csize
    return out


def _windows(blocks, patch):
    wins = set()
    for b in blocks:
        f = [int.from_bytes(b[i:i + 4], "little") for i in (0, 4, 8)]
        size = ((f[2] + 32767) & ~32767) + f[1] if patch else f[2]
        if patch or f[0]:
            wb = 17
            while wb < 25 and (1 << wb) < size:
                wb += 1
            wins.add(wb)
    return wins


@pytest.mark.parametrize("block_size", [65536, 300000])
def test_full_download_equals_jax(block_size):
    data = _data(330000, 1)
    oab = oab_c.write_oab(data, block_size=block_size)
    assert oab == jax_oab_c.write_oab(data, block_size=block_size)
    want = _run(JaxOab(engine="scalar"), "decompress", oab)
    assert want == (data, None)
    blocks = _blocks(oab, 16)
    for name, d in _engines():
        assert _run(d, "decompress", oab) == want, name
    d = _engines()[0][1]
    d.decompress_bytes(oab)
    # one engine call per window, every LZX block a lane
    wins = _windows(blocks, False)
    assert max(wins) == (17 if block_size == 65536 else 19)
    assert d.stats["engine calls"] == len(wins)
    assert d.cuda_engine.lanes == len(blocks) == d.stats["device blocks"]
    assert not d.cuda_engine.declines and not d.fallback_reasons


@pytest.mark.parametrize("block_size", [65536, 200000])
def test_incremental_patch_equals_jax(block_size):
    base = _data(260000, 2)
    target = bytearray(base[:250000])
    rng = np.random.RandomState(3)
    for p in rng.randint(0, len(target) - 8, 40):
        target[p:p + 8] = rng.randint(0, 256, 8, np.uint8).tobytes()
    target = bytes(target)
    patch = oab_c.write_oab_patch(target, base, block_size=block_size)
    assert patch == jax_oab_c.write_oab_patch(target, base,
                                              block_size=block_size)
    want = _run(JaxOab(engine="scalar"), "decompress_incremental", patch,
                base)
    assert want == (target, None)
    for name, d in _engines():
        assert _run(d, "decompress_incremental", patch, base) == want, name
    d = _engines()[0][1]
    d.decompress_incremental_bytes(patch, base)
    wins = _windows(_blocks(patch, 0x1C), True)
    assert max(wins) == (17 if block_size == 65536 else 19)
    assert d.stats["engine calls"] == len(wins)
    assert not d.cuda_engine.declines


def test_small_file_equals_jax_tpu_engine():
    data = _data(6000, 4)
    oab = oab_c.write_oab(data)
    assert JaxOab(engine="tpu").decompress_bytes(oab) == data
    d = lt.create_oab_decompressor(engine="cuda", device="cpu")
    assert d.decompress_bytes(oab) == data
    assert d.stats["device blocks"] == 1


def _three_blocks():
    data = _data(150000, 5)
    return data, oab_c.write_oab(data, block_size=65536)


def _error_cases():
    data, oab = _three_blocks()
    recs = _blocks(oab, 16)
    b = bytearray(oab)
    b[0:4] = (4).to_bytes(4, "little")
    yield "bad_signature", bytes(b)
    at = 16 + len(recs[0]) + len(recs[1])
    b = bytearray(oab)
    b[at:at + 4] = (2).to_bytes(4, "little")          # flags 2
    yield "bad_block_header", bytes(b)
    yield "truncated_block", oab[:at + 16 + len(recs[2]) // 2]
    b = bytearray(oab)
    at = 16 + len(recs[0]) + 12                        # block 1's CRC
    b[at] ^= 0xFF
    yield "crc_mismatch", bytes(b)


@pytest.mark.parametrize("case", [c for c, _ in _error_cases()])
def test_errors_follow_jax_scalar(case):
    oab = dict(_error_cases())[case]
    want = _run(JaxOab(engine="scalar"), "decompress", oab)
    assert want[1] is not None
    for name, d in _engines():
        if name == "native":
            # the JAX native path checks a block's CRC before writing it
            assert _run(d, "decompress", oab) == \
                _run(JaxOab(engine="native"), "decompress", oab), name
        else:
            assert _run(d, "decompress", oab) == want, name
    if case == "crc_mismatch":
        # the cuda engine, as the scalar path, wrote block 1's bytes: K3's,
        # with no decode on the host and nothing noted as a fallback
        d = _engines()[0][1]
        got = _run(d, "decompress", oab)[0]
        assert len(got) == 2 * 65536
        assert d.stats["device blocks"] == 1 and not d.stats["scalar blocks"]
        assert not d.fallback_reasons


def test_stored_block_among_lzx_blocks():
    data, oab = _three_blocks()
    stored = oab_c.write_oab(data, block_size=65536, compress=False)
    lzx, raw = _blocks(oab, 16), _blocks(stored, 16)
    mixed = oab[:16] + lzx[0] + raw[1] + lzx[2]
    want = _run(JaxOab(engine="scalar"), "decompress", mixed)
    assert want == (data, None)
    d = lt.create_oab_decompressor(engine="cuda", device="cpu")
    assert _run(d, "decompress", mixed) == want
    assert d.stats["stored blocks"] == 1 and d.stats["device blocks"] == 2
    assert d.stats["engine calls"] == 1


def _e8_file():
    """Three 64 KiB blocks at window 2^17; the middle one written with an
    intel E8 header over data with 0xE8 bytes (the encoder does not
    transform them, so the block decodes to what the reference codec's E8
    untransform makes of them). Returns (the decoded bytes, the file)."""
    data = bytearray(_data(3 * 65536, 6))
    for p in range(65536 + 10, 2 * 65536 - 10, 211):
        data[p] = 0xE8
    data = bytes(data)
    oab = oab_c.write_oab(data, block_size=65536)
    recs = _blocks(oab, 16)
    chunk = data[65536:2 * 65536]
    stream = jax_lzx_e.LzxEncoder(17, is_delta=True,
                                  intel_filesize=2_000_000).compress(chunk)[0]
    out = le.scalar_decode(stream, len(chunk), 17, delta=True)
    assert out is not None and out != chunk     # E8 did translate
    rec = ((1).to_bytes(4, "little") + len(stream).to_bytes(4, "little")
           + len(chunk).to_bytes(4, "little")
           + crc32_raw(out).to_bytes(4, "little") + stream)
    return (data[:65536] + out + data[2 * 65536:],
            oab[:16] + recs[0] + rec + recs[2])


def test_declined_batch_served_block_by_block():
    data, oab = _e8_file()
    assert JaxOab(engine="scalar").decompress_bytes(oab) == data
    d = lt.create_oab_decompressor(engine="cuda", device="cpu")
    assert d.decompress_bytes(oab) == data
    # one engine call for the three blocks: only the E8 block's lane
    # declines, and only that block takes the scalar path
    assert d.cuda_engine.declines == {E8_DECLINE: 1}
    assert d.stats["engine calls"] == 1 and d.cuda_engine.lanes == 3
    assert d.stats["device blocks"] == 2 and d.stats["scalar blocks"] == 1
    assert "oab_lzx_cuda" in d.fallback_reasons


@pytest.mark.parametrize("how", ["keyword", "environment"])
def test_strict_raises_on_the_declined_block(how, monkeypatch):
    data, oab = _e8_file()
    if how == "environment":
        monkeypatch.setenv("MSPACK_TPU_STRICT", "1")
        d = lt.create_oab_decompressor(engine="cuda", device="cpu")
    else:
        d = lt.create_oab_decompressor(engine="cuda", device="cpu",
                                       strict=True)
    sink = BytesSink()
    with pytest.raises(lt.FallbackError, match="declined") as info:
        d.decompress(oab, sink)
    assert info.value.path == "oab_lzx_cuda"
    assert E8_DECLINE in info.value.reason
    # the block before it is in the sink, as the scalar path leaves it
    assert sink.getvalue() == data[:65536]


def test_smoke_builders_equal_oab_c():
    """chip_smoke.py's threaded builders write oab_c's bytes."""
    base = _data(140000, 7)
    target = base[:70000] + b"changed" + base[70007:130000]
    assert chip_smoke.build_oab(base, 65536) == \
        oab_c.write_oab(base, block_size=65536)
    assert chip_smoke.build_oab(base, 100000) == \
        oab_c.write_oab(base, block_size=100000)
    patch = chip_smoke.build_oab_patch(target, base)
    assert patch == oab_c.write_oab_patch(target, base)
    lanes = chip_smoke.oab_lanes(patch, target, base)
    assert [len(v) for v in lanes.values()] == [2]
    assert b"".join(c.raw for c in lanes[17]) == target


def test_native_engine_builds_once_from_threads(tmp_path):
    """The smoke run's encoder threads may be the first to load the native
    engine: in a fresh process with an empty build directory, eight threads
    at once get one library, built once, with its return types set."""
    code = (
        "import concurrent.futures as cf, ctypes, os\n"
        "from libmspack_tpu_torch import kernels\n"
        f"kernels.BUILD_DIR = {str(tmp_path)!r}\n"
        "from libmspack_tpu_torch import native\n"
        "with cf.ThreadPoolExecutor(8) as ex:\n"
        "    libs = list(ex.map(lambda _: native.lib(), range(8)))\n"
        "assert all(x is libs[0] for x in libs)\n"
        "assert libs[0].msp_lzx_encode.restype is ctypes.c_int64\n"
        "print(' '.join(os.listdir(kernels.BUILD_DIR)))\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       env=dict(os.environ, PYTHONPATH=ROOT),
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    built = r.stdout.split()
    assert len(built) == 1 and built[0].endswith(".so")


def test_entry_point_defaults():
    d = lt.create_oab_decompressor(device="cpu")
    assert d.engine == "cuda" and not d.strict
    assert lt.create_oab_decompressor(engine="auto").engine == "native"
    with pytest.raises(lt.ArgsError, match="the port calls it"):
        lt.create_oab_decompressor(engine="tpu")
