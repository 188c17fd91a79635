"""OAB v3.2 incremental patches through the port's driver, built by the
benchmark's own writer (``portbench/formats/oab_patch.py``): a 1 MiB base
in 64 KiB blocks and its target, 16 bytes changed at a seeded offset in
every 4 KiB, each patch block taking the base block at its offset as
reference data.

``create_oab_decompressor(engine="cuda")`` on ``device="cpu"`` (K3's
plain version) and ``engine="scalar"`` deliver the target exactly; the
driver counts the reference bytes its one base read a batch gave the
blocks (``base_bytes``), and the engine the same bytes and lanes as served
on its path (``ref_bytes``, ``ref_lanes``). A base cut short at block k
leaves blocks 0..k-1 in the sink and the JAX ``scalar`` path's error
class. Blocks whose reference data is shorter or longer than their output,
or absent, decode to their target too, one ``decode_streams`` call a
window.
"""
import pytest

from libmspack_tpu.formats.oab import OabDecompressor as JaxOab
from libmspack_tpu.system import BytesSink as JaxBytesSink

import libmspack_tpu_torch as lt
from libmspack_tpu_torch.formats.oab import PATCHBLK_SIZEOF, PATCHHEAD_SIZEOF
from libmspack_tpu_torch.system import BytesSink, MemSource
from portbench.formats import oab_patch
from portbench.gen import data

SEED = 4294967311
BLOCK = 65536
MIX = {"text": 0.45, "records": 0.50, "random": 0.05}


def _bytes(stream, n):
    return data.file_bytes(SEED, stream, n, MIX, (4096, 65536),
                           data.Vocabulary(SEED))


def _daily(size=1 << 20):
    """(base, target, patch) as the cell builds them, at ``size``."""
    config = {"target_bytes": size, "block_max": BLOCK,
              "assumed": {"mix": MIX, "segment_bytes": [4096, 65536],
                          "edit_every": 4096, "edit_bytes": 16}}
    item = oab_patch.build(config, {"pool_items": 1}, SEED, 2)[0]
    return item.bases[0], item.expected[0]["oab"], item.inputs[0]


def _run(d, *args):
    """(bytes in the sink, error class name or None) of one
    ``decompress_incremental``; each driver writes to its own package's
    sink."""
    sink = JaxBytesSink() if isinstance(d, JaxOab) else BytesSink()
    try:
        d.decompress_incremental(*args, sink)
    except Exception as e:   # noqa: BLE001 - the class name is compared
        return sink.getvalue(), type(e).__name__
    return sink.getvalue(), None


def _header_at(patch, k):
    """Where block k's header starts in a patch."""
    at = PATCHHEAD_SIZEOF
    for _ in range(k):
        at += PATCHBLK_SIZEOF + int.from_bytes(patch[at:at + 4], "little")
    return at


def _cuda():
    return lt.create_oab_decompressor(engine="cuda", device="cpu",
                                      strict=True)


@pytest.mark.parametrize("engine", ["cuda", "scalar"])
def test_daily_patch_gives_the_target(engine):
    base, target, patch = _daily()
    assert base != target and len(base) == len(target) == 1 << 20
    d = _cuda() if engine == "cuda" else \
        lt.create_oab_decompressor(engine="scalar")
    assert _run(d, patch, base) == (target, None)
    if engine == "cuda":
        assert d.stats["device blocks"] == 16 and d.stats["engine calls"] == 1
        assert not d.fallback_reasons


def test_reference_bytes_are_counted_by_driver_and_engine():
    base, target, patch = _daily()
    d = _cuda()
    assert _run(d, patch, base) == (target, None)
    assert d.timings["base_bytes"] == len(base)     # the summed ssize
    assert d.timings["base_ms"] > 0
    eng = d.cuda_engine
    assert not eng.declines
    assert eng.timings["ref_bytes"] == len(base)
    assert eng.timings["ref_lanes"] == 16


def _cut_cases():
    # block 0's reference data short; block 5's half there; the base
    # ending right where block 9's reference data would start
    return [("block0", 100), ("inside_block5", 5 * BLOCK + 30000),
            ("at_block9", 9 * BLOCK)]


@pytest.mark.parametrize("case, cut", _cut_cases())
def test_short_base_follows_jax_scalar(case, cut):
    base, target, patch = _daily()
    short = base[:cut]
    want = _run(JaxOab(engine="scalar"), patch, short)
    k = cut // BLOCK
    assert want == (target[:k * BLOCK], "ReadError")
    d = _cuda()
    assert _run(d, patch, short) == want
    assert _run(lt.create_oab_decompressor(engine="scalar"), patch,
                short) == want
    assert d.timings.get("base_bytes", 0) == k * BLOCK
    assert d.stats["device blocks"] == k and not d.stats["scalar blocks"]
    # the read-ahead leaves the patch at block k's header and the base at
    # its reference data, where the reference loop reads them
    src, basesrc = MemSource(patch), MemSource(short)
    src.seek(PATCHHEAD_SIZEOF)
    blocks, stopped = _cuda()._read_ahead(src, basesrc, BLOCK, len(target))
    assert stopped and len(blocks) == k
    assert src.tell() == _header_at(patch, k)
    assert basesrc.tell() == k * BLOCK


def test_blocks_of_other_reference_sizes_give_the_target():
    """ssize < dsize, ssize 0, ssize > dsize (the last, short block), and
    at ``block_max`` 2^17 one block at window 2^18 beside others at 2^17:
    two windows, two engine calls."""
    block_max = 2 * BLOCK
    # (dsize, ssize) of each block
    shape = [(BLOCK, 40000), (BLOCK, 0), (BLOCK, BLOCK),
             (BLOCK, 2 * BLOCK), (20000, BLOCK)]
    base = _bytes((9, 0), sum(s for _, s in shape))
    rng = data.rng_for(SEED, 9, 1)
    blocks, chunks, at = [], [], 0
    for j, (dsize, ssize) in enumerate(shape):
        ref = base[at:at + ssize]
        at += ssize
        own = ref[:dsize] + _bytes((9, 2, j), max(0, dsize - len(ref)))
        chunk = oab_patch.edited(own, rng, 4096, 16)
        chunks.append(chunk)
        blocks.append(oab_patch.patch_block(chunk, ref))
    target = b"".join(chunks)
    patch = oab_patch.write_patch(blocks, block_max, base, target)
    assert {oab_patch.window_bits(s, n) for n, s in shape} == {17, 18}
    assert _run(JaxOab(engine="scalar"), patch, base) == (target, None)
    assert _run(lt.create_oab_decompressor(engine="scalar"), patch,
                base) == (target, None)
    d = _cuda()
    assert _run(d, patch, base) == (target, None)
    assert d.stats["engine calls"] == 2
    assert d.stats["device blocks"] == len(shape)
    assert d.timings["base_bytes"] == len(base)
    assert d.cuda_engine.timings["ref_bytes"] == len(base)
    assert d.cuda_engine.timings["ref_lanes"] == len(shape) - 1
