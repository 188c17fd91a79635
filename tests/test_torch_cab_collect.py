"""The CAB driver's CFDATA collect through the native walk.

``collect_mszip_frames`` and ``collect_raw_blocks`` walk and check a folder
that lies in one cabinet in one native call (``native.cab_walk``) and read
every other folder through the block reader (``_read_block``), as before.
The collect, through the walk and through the block reader alone, is held
to the JAX package's driver on cabinets of every codec, with reserved
areas, one-block folders, a zero checksum field, a bad checksum, a
truncated image, an MSZIP block without 'CK', a block split across two
cabinets, salvage and fix-MSZIP: equal block lists and sizes (the port's
MSZIP frames without their CK), or None on both sides. ``collect_routes``
(and the planner's ``Plan.collect_routes``) counts each collected folder's
route. ``native.cab_walk`` is held to the layout of the benchmark's own
cabinet writer.
"""
import struct

import numpy as np
import pytest

import libmspack_tpu as jax_lt
import libmspack_tpu_torch as lt
from libmspack_tpu_torch import native, utils
from libmspack_tpu_torch.compress import cab_c
from libmspack_tpu_torch.formats import cab as cabmod
from libmspack_tpu_torch.formats.cab import CabDecompressor
from libmspack_tpu_torch.parallel import planner
from libmspack_tpu_torch.system import BytesSink

DATA = utils.build_corpus(300000)
CODECS = [("none", 0, 20000), ("mszip", 16, 70000), ("lzx", 21, 70000),
          ("quantum", 16, 50000)]


def encoded(codec, wb, n, at=0):
    return cab_c._encode_folder_blocks(
        cab_c.FolderSpec([("f.bin", DATA[at:at + n])], codec, wb))


def raw_cab(folders, files, flags=0, names=(), set_index=0, block_resv=0):
    """A cabinet of ``folders`` ([(comp_type, [(payload, uncomp)])]) and
    ``files`` ([(name, length, offset, folder index)]); ``block_resv`` > 0
    adds reserved areas: 3 bytes in the header, 2 a folder, ``block_resv``
    a CFDATA block (cabd.c:374-394)."""
    resv = bool(block_resv)
    if resv:
        flags |= cabmod.FLAG_RESERVE_PRESENT
    strings = b"".join(n + b"\0" for n in names)
    ext = struct.pack("<HBB", 3, 2, block_resv) + b"\xbb" * 3 if resv else b""
    cffiles = b"".join(
        struct.pack("<IIHHHH", length, off, fidx, 0x5111, 0x6000, 0x20)
        + name + b"\0" for name, length, off, fidx in files)
    fold_size = 8 + (2 if resv else 0)
    head = 0x24 + len(ext) + len(strings)
    data_start = head + fold_size * len(folders) + len(cffiles)
    cffolders, cfdata = b"", b""
    for ct, blocks in folders:
        cffolders += struct.pack("<IHH", data_start + len(cfdata),
                                 len(blocks), ct) + b"\xcc" * (fold_size - 8)
        for p, u in blocks:
            tail = struct.pack("<HH", len(p), u)
            ck = cab_c._checksum(tail, cab_c._checksum(p, 0))
            cfdata += struct.pack("<I", ck) + tail + b"\xaa" * block_resv + p
    size = data_start + len(cfdata)
    return (b"MSCF" + struct.pack("<IIIIIBBHHHHH", 0, size, 0,
                                  head + fold_size * len(folders), 0, 3, 1,
                                  len(folders), len(files), flags, 0x0622,
                                  set_index)
            + ext + strings + cffolders + cffiles + cfdata)


def four_codecs(block_resv=0, sizes=None):
    """One folder of each codec, a file each."""
    folders, files = [], []
    for i, (codec, wb, n) in enumerate(CODECS):
        n = sizes[i] if sizes else n
        folders.append(encoded(codec, wb, n, 1000 * i))
        files.append((f"{codec}.bin".encode(), n, 0, i))
    return raw_cab(folders, files, block_resv=block_resv)


def block_at(blob, fi, k, block_resv=0):
    """Offset of folder ``fi``'s CFDATA block ``k`` in ``blob``."""
    fol = lt.create_cab_decompressor(engine="scalar").open(blob).folders[fi]
    off = fol.data[0].offset
    for _ in range(k):
        off += 8 + block_resv + int.from_bytes(blob[off + 4:off + 6],
                                               "little")
    return off


def restamp(b, off):
    """Block ``off``'s checksum written anew over its bytes."""
    clen = int.from_bytes(b[off + 4:off + 6], "little")
    ck = cab_c._checksum(bytes(b[off + 4:off + 8]),
                         cab_c._checksum(bytes(b[off + 8:off + 8 + clen]), 0))
    b[off:off + 4] = ck.to_bytes(4, "little")


def split_pair(codec):
    """Two cabinets of one set holding one folder between them, its block
    1 split with an uncompressed size of 0 in the first (cabd.c:1412-1450);
    the second adds a NONE folder."""
    n = 100000
    ct, blocks = encoded(codec, 16, n)
    payload, ulen = blocks[1]
    half = len(payload) // 2
    tail = b"tail of the set " * 64
    a = raw_cab([(ct, blocks[:1] + [(payload[:half], 0)])],
                [(b"span.bin", n, 0, 0xFFFE)], 0x0002, [b"b.cab", b"disk2"])
    b = raw_cab([(ct, [(payload[half:], ulen)] + blocks[2:]),
                 (0, [(tail, len(tail))])],
                [(b"span.bin", n, 0, 0xFFFD), (b"tail.txt", len(tail), 0, 1)],
                0x0001, [b"a.cab", b"disk1"], 1)
    return [a, b]


def corrupt(how):
    """Blobs, decompressor parameters, whether to merge the two cabinets,
    and the routes the collect of every folder takes."""
    base = bytearray(four_codecs())
    mszip_k1, lzx_k1 = block_at(base, 1, 1), block_at(base, 2, 1)
    if how == "clean":
        return [bytes(base)], {}, False, {"collect_native": 5}
    if how == "block_resv":
        return [four_codecs(block_resv=5)], {}, False, {"collect_native": 5}
    if how == "one_block":
        blob = four_codecs(sizes=[900, 5000, 3000, 2000])
        assert all(f.num_blocks == 1 for f in lt.create_cab_decompressor(
            engine="scalar").open(blob).folders)
        return [blob], {}, False, {"collect_native": 5}
    if how == "zero_checksum":
        for off in (mszip_k1, lzx_k1):
            base[off:off + 4] = bytes(4)
            base[off + 20] ^= 0x5A          # unchecked, so read as it is
        return [bytes(base)], {}, False, {"collect_native": 5}
    if how in ("bad_checksum", "fix_mszip"):
        for off in (mszip_k1, lzx_k1):
            base[off + 20] ^= 0x5A
        params = {cabmod.PARAM_FIXMSZIP: 1} if how == "fix_mszip" else {}
        return [bytes(base)], params, False, \
            {"collect_native": 2, "collect_python": 3}
    if how == "truncated":
        return [bytes(base[:lzx_k1 + 100])], {}, False, \
            {"collect_native": 3, "collect_python": 2}
    if how == "no_ck":
        base[mszip_k1 + 8:mszip_k1 + 10] = b"XY"
        restamp(base, mszip_k1)
        return [bytes(base)], {}, False, \
            {"collect_native": 3, "collect_python": 2}
    if how == "salvage":
        return [bytes(base)], {cabmod.PARAM_SALVAGE: 1}, False, \
            {"collect_python": 5}
    if how == "split":
        return split_pair("lzx"), {}, False, \
            {"collect_native": 1, "collect_python": 2}
    if how == "split_merged":
        return split_pair("mszip"), {}, True, \
            {"collect_native": 1, "collect_python": 2}
    raise ValueError(how)


def collect_all(mod, blobs, params, merge):
    """Every folder's ``collect_raw_blocks`` and, of an MSZIP folder, its
    ``collect_mszip_frames`` through ``mod``'s CAB driver (the port or the
    JAX package), each as (whether MSZIP frames, result); and the
    decompressor."""
    d = mod.create_cab_decompressor(engine="scalar")
    for p, v in params.items():
        d.set_param(p, v)
    cabs = [d.open(b) for b in blobs]
    if merge:
        d.append(cabs[0], cabs[1])
    folders = list({id(f): f for c in cabs for f in c.folders}.values())
    out = []
    for fol in folders:
        out.append((False, d.collect_raw_blocks(fol)))
        if fol.comp_type & cabmod.COMPTYPE_MASK == cabmod.COMPTYPE_MSZIP:
            out.append((True, d.collect_mszip_frames(fol)))
    return out, d


@pytest.mark.parametrize("walk", [True, False])
@pytest.mark.parametrize("how", [
    "clean", "block_resv", "one_block", "zero_checksum", "bad_checksum",
    "truncated", "no_ck", "split", "split_merged", "salvage", "fix_mszip"])
def test_collect_matches_jax_driver(how, walk, monkeypatch):
    """The port's collect, through the native walk and with the walk off
    (the block reader alone), against the JAX package's: the same blocks
    and sizes, or None on both sides; the port's MSZIP frames are the JAX
    package's without their CK."""
    blobs, params, merge, routes = corrupt(how)
    if not walk:
        monkeypatch.setattr(CabDecompressor, "_collect_native",
                            lambda *args: None)
        routes = {"collect_python": sum(routes.values())}
    got, d = collect_all(lt, blobs, params, merge)
    assert d.collect_routes == routes
    want, _ = collect_all(jax_lt, blobs, params, merge)
    assert [m for m, _ in got] == [m for m, _ in want]
    want = [None if r is None else
            ([bytes(f[2:]) for f in r[0]] if m else
             [bytes(b) for b in r[0]], r[1]) for m, r in want]
    got = [r for _, r in got]
    assert got == want
    for r in got:
        if r is not None:
            blocks, sizes = r
            assert all(type(b) is bytes for b in blocks)
            assert all(type(s) is int for s in sizes)
    if how in ("bad_checksum", "truncated", "no_ck", "split"):
        assert None in got
    if how == "fix_mszip":
        # the block reader serves the bad MSZIP frames; the LZX folder,
        # whose checksum fix-MSZIP does not waive, stays refused
        assert got[1] is not None and got[3] is None


# ------------------------------------------------------------- counters --

def portbench_cabs(n_cabs=4):
    """Cabinets as the benchmark's ``cab_corpus`` writes them, cut small:
    MSZIP and LZX:21 in turn, one folder of four files."""
    from portbench.gen import archives
    cabs = []
    for i in range(n_cabs):
        codec, wb = (("mszip", 15), ("lzx", 21))[i % 2]
        plain = DATA[i * 1000:i * 1000 + 160000]
        cabs.append(archives.write_cab([archives.Folder(codec, wb, [
            (f"f{j}", plain[j * 40000:(j + 1) * 40000]) for j in range(4)])])
            [0])
    return cabs


def test_planner_counts_each_folder_route():
    cabs = portbench_cabs()
    plan = planner.plan_archives(cabs)
    assert plan.collect_routes == {"collect_native": len(cabs)}
    got = planner.archive_files(plan, planner.execute(plan, engine="cuda",
                                                      device="cpu",
                                                      strict=True))
    assert got[1]["f2"] == DATA[1000 + 80000:1000 + 120000]
    assert plan.collect_routes == {"collect_native": 4}
    assert plan.calls == {"mszip": 1, "lzx": 1}
    # both parts of a split folder take the block reader (the first, which
    # ends in the split block, is refused), the second cabinet's NONE
    # folder the walk
    plan = planner.plan_archives(split_pair("lzx"))
    assert plan.collect_routes == {"collect_native": 1, "collect_python": 2}
    assert plan.fallback == [(0, 0)]


def test_cab_driver_counts_each_folder_route():
    blob = four_codecs()
    d = lt.create_cab_decompressor(engine="cuda", device="cpu")
    cab = d.open(blob)
    for f in cab.files:
        sink = BytesSink()
        d.extract(f, sink)
        assert sink.getvalue() == DATA[1000 * cab.files.index(f):][:f.length]
    # MSZIP, LZX and Quantum collected for the engines; NONE never is
    assert d.collect_routes == {"collect_native": 3}
    d = lt.create_cab_decompressor(engine="cuda", device="cpu")
    d.set_param(cabmod.PARAM_SALVAGE, 1)
    d.collect_raw_blocks(d.open(blob).folders[2])
    assert d.collect_routes == {"collect_python": 1}


def test_bad_checksum_still_declines_under_strict():
    blob, _, _, _ = corrupt("bad_checksum")
    blob = blob[0]
    with pytest.raises(lt.FallbackError,
                       match="CFDATA blocks could not be collected"):
        planner.extract_corpus([blob], engine="cuda", device="cpu",
                               strict=True)
    d = lt.create_cab_decompressor(engine="cuda", device="cpu", strict=True)
    cab = d.open(blob)
    with pytest.raises(lt.FallbackError,
                       match="CFDATA blocks could not be collected"):
        d.extract(cab.files[1], BytesSink())
    assert d.collect_routes == {"collect_python": 1}
    d = lt.create_cab_decompressor(engine="scalar")
    cab = d.open(blob)
    with pytest.raises(lt.ChecksumError):
        d.extract(cab.files[1], BytesSink())


# --------------------------------------------------------- native entry --

@pytest.mark.parametrize("codec,wb", [("none", 0), ("mszip", 15),
                                      ("lzx", 21), ("quantum", 16)])
def test_cab_walk_matches_writer_layout(codec, wb):
    from portbench.gen import archives
    folder = archives.Folder(codec, wb, [("a", DATA[:50000]),
                                         ("b", DATA[60000:130000])])
    enc = archives.encode_folder(folder)
    blob, _ = archives.write_cab([folder], [enc])
    ct, blocks = enc
    start = int.from_bytes(blob[0x24:0x28], "little")
    want_offs = np.cumsum([0] + [8 + len(p) for p, _ in blocks])[:-1] \
        + start + 8
    for img in (blob, np.frombuffer(blob, np.uint8)):
        offs, lens, sizes = native.cab_walk(img, start, len(blocks),
                                            ct & 0xF, 0)
        assert offs.tolist() == want_offs.tolist()
        assert lens.tolist() == [len(p) for p, _ in blocks]
        assert sizes.tolist() == [s for _, s in blocks]
        assert [blob[o:o + n] for o, n in zip(offs, lens)] == \
            [p for p, _ in blocks]
    bad = bytearray(blob)
    bad[want_offs[-1] + 2] ^= 1          # past an MSZIP block's CK
    assert native.cab_walk(bytes(bad), start, len(blocks), ct & 0xF,
                           0) is None
    assert native.cab_walk(bytes(bad), start, len(blocks), ct & 0xF, 0,
                           verify=False)[0].tolist() == want_offs.tolist()
    assert native.cab_walk(blob[:-1], start, len(blocks), ct & 0xF,
                           0) is None
