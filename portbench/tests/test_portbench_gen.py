"""The generator and the frozen writers: seeded, and decodable by the
program's native engine to the generator's plaintext."""
import json
import os

import pytest

from portbench.gen import archives, data, encoders

CELLS = ["cab_corpus.batch64", "oab_full.blocks64k",
         "cab_corpus.per_archive", "cab_corpus.large_folders"]


def _pool(root, workload, seed):
    import importlib
    with open(os.path.join(root, "BENCHMARK.json")) as fh:
        bench = json.load(fh)
    cell = next(w for w in bench["workloads"] if w["name"] == workload)
    conf = next(c for c in bench["configs"] if c["name"] == cell["config"])
    with open(os.path.join(root, conf["file"])) as fh:
        config = json.load(fh)
    with open(os.path.join(root, "portbench", "traffic",
                           f"{cell['traffic']}.json")) as fh:
        traffic = json.load(fh)
    fmt = importlib.import_module(f"portbench.formats.{config['format']}")
    return fmt.build(config, traffic, seed, 2)


def test_same_seed_same_archives_other_seed_other(tiny_root):
    a = _pool(tiny_root, "cab_corpus.batch64", 2**31 + 5)
    b = _pool(tiny_root, "cab_corpus.batch64", 2**31 + 5)
    c = _pool(tiny_root, "cab_corpus.batch64", 2**31 + 6)
    assert [i.inputs for i in a] == [i.inputs for i in b]
    assert [i.expected for i in a] == [i.expected for i in b]
    assert all(x != y for x, y in zip(a[0].inputs, c[0].inputs))


def test_segment_shapes_do_not_depend_on_the_seed():
    mix = {"text": 0.4, "records": 0.4, "noise": 0.1, "random": 0.1}
    a = data.file_bytes(1, (1, 2, 3), 1 << 18, mix, (4096, 65536),
                        data.Vocabulary(1))
    b = data.file_bytes(2, (1, 2, 3), 1 << 18, mix, (4096, 65536),
                        data.Vocabulary(2))
    assert len(a) == len(b) == 1 << 18 and a != b
    # the same kinds in the same amounts: the incompressible share agrees
    import zlib
    ra, rb = len(zlib.compress(a)) / len(a), len(zlib.compress(b)) / len(b)
    assert abs(ra - rb) < 0.02


@pytest.mark.parametrize("workload", CELLS)
def test_archives_decode_natively_to_the_plaintext(tiny_root, workload):
    import libmspack_tpu_torch as port
    from libmspack_tpu_torch.system import BytesSink

    pool = _pool(tiny_root, workload, 77)
    for item in pool:
        for archive, want in zip(item.inputs, item.expected):
            if workload.startswith("oab"):
                d = port.create_oab_decompressor(engine="native",
                                                 device="cpu")
                assert d.decompress_bytes(archive) == want["oab"]
                continue
            d = port.create_cab_decompressor(engine="native", device="cpu")
            cab = d.open(archive)
            got = {}
            for f in cab.files:
                sink = BytesSink()
                d.extract(f, sink)
                got[f.filename] = sink.getvalue()
            assert got == want


@pytest.mark.parametrize("codec,window_bits", [
    ("none", 0), ("mszip", 15), ("lzx", 21), ("quantum", 16)])
def test_every_codec_of_the_writer_decodes_natively(codec, window_bits):
    """Each codec the frozen writer offers (no cell packs Quantum or
    stored folders yet; a later configuration can, as data alone)."""
    import libmspack_tpu_torch as port
    from libmspack_tpu_torch.system import BytesSink

    mix = {"text": 0.4, "records": 0.4, "noise": 0.1, "random": 0.1}
    blob = data.file_bytes(5, (7, 1), 3 * 32768 + 123, mix, (4096, 65536),
                           data.Vocabulary(5))
    files = [("a", blob[:50000]), ("b", blob[50000:])]
    cab, counts = archives.write_cab([archives.Folder(codec, window_bits,
                                                      files)])
    assert counts[codec][1] == len(blob)
    d = port.create_cab_decompressor(engine="native", device="cpu")
    got = {}
    for f in d.open(cab).files:
        sink = BytesSink()
        d.extract(f, sink)
        got[f.filename] = sink.getvalue()
    assert got == dict(files)


def test_kernel_byte_counts_come_from_the_archive():
    files = [("a", b"x" * 40000), ("b", bytes(range(256)) * 100)]
    cab, counts = archives.write_cab([archives.Folder("mszip", 15, files)])
    frames = encoders.deflate_frames(b"".join(d for _, d in files))
    assert counts == {"mszip": [sum(map(len, frames)), 40000 + 25600]}
    assert len(cab) > counts["mszip"][0]


def test_cab_checksum_of_a_short_tail():
    assert archives.cab_checksum(b"\x01\x02\x03") == 0x010203
    assert archives.cab_checksum(b"\x01\x00\x00\x00\x05") == 0x1 ^ 0x5


def test_lzx_frames_stay_within_the_cab_block_limit():
    """Incompressible bytes after 31 frames of text code past CAB's block
    limit under the text's trees; the writer then gives each frame its
    own block, and the cabinet still decodes."""
    import numpy as np

    import libmspack_tpu_torch as port
    from libmspack_tpu_torch.system import BytesSink

    text = data.file_bytes(1, (9,), 31 * 32768, {"text": 1}, (4096, 65536),
                           data.Vocabulary(1))
    blob = text + np.random.default_rng(1).bytes(32768)
    stream, offs = encoders.lzx_encode(blob, 21)
    ends = offs[1:] + [len(stream)]
    assert max(b - a for a, b in zip(offs, ends)) > archives.INPUTMAX
    folder = archives.Folder("lzx", 21, [("f", blob)])
    ct, blocks = archives.encode_folder(folder)
    assert max(len(p) for p, _ in blocks) <= archives.INPUTMAX
    cab, _ = archives.write_cab([folder], [(ct, blocks)])
    d = port.create_cab_decompressor(engine="native", device="cpu")
    sink = BytesSink()
    d.extract(d.open(cab).files[0], sink)
    assert sink.getvalue() == blob
