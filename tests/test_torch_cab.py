"""The slice: CAB MSZIP extraction through the port's driver and engine,
and the port's independence from the JAX package.

Cabinets come from the JAX package's own writer. The port's
``engine="cuda"`` runs here with ``device="cpu"``, i.e. on the kernels'
plain versions, and is held to ``libmspack_tpu``'s ``engine="tpu"`` (the
Pallas kernels in interpret mode) and ``engine="scalar"``: equal bytes,
and an error class of the same name on a corrupt frame (the port has its
own copies of the error classes). The port's own writers give the bench's
cabinets byte for byte, and a subprocess drives every port path (CAB, CHM,
OAB, SZDD, KWAJ and the device ops) without importing jax, the JAX
package or bench.py. Strict mode: an MSZIP folder with a partial
mid-folder frame (under device phase B) and a Quantum folder whose
window-wrap flush the reference codec refuses decline; each is served
without strict mode and raises ``FallbackError`` under ``strict=True`` and
under ``MSPACK_TPU_STRICT=1``.
"""
import os
import struct
import subprocess
import sys
import zlib

import numpy as np
import pytest
import torch

import bench
from libmspack_tpu.compress import cab_c, mszip_c
from libmspack_tpu.errors import MSPackError as JaxMSPackError
from libmspack_tpu.formats.cab import CabDecompressor as JaxCabDecompressor
from libmspack_tpu.system import BytesSink as JaxBytesSink

import chip_smoke
import libmspack_tpu_torch as lt
from libmspack_tpu_torch.ops import cuda_inflate as ci
from libmspack_tpu_torch.parallel.cuda_pipeline import CudaMszipEngine
from libmspack_tpu_torch.system import BytesSink

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# the cabinet of test_parallel.py::test_tpu_engine_cab_extract_matches_scalar
# (one folder, two frames) plus a single-frame folder
FILES = [("a.txt", b"the quick brown fox jumps " * 700),
         ("b.txt", bytes(range(256)) * 130)]
SINGLE = [("c.txt", b"a second folder of one frame " * 30)]


def two_folder_cab():
    return cab_c.write_cab(folders=[cab_c.FolderSpec(FILES, "mszip"),
                                    cab_c.FolderSpec(SINGLE, "mszip")])


def extract_all(d, blob):
    """Every file's bytes, each driver writing to its own package's
    sinks."""
    jax = isinstance(d, JaxCabDecompressor)
    cab = d.open(blob)
    got = {}
    for f in cab.files:
        sink = JaxBytesSink() if jax else BytesSink()
        d.extract(f, sink)
        got[f.filename] = sink.getvalue()
    return got


def corrupt_first_frame(blob):
    """The cabinet with its first CFDATA block's deflate data made
    invalid (block type 3) and its checksum cleared, so that the block
    reads fine and phase A flags the frame."""
    cab = JaxCabDecompressor(engine="scalar").open(blob)
    off = cab.folders[0].data[0].offset
    resv = cab.block_resv
    b = bytearray(blob)
    b[off:off + 4] = b"\0\0\0\0"
    payload = off + 8 + resv
    assert b[payload:payload + 2] == b"CK"
    b[payload + 2] = 0x07
    return bytes(b)


def test_cuda_engine_matches_tpu_and_scalar_engines():
    blob = two_folder_cab()
    want = dict(FILES + SINGLE)
    assert extract_all(JaxCabDecompressor(engine="tpu"), blob) == want
    assert extract_all(JaxCabDecompressor(engine="scalar"), blob) == want
    before = ci.LAUNCHES["plain"]
    d = lt.create_cab_decompressor(engine="cuda", device="cpu")
    assert extract_all(d, blob) == want
    assert ci.LAUNCHES["plain"] > before
    assert not d.cuda_engine.declines


@pytest.mark.parametrize("phase_b", ["host", "device"])
def test_engine_folders_in_one_call(phase_b):
    datas = [b"engine folder one " * 4000, bytes(range(256)) * 300,
             b"tiny"]
    folders = []
    for data in datas:
        frames = [f[2:] for f in mszip_c.compress_frames(data)]
        sizes = [min(32768, len(data) - i * 32768)
                 for i in range(len(frames))]
        folders.append((frames, sizes))
    eng = CudaMszipEngine(device="cpu", phase_b=phase_b)
    assert eng.decode_folders(folders) == datas
    assert not eng.declines
    assert {"upload_ms", "k1_ms", "total_ms"} <= set(eng.timings)


def test_device_phase_b_declines_partial_mid_frame():
    # a folder whose first frame is short: the host resolver chains it
    # right; the device rule declines it, counted
    raw0, raw1 = b"short first frame " * 10, b"second frame, " * 50
    co0 = zlib.compressobj(9, zlib.DEFLATED, -15)
    co1 = zlib.compressobj(9, zlib.DEFLATED, -15, 9,
                           zlib.Z_DEFAULT_STRATEGY, raw0)
    frames = [co0.compress(raw0) + co0.flush(),
              co1.compress(raw1) + co1.flush()]
    eng = CudaMszipEngine(device="cpu", phase_b="device")
    outs = eng.decode_folders([(frames, [len(raw0), len(raw1)])])
    assert outs == [raw0 + raw1]
    assert dict(eng.declines) == {"partial mid-folder frame": 1}


def test_corrupt_frame_takes_counted_native_redecode():
    blob = corrupt_first_frame(cab_c.write_cab(
        files=[("x.txt", b"corrupt frame test " * 60)], compression="mszip"))
    errors = []
    for d in (JaxCabDecompressor(engine="tpu"),
              lt.create_cab_decompressor(engine="cuda", device="cpu")):
        with pytest.raises((JaxMSPackError, lt.MSPackError)) as info:
            extract_all(d, blob)
        errors.append(type(info.value))
    # the port has its own copies of the error classes: same names
    assert issubclass(errors[0], JaxMSPackError)
    assert issubclass(errors[1], lt.MSPackError)
    assert errors[0].__name__ == errors[1].__name__
    assert d.cuda_engine.declines["flagged lane"] == 1


@pytest.mark.parametrize("compression", ["mszip", "lzx", "quantum"])
def test_file_past_decoded_folder_gets_scalar_error(compression):
    """A file whose offset + length passes the num_blocks * 32768 test but
    ends past the bytes the folder decodes to: every engine serves the
    first file and raises the scalar codec's error class for the second."""
    rng = np.random.RandomState(3)
    first = rng.randint(0, 8, 30000).astype(np.uint8).tobytes()
    second = rng.randint(0, 8, 10000).astype(np.uint8).tobytes()
    blob = bytearray(cab_c.write_cab(
        files=[("a.bin", first), ("b.bin", second)], compression=compression))
    # the second CFFILE's length: stretched to end at 60000 (two blocks
    # allow 65536)
    at = 0x24 + 8 + 16 + len("a.bin") + 1
    assert struct.unpack_from("<I", blob, at)[0] == len(second)
    struct.pack_into("<I", blob, at, 60000 - len(first))
    blob = bytes(blob)
    errors = {}
    for engine, kw in (("scalar", {}), ("native", {}),
                       ("cuda", {"device": "cpu"})):
        d = lt.create_cab_decompressor(engine=engine, **kw)
        a, b = d.open(blob).files
        sink = BytesSink()
        d.extract(a, sink)
        assert sink.getvalue() == first, engine
        with pytest.raises(lt.MSPackError) as info:
            d.extract(b, BytesSink())
        errors[engine] = type(info.value)
    assert errors["native"] is errors["scalar"]
    assert errors["cuda"] is errors["scalar"]


def _partial_mid_frame_cab(monkeypatch):
    """One MSZIP folder of two CFDATA blocks whose first decodes to fewer
    than 32768 bytes (the second's matches reach into it): the host
    resolver chains it, device phase B's rule declines it."""
    from libmspack_tpu_torch.compress import cab_c as port_cab_c

    raw0, raw1 = b"short first frame " * 10, b"second frame, " * 50
    co0 = zlib.compressobj(9, zlib.DEFLATED, -15)
    co1 = zlib.compressobj(9, zlib.DEFLATED, -15, 9,
                           zlib.Z_DEFAULT_STRATEGY, raw0)
    blocks = [(b"CK" + co0.compress(raw0) + co0.flush(), len(raw0)),
              (b"CK" + co1.compress(raw1) + co1.flush(), len(raw1))]
    with monkeypatch.context() as m:
        m.setattr(port_cab_c, "_encode_folder_blocks",
                  lambda spec: (1, blocks))
        blob = port_cab_c.write_cab(files=[("p.txt", raw0 + raw1)])
    return blob, {"p.txt": raw0 + raw1}


def _wrap_flush_cab():
    from libmspack_tpu_torch import qtm_edge_cases as qe
    from libmspack_tpu_torch.compress import cab_c as port_cab_c

    files, wb = qe.wrap_flush_files()
    blob = port_cab_c.write_cab(folders=[port_cab_c.FolderSpec(
        files, "quantum", wb)])
    return blob, lt.create_cab_decompressor(engine="scalar")


def _outcomes(d, blob):
    """{file name: bytes or error class name}."""
    out = {}
    for f in d.open(blob).files:
        sink = BytesSink()
        try:
            d.extract(f, sink)
            out[f.filename] = sink.getvalue()
        except lt.MSPackError as e:
            out[f.filename] = type(e).__name__
    return out


@pytest.mark.parametrize("how", ["off", "keyword", "environment"])
@pytest.mark.parametrize("case", ["mszip_partial_mid_frame",
                                  "quantum_wrap_flush"])
def test_strict_mode_raises_on_a_decline(case, how, monkeypatch):
    """Without strict mode a declining folder is served (the scalar path's
    bytes or errors) and its reason noted; with ``strict=True`` or
    ``MSPACK_TPU_STRICT=1`` the first extract raises ``FallbackError``
    naming the path and the decline."""
    if case == "mszip_partial_mid_frame":
        blob, want = _partial_mid_frame_cab(monkeypatch)
        path, reason = "mszip_cuda", "partial mid-folder frame"
    else:
        blob, scalar = _wrap_flush_cab()
        want = _outcomes(scalar, blob)
        path, reason = "qtm_cuda", "window-wrap flush across a file edge"
    if how == "environment":
        monkeypatch.setenv("MSPACK_TPU_STRICT", "1")
    d = lt.create_cab_decompressor(engine="cuda", device="cpu",
                                   strict=True if how == "keyword" else None)
    if case == "mszip_partial_mid_frame":
        # the decline is device phase B's (K2) rule
        d.cuda_engine = CudaMszipEngine("cpu", phase_b="device")
    if how == "off":
        assert _outcomes(d, blob) == want
        assert reason in d.fallback_reasons[path]
        return
    f = d.open(blob).files[0]
    with pytest.raises(lt.FallbackError) as info:
        d.extract(f, BytesSink())
    assert info.value.path == path and reason in info.value.reason
    assert isinstance(info.value, lt.DecrunchError)


def test_none_folder_takes_scalar_path():
    files = [("n.txt", b"stored as is " * 100)]
    blob = cab_c.write_cab(files=files, compression="none")
    d = lt.create_cab_decompressor(engine="cuda", device="cpu")
    assert extract_all(d, blob) == dict(files)
    assert d.cuda_engine is None


def test_cuda_device_raises_without_gpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="cuda"):
        lt.create_cab_decompressor(engine="cuda")
    with pytest.raises(RuntimeError, match="cuda"):
        CudaMszipEngine()


def test_entry_points_default_to_the_card():
    for create in (lt.create_cab_decompressor, lt.create_chm_decompressor,
                   lt.create_oab_decompressor, lt.create_szdd_decompressor):
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError, match="cuda"):
                create()
        d = create(device="cpu")
        assert d.engine == "cuda" and d.device == torch.device("cpu")
        assert create(engine="auto").engine == "native"
        assert create(engine="scalar").device is None
        for engine in ("jax", "tpu"):
            with pytest.raises(lt.ArgsError, match="the port calls it"):
                create(engine=engine)


@pytest.mark.parametrize("compression", ["mszip", "lzx", "quantum"])
def test_port_builds_the_bench_cabinets(compression):
    corpus = bench.build_corpus(1 << 20)
    assert chip_smoke.build_corpus(1 << 20) == corpus
    assert chip_smoke.build_cab(corpus, compression) == \
        bench.build_cab(corpus, compression)


def test_port_imports_no_jax():
    """Every port path, its inputs made by the port's own writers, the
    probe tools, the corpus planner with its routing and calibration, the
    CLI tools and the fuzz runner, in a process that must end with neither
    jax, nor bench, nor any module of the JAX package or of tools/
    loaded."""
    code = (
        "import sys\n"
        "import chip_smoke\n"
        "import libmspack_tpu_torch as lt\n"
        "from libmspack_tpu_torch.parallel import cuda_pipeline\n"
        "from libmspack_tpu_torch import edge_cases, kernels\n"
        "from libmspack_tpu_torch import lzx_edge_cases, qtm_edge_cases\n"
        "from libmspack_tpu_torch.compress import cab_c, chm_c\n"
        "from libmspack_tpu_torch.system import BytesSink\n"
        "from libmspack_tpu_torch.tools import (micro_copy, micro_gather,\n"
        "    micro_gather2, micro_skel, micro_vec, mosaic_probe, sass,\n"
        "    timing)\n"
        "x, aux = mosaic_probe.inputs()\n"
        "for name in mosaic_probe.PROBES:\n"
        "    mosaic_probe.probe(name, x, aux.get(name), device='cpu')\n"
        "micro_vec.search('vec', device='cpu', shape=(1, 8), steps=2)\n"
        "data = b'no jax here ' * 5000\n"
        "def one(d, blob):\n"
        "    s = BytesSink()\n"
        "    d.extract(d.open(blob).files[0], s)\n"
        "    return s.getvalue()\n"
        "d = lt.create_cab_decompressor(engine='cuda', device='cpu')\n"
        "n = lt.create_cab_decompressor(engine='native')\n"
        "for comp in ('mszip', 'lzx', 'quantum'):\n"
        "    blob = cab_c.write_cab(files=[('j.txt', data)], "
        "compression=comp)\n"
        "    assert one(d, blob) == data, comp\n"
        "    assert one(n, blob) == data, comp\n"
        "assert d.cuda_lzx_engine.n_decoded == 1\n"
        "assert d.cuda_qtm_engine.n_decoded == 1\n"
        "eng = cuda_pipeline.CudaMszipEngine('cpu', phase_b='device')\n"
        "blob = cab_c.write_cab(files=[('j.txt', data)], "
        "compression='mszip')\n"
        "folder = d.collect_mszip_frames(d.open(blob).folders[0])\n"
        "assert eng.decode_folders([folder]) == [data]\n"
        "chm = chm_c.write_chm([('/h.html', data)])\n"
        "c = lt.create_chm_decompressor(engine='cuda', device='cpu')\n"
        "assert one(c, chm) == data and c.cuda_engine.n_decoded == 1\n"
        "assert one(lt.create_chm_decompressor(engine='native'), chm)"
        " == data\n"
        "from libmspack_tpu_torch.compress import lzss_c, oab_c\n"
        "from libmspack_tpu_torch.ops import checksum, crc32, digest\n"
        "oab = oab_c.write_oab(data)\n"
        "o = lt.create_oab_decompressor(engine='cuda', device='cpu')\n"
        "assert o.decompress_bytes(oab) == data\n"
        "assert o.stats['device blocks'] == 1\n"
        "patch = oab_c.write_oab_patch(data[::-1], data)\n"
        "assert o.decompress_incremental_bytes(patch, data) == data[::-1]\n"
        "assert lt.create_oab_decompressor(engine='native')"
        ".decompress_bytes(oab) == data\n"
        "szdd = lzss_c.szdd_compress(data[:3000])\n"
        "for e, kw in (('cuda', {'device': 'cpu'}), ('native', {})):\n"
        "    s = lt.create_szdd_decompressor(engine=e, **kw)\n"
        "    assert s.decompress_bytes(szdd) == data[:3000]\n"
        "kwaj = lzss_c.kwaj_compress(data[:3000], method=4, "
        "filename='k.txt')\n"
        "assert lt.create_kwaj_decompressor().decompress_bytes(kwaj)"
        " == data[:3000]\n"
        "assert checksum.cab_checksum(data, device='cpu') >= 0\n"
        "assert digest.verify_frames(__import__('torch').zeros((1, 8), "
        "dtype=__import__('torch').uint8), [0], [b''])\n"
        "import os, tempfile\n"
        "from libmspack_tpu_torch import utils\n"
        "from libmspack_tpu_torch.parallel import planner\n"
        "from libmspack_tpu_torch.cli import cabextract, cabinfo, cabsplit\n"
        "from libmspack_tpu_torch.cli import wince\n"
        "from libmspack_tpu_torch.tools import calibrate_engines, fuzz_mass\n"
        "mix = cab_c.write_cab(folders=[cab_c.FolderSpec([('m', data)]),\n"
        "    cab_c.FolderSpec([('l', data)], 'lzx', 21),\n"
        "    cab_c.FolderSpec([('q', data)], 'quantum')])\n"
        "for e in ('cuda', 'native', 'auto'):\n"
        "    got = planner.extract_corpus([mix], engine=e, device='cpu',\n"
        "                                 strict=True)\n"
        "    assert got == [dict.fromkeys('mlq', data)], e\n"
        "assert utils.choose_engine(1, 'lzx') in ('native', 'scalar')\n"
        "cal = calibrate_engines.calibrate(sizes_mb=(1 / 16,), reps=1)\n"
        "assert set(cal['cuda_crossover_bytes']) == set(utils.CODECS)\n"
        "import contextlib, io\n"
        "with tempfile.TemporaryDirectory() as td, \\\n"
        "        contextlib.redirect_stdout(io.StringIO()):\n"
        "    path = os.path.join(td, 'mix.cab')\n"
        "    open(path, 'wb').write(mix)\n"
        "    assert cabextract.main(['-q', '-d', td, '--device', 'cpu',\n"
        "                            path]) == 0\n"
        "    assert open(os.path.join(td, 'l'), 'rb').read() == data\n"
        "    assert cabinfo.main([path]) == 0\n"
        "    assert cabsplit.split_cabinet(path) is None\n"
        "arcs = fuzz_mass.build_archives()\n"
        "r = fuzz_mass.sweep('cab', arcs['cab'], 2, 0, device='cpu')\n"
        "assert not (r['fails'] or r['mismatches']), r\n"
        "t = lt.create_cab_decompressor(engine='torch', device='cpu')\n"
        "for comp in ('mszip', 'lzx'):\n"
        "    blob = cab_c.write_cab(files=[('j.txt', data)], "
        "compression=comp)\n"
        "    assert one(t, blob) == data, comp\n"
        "assert not t.torch_declines\n"
        "c = lt.create_chm_decompressor(engine='torch', device='cpu')\n"
        "assert one(c, chm) == data and not c.torch_declines\n"
        "o = lt.create_oab_decompressor(engine='torch', device='cpu')\n"
        "assert o.decompress_bytes(oab) == data\n"
        "assert o.stats['device blocks'] == 1\n"
        "from libmspack_tpu_torch import entry\n"
        "fn, args = entry.entry(device='cpu')\n"
        "lens, end = fn(*args)\n"
        "assert lens.tolist() == [16384] * 4, lens\n"
        "with contextlib.redirect_stdout(io.StringIO()):\n"
        "    s = entry.dryrun_multichip(1, backend='gloo', device='cpu')\n"
        "assert s['launches']['cuda_lzx']['plain'] > 0, s\n"
        "from libmspack_tpu_torch import bench as port_bench\n"
        "from libmspack_tpu_torch.tools import (bench_kernels, cut_bisect,\n"
        "    devtime, inflate_bench, mesh_scaling, scaling_model)\n"
        "from libmspack_tpu_torch.ops import cuda_inflate\n"
        "e = cuda_inflate.bench_entry(4, 4, device='cpu')\n"
        "assert e['sampled_bit_exact'] and e['errors'] == 0, e\n"
        "bad = [m for m in sys.modules if m in ('jax', 'bench', 'devtime')\n"
        "       or m.split('.')[0] in ('libmspack_tpu', 'tools')]\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "ok"
