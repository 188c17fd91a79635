"""The port's command-line tools against the JAX package's.

``cabextract`` (``--engine cuda --device cpu``: the kernels' plain
versions; and ``--engine native``) on cabinets from the port's writer, and
on a split set made by the port's ``cabsplit`` and a two-cabinet spanning
set: its standard output and extracted files equal the JAX CLI's
(``--engine native``), apart from the ``--version`` suffix. ``cabinfo``
prints what the JAX tool prints; ``cabsplit``'s parts extract through the
port to the input files; ``wince.info`` and ``wince.rename`` equal the JAX
tool's on a port-side copy of the MSCE builder of ``tests/test_tools.py``.
"""
import io
import os
import struct

import pytest

from libmspack_tpu.cli import cabextract as jax_cabextract
from libmspack_tpu.cli import cabinfo as jax_cabinfo
from libmspack_tpu.cli import wince as jax_wince

import libmspack_tpu_torch as lt
from libmspack_tpu_torch import utils
from libmspack_tpu_torch.cli import cabextract, cabinfo, cabsplit, wince
from libmspack_tpu_torch.compress import cab_c
from libmspack_tpu_torch.system import BytesSink

from test_torch_planner import span_pair

DATA = utils.build_corpus(300000)
FILES = {"Dir\\Alpha.TXT": DATA[:50000], "Dir\\beta.bin": DATA[50000:60000],
         "gamma.c": DATA[60000:130000], "Delta.dat": DATA[130000:160000],
         "e.txt": DATA[160000:170000]}


def write(tmp_path, name, blob):
    path = os.path.join(tmp_path, name)
    with open(path, "wb") as fh:
        fh.write(blob)
    return path


def mixed_cab(tmp_path):
    f = list(FILES.items())
    return write(tmp_path, "mixed.cab", cab_c.write_cab(folders=[
        cab_c.FolderSpec(f[:2], "mszip"),
        cab_c.FolderSpec(f[2:3], "lzx", 16),
        cab_c.FolderSpec(f[3:4], "quantum", 15),
        cab_c.FolderSpec(f[4:], "none")]))


PORT = ["--engine", "cuda", "--device", "cpu"]


def run(main, argv, capsys):
    rc = main(argv)
    out = capsys.readouterr()
    return rc, out.out, out.err


def tree(root):
    got = {}
    for d, _, files in os.walk(root):
        for f in files:
            p = os.path.join(d, f)
            with open(p, "rb") as fh:
                got[os.path.relpath(p, root)] = (fh.read(),
                                                 int(os.stat(p).st_mtime))
    return got


@pytest.mark.parametrize("opts", [["-l"], ["-t"], ["-q", "-t"],
                                  ["-t", "-F", "*.txt"], ["-l", "-L"],
                                  ["-t", "-s", "-F", "gamma*"]])
@pytest.mark.parametrize("engine", [PORT, ["--engine", "native"]])
def test_cabextract_stdout_matches_jax(opts, engine, tmp_path, capsys):
    cab = mixed_cab(tmp_path)
    want = run(jax_cabextract.main, opts + ["--engine", "native", cab],
               capsys)
    assert run(cabextract.main, opts + engine + [cab], capsys) == want
    assert want[0] == 0 and want[1]


@pytest.mark.parametrize("opts", [[], ["-q"], ["-L", "-F", "dir/*"]])
def test_cabextract_files_match_jax(opts, tmp_path, capsys):
    cab = mixed_cab(tmp_path)
    a, b = os.path.join(tmp_path, "a"), os.path.join(tmp_path, "b")
    want = run(jax_cabextract.main, opts + ["-d", a, "--engine", "native",
                                            cab], capsys)
    got = run(cabextract.main, opts + PORT + ["-d", b, cab], capsys)
    assert got[0] == want[0] == 0
    assert got[1] == want[1].replace(a, b) and got[2] == want[2]
    assert tree(b) == tree(a) and tree(a)


def test_cabextract_pipe_matches_jax(tmp_path, capsysbinary):
    cab = mixed_cab(tmp_path)
    outs = []
    for main, engine in ((jax_cabextract.main, ["--engine", "native"]),
                         (cabextract.main, PORT)):
        assert main(["-p", "-q", "-F", "*a*"] + engine + [cab]) == 0
        outs.append(capsysbinary.readouterr().out)
    assert outs[0] == outs[1]
    assert outs[1] == b"".join(v for k, v in FILES.items()
                               if "a" in k.lower())


def test_cabextract_split_parts_and_spanning_set(tmp_path, capsys):
    """cabsplit's one-folder parts, and a set whose folder spans two
    cabinets (the CLI loads the next cabinet; -s does not)."""
    cab = mixed_cab(tmp_path)
    assert cabsplit.split_cabinet(cab) is None
    parts = [f"{cab}.{i:03d}" for i in range(1, 5)]
    a, b, tail = span_pair(DATA[:120000], "lzx", 16)
    span = [write(tmp_path, "a.cab", a), write(tmp_path, "b.cab", b)]
    for argv in (["-t"] + parts, ["-t"] + span, ["-t", "-s"] + span,
                 ["-l"] + span[1:]):
        want = run(jax_cabextract.main, ["--engine", "native"] + argv,
                   capsys)
        assert run(cabextract.main, PORT + argv, capsys) == want
    rc, out, _ = run(cabextract.main, PORT + ["-t"] + span[:1], capsys)
    assert rc == 0 and "extends to b.cab (disk2)" in out
    assert out.count("  OK  ") == 2   # span.bin and the set's tail.txt


def test_cabextract_version_suffix(capsys):
    with pytest.raises(SystemExit):
        cabextract.main(["--version"])
    assert capsys.readouterr().out == "cabextract 1.11 (libmspack_tpu_torch)\n"


def test_cabextract_cuda_without_gpu_is_a_usage_error(tmp_path, capsys):
    import torch
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    cab = mixed_cab(tmp_path)
    with pytest.raises(SystemExit) as e:
        cabextract.main(["-t", cab])
    assert e.value.code == 2
    assert "is_available() is False" in capsys.readouterr().err


def test_cabextract_strict_cli_stays_on_device(tmp_path, capsys,
                                               monkeypatch):
    monkeypatch.setenv("MSPACK_TPU_STRICT", "1")
    cab = mixed_cab(tmp_path)
    rc, out, err = run(cabextract.main, PORT + ["-t", cab], capsys)
    assert rc == 0 and out.count("  OK  ") == len(FILES), err


@pytest.mark.parametrize("which", ["mixed", "span"])
def test_cabinfo_matches_jax(which, tmp_path, capsys):
    if which == "mixed":
        paths = [mixed_cab(tmp_path)]
    else:
        a, b, _ = span_pair(DATA[:120000], "mszip")
        paths = [write(tmp_path, "a.cab", a), write(tmp_path, "b.cab", b)]
    want = run(jax_cabinfo.main, paths, capsys)
    assert run(cabinfo.main, paths, capsys) == want
    assert want[0] == 0 and "[folders]" in want[1]


def test_cabsplit_roundtrip_through_the_port(tmp_path, capsys):
    cab = mixed_cab(tmp_path)
    assert cabsplit.main([cab]) == 0
    d = lt.create_cab_decompressor(engine="cuda", device="cpu", strict=True)
    got = {}
    for i in range(1, 5):
        part = d.open(f"{cab}.{i:03d}")
        assert len(part.folders) == 1
        for f in part.files:
            sink = BytesSink()
            d.extract(f, sink)
            got[f.filename] = sink.getvalue()
    assert got == FILES


# ------------------------------------------------------------------ wince --

def _msce(strings, dirs, files, hives, keys, links, appname=b"TestApp",
          provider=b"TestCo"):
    """A synthetic MSCE header file (the port-side copy of
    ``tests/test_tools.py::_msce``)."""
    body = bytearray()
    off0 = 100

    def sec(entries):
        nonlocal body
        start = off0 + len(body)
        for e in entries:
            body += e
        return start

    str_entries = [struct.pack("<HH", sid, len(s) + 1) + s + b"\x00"
                   for sid, s in strings]
    dir_entries = []
    for did, ids in dirs:
        payload = struct.pack(f"<{len(ids) + 1}H", *ids, 0)
        dir_entries.append(struct.pack("<HH", did, len(payload)) + payload)
    file_entries = [struct.pack("<HHHIH", fid, did, 0, flags, len(n) + 1)
                    + n + b"\x00" for fid, did, flags, n in files]
    hive_entries = []
    for hid, root, ids in hives:
        payload = struct.pack(f"<{len(ids) + 1}H", *ids, 0)
        hive_entries.append(struct.pack("<HHHH", hid, root, 0, len(payload))
                            + payload)
    key_entries = []
    for kid, hive, flags, name, data in keys:
        payload = name + b"\x00" + data
        key_entries.append(struct.pack("<HHHIH", kid, hive, 0, flags,
                                       len(payload)) + payload)
    link_entries = []
    for lid, ldir, fid, ltype, ids in links:
        payload = struct.pack(f"<{len(ids) + 1}H", *ids, 0)
        link_entries.append(struct.pack("<HHHHHH", lid, 0, ldir, fid, ltype,
                                        len(payload)) + payload)

    offs = [sec(str_entries), sec(dir_entries), sec(file_entries),
            sec(hive_entries), sec(key_entries), sec(link_entries)]
    app_off = off0 + len(body)
    body += appname + b"\x00"
    prov_off = off0 + len(body)
    body += provider + b"\x00"

    hdr = struct.pack(
        "<12I6H6I8H",
        0x4543534D, 0, 100 + len(body), 0, 0, 0xA11,
        3, 0, 4, 20, 0, 14132,
        len(str_entries), len(dir_entries), len(file_entries),
        len(hive_entries), len(key_entries), len(link_entries),
        *offs,
        app_off, len(appname) + 1, prov_off, len(provider) + 1, 0, 0, 0, 0)
    return hdr + bytes(body)


STRINGS = [(1, b"%CE1%"), (2, b"MyApp"), (3, b"Software"), (4, b"Vendor")]
DIRS = [(1, [1, 2])]          # \Program Files\MyApp
FILES_CE = [(1, 1, 0, b"app.exe"), (2, 1, 0x80000000, b"readme.txt")]
HIVES = [(1, 3, [3, 4])]      # HKLM\Software\Vendor
KEYS = [(1, 1, 0x10001, b"Version", struct.pack("<I", 0x30004)),
        (2, 1, 0x00000, b"Name", b"My App\x00"),
        (3, 1, 0x00001, b"Blob", b"\x01\x02\xfe")]
LINKS = [(1, 2, 1, 1, [2])]   # \Windows\MyApp -> file 1


def test_wince_info_matches_jax(tmp_path):
    path = write(tmp_path, "pkg.000",
                 _msce(STRINGS, DIRS, FILES_CE, HIVES, KEYS, LINKS))
    outs = []
    for mod in (jax_wince, wince):
        out = io.StringIO()
        mod.info(path, out=out)
        outs.append(out.getvalue())
    assert outs[0] == outs[1]
    assert "f01: \\Program Files\\MyApp\\app.exe" in outs[1]
    assert "[DWORD] 00030004" in outs[1]


def test_wince_rename_matches_jax(tmp_path):
    trees = []
    for mod in (jax_wince, wince):
        d = os.path.join(tmp_path, mod.__name__)
        os.mkdir(d)
        write(d, "pkg.000", _msce(STRINGS, DIRS, FILES_CE, HIVES, KEYS,
                                  LINKS))
        write(d, "pkg.001", b"exe bytes")
        write(d, "pkg.002", b"readme bytes")
        write(d, "pkg.999", b"dll bytes")
        mod.rename(d)
        trees.append({k: v[0] for k, v in tree(d).items()})
    assert trees[0] == trees[1]
    assert trees[1][os.path.join("Program Files", "MyApp", "app.exe")] == \
        b"exe bytes"
    assert trees[1]["setup.reg"].startswith(b"REGEDIT4\r\n")
