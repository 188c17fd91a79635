"""Benchmark: CAB decompression through the port; the port of ``bench.py``.

    python -m libmspack_tpu_torch.bench [--require-cuda]

Rows, at ``bench.py``'s sizes, every one checked bit-exact; each run
writes its files to a fresh temporary directory, gone when the run ends
or raises. ``bench.py`` put it in ``/dev/shm``; the port keeps to the
process's temporary directory (``TMPDIR``), as all its code writes
nothing outside its checkout and that directory:

* ``mszip_decompress`` / ``lzx_decompress`` / ``qtm_decompress``: the
  bench cabinets (96 MiB MSZIP, 96 MiB LZX, 24 MiB Quantum; ``build_cab``)
  through the port's native engine (``native.cab_pipeline``: CFDATA walk,
  checksums and decode in one call, folders across the host's threads).
  Baseline: the reference C library, one thread, extracting the same
  cabinet (``native/reference.py``) where its sources are there; else
  ``vs_baseline`` is null and ``baseline`` says why.
* ``mszip_decompress_cuda``: the MSZIP cabinet's frames, collected by
  ``CabDecompressor(engine="cuda", strict=True)``, through
  ``CudaMszipEngine.decode_folders`` (K1 and host phase B), then the same
  file writes; a folder the engine declines fails the row.
* ``k1_inflate``, ``k3_lzx``, ``k4_qtm``: the kernels' bench entries at
  their default shapes (``ops/cuda_*.py: bench_entry``). Baseline: the
  reference's one-thread rate on the cabinet of the same codec, measured
  in this run, where the reference is there; else the port's native
  decoder on one thread on the same streams, timed here. ``baseline``
  says which.
* ``mesh_1dev``: ``decode_frames_ring`` on 8 frames and
  ``decode_lzx_streams_sharded`` on 4 streams at window 2^16, in a group
  of one rank on NCCL (``multihost.spawn``), every K1 and K3 launch held
  to its plain version (``ops/shadow.py``).

The device rows need a card: without one each is ``{"value": null,
"reason": "no CUDA device"}``, and ``--require-cuda`` makes that an
error. A device row that fails raises. ``--mb mszip=N,lzx=N,quantum=N``
and ``--reps N`` exist to run the bench small (the tests do). Prints ONE
JSON line, ``bench.py``'s shape: ``{"metric": "mszip_decompress",
"value": <GB/s>, "unit": "GB/s", "vs_baseline": ..., "extra": {...}}``,
with the card's name and power limit in ``extra["device"]``. Cabinets
and encoded streams are cached in ``.bench_cache/`` under names of their
own (``torch_*``).
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np
import torch

CORPUS_MB = {"mszip": 96, "lzx": 96, "quantum": 24}
FOLDER_MB = {"mszip": 24, "lzx": 24, "quantum": 6}
ROWS = {"mszip": "mszip_decompress", "lzx": "lzx_decompress",
        "quantum": "qtm_decompress"}
REPS = {"reference": 3, "native": 5, "cuda": 2}
CACHE_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), ".bench_cache")
NO_CUDA = "no CUDA device"


def build_corpus(total_bytes: int) -> bytes:
    """``bench.py:40-50``, the same bytes (``utils.build_corpus``)."""
    from .utils import build_corpus as corpus
    return corpus(total_bytes)


def build_cab(corpus: bytes, compression: str) -> bytes:
    """``bench.py:53-60`` with the port's cabinet writer, the same bytes."""
    from .compress import cab_c
    folders = []
    fsz = FOLDER_MB[compression] << 20
    for i in range(0, len(corpus), fsz):
        folders.append(cab_c.FolderSpec(
            [(f"f{i}.bin", corpus[i:i + fsz])], compression))
    return cab_c.write_cab(folders=folders)


def cached_cab(comp: str, mb: int):
    """``(corpus, cabinet)`` of ``mb`` MiB, the cabinet read from
    ``CACHE_DIR`` when it was built before (``bench.py:287-297``)."""
    corpus = build_corpus(mb << 20)
    path = os.path.join(CACHE_DIR,
                        f"torch_{comp}_{mb}_f{FOLDER_MB[comp]}.cab")
    if os.path.exists(path):
        with open(path, "rb") as fh:
            return corpus, fh.read()
    cab = build_cab(corpus, comp)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "wb") as fh:
        fh.write(cab)
    os.replace(tmp, path)
    return corpus, cab


def _best(run, reps):
    """Best seconds of ``reps`` calls of ``run(outdir)``, each in a fresh
    temporary directory that is gone when it returns or raises."""
    best = float("inf")
    for _ in range(reps):
        with tempfile.TemporaryDirectory() as d:
            t0 = time.perf_counter()
            run(d)
            best = min(best, time.perf_counter() - t0)
    return best


def _write_files(outdir, cab, arena, folder_offs):
    """One file per member, written from the decoded folder bytes
    (``bench.py:70-80``)."""
    for f in cab.files:
        fi = next(i for i, fol in enumerate(cab.folders) if fol is f.folder)
        lo = folder_offs[fi] + f.offset
        with open(os.path.join(outdir, f.filename.replace("/", "_")),
                  "wb") as fh:
            fh.write(memoryview(arena)[lo:lo + f.length])


def bench_reference(cab_path: str, reps: int):
    """Best seconds of the reference extracting the cabinet, or None."""
    from .native import reference
    if reference.missing():
        return None

    def run(outdir):
        err = reference.cab_extract_all(cab_path, outdir)
        if err:
            raise RuntimeError(f"reference failed: {err}")

    return _best(run, reps)


def bench_native(cab_path: str, corpus: bytes, reps: int) -> float:
    """Best seconds of the port's native engine on the cabinet, files
    written; the bytes must equal the corpus (``bench.py:83-130``)."""
    from . import native
    from .formats.cab import (BLOCKMAX, COMPTYPE_MASK, INPUTMAX,
                              CabDecompressor)

    scratch, stage_scratch = native.Scratch(), native.Scratch()
    result = {}

    def run(outdir):
        cab = CabDecompressor(engine="native").open(cab_path)
        img = np.memmap(cab_path, dtype=np.uint8, mode="r")
        nblocks = sum(f.num_blocks for f in cab.folders)
        out = scratch.get(nblocks * BLOCKMAX)
        stage = None
        if any((f.comp_type & COMPTYPE_MASK) in (2, 3) for f in cab.folders):
            stage = stage_scratch.get(nblocks * (INPUTMAX + 1))
        offs = native.cab_pipeline(
            img, [fol.data[0].offset for fol in cab.folders],
            [fol.num_blocks for fol in cab.folders],
            [fol.comp_type for fol in cab.folders], cab.block_resv, out,
            stage)
        if offs is None:
            raise RuntimeError("the native pipeline declined the bench "
                               "cabinet")
        result["total"], result["arena"] = offs[-1], out
        _write_files(outdir, cab, out, offs)

    _best(run, 1)   # warm-up: page faults, the engine's build
    if bytes(result["arena"][:result["total"]]) != corpus:
        raise AssertionError("native: bytes differ from the corpus")
    best = _best(run, reps)
    if bytes(result["arena"][:result["total"]]) != corpus:
        raise AssertionError("native: bytes differ from the corpus")
    return best


def bench_cuda(cab_path: str, corpus: bytes, dev, reps: int) -> float:
    """Best seconds of the MSZIP cabinet through ``CudaMszipEngine``,
    files written (``bench.py:133-173``); raises where the engine declines
    a folder or the bytes differ."""
    from .formats.cab import CabDecompressor
    from .parallel.cuda_pipeline import CudaMszipEngine

    eng = CudaMszipEngine(device=dev)
    result = {}

    def run(outdir):
        d = CabDecompressor(engine="cuda", device=dev, strict=True)
        cab = d.open(cab_path)
        folders = []
        for fol in cab.folders:
            folders.append(d.collect_mszip_frames(fol))
        outs = eng.decode_folders(folders)
        if outs is None or eng.redecoded or eng.declines:
            raise RuntimeError(f"CudaMszipEngine declined: redecoded "
                               f"{eng.redecoded}, {dict(eng.declines)}")
        offs = np.concatenate([[0], np.cumsum([len(b) for b in outs])])
        result["blob"] = b"".join(outs)
        _write_files(outdir, cab, result["blob"], offs)

    _best(run, 1)   # warm-up: the kernels' build
    if result["blob"] != corpus:
        raise AssertionError("cuda: bytes differ from the corpus")
    best = _best(run, reps)
    if result["blob"] != corpus:
        raise AssertionError("cuda: bytes differ from the corpus")
    return best


# -- kernel rows -------------------------------------------------------------

def native_baseline(codec: str, shape: dict) -> float:
    """MB/s of the port's native decoder on one thread on the streams of
    a kernel entry at ``shape`` (its keyword arguments), checked against
    their bytes."""
    from . import native
    from .ops import cuda_inflate as ci
    from .ops import cuda_lzx as cl
    from .ops import cuda_qtm as cq

    if codec == "mszip":
        # the frames have no history: one call decodes them as one folder
        frames, raws = ci.bench_inputs(**shape)
        t0 = time.perf_counter()
        out = native.mszip_folder(frames, [len(r) for r in raws], 1)
        outs = [out[i:i + len(r)] for i, r in zip(
            np.cumsum([0] + [len(r) for r in raws]), raws)]
    elif codec == "lzx":
        raws, streams = cl.bench_inputs(**shape, cache_dir=CACHE_DIR)
        wb = shape.get("window_bits", 16)
        t0 = time.perf_counter()
        outs = [native.lzx_decode(s, wb, 0, len(r))
                for s, r in zip(streams, raws)]
    else:
        raws, streams = cq.bench_inputs(**shape, cache_dir=CACHE_DIR)
        wb = shape.get("window_bits", 15)
        t0 = time.perf_counter()
        outs = [native.qtm_decode(s, wb, len(r))
                for s, r in zip(streams, raws)]
    dt = time.perf_counter() - t0
    if outs != raws:
        raise AssertionError(f"native {codec} baseline: bytes differ")
    return sum(len(r) for r in raws) / dt / 1e6


KERNEL_ROWS = (("k1_inflate", "cuda_inflate", "mszip"),
               ("k3_lzx", "cuda_lzx", "lzx"), ("k4_qtm", "cuda_qtm",
                                               "quantum"))


def kernel_rows(extra: dict, dev, ref_mb_s: dict, shapes=None):
    """The ``k1_inflate``, ``k3_lzx`` and ``k4_qtm`` rows
    (``bench.py:176-218``) into ``extra``; returns the entries.
    ``shapes``: ``{module: bench_entry keyword arguments}``, each entry's
    defaults where absent."""
    import importlib

    entries = []
    for name, mod, codec in KERNEL_ROWS:
        m = importlib.import_module(f"libmspack_tpu_torch.ops.{mod}")
        shape = (shapes or {}).get(mod, {})
        kw = {} if mod == "cuda_inflate" else {"cache_dir": CACHE_DIR}
        e = m.bench_entry(device=dev, **shape, **kw)
        entries.append(e)
        if ref_mb_s.get(codec):
            base = ref_mb_s[codec]
            how = (f"reference C library, one thread, on the {codec} bench "
                   "cabinet in this run")
        else:
            base = native_baseline(codec, shape)
            how = ("the port's native decoder, one thread, on the same "
                   "streams in this run (no reference)")
        extra[name] = {
            "value": e["mb_per_s"], "unit": "MB/s",
            "bit_exact": bool(e["sampled_bit_exact"] and e["errors"] == 0
                              and e["out_ok"] == e["lanes"]
                              and e["plain_max_abs_err"] == 0),
            "vs_baseline": e["mb_per_s"] / base,
            "baseline": {"mb_per_s": base, "what": how}}
        print(f"# kernel {name}: {e['mb_per_s']:.1f} MB/s device-resident, "
              f"errors={e['errors']}, bit_exact={e['sampled_bit_exact']}; "
              f"baseline {base:.1f} MB/s ({how})", file=sys.stderr)
    return entries


# -- the mesh at one rank ----------------------------------------------------

def mesh_inputs():
    """``bench.py:238-256``'s inputs: 8 MSZIP frames of the bench corpus,
    each with the frame before as its dictionary, and 4 LZX streams at
    window 2^16."""
    import zlib

    from . import native
    from .utils import bench_corpus

    data = bench_corpus(8 * 32768)
    frames, sizes = [], []
    for i in range(8):
        raw = data[i * 32768:(i + 1) * 32768]
        co = zlib.compressobj(6, zlib.DEFLATED, -15,
                              zdict=data[(i - 1) * 32768:i * 32768]
                              if i else b"")
        frames.append(co.compress(raw) + co.flush())
        sizes.append(len(raw))
    datas = [bench_corpus(64 * 1024)[i * 7919:i * 7919 + 60000]
             for i in range(4)]
    streams = [native.lzx_encode(d, 16, 0)[0] for d in datas]
    return frames, sizes, data, streams, datas


def _mesh_rank(dev, inputs):
    """One rank of ``mesh_row``: both cases under ``shadow.active()``."""
    from .entry import _launches
    from .ops import shadow
    from .parallel import mesh as pmesh

    frames, sizes, data, streams, datas = inputs
    m = pmesh.default_mesh(device=dev)
    with shadow.active() as errs:
        ring_ok = pmesh.decode_frames_ring(m, frames, sizes) == data
        outs = pmesh.decode_lzx_streams_sharded(
            m, streams, [len(d) for d in datas], 16)
    lanes_ok = outs is not None and list(outs) == datas
    return {"ring_bit_exact": bool(ring_ok),
            "lzx_lanes_bit_exact": bool(lanes_ok),
            "launches": _launches(), "declines": dict(m.declines),
            "max_abs_err": dict(errs)}


def mesh_row(dev) -> dict:
    """``bench.py:221-265``: one rank, on NCCL on a card (gloo on the
    CPU). Returns the rank's result; raises where a case is not bit-exact
    or declines."""
    from .entry import _build_first
    from .parallel import multihost

    _build_first(dev)
    res, = multihost.spawn(_mesh_rank, 1,
                           "nccl" if dev.type == "cuda" else "gloo",
                           dev.type, args=(mesh_inputs(),), timeout_s=300)
    if not (res["ring_bit_exact"] and res["lzx_lanes_bit_exact"]) or \
            res["declines"]:
        raise AssertionError(f"mesh_1dev: {res}")
    return res


# -- the whole bench ---------------------------------------------------------

def device_info(dev) -> dict:
    if dev is None:
        return {"name": None, "reason": NO_CUDA}
    if dev.type == "cpu":
        return {"name": "cpu (plain versions, host clock)"}
    from .tools.timing import card_line
    name, _, limit = card_line().partition(", ")
    return {"name": name, "power_limit": limit}


def run(mb=None, reps=None, cabs=None, require_cuda=False, device=None,
        shapes=None) -> tuple[dict, dict]:
    """Every row; returns ``(the JSON line's object, details)``. ``mb``:
    corpus MiB per codec (``CORPUS_MB``); ``reps``: runs per row
    (``REPS``'s counts when None); ``cabs``: ``{codec: (corpus, cabinet)}``
    built already. The device rows run on the card where there is one;
    ``device="cpu"`` runs them on the plain versions instead (a
    rehearsal; ``shapes`` cuts the kernel entries, ``kernel_rows``).
    ``details`` holds the kernel entries (``"entries"``) and the mesh
    rank's result (``"mesh"``), None where the device rows did not run."""
    from .native import reference

    mb = dict(CORPUS_MB, **(mb or {}))
    reps = {k: reps or v for k, v in REPS.items()}
    if device is not None:
        from ._device import resolve_device
        dev = resolve_device(device)
    else:
        dev = torch.device("cuda") if torch.cuda.is_available() else None
    if require_cuda and (dev is None or dev.type != "cuda"):
        raise RuntimeError(f"--require-cuda: {NO_CUDA} "
                           f"(torch.cuda.is_available() is "
                           f"{torch.cuda.is_available()}, device {dev})")
    cuda = dev is not None
    extra = {"device": device_info(dev)}
    details = {"entries": None, "mesh": None}
    ref_mb_s = {}
    headline = None
    for comp in ("mszip", "lzx", "quantum"):
        corpus, cab_bytes = (cabs or {}).get(comp) or \
            cached_cab(comp, mb[comp])
        with tempfile.TemporaryDirectory() as d:
            cab_path = os.path.join(d, "bench.cab")
            with open(cab_path, "wb") as fh:
                fh.write(cab_bytes)
            ref_t = bench_reference(cab_path, reps["reference"])
            ours_t = bench_native(cab_path, corpus, reps["native"])
            cuda_t = bench_cuda(cab_path, corpus, dev, reps["cuda"]) \
                if comp == "mszip" and cuda else None
        gb = len(corpus) / 1e9
        ref_gbps = None if ref_t is None else gb / ref_t
        if ref_gbps:
            ref_mb_s[comp] = ref_gbps * 1e3
        base = {"reference_gb_s": ref_gbps} if ref_gbps else \
            reference.missing()
        row = {"value": gb / ours_t, "unit": "GB/s",
               "vs_baseline": gb / ours_t / ref_gbps if ref_gbps else None,
               "baseline": base}
        extra[ROWS[comp]] = row
        if comp == "mszip":
            headline = row
            extra["mszip_decompress_cuda"] = {
                "value": None, "unit": "GB/s", "vs_baseline": None,
                "reason": NO_CUDA} if cuda_t is None else {
                "value": gb / cuda_t, "unit": "GB/s",
                "vs_baseline": gb / cuda_t / ref_gbps if ref_gbps else None,
                "vs_native": ours_t / cuda_t, "baseline": base}
        print(f"# {comp}: corpus {len(corpus) >> 20} MiB, ratio "
              f"{len(cab_bytes) / len(corpus):.3f}; reference "
              + (f"{ref_gbps:.3f} GB/s ({ref_t:.3f}s, 1 thread C)"
                 if ref_gbps else f"none ({reference.missing()})")
              + f"; native {gb / ours_t:.3f} GB/s ({ours_t:.3f}s, "
              f"{os.cpu_count()} threads)"
              + (f"; cuda {gb / cuda_t:.3f} GB/s ({cuda_t:.3f}s)"
                 if cuda_t else ""), file=sys.stderr)
    if cuda:
        details["entries"] = kernel_rows(extra, dev, ref_mb_s, shapes)
        res = mesh_row(dev)
        details["mesh"] = res
        extra["mesh_1dev"] = {k: res[k] for k in ("ring_bit_exact",
                                                  "lzx_lanes_bit_exact")}
        print(f"# mesh 1-dev: ring={res['ring_bit_exact']} "
              f"lzx_lanes={res['lzx_lanes_bit_exact']}", file=sys.stderr)
    else:
        for name, _, _ in KERNEL_ROWS:
            extra[name] = {"value": None, "unit": "MB/s",
                           "vs_baseline": None, "reason": NO_CUDA}
        extra["mesh_1dev"] = {"value": None, "reason": NO_CUDA}
    doc = {"metric": "mszip_decompress", "value": headline["value"],
           "unit": "GB/s", "vs_baseline": headline["vs_baseline"],
           "extra": extra}
    return doc, details


def _mb_arg(text: str) -> dict:
    out = {}
    for part in text.split(","):
        k, _, v = part.partition("=")
        if k not in CORPUS_MB:
            raise argparse.ArgumentTypeError(f"unknown codec {k!r}")
        out[k] = int(v)
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(prog="libmspack_tpu_torch.bench")
    ap.add_argument("--require-cuda", action="store_true",
                    help="fail where there is no CUDA device")
    ap.add_argument("--mb", type=_mb_arg, default=None,
                    help="corpus MiB per codec, e.g. mszip=1,lzx=1,quantum=1")
    ap.add_argument("--reps", type=int, default=None,
                    help="runs per row (default: bench.py's)")
    args = ap.parse_args(argv)
    doc, _ = run(args.mb, args.reps, require_cuda=args.require_cuda)
    print(json.dumps(doc))
    return doc


if __name__ == "__main__":
    main()
