"""Decode planning: corpus-scale batch extraction.

The reference processes archives serially (reference:
cabextract.c:383-385). Here a *plan* turns a corpus of archives into
independent decode jobs along the natural shard grid (SURVEY.md §2.4):
archive -> folder -> (frames / reset chunks), then executes them with
the best engine per job:

* MSZIP folders: one engine call for the whole batch (frame-level
  parallelism inside, folder-level across).
* LZX / Quantum folders: one stream per folder, batched.
* NONE folders: raw copies.
* anything irregular (salvage cases, missing engines): scalar driver.

Copied from ``libmspack_tpu/parallel/planner.py``. Besides the imports:

* ``engine="cuda"`` (the default) decodes each codec's jobs over the whole
  plan on ``device``: every MSZIP job in one
  ``CudaMszipEngine.decode_folders`` call (K1, host phase B: the JAX
  default, ``tpu_pipeline.py:40``); the LZX jobs grouped by window bits,
  one ``CudaLzxEngine.decode_streams`` call a group (K3; the grouping of
  ``mesh.decode_cab_sharded``, ``mesh.py:823-845``); the Quantum jobs
  likewise, with the 0xFF trailer after every block (cabd.c:1327-1332),
  through ``CudaQtmEngine`` (K4). Declines stay per folder: a lane the
  engine flags, and a Quantum folder whose window-wrap flush the reference
  codec could fail on (``CabDecompressor._wrap_flush_fails``), take the
  JAX planner's own route from there (the native engine for LZX and
  Quantum where it decodes, then the scalar loop). Each decline is noted
  in ``Plan.fallback_reasons`` as the port's drivers note them; under
  strict mode (``strict=True`` or ``MSPACK_TPU_STRICT``) it raises
  ``FallbackError``. ``device="cuda"`` without a GPU raises.
* ``engine="auto"`` routes each codec's jobs by
  ``utils.choose_engine(their output bytes, codec)``; ``"scalar"`` sends
  every folder to the scalar loop.
* the archives are parsed, and the scalar loop runs, with
  ``CabDecompressor(engine="scalar")``: the port's driver defaults to the
  card.
* the plan keeps what a run did: ``timings`` (host ms of the parse, the
  CFDATA collect and each route), ``engines`` and ``calls`` (the CUDA
  engine and its calls per codec) and ``collect_routes``
  (``collect_native`` and ``collect_python``, the folders whose blocks
  the driver's collect took from one native walk or from its block
  reader); ``archive_files`` is the last step of ``extract_corpus`` on
  its own.
* spans (``tracing``): ``mspack.planner.plan``, ``.execute`` and ``.files``
  around the three steps; inside them ``mspack.planner.parse`` and
  ``.collect`` once an archive (``parse_ms``, ``collect_ms``) and
  ``mspack.planner.join``, the joining of the stream jobs' blocks.
"""
from __future__ import annotations

import collections
import dataclasses
import time
from typing import List, Optional

from .._device import (new_declines, note_fallback, reason_text,
                       resolve_device, resolve_engine, strict_mode)
from ..errors import ArgsError
from ..formats.cab import COMPTYPE_MASK, CabDecompressor, Cabinet
from ..system import BytesSink, PathOrBytes
from ..tracing import add_ms, span, spanned

CODECS = ("mszip", "lzx", "quantum")
_CODEC_OF = {1: "mszip", 2: "quantum", 3: "lzx"}   # comp_type & 0xF
_PATH_OF = {"mszip": "mszip_cuda", "lzx": "lzx_cuda", "quantum": "qtm_cuda"}


@dataclasses.dataclass
class FolderJob:
    archive_idx: int
    folder_idx: int
    comp_name: str
    frames: Optional[list]      # mszip: CK-stripped streams
    blocks: Optional[list]      # lzx/qtm: raw block payloads
    sizes: list
    comp_type: int

    @property
    def out_len(self) -> int:
        return sum(self.sizes)

    @property
    def key(self) -> tuple:
        return (self.archive_idx, self.folder_idx)

    @property
    def window_bits(self) -> int:
        return (self.comp_type >> 8) & 0x1F


@dataclasses.dataclass
class Plan:
    archives: list
    cabinets: List[Cabinet]
    jobs: List[FolderJob]
    fallback: List[tuple]       # (archive_idx, folder_idx) for scalar path
    timings: dict = dataclasses.field(default_factory=dict)
    engines: dict = dataclasses.field(default_factory=dict)
    calls: collections.Counter = dataclasses.field(
        default_factory=collections.Counter)
    # folders collected by the native walk or the block reader
    collect_routes: collections.Counter = dataclasses.field(
        default_factory=collections.Counter)
    # {path: "FallbackError: msg"} of the device paths that declined
    fallback_reasons: dict = dataclasses.field(default_factory=dict)
    strict: bool = False


@spanned("mspack.planner.plan")
def plan_archives(paths: List[PathOrBytes]) -> Plan:
    """Parse every archive on host and build the decode job list."""
    cabinets = []
    jobs: List[FolderJob] = []
    fallback = []
    timings = {"parse_ms": 0.0, "collect_ms": 0.0}
    d = CabDecompressor(engine="scalar")
    for ai, path in enumerate(paths):
        with span("mspack.planner.parse", timings, "parse_ms"):
            cab = d.open(path)
        cabinets.append(cab)
        with span("mspack.planner.collect", timings, "collect_ms"):
            for fi, fol in enumerate(cab.folders):
                ct = fol.comp_type & COMPTYPE_MASK
                if ct == 1:
                    collected = d.collect_mszip_frames(fol)
                    if collected is None:
                        fallback.append((ai, fi))
                        continue
                    frames, sizes = collected
                    jobs.append(FolderJob(ai, fi, "mszip", frames, None,
                                          sizes, fol.comp_type))
                elif ct in (2, 3):
                    collected = d.collect_raw_blocks(fol)
                    if collected is None:
                        fallback.append((ai, fi))
                        continue
                    blocks, sizes = collected
                    jobs.append(FolderJob(ai, fi,
                                          "lzx" if ct == 3 else "quantum",
                                          None, blocks, sizes, fol.comp_type))
                elif ct == 0:
                    collected = d.collect_raw_blocks(fol)
                    if collected is None:
                        fallback.append((ai, fi))
                        continue
                    blocks, sizes = collected
                    jobs.append(FolderJob(ai, fi, "none", None, blocks, sizes,
                                          fol.comp_type))
                else:
                    fallback.append((ai, fi))
    return Plan(paths, cabinets, jobs, fallback, timings,
                collect_routes=d.collect_routes)


def _native_archive_pipelines(plan: Plan, results: dict, n_threads,
                              routes: dict) -> None:
    """Whole-cabinet native fast path: one C call per archive does the
    CFDATA walk + checksums + all folder decodes against the mapped
    image — no per-folder Python copies (the per-job route below costs
    ~2x in slicing). Archives it declines fall through untouched, as do
    archives with a codec that ``routes`` sends elsewhere."""
    import numpy as np

    from .. import native
    if not native.available():
        return
    from ..formats.cab import BLOCKMAX, COMPTYPE_MASK, INPUTMAX

    for ai, cab in enumerate(plan.cabinets):
        jobs = [j for j in plan.jobs if j.archive_idx == ai]
        if not jobs or any((ai, fi) in plan.fallback
                           for fi in range(len(cab.folders))):
            continue
        if any(routes.get(j.comp_name, "native") != "native" for j in jobs):
            continue
        if any(len(fol.data) != 1 or fol.merge_prev or fol.merge_next
               for fol in cab.folders):
            continue
        if any((fol.comp_type & COMPTYPE_MASK) > 3
               for fol in cab.folders):
            continue
        try:
            src = plan.archives[ai]
            if isinstance(src, (bytes, bytearray)):
                img = np.frombuffer(src, np.uint8)
            else:
                img = np.memmap(src, dtype=np.uint8, mode="r")
            nblocks = sum(f.num_blocks for f in cab.folders)
            out = np.empty(max(nblocks * BLOCKMAX, 1), np.uint8)
            stage = None
            if any((f.comp_type & COMPTYPE_MASK) in (2, 3)
                   for f in cab.folders):
                stage = np.empty(nblocks * (INPUTMAX + 1), np.uint8)
            offs = native.cab_pipeline(
                img, [fol.data[0].offset for fol in cab.folders],
                [fol.num_blocks for fol in cab.folders],
                [fol.comp_type for fol in cab.folders],
                cab.block_resv, out, stage, n_threads=n_threads)
            if offs is None:
                continue
            for fi in range(len(cab.folders)):
                results[(ai, fi)] = out[offs[fi]:offs[fi + 1]]
        except Exception:
            continue


def _routes(plan: Plan, engine: str) -> dict:
    """codec -> "cuda", "native" or "scalar". ``"torch"`` has no batched
    route here (the drivers take it one archive at a time) and raises
    ``ArgsError`` rather than run on the host."""
    if engine != "auto":
        route = resolve_engine(engine)
        if route == "torch":
            raise ArgsError("the planner has no engine='torch' route: use "
                            "the drivers' engine='torch'")
        return dict.fromkeys(CODECS, route)
    from ..utils import choose_engine
    return {c: choose_engine(sum(j.out_len for j in plan.jobs
                                 if j.comp_name == c), c) for c in CODECS}


def _note(plan: Plan, path: str, eng, before: dict, keys) -> None:
    """Note the declines ``eng`` counted since ``before`` on the folders
    ``keys``, as the CAB driver notes a declined folder."""
    declined = new_declines(eng, before)
    if declined or keys:
        where = ", ".join(f"{a}:{f}" for a, f in keys)
        note_fallback(plan, path, f"{reason_text(declined) or 'declined'} "
                                  f"(archive:folder {where})")


def _cuda_mszip(plan, jobs, results, dev, n_threads):
    """Every MSZIP job in one ``CudaMszipEngine.decode_folders`` call."""
    from .cuda_pipeline import CudaMszipEngine
    eng = plan.engines.setdefault("mszip", CudaMszipEngine(dev))
    before = dict(eng.declines)
    outs = eng.decode_folders([(j.frames, j.sizes) for j in jobs], n_threads,
                              per_folder=True)
    plan.calls["mszip"] += 1
    for j, out in zip(jobs, outs):
        if out is not None:
            results[j.key] = out
    _note(plan, "mszip_cuda", eng, before,
          [jobs[fi].key for fi in eng.redecoded])


def _cuda_streams(plan, codec, jobs, results, dev, n_threads):
    """The LZX or Quantum jobs, one ``decode_streams`` call per window
    size (CAB LZX never resets, cabd.c:1249-1250: a folder is one
    stream)."""
    from . import cuda_pipeline as cp
    lzx = codec == "lzx"
    eng = plan.engines.setdefault(
        codec, (cp.CudaLzxEngine if lzx else cp.CudaQtmEngine)(dev))
    groups = collections.defaultdict(list)
    for j in jobs:
        groups[j.window_bits].append(j)
    for wb, group in sorted(groups.items()):
        before = dict(eng.declines)
        with span("mspack.planner.join"):
            if lzx:
                streams = [b"".join(j.blocks) for j in group]
            else:
                streams = [b"".join(b + b"\xff" for b in j.blocks)
                           for j in group]
        # an LZX folder's CFDATA sizes let K3 decode it a warp per frame
        kw = {"frame_sizes": [[len(b) for b in j.blocks] for j in group]} \
            if lzx else {}
        outs = eng.decode_streams(streams, [j.out_len for j in group], wb,
                                  n_threads, per_lane=True, **kw)
        plan.calls[codec] += 1
        declined = []
        for i, (j, out) in enumerate(zip(group, outs)):
            if out is not None and not lzx and CabDecompressor. \
                    _wrap_flush_fails(plan.cabinets[j.archive_idx]
                                      .folders[j.folder_idx],
                                      eng.wrap_spans[i]):
                eng.declines["window-wrap flush across a file edge"] += 1
                out = None
            if out is None:
                declined.append(j.key)
            else:
                results[j.key] = out
        _note(plan, f"{_PATH_OF[codec]} window 2^{wb}", eng, before,
              declined)


@spanned("mspack.planner.execute")
def execute(plan: Plan, n_threads: int | None = None,
            errors: dict | None = None, engine: str = "cuda",
            device="cuda", strict=None) -> dict:
    """Run all jobs; returns {(archive_idx, folder_idx): folder_bytes}.

    engine="cuda" decodes each codec's jobs on ``device`` (module
    docstring); engine="native" decodes whole archives with the C++
    pipeline, then the remaining MSZIP folders with the C++ thread pool
    and LZX and Quantum folders one native call each. Jobs the fast
    engines decline are re-run through the scalar driver so error
    semantics match the reference exactly. Decode failures are recorded
    in `errors` (same key -> exception) — partial folder bytes are still
    returned, like the reference's salvage discipline, but never silently
    (mspack.h error contract).

    engine="auto" routes by workload and codec: the CUDA path is chosen
    for a codec only when the host calibration (utils.engine_calibration,
    measured by tools/calibrate_engines.py) says it wins end-to-end at
    this plan's output size of that codec."""
    from .. import native

    plan.strict = strict_mode(strict)
    routes = _routes(plan, engine)
    dev = resolve_device(device) if "cuda" in routes.values() else None

    # a folder of a device codec whose blocks could not be collected is a
    # decline, as in the CAB driver
    uncollected = collections.defaultdict(list)
    for ai, fi in plan.fallback:
        codec = _CODEC_OF.get(plan.cabinets[ai].folders[fi].comp_type
                              & COMPTYPE_MASK)
        if codec and routes[codec] == "cuda":
            uncollected[codec].append((ai, fi))
    for codec, keys in uncollected.items():
        where = ", ".join(f"{a}:{f}" for a, f in keys)
        note_fallback(plan, _PATH_OF[codec], "CFDATA blocks could not be "
                      f"collected (archive:folder {where})")

    results: dict = {}
    t0 = time.perf_counter()
    if "native" in routes.values():
        _native_archive_pipelines(plan, results, n_threads, routes)
    add_ms(plan.timings, "native_ms", t0)

    def todo(codec):
        return [j for j in plan.jobs
                if j.comp_name == codec and j.key not in results]

    # the device paths: one engine call per codec (per window for streams)
    if routes["mszip"] == "cuda" and todo("mszip"):
        t0 = time.perf_counter()
        _cuda_mszip(plan, todo("mszip"), results, dev, n_threads)
        add_ms(plan.timings, "mszip_cuda_ms", t0)
    for codec in ("lzx", "quantum"):
        if routes[codec] == "cuda" and todo(codec):
            t0 = time.perf_counter()
            _cuda_streams(plan, codec, todo(codec), results, dev, n_threads)
            add_ms(plan.timings, f"{codec}_cuda_ms", t0)

    t0 = time.perf_counter()
    mszip_jobs = todo("mszip")
    if mszip_jobs and routes["mszip"] == "native" and native.available():
        outs = native.mszip_folders(
            [(j.frames, j.sizes) for j in mszip_jobs], n_threads)
        if outs is not None:
            for j, out in zip(mszip_jobs, outs):
                results[j.key] = out

    for j in plan.jobs:
        if j.key in results:
            continue
        if j.comp_name == "none":
            results[j.key] = b"".join(j.blocks)
        elif routes.get(j.comp_name) == "scalar" or not native.available():
            continue
        elif j.comp_name == "lzx":
            out = native.lzx_decode(b"".join(j.blocks), j.window_bits, 0,
                                    j.out_len)
            if out is not None:
                results[j.key] = out
        elif j.comp_name == "quantum":
            stream = b"\xFF".join(j.blocks) + b"\xFF" if j.blocks else b""
            out = native.qtm_decode(stream, j.window_bits, j.out_len)
            if out is not None:
                results[j.key] = out
    add_ms(plan.timings, "native_ms", t0)

    # scalar fallback for declined/irregular folders
    t0 = time.perf_counter()
    todo_keys = ([j.key for j in plan.jobs if j.key not in results]
                 + plan.fallback)
    for ai, fi in todo_keys:
        cab = plan.cabinets[ai]
        fol = cab.folders[fi]
        d = CabDecompressor(engine="scalar")
        sink = BytesSink()
        # decode the folder by extracting its byte range via files
        files = [f for f in cab.files if f.folder is fol]
        if not files:
            continue
        end = max(f.offset + f.length for f in files)
        d._init_folder_state(fol)
        d._d.outsink = sink
        try:
            d._run_decomp(d._d, end)
        except Exception as exc:
            if errors is not None:
                errors[(ai, fi)] = exc
        finally:
            if d._d is not None:
                d._d.outsink = None
        results[(ai, fi)] = sink.getvalue()
    add_ms(plan.timings, "scalar_ms", t0)
    return results


@spanned("mspack.planner.files")
def archive_files(plan: Plan, folder_bytes: dict) -> List[dict]:
    """Per-archive {filename: bytes} from ``execute``'s folder bytes."""
    out = []
    for ai, cab in enumerate(plan.cabinets):
        files = {}
        for f in cab.files:
            fi = next((i for i, fol in enumerate(cab.folders)
                       if fol is f.folder), None)
            if fi is None:
                continue
            blob = folder_bytes.get((ai, fi))
            if blob is None or f.offset + f.length > len(blob):
                continue
            files[f.filename] = bytes(blob[f.offset : f.offset + f.length])
        out.append(files)
    return out


def extract_corpus(paths: List[PathOrBytes],
                   n_threads: int | None = None,
                   errors: dict | None = None,
                   engine: str = "cuda", device="cuda",
                   strict=None) -> List[dict]:
    """Decode whole archives: returns per-archive {filename: bytes}.
    Folder decode failures land in `errors` keyed (archive, folder)."""
    plan = plan_archives(paths)
    folder_bytes = execute(plan, n_threads, errors=errors, engine=engine,
                           device=device, strict=strict)
    return archive_files(plan, folder_bytes)
