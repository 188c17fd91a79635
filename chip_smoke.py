#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port's main path once on one GPU, and check it.

    python3 chip_smoke.py
    python3 chip_smoke.py --time-k12   # K1 and K2 alone (time_k12)
    python3 chip_smoke.py --time-k34   # K3 and K4 alone (time_k34)
    python3 chip_smoke.py --time-oab   # the OAB files alone (time_oab)
    python3 chip_smoke.py --diag-k1    # where K1's time goes (diag_k1)
    python3 chip_smoke.py --measure    # phase 25 alone (measure_only)

Phases (any failure raises and exits non-zero; each prints its seconds):
1. require a CUDA device; print the card's name and power limit;
2. build the kernels (nvcc, sm_90a); print the build time, each kernel's
   ptxas report (stack frame, spills, registers, shared memory) and the
   SASS summary of K1, K2's two passes, K3 and K4, and of the probes P1
   and P3, each faithful port beside its redesign (loads and stores by
   memory space, ``tools/sass.py``);
3. K1 against its plain version on the edge-case batch
   (libmspack_tpu_torch/edge_cases.py): counts, tokens and resolved bytes
   must be equal;
4. K2 against its plain version on those traces: bytes and counts equal;
   then both kernels against their plain versions, and timed, at the
   shapes of the main path: K1 on one folder (the driver's launch) with
   the folder's literals and matches and K1's ns per symbol of its
   longest frame, K1 on the whole cabinet at 1, 2, 4 and 8 warps a block,
   K2 on the whole cabinet with the time of each pass;
5. the bench's 96 MiB MSZIP cabinet (four 24 MiB folders, 3072 frames;
   ``build_corpus`` and ``build_cab`` below give bench.py's bytes)
   extracted through create_cab_decompressor(engine="cuda"); the bytes
   must equal the corpus, K1 must have launched, nothing may decline; the
   port's engine="native" (host C++) on the same cabinet for comparison;
6. the same folders through CudaMszipEngine(phase_b="device"): bytes equal
   and K2 launched; then phase_b="host", and device phase B (k2_ms +
   bytes_pull_ms) beside host phase B (trace_pull_ms + host_resolve_ms);
7. K3 against its plain version on the LZX edge batch
   (libmspack_tpu_torch/lzx_edge_cases.py): counts, tokens and state
   records equal, bytes equal to the reference codec's; and K3 in
   segments through its state record against one launch;
8. K3 against its plain version on one whole bench LZX folder (the CAB
   driver's launch), with its ns per token (kernel time over the tokens
   of the lane) and per literal or match, and K3 alone on all four
   folders in one launch;
9. the bench's 96 MiB LZX cabinet (four 24 MiB folders, window 2^16)
   through create_cab_decompressor(engine="cuda"): bytes equal, K3
   launched, no decline; engine="native" beside it;
10. the four folders through CudaLzxEngine in one call;
11. a 16 MiB CHM from chm_c.write_chm (window 2^16, reset every 2 frames:
    256 chunks): K3 against its plain version on its 256 chunks (the CHM
    driver's launch), then the CHM through create_chm_decompressor(
    engine="cuda"): bytes equal, K3 launched, one lane per chunk, no
    decline; engine="native" beside it;
12. K4 against its plain version on the Quantum edge batch
    (libmspack_tpu_torch/qtm_edge_cases.py): counts, tokens and state
    records equal, bytes equal to the reference codec's; K4 in segments
    through its state record against one launch;
13. K4 against its plain version on one whole 6 MiB bench Quantum folder
    (the CAB driver's launch), with its ns per token and per adaptive-model
    symbol, and K4 alone on all four in one launch;
14. the bench's 24 MiB Quantum cabinet (four 6 MiB folders, window 2^16)
    through create_cab_decompressor(engine="cuda"): bytes equal, K4
    launched, no decline; engine="native" beside it; then the four
    folders through CudaQtmEngine in one call;
15. the probe tools P1-P6 (libmspack_tpu_torch.tools): each tool's main()
    at its own shapes, as ``python -m libmspack_tpu_torch.tools.<name>``
    runs it, then every run of a probe kernel against its plain version;
16. OAB on K3 (``oab_inputs``): a 64 MiB full download in 64 KiB blocks
    (1024 lanes at window 2^17), a 64 MiB incremental patch against a
    64 MiB base, and a 32 MiB full download in 4 MiB blocks (window 2^22):
    K3 against its plain version on each file's launch, then each file
    through create_oab_decompressor(engine="cuda", strict=True) cold and
    warm beside engine="native": bytes equal, one engine call per window,
    no decline; the engine's phase times and the driver's host CRC check
    (crc_ms), and the device CRC op (ops/crc32.py) on the file's blocks
    beside host CRC-32;
17. a 1 MiB SZDD file from lzss_c through create_szdd_decompressor(
    engine="cuda") (LZSS as device tensor ops) beside engine="native";
18. the corpus planner on corpus A (``build_corpus_a``: 64 cabinets, each
    a 1 MiB MSZIP, a 1 MiB LZX at window 2^21, a 512 KiB Quantum and a
    256 KiB NONE folder, 176 MiB out): extract_corpus(engine="cuda",
    strict=True) cold and warm (K1, K3 and K4 each launched once), beside
    engine="native" and the per-cabinet CabDecompressor(engine="cuda");
    bytes equal the written files; the engine calls, lanes per launch,
    host collect time and each engine's timings;
19. corpus B, the bench cabinets of phases 5, 9 and 14, in one
    extract_corpus beside the per-cabinet driver's MB/s of those phases;
    then CudaMszipEngine(phase_b="host") against "device" on the plan's
    MSZIP jobs, in turns;
20. the port's calibrate_engines into a temporary file (its JSON
    printed), read back by choose_engine through MSPACK_CALIBRATION;
21. ``python -m libmspack_tpu_torch.cli.cabextract --engine cuda`` in a
    subprocess under MSPACK_TPU_STRICT=1 on a corpus A cabinet and the
    LZX bench cabinet: -d's files equal the inputs, -t's MD5s hashlib's;
23. engine="torch" (the JAX package's "jax" engine as tensor ops, no
    kernel) under strict mode on the archives of phases 5, 9, 11, 16 and
    17 (the MSZIP and LZX cabinets, the CHM, the 64 MiB OAB full download,
    the SZDD file) beside engine="cuda" and "native" on each: bytes equal,
    MB/s, the ops' phase A and B ms, peak device memory; a decline prints
    its reasons (each one of the JAX package's) and the bytes are checked
    with strict=False; then entry()'s forward step and the bitview, E8
    and MSCF-search ops on the card against the host;
24. the mesh (parallel/mesh.py on torch.distributed): dryrun_multichip(1)
    on NCCL and dryrun_multichip(4) over gloo with four ranks on the one
    card (the JAX package's three dry-run cases, bit-exact on every rank;
    K1, K3 and K4 launched, their plain versions never, no decline), and
    decode_cab_multihost over 2 gloo ranks; each case's seconds; every
    rank holds each of its K1, K3 and K4 launches to the kernel's plain
    version on CPU copies of the same inputs (``ops/shadow.py``: counts,
    state records, live tokens), and the largest difference joins the
    kernel's max_abs_err;
25. the JAX package's measurement path through the port
    (``measure_phase``): ``python -m libmspack_tpu_torch.bench``'s rows on
    the cabinets of phases 5, 9 and 14 (native rows,
    ``mszip_decompress_cuda`` strict, the K1, K3 and K4 rows from their
    bench entries at the JAX shapes: K1 on 1024 frames of 32 KiB, K3 on
    1024 chunks of 64 KiB at window 2^16, K4 on 1024 streams of 24 KiB at
    2^15; ``mesh_1dev`` on one NCCL rank), printed as the bench's JSON
    line, then K2's entry on 256 frames: every lane without error, the
    sampled lanes (0, n/2, n-1) bit-exact and equal to the plain version
    run on their own inputs, each entry's launch configuration (blocks
    per SM from the runtime) and peak memory printed; ``mesh_scaling`` at
    1, 2 and 4 ranks (each rank's first decode shadow-checked),
    ``scaling_model`` from this run's rates and P5's gather rate,
    ``cut_bisect`` on one marker (nvcc, compile only), and
    ``devtime.time_chained`` on a chain of K1 launches beside the entry's
    time;
22. last (a kernel fault would poison the CUDA context): the port's
    fuzz_mass with engine="cuda" on CAB (MSZIP, LZX and Quantum folders),
    CHM, OAB and SZDD, seeded, 15 s each: no foreign exception, no CUDA
    error after any archive, no byte mismatch with the scalar engine;
    error-class differences are printed by class.

Each kernel's launch count is set to 0 just before its main path runs and
read just after (for a probe, its tool's main(), where a kernel replayed
from a CUDA graph counts once per replay; K3's is its CAB LZX path's plus
the OAB path's, each file's counted alone; K1-K4 add the launches of
phases 18-19, each run counted alone, K1, K3 and K4 those of phase
24's paths, counted in each spawned rank and summed, and K1-K4 those of
phase 25, the parent's and its ranks'). The next-to-last line is
a JSON object with each kernel's launches on the main path, its largest
difference from the plain version, its time, the plain version's, and its
bound: the larger of the bytes it must move over the card's memory rate
and its serial chain (for a decoder the tokens of its longest lane, each
at least one dependent step of one SM; for a probe its steps within one
lane, an indexed load or an ALU stage one step, a search or reduction
over n values a tree of depth log2 n, a loop that ends early as far as
this run's data takes it: ``tools.Work``) over the SM clock. No PyTorch
call computes these decoders, so their ``library_ms`` is null; for the
gather probes it is the time of ``torch.gather`` on the same inputs (and
the remainder, for P6's). K2's chain is its two passes': the most tokens
of one lane (pass 1) plus the most lanes of one chain (pass 2, one
dependent step a lane). A probe's time is the largest of its tool's
shapes. The last line is {"ok": true, "device": {...}}. It imports
neither JAX nor the JAX package nor bench.py nor tools/.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time

MB = 1 << 20
HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory
SM_CLOCK_HZ = 1.98e9        # H100 SXM boost clock
# bench.py's cabinets: corpus MiB and folder MiB per codec (bench.py:33-37)
CORPUS_MB = {"mszip": 96, "lzx": 96, "quantum": 24}
FOLDER_MB = {"mszip": 24, "lzx": 24, "quantum": 6}


def build_corpus(total_bytes: int) -> bytes:
    """bench.py:40-50, the same bytes (``libmspack_tpu_torch.bench``)."""
    from libmspack_tpu_torch import bench
    return bench.build_corpus(total_bytes)


def build_cab(corpus: bytes, compression: str) -> bytes:
    """bench.py:53-60 with the port's cabinet writer, the same bytes
    (``libmspack_tpu_torch.bench``)."""
    from libmspack_tpu_torch import bench
    return bench.build_cab(corpus, compression)


def _encode_blocks(jobs, threads=8):
    """``native.lzx_encode(data, window_bits, is_delta=True, ref_data=ref)``
    of each ``(data, window_bits, ref)``, on threads (the encoder leaves
    the GIL), in order: what ``compress/lzx_e.compress`` gives."""
    from concurrent.futures import ThreadPoolExecutor

    from libmspack_tpu_torch import native

    def one(job):
        data, wb, ref = job
        return native.lzx_encode(data, wb, is_delta=True, ref_data=ref)[0]

    with ThreadPoolExecutor(threads) as pool:
        return list(pool.map(one, jobs))


def _window_bits(size):
    wb = 17
    while wb < 25 and (1 << wb) < size:
        wb += 1
    return wb


def build_oab(data: bytes, block_size: int = 65536) -> bytes:
    """``compress/oab_c.write_oab(data, block_size)``, the same bytes, with
    the blocks encoded on threads."""
    from libmspack_tpu_torch.formats.oab import crc32_raw

    chunks = [data[i:i + block_size]
              for i in range(0, max(len(data), 1), block_size)]
    streams = _encode_blocks([(c, _window_bits(len(c)), b"")
                              for c in chunks])
    out = bytearray()
    for v in (3, 1, block_size, len(data)):
        out += v.to_bytes(4, "little")
    for c, s in zip(chunks, streams):
        for v in (1, len(s), len(c), crc32_raw(c)):
            out += v.to_bytes(4, "little")
        out += s
    return bytes(out)


def build_oab_patch(target: bytes, base: bytes,
                    block_size: int = 65536) -> bytes:
    """``compress/oab_c.write_oab_patch(target, base, block_size)``, the
    same bytes, with the blocks encoded on threads."""
    from libmspack_tpu_torch.formats.oab import crc32_raw

    jobs, bpos = [], 0
    for i in range(0, max(len(target), 1), block_size):
        chunk = target[i:i + block_size]
        ssize = min(block_size, len(base) - bpos) if bpos < len(base) else 0
        ref = base[bpos:bpos + ssize]
        bpos += ssize
        jobs.append((chunk, _window_bits(((ssize + 32767) & ~32767)
                                         + len(chunk)), ref))
    streams = _encode_blocks(jobs)
    out = bytearray()
    for v in (3, 2, block_size, len(base), len(target), crc32_raw(base),
              crc32_raw(target)):
        out += v.to_bytes(4, "little")
    for (chunk, _, ref), s in zip(jobs, streams):
        for v in (len(s), len(chunk), len(ref), crc32_raw(chunk)):
            out += v.to_bytes(4, "little")
        out += s
    return bytes(out)


def oab_lanes(blob: bytes, want: bytes, base: bytes | None = None):
    """The LZX blocks of an OAB file (a patch against ``base`` when given)
    as K3 cases, as the OAB driver hands them to ``CudaLzxEngine``: each
    block's stream, size, window, DELTA reference data and its bytes of
    ``want``. Returns ``{window_bits: [LzxCase]}``."""
    from libmspack_tpu_torch import lzx_edge_cases as le

    groups: dict[int, list] = {}
    p, out, bpos = (16, 0, 0) if base is None else (0x1C, 0, 0)
    while out < len(want):
        f = [int.from_bytes(blob[p + i:p + i + 4], "little")
             for i in (0, 4, 8, 12)]
        if base is None:
            flags, csize, dsize, _ = f
            ref, wb = b"", _window_bits(dsize)
        else:
            csize, dsize, ssize, _ = f
            flags, ref = 1, base[bpos:bpos + ssize]
            bpos += ssize
            wb = _window_bits(((ssize + 32767) & ~32767) + dsize)
        if flags:
            groups.setdefault(wb, []).append(le.LzxCase(
                "oab block", blob[p + 16:p + 16 + csize], dsize, wb, True,
                ref, want[out:out + dsize]))
        p += 16 + csize
        out += dsize
    return groups


def bench_folders(corpus, compression):
    """``build_cab(corpus, compression)`` and its folders as the CAB driver
    hands them to its engine, as K3 (``"lzx"``) or K4 (``"quantum"``)
    cases: each folder's stream (a Quantum block followed by the 0xFF
    trailer the reader injects), its output size and window, and for
    Quantum its bytes."""
    from libmspack_tpu_torch import create_cab_decompressor
    from libmspack_tpu_torch import lzx_edge_cases as le
    from libmspack_tpu_torch import qtm_edge_cases as qe

    blob = build_cab(corpus, compression)
    probe = create_cab_decompressor(engine="native")
    folders, off = [], 0
    for fol in probe.open(blob).folders:
        blocks, fsizes = probe.collect_raw_blocks(fol)
        n, wb = sum(fsizes), (fol.comp_type >> 8) & 0x1F
        if compression == "lzx":
            folders.append(le.LzxCase("folder", b"".join(blocks), n, wb,
                                      frame_sizes=[len(b) for b in blocks]))
        else:
            folders.append(qe.QtmCase(
                "folder", b"".join(b + b"\xff" for b in blocks), n, wb,
                corpus[off:off + n]))
        off += n
    return blob, folders


def bound(nbytes, chain):
    """(bound_ms, bound_by): the larger of ``nbytes`` over the memory rate
    and ``chain`` dependent steps at the SM clock."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = chain / SM_CLOCK_HZ * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def entry(name, source, replaces, launches, err, ms, plain_ms, nbytes,
          chain, library_ms=None):
    """One kernel's object of the kernels line."""
    b_ms, b_by = bound(nbytes, chain)
    return {"name": name, "route": "cuda",
            "source": f"libmspack_tpu_torch/csrc/{source}",
            "replaces": replaces, "launches": launches, "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": library_ms}


def trace_bytes(lens, cnt, state_bytes=0):
    """Bytes a phase-A launch must move: each stream read once, each
    lane's tokens (tok + litw), counts and state record written once."""
    import numpy as np
    cnt = np.asarray(cnt)
    return int(np.asarray(lens).sum()) + 8 * int(cnt[2].sum()) \
        + cnt.size * 4 + cnt.shape[1] * state_bytes


def trace_mix(tok):
    """(literal bytes, match lengths) of one lane's K3/K4 tokens."""
    import numpy as np

    tok = np.asarray(tok)
    lits = tok[(tok & 0x20000000) != 0] & 0xFF
    return int(lits.sum()), tok[(tok & 0x40000000) != 0] & 0xFFFFFF


def deflate_mix(tok, ntok):
    """(literals, matches) of each lane of K1 tokens ``(L, T)`` with
    ``ntok`` tokens each: a literal token carries 1-4 literals, a match
    token 0-3 pending ones."""
    import numpy as np

    tok = np.asarray(tok)
    live = np.arange(tok.shape[1])[None, :] < np.asarray(ntok)[:, None]
    lit = live & (tok >= 0) & ((tok & 0x20000000) != 0)
    mat = live & (tok >= 0) & ((tok & 0x40000000) != 0)
    lits = np.where(lit, tok & 7, 0) + np.where(mat, (tok >> 25) & 3, 0)
    return lits.sum(axis=1), mat.sum(axis=1)


def card_line() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60, check=True)
    return r.stdout.strip().splitlines()[0]


def timed(fn, device, reps=1):
    """(result, best ms over reps): CUDA events on the card, the host
    clock on the CPU."""
    import torch
    best, out = float("inf"), None
    for _ in range(reps):
        if device.type == "cuda":
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            out = fn()
            b.record()
            b.synchronize()
            best = min(best, a.elapsed_time(b))
        else:
            t0 = time.perf_counter()
            out = fn()
            best = min(best, (time.perf_counter() - t0) * 1e3)
    return out, best


def engine_phases():
    """A CPU-only ``torch.profiler`` over a call: while one records, the
    engines time their uploads, kernels and pulls on the card's CUDA
    events (``upload_ms``, ``k1_ms``..., ``trace_pull_ms``)."""
    from torch.profiler import ProfilerActivity, profile
    return profile(activities=[ProfilerActivity.CPU])


def k1_compare(cases, device, tcap):
    """K1 on ``device`` and its plain version on one batch; returns
    (device results on the CPU, plain results, max abs difference)."""
    import torch

    from libmspack_tpu_torch.ops import cuda_inflate as ci

    s, lens = ci.pack_streams([c.stream for c in cases])
    hists = torch.tensor([c.hist for c in cases], dtype=torch.int32)
    plain, plain_ms = timed(lambda: ci.inflate_phase_a_plain(
        s, lens, hists, tcap=tcap), torch.device("cpu"))
    sd, ld, hd = (t.to(device) for t in (s, lens, hists))
    dev, ms = timed(lambda: ci.inflate_phase_a(sd, ld, hd, tcap=tcap),
                    device, reps=3)
    dev = tuple(t.cpu() for t in dev)
    err = 0
    if not torch.equal(dev[2][:4], plain[2][:4]):
        raise AssertionError("K1 counts differ from the plain version")
    for i in range(len(cases)):
        n = int(plain[2][2, i])
        for a, b in ((dev[0], plain[0]), (dev[1], plain[1])):
            err = max(err, int((a[i, :n].long() - b[i, :n].long())
                               .abs().max()) if n else 0)
    return dev, plain, err, ms, plain_ms


def k2_compare(tok, litw, ntok, sizes, flags, device):
    """K2 on ``device`` (best of 3) and its plain version on one batch;
    returns (device results on the CPU, max abs byte difference, ms, plain
    ms, (pass 1 ms, pass 2 ms) of the best run, None off the card)."""
    import torch

    from libmspack_tpu_torch.ops import cuda_resolve as cr

    plain, plain_ms = timed(lambda: cr.resolve_frames_plain(
        tok, litw, ntok, sizes, flags), torch.device("cpu"))
    args = [t.to(device) for t in (tok, litw, ntok)]
    ms, dev, passes = float("inf"), None, None
    for _ in range(3):
        marks = [] if device.type == "cuda" else None
        out, t = timed(lambda: cr.resolve_frames_device(
            *args, sizes, flags, marks=marks), device)
        if t < ms:
            ms, dev = t, out
            passes = (marks[0].elapsed_time(marks[1]),
                      marks[1].elapsed_time(marks[2])) if marks else None
    dev = tuple(t.cpu() for t in dev)
    if not torch.equal(dev[1], plain[1]):
        raise AssertionError("K2 counts differ from the plain version")
    err = int((dev[0].int() - plain[0].int()).abs().max()) \
        if len(plain[0]) else 0
    return dev, err, ms, plain_ms, passes


def extract_all(d, blob):
    from libmspack_tpu_torch.system import BytesSink

    cab = d.open(blob)
    parts = []
    for f in cab.files:
        sink = BytesSink()
        d.extract(f, sink)
        parts.append(sink.getvalue())
    return b"".join(parts)


def extract_chm(d, blob):
    """{name: bytes} of every file of a CHM (directory order)."""
    from libmspack_tpu_torch.system import BytesSink

    h = d.open(blob)
    out = {}
    for f in h.files:
        sink = BytesSink()
        d.extract(f, sink)
        out[f.filename] = sink.getvalue()
    return out


DECODERS = ("k1_inflate_kernel", "k2_pass1_kernel", "k2_pass2_kernel",
            "k3_lzx_kernel", "k4_qtm_kernel")
# P2's and P4's redesigns, each with its 16-byte path and without
P24_SASS = tuple(f"{k}<{v}>" for k in (
    "p2_skel_vec_kernel", "p4_reduce_pred_vec", "p4_cond_vec_vec",
    "p4_while22_vec", "p4_table_rw_vec", "p4_stage_store_vec",
    "p4_minscalar_vec", "p4_smem_scalar_vec", "p4_u64shift_vec",
    "p4_dma_row_vec")
    for v in ("false", "true"))
# P1's, P2's, P3's, P5's and P6's faithful ports, each beside its redesign
PROBE_SASS = ("p1_sweep_kernel<false>", "p1_sweep_kernel<true>",
              "p1_vec_kernel<false>", "p1_vec_kernel<true>", "p1_reg_kernel",
              "p3_copy_kernel", "p3_par_kernel", "p5_dyngather_kernel",
              "p5_cluster_kernel", "p5_row_kernel<false>",
              "p5_row_kernel<true>", "p5_masksum_kernel",
              "p5_masksum_vec_kernel", "p5_symbol_kernel",
              "p5_symbol_smem_kernel", "p6_masksum_kernel",
              "p6_masksum_vec_kernel", "p6_symbol_kernel",
              "p6_symbol_smem_kernel", "p2_skel_kernel") + P24_SASS
# what a redesign's SASS must show: (kernel, count key, least, most)
SASS_CHECKS = (("p6_symbol_smem_kernel", "loop LDS", 1, None),
               ("p6_symbol_smem_kernel", "LDL", 0, 0),
               ("p6_masksum_vec_kernel", "LDL", 0, 0),
               ("p5_row_kernel<true>", "LDS", 1, None),
               ("p5_row_kernel<true>", "LDL", 0, 0),
               ("p5_row_kernel<false>", "LDS", 1, None),
               ("p5_row_kernel<false>", "LDL", 0, 0),
               ("p5_masksum_vec_kernel", "LDL", 0, 0)) + tuple(
                   (k, "LDL", 0, 0) for k in P24_SASS)


def build_report(t0, names):
    """Build the kernels (if need be), then print the build's time, every
    kernel's ptxas line and the SASS summary of the kernels ``names``."""
    from libmspack_tpu_torch import kernels
    from libmspack_tpu_torch.tools import sass

    kernels.lib()
    print(f"build: {time.perf_counter() - t0:.3f} s "
          f"({kernels.build_info['path']})")
    for name, line in sorted(kernels.ptxas_report().items()):
        print(f"ptxas {name}: {line}")
    found = sass.summarise(sass.listing())
    for name in names:
        c = found[name]
        print(f"sass {name}: {c['insns']} insns, {c['loops']} loops; "
              + " ".join(f"{o} {c[o]}" for o in sass.OPS if c[o])
              + "; in loops: " + " ".join(
                  f"{o} {c['loop ' + o]}" for o in sass.OPS
                  if c["loop " + o]))
    for name, key, least, most in SASS_CHECKS:
        n = found[name][key]
        if n < least or (most is not None and n > most):
            raise AssertionError(f"sass {name}: {key} {n}, want "
                                 f"{least}..{most}")


class Clock:
    """Prints the seconds each phase took."""

    def __init__(self):
        self.t = time.perf_counter()

    def lap(self, name):
        now = time.perf_counter()
        print(f"phase {name}: {now - self.t:.1f} s", flush=True)
        self.t = now


def run(device_name="cuda", total_mb=96, edge_frame=32768, lzx_big=1 << 20,
        chm_mb=16, qtm_mb=24, reps=4, oab_mb=64, oab_big_mb=32,
        oab_big_block=4 << 20, szdd_bytes=1 << 20, corpus_cabs=64,
        calib_mb=(4, 24), fuzz_s=15, torch_kb=None, small_bench=False):
    """All phases after the device check; returns the kernels' JSON.

    ``run("cpu", total_mb=6, edge_frame=4096, lzx_big=1 << 17, chm_mb=2,
    qtm_mb=1, reps=2, oab_mb=1, oab_big_mb=1, oab_big_block=1 << 19,
    szdd_bytes=1 << 16, corpus_cabs=2, calib_mb=(0.25,), fuzz_s=2,
    torch_kb=128, small_bench=True)`` rehearses every phase on the CPU,
    with the kernels' plain versions, before a run on the card.
    ``torch_kb`` gives phase 23 copies of the bench's archives cut to that
    many KiB (``torch_small``); ``small_bench`` runs phase 25's bench
    entries at ``SMALL_SHAPES`` and its mesh at 1 and 2 ranks."""
    import tempfile
    import threading

    import torch

    from libmspack_tpu_torch import native

    device = torch.device(device_name)
    clock = Clock()
    # 2. build: the host engine's g++ beside the kernels' nvcc processes
    t0 = time.perf_counter()
    host = threading.Thread(target=native.lib)
    host.start()
    if device.type == "cuda":
        build_report(t0, DECODERS + PROBE_SASS)
    host.join()
    native.lib()   # raises if the host engine did not build
    clock.lap("build")
    bench = {}
    entries = mszip_phases(device, total_mb, edge_frame, reps, clock, bench)
    k3 = lzx_phases(device, total_mb, lzx_big, chm_mb, reps, clock, bench)
    entries.append(k3)
    entries.append(qtm_phases(device, qtm_mb, lzx_big, reps, clock, bench))
    probes = {}
    entries.extend(probe_phases(device, clock, probes))
    # K3's entry gains the OAB path's launches and comparisons
    oab_launches, e3 = oab_phases(device, oab_mb, oab_big_mb, oab_big_block,
                                  min(reps, 3), clock, bench)
    print(f"K3 launches: CAB LZX path {k3['launches']}, OAB path "
          f"{oab_launches}")
    k3["launches"] += oab_launches
    k3["max_abs_err"] = max(k3["max_abs_err"], e3)
    szdd_phase(device, szdd_bytes, min(reps, 3), clock, bench)
    # the corpus planner's paths; their launches join each kernel's entry
    counts = Launches(device)
    with tempfile.TemporaryDirectory() as td:
        t0 = time.perf_counter()
        paths, want = build_corpus_a(td, corpus_cabs)
        print(f"corpus A built in {time.perf_counter() - t0:.1f} s")
        corpus_phases(device, paths, want, bench, min(reps, 3), counts,
                      clock)
        calibration_phase(device, calib_mb, clock)
        cli_phase(device, paths[0], want[0], bench, clock)
    print(f"launches on the planner paths: {counts.total}")
    for e in entries:
        e["launches"] += counts.total.get(e["name"], 0)
    torch_phase(device, torch_small(bench, torch_kb << 10) if torch_kb
                else bench, clock)
    mesh, mesh_err = mesh_phase(device, clock)
    print(f"launches on the mesh paths: {mesh}; largest differences from "
          f"the plain versions there: {mesh_err}")
    for e in entries:
        e["launches"] += mesh.get(e["name"], 0)
        e["max_abs_err"] = max(e["max_abs_err"], mesh_err.get(e["name"], 0))
    meas, meas_err = measure_phase(
        device, clock, bench, probes["micro_gather"],
        SMALL_SHAPES if small_bench else BENCH_SHAPES,
        (1, 2) if small_bench else (1, 2, 4))
    print(f"launches on the measurement path: {meas}; largest differences "
          f"from the plain versions there: {meas_err}")
    for e in entries:
        e["launches"] += meas.get(e["name"], 0)
        e["max_abs_err"] = max(e["max_abs_err"], meas_err.get(e["name"], 0))
    fuzz_phase(device, fuzz_s, clock)
    bad = [e["name"] for e in entries if e["max_abs_err"]]
    if bad:
        raise AssertionError(f"kernels differ from their plain versions: "
                             f"{bad}")
    return {"kernels": entries}


def mszip_folders(total_mb):
    """The bench's MSZIP cabinet of ``total_mb`` MiB: (corpus, cabinet,
    folders as CudaMszipEngine takes them: [(frames without 'CK',
    sizes)])."""
    from libmspack_tpu_torch import create_cab_decompressor

    t0 = time.perf_counter()
    corpus = build_corpus(total_mb * MB)
    blob = build_cab(corpus, "mszip")
    print(f"cabinet: {len(corpus)} bytes in {len(blob)} bytes, built in "
          f"{time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    probe = create_cab_decompressor(engine="native")
    folders = []
    for fol in probe.open(blob).folders:
        folders.append(probe.collect_mszip_frames(fol))
    print(f"host: open + collect_mszip_frames of {len(folders)} folders, "
          f"{sum(len(f) for f, _ in folders)} frames: "
          f"{(time.perf_counter() - t0) * 1e3:.1f} ms")
    return corpus, blob, folders


def folder_cases(folders):
    """Each frame of ``folders`` as a K1 case (history 0 for a folder's
    first frame, 32768 after)."""
    from libmspack_tpu_torch import edge_cases as ec

    return [ec.Case("f", fr, 0 if j == 0 else 32768, None)
            for frs, _ in folders for j, fr in enumerate(frs)]


def chain_layout(folders):
    """K2's lane sizes and hist flags for ``folders``, one chain each."""
    import numpy as np

    sizes = np.array([s for _, fs in folders for s in fs], np.int32)
    flags = np.array([int(j > 0) for frs, _ in folders
                      for j in range(len(frs))], np.int32)
    return sizes, flags


def k1_symbols(tok, cnt, ms):
    """Print a K1 launch's literals and matches: in all, per frame (mean
    and most) and K1's ns per symbol of its longest frame (its serial
    chain); returns the longest frame's symbols."""
    lits, mats = deflate_mix(tok.numpy(), cnt[2].numpy())
    syms = lits + mats
    i = int(syms.argmax())
    print(f"K1 {len(syms)} frames: {int(lits.sum())} literals and "
          f"{int(mats.sum())} matches, per frame {syms.mean():.0f} symbols "
          f"on average, at most {int(syms[i])} ({int(lits[i])} literals, "
          f"{int(mats[i])} matches): {ms * 1e6 / max(1, int(syms[i])):.1f} "
          f"ns per symbol of the longest frame")
    return int(syms[i])


def k2_work(ntok, folders, nbytes):
    """K2's (bytes, chain) for the bound: it reads each trace and writes
    the bytes; its serial chain is the most tokens of one lane (pass 1)
    plus the most lanes of one chain (pass 2). Prints the old chain's
    bound (a whole folder's tokens, one warp per chain) beside it."""
    import numpy as np

    k2_bytes = 8 * int(ntok.sum()) + 16 * len(ntok) + nbytes
    l0 = np.concatenate([[0], np.cumsum([len(f) for f, _ in folders])])
    chain = int(ntok.max()) + max(len(f) for f, _ in folders)
    whole = max(int(ntok[a:b].sum()) for a, b in zip(l0[:-1], l0[1:]))
    print(f"K2 bound {bound(k2_bytes, chain)} (chain {chain}: a lane's "
          f"tokens + a chain's lanes); one-warp-per-chain bound "
          f"{bound(k2_bytes, whole)} (chain {whole})")
    return k2_bytes, chain


def mszip_phases(device, total_mb, edge_frame, reps, clock, bench):
    """Phases 3-6 (MSZIP): K1 and K2 against their plain versions, the
    MSZIP cabinet through the driver and through CudaMszipEngine. Adds
    the cabinet and the driver's warm MB/s to ``bench``."""
    import numpy as np
    import torch

    from libmspack_tpu_torch import create_cab_decompressor
    from libmspack_tpu_torch import edge_cases as ec
    from libmspack_tpu_torch.ops import cuda_inflate as ci
    from libmspack_tpu_torch.ops import cuda_resolve as cr
    from libmspack_tpu_torch.parallel.cuda_pipeline import CudaMszipEngine

    # 3. K1 on the edge-case batch
    cases = ec.edge_case_batch(edge_frame, seed=0, variants=5)
    (tok, litw, cnt), plain, e1, ms, pms = k1_compare(cases, device,
                                                      edge_frame)
    want = {l0: b"".join(cases[i].raw for i in lanes)
            for l0, lanes in ec.folders_of(cases)}
    for res in ((tok, litw, cnt), plain):
        got = ec.resolve_valid(cases, res[0].numpy(), res[1].numpy(),
                               res[2].numpy())
        if got != want:
            raise AssertionError("edge batch: resolved bytes differ")
    flagged = [c.name for i, c in enumerate(cases) if int(cnt[0, i])]
    print(f"K1 edge batch: {len(cases)} frames equal to plain, flagged "
          f"{flagged}; kernel {ms:.3f} ms, plain {pms:.1f} ms")
    clock.lap("3 K1 edge batch")

    # 4. K2 on the same traces (valid lanes; corrupt ones resolve nothing)
    sizes = np.array([len(c.raw) if c.raw is not None else 0
                      for c in cases], np.int32)
    flags = np.array([int(c.chained) for c in cases], np.int32)
    (ob, counts), e2, ms, pms, _ = k2_compare(
        tok, litw, cnt[2].contiguous(), sizes, flags, device)
    off = np.concatenate([[0], np.cumsum(sizes)])
    for i, c in enumerate(cases):
        if c.raw is not None and (
                bytes(ob[off[i]:off[i + 1]].numpy()) != c.raw
                or int(counts[i]) != len(c.raw)):
            raise AssertionError(f"K2 edge batch: lane {c.name}")
    print(f"K2 edge batch: equal to plain; kernel {ms:.3f} ms, plain "
          f"{pms:.1f} ms")
    clock.lap("4 K2 edge batch")

    # the main path's shapes: one folder per K1 launch (the driver), the
    # whole cabinet per K2 launch (phase 6)
    corpus, blob, folders = mszip_folders(total_mb)
    nframes = sum(len(f) for f, _ in folders)
    fcases = folder_cases(folders[:1])
    (tok, litw, cnt), plain, e, k1_ms, k1_plain_ms = k1_compare(
        fcases, device, ci.FRAME_MAX)
    e1 = max(e1, e)
    k1_bytes = trace_bytes([len(c.stream) + 8 for c in fcases], cnt)
    k1_chain = int(cnt[2].max())
    print(f"K1 one folder ({len(fcases)} frames): kernel {k1_ms:.3f} ms, "
          f"plain {k1_plain_ms:.1f} ms, equal; bound "
          f"{bound(k1_bytes, k1_chain)}")
    k1_symbols(tok, cnt, k1_ms)
    allc = folder_cases(folders)
    s, lens = ci.pack_streams([c.stream for c in allc])
    hists = torch.tensor([c.hist for c in allc], dtype=torch.int32)
    sd, ld, hd = (t.to(device) for t in (s, lens, hists))
    if device.type == "cuda":
        for warps in (1, 2, 4, 8):
            _, t_ms = timed(lambda: ci.inflate_phase_a(
                sd, ld, hd, warps=warps), device, reps=3)
            print(f"K1 whole cabinet ({len(allc)} frames), {warps} "
                  f"warps/block: {t_ms:.3f} ms")
    tok, litw, cnt = (t.cpu() for t in ci.inflate_phase_a(sd, ld, hd))
    del sd, ld, hd, plain
    sizes, flags = chain_layout(folders)
    (ob, counts), e, k2_ms, k2_plain_ms, passes = k2_compare(
        tok, litw, cnt[2].contiguous(), sizes, flags, device)
    e2 = max(e2, e)
    if bytes(ob.numpy()) != corpus:
        raise AssertionError("K2 whole cabinet: bytes differ")
    k2_bytes, k2_chain = k2_work(cnt[2].numpy(), folders, len(corpus))
    print(f"K2 whole cabinet ({nframes} frames, {len(folders)} chains): "
          f"kernel {k2_ms:.3f} ms (pass 1, pass 2: {passes}), plain "
          f"{k2_plain_ms:.1f} ms, equal")
    del tok, litw, cnt, ob
    clock.lap("4 K1, K2 at the main path's shapes")

    # 5. the slice through the driver
    ci.LAUNCHES["cuda"] = 0
    runs = []
    for _ in range(reps):
        d = create_cab_decompressor(engine="cuda", device=device)
        t0 = time.perf_counter()
        out = extract_all(d, blob)
        if device.type == "cuda":
            torch.cuda.synchronize()
        runs.append(time.perf_counter() - t0)
        if out != corpus:
            raise AssertionError("engine=cuda: extracted bytes differ")
        eng = d.cuda_engine
        if sum(eng.declines.values()):
            raise AssertionError(f"declines {dict(eng.declines)}")
    k1_launches = ci.LAUNCHES["cuda"] if device.type == "cuda" else \
        ci.LAUNCHES["plain"]
    if k1_launches < 1:
        raise AssertionError("K1 never launched on the main path")
    mbs = [len(corpus) / t / 1e6 for t in runs]
    print(f"engine=cuda: {nframes} frames, cold {mbs[0]:.1f} MB/s, warm "
          f"best {max(mbs[1:]):.1f} MB/s, K1 launches {k1_launches}")
    print("engine=cuda phases of the last run (ms): " + ", ".join(
        f"{k} {v:.3f}" for k, v in sorted(eng.timings.items())))
    nat = []
    for _ in range(reps):
        d = create_cab_decompressor(engine="native")
        t0 = time.perf_counter()
        if extract_all(d, blob) != corpus:
            raise AssertionError("engine=native: bytes differ")
        nat.append(len(corpus) / (time.perf_counter() - t0) / 1e6)
    print(f"engine=native: cold {nat[0]:.1f} MB/s, warm best "
          f"{max(nat[1:]):.1f} MB/s")
    bench["mszip"] = dict(blob=blob, corpus=corpus, cuda=max(mbs[1:]),
                          native=max(nat[1:]))
    clock.lap("5 MSZIP cabinet through the driver")

    # 6. device phase B over the whole cabinet, and host phase B likewise
    cr.LAUNCHES["cuda"] = cr.LAUNCHES["plain"] = 0
    phase_b = {}
    for pb in ("device", "host"):
        for rep in range(2):
            eng = CudaMszipEngine(device, phase_b=pb)
            with engine_phases():
                t0 = time.perf_counter()
                outs = eng.decode_folders(folders)
                dt = time.perf_counter() - t0
            if outs is None or b"".join(outs) != corpus:
                raise AssertionError(f"phase_b={pb}: bytes differ")
            if sum(eng.declines.values()):
                raise AssertionError(f"phase_b={pb}: declines "
                                     f"{dict(eng.declines)}")
        print(f"CudaMszipEngine(phase_b={pb}), {len(folders)} folders in "
              f"one call: {len(corpus) / dt / 1e6:.1f} MB/s warm; phases "
              "(ms): " + ", ".join(f"{k} {v:.3f}"
                                   for k, v in sorted(eng.timings.items())))
        phase_b[pb] = eng.timings
        if pb == "device":
            k2_launches = cr.LAUNCHES["cuda"] if device.type == "cuda" \
                else cr.LAUNCHES["plain"]
    if k2_launches < 1:
        raise AssertionError("K2 never launched on the main path")
    dev_b = phase_b["device"]["k2_ms"] + phase_b["device"]["bytes_pull_ms"]
    host_b = phase_b["host"]["trace_pull_ms"] + \
        phase_b["host"]["host_resolve_ms"]
    print(f"phase B, {len(folders)} folders: device k2_ms + bytes_pull_ms "
          f"{dev_b:.3f} ms, host trace_pull_ms + host_resolve_ms "
          f"{host_b:.3f} ms")
    clock.lap("6 CudaMszipEngine, four folders")
    return [
        entry("k1_inflate", "inflate.cu",
              "libmspack_tpu/ops/pallas_inflate.py:134", k1_launches, e1,
              k1_ms, k1_plain_ms, k1_bytes, k1_chain),
        entry("k2_resolve", "resolve.cu",
              "libmspack_tpu/ops/pallas_resolve.py:51", k2_launches, e2,
              k2_ms, k2_plain_ms, k2_bytes, k2_chain)]


def stream_compare(name, kernel, plain, inputs, device):
    """A stream kernel (K3, K4) on ``device`` and its plain version on the
    same CPU ``inputs``: ``kernel(*inputs, return_state=True)`` and
    ``plain(*inputs)`` both give (tok, litw, cnt, state). Returns (device
    results on the CPU, max abs token difference, ms, plain ms). Counts
    and state records must be equal."""
    import torch

    want, plain_ms = timed(lambda: plain(*inputs), torch.device("cpu"))
    args = [t.to(device) for t in inputs]
    dev, ms = timed(lambda: kernel(*args, return_state=True), device, reps=3)
    dev = tuple(t.cpu() for t in dev)
    if not torch.equal(dev[2], want[2]):
        raise AssertionError(f"{name} counts differ from the plain version")
    if not torch.equal(dev[3], want[3]):
        raise AssertionError(f"{name} state records differ from the plain "
                             "version")
    err = 0
    for i in range(want[2].shape[1]):
        n = int(want[2][2, i])
        for a, b in ((dev[0], want[0]), (dev[1], want[1])):
            err = max(err, int((a[i, :n].long() - b[i, :n].long())
                               .abs().max()) if n else 0)
    return dev, err, ms, plain_ms


def k3_compare(cases, device):
    """K3 on ``device`` and its plain version on one batch of a single
    (window, DELTA) kind (``stream_compare``)."""
    from libmspack_tpu_torch import lzx_edge_cases as le
    from libmspack_tpu_torch.ops import cuda_lzx as cl

    wb, delta = cases[0].window_bits, cases[0].delta
    inputs = le.inputs(cases)
    kw = dict(is_delta=delta, tcap=max(1, int(inputs[2].max())))
    return stream_compare(
        "K3", lambda *a, **k: cl.lzx_phase_a(*a, wb, **kw, **k),
        lambda *a: cl.lzx_phase_a_plain(*a, wb, **kw), inputs, device)


def k3_split_compare(cases, device, raws=None):
    """K3's frame split (``frame_sizes``) on ``device`` and in its plain
    version on one window's cases: equal counts, equal tokens up to each
    row's count, the reference codec's bytes (``raws``, else each case's
    ``raw``), every row split. Returns (ms, plain ms)."""
    import torch

    from libmspack_tpu_torch import lzx_edge_cases as le
    from libmspack_tpu_torch.ops import cuda_lzx as cl

    wb, fs = cases[0].window_bits, [c.frame_sizes for c in cases]
    inputs = le.inputs(cases)
    kw = dict(tcap=max(c.out_len for c in cases), frame_sizes=fs)
    want, plain_ms = timed(lambda: cl.lzx_phase_a_plain(*inputs, wb, **kw),
                           torch.device("cpu"))
    args = [t.to(device) for t in inputs]
    dev, ms = timed(lambda: cl.lzx_phase_a(*args, wb, **kw), device, reps=3)
    dev = tuple(t.cpu() for t in dev)
    if not torch.equal(dev[2], want[2]) or \
            (dev[2][6] != cl.SPLIT_DONE).any():
        raise AssertionError("K3 split: counts differ from the plain version")
    for i in range(len(cases)):
        n = int(want[2][2, i])
        if not (torch.equal(dev[0][i, :n], want[0][i, :n])
                and torch.equal(dev[1][i, :n], want[1][i, :n])):
            raise AssertionError("K3 split: tokens differ")
    if le.resolve(cases, *(t.numpy() for t in dev)) != \
            (raws or [c.raw for c in cases]):
        raise AssertionError("K3 split: bytes differ from the reference")
    return ms, plain_ms


def k3_segments(cases, device, seg):
    """K3 in launches of <= seg bytes per lane through the state record
    against one launch: equal bytes and equal final records."""
    import torch

    from libmspack_tpu_torch import lzx_edge_cases as le
    from libmspack_tpu_torch.ops import cuda_lzx as cl

    s, lens, tg, hs = (t.to(device) for t in le.inputs(cases))
    wb = cases[0].window_bits

    def launch(targets, tcap, state):
        return cl.lzx_phase_a(s, lens, targets.to(device), hs, wb, tcap=tcap,
                              state=state, return_state=True)

    one = launch(tg, max(c.out_len for c in cases), None)
    tok, litw, state, launches = le.segmented(
        launch, [c.out_len for c in cases], seg)
    cnt1 = one[2].cpu().numpy()
    got = le.resolve(cases, tok, litw, cnt1)
    want = le.resolve(cases, one[0].cpu().numpy(), one[1].cpu().numpy(),
                      cnt1)
    if got != want or want != [c.raw for c in cases]:
        raise AssertionError("K3 segments: bytes differ from one launch")
    if not torch.equal(state.cpu(), one[3].cpu()):
        raise AssertionError("K3 segments: records differ from one launch")
    return launches


def lzx_phases(device, total_mb, lzx_big, chm_mb, reps, clock, bench):
    """Phases 7-11 (LZX): K3 against its plain version, the LZX cabinet
    through the driver and through CudaLzxEngine, and a CHM through its
    driver. Returns K3's entry of the kernels line; adds the LZX cabinet
    and the driver's warm MB/s to ``bench``."""
    import torch

    from libmspack_tpu_torch import (create_cab_decompressor,
                                     create_chm_decompressor)
    from libmspack_tpu_torch.compress import chm_c
    from libmspack_tpu_torch import lzx_edge_cases as le
    from libmspack_tpu_torch.ops import cuda_lzx as cl
    from libmspack_tpu_torch.parallel.cuda_pipeline import CudaLzxEngine

    def k3_count():
        return cl.LAUNCHES["cuda" if device.type == "cuda" else "plain"]

    # 7. K3 on the LZX edge batch, one launch per (window, DELTA) kind,
    # and in segments through the state record
    cases = le.lzx_edge_batch(seed=0, big=lzx_big)
    e3 = 0
    for (wb, delta), idx in le.groups(cases).items():
        sub = [cases[i] for i in idx]
        (tok, litw, cnt, _), e, ms, pms = k3_compare(sub, device)
        e3 = max(e3, e)
        got = le.resolve(sub, tok.numpy(), litw.numpy(), cnt.numpy())
        if got != [c.raw for c in sub]:
            raise AssertionError(f"K3 edge batch, window 2^{wb}: bytes")
        print(f"K3 edge batch, window 2^{wb}{' DELTA' if delta else ''}: "
              f"{len(sub)} streams ({sum(c.out_len for c in sub)} bytes) "
              f"equal to plain and the reference codec, flagged "
              f"{[c.name for c in sub if c.raw is None]}; kernel "
              f"{ms:.3f} ms, plain {pms:.1f} ms")
    for key, seg in (((16, False), 65536), ((15, False), 32768)):
        sub = [cases[i] for i in le.groups(cases)[key]
               if cases[i].raw is not None]
        n = k3_segments(sub, device, seg)
        print(f"K3 window 2^{key[0]}: {len(sub)} streams in {n} launches of "
              f"{seg} bytes through the state record = one launch")
    split = le.lzx_split_batch(seed=0) + [le.lzx_split_many()]
    for wb in sorted({c.window_bits for c in split}):
        sub = [c for c in split if c.window_bits == wb]
        ms, pms = k3_split_compare(sub, device)
        print(f"K3 split, window 2^{wb}: {len(sub)} streams a warp per "
              f"frame equal to plain and the reference codec; kernel "
              f"{ms:.3f} ms, plain {pms:.1f} ms")
    clock.lap("7 K3 edge batch")

    # 8. the CAB driver's shape: one whole bench folder per launch
    t0 = time.perf_counter()
    corpus = build_corpus(total_mb * MB)
    blob, folders = bench_folders(corpus, "lzx")
    print(f"LZX cabinet: {len(corpus)} bytes in {len(blob)} bytes, built "
          f"in {time.perf_counter() - t0:.2f} s")
    (tok, litw, cnt, _), e, k3_ms, k3_plain_ms = k3_compare(folders[:1],
                                                            device)
    e3 = max(e3, e)
    if le.resolve(folders[:1], tok.numpy(), litw.numpy(),
                  cnt.numpy()) != [corpus[:folders[0].out_len]]:
        raise AssertionError("K3 whole folder: bytes differ")
    k3_bytes = trace_bytes([len(folders[0].stream) + 12], cnt,
                           cl.STATE_BYTES)
    k3_chain = int(cnt[2].max())
    print(f"K3 one whole {folders[0].out_len}-byte folder "
          f"({len(folders[0].stream)} bytes in, {k3_chain} tokens): kernel "
          f"{k3_ms:.3f} ms, {k3_ms * 1e6 / k3_chain:.1f} ns per token, "
          f"plain {k3_plain_ms:.1f} ms, equal; bound "
          f"{bound(k3_bytes, k3_chain)}")
    lit, mlen = trace_mix(tok[0, :k3_chain].numpy())
    print(f"K3 folder: {lit} literals and {len(mlen)} matches, "
          f"{k3_ms * 1e6 / (lit + len(mlen)):.1f} ns per literal or match")
    del tok, litw, cnt
    # the same folder a warp per frame, as the CAB driver and the planner
    # launch it (its CFDATA sizes), against the plain version's split
    split_ms, split_plain_ms = k3_split_compare(
        folders[:1], device, [corpus[:folders[0].out_len]])
    print(f"K3 split, the same folder ({len(folders[0].frame_sizes)} frame "
          f"lanes): kernel {split_ms:.3f} ms against {k3_ms:.3f} ms on one "
          f"warp, plain {split_plain_ms:.1f} ms, equal")
    args = [t.to(device) for t in le.inputs(folders)]
    (tok, litw, cnt), ms = timed(lambda: cl.lzx_phase_a(
        *args, folders[0].window_bits,
        tcap=max(f.out_len for f in folders)), device)
    if (cnt[0] != 0).any():
        raise AssertionError("K3 whole folders: flagged")
    print(f"K3 {len(folders)} whole folders, one launch: kernel {ms:.3f} ms, "
          f"{len(corpus) / ms / 1e3:.1f} MB/s")
    del tok, litw, cnt, args
    clock.lap("8 K3 at the main path's shapes")

    # 9. the LZX cabinet through the driver (counts read around it), cold
    # and warm only: K3 makes each extraction some 5 s and its device
    # times repeat to 0.1%
    cl.LAUNCHES["cuda"] = cl.LAUNCHES["plain"] = 0
    runs = []
    for _ in range(min(reps, 2)):
        d = create_cab_decompressor(engine="cuda", device=device)
        t0 = time.perf_counter()
        out = extract_all(d, blob)
        if device.type == "cuda":
            torch.cuda.synchronize()
        runs.append(time.perf_counter() - t0)
        if out != corpus:
            raise AssertionError("engine=cuda LZX: extracted bytes differ")
        eng = d.cuda_lzx_engine
        if sum(eng.declines.values()):
            raise AssertionError(f"declines {dict(eng.declines)}")
        if eng.timings.get("k3_split_streams") != len(folders) or \
                eng.timings.get("k3_split_fallbacks"):
            raise AssertionError(
                f"{len(folders)} LZX folders, split "
                f"{eng.timings.get('k3_split_streams')}, fallbacks "
                f"{eng.timings.get('k3_split_fallbacks')}")
    k3_launches = k3_count()
    if k3_launches < 1:
        raise AssertionError("K3 never launched on the CAB LZX path")
    mbs = [len(corpus) / t / 1e6 for t in runs]
    print(f"engine=cuda LZX: {len(folders)} folders, cold {mbs[0]:.1f} MB/s,"
          f" warm best {max(mbs[1:]):.1f} MB/s, K3 launches {k3_launches}")
    print("engine=cuda LZX phases of the last run (ms): " + ", ".join(
        f"{k} {v:.3f}" for k, v in sorted(eng.timings.items())))
    nat = []
    for _ in range(min(reps, 2)):
        d = create_cab_decompressor(engine="native")
        t0 = time.perf_counter()
        if extract_all(d, blob) != corpus:
            raise AssertionError("engine=native LZX: bytes differ")
        nat.append(len(corpus) / (time.perf_counter() - t0) / 1e6)
    print(f"engine=native LZX: cold {nat[0]:.1f} MB/s, warm "
          f"best {max(nat[1:]):.1f} MB/s")
    bench["lzx"] = dict(blob=blob, corpus=corpus, cuda=max(mbs[1:]),
                        native=max(nat[1:]))
    clock.lap("9 LZX cabinet through the driver")

    # 10. CudaLzxEngine on all the folders in one call
    for _ in range(2):
        eng = CudaLzxEngine(device)
        t0 = time.perf_counter()
        outs = eng.decode_streams([f.stream for f in folders],
                                  [f.out_len for f in folders],
                                  folders[0].window_bits)
        dt = time.perf_counter() - t0
        if outs is None or b"".join(outs) != corpus or \
                sum(eng.declines.values()):
            raise AssertionError(f"CudaLzxEngine: bytes or declines "
                                 f"{dict(eng.declines)}")
    print(f"CudaLzxEngine, {len(folders)} folders in one call: "
          f"{len(corpus) / dt / 1e6:.1f} MB/s warm; phases (ms): "
          + ", ".join(f"{k} {v:.3f}" for k, v in sorted(eng.timings.items())))
    clock.lap("10 CudaLzxEngine, all folders")

    # 11. a CHM through its driver: one K3 lane per reset-interval chunk
    t0 = time.perf_counter()
    files = [(f"/topic{i}.html", corpus[i * MB:(i + 1) * MB])
             for i in range(chm_mb)]
    content = dict(files)
    chm = chm_c.write_chm(files)
    plan = create_chm_decompressor(engine="native")
    chunks, csizes, cwb = plan.sec1_chunk_plan(plan.open(chm))
    total = chm_mb * MB
    print(f"CHM: {total} bytes in {len(chm)} bytes, {len(chunks)} "
          f"reset chunks, window 2^{cwb}, built in "
          f"{time.perf_counter() - t0:.2f} s")
    # the CHM driver's launch: all the chunks, one lane each
    ccases = [le.LzxCase("chunk", c, n, cwb) for c, n in zip(chunks, csizes)]
    (tok, litw, cnt, _), e, ms, pms = k3_compare(ccases, device)
    e3 = max(e3, e)
    got = le.resolve(ccases, tok.numpy(), litw.numpy(), cnt.numpy())
    if None in got or b"".join(got) != corpus[:total]:
        raise AssertionError("K3 CHM chunks: bytes differ")
    print(f"K3 CHM chunks ({len(chunks)} lanes): kernel {ms:.3f} ms, plain "
          f"{pms:.1f} ms, equal")
    del tok, litw, cnt

    cl.LAUNCHES["cuda"] = cl.LAUNCHES["plain"] = 0
    runs = []
    for _ in range(reps):
        c = create_chm_decompressor(engine="cuda", device=device)
        t0 = time.perf_counter()
        out = extract_chm(c, chm)
        runs.append(time.perf_counter() - t0)
        eng = c.cuda_engine
        if out != content:
            raise AssertionError("engine=cuda CHM: bytes differ")
        if sum(eng.declines.values()) or eng.lanes < len(chunks):
            raise AssertionError(f"CHM: declines {dict(eng.declines)}, "
                                 f"lanes {eng.lanes}")
    chm_launches = k3_count()
    if chm_launches < 1:
        raise AssertionError("K3 never launched on the CHM path")
    mbs = [total / t / 1e6 for t in runs]
    print(f"engine=cuda CHM: {eng.lanes} lanes, cold {mbs[0]:.1f} MB/s, "
          f"warm best {max(mbs[1:]):.1f} MB/s, K3 launches {chm_launches}")
    print("engine=cuda CHM phases of the last run (ms): " + ", ".join(
        f"{k} {v:.3f}" for k, v in sorted(eng.timings.items())))
    nat = []
    for _ in range(reps):
        c = create_chm_decompressor(engine="native")
        t0 = time.perf_counter()
        if extract_chm(c, chm) != content:
            raise AssertionError("engine=native CHM: bytes differ")
        nat.append(total / (time.perf_counter() - t0) / 1e6)
    print(f"engine=native CHM: cold {nat[0]:.1f} MB/s, warm "
          f"best {max(nat[1:]):.1f} MB/s")
    bench["chm"] = dict(blob=chm, want=content)
    clock.lap("11 CHM through the driver")
    k3 = entry("k3_lzx", "lzx.cu", "libmspack_tpu/ops/pallas_lzx.py:99",
               k3_launches, e3, k3_ms, k3_plain_ms, k3_bytes, k3_chain)
    k3["split_ms"] = split_ms  # the same folder a warp per frame
    return k3


def k4_compare(cases, device):
    """K4 on ``device`` and its plain version on one batch of one window
    (``stream_compare``)."""
    from libmspack_tpu_torch import qtm_edge_cases as qe
    from libmspack_tpu_torch.ops import cuda_qtm as cq

    wb = cases[0].window_bits
    inputs = qe.inputs(cases)
    tcap = max(1, int(inputs[2].max()))
    return stream_compare(
        "K4", lambda *a, **k: cq.qtm_phase_a(*a, wb, tcap=tcap, **k),
        lambda *a: cq.qtm_phase_a_plain(*a, wb, tcap=tcap), inputs, device)


def k4_segments(cases, device, seg):
    """K4 in launches of <= seg bytes per lane through the state record
    against one launch: equal tokens and equal final records."""
    import numpy as np
    import torch

    from libmspack_tpu_torch import lzx_edge_cases as le
    from libmspack_tpu_torch import qtm_edge_cases as qe
    from libmspack_tpu_torch.ops import cuda_qtm as cq

    s, lens, tg = (t.to(device) for t in qe.inputs(cases))
    wb = cases[0].window_bits

    def launch(targets, tcap, state):
        return cq.qtm_phase_a(s, lens, targets.to(device), wb, tcap=tcap,
                              state=state, return_state=True)

    one = launch(tg, max(c.out_len for c in cases), None)
    tok, litw, state, launches = le.segmented(
        launch, [c.out_len for c in cases], seg)
    cnt1 = one[2].cpu().numpy()
    for i in range(len(cases)):
        n = int(cnt1[2, i])
        if not (np.array_equal(tok[i, :n], one[0][i, :n].cpu().numpy())
                and np.array_equal(litw[i, :n],
                                   one[1][i, :n].cpu().numpy())):
            raise AssertionError("K4 segments: tokens differ from one "
                                 "launch")
    if qe.resolve(cases, tok, litw, cnt1) != [c.raw for c in cases]:
        raise AssertionError("K4 segments: bytes differ")
    if not torch.equal(state.cpu(), one[3].cpu()):
        raise AssertionError("K4 segments: records differ from one launch")
    return launches


def qtm_phases(device, total_mb, edge_big, reps, clock, bench):
    """Phases 12-14 (Quantum): K4 against its plain version, the Quantum
    cabinet through the driver and through CudaQtmEngine. Returns K4's
    entry of the kernels line; adds the cabinet and the driver's warm
    MB/s to ``bench``."""
    import torch

    from libmspack_tpu_torch import create_cab_decompressor
    from libmspack_tpu_torch import qtm_edge_cases as qe
    from libmspack_tpu_torch.ops import cuda_qtm as cq
    from libmspack_tpu_torch.parallel.cuda_pipeline import CudaQtmEngine

    def k4_count():
        return cq.LAUNCHES["cuda" if device.type == "cuda" else "plain"]

    # 12. K4 on the Quantum edge batch, one launch per window, and in
    # segments through the state record
    cases = qe.qtm_edge_batch(seed=0, big=edge_big)
    e4 = 0
    for wb, idx in qe.groups(cases).items():
        sub = [cases[i] for i in idx]
        (tok, litw, cnt, _), e, ms, pms = k4_compare(sub, device)
        e4 = max(e4, e)
        got = qe.resolve(sub, tok.numpy(), litw.numpy(), cnt.numpy())
        if got != [c.raw for c in sub]:
            raise AssertionError(f"K4 edge batch, window 2^{wb}: bytes")
        print(f"K4 edge batch, window 2^{wb}: {len(sub)} streams "
              f"({sum(c.out_len for c in sub)} bytes) equal to plain and the "
              f"reference codec, flagged "
              f"{[c.name for c in sub if c.raw is None]}; kernel {ms:.3f} ms, "
              f"plain {pms:.1f} ms")
    for wb in (16, 10):
        sub = [cases[i] for i in qe.groups(cases)[wb]
               if cases[i].raw is not None]
        n = k4_segments(sub, device, 32768)
        print(f"K4 window 2^{wb}: {len(sub)} streams in {n} launches of "
              f"32768 bytes through the state record = one launch")
    clock.lap("12 K4 edge batch")

    # 13. the CAB driver's shape: one whole bench folder per launch
    t0 = time.perf_counter()
    corpus = build_corpus(total_mb * MB)
    blob, folders = bench_folders(corpus, "quantum")
    print(f"Quantum cabinet: {len(corpus)} bytes in {len(blob)} bytes, "
          f"built in {time.perf_counter() - t0:.2f} s")
    (tok, litw, cnt, _), e, k4_ms, k4_plain_ms = k4_compare(folders[:1],
                                                            device)
    e4 = max(e4, e)
    if qe.resolve(folders[:1], tok.numpy(), litw.numpy(),
                  cnt.numpy()) != [folders[0].raw]:
        raise AssertionError("K4 whole folder: bytes differ")
    k4_bytes = trace_bytes([len(folders[0].stream) + 8], cnt, cq.STATE_BYTES)
    k4_chain = int(cnt[2].max())
    print(f"K4 one whole {folders[0].out_len}-byte folder "
          f"({len(folders[0].stream)} bytes in, {k4_chain} tokens): kernel "
          f"{k4_ms:.3f} ms, {k4_ms * 1e6 / k4_chain:.1f} ns per token, "
          f"plain {k4_plain_ms:.1f} ms, equal; bound "
          f"{bound(k4_bytes, k4_chain)}")
    # a literal is two model symbols (selector, literal); a match of 3 or
    # 4 bytes two (selector, position slot), a longer one three (+ length)
    lit, mlen = trace_mix(tok[0, :k4_chain].numpy())
    nsym = 2 * lit + 2 * len(mlen) + int((mlen > 4).sum())
    print(f"K4 folder: {lit} literals and {len(mlen)} matches, {nsym} "
          f"model symbols, {k4_ms * 1e6 / nsym:.1f} ns per symbol")
    del tok, litw, cnt
    args = [t.to(device) for t in qe.inputs(folders)]
    (tok, litw, cnt), ms = timed(lambda: cq.qtm_phase_a(
        *args, folders[0].window_bits,
        tcap=max(f.out_len for f in folders)), device)
    if (cnt[0] != 0).any():
        raise AssertionError("K4 whole folders: flagged")
    print(f"K4 {len(folders)} whole folders, one launch: kernel {ms:.3f} ms, "
          f"{len(corpus) / ms / 1e3:.1f} MB/s")
    del tok, litw, cnt, args
    clock.lap("13 K4 at the main path's shapes")

    # 14. the Quantum cabinet through the driver (counts read around it),
    # cold and warm only: K4 makes each extraction some 9 s
    cq.LAUNCHES["cuda"] = cq.LAUNCHES["plain"] = 0
    runs = []
    for _ in range(min(reps, 2)):
        d = create_cab_decompressor(engine="cuda", device=device)
        t0 = time.perf_counter()
        out = extract_all(d, blob)
        if device.type == "cuda":
            torch.cuda.synchronize()
        runs.append(time.perf_counter() - t0)
        if out != corpus:
            raise AssertionError("engine=cuda Quantum: bytes differ")
        eng = d.cuda_qtm_engine
        if sum(eng.declines.values()) or eng.n_decoded != len(folders):
            raise AssertionError(f"declines {dict(eng.declines)}, decoded "
                                 f"{eng.n_decoded}")
    k4_launches = k4_count()
    if k4_launches < 1:
        raise AssertionError("K4 never launched on the CAB Quantum path")
    mbs = [len(corpus) / t / 1e6 for t in runs]
    print(f"engine=cuda Quantum: {len(folders)} folders, cold {mbs[0]:.1f} "
          f"MB/s, warm best {max(mbs[1:]):.1f} MB/s, K4 launches "
          f"{k4_launches}")
    print("engine=cuda Quantum phases of the last run (ms): " + ", ".join(
        f"{k} {v:.3f}" for k, v in sorted(eng.timings.items())))
    nat = []
    for _ in range(min(reps, 2)):
        d = create_cab_decompressor(engine="native")
        t0 = time.perf_counter()
        if extract_all(d, blob) != corpus:
            raise AssertionError("engine=native Quantum: bytes differ")
        nat.append(len(corpus) / (time.perf_counter() - t0) / 1e6)
    print(f"engine=native Quantum: cold {nat[0]:.1f} MB/s, warm best "
          f"{max(nat[1:]):.1f} MB/s")
    bench["quantum"] = dict(blob=blob, corpus=corpus, cuda=max(mbs[1:]),
                            native=max(nat[1:]))
    for _ in range(2):
        eng = CudaQtmEngine(device)
        t0 = time.perf_counter()
        outs = eng.decode_streams([f.stream for f in folders],
                                  [f.out_len for f in folders],
                                  folders[0].window_bits)
        dt = time.perf_counter() - t0
        if outs is None or b"".join(outs) != corpus or \
                sum(eng.declines.values()):
            raise AssertionError(f"CudaQtmEngine: bytes or declines "
                                 f"{dict(eng.declines)}")
    print(f"CudaQtmEngine, {len(folders)} folders in one call: "
          f"{len(corpus) / dt / 1e6:.1f} MB/s warm; phases (ms): "
          + ", ".join(f"{k} {v:.3f}" for k, v in sorted(eng.timings.items())))
    clock.lap("14 Quantum cabinet through the driver and the engine")
    return entry("k4_qtm", "qtm.cu", "libmspack_tpu/ops/pallas_qtm.py:125",
                 k4_launches, e4, k4_ms, k4_plain_ms, k4_bytes, k4_chain)


def oab_inputs(oab_mb, big_mb, big_block):
    """The OAB phase's three files: ``(name, file, bytes it decodes to,
    base or None)``. A full download of ``oab_mb`` MiB of the bench corpus
    in oab_c's 64 KiB blocks (window 2^17: one K3 lane a block); an
    incremental patch of as much against a base of as much, the target
    being the base with 16 bytes changed in every 4 KiB (64 KiB blocks,
    each with 64 KiB of reference data: window 2^17); a full download of
    ``big_mb`` MiB in ``big_block`` blocks (4 MiB: window 2^22, which the
    JAX ``tpu`` engine declines to the host)."""
    import numpy as np

    t0 = time.perf_counter()
    base = build_corpus(oab_mb * MB)
    rng = np.random.RandomState(11)
    target = np.frombuffer(base, np.uint8).copy()
    at = np.arange(0, len(base) - 16, 4096) + rng.randint(0, 4080,
                                                          len(base) // 4096)
    for k in range(16):
        target[at + k] = rng.randint(0, 256, len(at))
    target = target.tobytes()
    big = build_corpus(big_mb * MB)
    files = [("full 64 KiB blocks", build_oab(base), base, None),
             ("patch 64 KiB blocks", build_oab_patch(target, base), target,
              base),
             (f"full {big_block >> 10} KiB blocks",
              build_oab(big, big_block), big, None)]
    print(f"OAB inputs built in {time.perf_counter() - t0:.2f} s: " + "; ".join(
        f"{n}: {len(w)} bytes in {len(f)}" for n, f, w, _ in files))
    return files


def oab_phases(device, oab_mb, big_mb, big_block, reps, clock, bench):
    """Phase 16 (OAB on K3): K3 against its plain version at each file's
    launch (all its blocks of one window, one lane each, DELTA with the
    reference data's budget), then each file through
    create_oab_decompressor(engine="cuda", strict=True) cold and warm,
    beside engine="native": bytes equal, K3 launched, every LZX block of a
    window in one engine call, no decline (strict mode raises on one); the
    engine's phase times and the CRC op's beside host CRC-32. Returns (K3
    launches, largest difference from the plain version); keeps the full
    download in 64 KiB blocks in ``bench``."""
    import torch

    from libmspack_tpu_torch import create_oab_decompressor
    from libmspack_tpu_torch import lzx_edge_cases as le
    from libmspack_tpu_torch.ops import crc32
    from libmspack_tpu_torch.ops import cuda_lzx as cl

    def k3_count():
        return cl.LAUNCHES["cuda" if device.type == "cuda" else "plain"]

    files = oab_inputs(oab_mb, big_mb, big_block)
    bench["oab"] = dict(blob=files[0][1], want=files[0][2])
    clock.lap("16 OAB inputs")
    err, launches = 0, 0
    for name, blob, want, base in files:
        groups = oab_lanes(blob, want, base)
        for wb, cases in groups.items():
            (tok, litw, cnt, _), e, ms, pms = k3_compare(cases, device)
            err = max(err, e)
            got = le.resolve(cases, tok.numpy(), litw.numpy(), cnt.numpy())
            if got != [c.raw for c in cases]:
                raise AssertionError(f"K3 OAB {name}: bytes differ")
            print(f"K3 OAB {name}, window 2^{wb}: {len(cases)} lanes, "
                  f"{int(cnt[2].sum())} tokens, kernel {ms:.3f} ms "
                  f"({sum(c.out_len for c in cases) / ms / 1e3:.1f} MB/s), "
                  f"plain {pms:.1f} ms, equal", flush=True)
            del tok, litw, cnt

        def decode(d):
            if base is None:
                return d.decompress_bytes(blob)
            return d.decompress_incremental_bytes(blob, base)

        cl.LAUNCHES["cuda"] = cl.LAUNCHES["plain"] = 0
        runs, uploads = [], []
        for _ in range(reps):
            d = create_oab_decompressor(engine="cuda", device=device,
                                        strict=True)
            with engine_phases():
                t0 = time.perf_counter()
                out = decode(d)
                runs.append(time.perf_counter() - t0)
            uploads.append(d.cuda_engine.timings["upload_ms"])
            if out != want:
                raise AssertionError(f"OAB {name}: bytes differ")
            nblocks = sum(len(c) for c in groups.values())
            if d.stats["engine calls"] != len(groups) or \
                    d.stats["device blocks"] != nblocks or \
                    sum(d.cuda_engine.declines.values()):
                raise AssertionError(f"OAB {name}: {dict(d.stats)}, "
                                     f"declines {dict(d.cuda_engine.declines)}")
        n = k3_count()
        if n < 1:
            raise AssertionError(f"K3 never launched on the OAB {name} path")
        launches += n
        mbs = [len(want) / t / 1e6 for t in runs]
        print(f"engine=cuda OAB {name}: {nblocks} blocks, {len(groups)} "
              f"engine call(s), {d.cuda_engine.lanes} lanes, cold "
              f"{mbs[0]:.1f} MB/s, warm best {max(mbs[1:]):.1f} MB/s, K3 "
              f"launches {n}; upload_ms of each run "
              + ", ".join(f"{u:.3f}" for u in uploads))
        print(f"engine=cuda OAB {name} phases of the last run (ms): "
              + ", ".join(f"{k} {v:.3f}" for k, v in sorted(
                  {**d.cuda_engine.timings, **d.timings}.items())))
        nat = []
        for _ in range(reps):
            d = create_oab_decompressor(engine="native")
            t0 = time.perf_counter()
            if decode(d) != want:
                raise AssertionError(f"OAB {name} engine=native: bytes")
            nat.append(len(want) / (time.perf_counter() - t0) / 1e6)
        print(f"engine=native OAB {name}: cold {nat[0]:.1f} MB/s, warm best "
              f"{max(nat[1:]):.1f} MB/s")
        # the CRC op on this file's blocks beside host CRC-32
        blocks = [c.raw for cs in groups.values() for c in cs]
        for _ in range(2):
            t = {}
            t0 = time.perf_counter()
            dev = crc32.crc32_blocks(blocks, device, timings=t)
            op_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        host = [crc32.crc32_raw(b) for b in blocks]
        host_ms = (time.perf_counter() - t0) * 1e3
        if dev != host:
            raise AssertionError(f"OAB {name}: the CRC op differs from "
                                 "host CRC-32")
        print(f"CRC OAB {name}: {len(blocks)} blocks, op {op_ms:.3f} ms ("
              + ", ".join(f"{k} {v:.3f}" for k, v in sorted(t.items()))
              + f"), host zlib {host_ms:.3f} ms, equal", flush=True)
        if device.type == "cuda":
            torch.cuda.empty_cache()
        clock.lap(f"16 OAB {name}")
    return launches, err


def szdd_phase(device, nbytes, reps, clock, bench):
    """Phase 17: an SZDD file of ``nbytes`` of the bench corpus from
    ``lzss_c`` through create_szdd_decompressor(engine="cuda") (LZSS as
    device tensor ops) cold and warm, beside engine="native": bytes
    equal."""
    from libmspack_tpu_torch import create_szdd_decompressor
    from libmspack_tpu_torch.compress import lzss_c

    t0 = time.perf_counter()
    data = build_corpus(nbytes)
    blob = lzss_c.szdd_compress(data)
    bench["szdd"] = dict(blob=blob, want=data)
    print(f"SZDD: {len(data)} bytes in {len(blob)}, built in "
          f"{time.perf_counter() - t0:.2f} s")
    for engine in ("cuda", "native"):
        mbs = []
        for _ in range(reps):
            kw = {"device": device} if engine == "cuda" else {}
            d = create_szdd_decompressor(engine=engine, **kw)
            t0 = time.perf_counter()
            if d.decompress_bytes(blob) != data:
                raise AssertionError(f"SZDD engine={engine}: bytes differ")
            mbs.append(len(data) / (time.perf_counter() - t0) / 1e6)
        print(f"engine={engine} SZDD: cold {mbs[0]:.1f} MB/s, warm best "
              f"{max(mbs[1:]):.1f} MB/s")
    clock.lap("17 SZDD")


# corpus A's four folders a cabinet: (cab_c compression, window bits,
# bytes); LZX at 2^21 is makecab's LZX:21, the usual setting of Windows
# update and driver cabinets
CORPUS_A = (("mszip", 16, MB), ("lzx", 21, MB), ("quantum", 16, MB // 2),
            ("none", 16, MB // 4))


def build_corpus_a(directory, n_cabs):
    """Corpus A: ``n_cabs`` cabinets written into ``directory``, each with
    the four folders of ``CORPUS_A`` holding two files apiece, distinct
    slices of ``build_corpus``. Returns (paths, each cabinet's files as
    ``{name: bytes}``). The encoders run on threads."""
    import os
    from concurrent.futures import ThreadPoolExecutor

    from libmspack_tpu_torch.compress import cab_c

    per = sum(n for _, _, n in CORPUS_A)
    corpus = build_corpus(n_cabs * per)

    def one(i):
        base, folders, files = i * per, [], {}
        for comp, wb, n in CORPUS_A:
            cut = n * 3 // 5 + 17
            pair = [(f"a{i:03d}_{comp}_{k}.bin", part) for k, part in
                    enumerate((corpus[base:base + cut],
                               corpus[base + cut:base + n]))]
            folders.append(cab_c.FolderSpec(pair, comp, wb))
            files.update(pair)
            base += n
        path = os.path.join(directory, f"a{i:03d}.cab")
        with open(path, "wb") as fh:
            fh.write(cab_c.write_cab(folders=folders))
        return path, files

    with ThreadPoolExecutor(8) as pool:
        done = list(pool.map(one, range(n_cabs)))
    return [p for p, _ in done], [f for _, f in done]


def bench_files(codec, corpus):
    """The files of ``build_cab(corpus, codec)``."""
    fsz = FOLDER_MB[codec] << 20
    return {f"f{i}.bin": corpus[i:i + fsz]
            for i in range(0, len(corpus), fsz)}


class Launches:
    """K1-K4's launch counts on the paths it is handed: each path runs
    with the counts set to 0 just before it and read just after."""

    def __init__(self, device):
        from libmspack_tpu_torch.ops import (cuda_inflate, cuda_lzx, cuda_qtm,
                                             cuda_resolve)
        self.key = "cuda" if device.type == "cuda" else "plain"
        self.mods = {"k1_inflate": cuda_inflate, "k2_resolve": cuda_resolve,
                     "k3_lzx": cuda_lzx, "k4_qtm": cuda_qtm}
        self.total = dict.fromkeys(self.mods, 0)

    def run(self, fn):
        """``fn()``; returns (its result, the launches it made)."""
        for m in self.mods.values():
            m.LAUNCHES[self.key] = 0
        out = fn()
        got = {n: m.LAUNCHES[self.key] for n, m in self.mods.items()}
        for n, k in got.items():
            self.total[n] += k
        return out, got


def planner_run(srcs, engine, device, strict=None):
    """One ``extract_corpus`` as its three steps, so that the plan's
    counters can be read: (plan, files, seconds)."""
    import torch

    from libmspack_tpu_torch.parallel import planner

    t0 = time.perf_counter()
    plan = planner.plan_archives(srcs)
    files = planner.archive_files(plan, planner.execute(
        plan, engine=engine, device=device, strict=strict))
    if device.type == "cuda":
        torch.cuda.synchronize()
    return plan, files, time.perf_counter() - t0


def plan_report(name, plan, launches):
    """Print a cuda planner run's engine calls, collect routes, lanes per
    launch, host times and each engine's timings."""
    per = {"mszip": "k1_inflate", "lzx": "k3_lzx", "quantum": "k4_qtm"}
    lanes = {c: (e.lanes if hasattr(e, "lanes") else
                 sum(len(j.frames) for j in plan.jobs if j.comp_name == c))
             for c, e in plan.engines.items()}
    print(f"{name}: engine calls {dict(plan.calls)}, folders collected "
          f"{dict(plan.collect_routes)}, launches "
          f"{ {c: launches[per[c]] for c in plan.engines} }, lanes "
          f"{lanes}; host ms: " + ", ".join(
              f"{k} {v:.1f}" for k, v in sorted(plan.timings.items())))
    for c, e in sorted(plan.engines.items()):
        print(f"{name}: {c} engine timings (ms): " + ", ".join(
            f"{k} {v:.3f}" for k, v in sorted(e.timings.items()))
            + f"; declines {dict(e.declines)}")


def corpus_phases(device, paths, want, bench, reps, counts, clock):
    """Phases 18-19: the corpus planner. Corpus A (``paths``, the files
    ``want``) through extract_corpus(engine="cuda", strict=True), cold and
    warm, beside engine="native" and the per-cabinet driver; corpus B (the
    bench cabinets of ``bench``) in one extract_corpus, beside the driver's
    MB/s of phases 5, 9 and 14; then CudaMszipEngine's host against device
    phase B on the plan's MSZIP jobs. Bytes must equal the inputs; each of
    K1, K3 and K4 must launch once a codec group."""
    import os

    import torch

    from libmspack_tpu_torch import create_cab_decompressor
    from libmspack_tpu_torch.parallel.cuda_pipeline import CudaMszipEngine
    from libmspack_tpu_torch.system import BytesSink

    total = sum(len(b) for w in want for b in w.values())
    print(f"corpus A: {len(paths)} cabinets, {total} bytes out of "
          f"{sum(os.path.getsize(p) for p in paths)} bytes")
    # 18. corpus A
    mbs = []
    for rep in range(reps):
        (plan, files, dt), got = counts.run(
            lambda: planner_run(paths, "cuda", device, strict=True))
        if files != want:
            raise AssertionError("planner engine=cuda, corpus A: bytes")
        once = {"k1_inflate": 1, "k3_lzx": 1, "k4_qtm": 1}
        if {k: got[k] for k in once} != once:
            raise AssertionError(f"corpus A: launches {got}, want {once}")
        mbs.append(total / dt / 1e6)
    plan_report("corpus A planner engine=cuda (last run)", plan, got)
    print(f"corpus A planner engine=cuda: cold {mbs[0]:.1f} MB/s, warm "
          f"best {max(mbs[1:]):.1f} MB/s")
    nat = []
    for rep in range(reps):
        _, files, dt = planner_run(paths, "native", device)
        if files != want:
            raise AssertionError("planner engine=native, corpus A: bytes")
        nat.append(total / dt / 1e6)
    print(f"corpus A planner engine=native: cold {nat[0]:.1f} MB/s, warm "
          f"best {max(nat[1:]):.1f} MB/s")

    def per_cabinet():
        t0 = time.perf_counter()
        for path, w in zip(paths, want):
            d = create_cab_decompressor(engine="cuda", device=device,
                                        strict=True)
            for f in d.open(path).files:
                sink = BytesSink()
                d.extract(f, sink)
                if sink.getvalue() != w[f.filename]:
                    raise AssertionError(f"driver, {path}: {f.filename}")
        if device.type == "cuda":
            torch.cuda.synchronize()
        return time.perf_counter() - t0

    drv = []
    for _ in range(2):
        dt, got = counts.run(per_cabinet)
        drv.append(total / dt / 1e6)
    print(f"corpus A per-cabinet CabDecompressor(engine=cuda): cold "
          f"{drv[0]:.1f} MB/s, warm {drv[1]:.1f} MB/s, launches of the "
          f"warm run {got}")
    clock.lap("18 planner, corpus A")

    # 19. corpus B: the bench cabinets in one extract_corpus
    codecs = ("mszip", "lzx", "quantum")
    srcs = [bench[c]["blob"] for c in codecs]
    wantb = [bench_files(c, bench[c]["corpus"]) for c in codecs]
    totb = sum(len(bench[c]["corpus"]) for c in codecs)
    mbs = []
    for _ in range(2):
        (plan, files, dt), got = counts.run(
            lambda: planner_run(srcs, "cuda", device, strict=True))
        if files != wantb:
            raise AssertionError("planner engine=cuda, corpus B: bytes")
        mbs.append(totb / dt / 1e6)
    plan_report("corpus B planner engine=cuda (warm run)", plan, got)
    nat = []
    for _ in range(2):
        _, files, dt = planner_run(srcs, "native", device)
        if files != wantb:
            raise AssertionError("planner engine=native, corpus B: bytes")
        nat.append(totb / dt / 1e6)
    # the per-cabinet driver's MB/s over the three cabinets, from its
    # warm runs of phases 5, 9 and 14
    drv = {k: totb / sum(len(bench[c]["corpus"]) / bench[c][k]
                         for c in codecs) for k in ("cuda", "native")}
    print(f"corpus B ({totb} bytes, 3 cabinets) planner engine=cuda: cold "
          f"{mbs[0]:.1f} MB/s, warm {mbs[1]:.1f}; engine=native cold "
          f"{nat[0]:.1f}, warm {nat[1]:.1f}; per-cabinet driver (phases "
          f"5, 9, 14, warm) engine=cuda {drv['cuda']:.1f}, engine=native "
          f"{drv['native']:.1f}; by codec, driver cuda " + ", ".join(
              f"{c} {bench[c]['cuda']:.1f}" for c in codecs))
    folders = [(j.frames, j.sizes) for j in plan.jobs
               if j.comp_name == "mszip"]
    want_m = bench["mszip"]["corpus"]
    for pb in ("host", "device", "device", "host"):
        eng = CudaMszipEngine(device, phase_b=pb)
        with engine_phases():
            t0 = time.perf_counter()
            outs, got = counts.run(lambda: eng.decode_folders(folders))
            dt = time.perf_counter() - t0
        if outs is None or b"".join(outs) != want_m or \
                sum(eng.declines.values()):
            raise AssertionError(f"corpus B phase_b={pb}: bytes or "
                                 f"declines {dict(eng.declines)}")
        t = eng.timings
        b_ms = t["k2_ms"] + t["bytes_pull_ms"] if pb == "device" else \
            t["trace_pull_ms"] + t["host_resolve_ms"]
        print(f"corpus B MSZIP jobs ({len(folders)} folders) "
              f"CudaMszipEngine(phase_b={pb}): {len(want_m) / dt / 1e6:.1f} "
              f"MB/s, phase B {b_ms:.3f} ms, total_ms "
              f"{t['total_ms']:.3f}, K1/K2 launches "
              f"{got['k1_inflate']}/{got['k2_resolve']}")
    clock.lap("19 planner, corpus B")


def calibration_phase(device, sizes_mb, clock):
    """Phase 20: the port's calibrate_engines into a temporary file (its
    JSON printed), then choose_engine reading it through
    MSPACK_CALIBRATION."""
    import json
    import os
    import tempfile

    import torch

    from libmspack_tpu_torch import utils
    from libmspack_tpu_torch.tools import calibrate_engines

    with tempfile.TemporaryDirectory() as td:
        out = os.path.join(td, "calibration.json")
        calibrate_engines.main(["--out", out, "--sizes"]
                               + [str(x) for x in sizes_mb])
        with open(out) as fh:
            cal = json.load(fh)
        old = os.environ.get("MSPACK_CALIBRATION")
        os.environ["MSPACK_CALIBRATION"] = out
        try:
            if utils.engine_calibration() != cal:
                raise AssertionError("engine_calibration did not read "
                                     "MSPACK_CALIBRATION")
            routes = {}
            for codec in utils.CODECS:
                cross = cal["cuda_crossover_bytes"][codec]
                big = utils.choose_engine(1 << 40, codec)
                want = "cuda" if cross is not None and \
                    torch.cuda.is_available() else "native"
                if big != want or (cross is not None and utils.choose_engine(
                        cross - 1, codec) != "native"):
                    raise AssertionError(f"choose_engine {codec}: {big}")
                routes[codec] = big
        finally:
            if old is None:
                del os.environ["MSPACK_CALIBRATION"]
            else:
                os.environ["MSPACK_CALIBRATION"] = old
    print(f"calibration: choose_engine at 1 TiB routes {routes}")
    clock.lap("20 calibration")


def cli_phase(device, cab_path, want_a, bench, clock):
    """Phase 21: ``python -m libmspack_tpu_torch.cli.cabextract --engine
    cuda`` under MSPACK_TPU_STRICT=1 on one corpus A cabinet and the bench
    LZX cabinet: -d's files equal the inputs, -t's MD5s equal hashlib's."""
    import hashlib
    import os
    import tempfile

    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, MSPACK_TPU_STRICT="1",
               PYTHONPATH=os.pathsep.join(
                   [root] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    cmd = [sys.executable, "-m", "libmspack_tpu_torch.cli.cabextract",
           "--engine", "cuda", "--device", device.type]
    want = dict(want_a, **bench_files("lzx", bench["lzx"]["corpus"]))
    with tempfile.TemporaryDirectory() as td:
        lzx = os.path.join(td, "lzx.cab")
        with open(lzx, "wb") as fh:
            fh.write(bench["lzx"]["blob"])
        out = os.path.join(td, "out")
        t0 = time.perf_counter()
        r = subprocess.run(cmd + ["-q", "-d", out, cab_path, lzx], cwd=root,
                           env=env, capture_output=True, text=True,
                           timeout=600)
        dt = time.perf_counter() - t0
        if r.returncode:
            raise AssertionError(f"cabextract -d: {r.returncode} {r.stderr}")
        got = {}
        for name in os.listdir(out):
            with open(os.path.join(out, name), "rb") as fh:
                got[name] = fh.read()
        if got != want:
            raise AssertionError("cabextract -d: files differ")
        r = subprocess.run(cmd + ["-t", cab_path, lzx], cwd=root, env=env,
                           capture_output=True, text=True, timeout=600)
        sums = {ln.split()[0]: ln.split()[-1] for ln in r.stdout.splitlines()
                if "  OK  " in ln}
        if r.returncode or sums != {n: hashlib.md5(b).hexdigest()
                                    for n, b in want.items()}:
            raise AssertionError(f"cabextract -t: {r.returncode} {r.stdout}")
    print(f"cli: cabextract -d of {len(want)} files "
          f"({sum(map(len, want.values()))} bytes) in {dt:.1f} s with the "
          f"interpreter's start, equal; -t MD5s equal hashlib's")
    clock.lap("21 cabextract CLI")


def torch_small(bench, nbytes):
    """Phase 23's archives for a rehearsal on the CPU: ``bench``'s own,
    each built again by the same builder from the first ``nbytes`` of what
    it decodes to (the CHM from its first four topics). A bench LZX block
    spans 32 frames, which the tensor ops decode in the (64 frames, 8 MiB)
    bucket: 2^26 bit positions, some 20 GB."""
    from libmspack_tpu_torch.compress import chm_c, lzss_c

    mszip, lzx = (bench[c]["corpus"][:nbytes] for c in ("mszip", "lzx"))
    topics = {k: v[:nbytes // 4]
              for k, v in list(bench["chm"]["want"].items())[:4]}
    oab, szdd = (bench[c]["want"][:nbytes] for c in ("oab", "szdd"))
    return {"mszip": dict(blob=build_cab(mszip, "mszip"), corpus=mszip),
            "lzx": dict(blob=build_cab(lzx, "lzx"), corpus=lzx),
            "chm": dict(blob=chm_c.write_chm(list(topics.items())),
                        want=topics),
            "oab": dict(blob=build_oab(oab), want=oab),
            "szdd": dict(blob=lzss_c.szdd_compress(szdd), want=szdd)}


def torch_archives(bench):
    """Phase 23's archives: (name, format, file, what it decodes to)."""
    return [("MSZIP cabinet", "cab", bench["mszip"]["blob"],
             bench["mszip"]["corpus"]),
            ("LZX cabinet", "cab", bench["lzx"]["blob"],
             bench["lzx"]["corpus"]),
            ("CHM", "chm", bench["chm"]["blob"], bench["chm"]["want"]),
            ("OAB full 64 KiB blocks", "oab", bench["oab"]["blob"],
             bench["oab"]["want"]),
            ("SZDD", "szdd", bench["szdd"]["blob"], bench["szdd"]["want"])]


def _decode(fmt, engine, device, blob, strict):
    """One archive through one engine's driver: (driver, output)."""
    import libmspack_tpu_torch as lt

    kw = {"device": device} if engine in ("torch", "cuda") else {}
    if fmt != "szdd" and engine != "native":
        kw["strict"] = strict
    d = getattr(lt, f"create_{fmt}_decompressor")(engine=engine, **kw)
    if fmt == "cab":
        return d, extract_all(d, blob)
    if fmt == "chm":
        return d, extract_chm(d, blob)
    return d, d.decompress_bytes(blob)


def torch_phase(device, bench, clock):
    """Phase 23: engine="torch" (the JAX package's "jax" engine as PyTorch
    tensor ops) on the archives of phases 5, 9, 11, 16 and 17 under strict
    mode (the MSZIP cabinet twice, cold and warm; every other archive, and
    the other engines, one run: a run of the LZX cabinet or the OAB file
    takes about a minute), beside engine="cuda" and "native" on the same
    archive: bytes equal;
    MB/s, the ops' phase A and B times and the peak device memory (on the
    card). Where the ops decline (strict raises), the reasons and
    counts are printed, each must be one of the JAX package's decline
    texts, and the bytes are checked with strict=False. Then entry()'s
    forward step on the device (each frame's decoded length) and the
    bitview, E8 and MSCF-search ops against their host results."""
    import numpy as np
    import torch

    from libmspack_tpu_torch import FallbackError
    from libmspack_tpu_torch import entry as port_entry
    from libmspack_tpu_torch.codecs.lzx import _e8_transform
    from libmspack_tpu_torch.ops import bitview, e8, search
    from libmspack_tpu_torch.ops import inflate as ti
    from libmspack_tpu_torch.ops import lzx as tl

    known = set(ti.DECLINE_REASONS) | set(tl.DECLINE_REASONS)
    cuda = device.type == "cuda"
    for k, (name, fmt, blob, want) in enumerate(torch_archives(bench)):
        nbytes = sum(map(len, want.values())) if fmt == "chm" else len(want)
        for engine in ("torch", "cuda", "native"):
            strict, line = engine != "native", []
            runs = 2 if engine == "torch" and k == 0 else 1
            for rep in range(runs):
                if cuda:
                    torch.cuda.synchronize()
                    torch.cuda.reset_peak_memory_stats()
                t0 = time.perf_counter()
                try:
                    d, out = _decode(fmt, engine, device, blob, strict)
                except FallbackError as e:
                    if engine != "torch":
                        raise
                    print(f"engine=torch {name}: strict mode raised {e}")
                    strict = False
                    d, out = _decode(fmt, engine, device, blob, strict)
                if cuda:
                    torch.cuda.synchronize()
                secs = time.perf_counter() - t0
                if out != want:
                    raise AssertionError(f"engine={engine} {name}: bytes "
                                         "differ")
                declines = dict(getattr(d, "torch_declines", {}))
                if declines:
                    print(f"engine=torch {name} declines: {declines}")
                    unknown = set(declines) - known
                    if unknown:
                        raise AssertionError(f"{name}: declines that are not "
                                             f"the JAX package's: {unknown}")
                timings = getattr(d, "torch_timings", None)
                if timings is None:
                    timings = getattr(d, "timings", {})
                peak = torch.cuda.max_memory_allocated() / MB if cuda \
                    else float("nan")
                line.append(
                    f"{('cold', 'warm')[rep] if runs == 2 else 'one run'} "
                    f"{nbytes / secs / 1e6:.2f} MB/s"
                    + (f" (phase A {timings.get('phase_a_ms', 0):.1f} ms, "
                       f"phase B {timings.get('phase_b_ms', 0):.1f} ms)"
                       if engine == "torch" and "phase_a_ms" in timings
                       else "")
                    + (f", peak device memory {peak:.1f} MiB"
                       if engine != "native" and cuda else ""))
            print(f"engine={engine} {name}: " + "; ".join(line), flush=True)
        if cuda:
            torch.cuda.empty_cache()
        clock.lap(f"23 engine=torch {name}")

    # entry(): the forward step of the graft entry on the device
    fn, args = port_entry.entry(device=device)
    lens, end = fn(*args)
    host = port_entry.entry(device="cpu")
    want_lens, want_end = host[0](*host[1])
    if not (torch.equal(lens.cpu(), want_lens)
            and torch.equal(end.cpu(), want_end)):
        raise AssertionError("entry() on the device differs from the host")
    print(f"entry(): per-frame lengths {lens.tolist()}, end bits "
          f"{end.tolist()}, equal to the host's")
    # the bitview, E8 and search ops on the device against the host
    rng = np.random.RandomState(23)
    data = rng.randint(0, 256, 1 << 16, dtype=np.uint8)
    data[rng.randint(0, len(data) - 4, 64)] = 0xE8
    for at in rng.randint(0, len(data) - 4, 16):
        data[at:at + 4] = np.frombuffer(b"MSCF", np.uint8)
    t = torch.from_numpy(data)
    pos = torch.arange(8 * (len(data) - 8))
    for peek, n in ((bitview.peek_lsb, 24), (bitview.peek_msb16, 17)):
        if not torch.equal(peek(t.to(device), pos.to(device), n).cpu(),
                           peek(t, pos, n)):
            raise AssertionError(f"{peek.__name__} differs on the device")
    frame = data[:32768].tobytes()
    if e8.e8_decode_frame(frame, 65536, 1 << 22, device=device) != \
            bytes(_e8_transform(bytearray(frame), 65536, 1 << 22)):
        raise AssertionError("e8_transform differs from the scalar pass")
    raw = data.tobytes()
    found = [i for i in range(len(raw) - 3) if raw[i:i + 4] == b"MSCF"]
    if search.signature_positions(raw, device=device) != found:
        raise AssertionError("signature_positions differs from the host")
    print(f"bitview, e8 and search ops on {device}: equal to the host "
          f"({len(found)} signatures)")
    clock.lap("23 entry and the small ops")


MESH_KERNELS = (("cuda_inflate", "k1_inflate"), ("cuda_lzx", "k3_lzx"),
                ("cuda_qtm", "k4_qtm"))


def mesh_phase(device, clock):
    """Phase 24: the mesh. dryrun_multichip(1) on NCCL and
    dryrun_multichip(4) over gloo with all four ranks on the one card
    (the JAX package's three dry-run cases, each bit-exact on every rank),
    then decode_cab_multihost over 2 gloo ranks; the wall time of each
    case. On the card K1, K3 and K4 must each have launched on every path,
    their plain versions never, and nothing may decline (the Quantum folder
    reaches K4); each rank holds every launch to the kernel's plain version
    on the same inputs (``ops/shadow.py``). Returns the kernels' launches
    on these paths and their largest differences from the plain
    versions."""
    from libmspack_tpu_torch import entry as port_entry

    cuda = device.type == "cuda"
    key = "cuda" if cuda else "plain"
    total = {name: 0 for _, name in MESH_KERNELS}
    errs = {}

    def add(s, where):
        for mod, name in MESH_KERNELS:
            got = s["launches"][mod]
            if cuda and (got["plain"] or not got["cuda"]):
                raise AssertionError(f"{where}: {mod} launches {got}")
            total[name] += got[key]
            errs[name] = max(errs.get(name, 0), s["max_abs_err"].get(name, 0))
        if cuda and set(s["max_abs_err"]) != set(total):
            raise AssertionError(f"{where}: kernels held to their plain "
                                 f"versions: {s['max_abs_err']}")

    for n, backend in ((1, "nccl" if cuda else "gloo"), (4, "gloo")):
        t0 = time.perf_counter()
        s = port_entry.dryrun_multichip(n, backend=backend,
                                        device=device.type)
        wall = time.perf_counter() - t0
        if cuda and s["declines"]:
            raise AssertionError(f"mesh {n}: declines {s['declines']}")
        add(s, f"dryrun_multichip({n})")
        print(f"mesh dryrun_multichip({n}) on {backend}: "
              + ", ".join(f"{c} {v:.3f} s" for c, v in s["cases"].items())
              + f"; wall {wall:.1f} s with the ranks' start; launches "
              + str({m: c[key] for m, c in s["launches"].items()})
              + f"; declines {s['declines']}; largest differences from the "
              f"plain versions {s['max_abs_err']}", flush=True)
    t0 = time.perf_counter()
    s = port_entry.multihost_dryrun(2, backend="gloo", device=device.type,
                                    engine="cuda")
    add(s, "decode_cab_multihost")
    print(f"decode_cab_multihost over 2 gloo ranks: {s['seconds']:.3f} s, "
          f"wall {time.perf_counter() - t0:.1f} s; launches "
          + str({m: c[key] for m, c in s["launches"].items()})
          + f"; largest differences from the plain versions "
          f"{s['max_abs_err']}")
    clock.lap("24 mesh")
    return total, errs


# phase 25: the kernels' bench entries at the JAX package's shapes (each
# entry's defaults), and small ones for a rehearsal on the CPU
BENCH_SHAPES = {"cuda_inflate": {}, "cuda_resolve": {}, "cuda_lzx": {},
                "cuda_qtm": {}}
SMALL_SHAPES = {"cuda_inflate": dict(n=8, kb=8),
                "cuda_resolve": dict(n_frames=8),
                "cuda_lzx": dict(n_lanes=4, chunk_kb=16),
                "cuda_qtm": dict(n_lanes=4, chunk_kb=8)}
# the link the scaling model is given where there is one card: what
# tools/scaling_model.measure_link measured between two NVIDIA H100 80GB
# HBM3 (700 W) of a four-card host, NCCL send/recv, 200 round trips each
# of 4 bytes (the one-way latency) and of 4 * H_WIN bytes (the rate)
LINK_GBPS = 9.990834062244028
LINK_US = 80.65297000001693
CUT_MARKER = "int64_t used = b.tell();"
MODULE_KERNELS = {"cuda_inflate": "k1_inflate", "cuda_resolve": "k2_resolve",
                  "cuda_lzx": "k3_lzx", "cuda_qtm": "k4_qtm"}


def measure_phase(device, clock, bench, gather_records, shapes, mesh_sizes):
    """Phase 25: the JAX package's measurement path through the port.
    bench.py's rows on the cabinets of phases 5, 9 and 14
    (``libmspack_tpu_torch.bench``: native rows, ``mszip_decompress_cuda``
    strict, the K1, K3 and K4 rows from their bench entries, the mesh at
    one rank), K2's bench entry, ``mesh_scaling`` at ``mesh_sizes``,
    ``scaling_model`` from this run's rates and P5's gather rate
    (``gather_records``), ``cut_bisect`` on one marker, and
    ``devtime.time_chained`` on a chain of K1 launches. Each entry must be
    bit-exact with no error and its sampled lanes equal to the plain
    version; the mesh runs hold every launch of their first decode to the
    plain version (``ops/shadow.py``). Returns the launches of the phase
    by kernel name (the parent's counted by ``Launches``, the ranks' summed)
    and the largest differences from the plain versions."""
    import torch

    from libmspack_tpu_torch import bench as port_bench
    from libmspack_tpu_torch.ops import cuda_inflate as ci
    from libmspack_tpu_torch.ops import cuda_resolve as cr
    from libmspack_tpu_torch.tools import (cut_bisect, devtime, mesh_scaling,
                                           scaling_model)

    cuda = device.type == "cuda"
    counts = Launches(device)
    errs = {}
    key = counts.key
    ranks_total = dict.fromkeys(MODULE_KERNELS.values(), 0)

    def add_ranks(launches, max_abs_err):
        for mod, c in launches.items():
            ranks_total[MODULE_KERNELS[mod]] += c[key]
            if cuda and c["plain"]:
                raise AssertionError(f"{mod}: plain launches {c} on a card")
        for k, v in max_abs_err.items():
            errs[k] = max(errs.get(k, 0), v)

    def check(e):
        print(json.dumps(e), flush=True)
        bad = e["errors"] or not e["sampled_bit_exact"] or \
            e.get("out_ok", e.get("cnt_ok")) != e["lanes"] or \
            e["plain_max_abs_err"] or e.get("k1_plain_max_abs_err", 0)
        if bad:
            raise AssertionError(f"{e['kernel']} bench entry failed: {e}")
        name = e["kernel"]
        errs[name] = max(errs.get(name, 0), e["plain_max_abs_err"])
        if "k1_plain_max_abs_err" in e:
            errs["k1_inflate"] = max(errs.get("k1_inflate", 0),
                                     e["k1_plain_max_abs_err"])
        if name == "k2_resolve":   # tokens read, bytes written; a lane a chain
            nbytes, chain = 8 * e["tokens"] + e["bytes_out"], \
                e["max_steps"] + 1
        else:     # streams read, tokens and counts written
            nbytes = e["bytes_in"] + 8 * e["tokens"] + 32 * e["lanes"]
            chain = e["max_steps"]
        print(f"{name}: {e['config']}: {e['ms']:.3f} ms "
              f"({e['mb_per_s']:.1f} MB/s, {e['timing']}); bound "
              f"{bound(nbytes, chain)}; launch {e['launch']}; peak "
              f"{e['peak_bytes']} bytes", flush=True)

    cabs = {c: (bench[c]["corpus"], bench[c]["blob"])
            for c in ("mszip", "lzx", "quantum")}
    (doc, details), _ = counts.run(lambda: port_bench.run(
        cabs=cabs, require_cuda=cuda, device=device,
        shapes={m: shapes[m] for m in ("cuda_inflate", "cuda_lzx",
                                       "cuda_qtm")}))
    print(json.dumps(doc), flush=True)
    entries = details["entries"]
    for e in entries:
        check(e)
    add_ranks(details["mesh"]["launches"], details["mesh"]["max_abs_err"])
    clock.lap("25 bench rows")
    k2, _ = counts.run(lambda: cr.bench_entry(**shapes["cuda_resolve"],
                                              device=device))
    check(k2)
    entries.append(k2)
    clock.lap("25 K2 bench entry")
    scale, _ = counts.run(lambda: mesh_scaling.run(mesh_sizes, device))
    add_ranks(scale.pop("launches"), scale.pop("max_abs_err"))
    print(json.dumps(scale), flush=True)
    clock.lap("25 mesh_scaling")
    rates = scaling_model.rates_from({"entries": entries})
    if cuda and torch.cuda.device_count() >= 2:
        link = scaling_model.measure_link()
    else:
        link = scaling_model.given_link(LINK_GBPS, LINK_US)
    proj = scaling_model.project(
        rates, scaling_model.gather_rate(gather_records), link)
    print(json.dumps(proj), flush=True)
    ok, line = cut_bisect.cut(CUT_MARKER)
    print(line, flush=True)
    if not ok:
        raise AssertionError(f"cut_bisect: {line}")
    clock.lap("25 scaling_model, cut_bisect")
    k1 = entries[0]
    frames, _ = ci.bench_inputs(**shapes["cuda_inflate"])
    s, lens = ci.pack_streams(frames)
    sd, ld = s.to(device), lens.to(device)
    tcap = k1["tcap"]

    def step(h):
        _, _, cnt = ci.inflate_phase_a(sd, ld, h, tcap=tcap)
        return h + cnt[0]   # the next launch waits on these counts

    h0 = torch.zeros(len(frames), dtype=torch.int32, device=device)
    (per_step, last), _ = counts.run(lambda: (devtime.time_chained(
        step, h0, n=16, min_delta=0.5 if cuda else 0.05), step(h0)))
    if int(last.abs().max()):
        raise AssertionError("K1 chain: a launch flagged an error")
    print(f"devtime.time_chained, K1 on {k1['config']}: {per_step * 1e3:.3f} "
          f"ms a launch; bench_entry {k1['ms']:.3f} ms", flush=True)
    clock.lap("25 devtime")
    total = {n: counts.total[n] + ranks_total[n]
             for n in MODULE_KERNELS.values()}
    if cuda:
        missing = [n for n, v in total.items() if not v]
        if missing:
            raise AssertionError(f"phase 25 never launched {missing}")
    return total, errs


def fuzz_phase(device, budget_s, clock):
    """Phase 22, last: the port's fuzz_mass on ``device`` for CAB (MSZIP,
    LZX and Quantum folders), CHM, OAB and SZDD, seeded, ``budget_s``
    seconds each: no foreign exception, no CUDA error, no byte mismatch
    with the scalar engine."""
    from libmspack_tpu_torch.tools import fuzz_mass

    arcs = fuzz_mass.build_archives()
    bad = []
    for kind in ("cab", "chm", "oab", "szdd"):
        r = fuzz_mass.sweep(kind, arcs[kind], 1 << 30, seed=8,
                            time_budget_s=budget_s, engine="cuda",
                            device=device)
        print(f"fuzz {kind}: {r['done']} rounds, {len(r['fails'])} "
              f"failures, {len(r['cuda_errors'])} CUDA errors, "
              f"{len(r['mismatches'])} byte mismatches with scalar, "
              f"error-class differences (cuda, scalar) "
              f"{dict(r['class_diffs'])}")
        for f in (r["fails"] + r["cuda_errors"])[:5]:
            print(f"fuzz {kind}:   {f}")
        if r["fails"] or r["cuda_errors"] or r["mismatches"]:
            bad.append(kind)
    if bad:
        raise AssertionError(f"fuzz failed on {bad}")
    clock.lap("22 fuzz")


PROBE_TOOLS = ("micro_vec", "micro_skel", "micro_copy", "mosaic_probe",
               "micro_gather", "micro_gather2")


def probe_phases(device, clock, records=None):
    """Phase 15: each probe tool's main() with its kernels' launch counts
    set to 0 before and read after, then each run's result against the
    plain version on the same inputs. On the CPU (a rehearsal) the tools
    run their plain versions with small library rows. Returns one entry
    per probe kernel: the time, bound and library time of its largest
    run, the largest difference over all its runs; ``records`` (a dict)
    receives each tool's records by name."""
    import importlib

    import torch

    entries = []
    for name in PROBE_TOOLS:
        mod = importlib.import_module(f"libmspack_tpu_torch.tools.{name}")
        for k in mod.LAUNCHES:
            mod.LAUNCHES[k] = 0
        recs = mod.main([], device=device)
        if records is not None:
            records[name] = recs
        launches = dict(mod.LAUNCHES)
        runs = {k: [] for k in mod.REPLACES}
        for r in recs:
            want, plain_ms = timed(r.plain, torch.device("cpu"))
            if want.shape != r.out.shape:
                raise AssertionError(f"{r.kernel} {r.label}: shape "
                                     f"{tuple(r.out.shape)}, plain "
                                     f"{tuple(want.shape)}")
            err = int((r.out.long() - want.long()).abs().max()) \
                if want.numel() else 0
            runs[r.kernel].append((r, err, plain_ms))
        for kernel, done in runs.items():
            if not done:
                raise AssertionError(f"{kernel}: {name}.main() never ran it")
            if device.type == "cuda" and launches[kernel] < 1:
                raise AssertionError(f"{kernel} never launched in {name}")
            r, _, plain_ms = max(done, key=lambda d: (not d[0].edge,
                                                      d[0].nbytes))
            err = max(e for _, e, _ in done)
            lib = "" if r.library_ms is None else \
                f", library {r.library_ms:.4f} ms"
            print(f"{kernel}: {len(done)} runs, max abs err {err}; "
                  f"{r.label}: kernel {r.ms:.4f} ms, plain {plain_ms:.1f} "
                  f"ms{lib}; launches {launches[kernel]}; bound "
                  f"{bound(r.nbytes, r.chain)}", flush=True)
            source = getattr(mod, "SOURCES", {}).get(kernel, mod.SOURCE)
            entries.append(entry(kernel, source, mod.REPLACES[kernel],
                                 launches[kernel], err, r.ms, plain_ms,
                                 r.nbytes, r.chain, r.library_ms))
        clock.lap(f"15 probes: {name}")
    return entries


def time_k34(reps=4):
    """``python3 chip_smoke.py --time-k34``: K3 on one whole bench LZX
    folder and K4 on one whole bench Quantum folder (the launches of phases
    8 and 13), ``reps`` times each, with the kernels built from this
    checkout, beside a hash of each trace. To compare two versions of a
    kernel on one card, unpack each checkout into a directory of its own
    and run this in each, in turns (A, B, B, A)."""
    import hashlib

    import torch

    from libmspack_tpu_torch import kernels
    from libmspack_tpu_torch import lzx_edge_cases as le
    from libmspack_tpu_torch import qtm_edge_cases as qe
    from libmspack_tpu_torch.ops import cuda_lzx as cl
    from libmspack_tpu_torch.ops import cuda_qtm as cq

    device = torch.device("cuda")
    kernels.lib()
    report = kernels.ptxas_report()
    for name, comp in (("k3_lzx", "lzx"), ("k4_qtm", "quantum")):
        _, folders = bench_folders(build_corpus(FOLDER_MB[comp] * MB), comp)
        f = folders[0]
        if comp == "lzx":
            args = [t.to(device) for t in le.inputs([f])]
            launch = lambda: cl.lzx_phase_a(*args, f.window_bits,
                                            tcap=f.out_len)
        else:
            args = [t.to(device) for t in qe.inputs([f])]
            launch = lambda: cq.qtm_phase_a(*args, f.window_bits,
                                            tcap=f.out_len)
        times = []
        for _ in range(reps):
            (tok, litw, cnt), ms = timed(launch, device)
            times.append(ms)
        cnt = cnt.cpu()
        n = int(cnt[2, 0])
        if int(cnt[0, 0]) or int(cnt[1, 0]) != f.out_len:
            raise AssertionError(f"{name}: counts {cnt[:3, 0].tolist()}")
        h = hashlib.sha256(tok[0, :n].cpu().numpy().tobytes()
                           + litw[0, :n].cpu().numpy().tobytes())
        print(f"{name}: {f.out_len}-byte folder, {n} tokens, trace "
              f"{h.hexdigest()[:16]}; ms " + ", ".join(
                  f"{t:.3f}" for t in times)
              + f"; ptxas {report.get(name + '_kernel')}", flush=True)


def time_k12(reps=4):
    """``python3 chip_smoke.py --time-k12``: K1 on one bench MSZIP folder
    and on the whole cabinet, and K2 on the whole cabinet (phase 4's
    launches), each held to its plain version, with the kernels built from
    this checkout: K1's whole-cabinet time ``reps`` times, K2's passes, the
    ptxas lines and SASS summaries of both."""
    import torch

    from libmspack_tpu_torch.ops import cuda_inflate as ci

    device = torch.device("cuda")
    build_report(time.perf_counter(), DECODERS[:3])
    corpus, _, folders = mszip_folders(CORPUS_MB["mszip"])
    fcases = folder_cases(folders[:1])
    (tok, _, cnt), _, e1, ms, pms = k1_compare(fcases, device, ci.FRAME_MAX)
    print(f"K1 one folder ({len(fcases)} frames): kernel {ms:.3f} ms (best "
          f"of 3), plain {pms:.1f} ms, max abs err {e1}", flush=True)
    k1_symbols(tok, cnt, ms)
    allc = folder_cases(folders)
    s, lens = ci.pack_streams([c.stream for c in allc])
    hists = torch.tensor([c.hist for c in allc], dtype=torch.int32)
    sd, ld, hd = (t.to(device) for t in (s, lens, hists))
    times = [timed(lambda: ci.inflate_phase_a(sd, ld, hd), device)[1]
             for _ in range(reps)]
    print(f"K1 whole cabinet ({len(allc)} frames): ms " + ", ".join(
        f"{t:.3f}" for t in times), flush=True)
    tok, litw, cnt = (t.cpu() for t in ci.inflate_phase_a(sd, ld, hd))
    sizes, flags = chain_layout(folders)
    (ob, _), e2, ms, pms, passes = k2_compare(
        tok, litw, cnt[2].contiguous(), sizes, flags, device)
    if e1 or e2 or bytes(ob.numpy()) != corpus:
        raise AssertionError(f"K1 or K2 differ: max abs err {e1}, {e2}")
    k2_work(cnt[2].numpy(), folders, len(corpus))
    print(f"K2 whole cabinet ({len(allc)} frames, {len(folders)} chains): "
          f"kernel {ms:.3f} ms (best of 3; pass 1, pass 2: {passes}), plain "
          f"{pms:.1f} ms, equal", flush=True)


def diag_k1():
    """``python3 chip_smoke.py --diag-k1``: where K1's time goes. K1 alone
    on one bench MSZIP folder, six launches; then ``inflate.cu`` built
    with -DDC_CYCLES (deflate_core.cuh), whose counts rows 4-7 carry each
    warp's clock64 cycles in all, in literal runs and in block headers, and
    the literals of those runs, on one folder and on the whole cabinet:
    the slowest warp's parts; then device phase B's pull, 96 MiB into
    pageable memory (``.cpu()``) and into page-locked memory (``copy_``),
    twice each."""
    import ctypes
    import os

    import numpy as np
    import torch

    from libmspack_tpu_torch import kernels
    from libmspack_tpu_torch.ops import cuda_inflate as ci

    device = torch.device("cuda")
    _, _, folders = mszip_folders(CORPUS_MB["mszip"])
    batches = {}
    for name, fols in (("one folder", folders[:1]), ("whole cabinet", folders)):
        cases = folder_cases(fols)
        s, lens = ci.pack_streams([c.stream for c in cases])
        hists = torch.tensor([c.hist for c in cases], dtype=torch.int32)
        batches[name] = [t.to(device) for t in (s, lens, hists)]
    sd, ld, hd = batches["one folder"]
    ms = [timed(lambda: ci.inflate_phase_a(sd, ld, hd), device)[1]
          for _ in range(6)]
    print("K1 one folder ms " + " ".join(f"{m:.3f}" for m in ms), flush=True)
    src = os.path.join(kernels.CSRC, "inflate.cu")
    tag = kernels.source_tag([src, os.path.join(kernels.CSRC,
                                                "deflate_core.cuh")])
    so = os.path.join(kernels.BUILD_DIR, f"k1_cycles_{tag}.so")
    if not os.path.exists(so):
        kernels.compile_to([kernels.nvcc_path()] + kernels.NVCC_FLAGS
                           + ["-DDC_CYCLES", "-shared", src], so)
    fn = ctypes.CDLL(so).msp_k1_inflate
    fn.argtypes = kernels._SIGNATURES["msp_k1_inflate"]
    for name, (s, lens, hists) in batches.items():
        L = s.shape[0]
        tok = torch.empty((L, ci.FRAME_MAX), dtype=torch.int32, device=device)
        litw = torch.empty_like(tok)
        cnt = torch.empty((8, L), dtype=torch.int32, device=device)
        for _ in range(2):
            rc = fn(s.data_ptr(), s.stride(0), lens.data_ptr(),
                    hists.data_ptr(), L, tok.data_ptr(), litw.data_ptr(),
                    ci.FRAME_MAX, cnt.data_ptr(), ci.K1_WARPS,
                    torch.cuda.current_stream().cuda_stream)
            if rc:
                raise RuntimeError(f"K1 (DC_CYCLES): CUDA error {rc}")
        c = cnt.cpu().numpy().astype(np.int64)
        lits, mats = deflate_mix(tok.cpu().numpy(), c[2])
        i = int(c[4].argmax())
        print(f"K1 cycles, {name}: slowest warp {c[4, i]} cycles; literal "
              f"runs {c[5, i]} for {c[7, i]} literals "
              f"({c[5, i] / max(1, c[7, i]):.1f} a literal); block headers "
              f"{c[6, i]}; the rest {c[4, i] - c[5, i] - c[6, i]} for "
              f"{mats[i]} matches and {lits[i] - c[7, i]} other literals; "
              f"all warps {c[5].sum() / max(1, c[7].sum()):.1f} cycles a "
              f"literal in literal runs", flush=True)
    x = torch.randint(0, 255, (96 * MB,), dtype=torch.uint8, device=device)
    pinned = torch.empty(x.numel(), dtype=torch.uint8, pin_memory=True)
    for name, pull in (("pageable", lambda: x.cpu()),
                       ("page-locked", lambda: pinned.copy_(x))) * 2:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pull()
        torch.cuda.synchronize()
        print(f"96 MiB pull into {name} memory: "
              f"{(time.perf_counter() - t0) * 1e3:.2f} ms", flush=True)


def time_oab(reps=5, device="cuda", sizes=(64, 32, 4 << 20)):
    """``python3 chip_smoke.py --time-oab``: phase 16's three OAB files
    (``oab_inputs(*sizes)``) through create_oab_decompressor(engine="cuda",
    strict=True), then engine="native", ``reps`` times each, bytes
    checked; prints every run's MB/s and the last cuda run's phases (engine
    and driver). To compare two checkouts' OAB paths on one card, unpack
    each into a directory of its own and run this in each, in turns (A, B,
    B, A)."""
    from libmspack_tpu_torch import create_oab_decompressor

    for name, blob, want, base in oab_inputs(*sizes):
        for engine in ("cuda", "native"):
            kw = {"device": device, "strict": True} if engine == "cuda" \
                else {}
            mbs = []
            for _ in range(reps):
                d = create_oab_decompressor(engine=engine, **kw)
                t0 = time.perf_counter()
                out = d.decompress_bytes(blob) if base is None else \
                    d.decompress_incremental_bytes(blob, base)
                mbs.append(len(want) / (time.perf_counter() - t0) / 1e6)
                if out != want:
                    raise AssertionError(f"OAB {name} engine={engine}: "
                                         "bytes differ")
            print(f"engine={engine} OAB {name}, MB/s of each run: "
                  + ", ".join(f"{v:.1f}" for v in mbs), flush=True)
            if engine == "cuda":
                print(f"engine=cuda OAB {name} phases of the last run (ms): "
                      + ", ".join(f"{k} {v:.3f}" for k, v in sorted(
                          {**d.cuda_engine.timings, **d.timings}.items())))


def measure_only():
    """``python3 chip_smoke.py --measure``: phase 25 alone, after the build,
    on bench.py's cabinets (``bench.cached_cab``) and P5's gather rows
    (``micro_gather.bench_gather``)."""
    import torch

    from libmspack_tpu_torch import bench as port_bench
    from libmspack_tpu_torch.tools import micro_gather

    device = torch.device("cuda")
    clock = Clock()
    build_report(time.perf_counter(), ())
    bench = {}
    for c, mb in CORPUS_MB.items():
        corpus, blob = port_bench.cached_cab(c, mb)
        bench[c] = dict(corpus=corpus, blob=blob)
    clock.lap("cabinets")
    recs = micro_gather.bench_gather(device)
    meas, errs = measure_phase(device, clock, bench, recs, BENCH_SHAPES,
                               (1, 2, 4))
    print(f"launches on the measurement path: {meas}; largest differences "
          f"from the plain versions there: {errs}")
    if any(errs.values()):
        raise AssertionError(f"kernels differ from their plain versions: "
                             f"{errs}")


def main(argv=None) -> int:
    import torch

    argv = sys.argv[1:] if argv is None else argv
    modes = {"--time-k12": time_k12, "--time-k34": time_k34,
             "--time-oab": time_oab, "--diag-k1": diag_k1,
             "--measure": measure_only}
    if argv and (len(argv) > 1 or argv[0] not in modes):
        print("usage: chip_smoke.py [--time-k12 | --time-k34 | --time-oab "
              "| --diag-k1 | --measure]", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 1
    print(card_line())
    if argv:
        modes[argv[0]]()
        return 0
    result = run("cuda")
    print(json.dumps(result))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
