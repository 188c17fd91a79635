"""Build and load the port's CUDA kernels (K1 inflate, K2 resolve, K3 LZX,
K4 Quantum, and the probes P1-P6 of ``libmspack_tpu_torch.tools``).

The sources in ``libmspack_tpu_torch/csrc`` are compiled at first use by
``nvcc`` for Hopper (``sm_90a``), one ``nvcc`` per ``.cu`` file, all
started together, and linked into one shared library with a plain C
interface, which ctypes loads. The library lives in
``libmspack_tpu_torch/_build/`` (git-ignored), named by the sha256 of the
sources, so an edit rebuilds and an unchanged tree reuses the last build.
Nothing here runs at import time: this module imports on hosts without a
CUDA toolkit, and only ``lib()`` needs one.

``host_twin()``, ``host_twin_resolve()``, ``host_twin_lzx()`` and
``host_twin_qtm()`` build the kernels' cores (``deflate_core.cuh``,
``resolve_core.cuh``, ``lzx_core.cuh``, ``qtm_core.cuh``) with g++
instead, for the tests: the same C++ the kernels run, on the CPU, the warp
steps evaluated lane by lane (``stream_core.cuh``) and K2's block steps
thread by thread; ``host_twin_copy()``, ``host_twin_vec()``,
``host_twin_gather()`` and ``host_twin_gather2()`` do the same for the
redesigned probes P3, P1, P5 and P6 (``probes_copy_core.cuh``,
``probes_vec.cuh``, ``probes_gather_core.cuh``,
``probes_gather2_core.cuh``), and ``host_twin_mosaic()`` and
``host_twin_skel()`` for P4 and P2 (``probes_mosaic_core.cuh``,
``probes_skel_core.cuh``). Each twin is keyed by the sha256 of its
header and the headers it includes.
"""
from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "csrc")
BUILD_DIR = os.path.join(os.path.dirname(CSRC), "_build")

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-std=c++17", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_I64 = ctypes.c_int64

# C entry points: (argtypes) — every pointer and the stream as c_void_p
_SIGNATURES = {
    "msp_k1_inflate": [_P, _I64, _P, _P, _I, _P, _P, ctypes.c_int32, _P,
                       _I, _P],
    "msp_k2_pass1": [_P, _P, _I64, _P, _P, _P, _P, _I, _I, _P, _P, _P],
    "msp_k2_pass2": [_P, _P, _P, _P, _P, _I, _P, _P],
    "msp_k3_lzx": [_P, _I64, _P, _P, _P, _I, _I, _I, _I, _P, _P, _P,
                   ctypes.c_int32, _P, _P],
    "msp_k3_lzx_split": [_P, _I64, _P, _P, _P, _I, _I, _P, _P, _P,
                         ctypes.c_int32, _P, _P, _I, _I, _P, _P, _P, _P, _P,
                         _P],
    "msp_k4_qtm": [_P, _I64, _P, _P, _I, _I, _I, _P, _P, _P, ctypes.c_int32,
                   _P, _P],
    "msp_p1_vec": [_I, _I, _I, _I, _P, _P, _P],
    "msp_p1_registers": [_I, _I, _I, _P, _P],
    "msp_p2_skel": [_P, _I64, _P, _I, _I, _I, _I, _P, _P, _P],
    "msp_p2_skel_vec": [_P, _I64, _P, _I, _I, _I, _I, _P, _P, _P],
    "msp_p3_copy": [_P, _P, _I, _P, _P, _P, _P],
    "msp_p3_copy_par": [_P, _P, _I, _P, _P, _P, _I, _P],
    "msp_p4_probe": [_I, _P, _P, _I64, _P, _P],
    "msp_p4_probe_vec": [_I, _P, _P, _I64, _P, _P],
    "msp_p5_dyngather": [_P, _P, _P, _I, _I, _I, _P],
    "msp_p5_masksum": [_P, _P, _P, _I, _I, _P],
    "msp_p5_symbol_step": [_P, _P, _P, _P, _I, _I, _P],
    "msp_p5_dyngather_cluster": [_P, _P, _P, _I, _I, _P, _P],
    "msp_p5_symbol_smem": [_P, _P, _P, _P, _I, _I, _P],
    "msp_p5_dyngather_row": [_P, _P, _P, _I, _I, _P],
    "msp_p5_masksum_vec": [_P, _P, _P, _I, _I, _P],
    "msp_p6_masksum": [_P, _P, _P, _I, _I, _P],
    "msp_p6_symbol_step": [_P, _P, _P, _P, _P, _I, _I, _P],
    "msp_p6_masksum_vec": [_P, _P, _P, _I, _I, _P],
    "msp_p6_symbol_smem": [_P, _P, _P, _P, _P, _I, _I, _P],
    # launch resources (csrc/launch_info.cuh): no stream, an int[5] out
    "msp_k1_launch_info": [_I, _P],
    "msp_k2_launch_info": [_I, _I, _P],
    "msp_k3_launch_info": [_P],
    "msp_k4_launch_info": [_P],
}

_lib = None
build_info: dict = {}   # seconds, path and ptxas report of the last build


def _sources(patterns) -> list[str]:
    out = []
    for p in patterns:
        out.extend(sorted(glob.glob(os.path.join(CSRC, p))))
    return out


def source_tag(paths) -> str:
    h = hashlib.sha256()
    for p in paths:
        h.update(os.path.basename(p).encode())
        with open(p, "rb") as fh:
            h.update(fh.read())
    return h.hexdigest()[:16]


def compile_to(cmd: list[str], so: str) -> str:
    """Run a compiler into a temporary name, then move it to ``so`` (so
    concurrent builds never load a half-written library). Returns the
    compiler's stderr; raises with it on failure."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{so}.{os.getpid()}.{threading.get_ident()}.tmp"
    r = subprocess.run(cmd + ["-o", tmp], capture_output=True, text=True)
    if r.returncode != 0:
        raise RuntimeError(f"kernel build failed: {' '.join(cmd)}\n"
                           f"{r.stderr}")
    os.replace(tmp, so)
    return r.stderr


def nvcc_path() -> str:
    cand = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(cand):
        raise RuntimeError("nvcc not found (PATH, /usr/local/cuda/bin): "
                           "the CUDA kernels cannot be built here")
    return cand


def lib():
    """The loaded kernel library, building it on first use."""
    global _lib
    if _lib is not None:
        return _lib
    srcs = _sources(["*.cu", "*.cuh"])
    so = os.path.join(BUILD_DIR, f"kernels_{source_tag(srcs)}.so")
    t0 = time.perf_counter()
    log = ""
    if not os.path.exists(so):
        log = _nvcc_parallel([s for s in srcs if s.endswith(".cu")], so)
    build_info.update(seconds=time.perf_counter() - t0, path=so,
                      ptxas=log)
    handle = ctypes.CDLL(so)
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(handle, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    handle.msp_cuda_error_string.argtypes = [_I]
    handle.msp_cuda_error_string.restype = ctypes.c_char_p
    for name in ("msp_k3_state_bytes", "msp_k3_frame_end_bytes",
                 "msp_k4_state_bytes"):
        getattr(handle, name).argtypes = []
        getattr(handle, name).restype = _I64
    _lib = handle
    return _lib


def kernel_name(mangled: str) -> str:
    """A kernel's name from its mangled one: the last part of its nested
    name (``_ZN12_GLOBAL__N_117p5_masksum_kernelE...``) or its plain name
    (``_Z13k3_lzx_kernel...``), with a bool template argument as
    ``<true>``/``<false>``."""
    rest, parts = mangled[2:], []
    nested = rest.startswith("N")
    rest = rest[1:] if nested else rest
    while rest[:1].isdigit():
        m = re.match(r"\d+", rest)
        n = int(m.group())
        parts.append(rest[m.end():m.end() + n])
        rest = rest[m.end() + n:]
        if not nested:
            break
    arg = {"ILb1E": "<true>", "ILb0E": "<false>"}.get(rest[:5], "")
    return (parts[-1] if parts else mangled) + arg


def ptxas_report(log: str = None) -> dict:
    """{kernel name: its ptxas lines (stack frame and spills; registers and
    shared memory), joined} from a build's ``-Xptxas -v`` log (by default
    the last build's; empty when ``lib()`` reused a built library)."""
    out, cur, mangled = {}, None, None
    for line in (build_info.get("ptxas", "") if log is None
                 else log).splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        p = re.search(r"Function properties for (\w+)", line)
        if m:
            mangled, cur = m.group(1), kernel_name(m.group(1))
            out[cur] = []
        elif p and p.group(1) != mangled:   # a device function's
            cur = None
        elif cur and ("stack frame" in line or "Used" in line):
            out[cur].append(line.split(":", 1)[-1].strip())
    return {k: "; ".join(v) for k, v in out.items()}


def _nvcc_parallel(cus: list[str], so: str) -> str:
    """One ``nvcc -c`` per source, all running at once, then one link into
    ``so``. Returns the compilers' stderr (the ptxas report); raises with
    it on failure."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = nvcc_path()
    objs = [f"{so}.{os.getpid()}.{os.path.basename(c)}.o" for c in cus]
    procs = [subprocess.Popen([nvcc] + NVCC_FLAGS + ["-c", c, "-o", o],
                              stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for c, o in zip(cus, objs)]
    logs, failed = [], []
    for c, p in zip(cus, procs):
        _, err = p.communicate()
        logs.append(err)
        if p.returncode != 0:
            failed.append(f"{os.path.basename(c)}:\n{err}")
    try:
        if failed:
            raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
        logs.append(compile_to([nvcc, "-shared"] + NVCC_FLAGS[:2] + objs,
                               so))
    finally:
        for o in objs:
            if os.path.exists(o):
                os.remove(o)
    return "".join(logs)


def _twin(header: str, define: str, includes=()):
    """g++ build of one core header's host entry points (tests only), keyed
    by it and the ``includes`` it pulls in from ``csrc``. Raises if g++ is
    missing or the build fails."""
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ not found")
    src = os.path.join(CSRC, header)
    stem = header.split("_")[0]
    tag = source_tag([src] + [os.path.join(CSRC, h) for h in includes])
    so = os.path.join(BUILD_DIR, f"{stem}_twin_{tag}.so")
    if not os.path.exists(so):
        compile_to([gxx, "-O2", "-std=c++17", "-shared", "-fPIC",
                  f"-D{define}", "-x", "c++", src], so)
    return ctypes.CDLL(so)


def host_twin():
    """The DEFLATE core's twin: ``dc_inflate_host``, K1's launch, and the
    table decode (``dc_table_decode``) and bit reader (``dc_read_bits``)
    alone."""
    handle = _twin("deflate_core.cuh", "DEFLATE_CORE_HOST_TWIN",
                   ["stream_core.cuh"])
    handle.dc_inflate_host.argtypes = [_P, _I64, _P, _P, _I, _P, _P,
                                       ctypes.c_int32, _P]
    handle.dc_inflate_host.restype = ctypes.c_int
    handle.dc_table_decode.argtypes = [_P, _I, _I, _P, _I64, _I, _P, _P]
    handle.dc_table_decode.restype = ctypes.c_int
    handle.dc_read_bits.argtypes = [_P, _I64, _P, _I, _P, _P]
    handle.dc_read_bits.restype = None
    return handle


def host_twin_resolve():
    """The resolve core's twin: ``rs_resolve_host`` (K2's two passes, one
    after the other) and ``rs_pass1_host`` (pass 1 alone)."""
    handle = _twin("resolve_core.cuh", "RESOLVE_CORE_HOST_TWIN",
                   ["stream_core.cuh"])
    handle.rs_resolve_host.argtypes = [_P, _P, _I64, _P, _P, _P, _P, _P, _P,
                                       _I, _I, _P, _P, _P]
    handle.rs_resolve_host.restype = ctypes.c_int
    handle.rs_pass1_host.argtypes = [_P, _P, _I64, _P, _P, _P, _P, _I, _P,
                                     _P]
    handle.rs_pass1_host.restype = ctypes.c_int
    return handle


def host_twin_lzx():
    """The LZX core's twin: ``lz_decode_host``, K3's launch,
    ``lz_split_host``, its split launch sequence, ``lz_state_bytes``,
    ``lz_frame_end_bytes``, and the table decode alone:
    ``lz_first_bits(tree)`` (the first-level bits of the main, length,
    aligned and pretree tables) and ``lz_table_decode``."""
    handle = _twin("lzx_core.cuh", "LZX_CORE_HOST_TWIN", ["stream_core.cuh"])
    handle.lz_decode_host.argtypes = _SIGNATURES["msp_k3_lzx"][:-1]
    handle.lz_decode_host.restype = ctypes.c_int
    handle.lz_split_host.argtypes = _SIGNATURES["msp_k3_lzx_split"][:-1]
    handle.lz_split_host.restype = ctypes.c_int
    for name in ("lz_state_bytes", "lz_frame_end_bytes"):
        getattr(handle, name).argtypes = []
        getattr(handle, name).restype = _I64
    handle.lz_first_bits.argtypes = [_I]
    handle.lz_first_bits.restype = ctypes.c_int
    handle.lz_table_decode.argtypes = [_P, _I, _I, _P, _I64, _I, _P, _P]
    handle.lz_table_decode.restype = ctypes.c_int
    return handle


def host_twin_qtm():
    """The Quantum core's twin: ``qt_decode_host``, K4's launch,
    ``qt_state_bytes``, and the warp steps alone: ``qt_model_symbol``,
    ``qt_rescale`` (on a ``qt::Model`` record of ``qt_model_bytes``) and
    ``qt_renorm``."""
    handle = _twin("qtm_core.cuh", "QTM_CORE_HOST_TWIN", ["stream_core.cuh"])
    handle.qt_decode_host.argtypes = _SIGNATURES["msp_k4_qtm"][:-1]
    handle.qt_decode_host.restype = ctypes.c_int
    for name in ("qt_state_bytes", "qt_model_bytes"):
        getattr(handle, name).argtypes = []
        getattr(handle, name).restype = _I64
    handle.qt_model_symbol.argtypes = [_P, ctypes.c_uint32]
    handle.qt_model_symbol.restype = ctypes.c_int
    handle.qt_rescale.argtypes = [_P]
    handle.qt_rescale.restype = None
    handle.qt_renorm.argtypes = [_P, _P, _P, _P, _I64, _P]
    handle.qt_renorm.restype = None
    return handle


def host_twin_copy():
    """P3's block-parallel resolve, its threads one after another:
    ``pc_resolve_host(seed, tok, nt, lit, out, sc, n, rounds)``, as
    ``msp_p3_copy_par`` (host pointers), with the jumping rounds it took."""
    handle = _twin("probes_copy_core.cuh", "PROBES_COPY_CORE_HOST_TWIN",
                   ["stream_core.cuh"])
    handle.pc_resolve_host.argtypes = [_P, _P, _I, _P, _P, _P, _I, _P]
    handle.pc_resolve_host.restype = ctypes.c_int
    return handle


def host_twin_vec():
    """P1's warp-ballot search over rows in registers, the warp's 32
    threads emulated: ``pv_search_host(miss, L, steps, out)``."""
    handle = _twin("probes_vec.cuh", "PROBES_VEC_HOST_TWIN",
                   ["stream_core.cuh"])
    handle.pv_search_host.argtypes = [_I, _I, _I, _P]
    handle.pv_search_host.restype = ctypes.c_int
    return handle


def host_twin_gather():
    """P5's redesigns of the gathers and the symbol step, a cluster's
    blocks and a block's threads one after another: ``pg_dyngather_host(t,
    idx, out, H, L, S)`` (-1 where a cluster of S blocks cannot hold a
    tile), ``pg_cluster_size_host(H, L, sms)`` (the S the kernel launches
    on ``sms`` SMs, 0 for none), ``pg_dyngather_row_host(t, idx, out, H,
    L)`` (-1 where a row is wider than a block stages),
    ``pg_len_find_host(peek, limit, n, length, code)`` and
    ``pg_symbol_host(meta, limit, words, out, L, T)``, as
    ``msp_p5_dyngather_cluster``, ``msp_p5_dyngather_row`` and
    ``msp_p5_symbol_smem`` (host pointers)."""
    handle = _twin("probes_gather_core.cuh", "PROBES_GATHER_CORE_HOST_TWIN",
                   ["stream_core.cuh"])
    handle.pg_dyngather_host.argtypes = [_P, _P, _P, _I, _I, _I]
    handle.pg_dyngather_host.restype = ctypes.c_int
    handle.pg_cluster_size_host.argtypes = [_I, _I, _I]
    handle.pg_cluster_size_host.restype = ctypes.c_int
    handle.pg_dyngather_row_host.argtypes = [_P, _P, _P, _I, _I]
    handle.pg_dyngather_row_host.restype = ctypes.c_int
    handle.pg_len_find_host.argtypes = [_P, _P, _I, _P, _P]
    handle.pg_len_find_host.restype = None
    handle.pg_symbol_host.argtypes = [_P, _P, _P, _P, _I, _I]
    handle.pg_symbol_host.restype = None
    return handle


def host_twin_gather2():
    """P6's two redesigns and P5's mask-sum on the same core, a block's
    threads one after another: ``pg2_masksum_host(tab, idx, out, N, L)``,
    ``pg2_masksum_p5_host`` (the same arguments) and
    ``pg2_symbol_host(meta, limit, words, x, out, L, T)``, as
    ``msp_p6_masksum_vec``, ``msp_p5_masksum_vec`` and
    ``msp_p6_symbol_smem`` (host pointers), and ``pg2_len_find_host(peek,
    limit, n, length, row)``, the symbol step's early-exit length find
    and the meta row it picks."""
    handle = _twin("probes_gather2_core.cuh", "PROBES_GATHER2_CORE_HOST_TWIN",
                   ["probes_gather_core.cuh", "stream_core.cuh"])
    handle.pg2_masksum_host.argtypes = [_P, _P, _P, _I, _I]
    handle.pg2_masksum_host.restype = None
    handle.pg2_masksum_p5_host.argtypes = [_P, _P, _P, _I, _I]
    handle.pg2_masksum_p5_host.restype = None
    handle.pg2_len_find_host.argtypes = [_P, _P, _I, _P, _P]
    handle.pg2_len_find_host.restype = None
    handle.pg2_symbol_host.argtypes = [_P, _P, _P, _P, _P, _I, _I]
    handle.pg2_symbol_host.restype = None
    return handle


def host_twin_mosaic():
    """P4's nine redesigned probes, the block's threads one after
    another: ``pm_probe_host(which, x, sm, stride, out)`` as
    ``msp_p4_probe_vec`` (host pointers; -1 for an unknown probe)."""
    handle = _twin("probes_mosaic_core.cuh", "PROBES_MOSAIC_CORE_HOST_TWIN",
                   ["probes_gather_core.cuh", "stream_core.cuh"])
    handle.pm_probe_host.argtypes = [_I, _P, _P, _I64, _P]
    handle.pm_probe_host.restype = ctypes.c_int
    return handle


def host_twin_skel():
    """P2's redesign, its blocks one after another: ``ps_skel_host(stream,
    W, seed, L, T, G, WIN, out, cnt)`` as ``msp_p2_skel_vec`` (host
    pointers), ``ps_skel_cover_host(..., hits)``, the same grid with each
    store of out tallied into hits (256, L): a decode block's sets 0x100,
    a zero block's adds 1, and ``ps_grid_host(L, T, blocks)``, the decode
    and zero blocks the kernel launches."""
    handle = _twin("probes_skel_core.cuh", "PROBES_SKEL_CORE_HOST_TWIN",
                   ["probes_gather_core.cuh", "stream_core.cuh"])
    args = _SIGNATURES["msp_p2_skel_vec"][:-1]
    handle.ps_skel_host.argtypes = args
    handle.ps_skel_host.restype = None
    handle.ps_skel_cover_host.argtypes = args + [_P]
    handle.ps_skel_cover_host.restype = None
    handle.ps_grid_host.argtypes = [_I, _I, _P]
    handle.ps_grid_host.restype = None
    return handle


def launch_info(entry: str, *args) -> dict:
    """A kernel's launch resources from the runtime (``csrc/
    launch_info.cuh``): ``lib().<entry>(*args, out)``. Returns
    ``{"blocks_per_sm", "regs", "static_smem", "dynamic_smem",
    "local_bytes"}``; raises on a CUDA error."""
    out = (ctypes.c_int * 5)()
    check(getattr(lib(), entry)(*args, out), entry)
    return dict(zip(("blocks_per_sm", "regs", "static_smem",
                     "dynamic_smem", "local_bytes"), out))


def check(rc: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error code."""
    if rc != 0:
        msg = _lib.msp_cuda_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} at launch: {msg}")
