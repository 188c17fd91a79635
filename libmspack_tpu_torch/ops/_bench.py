"""What the kernels' bench entries share.

``bench_entry`` of ``cuda_inflate`` (K1), ``cuda_resolve`` (K2),
``cuda_lzx`` (K3) and ``cuda_qtm`` (K4) port the JAX package's chip
benchmarks (``tools/bench_kernels.py:21-79``, ``pallas_resolve.py:262``,
``pallas_lzx.py:1313``, ``pallas_qtm.py:914``): the same inputs, cut from
``utils.bench_corpus``, the same keys. Each entry checks every lane's
counts, replays three lanes (0, n/2, n-1) into bytes, and holds those
lanes to the kernel's plain version run on CPU copies of the same inputs.

Times: ``ms`` is device-resident, the mean over ``reps`` launches of one
set of inputs already on the card, between two CUDA events (the closing
one synchronised before ``elapsed_time``); each launch's outputs are freed
before the next, so the caching allocator hands one set of buffers round.
``mb_per_s_with_upload`` is the host clock around the packing, the upload,
the launch and the pull of the counts, mean over ``reps``. On the CPU both
are the plain version's host time, and ``device`` says so.
"""
from __future__ import annotations

import hashlib
import math
import os
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from ..utils import bench_corpus


def chunks(n: int, kb: int) -> list[bytes]:
    """``n`` chunks of ``kb`` KiB of the bench corpus, as every JAX entry
    cuts them (``tools/bench_kernels.py:27-33``)."""
    base = bench_corpus(1 << 20)
    base = base * (1 + (kb * 1024 * n) // len(base))
    return [base[i * kb * 1024:(i + 1) * kb * 1024] for i in range(n)]


def sampled(n: int) -> list[int]:
    """The lanes replayed into bytes: 0, n/2 and n-1."""
    return sorted({0, n // 2, n - 1})


def encoded(kind: str, datas: list[bytes], encode, cache_dir=None):
    """``encode(d)`` of every chunk, on threads (the native encoders leave
    the GIL). With ``cache_dir`` the streams are kept there, in a file
    named by ``kind``, the chunks and the native engine's source, and read
    back on the next call."""
    if cache_dir is None:
        return _encode_all(datas, encode)
    from .. import kernels, native
    h = hashlib.sha256(kind.encode())
    h.update(kernels.source_tag([native._SRC]).encode())
    for d in datas:
        h.update(hashlib.sha256(d).digest())
    path = os.path.join(cache_dir, f"torch_streams_{kind}_"
                                   f"{h.hexdigest()[:16]}.npz")
    if os.path.exists(path):
        with np.load(path, allow_pickle=False) as z:
            blob, offs = z["blob"], z["offs"]
        return [blob[offs[i]:offs[i + 1]].tobytes()
                for i in range(len(offs) - 1)]
    streams = _encode_all(datas, encode)
    offs = np.zeros(len(streams) + 1, np.int64)
    np.cumsum([len(s) for s in streams], out=offs[1:])
    os.makedirs(cache_dir, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp.npz"
    np.savez(tmp, blob=np.frombuffer(b"".join(streams), np.uint8),
             offs=offs)
    os.replace(tmp, path)
    return streams


def _encode_all(datas, encode):
    with ThreadPoolExecutor(min(32, os.cpu_count() or 1)) as pool:
        return list(pool.map(encode, datas))


def device_name(dev: torch.device) -> str:
    if dev.type == "cuda":
        return torch.cuda.get_device_name(dev)
    return "cpu (plain version, host clock)"


def reset_peak(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)


def peak(dev: torch.device):
    """``torch.cuda.max_memory_allocated`` since ``reset_peak``; None on
    the CPU."""
    return torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" \
        else None


def device_ms(fn, dev: torch.device, reps: int) -> float:
    """Mean ms of ``reps`` calls of ``fn`` (inputs already on ``dev``)."""
    if dev.type == "cuda":
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        b.synchronize()
        return a.elapsed_time(b) / reps
    return host_ms(fn, reps)


def host_ms(fn, reps: int) -> float:
    """Mean host ms of ``reps`` calls of ``fn``, which ends in a pull."""
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t0) * 1e3 / reps


def launch_line(dev: torch.device, grid: int, block: int, info: dict):
    """The launch configuration of a kernel (``kernels.launch_info``'s
    resources) at ``grid`` blocks of ``block`` threads: shared memory per
    block, blocks resident per SM, SMs and waves. None on the CPU."""
    if dev.type != "cuda":
        return None
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    per = info["blocks_per_sm"]
    return {"grid": grid, "block": block,
            "smem_bytes": info["static_smem"] + info["dynamic_smem"],
            "regs": info["regs"], "local_bytes": info["local_bytes"],
            "blocks_per_sm": per, "sms": sms,
            "waves": math.ceil(grid / (per * sms)) if per else None}


def result(kernel: str, replaces: str, config: str, dev, total: int,
           ms: float, reps: int, **rest) -> dict:
    """An entry's dict: the JAX entry's ``kernel``, ``config``,
    ``bytes_out``, ``ms`` and ``mb_per_s``, the TPU kernel it replaces,
    what it ran on, and ``rest``."""
    return {"kernel": kernel, "replaces": replaces, "config": config,
            "device": device_name(dev), "bytes_out": total, "ms": ms,
            "mb_per_s": total / ms / 1e3 if ms > 0 else None,
            "timing": (f"mean of {reps} launches, device-resident"
                       if dev.type == "cuda" else
                       f"mean of {reps} calls of the plain version"),
            **rest}
