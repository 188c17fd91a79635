"""Multi-process decode: corpus scatter and result gather over ranks.

PyTorch counterpart of ``libmspack_tpu/parallel/multihost.py``. The
reference is a single-process C library; multi-host operation is the
framework's own design (SURVEY.md §5.8):

* ``initialize()`` brings up ``torch.distributed`` with an explicit
  backend, address, world size and rank: one process per host, per GPU,
  or several on one card or CPU (gloo).
* Corpus scatter: independent decode units (CAB folders, the grid every
  other parallel axis uses) go round-robin to the ranks; each rank decodes
  only its share, with its own driver on its own device.
* Result gather: the decoded folder buffers, padded to one length, are
  all-gathered (the JAX module's ``process_allgather``), so every rank
  assembles the complete member set.

``spawn`` starts a group of local processes for a function (the tests,
``entry.dryrun_multichip`` and ``chip_smoke.py`` use it); ``mesh_calls``
is such a function, calling functions of ``parallel/mesh.py`` on every
rank.
"""
from __future__ import annotations

import datetime
import multiprocessing
import os
import queue
import tempfile
import traceback

import numpy as np
import torch
import torch.distributed as dist

from .._device import DEVICE_ENGINES
from .mesh import Mesh, all_gather

__all__ = ["initialize", "decode_cab_multihost", "spawn", "mesh_calls"]


def initialize(coordinator_address: str, num_processes: int,
               process_id: int, backend: str = "gloo",
               timeout_s: float = 600.0) -> None:
    """Join the process group (idempotent). ``coordinator_address`` is
    ``host:port`` (rank 0 listens there) or any ``init_method`` URL
    (``tcp://...``, ``file://...``)."""
    if dist.is_initialized():
        return
    url = coordinator_address if "://" in coordinator_address \
        else f"tcp://{coordinator_address}"
    dist.init_process_group(backend, init_method=url,
                            world_size=num_processes, rank=process_id,
                            timeout=datetime.timedelta(seconds=timeout_s))


def decode_cab_multihost(path_or_bytes, engine: str = "cuda",
                         device="cuda") -> dict | None:
    """Decode a cabinet across the ranks of the default process group.

    Every rank parses the (KB-sized) container; folder i is decoded by rank
    i % size through ``create_cab_decompressor(engine, device)``; the folder
    bytes are all-gathered so each rank returns the full {filename: bytes}
    map. None where a folder is not decoded by any rank."""
    from ..formats.cab import CabDecompressor
    from ..system import BytesSink

    mesh = Mesh(None, device if engine in DEVICE_ENGINES else "cpu")
    d = CabDecompressor(engine=engine, device=device)
    cab = d.open(path_or_bytes)
    nf = len(cab.folders)

    def folder_of(f):
        return next(i for i, fol in enumerate(cab.folders) if fol is f.folder)

    # folder extents = the span its member files cover (the container does
    # not record a folder's total uncompressed size)
    sizes = np.zeros(nf, np.int64)
    for f in cab.files:
        fi = folder_of(f)
        sizes[fi] = max(sizes[fi], f.offset + f.length)

    maxlen = int(sizes.max()) if nf else 0
    local = np.zeros((nf, maxlen), np.uint8)
    owned = np.zeros(nf, np.int64)
    for fi, fol in enumerate(cab.folders):
        if fi % mesh.size != mesh.rank:
            continue
        for f in cab.files:
            if f.folder is fol:
                s = BytesSink()
                d.extract(f, s)
                local[fi, f.offset:f.offset + f.length] = np.frombuffer(
                    s.getvalue(), np.uint8)
        owned[fi] = 1

    # the result gather: a dense (size, nf, maxlen) exchange
    gathered = all_gather(mesh, torch.from_numpy(local)).cpu().numpy()
    owners = all_gather(mesh, torch.from_numpy(owned)).cpu().numpy()
    out = {}
    for f in cab.files:
        fi = folder_of(f)
        owner = int(np.argmax(owners[:, fi]))
        if owners[owner, fi] == 0:
            return None
        out[f.filename] = gathered[owner, fi,
                                   f.offset:f.offset + f.length].tobytes()
    return out


def mesh_calls(dev, calls) -> list:
    """On one rank (a ``spawn`` target): each ``(name, args)`` of
    ``calls`` in turn as ``parallel.mesh.<name>(mesh, *args)`` on the
    default group as a mesh on ``dev``. Returns, per call, its result and
    the declines it counted."""
    from . import mesh as pmesh

    out = []
    for name, args in calls:
        m = pmesh.default_mesh(device=dev)
        out.append((getattr(pmesh, name)(m, *args), dict(m.declines)))
    return out


# ---------------------------------------------------------------------------
# a local process group for one function
# ---------------------------------------------------------------------------

def _rank_main(rank, world, backend, device, init, fn, args, results):
    """One spawned rank: join the group, run ``fn(device, *args)``, put
    ``(rank, error text or None, result)`` on ``results``."""
    try:
        if device == "cuda":
            dev = torch.device("cuda", rank % torch.cuda.device_count())
            torch.cuda.set_device(dev)
        else:
            dev = torch.device("cpu")
            torch.set_num_threads(1)
        dist.init_process_group(backend, init_method=init, world_size=world,
                                rank=rank,
                                timeout=datetime.timedelta(seconds=300))
        try:
            results.put((rank, None, fn(dev, *args)))
        finally:
            dist.destroy_process_group()
    except BaseException:
        results.put((rank, traceback.format_exc(), None))
        raise


def spawn(fn, world_size: int, backend: str = "gloo", device: str = "cuda",
          args: tuple = (), timeout_s: float = 600.0) -> list:
    """Run ``fn(device, *args)`` in ``world_size`` new processes that form
    a process group (``backend``, rendezvous through a file in a temporary
    directory), and return each rank's result in rank order. ``device``:
    ``"cuda"`` (the default) for rank r on card r mod the card count (so
    every rank shares one card where there is one; NCCL refuses that, gloo
    takes it), or ``"cpu"`` where the caller asks for the CPU (the tests
    do). ``fn`` and its arguments and results must pickle. Raises
    with the rank's traceback if a rank fails, and ``TimeoutError`` (after
    killing every rank) if the group does not finish in ``timeout_s``."""
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    with tempfile.TemporaryDirectory() as td:
        init = "file://" + os.path.join(td, "rendezvous")
        procs = [ctx.Process(target=_rank_main,
                             args=(r, world_size, backend, device, init, fn,
                                   args, results), daemon=True)
                 for r in range(world_size)]
        for p in procs:
            p.start()
        got, errors = {}, []
        deadline = datetime.datetime.now() + datetime.timedelta(
            seconds=timeout_s)
        try:
            # drain the queue before joining (a full pipe blocks a writer)
            while len(got) < world_size and not errors:
                if datetime.datetime.now() > deadline:
                    raise TimeoutError(f"{world_size} ranks of {fn.__name__}"
                                       f" did not finish in {timeout_s} s")
                try:
                    rank, err, res = results.get(timeout=1.0)
                except queue.Empty:
                    # a rank that died without a word (a crash)
                    dead = [r for r, p in enumerate(procs)
                            if r not in got and p.exitcode not in (None, 0)]
                    if dead:
                        errors.append(f"ranks {dead} died (exit codes "
                                      f"{[procs[r].exitcode for r in dead]})")
                    continue
                if err is not None:
                    errors.append(f"rank {rank}:\n{err}")
                got[rank] = res
            if not errors:
                for p in procs:
                    p.join(timeout=30)
        finally:
            # a rank still alive here is stuck (a peer failed, or time ran
            # out): end them all
            for p in procs:
                if p.is_alive():
                    p.kill()
            for p in procs:
                p.join(timeout=10)
    if errors:
        raise RuntimeError("a spawned rank failed:\n" + "\n".join(errors))
    return [got[r] for r in range(world_size)]
