"""Entry points: a one-device forward step and a multi-device dry run.

PyTorch counterpart of the JAX package's ``__graft_entry__.py``:

``entry(device)``       -> (fn, example_args): a plain function on tensors,
                           the speculative DEFLATE phase A of
                           ``ops/inflate.py`` on a batch of real frames.
``dryrun_multichip(n)`` -> spawns an ``n``-rank process group and decodes
                           the three cases of the JAX package's dry run
                           over it (``parallel/mesh.py``): a 6-folder
                           cabinet (MSZIP ring on K1, LZX lanes on K3,
                           Quantum on K4, a raw folder), an LZX folder
                           beyond ``LZX_MESH_CAP`` in K3 segments, and a
                           CHM's section 1 on K3 lanes; each bit-exact.
``multihost_dryrun(n)`` -> ``parallel/multihost.decode_cab_multihost`` of
                           a 4-codec cabinet over ``n`` ranks.

Both dry runs take ``backend`` and ``device``: NCCL between cards, gloo on
the CPU or for several ranks on one card (``multihost.spawn``). On a card
each rank runs under ``ops/shadow.active()``: every K1, K3 and K4 launch
is held to the kernel's plain version on the same inputs, and the largest
difference is returned by kernel.
"""
from __future__ import annotations

import random
import time

import numpy as np
import torch

from ._device import resolve_device
from .parallel import multihost

__all__ = ["entry", "dryrun_multichip", "multihost_dryrun",
           "dryrun_cases"]


def _example_batch(n_frames: int, s_bucket: int):
    """A deterministic batch of real deflate frames and their LUTs:
    (bytes (n_frames, S) uint8, start bits, literal LUTs, distance LUTs),
    numpy."""
    from .compress import mszip_c
    from .ops import inflate as ti

    rng = np.random.RandomState(42)
    payload = (b"graft entry example data! " * 64
               + rng.randint(0, 256, 256, dtype=np.uint8).tobytes())
    data = (payload * 64)[: n_frames * 4096]
    frames = [f[2:] for f in mszip_c.compress_frames(data)]
    frames = (frames * n_frames)[:n_frames]

    S = s_bucket
    buf = np.zeros((n_frames, S), np.uint8)
    luts_l = np.zeros((n_frames, 1 << 15), np.int32)
    luts_d = np.zeros((n_frames, 1 << 15), np.int32)
    starts = np.zeros(n_frames, np.int32)
    for i, f in enumerate(frames):
        buf[i, : len(f)] = np.frombuffer(f, np.uint8)
        last, kind, lut_l, lut_d, start = ti._parse_block_header(f, 0)
        if kind != "huff" or not last:
            raise ValueError("example frame is not one huffman block")
        luts_l[i], luts_d[i], starts[i] = lut_l, lut_d, start
    return buf, starts, luts_l, luts_d


def entry(device="cuda"):
    """One device's forward step and its example arguments on ``device``:
    ``fn(data_flat, starts, lit_luts, dist_luts)`` returns each frame's
    decoded length and end bit position."""
    from .ops import inflate as ti

    S = 1024
    B = 4
    buf, starts, luts_l, luts_d = _example_batch(B, S)

    def forward(data_flat, starts, lit_luts, dist_luts):
        t_kind, t_outlen, _d, _l, end_pos, _inv, _reached = ti._phase_a(
            data_flat, starts, lit_luts, dist_luts, S * 8, ti.MAX_TOKENS, S)
        live = (t_kind == 0) | (t_kind == 1)
        return torch.where(live, t_outlen, 0).sum(dim=1), end_pos

    dev = resolve_device(device)
    args = tuple(torch.from_numpy(a).to(dev)
                 for a in (buf.reshape(-1), starts, luts_l, luts_d))
    return forward, args


def _encode_lzx(datas, window_bits=16):
    from . import native
    streams = [native.lzx_encode(d, window_bits, 0)[0] for d in datas]
    return streams, [len(d) for d in datas]


def dryrun_cases():
    """The dry run's inputs, as the JAX package's ``dryrun_multichip``
    builds them: ``{"cab": (cabinet, {name: bytes}), "lzx_big": (stream,
    bytes), "chm": (chm, html)}``."""
    from .compress import cab_c, chm_c
    from .parallel import mesh as pmesh

    rng = random.Random(1222)
    text = (b"multi chip dry run payload: folders are the shard grid "
            b"rows, frames the dp axis. " * 40)
    folders = []
    expects = {}
    for k, comp in enumerate(["mszip", "mszip", "lzx", "lzx", "quantum"]):
        blob = (text + bytes(rng.randrange(256) for _ in range(512))) \
            * (2 + k)
        name = f"{comp}{k}.bin"
        folders.append(cab_c.FolderSpec([(name, blob)], comp))
        expects[name] = blob
    raw = bytes(rng.randrange(256) for _ in range(3000))
    folders.append(cab_c.FolderSpec([("raw.bin", raw)], "none"))
    expects["raw.bin"] = raw
    cab_bytes = cab_c.write_cab(folders=folders)

    # an LZX folder BEYOND the single-launch mesh budget: K3 segments
    big = (text + bytes(rng.randrange(256) for _ in range(256))) * 44
    if len(big) <= pmesh.LZX_MESH_CAP:
        raise AssertionError("the big LZX case fits one launch")
    (big_stream,), _ = _encode_lzx([big])

    # a CHM: the ResetTable shards section 1 onto K3 lanes
    words = [bytes(rng.choices(b"abcdef the of and <p>",
                               k=rng.randrange(3, 11)))
             for _ in range(50)]
    html = b"".join(rng.choice(words) for _ in range(40_000))[:96_000]
    chm_bytes = chm_c.write_chm([("big.html", html)], window_bits=16,
                                reset_frames=1)
    return {"cab": (cab_bytes, expects), "lzx_big": (big_stream, big),
            "chm": (chm_bytes, html)}


_KERNELS = ("cuda_inflate", "cuda_lzx", "cuda_qtm")


def _build_first(dev):
    """Build the host engine (and on a card the kernels) in this process,
    before spawned ranks would race to build them."""
    from . import kernels, native
    native.lib()
    if dev.type == "cuda":
        kernels.lib()


def _launches():
    from .ops import cuda_inflate, cuda_lzx, cuda_qtm
    return {name: dict(m.LAUNCHES) for name, m in
            zip(_KERNELS, (cuda_inflate, cuda_lzx, cuda_qtm))}


def _merge_errs(into: dict, errs: dict) -> dict:
    for k, v in errs.items():
        into[k] = max(into.get(k, 0), v)
    return into


def _dryrun_rank(dev, cases):
    """One rank of ``dryrun_multichip``: each case decoded collectively;
    returns {case: (bit-exact, seconds)}, the rank's kernel launches by
    key ("cuda" or "plain"), its mesh declines and its launches' largest
    differences from the plain versions."""
    from .ops import shadow
    from .parallel import mesh as pmesh

    mesh = pmesh.default_mesh(device=dev)
    got = {}

    def timed(name, fn, want):
        t0 = time.perf_counter()
        out = fn()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        got[name] = (out == want, time.perf_counter() - t0)

    cab_bytes, expects = cases["cab"]
    big_stream, big = cases["lzx_big"]
    chm_bytes, html = cases["chm"]
    with shadow.active() as errs:
        timed("cab", lambda: pmesh.decode_cab_sharded(mesh, cab_bytes),
              expects)
        timed("lzx_big", lambda: pmesh.decode_lzx_streams_sharded(
            mesh, [big_stream], [len(big)], 16), [big])
        timed("chm", lambda: (pmesh.decode_chm_sharded(mesh, chm_bytes)
                              or {}).get("big.html"), html)
    return {"cases": got, "launches": _launches(),
            "declines": dict(mesh.declines), "max_abs_err": dict(errs)}


def dryrun_multichip(n_devices: int, backend: str | None = None,
                     device="cuda", timeout_s: float = 600.0) -> dict:
    """Decode the dry run's three cases over an ``n_devices``-rank group
    (``multihost.spawn``) and check each is bit-exact on every rank.
    ``backend``: NCCL when every rank has a card of its own, gloo
    otherwise (the default). Prints one line a case and returns
    ``{"cases": {case: max seconds over ranks}, "launches": {kernel:
    {key: launches summed over ranks}}, "declines": {reason: count},
    "max_abs_err": {kernel: largest difference from its plain version,
    on a card}}``; raises ``AssertionError`` where a case is not
    bit-exact."""
    dev = resolve_device(device)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" and \
            n_devices <= torch.cuda.device_count() else "gloo"
    _build_first(dev)
    cases = dryrun_cases()
    ranks = multihost.spawn(_dryrun_rank, n_devices, backend, dev.type,
                            args=(cases,), timeout_s=timeout_s)
    summary = {"cases": {}, "launches": {}, "declines": {},
               "max_abs_err": {}}
    for name in ranks[0]["cases"]:
        bad = [r for r, res in enumerate(ranks) if not res["cases"][name][0]]
        if bad:
            raise AssertionError(f"dryrun_multichip({n_devices}): {name} "
                                 f"not bit-exact on ranks {bad}")
        summary["cases"][name] = max(res["cases"][name][1] for res in ranks)
    for res in ranks:
        for k, counts in res["launches"].items():
            tot = summary["launches"].setdefault(k, {})
            for key, v in counts.items():
                tot[key] = tot.get(key, 0) + v
        for reason, v in res["declines"].items():
            summary["declines"][reason] = summary["declines"].get(reason, 0) + v
        _merge_errs(summary["max_abs_err"], res["max_abs_err"])
    from .parallel import mesh as pmesh

    cab_bytes, expects = cases["cab"]
    where = f"over {n_devices} {backend} ranks on {dev.type}"
    print(f"dryrun_multichip({n_devices}): 6-folder cab "
          f"({sum(len(v) for v in expects.values())} bytes, mszip ring + "
          f"lzx lanes + quantum + raw) bit-exact {where}")
    print(f"dryrun_multichip({n_devices}): {len(cases['lzx_big'][1])}-byte "
          f"LZX folder (> {pmesh.LZX_MESH_CAP} single-launch cap) bit-exact "
          f"via "
          f"K3 segments {where}")
    print(f"dryrun_multichip({n_devices}): CHM section 1 "
          f"({len(cases['chm'][1])} bytes, ResetTable chunk grid) "
          f"bit-exact on K3 lanes {where}")
    return summary


def multihost_cab():
    """A 4-codec cabinet (the JAX package's ``tools/multihost_dryrun.py``)
    and its members."""
    from .compress import cab_c

    rng = random.Random(404)
    text = b"multihost scatter/gather payload " * 80
    folders, expects = [], {}
    for k, comp in enumerate(["mszip", "lzx", "quantum", "none"]):
        blob = (text + bytes(rng.randrange(256) for _ in range(256))) \
            * (2 + k)
        folders.append(cab_c.FolderSpec([(f"{comp}{k}.bin", blob)], comp))
        expects[f"{comp}{k}.bin"] = blob
    return cab_c.write_cab(folders=folders), expects


def _multihost_rank(dev, cab_bytes, engine):
    from .ops import shadow

    t0 = time.perf_counter()
    with shadow.active() as errs:
        out = multihost.decode_cab_multihost(cab_bytes, engine=engine,
                                             device=dev)
    return out, time.perf_counter() - t0, _launches(), dict(errs)


def multihost_dryrun(n: int = 2, backend: str = "gloo", device="cuda",
                     engine: str = "cuda", timeout_s: float = 600.0) -> dict:
    """``decode_cab_multihost`` of ``multihost_cab()`` over ``n`` ranks:
    every rank must return the whole member set, bit-exact. Returns
    {"seconds": max over ranks, "launches": {kernel: {key: launches summed
    over ranks}}, "max_abs_err": {kernel: largest difference from its
    plain version, on a card}}."""
    dev = resolve_device(device)
    _build_first(dev)
    cab_bytes, expects = multihost_cab()
    ranks = multihost.spawn(_multihost_rank, n, backend, dev.type,
                            args=(cab_bytes, engine), timeout_s=timeout_s)
    bad = [r for r, (out, *_) in enumerate(ranks) if out != expects]
    if bad:
        raise AssertionError(f"multihost_dryrun({n}): ranks {bad} differ")
    print(f"multihost_dryrun({n}): {len(expects)} files bit-exact on every "
          f"one of {n} {backend} ranks ({engine} on {dev.type})")
    launches, errs = {}, {}
    for _, _, lc, e in ranks:
        for k, counts in lc.items():
            tot = launches.setdefault(k, {})
            for key, v in counts.items():
                tot[key] = tot.get(key, 0) + v
        _merge_errs(errs, e)
    return {"seconds": max(s for _, s, _, _ in ranks),
            "launches": launches, "max_abs_err": errs}
