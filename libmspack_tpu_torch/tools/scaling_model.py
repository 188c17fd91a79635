"""Multi-card scaling projected from one card's measured rates: the port of
``tools/scaling_model.py``.

    python -m libmspack_tpu_torch.tools.scaling_model --rates PATH
        [--link-gbps G --link-us U] [--out PATH]

``ring_projection`` and ``lanes_projection`` keep the JAX functions'
arithmetic and arguments; their parameters come from this card instead of
the JAX module's constants:

* the phase-A rates (``rates``, bytes/s by the port's kernel names,
  ``k1_inflate``, ``k3_lzx``, ``k4_qtm``): a ``bench_kernels`` output,
  given by path (``--rates``) or as a dict (``rates_from``);
* the gather rate of the ring's resolve: ``torch.gather`` elements per
  second on the card, from the axis-0 library rows of P5
  (``tools/micro_gather.py``: ``gather_rate``);
* the link's bandwidth and latency: a send/recv of ``4 * H_WIN`` bytes
  (and of 4 bytes) between two cards, measured in the same run where
  there are two (``measure_link``); otherwise ``--link-gbps`` and
  ``--link-us``, which have no default, and the output records them as
  given, not measured.

The ring (``mesh.decode_frames_ring``) moves ``ndev`` window states of
``4 * H_WIN`` bytes a pass; the LZX and Quantum lanes move nothing. The
output states no conclusion: what a run projects is in its rows.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import torch

H_WIN = 32768
NDEVS = (1, 2, 4, 8, 16, 32)


def ring_projection(rates, total_mb=256, ndevs=NDEVS, *, gather_elem_s,
                    link_bytes_s, link_lat_s):
    """``decode_frames_ring`` (MSZIP folder, frames over the ranks).

    Per device at ndev:
      t_A   = (S/ndev) / rate_A                   (phase A, no comm)
      t_res = (S/ndev) x ~2 gathers/byte / G      (root resolve and the
                                                   per-step substitute)
      t_ring= ndev x (4xH_WIN / BW + LAT)         (window handoff)
    """
    rate_a = rates["k1_inflate"]
    S = total_mb * 1e6
    rows = []
    t1 = None
    for nd in ndevs:
        t_a = (S / nd) / rate_a
        t_res = (S / nd) * 2 / gather_elem_s
        t_ring = nd * (4 * H_WIN / link_bytes_s + link_lat_s)
        t = t_a + t_res + t_ring
        if t1 is None:
            t1 = t
        rows.append({"devices": nd, "t_a_ms": round(t_a * 1e3, 2),
                     "t_resolve_ms": round(t_res * 1e3, 2),
                     "t_ring_ms": round(t_ring * 1e3, 4),
                     "mb_per_s": round(S / t / 1e6, 1)})
    # efficiency = speedup / ndev
    for r in rows:
        r["efficiency"] = round((t1 / (S / (r["mb_per_s"] * 1e6)))
                                / r["devices"], 3)
    return rows


def lanes_projection(rates, kernel, total_mb=256, ndevs=NDEVS):
    """Folder lanes (LZX / Quantum) over the ranks: no communication; the
    only loss is lane-tail imbalance, modeled as a 2% tax per doubling."""
    rate = rates[kernel]
    S = total_mb * 1e6
    rows = []
    for nd in ndevs:
        t = (S / nd) / rate * (1.02 ** (nd.bit_length() - 1))
        rows.append({"devices": nd,
                     "mb_per_s": round(S / t / 1e6, 1),
                     "efficiency": round((S / rate) / (nd * t), 3)})
    return rows


def rates_from(doc) -> dict:
    """Bytes/s by kernel name from a ``bench_kernels`` output (its JSON
    object, or a path to it)."""
    if isinstance(doc, str):
        with open(doc) as fh:
            doc = json.load(fh)
    return {e["kernel"]: e["mb_per_s"] * 1e6 for e in doc["entries"]}


def gather_rate(records) -> float:
    """``torch.gather`` elements per second on axis 0 from P5's records
    (``micro_gather.bench_gather``): the library time of its largest
    axis-0 shape."""
    best = max((r for r in records if r.kernel == "p5_dyngather_axis0"),
               key=lambda r: r.nbytes)
    h, w = (int(v) for v in best.label.strip("()").split(","))
    return h * w / (best.library_ms / 1e3)


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _link_rank(dev, sizes, iters):
    """Ranks 0 and 1: ping-pong ``iters`` messages of each size; returns
    rank 0's one-way seconds per size."""
    import torch.distributed as dist

    out = {}
    for size in sizes:
        buf = torch.zeros(size, dtype=torch.uint8, device=dev)
        for k in range(iters + 1):
            if k == 1:   # the first exchange sets up the connection
                _sync(dev)
                t0 = time.perf_counter()
            if dist.get_rank() == 0:
                dist.send(buf, 1)
                dist.recv(buf, 1)
            else:
                dist.recv(buf, 0)
                dist.send(buf, 0)
        _sync(dev)
        out[size] = (time.perf_counter() - t0) / (2 * iters)
    return out


def measure_link(iters=200, device="cuda") -> dict:
    """A send/recv between two ranks: the one-way time of 4 bytes (the
    latency) and of ``4 * H_WIN`` bytes; the bandwidth is the second
    message's bytes over the difference. On the card, two cards on NCCL
    (it needs two); ``device="cpu"`` runs two gloo ranks (a rehearsal)."""
    from ..entry import _build_first
    from ..parallel import multihost

    dev = torch.device(device)
    if dev.type == "cuda" and torch.cuda.device_count() < 2:
        raise RuntimeError("measure_link needs two cards")
    _build_first(dev)
    backend = "nccl" if dev.type == "cuda" else "gloo"
    small, big = 4, 4 * H_WIN
    r0, _ = multihost.spawn(_link_rank, 2, backend, dev.type,
                            args=((small, big), iters), timeout_s=300)
    lat, t_big = r0[small], r0[big]
    return {"link_bytes_s": big / max(t_big - lat, 1e-12),
            "link_lat_s": lat, "how": f"measured: {backend} send/recv "
            f"between two ranks on {dev.type}, {iters} round trips of 4 "
            f"and {big} bytes"}


def project(rates, gather_elem_s, link) -> dict:
    """The projection's JSON: parameters (each with where it came from)
    and the three paths' rows."""
    kw = dict(gather_elem_s=gather_elem_s,
              link_bytes_s=link["link_bytes_s"],
              link_lat_s=link["link_lat_s"])
    return {
        "method": ("derived from one card's measured rates; see "
                   "libmspack_tpu_torch/tools/scaling_model.py for the "
                   "arithmetic"),
        "parameters": {"rates_B_s": rates, "gather_elem_s": gather_elem_s,
                       "link_bytes_s": link["link_bytes_s"],
                       "link_lat_s": link["link_lat_s"],
                       "link": link["how"]},
        "mszip_ring": ring_projection(rates, **kw),
        "lzx_lanes": lanes_projection(rates, "k3_lzx"),
        "qtm_lanes": lanes_projection(rates, "k4_qtm"),
    }


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(prog="scaling_model")
    ap.add_argument("--rates", required=True,
                    help="a bench_kernels output (JSON file)")
    ap.add_argument("--link-gbps", type=float,
                    help="link GB/s, where there is no second card")
    ap.add_argument("--link-us", type=float,
                    help="link latency in microseconds, likewise")
    ap.add_argument("--out", help="also write the JSON object there")
    args = ap.parse_args(argv)
    rates = rates_from(args.rates)
    if torch.cuda.device_count() >= 2:
        link = measure_link()
    elif args.link_gbps is None or args.link_us is None:
        ap.error("one card: give --link-gbps and --link-us")
    else:
        link = given_link(args.link_gbps, args.link_us)
    from . import micro_gather
    gather = gather_rate(micro_gather.bench_gather(torch.device("cuda")))
    doc = project(rates, gather, link)
    print(json.dumps(doc))
    if args.out:
        with open(args.out, "w") as fh:
            json.dump(doc, fh, indent=1)
    return doc


def given_link(gbps: float, us: float) -> dict:
    """Link parameters as given by the caller, not measured."""
    return {"link_bytes_s": gbps * 1e9, "link_lat_s": us * 1e-6,
            "how": f"given, not measured: {gbps} GB/s, {us} us"}


if __name__ == "__main__":
    main(sys.argv[1:])
