"""The slice's Quantum half: CAB Quantum folders through the port's driver
and ``CudaQtmEngine``.

Cabinets come from the JAX package's writer. The port's ``engine="cuda"``
runs here with ``device="cpu"``, i.e. on K4's plain version, and is held to
``libmspack_tpu``'s ``engine="scalar"`` (the reference codec): equal bytes
on several folders and files at windows 2^10 and 2^16, and an error class
of the same name on a corrupt folder. The engine's segmented decode is held
to its one-launch decode, and its declines are counted by reason.
"""
import numpy as np
import pytest

from libmspack_tpu.compress import cab_c
from libmspack_tpu.errors import MSPackError as JaxMSPackError
from libmspack_tpu.formats.cab import CabDecompressor as JaxCabDecompressor
from libmspack_tpu.system import BytesSink as JaxBytesSink

import libmspack_tpu_torch as lt
from libmspack_tpu_torch import qtm_edge_cases as qe
from libmspack_tpu_torch.ops import cuda_qtm as cq
from libmspack_tpu_torch.parallel.cuda_pipeline import CudaQtmEngine
from libmspack_tpu_torch.system import BytesSink


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


def _files(prefix, text, sizes):
    out, o = [], 0
    for i, n in enumerate(sizes):
        out.append((f"{prefix}{i}.txt", text[o:o + n]))
        o += n
    return out


def test_cab_quantum_matches_scalar():
    text = qe.in_repo_text(120_000)
    rng = np.random.RandomState(1)
    noise = bytes(rng.randint(0, 256, 3000, np.uint8))
    blob = cab_c.write_cab(folders=[
        cab_c.FolderSpec(_files("w10_", text, [700, 737, 774, 811, 848]),
                         "quantum", 10),
        cab_c.FolderSpec(_files("w16_", text[5000:], [40_000, 9, 30_000])
                         + [("noise.bin", noise)], "quantum", 16),
        cab_c.FolderSpec([("m.txt", text[:20_000])], "mszip")])
    want = extract_all(JaxCabDecompressor(engine="scalar"), blob)
    assert want["w16_0.txt"] == text[5000:45_000]
    before = cq.LAUNCHES["plain"]
    d = lt.create_cab_decompressor(engine="cuda", device="cpu")
    assert extract_all(d, blob) == want
    assert cq.LAUNCHES["plain"] == before + 2     # one per Quantum folder
    eng = d.cuda_qtm_engine
    assert eng.n_decoded == 2 and not eng.declines
    assert {"upload_ms", "k4_ms", "trace_pull_ms", "host_resolve_ms",
            "total_ms"} <= set(eng.timings)


def overshoot_cab(monkeypatch):
    """A Quantum cabinet whose first block's match overshoots the frame
    end: the writer's encoder is swapped for the edge batch's stream."""
    payload = qe.overshoot_stream()[:-1]    # the reader adds the 0xFF
    monkeypatch.setattr(cab_c.qtm_e, "compress",
                        lambda data, wb: [payload, b"\0"])
    return cab_c.write_cab(files=[("x.bin", bytes(qe.FRAME + 1))],
                           compression="quantum")


def test_corrupt_quantum_folder_raises_like_scalar(monkeypatch):
    blob = overshoot_cab(monkeypatch)
    errors = []
    for d in (JaxCabDecompressor(engine="scalar"),
              lt.create_cab_decompressor(engine="cuda", device="cpu")):
        with pytest.raises((JaxMSPackError, lt.MSPackError)) as info:
            extract_all(d, blob)
        errors.append(type(info.value))
    # the port has its own copies of the error classes: same names
    assert issubclass(errors[0], JaxMSPackError)
    assert issubclass(errors[1], lt.MSPackError)
    assert errors[0].__name__ == errors[1].__name__ == "DecrunchError"
    assert d.cuda_qtm_engine.declines == {"flagged lane": 1}


def _valid(wb):
    cases = qe.qtm_edge_batch(seed=0)
    return [cases[i] for i in qe.groups(cases)[wb]
            if cases[i].raw is not None]


@pytest.mark.parametrize("wb", [10, 16])
def test_engine_segments_equal_one_call(wb):
    sub = _valid(wb)
    args = ([c.stream for c in sub], [c.out_len for c in sub], wb)
    one = CudaQtmEngine("cpu")
    seg = CudaQtmEngine("cpu", segment_bytes=32768)
    want = one.decode_streams(*args)
    assert want == [c.raw for c in sub]
    assert seg.decode_streams(*args) == want
    assert not one.declines and not seg.declines
    assert one.lanes == seg.lanes == len(sub)
    for a, b in zip(one.wrap_spans, seg.wrap_spans):
        assert np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])


def test_engine_batches_within_the_trace_budget():
    sub = _valid(16)
    eng = CudaQtmEngine("cpu")
    eng.TRACE_BUDGET = 8 * 140_000   # one lane of 131072 bytes per launch
    before = cq.LAUNCHES["plain"]
    outs = eng.decode_streams([c.stream for c in sub],
                              [c.out_len for c in sub], 16)
    assert outs == [c.raw for c in sub]
    assert cq.LAUNCHES["plain"] - before == len(sub)


def test_engine_declines_flagged_lane_and_bad_window():
    cases = qe.qtm_edge_batch(seed=0)
    bad = next(c for c in cases if c.name == "truncated")
    good = next(c for c in cases if c.name == "trailer_padding")
    eng = CudaQtmEngine("cpu")
    assert eng.decode_streams([good.stream, bad.stream],
                              [good.out_len, bad.out_len], 16) is None
    assert eng.decode_streams([good.stream], [good.out_len], 22) is None
    assert eng.declines == {"flagged lane": 1,
                            "window size outside Quantum's": 1}
    with pytest.raises(ValueError):
        CudaQtmEngine("cpu", segment_bytes=1000)
