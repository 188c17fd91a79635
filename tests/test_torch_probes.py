"""The probe tools P1-P6 of the port (libmspack_tpu_torch.tools) against the
JAX tools under tools/, on the CPU.

Each case runs the JAX tool's own Pallas kernel in interpret mode and the
port's plain version on the same numpy inputs from a seed, and asserts
equality (integers: exact). The JAX tools are loaded from tools/ with a
stand-in for their timing module ``devtime``: it records the callable a
tool would time instead of timing it (the real module also points JAX's
compilation cache at a directory). ``pl.pallas_call`` is wrapped to run
interpreted for the tools that call it bare, ``make_kernel(...,
interpret=True)`` serves micro_skel and ``MC_INTERP=1`` micro_copy.

Where a TPU kernel reads scratch it never wrote (micro_skel's windows,
stage_store's stage, dma_row's other rows; interpret mode fills them with
INT32_MIN), the port defines 0; the inputs here keep such values from the
compared output, or compare them as 0 (micro_copy's frame), and the cases
say where.
"""
import functools
import hashlib
import importlib.util
import os
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from libmspack_tpu_torch import kernels
from libmspack_tpu_torch.tools import (Work, micro_copy, micro_gather,
                                       micro_gather2, micro_skel, micro_vec,
                                       mosaic_probe, sass)

TOOLS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "tools")
SL, LN = 8, 128


class _DevTime(types.ModuleType):
    """Stands in for tools/devtime.py: ``time_chained`` records the step
    a tool would time and returns 1 s."""

    def __init__(self):
        super().__init__("devtime")
        self.steps = []

    def warmup(self):
        pass

    def time_chained(self, make_step, init, n=64, **kw):
        self.steps.append(make_step)
        return 1.0


def _closure(fn):
    """A closure's free variables by name."""
    return dict(zip(fn.__code__.co_freevars,
                    (c.cell_contents for c in fn.__closure__)))


@pytest.fixture
def jax_tool(monkeypatch):
    """load(name) -> (the JAX tool module, its devtime stand-in), with
    pallas_call interpreted."""
    monkeypatch.setattr(pl, "pallas_call",
                        functools.partial(pl.pallas_call, interpret=True))
    monkeypatch.setenv("MC_INTERP", "1")
    monkeypatch.setattr(sys, "path", [TOOLS] + sys.path)   # the tools add
    #                                                        it themselves

    def load(name):
        dt = _DevTime()
        monkeypatch.setitem(sys.modules, "devtime", dt)
        spec = importlib.util.spec_from_file_location(
            f"_jax_tool_{name}", os.path.join(TOOLS, f"{name}.py"))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod, dt
    return load


def _t(a):
    a = np.ascontiguousarray(a)
    return torch.from_numpy(a.view(np.int32) if a.dtype == np.uint32 else a)


# ---------------------------------------------------------------- P1
@pytest.mark.parametrize("variant", ["sweep", "vec"])
def test_micro_vec_matches_jax(jax_tool, monkeypatch, variant):
    mv, dt = jax_tool("micro_vec")
    shape, steps = (2, 16), 8
    monkeypatch.setattr(mv, "SL", shape[0])
    monkeypatch.setattr(mv, "LN", shape[1])
    monkeypatch.setattr(mv, "STEPS", steps)
    mv.run_variant(variant)
    want = np.asarray(dt.steps[0](jnp.zeros((1, *shape), jnp.int32)))
    got = micro_vec.search(variant, device="cpu", shape=shape, steps=steps)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.fixture(scope="module")
def vec_twin():
    try:
        return kernels.host_twin_vec()
    except RuntimeError as e:
        pytest.skip(f"g++ build of the kernel core unavailable: {e}")


@pytest.mark.parametrize("variant", ["sweep", "vec"])
@pytest.mark.parametrize("shape,steps", [((2, 16), 8), ((8, 128), 64)])
def test_micro_vec_registers_twin(vec_twin, variant, shape, steps):
    """The warp-ballot step (probes_vec.cuh), its 32 threads emulated,
    equals search_plain for both variants, the steps where no row
    matches included (each variant's own miss value: the variants differ
    only there, so they differ only if such steps occur)."""
    assert not torch.equal(micro_vec.search_plain("sweep", shape, steps),
                           micro_vec.search_plain("vec", shape, steps))
    L = shape[0] * shape[1]
    out = np.zeros(L, np.int32)
    miss = 0 if variant == "sweep" else -1
    assert vec_twin.pv_search_host(miss, L, steps, out.ctypes.data) == 0
    want = micro_vec.search_plain(variant, shape, steps)
    np.testing.assert_array_equal(out, want.numpy().reshape(-1))


def test_micro_vec_per_step_on_cpu(capsys):
    """main() times every kernel at 0, 64 and 256 steps for each of its
    per-step lane counts (here the plain versions at the CPU's)."""
    micro_vec.main([], device="cpu")
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if "ns/step" in ln]
    lanes = micro_vec.PER_STEP_LANES["cpu"]
    assert len(lines) == \
        len(lanes) * len(micro_vec.VARIANTS) * len(micro_vec.TABLES)
    for n in lanes:
        assert sum(f" {n} lanes:" in ln for ln in lines) == \
            len(lines) // len(lanes)


def test_micro_vec_variants_differ_on_no_match():
    """sweep gives 0 and vec -1 where no row matches (micro_vec.py:57-59
    against :67-68), so the two functions part."""
    a = micro_vec.search("sweep", device="cpu", shape=(2, 16), steps=8)
    b = micro_vec.search("vec", device="cpu", shape=(2, 16), steps=8)
    assert not torch.equal(a, b)


# ---------------------------------------------------------------- P2
@pytest.mark.parametrize("shape,steps", [((1, 16), 8), ((2, 16), 8),
                                         ((1, 8), 12)])
def test_micro_skel_matches_jax(jax_tool, shape, steps):
    """L = 16 = G re-windows every lane each step; L = 32 leaves lanes
    16-31 unwindowed in step 0 (the TPU read uninitialised VMEM there, the
    port a zero window: both give a 0 word); L = 8 re-windows each lane
    twice a step."""
    ms, _ = jax_tool("micro_skel")
    rng = np.random.RandomState(sum(shape) + steps)
    L = shape[0] * shape[1]
    stream = rng.randint(0, 1 << 30, (L, 4096)).astype(np.uint32)
    seed = rng.randint(0, 1 << 20, shape).astype(np.int32)
    run = ms.make_kernel(*shape, steps, interpret=True)
    want = np.asarray(run(jnp.asarray(stream), jnp.asarray(seed)))
    out, cnt = micro_skel.skel(_t(stream), _t(seed), steps, device="cpu")
    np.testing.assert_array_equal(cnt.numpy(), want)
    assert out.shape == (256, *shape)


def test_micro_skel_output_ignores_the_stream():
    """The tool's mock decode never finds a key: the length find stops at
    bl = 1 (peek >> 14 <= 1 < 37), so key is 65536 or 65537, which no
    (n * 1315423911) mod 2^20 for n < 288 equals; sym is 0 and every step
    consumes 1 bit. Its outputs are the same for any stream, so they
    cannot show when a window copy becomes visible."""
    keys = {(n * 1315423911) & 0xFFFFF for n in range(288)}
    assert not keys & {65536, 65537}
    rng = np.random.RandomState(9)
    seed = _t(rng.randint(0, 1000, (2, 16)).astype(np.int32))
    outs = [micro_skel.skel(_t(rng.randint(0, 1 << 30, (32, 4096))
                               .astype(np.uint32)), seed, 40, device="cpu")
            for _ in range(2)]
    assert all(torch.equal(a, b) for a, b in zip(*outs))


def test_interpret_dma_visible_before_wait():
    """Pallas interpret mode completes an async copy when it starts, so a
    read before the wait sees the copied data: the semantics the port's
    micro_skel follows (the TPU kernel reads a window in the step that
    starts its copy, micro_skel.py:51-68)."""
    src = np.arange(SL * LN, dtype=np.int32).reshape(SL, LN)

    def kernel(hbm, o_ref, win, sem):
        cp = pltpu.make_async_copy(hbm, win, sem)
        cp.start()
        o_ref[:] = win[:]
        cp.wait()

    out = pl.pallas_call(
        kernel, out_shape=jax.ShapeDtypeStruct((SL, LN), jnp.int32),
        in_specs=[pl.BlockSpec(memory_space=pltpu.ANY)],
        scratch_shapes=[pltpu.VMEM((SL, LN), jnp.int32),
                        pltpu.SemaphoreType.DMA(())],
        interpret=True)(jnp.asarray(src))
    np.testing.assert_array_equal(np.asarray(out), src)


@pytest.fixture(scope="module")
def skel_twin():
    try:
        return kernels.host_twin_skel()
    except RuntimeError as e:
        pytest.skip(f"g++ build of the kernel core unavailable: {e}")


def _skel_inputs(L, T, seed=0):
    rng = np.random.RandomState(L + 7 * T + seed)
    stream = rng.randint(0, 1 << 30, (L, max(T + 64, 128))).astype(np.uint32)
    return stream, rng.randint(-(1 << 20), 1 << 20, L).astype(np.int32)


def _skel_twin(twin, stream, seed, T, unaligned=False, hits=None):
    """P2's redesign through its twin on numpy inputs (seed and out 4 bytes
    off 16-byte alignment where ``unaligned``: zero stores an element at a
    time); with ``hits`` (256, L) int32, its stores tallied there
    instead."""
    L, W = stream.shape
    off = 4 if unaligned else 0
    seed = _placed(seed, off)
    out = _placed(np.full((256, L), -7, np.int32), off)
    cnt = _placed(np.full(L, -7, np.int32), 0)
    args = (stream.ctypes.data, W, seed.ctypes.data, L, T, micro_skel.G,
            micro_skel.WIN, out.ctypes.data, cnt.ctypes.data)
    if hits is None:
        twin.ps_skel_host(*args)
    else:
        twin.ps_skel_cover_host(*args, hits.ctypes.data)
    return out, cnt


@pytest.mark.parametrize("L", [8, 16, 32, 100])
@pytest.mark.parametrize("T", [0, 8, 256, 300])
def test_skel_vec_twin(skel_twin, L, T):
    """The redesign's twin equals skel_plain: L = 8 re-windows each lane
    twice a step, 16 = G all once, 32 half, 100 is L % 4 != 0 (zero stores
    an element at a time); T = 0 zeroes every row, 256 writes every row,
    300 overwrites rows 0-43."""
    stream, seed = _skel_inputs(L, T)
    out, cnt = _skel_twin(skel_twin, stream, seed, T)
    want_out, want_cnt = micro_skel.skel_plain(_t(stream), _t(seed), T)
    np.testing.assert_array_equal(out, want_out.numpy())
    np.testing.assert_array_equal(cnt, want_cnt.numpy())


def test_skel_vec_twin_unaligned(skel_twin):
    """Seed and out 4 bytes off 16-byte alignment, which sends the zero
    blocks to element stores at L = 32, give the same rows as the 16-byte
    path."""
    stream, seed = _skel_inputs(32, 40)
    a = _skel_twin(skel_twin, stream, seed, 40)
    b = _skel_twin(skel_twin, stream, seed, 40, unaligned=True)
    want_out, want_cnt = micro_skel.skel_plain(_t(stream), _t(seed), 40)
    for out, cnt in (a, b):
        np.testing.assert_array_equal(out, want_out.numpy())
        np.testing.assert_array_equal(cnt, want_cnt.numpy())


def test_skel_vec_twin_matches_jax(jax_tool, skel_twin):
    """The twin's counts at (2, 16), T = 8, against the JAX tool's kernel
    (make_kernel, interpret mode)."""
    ms, _ = jax_tool("micro_skel")
    rng = np.random.RandomState(26)
    stream = rng.randint(0, 1 << 30, (32, 4096)).astype(np.uint32)
    seed = rng.randint(0, 1 << 20, (2, 16)).astype(np.int32)
    want = np.asarray(ms.make_kernel(2, 16, 8, interpret=True)(
        jnp.asarray(stream), jnp.asarray(seed)))
    _, cnt = _skel_twin(skel_twin, stream, seed.ravel(), 8)
    np.testing.assert_array_equal(cnt.reshape(2, 16), want)


@pytest.mark.parametrize("T", [0, 8, 64, 255, 256, 300])
@pytest.mark.parametrize("L", [100, 256])
def test_skel_vec_covers_each_row_once(skel_twin, L, T):
    """The decode blocks write the rows t mod 256 (t < T) and the zero
    blocks the rows [min(T, 256), 256), each element of the latter once:
    every element of out is written by exactly one kind of block, so the
    wrapper's torch.empty needs no fill; at T >= 256 the grid has no zero
    block."""
    stream, seed = _skel_inputs(L, T)
    hits = np.zeros((256, L), np.int32)
    _skel_twin(skel_twin, stream, seed, T, hits=hits)
    r0 = min(T, 256)
    assert (hits[:r0] == 0x100).all() and (hits[r0:] == 1).all()
    blocks = np.zeros(2, np.int32)
    skel_twin.ps_grid_host(L, T, blocks.ctypes.data)
    assert blocks[0] == -(-L // 64)   # a lane a thread
    assert (blocks[1] == 0) == (T >= 256)


def test_skel_designs_on_cpu():
    """On the CPU both designs are the plain version; an unknown design
    raises."""
    stream, seed = _skel_inputs(16, 8)
    a = micro_skel.skel(_t(stream), _t(seed), 8, "cpu")
    b = micro_skel.skel(_t(stream), _t(seed), 8, "cpu", "vec")
    assert all(torch.equal(u, v) for u, v in zip(a, b))
    with pytest.raises(ValueError, match="design"):
        micro_skel.skel(_t(stream), _t(seed), 8, "cpu", "wide")


# ---------------------------------------------------------------- P3
# whether the case's frame is LZ77's: the TPU kernel's chunks past 128
# elements are not
_LZ77 = {"tool_frame": True, "tool_prefix": True, "long_matches": False}


@pytest.mark.parametrize("case", list(micro_copy.inputs()))
def test_micro_copy_matches_jax(jax_tool, case):
    """The whole frame and sc. The TPU kernel writes only the tokens'
    positions; interpret mode leaves the rest INT32_MIN, and a match that
    reads below seed copies it, where the port defines 0."""
    mc, _ = jax_tool("micro_copy")
    seed, tok, lit = micro_copy.inputs()[case]
    # the tool cannot trace a (0, 3) token array: no tokens are one
    # empty literal run there, the same function
    jtok = tok if len(tok) else np.zeros((1, 3), np.int32)
    run = mc.make_resolver(len(jtok))
    out, sc = run(jnp.array([seed], jnp.int32), jnp.asarray(jtok),
                  jnp.asarray(lit))
    want = np.asarray(out).reshape(-1)
    want = np.where(want == np.iinfo(np.int32).min, 0, want)
    end = int(np.asarray(sc)[0])
    got, gsc = micro_copy.resolve(torch.tensor([seed], dtype=torch.int32),
                                  _t(tok), _t(lit), device="cpu")
    assert int(gsc[0]) == end == seed + int(tok[:, 1].sum())
    np.testing.assert_array_equal(got.numpy().reshape(-1), want)
    if case in _LZ77:
        lz = micro_copy.lz77_replay(tok, lit)
        assert np.array_equal(lz, want[:end]) == _LZ77[case]


@pytest.fixture(scope="module")
def copy_twin():
    try:
        return kernels.host_twin_copy()
    except RuntimeError as e:
        pytest.skip(f"g++ build of the kernel core unavailable: {e}")


@pytest.mark.parametrize("case", list(micro_copy.inputs()))
def test_micro_copy_par_twin(copy_twin, case):
    """The block-parallel resolve (probes_copy_core.cuh: scans, owners,
    chunk sources, pointer jumping), its threads one after another,
    equals resolve_plain: the frame, every element of it, and sc."""
    seed, tok, lit = micro_copy.inputs()[case]
    seed = np.array([seed], np.int32)
    tok = np.ascontiguousarray(tok, np.int32)
    n = (micro_copy.ROWS + 2) * micro_copy.V
    micro_copy._check(_t(seed), _t(tok), lit.size, n)
    out = np.full(n, -5, np.int32)
    sc, rounds = np.zeros(1, np.int32), np.zeros(1, np.int32)
    assert copy_twin.pc_resolve_host(
        seed.ctypes.data, tok.ctypes.data, len(tok), lit.ctypes.data,
        out.ctypes.data, sc.ctypes.data, n, rounds.ctypes.data) == 0
    want, wsc = micro_copy.resolve_plain(_t(seed), _t(tok), _t(lit))
    np.testing.assert_array_equal(out, want.numpy().reshape(-1))
    assert int(sc[0]) == int(wsc[0]) == int(seed[0]) + int(tok[:, 1].sum())
    assert 1 <= int(rounds[0]) <= 17


def test_micro_copy_breakdown_on_cpu():
    """main() runs both kernels (here the plain versions) on every input
    of inputs(), each checked; both rows of an input share one bound, the
    function's: its chain is the scans, the owner search, the source, the
    jumping rounds its longest chain of copies needs and the write, far
    below the tool frame's 1080-token walk."""
    records = micro_copy.main([], device="cpu")
    cases = micro_copy.inputs()
    assert [r.label.split(":")[0] for r in records] == \
        [c for c in cases for _ in micro_copy.REPLACES]
    for a, b in zip(records[::2], records[1::2]):
        assert (a.kernel, b.kernel) == tuple(micro_copy.REPLACES)
        assert (a.nbytes, a.chain) == (b.nbytes, b.chain)
    frame = records[0]
    assert frame.label.startswith("tool_frame")
    assert frame.nbytes == max(r.nbytes for r in records)
    # log2 of 1080 tokens and 32587 positions, the source, 4 rounds (the
    # longest chain, 8-15 copies) and the write
    assert frame.chain == 11 + 15 + 1 + 4 + 1
    # every chunk of a match reads from dst - dist, so a dist-1 run of
    # 4000 is no deeper than its first 128 elements: 8 copies, 4 rounds
    dist1 = records[2 * list(cases).index("dist1_run")]
    assert dist1.chain == 1 + 12 + 1 + 4 + 1


def test_micro_copy_rejects_reads_outside():
    bad = torch.tensor([[1, 4, 1]], dtype=torch.int32)   # a match at 0
    with pytest.raises(ValueError):
        micro_copy.resolve(torch.zeros(1, dtype=torch.int32), bad,
                           torch.zeros((258, 128), dtype=torch.int32),
                           device="cpu")


# ---------------------------------------------------------------- P4
def _mosaic_jax(mp, name, x, aux):
    """The tool's probe body, run as the pallas_call of its ``run`` (or,
    for the two probes its CLI never ran, with their inputs passed)."""
    out_shape = jax.ShapeDtypeStruct((SL, LN), jnp.int32)
    vmem = pl.BlockSpec(memory_space=pltpu.VMEM)
    if name == "smem_scalar":
        return pl.pallas_call(
            lambda x_ref, sm_ref, o_ref: mp.probe_smem_scalar(
                x_ref, o_ref, sm_ref),
            out_shape=out_shape,
            in_specs=[vmem, pl.BlockSpec(memory_space=pltpu.SMEM)])(
                jnp.asarray(x), jnp.asarray(aux))
    if name == "dma_row":
        return pl.pallas_call(
            lambda x_ref, hbm, o_ref, win, sem: mp.probe_dma_row(
                x_ref, o_ref, hbm, win, sem),
            out_shape=out_shape,
            in_specs=[vmem, pl.BlockSpec(memory_space=pltpu.ANY)],
            scratch_shapes=[pltpu.VMEM((16, SL, LN), jnp.int32),
                            pltpu.SemaphoreType.DMA(())])(
                jnp.asarray(x), jnp.asarray(aux))
    kernel, scratch = mp.PROBES[name]
    return pl.pallas_call(kernel, out_shape=out_shape,
                          scratch_shapes=list(scratch))(jnp.asarray(x))


@pytest.mark.parametrize("name,x00", [(n, 16) for n in mosaic_probe.PROBES]
                         + [("stage_store", -8), ("dma_row", 11),
                            ("cond_vec", 3)]
                         + [("dma_row", x00) for x00 in
                            (-1, -2, -3, -13, mosaic_probe.INT32_MIN,
                             mosaic_probe.INT32_MAX)])
def test_mosaic_probe_matches_jax(jax_tool, name, x00):
    """x[0, 0] = 16, -8: stage_store writes stage[0, 0] (other values leave
    it unwritten: INT32_MIN on the TPU side, 0 in the port); dma_row
    writes one row r = x[0, 0] mod 8, the only row compared, from slab 48
    where x[0, 0] rem 4 < 0 (-1, -2, -3, -13)."""
    mp, _ = jax_tool("mosaic_probe")
    x, aux = mosaic_probe.inputs(seed=x00 & 0xFF)
    x = x.numpy().copy()
    x[0, 0] = x00
    a = aux.get(name)
    want = np.asarray(_mosaic_jax(mp, name, x, None if a is None
                                  else a.numpy()))
    got = mosaic_probe.probe(name, _t(x), a, device="cpu").numpy()
    if name == "dma_row":
        r = x00 % SL
        np.testing.assert_array_equal(got[r], want[r])
        assert not np.delete(got, r, axis=0).any()
    else:
        np.testing.assert_array_equal(got, want)


def test_mosaic_probe_cli_defects_are_the_tools():
    """The tool's CLI never ran smem_scalar (not in PROBES) and ran
    dma_row with one input for a kernel of five refs; the port runs both
    as the functions their bodies define."""
    src = open(os.path.join(TOOLS, "mosaic_probe.py")).read()
    assert '"smem_scalar"' not in src
    assert "def probe_dma_row(x_ref, o_ref, hbm, win, sem)" in src
    assert set(mosaic_probe.PROBES) >= {"smem_scalar", "dma_row"}


@pytest.fixture(scope="module")
def mosaic_twin():
    try:
        return kernels.host_twin_mosaic()
    except RuntimeError as e:
        pytest.skip(f"g++ build of the kernel core unavailable: {e}")


def _mosaic_twin(twin, name, x, aux=None, unaligned=False):
    """P4's redesign of probe ``name`` through its twin on numpy x, with
    out pre-filled with -7 (x, aux and out each 4 bytes off 16-byte
    alignment where ``unaligned``: the element path); ``aux`` is
    smem_scalar's table, any row stride, or dma_row's source."""
    off = 4 if unaligned else 0
    x = _placed(np.asarray(x, np.int32), off)
    out = _placed(np.full((SL, LN), -7, np.int32), off)
    sm = None if aux is None else _placed(np.asarray(aux, np.int32), off)
    rc = twin.pm_probe_host(mosaic_probe.PROBES.index(name), x.ctypes.data,
                            None if sm is None else sm.ctypes.data,
                            0 if sm is None else sm.strides[0] // 4,
                            out.ctypes.data)
    assert rc == 0
    return out


_MOSAIC_EDGES = mosaic_probe.edges()
_MOSAIC_EDGE_LABELS = list(dict.fromkeys(
    label for cases in _MOSAIC_EDGES.values() for label, _, _ in cases))
# the edges of dma_row alone
_DMA_ROW_LABELS = {f"x[0, 0] = {t}" for t in (
    -1, -2, -3, 7, mosaic_probe.INT32_MAX, mosaic_probe.INT32_MIN)}


@pytest.mark.parametrize("label", _MOSAIC_EDGE_LABELS)
def test_mosaic_vec_twin_edges(mosaic_twin, label):
    """The twin of each probe that has the card's edge input ``label``
    (mosaic_probe.edges(): x[0, 0] at test_mosaic_probe_matches_jax's
    cases and stage_store's other hits and misses, x <= 0 and x > 99
    everywhere, int32's extremes, x, aux and out unaligned, smem_scalar's
    table with row stride 3, dma_row's negative t rem 4, its row 7 of slab
    3 and t at int32's extremes) equals PLAIN, every element written."""
    ran = []
    for name, cases in _MOSAIC_EDGES.items():
        for lab, unaligned, ins in cases:
            if lab != label:
                continue
            x, aux = ins[0], (ins[1] if len(ins) > 1 else None)
            got = _mosaic_twin(mosaic_twin, name, x.numpy(),
                               None if aux is None else aux.numpy(),
                               unaligned)
            want = mosaic_probe.PLAIN[name](x, aux)
            np.testing.assert_array_equal(got, want.numpy(), err_msg=name)
            ran.append(name)
    assert ran == (["smem_scalar"] if label == "table row stride 3"
                   else ["dma_row"] if label in _DMA_ROW_LABELS
                   else list(mosaic_probe.PROBES))


@pytest.mark.parametrize("name,label", [("table_rw", "x[0, 0] = 16"),
                                        ("minscalar", "x > 99")])
def test_mosaic_vec_twin_matches_jax(jax_tool, mosaic_twin, name, label):
    """table_rw's redesign (its 16-row table in registers), and minscalar's
    where every x exceeds 99 (its minimum is then the least x), through
    the twin against the JAX tool's probe body (interpret mode)."""
    mp, _ = jax_tool("mosaic_probe")
    (x,), = [ins for lab, _, ins in _MOSAIC_EDGES[name] if lab == label]
    want = np.asarray(_mosaic_jax(mp, name, x.numpy(), None))
    got = _mosaic_twin(mosaic_twin, name, x.numpy())
    np.testing.assert_array_equal(got, want)


def test_mosaic_vec_refusals(mosaic_twin):
    """An unknown design raises on any device; the twin refuses an unknown
    probe (index 9, past dma_row)."""
    x, aux = mosaic_probe.inputs()
    with pytest.raises(ValueError, match="design"):
        mosaic_probe.probe("minscalar", x, None, "cpu", "wide")
    with pytest.raises(ValueError, match="design"):
        mosaic_probe.probe("dma_row", x, aux["dma_row"], "cpu", "wide")
    assert len(mosaic_probe.PROBES) == 9
    out = np.zeros((SL, LN), np.int32)
    assert mosaic_twin.pm_probe_host(9, x.numpy().ctypes.data, None, 0,
                                     out.ctypes.data) == -1


# ---------------------------------------------------------------- P5
@pytest.mark.parametrize("axis,H,L", [(0, 16, 128), (1, 8, 128)])
def test_dyngather_matches_jax(jax_tool, axis, H, L):
    mg, _ = jax_tool("micro_gather")
    rng = np.random.RandomState(axis)
    t = rng.randint(0, 100, (H, L)).astype(np.int32)
    i = rng.randint(0, H if axis == 0 else L, (H, L)).astype(np.int32)
    run = (mg.pallas_dyngather_axis0 if axis == 0
           else mg.pallas_dyngather_axis1)(H, L)
    want = np.asarray(run(jnp.asarray(t), jnp.asarray(i)))
    got = micro_gather.dyngather(_t(t), _t(i), axis, device="cpu")
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.fixture(scope="module")
def gather_twin():
    try:
        return kernels.host_twin_gather()
    except RuntimeError as e:
        pytest.skip(f"g++ build of the kernel core unavailable: {e}")


def _cluster_twin(twin, t, i, S):
    """The cluster gather's twin (probes_gather_core.cuh) on numpy
    inputs, its clusters' blocks one after another."""
    t, i = np.ascontiguousarray(t, np.int32), np.ascontiguousarray(i, np.int32)
    out = np.full(t.shape, -7, np.int32)
    rc = twin.pg_dyngather_host(t.ctypes.data, i.ctypes.data,
                                out.ctypes.data, *t.shape, S)
    assert rc == 0
    return out


def test_dyngather_cluster_twin_matches_jax(jax_tool, gather_twin):
    """The cluster gather's twin at the tool's (16, 128) on
    test_dyngather_matches_jax's inputs, at the cluster the kernel picks
    on 132 SMs, against the JAX tool's Pallas kernel (interpret mode)."""
    mg, _ = jax_tool("micro_gather")
    rng = np.random.RandomState(0)
    t = rng.randint(0, 100, (16, 128)).astype(np.int32)
    i = rng.randint(0, 16, (16, 128)).astype(np.int32)
    want = np.asarray(mg.pallas_dyngather_axis0(16, 128)(jnp.asarray(t),
                                                        jnp.asarray(i)))
    S = gather_twin.pg_cluster_size_host(16, 128, 132)
    np.testing.assert_array_equal(_cluster_twin(gather_twin, t, i, S), want)


@pytest.mark.parametrize("S", [1, 2, 8])
@pytest.mark.parametrize("H,L", [(16, 128), (288, 1024), (1, 12), (37, 12),
                                 (5, 3), (300, 20), (328, 8)])
def test_dyngather_cluster_twin(gather_twin, H, L, S):
    """The twin equals dyngather_plain on every cluster: the tool's (16,
    128) and (288, 1024) on test_dyngather_matches_jax's inputs, then
    shapes that stress the map (H = 1, H not a multiple of S, L = 12 and 3
    and 20: a tail tile) with indices at -3, 0, H - 1 and H + 5 (clamped)
    beside random ones; at H = 328 (41 rows a rank at S = 8, where the
    float rank of k = 41 m falls just under m) the indices 41 m and 41 m
    - 1 too."""
    rng = np.random.RandomState(0)
    t = rng.randint(0, 100, (H, L)).astype(np.int32)
    if (H, L) in ((16, 128), (288, 1024)):
        i = rng.randint(0, H, (H, L)).astype(np.int32)
    else:
        t = rng.randint(-1 << 31, 1 << 31, (H, L), dtype=np.int64) \
            .astype(np.int32)
        i = rng.randint(-3, H + 6, (H, L)).astype(np.int32)
        i.flat[:4] = [-3, 0, H - 1, H + 5]
        if H == 328:
            edges = [41 * m + d for m in range(1, 8) for d in (-1, 0)]
            i.flat[4:4 + len(edges)] = edges
    want = micro_gather.dyngather_plain(_t(t), _t(i), 0).numpy()
    np.testing.assert_array_equal(_cluster_twin(gather_twin, t, i, S), want)


def test_cluster_size_and_refusals(gather_twin):
    """The cluster the kernel picks on 132 SMs: 8 blocks for every axis-0
    shape of the tool at L = 128 (32 tiles), 1 at L = 1024 (256 tiles); at
    each of the tool's edge shapes the one the twin tests pin (41 rows a
    rank at H = 328); 8 blocks hold at most 116,224 rows, and the kernel
    refuses a table past that, as the twin does a cluster that is no power
    of two or past 8; the cluster design on axis 1 raises."""
    size = gather_twin.pg_cluster_size_host
    got = [size(H, L, 132)
           for axis, H, L in micro_gather.GATHER_SHAPES if axis == 0]
    assert got == [8] * 7 + [1] * 2
    assert [size(H, L, 132) for H, L in micro_gather.EDGE_GATHERS] == \
        [8, 8, 4, 1]
    assert size(116224, 8, 132) == 8 and size(116225, 8, 132) == 0
    assert size(116224, 1024, 132) == 8 and size(58112, 1024, 132) == 4
    for H, S in ((116225, 8), (8, 3), (8, 16), (0, 1)):
        assert gather_twin.pg_dyngather_host(None, None, None, H, 8, S) == -1
    z = torch.zeros((8, 8), dtype=torch.int32)
    with pytest.raises(ValueError, match="axis 0"):
        micro_gather.dyngather(z, z, 1, "cpu", "cluster")


_LEN_CASES = {   # (peek, limits 1-14 by bl): (length, code)
    "no_hit": (0x7FFF, [1] * 14, (15, 0)),
    "all_limits_0": (0x1234, [0] * 14, (15, 0)),
    "only_bl_1": (0x7FFF, [2] + [0] * 13, (1, 1)),
    "only_bl_14": (0x7FFF, [0] * 13 + [0x4000], (14, 0x3FFF)),
    "peek_0": (0, [0, 0, 5] + [1] * 11, (3, 0)),
    "peek_7fff": (0x7FFF, [1, 3, 7, 16] + [1 << 15] * 10, (4, 15)),
}


@pytest.mark.parametrize("case", list(_LEN_CASES))
def test_len_find_branch_free(gather_twin, case):
    """The branch-free length find (a mask of 14 compares, its lowest set
    bit) equals len_find_plain on the case's lane and on 64 random
    lanes beside it."""
    peek0, lims, want = _LEN_CASES[case]
    rng = np.random.RandomState(7)
    n = 65
    peek = rng.randint(0, 1 << 15, n).astype(np.int32)
    limit = rng.randint(0, 1 << 15, (16, n)).astype(np.int32)
    peek[0], limit[1:15, 0] = peek0, lims
    length, code = np.zeros(n, np.int32), np.zeros(n, np.int32)
    gather_twin.pg_len_find_host(peek.ctypes.data, limit.ctypes.data, n,
                                 length.ctypes.data, code.ctypes.data)
    wl, wc = micro_gather.len_find_plain(torch.from_numpy(peek).long(),
                                         _t(limit))
    assert (int(length[0]), int(code[0])) == want
    np.testing.assert_array_equal(length, wl.numpy())
    np.testing.assert_array_equal(code, wc.numpy())


@pytest.mark.parametrize("L,T", [(16, 40), (100, 40), (128, 40)])
def test_symbol_smem_twin(gather_twin, L, T):
    """The staged step's twin, block by block of 64 lanes (16 and 100
    lanes: a last block part full; 128: whole blocks, copied 16 bytes at
    a time), equals symbol_step_plain."""
    meta, limit, stream = (x.numpy().copy()
                           for x in micro_gather.symbol_inputs(L, 3))
    out = np.zeros(L, np.int32)
    gather_twin.pg_symbol_host(meta.ctypes.data, limit.ctypes.data,
                               stream.ctypes.data, out.ctypes.data, L, T)
    want = micro_gather.symbol_step_plain(_t(meta), _t(limit), _t(stream), T)
    np.testing.assert_array_equal(out, want.numpy())


def _first_timed(mod, make_args):
    """Replace ``mod.timeit``: the first call runs the function it was
    handed on ``make_args(*its args)`` and keeps the result; every call
    then raises, which the tool reports and passes over."""
    got = []

    def timeit(fn, *args, **kw):
        if not got:
            got.append(np.asarray(fn(*make_args(*args))))
        raise RuntimeError("not timed here")
    mod.timeit = timeit
    return got


def test_masksum_matches_jax(jax_tool):
    """The tool's first shape, (8, 128) lanes; indices outside the table
    give 0 on both sides."""
    mg, _ = jax_tool("micro_gather")
    rng = np.random.RandomState(2)
    tab = rng.randint(0, 288, (288, SL * LN)).astype(np.int32)
    idx = rng.randint(-3, 300, (SL, LN)).astype(np.int32)
    got = _first_timed(mg, lambda *a: (jnp.asarray(tab), jnp.asarray(idx)))
    mg.bench_pallas_masksum()
    out = micro_gather.masksum(_t(tab), _t(idx), device="cpu")
    np.testing.assert_array_equal(out.numpy(), got[0])


def test_symbol_step_matches_jax(jax_tool):
    """The tool's own shape: 8192 lanes, 256 steps."""
    mg, _ = jax_tool("micro_gather")
    ins = micro_gather.symbol_inputs(micro_gather.SYMBOL_LANES, 3)
    arrs = [t.numpy() for t in ins]
    arrs[2] = arrs[2].view(np.uint32)
    got = _first_timed(mg, lambda *a: [jnp.asarray(v) for v in arrs])
    mg.bench_symbol_step()
    out = micro_gather.symbol_step(*ins, device="cpu")
    np.testing.assert_array_equal(out.numpy(), got[0].reshape(-1))


# ---------------------------------------------------------------- P6
def test_gather2_masksum_matches_jax(jax_tool):
    mg2, dt = jax_tool("micro_gather2")
    mg2.bench_masksum(1, 32)
    call = _closure(dt.steps[0])["call"]
    rng = np.random.RandomState(4)
    tab = rng.randint(0, 288, (288, 32)).astype(np.int32)
    idx = rng.randint(0, 288, (1, 32)).astype(np.int32)
    want = np.asarray(call(jnp.asarray(tab), jnp.asarray(idx)))
    got = micro_gather2.masksum(_t(tab), _t(idx), device="cpu")
    np.testing.assert_array_equal(got.numpy(), want)


def test_gather2_symbol_step_matches_jax(jax_tool):
    mg2, dt = jax_tool("micro_gather2")
    mg2.bench_symbol_step(1, 32, T=8)
    call = _closure(dt.steps[0])["call"]
    meta, limit, stream = micro_gather.symbol_inputs(32, 5)
    x = np.random.RandomState(6).randint(0, 100, (1, 32)).astype(np.int32)
    want = np.asarray(call(jnp.asarray(meta.numpy()),
                           jnp.asarray(limit.numpy()),
                           jnp.asarray(stream.numpy().view(np.uint32)),
                           jnp.asarray(x)))
    got = micro_gather2.symbol_step(meta, limit, stream, _t(x), 8,
                                    device="cpu")
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.fixture(scope="module")
def gather2_twin():
    try:
        return kernels.host_twin_gather2()
    except RuntimeError as e:
        pytest.skip(f"g++ build of the kernel core unavailable: {e}")


def _placed(a, offset):
    """A copy of ``a`` whose data lies ``offset`` bytes past a 16-byte
    boundary."""
    a = np.ascontiguousarray(a)
    buf = np.zeros(a.size + 8, a.dtype)
    k = (-buf.ctypes.data % 16 + offset) // a.itemsize
    v = buf[k:k + a.size].reshape(a.shape)
    v[...] = a
    assert v.ctypes.data % 16 == offset
    return v


def _masksum_twin(twin, tab, idx, unaligned=False,
                  entry="pg2_masksum_host"):
    """The vec mask-sum's twin on numpy inputs (both 4 bytes off 16-byte
    alignment where ``unaligned``, taking the lane-by-lane path); P6's,
    or P5's with ``entry="pg2_masksum_p5_host"``."""
    off = 4 if unaligned else 0
    tab, idx = _placed(tab.astype(np.int32), off), _placed(idx, off)
    out = _placed(np.full(idx.size, -7, np.int32), 0)
    getattr(twin, entry)(tab.ctypes.data, idx.ctypes.data, out.ctypes.data,
                         *tab.shape)
    return out


def _symbol_twin(twin, meta, limit, stream, x, T, unaligned=False):
    off = 4 if unaligned else 0
    meta, limit, stream, x = (_placed(np.asarray(a).view(np.int32), off)
                              for a in (meta, limit, stream, x))
    out = np.zeros(x.size, np.int32)
    twin.pg2_symbol_host(meta.ctypes.data, limit.ctypes.data,
                         stream.ctypes.data, x.ctypes.data, out.ctypes.data,
                         meta.shape[1], T)
    return out


def test_gather2_masksum_vec_twin_matches_jax(jax_tool, gather2_twin):
    """The vec mask-sum's twin at (1, 36): nine whole quads of 16-byte
    loads, idx at -1, 288 and 287 beside random rows, against the JAX
    tool's Pallas kernel (interpret mode)."""
    mg2, dt = jax_tool("micro_gather2")
    mg2.bench_masksum(1, 36)
    call = _closure(dt.steps[0])["call"]
    rng = np.random.RandomState(4)
    tab = rng.randint(-288, 288, (288, 36)).astype(np.int32)
    idx = rng.randint(0, 288, (1, 36)).astype(np.int32)
    idx[0, :3] = [-1, 288, 287]
    want = np.asarray(call(jnp.asarray(tab), jnp.asarray(idx)))
    got = _masksum_twin(gather2_twin, tab, idx.ravel())
    np.testing.assert_array_equal(got, want.ravel())


def test_gather2_symbol_smem_twin_matches_jax(jax_tool, gather2_twin):
    """The staged symbol step's twin at (1, 64), one whole block, 8
    steps, on test_gather2_symbol_step_matches_jax's draw, against the JAX
    tool's Pallas kernel (interpret mode)."""
    mg2, dt = jax_tool("micro_gather2")
    mg2.bench_symbol_step(1, 64, T=8)
    call = _closure(dt.steps[0])["call"]
    meta, limit, stream = (t.numpy() for t in
                           micro_gather.symbol_inputs(64, 5))
    x = np.random.RandomState(6).randint(0, 100, (1, 64)).astype(np.int32)
    want = np.asarray(call(jnp.asarray(meta), jnp.asarray(limit),
                           jnp.asarray(stream.view(np.uint32)),
                           jnp.asarray(x)))
    got = _symbol_twin(gather2_twin, meta, limit, stream, x.ravel(), 8)
    np.testing.assert_array_equal(got, want.ravel())


@pytest.mark.parametrize("case", range(4))
def test_masksum_vec_twin_edges(gather2_twin, case):
    """The vec mask-sum's twin on each of micro_gather2.masksum_edges()
    (the card's edge runs: 100 and 8194 lanes, unaligned idx and tab, tab
    near INT32_MAX; idx -1, 288, INT32_MIN, INT32_MAX) equals
    masksum_plain."""
    label, unaligned, (tab, idx) = micro_gather2.masksum_edges()[case]
    want = micro_gather2.masksum_plain(tab, idx).numpy()
    got = _masksum_twin(gather2_twin, tab.numpy(), idx.numpy(), unaligned)
    np.testing.assert_array_equal(got, want, err_msg=label)


@pytest.mark.parametrize("case", range(4))
def test_symbol_smem_p6_twin_edges(gather2_twin, case):
    """The staged symbol step's twin on each of
    micro_gather2.symbol_edges() (100, 8194 and unaligned 8192 lanes with
    row-1 limits of 0, -5, 2^15, 2^20, 1 and 2, negative seeds and meta
    over all of int32; all limits 0) equals symbol_step_plain."""
    label, unaligned, ins = micro_gather2.symbol_edges()[case]
    want = micro_gather2.symbol_step_plain(*ins, 64).numpy()
    got = _symbol_twin(gather2_twin, *(t.numpy() for t in ins), 64,
                       unaligned)
    np.testing.assert_array_equal(got, want, err_msg=label)


@pytest.mark.parametrize("case", list(_LEN_CASES))
def test_len_find_early_exit(gather2_twin, case):
    """The staged symbol step's find (an exit at bl = 1, else the count
    of compares) gives len_find_plain's length and the meta row (code + 7
    length) mod 288 on the case's lane and on 64 random lanes beside it;
    the lanes of length 1 took the early exit, the others the count, and
    both occur."""
    peek0, lims, want = _LEN_CASES[case]
    rng = np.random.RandomState(7)
    n = 65
    peek = rng.randint(0, 1 << 15, n).astype(np.int32)
    limit = np.zeros((16, n), np.int32)
    for bl in range(1, 15):
        limit[bl] = rng.randint(-2, (1 << bl) + 2, n)
    peek[0], limit[1:15, 0] = peek0, lims
    length, row = np.zeros(n, np.int32), np.zeros(n, np.int32)
    gather2_twin.pg2_len_find_host(peek.ctypes.data, limit.ctypes.data, n,
                                   length.ctypes.data, row.ctypes.data)
    wl, wc = micro_gather.len_find_plain(torch.from_numpy(peek).long(),
                                         _t(limit))
    assert int(length[0]) == want[0]
    np.testing.assert_array_equal(length, wl.numpy())
    np.testing.assert_array_equal(row, ((wc + 7 * wl) % 288).numpy())
    assert (length == 1).any() and (length > 1).any()


def test_gather2_designs_on_cpu():
    """On the CPU both designs of each P6 probe run the plain version;
    an unknown design, and a table without rows, raise."""
    tab, idx = micro_gather2.masksum_edges()[0][2]
    want = micro_gather2.masksum_plain(tab, idx)
    for design in ("faithful", "vec"):
        assert torch.equal(micro_gather2.masksum(tab, idx, "cpu", design),
                           want)
    ins = micro_gather2.symbol_edges()[0][2]
    want = micro_gather2.symbol_step_plain(*ins, 8)
    for design in ("faithful", "smem"):
        assert torch.equal(micro_gather2.symbol_step(*ins, 8, "cpu", design),
                           want)
    with pytest.raises(ValueError, match="design"):
        micro_gather2.masksum(tab, idx, "cpu", "smem")
    with pytest.raises(ValueError, match="design"):
        micro_gather2.symbol_step(*ins, 8, "cpu", "vec")
    with pytest.raises(ValueError, match="rows"):
        micro_gather2.masksum(tab[:0], idx, "cpu")


# ------------------------------------- P5 axis 1 and mask-sum redesigns
def _row_twin(twin, t, i, t_off=0, i_off=0):
    """The row gather's twin on numpy inputs, t and i ``t_off`` and
    ``i_off`` bytes past 16-byte alignment."""
    t, i = _placed(t, t_off), _placed(i, i_off)
    out = _placed(np.full(t.shape, -7, np.int32), 0)
    rc = twin.pg_dyngather_row_host(t.ctypes.data, i.ctypes.data,
                                    out.ctypes.data, *t.shape)
    assert rc == 0
    return out


@pytest.mark.parametrize("case", range(len(micro_gather.row_edges())))
def test_dyngather_row_twin_edges(gather_twin, case):
    """The row gather's twin on each of micro_gather.row_edges() (the
    card's edge runs: L = 100, 130 and 3, one row, unaligned t and idx,
    the widest staged row; indices -3, -1, L and L + 5; t over all of
    int32) equals dyngather_plain."""
    label, unaligned, (t, i) = micro_gather.row_edges()[case]
    off = 4 if unaligned else 0
    got = _row_twin(gather_twin, t.numpy(), i.numpy(), off, off)
    want = micro_gather.dyngather_plain(t, i, 1).numpy()
    np.testing.assert_array_equal(got, want, err_msg=label)


@pytest.mark.parametrize("t_off,i_off", [(4, 0), (0, 4), (0, 0)])
def test_dyngather_row_twin_alignment(gather_twin, t_off, i_off):
    """Only t, or only idx, 4 bytes off 16-byte alignment, which sends the
    whole kernel down its element paths (pg::row_vec), and both aligned,
    at (37, 1032): each thread's first quad loaded before the copy's wait,
    its second (quads 256-257) after it."""
    rng = np.random.RandomState(12)
    t = rng.randint(-1 << 31, 1 << 31, (37, 1032), dtype=np.int64) \
        .astype(np.int32)
    i = rng.randint(-3, 1038, (37, 1032)).astype(np.int32)
    got = _row_twin(gather_twin, t, i, t_off, i_off)
    want = micro_gather.dyngather_plain(_t(t), _t(i), 1).numpy()
    np.testing.assert_array_equal(got, want)


def test_dyngather_row_twin_matches_jax(jax_tool, gather_twin):
    """The row gather's twin at the tool's (8, 128) on
    test_dyngather_matches_jax's axis-1 inputs, against the JAX tool's
    Pallas kernel (interpret mode)."""
    mg, _ = jax_tool("micro_gather")
    rng = np.random.RandomState(1)
    t = rng.randint(0, 100, (8, 128)).astype(np.int32)
    i = rng.randint(0, 128, (8, 128)).astype(np.int32)
    want = np.asarray(mg.pallas_dyngather_axis1(8, 128)(jnp.asarray(t),
                                                        jnp.asarray(i)))
    np.testing.assert_array_equal(_row_twin(gather_twin, t, i), want)


def test_dyngather_row_refusals(gather_twin):
    """A row wider than ROW_MAX (48 KiB) is refused: the wrapper raises
    ValueError on any device, the twin returns -1; the widest row runs;
    the row design on axis 0 raises."""
    wide = micro_gather.ROW_MAX + 1
    z = torch.zeros((1, wide), dtype=torch.int32)
    with pytest.raises(ValueError, match=f"at most {micro_gather.ROW_MAX}"):
        micro_gather.dyngather(z, z, 1, "cpu", "row")
    assert gather_twin.pg_dyngather_row_host(None, None, None, 1, wide) == -1
    z = z[:, 1:]
    assert torch.equal(micro_gather.dyngather(z, z, 1, "cpu", "row"), z)
    with pytest.raises(ValueError, match="axis 1"):
        micro_gather.dyngather(z, z, 0, "cpu", "row")


def test_masksum_p5_vec_twin_matches_jax(jax_tool, gather2_twin):
    """P5's vec mask-sum twin at the tool's (8, 128) lanes on
    test_masksum_matches_jax's inputs (idx in [-3, 300): lanes outside
    the table give 0), against the JAX tool's sweep (interpret mode)."""
    mg, _ = jax_tool("micro_gather")
    rng = np.random.RandomState(2)
    tab = rng.randint(0, 288, (288, SL * LN)).astype(np.int32)
    idx = rng.randint(-3, 300, (SL, LN)).astype(np.int32)
    got = _first_timed(mg, lambda *a: (jnp.asarray(tab), jnp.asarray(idx)))
    mg.bench_pallas_masksum()
    out = _masksum_twin(gather2_twin, tab, idx.ravel(),
                        entry="pg2_masksum_p5_host")
    np.testing.assert_array_equal(out, got[0].ravel())


@pytest.mark.parametrize("case", range(4))
def test_masksum_p5_vec_twin_edges(gather2_twin, case):
    """P5's vec mask-sum twin on each of micro_gather.masksum_edges() (the
    card's edge runs: 100 and 8194 lanes, unaligned idx and tab; idx -1,
    288, INT32_MIN, INT32_MAX; tab over all of int32) equals
    masksum_plain."""
    label, unaligned, (tab, idx) = micro_gather.masksum_edges()[case]
    want = micro_gather.masksum_plain(tab, idx).numpy()
    got = _masksum_twin(gather2_twin, tab.numpy(), idx.numpy(), unaligned,
                        "pg2_masksum_p5_host")
    np.testing.assert_array_equal(got, want, err_msg=label)


def test_masksum_p6_vec_bytes_unchanged(gather2_twin):
    """P6's vec twin gives, on each of micro_gather2.masksum_edges() at
    both alignments, the bytes it gave before its core was shared with
    P5's mask-sum: the sha256 of the outputs in order, taken from the
    core before the change."""
    h = hashlib.sha256()
    for _, _, (tab, idx) in micro_gather2.masksum_edges():
        for unaligned in (False, True):
            h.update(_masksum_twin(gather2_twin, tab.numpy(), idx.numpy(),
                                   unaligned).tobytes())
    assert h.hexdigest() == \
        "6fbea6930f9a27d596d19145129f777e797351bb19e163ecac2df4c06c4c15cc"


def test_gather_designs_on_cpu():
    """On the CPU the row gather and the vec mask-sum run the plain
    version; an unknown design raises."""
    _, _, (t, i) = micro_gather.row_edges()[0]
    want = micro_gather.dyngather_plain(t, i, 1)
    for design in ("faithful", "row"):
        assert torch.equal(micro_gather.dyngather(t, i, 1, "cpu", design),
                           want)
    _, _, (tab, idx) = micro_gather.masksum_edges()[0]
    want = micro_gather.masksum_plain(tab, idx)
    for design in ("faithful", "vec"):
        assert torch.equal(micro_gather.masksum(tab, idx, "cpu", design),
                           want)
    with pytest.raises(ValueError, match="design"):
        micro_gather.masksum(tab, idx, "cpu", "row")
    with pytest.raises(ValueError, match="design"):
        micro_gather.dyngather(t, i, 1, "cpu", "vec")


# ---------------------------------------------------------------- port
MODULES = [micro_vec, micro_skel, micro_copy, mosaic_probe, micro_gather,
           micro_gather2]


@pytest.mark.parametrize("mod", MODULES,
                         ids=lambda m: m.__name__.split(".")[-1])
def test_tool_main_on_cpu(mod, capsys):
    """Each tool's main() on the CPU (its plain versions, small library
    rows): a record for every kernel the tool has, each equal to a second
    plain run, and the header says no device time was taken."""
    records = mod.main([], device="cpu")
    assert {r.kernel for r in records} == set(mod.REPLACES)
    for r in records:
        assert torch.equal(r.out, r.plain()), r.kernel
        assert r.nbytes > 0 and r.chain > 0
    assert "no device times" in capsys.readouterr().out.splitlines()[0]
    assert not any(mod.LAUNCHES.values())   # plain runs launch nothing


def test_probes_refuse_cuda_without_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    x = torch.zeros((SL, LN), dtype=torch.int32)
    with pytest.raises(RuntimeError, match="is_available"):
        mosaic_probe.probe("minscalar", x)
    with pytest.raises(RuntimeError, match="is_available"):
        micro_vec.main([])


def test_probe_kernels_in_the_library():
    """Every probe source is built into kernels.lib() and every probe
    entry point has its ctypes signature."""
    srcs = {os.path.basename(s) for s in kernels._sources(["*.cu", "*.cuh"])}
    for mod in MODULES:
        assert mod.SOURCE in srcs
        assert set(getattr(mod, "SOURCES", {}).values()) <= srcs
    assert {"probes_gather.cuh", "probes_copy_core.cuh",
            "probes_vec.cuh", "probes_gather_core.cuh",
            "probes_gather_cluster.cu", "probes_gather2_core.cuh",
            "probes_gather2_smem.cu", "probes_gather_row.cu",
            "probes_mosaic_core.cuh", "probes_mosaic_vec.cu",
            "probes_skel_core.cuh", "probes_skel_vec.cu"} <= srcs
    for name in ("msp_p1_vec", "msp_p1_registers", "msp_p2_skel",
                 "msp_p3_copy", "msp_p3_copy_par", "msp_p4_probe",
                 "msp_p5_dyngather", "msp_p5_masksum", "msp_p5_symbol_step",
                 "msp_p5_dyngather_cluster", "msp_p5_symbol_smem",
                 "msp_p6_masksum", "msp_p6_symbol_step",
                 "msp_p6_masksum_vec", "msp_p6_symbol_smem",
                 "msp_p5_dyngather_row", "msp_p5_masksum_vec",
                 "msp_p4_probe_vec", "msp_p2_skel_vec"):
        assert name in kernels._SIGNATURES


@pytest.mark.parametrize("limit,length", [(1 << 15, 1), (0, 15)])
def test_symbol_work_tally(limit, length):
    """The bound's tally follows the data: with every limit above any
    code the length find stops at bl = 1 (one limit row read, one
    compare); with every limit 0 it reads all 14 rows and counts a 4-deep
    tree. A step adds the refill, the meta load and the consume."""
    L, T = 16, 40
    meta, _, stream = micro_gather.symbol_inputs(L, 3)
    lim = torch.full((16, L), limit, dtype=torch.int32)
    work = Work(L)
    micro_gather.symbol_step_plain(meta, lim, stream, T, work)
    assert work.chain() == T * (3 + min(length, 4))
    assert int(work.masks["limit"].sum()) == min(length, 14) * L
    assert int(work.masks["stream"].sum()) == 32 * L
    assert 0 < int(work.masks["meta"].sum()) <= T * L


_LISTING = """
        Function : _ZN12_GLOBAL__N_117p5_masksum_kernelEPKiS1_Piii
        /*0000*/                   MOV R1, c[0x0][0x28] ;
        /*0010*/                   LDG.E R2, desc[UR4][R2.64] ;
        /*0020*/                   ISETP.NE.AND P0, PT, R2, RZ, PT ;
        /*0030*/               @P0 BRA 0x10 ;
        /*0040*/                   STG.E desc[UR4][R4.64], R2 ;
        /*0050*/                   NOP;
        Function : _ZN12_GLOBAL__N_113p2_skel_kernelEPKjlPKiiiiiPiS4_
        /*0000*/                   SEL R3, R2, RZ, P0 ;
        /*0010*/                   BRA 0x20 ;
        Function : _ZN12_GLOBAL__N_115p1_sweep_kernelILb1EEEviiPiS1_
        /*0000*/                   LDS R3, [R2] ;
        /*0010*/                   LD.E R4, [R6.64] ;
"""


def test_sass_summary_reads_a_listing():
    got = sass.summarise(_LISTING)
    m = got["p5_masksum_kernel"]
    assert (m["insns"], m["LDG"], m["STG"], m["ISETP"], m["loops"]) == \
        (5, 1, 1, 1, 1)
    s = got["p2_skel_kernel"]
    assert (s["insns"], s["SEL"], s["loops"]) == (2, 1, 0)
    p = got["p1_sweep_kernel<true>"]
    assert (p["LDS"], p["LD"], p["LDG"]) == (1, 1, 0)


def test_sass_summary_finds_loads_in_loops():
    """The opcodes between a backward branch and its target count as in a
    loop: p5_masksum_kernel's LDG at 0x10 and ISETP at 0x20 (the loop
    0x10-0x30), not its STG at 0x40; a kernel without a loop has none."""
    got = sass.summarise(_LISTING)
    m = got["p5_masksum_kernel"]
    assert (m["loop LDG"], m["loop ISETP"], m["loop STG"]) == (1, 1, 0)
    assert not any(k.startswith("loop ") for k in got["p2_skel_kernel"])


def test_sass_names_p4_redesigns():
    """A P4 redesign's mangled name holds its faithful probe's name
    (p4_reduce_pred_vec, reduce_pred; p4_dma_row_vec, dma_row): the summary
    keeps them apart, and keeps P2's redesign apart from the faithful
    p2_skel_kernel."""
    listing = """
        Function : _ZN12_GLOBAL__N_118p4_reduce_pred_vecILb1EEEvPKiS2_lPi
        /*0000*/                   LDG.E.128 R4, desc[UR4][R2.64] ;
        Function : _ZN12_GLOBAL__N_111reduce_predEPKiS1_lPi
        /*0000*/                   LDG.E R4, desc[UR4][R2.64] ;
        /*0010*/                   STG.E desc[UR4][R6.64], R4 ;
        Function : _ZN12_GLOBAL__N_118p2_skel_vec_kernelILb0EEEvN2ps4ArgsENS0_4GridE
        /*0000*/                   STG.E desc[UR4][R6.64], R4 ;
        Function : _ZN12_GLOBAL__N_114p4_dma_row_vecILb0EEEvPKiS2_lPi
        /*0000*/                   LDG.E R4, desc[UR4][R2.64] ;
        Function : _ZN12_GLOBAL__N_17dma_rowEPKiS1_lPi
        /*0000*/                   LDS R4, [R2] ;
"""
    got = sass.summarise(listing)
    assert got["p4_reduce_pred_vec<true>"]["insns"] == 1
    assert got["reduce_pred"]["insns"] == 2
    assert got["p4_dma_row_vec<false>"]["LDG"] == 1
    assert got["dma_row"]["LDS"] == 1
    assert got["p2_skel_vec_kernel<false>"]["STG"] == 1
    assert "p2_skel_kernel" not in got
