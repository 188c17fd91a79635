"""The warp steps of K3 and K4 (one warp per stream) against the serial
loops they replace, through the g++ twins of ``lzx_core.cuh`` and
``qtm_core.cuh``, whose lanes run one after another on the CPU.

* K4: the lane-form model search, +8 update and rescale (halving as a
  suffix max, the exchange sort on lane 0) against the serial loops of the
  reference codec (``ops/cuda_qtm.py:_update`` and the plain version's
  search), on random models of 7, 24, 27, 36, 42 and 64 entries with tied
  counts; the one-step renormalisation against the bit loop on 2^20 coder
  states that cover every (k1, k2) the coder can reach and random ones.
* K3: the first-level table decode against the canonical walk on random
  complete codes of lengths 1-16 (past each table's bits), incomplete
  codes and the pretree.
* Both: the twin against the plain version at small token caps, where the
  decode stops inside K3's literal run.

Tolerance: exact. Inputs are made from numpy seeds.
"""
import numpy as np
import pytest
import torch

from libmspack_tpu_torch import kernels
from libmspack_tpu_torch import lzx_edge_cases as le
from libmspack_tpu_torch import qtm_edge_cases as qe
from libmspack_tpu_torch.ops import cuda_lzx as cl
from libmspack_tpu_torch.ops import cuda_qtm as cq


def _ptr(a):
    return a.ctypes.data


@pytest.fixture(scope="module")
def qtwin():
    try:
        return kernels.host_twin_qtm()
    except RuntimeError as e:
        pytest.skip(f"g++ build of the kernel core unavailable: {e}")


@pytest.fixture(scope="module")
def ltwin():
    try:
        return kernels.host_twin_lzx()
    except RuntimeError as e:
        pytest.skip(f"g++ build of the kernel core unavailable: {e}")


# ------------------------------------------------------------- K4 models --

def _model(rng, n, total, rescales_left):
    """A model record of n entries whose counts tie often and sum to
    about total."""
    counts = rng.choice([1, 1, 2, 3, 3, 5, 8], n).astype(np.int64)
    counts *= max(1, total // int(counts.sum()))
    counts[rng.integers(n)] += max(0, total - int(counts.sum()))
    m = np.zeros((), cq.MODEL_DTYPE)
    m["entries"] = n
    m["rescales_left"] = rescales_left
    m["sym"][:n] = rng.permutation(n) + 64
    m["sym"][n] = 64 + n
    m["cum"][:n] = np.cumsum(counts[::-1])[::-1]
    return m


def _serial_symbol(m, symf):
    """The reference's search, +8 update and rescale on a copy of m."""
    n = int(m["entries"])
    cum, sym = m["cum"].tolist(), m["sym"].tolist()
    rl = [int(m["rescales_left"])]
    i = 1
    while i < n and cum[i] > symf:
        i += 1
    for j in range(i):
        cum[j] += 8
    if cum[0] > 3800:
        cq._update(n, rl, sym, cum)
    return i, cum, sym, rl[0]


@pytest.mark.parametrize("n", [7, 24, 27, 36, 42, 64])
def test_model_search_update_rescale_equal_serial_loops(qtwin, n):
    assert qtwin.qt_model_bytes() == cq.MODEL_DTYPE.itemsize
    rng = np.random.default_rng(n)
    rescaled = 0
    for trial in range(300):
        # totals near 3800 make the +8 update rescale; rescales_left 1
        # makes that rescale the exchange sort
        total = int(rng.choice([n, 400, 2000, 3793, 3800]))
        m = _model(rng, n, total, int(rng.choice([1, 2, 4, 50])))
        t = int(m["cum"][0])
        symf = int(rng.integers(0, t + 2))
        i, cum, sym, rl = _serial_symbol(m, symf)
        rescaled += cum[0] != t + 8
        rec = np.array(m)
        got = qtwin.qt_model_symbol(_ptr(rec), symf)
        assert got == i, (trial, symf)
        assert rec["cum"].tolist() == cum, trial
        assert rec["sym"].tolist() == sym, trial
        assert int(rec["rescales_left"]) == rl, trial
    assert rescaled > 50


@pytest.mark.parametrize("n", [7, 24, 27, 36, 42, 64])
@pytest.mark.parametrize("left", [1, 2, 5])
def test_rescale_equals_serial_update(qtwin, n, left):
    """Halving (rescales_left > 1) and the sort (rescales_left 1) against
    ``cuda_qtm._update``, on models with many equal counts."""
    rng = np.random.default_rng(100 * n + left)
    for trial in range(100):
        m = _model(rng, n, int(rng.integers(n, 3809)), left)
        cum, sym = m["cum"].tolist(), m["sym"].tolist()
        rl = [left]
        cq._update(n, rl, sym, cum)
        rec = np.array(m)
        qtwin.qt_rescale(_ptr(rec))
        assert rec["cum"].tolist() == cum, trial
        assert rec["sym"].tolist() == sym, trial
        assert int(rec["rescales_left"]) == rl[0], trial


# ------------------------------------------------------- K4 renormalise --

def _renorm_loop(lo, hi, code, nxt):
    """The reference's bit loop (codecs/qtm.py:117-131), vectorised: each
    state shifts in bits of nxt (MSB first) until it stops."""
    lo, hi, code = (a.astype(np.int64) for a in (lo, hi, code))
    nxt = nxt.astype(np.int64)
    used = np.zeros_like(lo)
    live = np.ones(lo.shape, bool)
    for _ in range(40):
        differ = ((lo ^ hi) & 0x8000) != 0
        under = differ & ((lo & 0x4000) != 0) & ((hi & 0x4000) == 0)
        live &= ~(differ & ~under)
        if not live.any():
            break
        u = live & under
        code = np.where(u, code ^ 0x4000, code)
        lo = np.where(u, lo & 0x3FFF, lo)
        hi = np.where(u, hi | 0x4000, hi)
        bit = (nxt >> np.clip(31 - used, 0, 31)) & 1
        lo = np.where(live, (lo << 1) & 0xFFFF, lo)
        hi = np.where(live, ((hi << 1) | 1) & 0xFFFF, hi)
        code = np.where(live, ((code << 1) | bit) & 0xFFFF, code)
        used = np.where(live, used + 1, used)
    assert not live.any()
    return lo, hi, code, used


def _states(rng, per):
    """Coder states lo <= hi built to give each reachable (k1, k2): k1
    shared leading bits, then lo 0 / hi 1, then k2 positions of lo 1 / hi
    0, then a position that ends the run; plus lo == hi (k1 = 16)."""
    lo, hi = [], []
    for k1 in range(16):
        for k2 in range(16 - k1):
            top = rng.integers(0, 1 << 16, per)
            low = rng.integers(0, 1 << 16, (2, per))
            run = ((1 << k2) - 1) << (15 - k1 - k2)
            stop = 14 - k1 - k2           # the position after the run
            lo_b = (top & ~((1 << (16 - k1)) - 1)) | run
            hi_b = (top & ~((1 << (16 - k1)) - 1)) | (1 << (15 - k1))
            if stop >= 0:
                # (lo, hi) at stop: (0, 0), (0, 1) or (1, 1), not (1, 0)
                pick = rng.integers(0, 3, per)
                lo_b = lo_b | np.where(pick == 2, 1 << stop, 0)
                hi_b = hi_b | np.where(pick >= 1, 1 << stop, 0)
                mask = (1 << stop) - 1
                lo_b = lo_b | (low[0] & mask)
                hi_b = hi_b | (low[1] & mask)
            lo.append(lo_b)
            hi.append(hi_b)
    same = rng.integers(0, 1 << 16, per)
    lo.append(same)
    hi.append(same)
    return np.concatenate(lo), np.concatenate(hi)


def test_renorm_closed_form_equals_bit_loop(qtwin):
    rng = np.random.default_rng(7)
    lo_c, hi_c = _states(rng, 4096)
    n_rand = (1 << 20) - len(lo_c)
    lo = np.concatenate([lo_c, rng.integers(0, 1 << 16, n_rand)])
    hi = np.concatenate([hi_c, rng.integers(0, 1 << 16, n_rand)])
    code = rng.integers(0, 1 << 16, len(lo))
    nxt = rng.integers(0, 1 << 32, len(lo), dtype=np.uint64)
    want = _renorm_loop(lo, hi, code, nxt)
    x = (lo ^ hi) & 0xFFFF
    k1 = np.where(x == 0, 16, 15 - np.floor(np.log2(np.maximum(x, 1))))
    k2 = want[3] - k1
    built = slice(0, len(lo_c))
    pairs = set(zip(k1[built].astype(int).tolist(),
                    k2[built].astype(int).tolist()))
    assert pairs == {(a, b) for a in range(16) for b in range(16 - a)} | \
        {(16, 0)}
    got = [a.astype(np.uint16) for a in (lo, hi, code)]
    used = np.zeros(len(lo), np.uint8)
    nxt32 = nxt.astype(np.uint32)
    qtwin.qt_renorm(_ptr(got[0]), _ptr(got[1]), _ptr(got[2]), _ptr(nxt32),
                    len(lo), _ptr(used))
    for g, w in zip(got + [used], want):
        np.testing.assert_array_equal(g.astype(np.int64), w)


# ---------------------------------------------------- K3 table decode --

def _complete_lengths(rng, n, used, max_len):
    """Code lengths of n symbols, used of them coded, forming a complete
    code of lengths <= max_len: leaves split at random, the deepest often,
    so codes reach past the table's bits."""
    depths = [0]
    while len(depths) < used:
        cand = [i for i, d in enumerate(depths) if d < max_len]
        deep = max(cand, key=lambda i: depths[i])
        i = deep if rng.random() < 0.4 else int(rng.choice(cand))
        d = depths.pop(i) + 1
        depths += [d, d]
    lens = np.zeros(n, np.uint8)
    lens[rng.choice(n, used, replace=False)] = depths
    return lens


def _encode(lens, syms):
    """syms under the canonical code of lens, MSB first, in LZX's 16-bit
    little-endian units."""
    count = np.bincount(lens, minlength=17)
    count[0] = 0
    nxt, code = {}, 0
    for l in range(1, 17):
        code = (code + count[l - 1]) << 1
        nxt[l] = code
    codes = {}
    for s in range(len(lens)):
        if lens[s]:
            codes[s] = (nxt[lens[s]], int(lens[s]))
            nxt[lens[s]] += 1
    bits = "".join(format(codes[s][0], f"0{codes[s][1]}b") for s in syms)
    bits += "0" * (-len(bits) % 16 + 32)
    units = [int(bits[k:k + 16], 2) for k in range(0, len(bits), 16)]
    return np.array(units, "<u2").tobytes()


def _walk(data, lens, nsym):
    """The reference's canonical walk (lzx_core.cuh before the tables,
    lzxd.c's fallback) over ``cuda_lzx._build``'s code: (syms, positions),
    stopping after a -1."""
    count, sym, _ = cl._build(lens.tolist(), len(lens))
    units = np.frombuffer(data, "<u2")
    bits = "".join(format(int(u), "016b") for u in units) + "0" * 32
    pos, out, where = 0, [], []
    for _ in range(nsym):
        code = first = index = 0
        s = -1
        for ln in range(1, 17):
            code |= int(bits[pos + ln - 1])
            c = count[ln]
            if code - c < first:
                s = sym[index + code - first]
                pos += ln
                break
            index += c
            first = (first + c) << 1
            code <<= 1
        out.append(s)
        where.append(pos)
        if s < 0:
            break
    return out, where


def _table_decode(ltwin, lens, tb, data, nsym):
    out = np.zeros(nsym, np.int32)
    pos = np.zeros(nsym, np.int64)
    lens = np.ascontiguousarray(lens, np.uint8)
    left = ltwin.lz_table_decode(_ptr(lens), len(lens), tb, data, len(data),
                                 nsym, _ptr(out), _ptr(pos))
    return left, out, pos


# (tree, symbols, coded symbols, longest code)
TREES = [(0, 256 + 50 * 8, 500, 16), (0, cl.MAIN_MAX, 300, 16),
         (1, cl.NLEN, 249, 16), (1, cl.NLEN, 40, 14), (2, cl.NALN, 8, 7),
         (3, cl.NPRE, 20, 15), (3, cl.NPRE, 9, 8)]


@pytest.mark.parametrize("tree,n,used,max_len", TREES)
def test_table_decode_equals_canonical_walk(ltwin, tree, n, used, max_len):
    tb = ltwin.lz_first_bits(tree)
    rng = np.random.default_rng(1000 * tree + used)
    longest = 0
    for trial in range(6):
        lens = _complete_lengths(rng, n, used, max_len)
        longest = max(longest, int(lens.max()))
        coded = np.flatnonzero(lens)
        syms = rng.choice(coded, 600)
        data = _encode(lens, syms)
        left, out, pos = _table_decode(ltwin, lens, tb, data, len(syms))
        assert left == 0
        want, where = _walk(data, lens, len(syms))
        assert out.tolist() == want == syms.tolist(), trial
        assert pos.tolist() == where, trial
    if max_len > tb:
        assert longest > tb


@pytest.mark.parametrize("tree", [0, 1, 3])
def test_table_decode_incomplete_code_equals_walk(ltwin, tree):
    """Under-subscribed codes (which the decoder rejects when it builds
    them) decode alike too, -1 where no code matches."""
    tb = ltwin.lz_first_bits(tree)
    n = {0: 656, 1: cl.NLEN, 3: cl.NPRE}[tree]
    rng = np.random.default_rng(tree)
    for trial in range(6):
        lens = _complete_lengths(rng, n, min(n, 30), 16 if tree < 3 else 15)
        lens[np.flatnonzero(lens)[:3]] = 0      # drop three codes
        data = rng.integers(0, 256, 512, dtype=np.uint8).tobytes()
        left, out, pos = _table_decode(ltwin, lens, tb, data, 200)
        assert left > 0
        want, where = _walk(data, lens, 200)
        k = len(want)
        assert out[:k].tolist() == want, trial
        assert pos[:k].tolist() == where, trial


# ------------------------------------------------- token caps, twin == plain

@pytest.fixture(scope="module")
def lzx_cases():
    return le.lzx_edge_batch(seed=0)


@pytest.mark.parametrize("cap", [1, 2, 3, 5, 40])
def test_lzx_twin_equals_plain_at_token_caps(ltwin, lzx_cases, cap):
    sub = [lzx_cases[i] for i in le.groups(lzx_cases)[(15, False)]]
    s, lens, tg, hs = le.inputs(sub)
    plain = cl.lzx_phase_a_plain(s, lens, tg, hs, 15, tcap=cap)
    L = len(sub)
    state = torch.empty((L, cl.STATE_BYTES), dtype=torch.uint8)
    tok = torch.full((L, cap), -1, dtype=torch.int32)
    litw = torch.zeros((L, cap), dtype=torch.int32)
    cnt = torch.zeros((8, L), dtype=torch.int32)
    assert ltwin.lz_decode_host(
        s.data_ptr(), s.stride(0), lens.data_ptr(), tg.data_ptr(),
        hs.data_ptr(), L, 15, 0, 1, state.data_ptr(), tok.data_ptr(),
        litw.data_ptr(), cap, cnt.data_ptr()) == 0
    assert (plain[2][0] == 2).sum() >= 5
    for a, b in zip((tok, litw, cnt, state), plain):
        assert torch.equal(a, b)


@pytest.fixture(scope="module")
def qtm_cases():
    return qe.qtm_edge_batch(seed=0)


@pytest.mark.parametrize("cap", [1, 3, 40])
def test_qtm_twin_equals_plain_at_token_caps(qtwin, qtm_cases, cap):
    sub = [qtm_cases[i] for i in qe.groups(qtm_cases)[12]]
    s, lens, tg = qe.inputs(sub)
    plain = cq.qtm_phase_a_plain(s, lens, tg, 12, tcap=cap)
    L = len(sub)
    state = torch.empty((L, cq.STATE_BYTES), dtype=torch.uint8)
    tok = torch.full((L, cap), -1, dtype=torch.int32)
    litw = torch.zeros((L, cap), dtype=torch.int32)
    cnt = torch.zeros((8, L), dtype=torch.int32)
    assert qtwin.qt_decode_host(
        s.data_ptr(), s.stride(0), lens.data_ptr(), tg.data_ptr(), L, 12, 1,
        state.data_ptr(), tok.data_ptr(), litw.data_ptr(), cap,
        cnt.data_ptr()) == 0
    assert (plain[2][0] == 2).all()
    for a, b in zip((tok, litw, cnt, state), plain):
        assert torch.equal(a, b)


# ------------------------------------------------------ wrapper, build log

def test_word_aligned_pads_only_misaligned_rows():
    s = torch.arange(2 * 8, dtype=torch.uint8).reshape(2, 8)
    assert cl.word_aligned(s) is s
    odd = torch.arange(3 * 7, dtype=torch.uint8).reshape(3, 7)
    got = cl.word_aligned(odd)
    assert got.shape == (3, 8) and got.stride(0) == 8
    assert torch.equal(got[:, :7], odd) and not got[:, 7].any()
    view = torch.arange(2 * 9, dtype=torch.uint8).reshape(2, 9)[:, 1:]
    got = cl.word_aligned(view)
    assert got.data_ptr() % 4 == 0 and torch.equal(got[:, :8], view)


_PTXAS = """\
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_Z13k3_lzx_kernelPKhlPKiS2_S2_iiiiPN2lz5StateEPiS6_iS6_' for 'sm_90a'
ptxas info    : Function properties for _Z13k3_lzx_kernelPKhlPKiS2_S2_iiiiPN2lz5StateEPiS6_iS6_
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 86 registers, used 0 barriers, 19968 bytes smem, 424 bytes cmem[0]
ptxas info    : Function properties for _Z6helperv
    8 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_115p1_sweep_kernelILb1EEEviiPiS1_' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_115p1_sweep_kernelILb1EEEviiPiS1_
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 32 registers, used 0 barriers, 8192 bytes smem
"""


def test_ptxas_report_names_each_kernel():
    got = kernels.ptxas_report(_PTXAS)
    assert set(got) == {"k3_lzx_kernel", "p1_sweep_kernel<true>"}
    assert got["k3_lzx_kernel"].startswith("0 bytes stack frame")
    assert "Used 86 registers" in got["k3_lzx_kernel"]
    assert "19968 bytes smem" in got["k3_lzx_kernel"]
    assert "8 bytes stack" not in got["k3_lzx_kernel"]
    assert "Used 32 registers" in got["p1_sweep_kernel<true>"]
