"""The designs of K1 (one warp per frame, first-level tables) and K2 (two
passes over all frames) against the plain versions, through the g++ twins
of ``deflate_core.cuh`` and ``resolve_core.cuh``, whose warp lanes and
block threads run one after another on the CPU.

* K2: both passes (the twin's pass 1, then its pass 2) against
  ``resolve_frames_plain``, bytes and counts, on zlib frames chained by
  preset dictionaries, on the edge batch's traces and on hand-built traces
  (distance-1 runs that make a marker of a marker of a marker, matches
  reaching back across two earlier lanes, full 32 KiB lanes whose markers
  name ring slots the lane overwrites, a match before the chain's
  start, empty lanes between chains, a match cut at the lane's end,
  literal tokens of 5-7 bytes, ``ntok`` above the row, NOPs); pass 1
  alone against a replay that tracks where each byte comes from.
* K1: the first-level table decode against puff's canonical walk (fixed
  codes, complete codes up to 15 bits, incomplete and over-subscribed
  codes); the LSB-first word reader against a byte reader (values, tell(),
  zeros past the end, unaligned starts); the twin against the plain
  version at token caps 1, 2, 5 and 40.

Tolerance: exact. Inputs are made from numpy seeds and zlib.
"""
import zlib

import numpy as np
import pytest
import torch

from libmspack_tpu_torch import edge_cases as ec
from libmspack_tpu_torch import kernels
from libmspack_tpu_torch.ops import cuda_inflate as ci
from libmspack_tpu_torch.ops import cuda_resolve as cr

LIT, MATCH = ci.TOK_LIT, ci.TOK_MATCH


def _ptr(a):
    return a.ctypes.data


@pytest.fixture(scope="module")
def rtwin():
    try:
        return kernels.host_twin_resolve()
    except RuntimeError as e:
        pytest.skip(f"g++ build of the kernel core unavailable: {e}")


@pytest.fixture(scope="module")
def dtwin():
    try:
        return kernels.host_twin()
    except RuntimeError as e:
        pytest.skip(f"g++ build of the kernel core unavailable: {e}")


# ------------------------------------------------------------------ K2 --

def _np_traces(tok, litw, ntok):
    return (np.ascontiguousarray(np.asarray(tok), np.int32),
            np.ascontiguousarray(np.asarray(litw), np.int32),
            np.ascontiguousarray(np.asarray(ntok), np.int32))


def _twin_resolve(rtwin, tok, litw, ntok, sizes, flags):
    tok, litw, ntok = _np_traces(tok, litw, ntok)
    lens = np.asarray(sizes, np.int32)
    off, chains = cr._layout(lens, flags)
    woff = cr._slots(lens)
    avail = cr._chain_bytes(off, chains)
    work = np.zeros(max(1, int(woff[-1])), np.uint16)
    out = np.zeros(max(1, int(off[-1])), np.uint8)
    counts = np.zeros(len(lens), np.int32)
    assert rtwin.rs_resolve_host(
        _ptr(tok), _ptr(litw), tok.shape[1], _ptr(ntok), _ptr(lens),
        _ptr(off), _ptr(woff), _ptr(avail), _ptr(chains), len(chains) - 1,
        len(lens), _ptr(work), _ptr(out), _ptr(counts)) == 0
    return out[:int(off[-1])], counts


def _twin_pass1(rtwin, tok, litw, ntok, sizes, flags):
    tok, litw, ntok = _np_traces(tok, litw, ntok)
    lens = np.asarray(sizes, np.int32)
    off, chains = cr._layout(lens, flags)
    woff = cr._slots(lens)
    avail = cr._chain_bytes(off, chains)
    work = np.zeros(max(1, int(woff[-1])), np.uint16)
    counts = np.zeros(len(lens), np.int32)
    assert rtwin.rs_pass1_host(
        _ptr(tok), _ptr(litw), tok.shape[1], _ptr(ntok), _ptr(lens),
        _ptr(woff), _ptr(avail), len(lens), _ptr(work), _ptr(counts)) == 0
    return [work[woff[i]:woff[i] + lens[i]] for i in range(len(lens))], counts


def _check_k2(rtwin, tok, litw, ntok, sizes, flags):
    tok_t, litw_t = torch.as_tensor(np.asarray(tok, np.int32)), \
        torch.as_tensor(np.asarray(litw, np.int32))
    ntok_t = torch.as_tensor(np.asarray(ntok, np.int32))
    want, wcnt = cr.resolve_frames_device(tok_t, litw_t, ntok_t, sizes, flags)
    got, gcnt = _twin_resolve(rtwin, tok, litw, ntok, sizes, flags)
    assert gcnt.tolist() == wcnt.tolist()
    np.testing.assert_array_equal(got, want.numpy())
    return got, gcnt


def _lanes(token_lists, width=None):
    """Hand-built traces: one list of (tok, litw) per lane -> tok, litw
    (L, width) padded with NOPs, ntok."""
    width = width or max(1, max(len(t) for t in token_lists))
    tok = np.full((len(token_lists), width), ci.TOK_NOP, np.int32)
    litw = np.zeros_like(tok)
    for i, toks in enumerate(token_lists):
        for j, (v, w) in enumerate(toks[:width]):
            tok[i, j] = v
            litw[i, j] = np.int64(w).astype(np.int32)
    return tok, litw, np.array([len(t) for t in token_lists], np.int32)


def lit(data):
    """Literal tokens of up to 4 bytes for ``data``."""
    out = []
    for k in range(0, len(data), 4):
        part = data[k:k + 4]
        out.append((LIT | len(part), int.from_bytes(part, "little")))
    return out


def match(length, dist, pending=b""):
    return (MATCH | (len(pending) << 25) | (length << 16) | (dist - 1),
            int.from_bytes(pending, "little"))


def _zlib_chain():
    """Frames of one folder chained by preset dictionaries, a stored
    frame, a distance-1 run and a periodic one (``test_torch_resolve``'s
    kind), decoded by K1's plain version."""
    rng = np.random.RandomState(11)
    words = [b"alpha ", b"beta ", b"gamma ", b"delta ", b"epsilon "]
    text = b"".join(words[i] for i in rng.randint(0, 5, 4000))
    F = 4096
    raws = [text[:F], text[F:2 * F], text[2 * F:2 * F + 3000],
            rng.randint(0, 256, 1000).astype(np.uint8).tobytes(),
            bytes([9]) * 700,
            (b"xyz" + bytes(rng.randint(97, 100, 5).astype(np.uint8))) * 90]

    def deflate(raw, level=9, zdict=None):
        args = (level, zlib.DEFLATED, -15, 9, zlib.Z_DEFAULT_STRATEGY)
        co = zlib.compressobj(*args, zdict) if zdict else \
            zlib.compressobj(*args)
        return co.compress(raw) + co.flush()

    frames = [deflate(raws[0]), deflate(raws[1], zdict=raws[0]),
              deflate(raws[2], zdict=raws[0] + raws[1]), deflate(raws[3], 6),
              deflate(raws[4], 1), deflate(raws[5])]
    flags = [0, 1, 1, 0, 0, 0]
    s, lens = ci.pack_streams(frames)
    hists = torch.tensor([32768 * f for f in flags], dtype=torch.int32)
    tok, litw, cnt = ci.inflate_phase_a(s, lens, hists, tcap=F)
    assert (cnt[0] == 0).all()
    return raws, flags, tok, litw, cnt


def test_k2_twin_equals_plain_on_zlib_chain(rtwin):
    raws, flags, tok, litw, cnt = _zlib_chain()
    got, counts = _check_k2(rtwin, tok, litw, cnt[2], [len(r) for r in raws],
                            flags)
    assert got.tobytes() == b"".join(raws)
    assert counts.tolist() == [len(r) for r in raws]


@pytest.mark.parametrize("frame", [512, 4096])
def test_k2_twin_equals_plain_on_edge_batch(rtwin, frame):
    cases = ec.edge_case_batch(frame, seed=5, variants=2)
    s, lens = ci.pack_streams([c.stream for c in cases])
    hists = torch.tensor([c.hist for c in cases], dtype=torch.int32)
    tok, litw, cnt = ci.inflate_phase_a(s, lens, hists, tcap=frame)
    sizes = [len(c.raw) if c.raw is not None else 0 for c in cases]
    flags = [int(c.chained) for c in cases]
    got, counts = _check_k2(rtwin, tok, litw, cnt[2], sizes, flags)
    off = np.concatenate([[0], np.cumsum(sizes)])
    for i, c in enumerate(cases):
        if c.raw is not None:
            assert got[off[i]:off[i + 1]].tobytes() == c.raw, c.name
    # the same traces with every corrupt lane given a size: what they
    # resolve to (some bytes, then zeros) equals too
    sizes = [len(c.raw) if c.raw is not None else 100 for c in cases]
    _check_k2(rtwin, tok, litw, cnt[2], sizes, flags)


HAND = {
    # a distance-1 run at the start of each of three chained lanes: each
    # lane's bytes are markers of the lane before's last byte
    "marker_chain": ([lit(b"abcdefgh"), [match(100, 1)], [match(60, 1)],
                      [match(258, 1)]], [8, 100, 60, 258], [0, 1, 1, 1]),
    # small lanes; lane 2 reaches back across lanes 1 and 0
    "two_lanes_back": ([lit(b"0123456789"), lit(b"ABCDEFGHIJ"),
                        [match(12, 18), match(8, 17, b"xy")]],
                       [10, 10, 22], [0, 1, 1]),
    # a match before the chain's start (8 bytes behind, 3 present)
    "before_chain": ([lit(b"abc"), [match(4, 8)] + lit(b"zz"),
                      lit(b"next")], [3, 6, 4], [0, 1, 0]),
    # empty lanes between chains (and a chain of one empty lane)
    "empty_lanes": ([lit(b"first"), [], [], lit(b"second"), [], lit(b"ab")
                     + [match(6, 2)]], [5, 0, 0, 6, 0, 8], [0, 0, 1, 0, 1, 0]),
    # a match cut at the lane's end: count past the size
    "cut_match": ([lit(b"abcd") + [match(40, 4)], lit(b"tail")],
                  [20, 4], [0, 1]),
    # literal tokens of 5-7 bytes: bytes 4.. are zeros
    "long_literals": ([[(LIT | 5, 0x44434241), (LIT | 7, 0x48474645),
                        (LIT | 6, 0x4C4B4A49)], [match(10, 18)]],
                      [18, 10], [0, 1]),
    # NOPs between and before tokens
    "nops": ([[(ci.TOK_NOP, 0)] + lit(b"ab") + [(ci.TOK_NOP, 0)]
              + [match(5, 1)] + [(ci.TOK_NOP, 0)]], [7], [0]),
}


@pytest.mark.parametrize("name", sorted(HAND))
def test_k2_twin_equals_plain_on_hand_traces(rtwin, name):
    toks, sizes, flags = HAND[name]
    tok, litw, ntok = _lanes(toks)
    got, counts = _check_k2(rtwin, tok, litw, ntok, sizes, flags)
    if name == "marker_chain":
        assert got.tobytes() == b"abcdefgh" + b"h" * 418
    if name == "two_lanes_back":
        assert got[20:].tobytes() == b"23456789ABCDxyHIJ23456"
    if name == "before_chain":
        assert counts.tolist() == [3, -1, 4]
    if name == "cut_match":
        assert counts.tolist() == [44, 4]
    if name == "long_literals":
        assert got[:18].tobytes() == b"ABCD\0EFGH\0\0\0IJKL\0\0"


def test_k2_full_lanes_reaching_far_back(rtwin):
    """Full 32 KiB lanes whose matches reach 30000 and 32768 bytes back:
    their markers name ring slots that the lane's own bytes overwrite, so
    pass 2 must read the whole lane before it writes any of it."""
    rng = np.random.RandomState(7)
    first = rng.randint(0, 256, 32768).astype(np.uint8).tobytes()
    far = [match(258, 30000)] * 127 + [match(2, 30000)]
    whole = [match(258, 32768)] * 127 + [match(2, 32768)]
    near = lit(b"q") + [match(200, 1)] + [match(258, 29999)] * 126
    tok, litw, ntok = _lanes([lit(first), far, whole, near, far])
    got, counts = _check_k2(rtwin, tok, litw, ntok, [32768] * 5,
                            [0, 1, 1, 1, 1])
    assert counts.tolist()[:3] == [32768] * 3
    assert got[32768:32768 + 30000].tobytes() == first[2768:]


def test_k2_ntok_above_row_width(rtwin):
    tok, litw, _ = _lanes([lit(b"abcdefgh") + [match(8, 8)],
                           [match(30, 4)] + lit(b"zz")], width=3)
    for ntok in ([3, 3], [50, 7], [0, 2]):
        _check_k2(rtwin, tok, litw, ntok, [16, 32], [0, 1])


def _pass1_spec(toks, litws, nt, n, avail):
    """The values pass 1 must leave: a replay in which each byte is a byte
    or, where its source lies k bytes before the 32 KiB window's end, the
    marker 256 + 32768 - k. Returns (values, count)."""
    vals = [0] * n
    dst = 0
    for v, w in zip(toks[:nt], litws[:nt]):
        if dst >= n:
            break
        if v < 0:
            continue
        if v < MATCH:
            nl, ln, dist = v & 7, 0, 1
        else:
            nl, ln, dist = (v >> 25) & 3, (v >> 16) & 0x1FF, (v & 0x7FFF) + 1
        for k in range(min(nl, n - dst)):
            vals[dst + k] = ((w & 0xFFFFFFFF) >> (8 * k)) & 0xFF if k < 4 \
                else 0
        d = dst + nl
        if ln and d < n:
            if d - dist < -avail:
                return vals, -1
            for o in range(min(ln, n - d)):
                s = d - dist + o % dist
                vals[d + o] = vals[s] if s >= 0 else 256 + 32768 + s
        dst = d + ln
    return vals, dst


def test_k2_pass1_markers_where_sources_precede_lane(rtwin):
    raws, flags, tok, litw, cnt = _zlib_chain()
    sizes = [len(r) for r in raws]
    toks = [HAND[k] for k in ("marker_chain", "two_lanes_back")]
    work, counts = _twin_pass1(rtwin, tok, litw, cnt[2], sizes, flags)
    lens = np.asarray(sizes, np.int32)
    off, chains = cr._layout(lens, flags)
    avail = cr._chain_bytes(off, chains)
    plain = b"".join(raws)
    markers = 0
    for i in range(len(sizes)):
        want, c = _pass1_spec(tok[i].tolist(), litw[i].tolist(),
                              int(cnt[2, i]), sizes[i], int(avail[i]))
        assert work[i].tolist() == want, i
        assert counts[i] == c
        # a marker names the byte its source is in the plain output
        for p, v in enumerate(want):
            if v >= 256:
                markers += 1
                assert plain[off[i] - 32768 + v - 256] == plain[off[i] + p]
            else:
                assert v == plain[off[i] + p]
    assert markers > 1000
    for ts, sz, fl in toks:
        t, lw, nt = _lanes(ts)
        work, counts = _twin_pass1(rtwin, t, lw, nt, sz, fl)
        o, ch = cr._layout(np.asarray(sz, np.int32), fl)
        av = cr._chain_bytes(o, ch)
        for i in range(len(sz)):
            want, c = _pass1_spec(t[i].tolist(), lw[i].tolist(), int(nt[i]),
                                  sz[i], int(av[i]))
            assert work[i].tolist() == want and counts[i] == c


def test_k2_wrapper_refuses_lanes_above_32768():
    tok = torch.zeros((2, 4), dtype=torch.int32)
    n = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(ValueError, match="32768"):
        cr.resolve_frames_device(tok, tok, n, [32769, 1], [0, 0])
    out, counts = cr.resolve_frames_device(tok, tok, n, [32768, 1], [0, 0])
    assert counts.tolist() == [0, 0] and len(out) == 32769


# ------------------------------------------------------------------ K1 --

def _canonical(lens):
    """(count, sym) of a canonical code (puff's construction)."""
    count = np.bincount(np.asarray(lens, np.int64), minlength=16)[:16].copy()
    count[0] = 0
    sym = [s for ln in range(1, 16) for s in range(len(lens)) if lens[s] == ln]
    return count.tolist(), sym


def _codes(lens):
    count, _ = _canonical(lens)
    nxt, code = {}, 0
    for ln in range(1, 16):
        code = (code + count[ln - 1]) << 1
        nxt[ln] = code
    codes = {}
    for s, ln in enumerate(lens):
        if ln:
            codes[s] = (nxt[ln], ln)
            nxt[ln] += 1
    return codes


def _encode(lens, syms, extra=b"\x5a\xc3"):
    """syms under the canonical code, each code's bits first-bit-first
    into an LSB-first stream (DEFLATE's packing), then ``extra``."""
    codes = _codes(lens)
    bits = "".join(format(codes[s][0], f"0{codes[s][1]}b") for s in syms)
    bits += "".join(format(b, "08b")[::-1] for b in extra)
    bits += "0" * (-len(bits) % 8)
    return bytes(int(bits[k:k + 8][::-1], 2) for k in range(0, len(bits), 8))


def _walk(data, lens, nsym):
    """puff's canonical walk, one bit at a time, zeros past the end:
    (symbols, bit positions after each), stopping after a -1."""
    count, sym = _canonical(lens)
    bits = "".join(format(b, "08b")[::-1] for b in data) + "0" * 64
    pos, out, where = 0, [], []
    for _ in range(nsym):
        code = first = index = 0
        s = -1
        for ln in range(1, 16):
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


def _table_decode(dtwin, lens, tb, data, nsym):
    out = np.zeros(nsym, np.int32)
    pos = np.zeros(nsym, np.int64)
    lens = np.ascontiguousarray(lens, np.uint8)
    r = dtwin.dc_table_decode(_ptr(lens), len(lens), tb, data, len(data),
                              nsym, _ptr(out), _ptr(pos))
    return r, out, pos


def _complete_lengths(rng, n, used, max_len):
    """Lengths of a complete code of ``used`` of n symbols, at most
    max_len, the deepest leaf split often so codes pass the table's bits."""
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


TABLES = [("lit", 288, 10), ("dist", 32, 8), ("cl", 19, 7)]


def test_k1_table_decode_fixed_codes(dtwin):
    rng = np.random.default_rng(0)
    for lens, tb, n in ((ci.FIXED_LIT_LENS, 10, 288),
                        (ci.FIXED_DIST_LENS[:30], 8, 30)):
        lens = np.array(lens, np.uint8)
        syms = rng.integers(0, n, 700)
        data = _encode(lens, syms)
        r, out, pos = _table_decode(dtwin, lens, tb, data, len(syms))
        want, where = _walk(data, lens, len(syms))
        assert r == 0 and out.tolist() == want == syms.tolist()
        assert pos.tolist() == where
    # the fixed distance code of 30 symbols: codes 30 and 31 miss
    lens = np.full(30, 5, np.uint8)
    data = bytes([0b11111, 0])  # code 31 (5 bits of 1): reversed, all ones
    r, out, _ = _table_decode(dtwin, lens, 8, data, 1)
    assert out[0] == -1


@pytest.mark.parametrize("name,n,tb", TABLES)
def test_k1_table_decode_complete_codes(dtwin, name, n, tb):
    rng = np.random.default_rng(n)
    longest = 0
    for trial in range(8):
        used = int(rng.integers(2, n + 1))
        lens = _complete_lengths(rng, n, used, 15 if name != "cl" else 7)
        longest = max(longest, int(lens.max()))
        syms = rng.choice(np.flatnonzero(lens), 500)
        data = _encode(lens, syms)
        r, out, pos = _table_decode(dtwin, lens, tb, data, len(syms))
        want, where = _walk(data, lens, len(syms))
        assert r == 0
        assert out.tolist() == want == syms.tolist(), trial
        assert pos.tolist() == where, trial
    if name != "cl":
        assert longest > tb


@pytest.mark.parametrize("name,n,tb", TABLES)
def test_k1_table_decode_incomplete_and_oversubscribed(dtwin, name, n, tb):
    rng = np.random.default_rng(100 + n)
    for trial in range(6):
        lens = _complete_lengths(rng, n, min(n, 12), 15 if name != "cl" else 7)
        coded = np.flatnonzero(lens)
        lens[coded[np.argsort(lens[coded])][:2]] = 0   # drop the 2 shortest
        data = rng.integers(0, 256, 256, dtype=np.uint8).tobytes()
        r, out, pos = _table_decode(dtwin, lens, tb, data, 150)
        want, where = _walk(data, lens, 150)
        assert r == 0
        assert out[:len(want)].tolist() == want, trial
        assert pos[:len(want)].tolist() == where, trial
    assert -1 in want or name == "cl"
    over = _complete_lengths(rng, n, min(n, 9), 7)
    over[np.flatnonzero(over == 0)[:1]] = 1     # one more code of length 1
    r, _, _ = _table_decode(dtwin, over, tb, b"\0" * 8, 4)
    assert r == -1


@pytest.mark.parametrize("shift", [0, 1, 2, 3])
def test_k1_reader_tell_and_zeros_past_end(dtwin, shift):
    rng = np.random.default_rng(shift)
    data = rng.integers(0, 256, 37, dtype=np.uint8).tobytes()
    # the stream starts `shift` bytes into an aligned buffer
    buf = np.zeros(64, np.uint8)
    base = (-buf.ctypes.data) % 4
    buf[base + shift:base + shift + len(data)] = np.frombuffer(data, np.uint8)
    buf[base + shift + len(data):] = 0xFF   # must read as zeros
    ks = rng.integers(0, 33, 60).astype(np.int32)
    vals = np.zeros(len(ks), np.uint32)
    pos = np.zeros(len(ks), np.int64)
    dtwin.dc_read_bits(buf.ctypes.data + base + shift, len(data), _ptr(ks),
                       len(ks), _ptr(vals), _ptr(pos))
    acc = int.from_bytes(data, "little")
    p = 0
    for k, v, q in zip(ks.tolist(), vals.tolist(), pos.tolist()):
        assert v == (acc >> p) & ((1 << k) - 1)
        p += k
        assert q == p
    assert p > 8 * len(data)       # the reads ran past the end


@pytest.fixture(scope="module")
def edge_batch():
    cases = ec.edge_case_batch(4096, seed=4)
    s, lens = ci.pack_streams([c.stream for c in cases])
    hists = torch.tensor([c.hist for c in cases], dtype=torch.int32)
    return s, lens, hists


@pytest.mark.parametrize("cap", [1, 2, 5, 40])
def test_k1_twin_equals_plain_at_token_caps(dtwin, edge_batch, cap):
    s, lens, hists = edge_batch
    plain = ci.inflate_phase_a_plain(s, lens, hists, tcap=cap)
    L = s.shape[0]
    tok = torch.full((L, cap), -1, dtype=torch.int32)
    litw = torch.zeros((L, cap), dtype=torch.int32)
    cnt = torch.zeros((8, L), dtype=torch.int32)
    assert dtwin.dc_inflate_host(s.data_ptr(), s.stride(0), lens.data_ptr(),
                                 hists.data_ptr(), L, tok.data_ptr(),
                                 litw.data_ptr(), cap, cnt.data_ptr()) == 0
    assert (plain[2][0] == 2).sum() >= 5
    for a, b in zip((tok, litw, cnt), plain):
        assert torch.equal(a, b)
