"""K4 and K3 as their CUDA kernels decompose the work, on the CPU.

K4 (``csrc/pack.cu``): a Python model of the one-pass pack -- tiles of
THREADS runs of RUN symbols, the tile's (bits, tail) segment from the
runs' own tails, each run's codes shifted through a 64-bit accumulator
into the tile's word buffer (a word the run covers alone is stored, its
first and last word ORed),
the decoupled look-back over predecessors published as aggregates or
inclusive prefixes, and the store of every word that ends inside the tile
-- must equal ``pack_bits_plain`` and ``huffman.encode`` byte for byte.
The model also checks the design's claims: no stored word is ever ORed or
stored again, the look-back's prefix equals the fold of every earlier
tile, and each output word is stored exactly once.

K3 (``csrc/hist.cu``): a model of the split into the register bins (the
hinted radius and symbol 0), the shared-memory window and the global
spill, with the kernel's head / 16-byte body / tail partition of the
symbols, must equal ``torch.bincount`` whatever the hint.

The constants come from the CUDA sources, the cases from chip_smoke.py
(which runs the same cases through the kernels on the card).  Inputs
from numpy seeds; tolerance: exact (equal bytes, equal counts).
"""

import re
from types import SimpleNamespace

import numpy as np
import pytest
import torch
torch.set_num_threads(1)  # xdist workers share the cores: one thread each

from sz_tpu_torch.format import huffman
from sz_tpu_torch.gpu import hist_kernel, pack_kernel

from _chip_smoke import REPO, SMOKE

CSRC = REPO / "sz_tpu_torch" / "csrc"
M31, M32, M64 = (1 << 31) - 1, (1 << 32) - 1, (1 << 64) - 1
AGG, INC = 1, 2   # a tile's published state (pack.cu kAggregate/kInclusive)


def _constants(name: str) -> dict:
    """The `constexpr int kX = expr;` of a CUDA source, evaluated."""
    env = {}
    for key, expr in re.findall(r"constexpr int (k\w+) = ([^;,]+);",
                                (CSRC / name).read_text()):
        env[key] = int(eval(expr.replace("/", "//"), {}, dict(env)))
    return env


PACK = _constants("pack.cu")
HIST = _constants("hist.cu")
PACK_CASES = SMOKE.PACK_CASE_NAMES
HIST_CASES = SMOKE.HIST_CASE_NAMES


def test_constants_match_the_cuda_sources():
    assert PACK["kThreads"] == pack_kernel.THREADS
    assert PACK["kRun"] == pack_kernel.RUN
    assert PACK["kTile"] == pack_kernel.TILE
    assert PACK["kWords"] == pack_kernel.TILE * 128 // 32 + 1
    assert PACK["kLookback"] == 32
    assert PACK["kRun"] % 4 == 0
    assert PACK["kBlock"] == PACK["kThreads"] + 32
    assert HIST["kWindow"] == hist_kernel.WINDOW
    assert HIST["kBins"] == hist_kernel.NBINS
    # the names the tests parametrize on are the cases the card runs
    assert tuple(c[0] for c in SMOKE.pack_cases()) == PACK_CASES
    assert tuple(c[0] for c in SMOKE.hist_cases()) == HIST_CASES


# --- K4 ------------------------------------------------------------------

def join(a, b):
    """pack.cu join(): segment a followed by segment b."""
    bits = a[0] + b[0]
    tail = b[1] if b[0] >= 31 else ((a[1] << b[0]) | b[1]) & M31
    return bits, tail


def code_word(hi: int, lo: int, q: int, length: int) -> int:
    w = (hi >> 32, hi & M32, lo >> 32, lo & M32)[q] if q < 4 else 0
    keep = length - 32 * q
    return w if keep >= 32 else w & ~(M32 >> keep) & M32


def tile_tail(sh, m: int) -> int:
    k = min(m, 31)
    if k == 0:
        return 0
    p = m - k
    x = (sh[p >> 5] << 32) | sh[(p >> 5) + 1]
    return ((x << (p & 31)) & M64) >> (64 - k)


def code_tail(hi: int, lo: int, length: int) -> int:
    """pack.cu code_tail(): the code's last min(length, 31) bits."""
    if length <= 64:
        v = hi >> (64 - length)
    elif length < 128:
        v = ((hi << (length - 64)) | (lo >> (128 - length))) & M64
    else:
        v = 0 if length - 128 >= 64 else (lo << (length - 128)) & M64
    return v & M31


def look_back(t: int, agg, inc, state):
    """pack.cu look_back(): lane l of the warp reads tile j - l; the fold
    runs up to the nearest inclusive prefix, else over all 32 aggregates
    and one step further back."""
    width = PACK["kLookback"]
    suffix = (0, 0)
    j = t - 1
    while True:
        idx = [j - lane for lane in range(width)]
        f = [INC if i < 0 else state[i] for i in idx]
        incl = [lane for lane in range(width) if f[lane] == INC]
        stop = incl[0] if incl else width - 1
        w = (0, 0)
        for k in range(stop, -1, -1):       # earliest tile first
            i = idx[k]
            w = join(w, (0, 0) if i < 0 else (inc if f[k] == INC else agg)[i])
        suffix = join(w, suffix)
        if incl:
            return suffix
        j -= width


def _put(sh, how, w, v, shared):
    assert w < PACK["kWords"] - 1, "a word past the tile's buffer"
    if shared:
        assert how.get(w) != "store", f"word {w} stored, then ORed"
        how[w] = "or"
        sh[w] |= v
    else:
        assert w not in how, f"word {w} written twice"
        how[w] = "store"
        sh[w] = v


def model_pack(sym, code_hi, code_lo, code_len, total_bits, seed=0):
    """The bytes pack_lookback_kernel writes, tile after tile, each tile's
    look-back reading a random mix of aggregates and inclusive prefixes."""
    rng = np.random.default_rng(seed)
    threads, run, tile = PACK["kThreads"], PACK["kRun"], PACK["kTile"]
    sym = np.asarray(sym, np.int64)
    n, nst = len(sym), len(code_len)
    nwords, nbytes = (total_bits + 31) // 32, (total_bits + 7) // 8
    if n == 0 or nwords == 0:   # the wrapper launches nothing
        return b""
    hi = [int(v) for v in code_hi]
    lo = [int(v) for v in code_lo]
    ntiles = -(-n // tile)
    out = np.zeros(nwords, np.uint32)
    stores = np.zeros(nwords, np.int64)
    agg, inc = [], []
    for t in range(ntiles):
        s = np.full(tile, -1, np.int64)
        part = sym[t * tile:(t + 1) * tile]
        s[:len(part)] = part
        valid = (s >= 0) & (s < nst)
        lens = np.where(valid, np.asarray(code_len)[np.where(valid, s, 0)],
                        0).astype(np.int64)
        bits = lens.reshape(threads, run).sum(1)
        offs = np.cumsum(bits) - bits
        m = int(bits.sum())
        # the tile's tail from the runs' own tails, before any packing
        or_tail = 0
        for th in range(threads):
            run_tail = 0
            for q in range(run):
                ln = int(lens[th * run + q])
                if ln > 0:
                    sq = int(s[th * run + q])
                    c = code_tail(hi[sq], lo[sq], ln)
                    run_tail = c if ln >= 31 else (
                        (run_tail << ln) | c) & M31
            end = int(offs[th] + bits[th])
            if bits[th] > 0 and end > m - 31:
                or_tail |= ((run_tail << (m - end)) & M64) & M31
        sh = [0] * PACK["kWords"]
        how = {}
        for th in range(threads):
            if bits[th] == 0:
                continue
            w, nacc = int(offs[th]) >> 5, int(offs[th]) & 31
            first_shared, acc = nacc != 0, 0
            for q in range(run):
                ln = int(lens[th * run + q])
                if ln <= 0:
                    continue
                sq = int(s[th * run + q])
                h, lw = hi[sq], lo[sq] if ln > 64 else 0
                c = 0
                while 32 * c < ln:
                    acc |= (code_word(h, lw, c, ln) << 32) >> nacc
                    nacc += min(ln - 32 * c, 32)
                    if nacc >= 32:
                        _put(sh, how, w, acc >> 32, first_shared)
                        first_shared = False
                        w += 1
                        acc = (acc << 32) & M64
                        nacc -= 32
                    c += 1
            if nacc > 0:
                _put(sh, how, w, acc >> 32, True)
        own = (m, or_tail)
        assert or_tail == tile_tail(sh, m)   # the packed words agree
        agg.append(own)
        before = (0, 0)
        if t:
            state = np.full(t, AGG)
            if rng.random() < 0.5:   # else only tile 0 is inclusive
                state[rng.random(t) < 0.3] = INC
            state[0] = INC
            before = look_back(t, agg, inc, state)
            fold = (0, 0)
            for a in agg[:t]:
                fold = join(fold, a)
            assert before == fold
        inc.append(join(before, own))
        g0, r = before[0] >> 5, before[0] & 31
        nout = (r + m) >> 5
        if t == ntiles - 1 and (r + m) & 31:
            nout += 1
        for j in range(nout):
            v = sh[j]
            if r:
                v = (((sh[j - 1] if j else before[1]) << (32 - r)) & M32) \
                    | (v >> r)
            if g0 + j < nwords:
                out[g0 + j] = v
                stores[g0 + j] += 1
    assert (stores == 1).all(), "an output word stored twice or never"
    return out.astype(">u4").tobytes()[:nbytes]


def _pack_case(name):
    case = next(c for c in SMOKE.pack_cases() if c[0] == name)
    _, sym, (hi, lo, ln) = case
    return sym, hi, lo, ln, SMOKE.code_bits(sym, ln)


def _i64(a):
    return torch.from_numpy(np.ascontiguousarray(a, np.uint64).view(np.int64))


@pytest.mark.parametrize("name", PACK_CASES)
def test_pack_model_matches_plain_and_encode(name):
    sym, hi, lo, ln, total = _pack_case(name)
    got = model_pack(sym, hi, lo, ln, total, seed=len(sym))
    plain = pack_kernel.pack_bits(
        torch.from_numpy(sym), _i64(hi), _i64(lo), torch.from_numpy(ln),
        total).numpy().tobytes()
    assert got == plain
    keep = sym[(sym >= 0) & (sym < len(ln))]
    tables = SimpleNamespace(code_hi=hi, code_lo=lo, code_len=ln)
    assert got == huffman.encode(tables, keep)


def test_pack_cases_reach_what_they_name():
    """The cases cover the code lengths, many tiles and the word that
    every run of a tile shares (test_look_back_equals_the_fold steps the
    look-back over several rounds)."""
    assert set(SMOKE.edge_code_table()[2].tolist()) >= {
        1, 31, 32, 33, 64, 65, 128}
    sym, *_ = _pack_case("zipf_41_tiles")
    assert len(sym) == 41 * pack_kernel.TILE + 3     # and a partial tile
    sym, *_, ln, total = _pack_case("hot_word_1_bit")
    assert ln[0] == 1 and total == len(sym)
    sym, *_, ln, _ = _pack_case("past_the_table")
    assert (sym >= len(ln)).mean() > 0.9


def test_join_is_the_concatenation():
    """join() gives the length and the last min(bits, 31) bits of the
    concatenated bit strings, so any grouping of a look-back folds to the
    same prefix."""
    rng = np.random.default_rng(2)
    for _ in range(300):
        strs = ["".join(rng.choice(["0", "1"], rng.integers(0, 45)))
                for _ in range(3)]
        segs = [(len(b), int(b[-31:] or "0", 2)) for b in strs]
        whole = "".join(strs)
        want = (len(whole), int(whole[-31:] or "0", 2))
        assert join(join(segs[0], segs[1]), segs[2]) == want
        assert join(segs[0], join(segs[1], segs[2])) == want


@pytest.mark.parametrize("pattern", ["nearest", "only_first", "random",
                                     "every_33rd", "every_129th"])
def test_look_back_equals_the_fold(pattern):
    rng = np.random.default_rng(4)
    segs = [(int(b), int(rng.integers(0, 1 << min(int(b), 31))))
            for b in rng.integers(0, 70, 3 * PACK["kLookback"] + 5)]
    inc, fold = [], (0, 0)
    for s in segs:
        fold = join(fold, s)
        inc.append(fold)
    for t in range(1, len(segs)):
        state = np.full(t, AGG)
        if pattern == "nearest":
            state[:] = INC
        elif pattern == "random":
            state[rng.random(t) < 0.2] = INC
        elif pattern == "every_33rd":
            state[::33] = INC
        elif pattern == "every_129th":
            state[::129] = INC
        state[0] = INC
        assert look_back(t, segs, inc, state) == inc[t - 1]


# --- K3 ------------------------------------------------------------------

def model_hist(sym, radius, offset: int):
    """The counts histogram_window_kernel adds up, for symbols that start
    `offset` int32s past a 16-byte boundary: each symbol goes down
    exactly one of the register, window, spill or skip paths."""
    sym = np.asarray(sym, np.int64)
    n, nbins, width = len(sym), HIST["kBins"], HIST["kWindow"]
    center, lo = hist_kernel.window(radius)
    head = min((4 - offset % 4) % 4, n)
    nv = (n - head) // 4
    tail = n - head - 4 * nv
    assert head <= 3 and tail <= 3          # one warp's lanes 0-3 and 4-6
    parts = np.concatenate([sym[:head], sym[head:head + 4 * nv],
                            sym[head + 4 * nv:]])
    assert np.array_equal(parts, sym)
    reg_center = int((sym == center).sum())
    reg_zero = int((sym == 0).sum())
    d = sym - lo
    in_window = (d >= 0) & (d < width) & (sym != center)
    spill = (sym > 0) & (sym < nbins) & ~((d >= 0) & (d < width))
    skip = (sym < 0) | (sym >= nbins)
    paths = ((sym == center).astype(int) + (sym == 0) + in_window + spill
             + skip)
    assert (paths == 1).all()
    hist = np.zeros(nbins, np.int64)
    hist[lo:lo + width] += np.bincount(d[in_window], minlength=width)
    hist[center] += reg_center
    hist[0] += reg_zero
    hist += np.bincount(sym[spill], minlength=nbins)
    return hist


@pytest.mark.parametrize("offset", [0, 1, 2, 3])
@pytest.mark.parametrize("name", HIST_CASES)
def test_hist_model_matches_bincount(name, offset):
    _, sym, radius = next(c for c in SMOKE.hist_cases() if c[0] == name)
    t = torch.from_numpy(sym)
    valid = t[(t >= 0) & (t < hist_kernel.NBINS)]
    want = torch.bincount(valid, minlength=hist_kernel.NBINS)
    assert np.array_equal(model_hist(sym, radius, offset), want.numpy())
    assert torch.equal(hist_kernel.histogram(t, radius), want.to(torch.int32))


def test_hist_cases_reach_what_they_name():
    cases = {c[0]: c for c in SMOKE.hist_cases()}
    _, sym, radius = cases["cluster_wrong_hint"]
    center, lo = hist_kernel.window(radius)
    inside = (sym >= lo) & (sym < lo + hist_kernel.WINDOW)
    assert not inside.any()          # every symbol takes the spill path
    _, sym, _ = cases["heavy_zero"]
    assert (sym == 0).mean() > 0.5
    assert all(len(cases[k][1]) % 4 for k in ("clustered", "one", "seven"))


@pytest.mark.parametrize("radius", [0, 1, 5, 2047, 32767, 32768, 65534,
                                    65535, 65536, 1 << 20, -3])
def test_hist_counts_ignore_the_hint(radius):
    """On the CPU the wrapper gives the plain counts, with any hint or
    none, and the model of the kernel's split gives them too."""
    rng = np.random.default_rng(8)
    sym = np.clip(rng.normal(32768, 3000, 20001), -10, 70000).astype(
        np.int32)
    t = torch.from_numpy(sym)
    want = hist_kernel.histogram_plain(t)
    assert torch.equal(hist_kernel.histogram(t, radius), want)
    assert torch.equal(hist_kernel.histogram(t), want)
    assert np.array_equal(model_hist(sym, radius, 0), want.numpy())


def test_window_placement():
    """The register bin lies in the window, and the window in [1, NBINS),
    for every hint (the bounds sz_histogram checks)."""
    for radius in list(range(-2, 5000, 7)) + list(range(60000, 70000, 3)) \
            + [1 << 40]:
        center, lo = hist_kernel.window(radius)
        assert 1 <= lo <= center < lo + hist_kernel.WINDOW
        assert lo + hist_kernel.WINDOW <= hist_kernel.NBINS
    assert hist_kernel.window(300) == (300, 1)
    assert hist_kernel.window(32768) == (32768, 32768 - 2048)
