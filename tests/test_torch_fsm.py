"""The device Huffman decode (K5 fsm_sweep, K6 fsm_scan, K7 fsm_emit) on
the CPU: the plain versions against a serial tree walk, K6 against a
serial chain over its maps, a numpy model of K6's decomposition (tiles,
runs, look-back) against the same chain, and ``decode_coded`` against
the Pallas decode of sz_tpu (``fsm_kernel.decode_bits_device`` in
interpret mode) and against the symbols that were encoded.  Tolerance:
exact (equal symbols, offsets and counts).
"""

import itertools
import pathlib

import numpy as np
import pytest
import torch
torch.set_num_threads(1)  # xdist workers share the cores: one thread each

from sz_tpu.format import huffman as jhuff
from sz_tpu.tpu import fsm_kernel as jfsm

from sz_tpu_torch.format import huffman
from sz_tpu_torch.gpu import fsm_kernel as fk


def _zipf_stream(seed, n, nstate, a):
    """tests/test_pallas.py's skewed type streams."""
    rng = np.random.default_rng(seed)
    p = 1.0 / np.arange(1, nstate + 1) ** a
    return rng.choice(np.arange(nstate), size=n,
                      p=p / p.sum()).astype(np.int32)


def _coded(types, state_num):
    t = huffman.build_tables(types, state_num)
    return t, huffman.encode(t, types)


def _tree(t):
    return (t.L, t.R, t.C, t.T, t.node_count)


def _decode(t, enc, n):
    syms, scans = fk.decode(_tree(t), enc, n, "cpu")
    return syms.numpy(), scans


def _jax_decode(t, enc, n):
    pad = (-len(enc)) % 4
    words = np.frombuffer(enc + b"\0" * pad, ">u4").astype(np.uint32)
    trans = jfsm.build_trans(t.L, t.R, t.C, t.T)
    syms, ok = jfsm.decode_bits_device(words, trans, n, len(enc) * 8,
                                       interpret=True)
    assert bool(ok)
    return np.asarray(syms)[:n]


def _caterpillar(depth):
    """A complete prefix code of ``depth`` + 1 symbols: symbol k is k
    ones then a zero, the last symbol ``depth`` ones (L, R, C, T)."""
    nc = 2 * depth + 1
    L, R = np.zeros(nc, np.uint32), np.zeros(nc, np.uint32)
    C, T = np.zeros(nc, np.uint32), np.zeros(nc, np.uint8)
    for k in range(depth):            # internal node k at depth k
        node, zero_leaf = (0 if k == 0 else depth + k), k + 1
        L[node], C[zero_leaf], T[zero_leaf] = zero_leaf, k, 1
        R[node] = depth + k + 1 if k + 1 < depth else 2 * depth
    C[2 * depth], T[2 * depth] = depth, 1
    return L, R, C, T


def test_build_trans_matches_pallas_table():
    for types, ns in ((_zipf_stream(3, 5000, 600, 1.5), 600),
                      (np.arange(90, dtype=np.int32), 128)):
        t = jhuff.build_tables(types, ns)
        want = jfsm.build_trans(t.L, t.R, t.C, t.T).reshape(-1)
        got = fk.build_trans(t.L, t.R, t.C, t.T)
        assert got.dtype == np.int32
        np.testing.assert_array_equal(got.view(np.uint32),
                                      want[:2 * t.node_count])


def test_code_depth_is_the_longest_code():
    for types, ns in ((_zipf_stream(3, 5000, 600, 1.5), 600),
                      (np.repeat(np.arange(8, dtype=np.int32), 5), 8)):
        t = huffman.build_tables(types, ns)
        assert fk.code_depth(t.L, t.R, t.T) == int(t.code_len.max())
    L, R, C, T = _caterpillar(130)
    assert fk.code_depth(L, R, T) == 130
    assert fk.chunk_bits(130) == fk.F_BITS
    assert fk.chunk_bits(fk.F_BITS + 1) == 2 * fk.F_BITS
    R[5 + 130] = 130 + 2        # node 5 points back to node 2: a loop
    with pytest.raises(ValueError, match="corrupt"):
        fk.code_depth(L, R, T)


@pytest.mark.parametrize("seed,n,nstate,a", [(29, 40000, 600, 1.5),
                                             (31, 700_000, 300, 1.4)],
                         ids=["pallas_383", "pallas_432"])
def test_decode_bits_matches_pallas(seed, n, nstate, a):
    types = _zipf_stream(seed, n, nstate, a)
    t, enc = _coded(types, nstate)
    got, scans = _decode(t, enc, n)
    np.testing.assert_array_equal(got, types)
    assert fk.nchunks_of(8 * len(enc)) > 1 and scans == 1
    np.testing.assert_array_equal(got, _jax_decode(t, enc, n))


def _serial_walk(u8, L, R, C, T, start, stop_at, total):
    """Walk in Python (Huffman.c decode) from the root at bit ``start``
    to the first root position >= ``stop_at``, or to ``total``.
    Returns (end position, symbols)."""
    s, q, syms = 0, start, []
    while q < total and not (s == 0 and q >= stop_at):
        b = (u8[q >> 3] >> (7 - (q & 7))) & 1
        s = int(R[s] if b else L[s])
        q += 1
        if T[s]:
            syms.append(int(C[s]))
            s = 0
    return q, syms


def _random_bits_case(tree, nbytes, seed):
    rng = np.random.default_rng(seed)
    raw = rng.integers(0, 256, nbytes).astype(np.uint8).tobytes()
    return raw, fk.upload((*tree, len(tree[0])), raw, "cpu")


@pytest.mark.parametrize("tree_kind", ["zipf", "caterpillar_130"])
def test_plain_versions_match_a_serial_walk(tree_kind):
    """K5's map of every chunk and offset, the composed offsets of K6 and
    K7's symbols, on random bits (a complete prefix code decodes any bit
    string), against the serial walk.  The 130-bit code takes K5's path
    for codes past 63 bits (W0's boundary bitmap)."""
    if tree_kind == "zipf":
        t = huffman.build_tables(_zipf_stream(37, 3000, 200, 1.2), 200)
        tree = (t.L, t.R, t.C, t.T)
        depth = int(t.code_len.max())
    else:
        tree, depth = _caterpillar(130), 130
    nbytes = 5 * fk.F_BITS // 8 - 37              # last chunk ragged
    raw, coded = _random_bits_case(tree, nbytes, 37)
    assert coded.depth == depth
    u8, total = np.frombuffer(raw, np.uint8), 8 * nbytes
    F = fk.chunk_bits(depth)
    g, n = fk.fsm_sweep(coded)
    nchunks = coded.bits.numel() * 8 // F
    assert g.shape == n.shape == (nchunks, depth)
    for c in range(nchunks):
        for j in range(depth):
            if c * F + j >= total:
                assert (int(g[c, j]), int(n[c, j])) == (0, 0)
                continue
            q, syms = _serial_walk(u8, *tree, c * F + j, (c + 1) * F, total)
            assert (int(g[c, j]), int(n[c, j])) == \
                (max(q - (c + 1) * F, 0), len(syms))
    entry, offsets, count = fk.fsm_scan(g, n)
    _, ref = _serial_walk(u8, *tree, 0, total, total)
    assert count.shape == (1,) and int(count) == len(ref)
    q, k = 0, 0
    for c in range(nchunks):      # the true boundaries, chunk by chunk
        assert (int(entry[c]), int(offsets[c])) == (q - c * F, k)
        q2, syms = _serial_walk(u8, *tree, q, (c + 1) * F, total)
        q, k = q2, k + len(syms)
    out = fk.fsm_emit(coded, entry, offsets, len(ref) - 3)
    np.testing.assert_array_equal(out.numpy(), ref[:-3])


def _maps(kind, L, D, seed):
    """K5-shaped maps (g int32 (L, D) in [0, D), n int64 (L, D)) from a
    seed: random, a permutation a chunk (composites never converge), a
    constant a chunk, or counts of 2^31 and more."""
    rng = np.random.default_rng(seed)
    if kind == "permutation":
        g = np.stack([rng.permutation(D) for _ in range(L)])
    elif kind == "constant":
        g = np.repeat(rng.integers(0, D, (L, 1)), D, axis=1)
    else:
        g = rng.integers(0, D, (L, D))
    lo, hi = (1 << 31, 1 << 33) if kind == "big_counts" else (0, 1000)
    n = rng.integers(lo, hi, (L, D))
    return (torch.from_numpy(g.astype(np.int32)),
            torch.from_numpy(n.astype(np.int64)))


def _chain(g, n):
    """The serial chain: chunk 0 entered at 0, entry[c + 1] =
    g[c][entry[c]], offsets[c + 1] = offsets[c] + n[c][entry[c]];
    returns (entry, offsets, total) as numpy int64 and a Python int."""
    g, n = g.numpy(), n.numpy()
    entry = np.zeros(len(g), np.int64)
    offsets = np.zeros(len(g), np.int64)
    e = k = 0
    for c in range(len(g)):
        entry[c], offsets[c] = e, k
        e, k = int(g[c, e]), k + int(n[c, e])
    return entry, offsets, k


MAP_KINDS = ["random", "permutation", "constant", "big_counts"]


@pytest.mark.parametrize("kind", MAP_KINDS)
@pytest.mark.parametrize("D", [1, 5, 28, 63, 64, 200])
@pytest.mark.parametrize("L", [1, 2, 37, 1237])
def test_scan_matches_a_serial_chain(L, D, kind):
    """K6 (on the CPU its plain version, the doubling composition)
    against the serial chain.  1237 chunks are no multiple of any tile
    size."""
    g, n = _maps(kind, L, D, 59 + L + D)
    entry, offsets, total = fk.fsm_scan(g, n)
    want_e, want_o, want_t = _chain(g, n)
    assert entry.dtype == torch.int32 and offsets.dtype == torch.int64
    assert total.dtype == torch.int64 and total.shape == (1,)
    np.testing.assert_array_equal(entry.numpy(), want_e)
    np.testing.assert_array_equal(offsets.numpy(), want_o)
    assert int(total) == want_t
    if kind == "big_counts":
        assert want_t >= 1 << 31


# --- a model of K6's decomposition (csrc/fsm.cu fsm_scan_kernel, and
# fsm_scan_wide_kernel past the windowed depth) ---------------------------

def _walk(g, n, chunks, j):
    """The walk entered at offset j through ``chunks``, reading g as the
    kernel does (an entry past D - 1 as D - 1): (entry after, count)."""
    D = g.shape[1]
    e, k = j, 0
    for c in chunks:
        e, k = min(int(g[c, e]), D - 1), k + int(n[c, e])
    return e, k


def _composite(g, n, chunks):
    """The D-wide composite of a run of chunks: (entries, counts)."""
    w = [_walk(g, n, chunks, j) for j in range(g.shape[1])]
    return (np.array([e for e, _ in w], np.int64),
            np.array([k for _, k in w], np.int64))


def _then(first, second):
    """The composite of ``first`` followed by ``second``."""
    return second[0][first[0]], first[1] + second[1][first[0]]


def _look_back(t, states, agg, incl, window, wide):
    """Tile t's (entry, count) as its look-back warp finds them: lanes
    read ``window`` predecessors at a time (a tile before 0 reads as
    inclusive (0, 0)); states[s] is what tile s's descriptor shows
    ("A" or "I"); incl[s] its inclusive prefix; agg[s] its aggregate.
    Narrow: fold the aggregates, nearest first, into Y until the nearest
    inclusive prefix.  Wide: find that prefix, then walk its entry
    forward through the aggregates in between."""
    D = len(agg[0][0])
    y = (np.arange(D), np.zeros(D, np.int64))
    j = t - 1
    while True:
        tiles = [j - lane for lane in range(window)]
        stop = next((lane for lane, s in enumerate(tiles)
                     if s < 0 or states[s] == "I"), None)
        if not wide:
            for s in tiles[:window if stop is None else stop]:
                y = _then(agg[s], y)
        if stop is not None:
            s = tiles[stop]
            e, k = incl[s] if s >= 0 else (0, 0)
            if wide:
                for a in range(s + 1, t):
                    e, k = int(agg[a][0][e]), k + int(agg[a][1][e])
                return e, k
            return int(y[0][e]), k + int(y[1][e])
        j -= window


def scan_model(g, n, tile, warps, window):
    """K6's decomposition: tiles of ``tile`` chunks, each composed in
    ``warps`` runs (narrow; one run on the wide path) whose composites
    make its aggregate; every tile's look-back is run against every
    order in which its predecessors' descriptors can show AGGREGATE or
    INCLUSIVE (tile 0 is always inclusive) and must give its true
    prefix; then each run walks from its entry.  Returns (entry,
    offsets, total) and the look-backs run."""
    L, D = g.shape
    wide = D > fk.WINDOW_DEPTH
    ntiles = -(-L // tile)
    runs, agg, incl = [], [], []
    e = k = 0
    for t in range(ntiles):
        rows = list(range(t * tile, min((t + 1) * tile, L)))
        R = tile if wide else tile // warps
        parts = [_composite(g, n, rows[r:r + R])
                 for r in range(0, tile, R)]
        a = parts[0]
        for x in parts[1:]:
            a = _then(a, x)
        runs.append(parts)
        agg.append(a)
        e, k = int(a[0][e]), k + int(a[1][e])
        incl.append((e, k))
    entry = np.zeros(L, np.int64)
    offsets = np.zeros(L, np.int64)
    looks = 0
    for t in range(ntiles):
        if t == 0:
            start = (0, 0)
        else:
            for pattern in itertools.product("AI", repeat=t - 1):
                states = ("I",) + pattern
                got = _look_back(t, states, agg, incl, window, wide)
                assert got == incl[t - 1], (t, states)
                looks += 1
            start = incl[t - 1]
        e, k = start
        R = tile if wide else tile // warps
        for r, (xg, xn) in enumerate(runs[t]):
            for c in range(t * tile + r * R, min(t * tile + (r + 1) * R, L)):
                entry[c], offsets[c] = e, k
                e, k = min(int(g[c, e]), D - 1), k + int(n[c, e])
            assert (e, k) == (int(xg[start[0]]), start[1] + int(xn[start[0]]))
            start = (e, k)
    return entry, offsets, k, looks


@pytest.mark.parametrize("kind", ["random", "permutation", "big_counts"])
@pytest.mark.parametrize("D", [1, 5, 28, 63, 64, 200])
def test_scan_model_matches_a_serial_chain(D, kind):
    """The model, at small tiles (8 chunks, 2 runs of 4; 37 chunks make
    a ragged last tile), with the kernel's window of 32 predecessors and
    with one of 2 (the look-back steps back window by window), against
    the serial chain."""
    g, n = _maps(kind, 37, D, 71 + D)
    want = _chain(g, n)
    for window in (fk.SCAN_WINDOW, 2):
        entry, offsets, total, looks = scan_model(g, n, 8, 2, window)
        np.testing.assert_array_equal(entry, want[0])
        np.testing.assert_array_equal(offsets, want[1])
        assert total == want[2] and looks == 2 ** 4 - 1


def test_scan_tile_fits_the_kernel():
    """scan_tile's tiles are multiples of 32 whose staged rows fit two
    blocks an SM; the constants are fsm.cu's."""
    src = (pathlib.Path(fk.__file__).resolve().parent.parent / "csrc"
           / "fsm.cu").read_text()
    assert f"constexpr int kScanWarps = {fk.SCAN_WARPS};" in src
    assert "constexpr int kSmemPerSm = 233472;" in src
    assert f"constexpr int kWindow = {fk.SCAN_WINDOW};" in src
    assert "(D + 3) & ~3" in src and "kWindow * padded(D)" in src
    for D in range(1, fk.WINDOW_DEPTH + 1):
        T = fk.scan_tile(D)
        assert T % 32 == 0 and 32 <= T <= 512
        assert fk.scan_smem(T, D) <= fk.SCAN_SMEM
        assert T == 512 or fk.scan_smem(2 * T, D) > fk.SCAN_SMEM
    assert fk.scan_smem(256, 28) == 12 * (256 * 28 + 8 * 28 + 256 + 32 * 28)
    assert fk.scan_tile(28) == 256 and fk.scan_tile(63) == 64
    assert fk.scan_tile(fk.WINDOW_DEPTH + 1) == 32


def test_tree_past_8192_nodes():
    types = _zipf_stream(41, 60000, 6000, 0.9)
    t, enc = _coded(types, 6000)
    assert t.node_count > 8192
    got, _ = _decode(t, enc, len(types))
    np.testing.assert_array_equal(got, types)


def test_stream_under_2_16_bits():
    types = _zipf_stream(43, 900, 50, 1.5)
    t, enc = _coded(types, 50)
    assert len(enc) * 8 < (1 << 16)
    got, scans = _decode(t, enc, len(types))
    np.testing.assert_array_equal(got, types)
    np.testing.assert_array_equal(got, _jax_decode_small(t, enc, types))


def _jax_decode_small(t, enc, types):
    """sz_tpu decodes streams under 2^16 bits on the host."""
    return jhuff.decode(t.L, t.R, t.C, t.T, enc, len(types))


def test_one_leaf_tree_fills_the_output():
    types = np.full(777, 5, np.int32)
    t, enc = _coded(types, 8)
    assert t.node_count == 1 and enc == b""
    got, scans = _decode(t, enc, len(types))
    np.testing.assert_array_equal(got, types)
    assert scans == 0


def test_chunks_that_never_sync():
    """A fixed-length 3-bit code never self-synchronizes, and F_BITS is
    no multiple of 3: the walks of a chunk from its three offsets never
    meet (far past the TPU's 2048-bit window), and the decode is still
    exact in one K6 scan, as for any stream."""
    rng = np.random.default_rng(47)
    types = rng.integers(0, 8, 6000).astype(np.int32)
    t, enc = _coded(types, 8)
    assert set(t.code_len[:8].tolist()) == {3} and fk.F_BITS % 3
    got, scans = _decode(t, enc, len(types))
    np.testing.assert_array_equal(got, types)
    g, _ = fk.fsm_sweep(fk.upload(_tree(t), enc, "cpu"))
    assert all(len(set(row.tolist())) == 3 for row in g[:-1])
    assert g.shape[0] == 18 and scans == 1


@pytest.mark.parametrize("how", ["truncated", "extra_bytes", "bad_tree"])
def test_corrupt_stream_raises(how):
    types = _zipf_stream(53, 20000, 300, 1.3)
    t, enc = _coded(types, 300)
    tree = _tree(t)
    if how == "truncated":
        enc = enc[:len(enc) // 2]
    elif how == "extra_bytes":
        enc = enc + enc[:64]
    else:
        L = t.L.copy()
        L[np.flatnonzero(t.T == 0)[3]] = t.node_count + 5
        tree = (L, t.R, t.C, t.T, t.node_count)
    with pytest.raises(ValueError, match="corrupt"):
        fk.decode(tree, enc, len(types), "cpu")
