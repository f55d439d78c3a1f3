"""The device Huffman decode (K5 fsm_sweep, K6 fsm_sync, K7 fsm_emit) on
the CPU: the plain versions against a serial tree walk, and
``decode_coded`` against the Pallas decode of sz_tpu
(``fsm_kernel.decode_bits_device`` in interpret mode) and against the
symbols that were encoded.  Tolerance: exact (equal symbols, offsets and
counts).
"""

import numpy as np
import pytest
import torch

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
    syms, steps = fk.decode(_tree(t), enc, n, "cpu")
    return syms.numpy(), steps


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
    got, steps = _decode(t, enc, n)
    np.testing.assert_array_equal(got, types)
    chunks = fk.nchunks_of(8 * len(enc))
    assert steps == int(np.ceil(np.log2(chunks))) >= 1
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
    entry, offsets, count, steps = fk.compose(g, n)
    _, ref = _serial_walk(u8, *tree, 0, total, total)
    assert count == len(ref) and steps == 3
    q, k = 0, 0
    for c in range(nchunks):      # the true boundaries, chunk by chunk
        assert (int(entry[c]), int(offsets[c])) == (q - c * F, k)
        q2, syms = _serial_walk(u8, *tree, q, (c + 1) * F, total)
        q, k = q2, k + len(syms)
    out = fk.fsm_emit(coded, entry, offsets, len(ref) - 3)
    np.testing.assert_array_equal(out.numpy(), ref[:-3])


def test_sync_step_composes_maps():
    """One K6 step against the composition written out, and the full
    doubling against a serial scan p[c + 1] = g[c][p[c]]."""
    rng = np.random.default_rng(59)
    nch, D = 37, 5
    g = torch.from_numpy(rng.integers(0, D, (nch, D)).astype(np.int32))
    n = torch.from_numpy(rng.integers(0, 1000, (nch, D)).astype(np.int64))
    g2, n2 = fk.fsm_sync(g, n, 4)
    for c in range(nch):
        for j in range(D):
            if c < 4:
                want = (int(g[c, j]), int(n[c, j]))
            else:
                p = int(g[c - 4, j])
                want = (int(g[c, p]), int(n[c - 4, j]) + int(n[c, p]))
            assert (int(g2[c, j]), int(n2[c, j])) == want
    entry, offsets, total, steps = fk.compose(g, n)
    p, k = 0, 0
    for c in range(nch):
        assert (int(entry[c]), int(offsets[c])) == (p, k)
        p, k = int(g[c, p]), k + int(n[c, p])
    assert total == k and steps == 6


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
    got, steps = _decode(t, enc, len(types))
    np.testing.assert_array_equal(got, types)
    np.testing.assert_array_equal(got, _jax_decode_small(t, enc, types))


def _jax_decode_small(t, enc, types):
    """sz_tpu decodes streams under 2^16 bits on the host."""
    return jhuff.decode(t.L, t.R, t.C, t.T, enc, len(types))


def test_one_leaf_tree_fills_the_output():
    types = np.full(777, 5, np.int32)
    t, enc = _coded(types, 8)
    assert t.node_count == 1 and enc == b""
    got, steps = _decode(t, enc, len(types))
    np.testing.assert_array_equal(got, types)
    assert steps == 0


def test_chunks_that_never_sync():
    """A fixed-length 3-bit code never self-synchronizes, and F_BITS is
    no multiple of 3: the walks of a chunk from its three offsets never
    meet (far past the TPU's 2048-bit window), and the decode is still
    exact in ceil(log2 L) K6 steps, as for any stream."""
    rng = np.random.default_rng(47)
    types = rng.integers(0, 8, 6000).astype(np.int32)
    t, enc = _coded(types, 8)
    assert set(t.code_len[:8].tolist()) == {3} and fk.F_BITS % 3
    got, steps = _decode(t, enc, len(types))
    np.testing.assert_array_equal(got, types)
    g, _ = fk.fsm_sweep(fk.upload(_tree(t), enc, "cpu"))
    assert all(len(set(row.tolist())) == 3 for row in g[:-1])
    assert steps == int(np.ceil(np.log2(g.shape[0]))) == 5


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
