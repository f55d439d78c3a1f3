"""Parity of the port's four kernels (sz_tpu_torch.gpu) with the Pallas
kernels they replace.

On the CPU each wrapper runs its plain torch version; these tests hold
that version bit-equal to the Pallas kernel run in interpret mode, on the
same inputs made from numpy seeds.  The CUDA kernels themselves are held
against the plain versions on the card by tests/test_torch_gpu.py and
chip_smoke.py.  Tolerance everywhere: exact (equal bits,
equal bytes) -- the codec's contract is bit-exactness.
"""

import pathlib
import re
from types import SimpleNamespace

import numpy as np
import pytest
import torch
torch.set_num_threads(1)  # xdist workers share the cores: one thread each

import jax.numpy as jnp

from sz_tpu.format import huffman
from sz_tpu.tpu import hist_kernel as jhk
from sz_tpu.tpu import pack_kernel as jpk
from sz_tpu.tpu import pallas_kernels as jpl
from sz_tpu.tpu import wf_quantize as jwf
from sz_tpu.tpu.engine import _strict_jit

from sz_tpu_torch.gpu import hist_kernel, lorenzo_kernel, pack_kernel, tiles

RADIUS = 32
RP, RECIP = np.float32(1e-3), np.float32(np.float32(1) / np.float32(1e-3))
CAP_SZF = np.float32(2 * RADIUS - 2)
MEAN = np.float32(0.25)


def _k1_inputs(shape, seed):
    """A field plus regression points / mean flushes on random blocks of
    it: the per-point inputs K1 merges."""
    rng = np.random.default_rng(seed)
    n = int(np.prod(shape))
    data = (np.sin(np.linspace(0, 12, n, dtype=np.float32))
            + 0.02 * rng.standard_normal(n)).astype(np.float32).reshape(shape)
    data[rng.random(shape) < 0.1] = MEAN
    reg = rng.random(shape) < 0.3
    t_reg = rng.integers(0, 2 * RADIUS, shape).astype(np.int32)
    rec_reg = (data + rng.uniform(-1e-3, 1e-3, shape)).astype(np.float32)
    mean_mask = (~reg) & (np.abs(data - MEAN) <= RP)
    return data, t_reg, rec_reg, reg, mean_mask


def _k1_plain(inputs, use_mean):
    data, t_reg, rec_reg, reg, mm = (torch.from_numpy(a) for a in inputs)
    return lorenzo_kernel.wavefront_quantize(
        data, t_reg, rec_reg, reg, mm if use_mean else None, RP, RECIP,
        CAP_SZF, RADIUS, MEAN, use_mean=use_mean, want_R=True)


def _strict(fn, *args, **kw):
    """Run a Pallas entry point (interpret mode) the way the JAX engine
    runs its CPU stages: jitted with XLA:CPU's fusion pass off, so no
    mul+add is contracted into an FMA (engine._strict_jit)."""
    return _strict_jit(lambda *a: fn(*a, interpret=True, **kw), "cpu")(*args)


def _jax_scalars():
    return (jnp.float32(RP), jnp.float32(RECIP), jnp.float32(CAP_SZF),
            jnp.int32(RADIUS), jnp.float32(MEAN))


def _tile_pad(arrays, shape, H=0):
    """Pad planes as engine._quantize_fn does before the Pallas plane and
    strip kernels: rows to 8 (or to the strip height H), columns to
    128; the data by edge replication, the rest with zeros."""
    ny, nz = shape[-2:]
    nyp8 = -(-ny // 8) * 8
    py = (-(-nyp8 // H) * H if H else nyp8) - ny
    pz = -(-nz // 128) * 128 - nz
    w = ((0, 0), (0, py), (0, pz))
    return [jnp.pad(jnp.asarray(a), w, mode="edge" if i == 0 else "constant")
            for i, a in enumerate(arrays)]


def _assert_k1_equal(got, t, R, shape):
    t_p, R_p = got
    np.testing.assert_array_equal(t_p.numpy(), np.asarray(t)[..., :shape[-2],
                                                              :shape[-1]])
    np.testing.assert_array_equal(
        R_p.numpy().view(np.uint32),
        np.asarray(R)[..., :shape[-2], :shape[-1]].view(np.uint32))


@pytest.mark.parametrize("use_mean", [False, True])
@pytest.mark.parametrize("shape", [(5, 12, 20), (40, 30)])
def test_k1_plain_matches_plane_quantize(shape, use_mean):
    inputs = _k1_inputs(shape, 1)
    got = _k1_plain(inputs, use_mean)
    data, t_reg, rec_reg, reg, mm = inputs
    planes = [data, t_reg, rec_reg, reg, mm if use_mean else reg]
    planes = [a[None] if len(shape) == 2 else a for a in planes]
    args = _tile_pad(planes, shape)
    t, R, _ = _strict(jpl.plane_quantize, *args, *_jax_scalars(),
                      use_mean=use_mean)
    if len(shape) == 2:
        t, R = t[0], R[0]
    _assert_k1_equal(got, t, R, shape)


@pytest.mark.parametrize("use_mean", [False, True])
def test_k1_plain_matches_strip_quantize(use_mean):
    shape, H = (3, 40, 130), 16
    inputs = _k1_inputs(shape, 2)
    got = _k1_plain(inputs, use_mean)
    data, t_reg, rec_reg, reg, mm = inputs
    args = _tile_pad([data, t_reg, rec_reg, reg, mm if use_mean else reg],
                     shape, H)
    t, R, _ = _strict(jpl.strip_quantize, *args, *_jax_scalars(), H=H,
                      use_mean=use_mean)
    _assert_k1_equal(got, t, R, shape)


@pytest.mark.parametrize("use_mean", [False, True])
def test_k1_plain_matches_wavefront_quantize(use_mean):
    shape = (6, 9, 11)
    inputs = _k1_inputs(shape, 3)
    got = _k1_plain(inputs, use_mean)
    data, t_reg, rec_reg, reg, mm = (jnp.asarray(a) for a in inputs)
    t, R, _ = _strict(jwf.wavefront_quantize, data, t_reg, rec_reg, reg,
                      mm if use_mean else reg, *_jax_scalars(),
                      use_mean=use_mean, want_R=True)
    _assert_k1_equal(got, t, R, shape)


def _k2_inputs(shape, seed):
    rng = np.random.default_rng(seed)
    known_mask = rng.random(shape) < 0.3
    known = rng.standard_normal(shape).astype(np.float32)
    t = rng.integers(0, 2 * RADIUS, shape)
    q_lor = ((2 * (t - RADIUS)).astype(np.float32) * RP).astype(np.float32)
    return known_mask, known, q_lor


def test_k2_plain_matches_wavefront_decode():
    shape = (7, 10, 13)
    km, kv, q = _k2_inputs(shape, 4)
    got = lorenzo_kernel.wavefront_decode(*(torch.from_numpy(a)
                                            for a in (km, kv, q)))
    ref = _strict(jwf.wavefront_decode, jnp.asarray(km), jnp.asarray(kv),
                  jnp.asarray(q))
    np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                  np.asarray(ref).view(np.uint32))


def test_k3_plain_matches_pallas_histogram():
    rng = np.random.default_rng(5)
    sym = np.clip(rng.normal(32768, 40, 30000), 0, 65535).astype(np.int32)
    sym[rng.integers(0, 30000, 500)] = rng.integers(0, 65536, 500)
    sym[::7] = -1
    got = hist_kernel.histogram(torch.from_numpy(sym))
    ref = jhk.histogram(jnp.asarray(sym), interpret=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert int(got.sum()) == int((sym >= 0).sum())


def _i64(a):
    return torch.from_numpy(np.ascontiguousarray(a, np.uint64).view(np.int64))


def _pack(sym, code_hi, code_lo, code_len):
    lens = np.where(sym >= 0, code_len[np.maximum(sym, 0)], 0)
    total_bits = int(lens.astype(np.int64).sum())
    out = pack_kernel.pack_bits(
        torch.from_numpy(sym.astype(np.int32)), _i64(code_hi), _i64(code_lo),
        torch.from_numpy(code_len.astype(np.int32)), total_bits)
    return out.numpy().tobytes(), total_bits


def test_k4_plain_matches_pack2_bits():
    """Window-fitting tables (codes <= 26 bits, symbol 0 special), with
    -1 holes -- the inputs of test_pallas.test_pack2_kernel_matches_*."""
    rng = np.random.default_rng(21)
    nstate, n = 65536, 20000
    code_len = np.zeros(nstate, np.int32)
    used = np.arange(100, 901)
    code_len[used] = rng.integers(1, 27, len(used))
    code_len[0] = 30
    vals = ((rng.integers(0, 1 << 16, nstate).astype(np.uint64) << 16)
            | rng.integers(0, 1 << 16, nstate).astype(np.uint64))
    vals &= (np.uint64(1) << np.maximum(code_len, 1).astype(np.uint64)) \
        - np.uint64(1)
    code_hi = np.where(code_len > 0, vals << (np.uint64(64) - np.maximum(
        code_len, 1).astype(np.uint64)), np.uint64(0)).astype(np.uint64)
    t = rng.choice(used, size=n).astype(np.int32)
    t[rng.random(n) < 0.1] = 0
    t[rng.random(n) < 0.05] = -1
    got, total_bits = _pack(t, code_hi, np.zeros(nstate, np.uint64), code_len)
    freq = np.bincount(t[t >= 0], minlength=nstate)
    lo, K = jpk.window_from_freq(freq, code_len)
    tbl = jpk.build_window_table(
        SimpleNamespace(code_hi=code_hi, code_len=code_len), lo, K)
    out_bytes = ((total_bits + 31) // 32) * 4
    ref = np.asarray(jpk.pack2_bits(
        jnp.asarray(t), jnp.asarray(tbl), lo, int(code_len[0]),
        int(code_hi[0] >> np.uint64(32)), n, out_bytes,
        interpret=True)).view(np.uint8)
    assert got == ref[:(total_bits + 7) // 8].tobytes()


def test_k4_plain_matches_huffman_encode_long_codes():
    """A Fibonacci-frequency Huffman table has codes past 32 and past 64
    bits (the full 128-bit HuffmanTables width): byte-equal to
    huffman.encode."""
    nsym = 90
    fib = [1, 1]
    while len(fib) < nsym:
        fib.append(fib[-1] + fib[-2])
    freq = np.zeros(256, np.int64)
    freq[:nsym] = fib
    tables = huffman.build_tables(None, 128, freq=freq)
    assert tables.code_len.max() > 64
    assert ((tables.code_len > 32) & (tables.code_len <= 64)).any()
    rng = np.random.default_rng(6)
    syms = rng.integers(0, nsym, 5000).astype(np.int32)
    got, _ = _pack(syms, tables.code_hi, tables.code_lo,
                   tables.code_len.astype(np.int32))
    assert got == huffman.encode(tables, syms)


# --- the tiled K1/K2's geometry and order -----------------------------------

def test_tiles_match_the_cuda_source():
    """TILE3 / TILE2, from which the wrapper makes K1/K2's claim order, are
    the tile shapes lorenzo.cu compiles (LorenzoTile<3> / <2>), which it
    hands to tiles.cuh's TileShape with a one-deep k-halo; the float64
    K1d/K2d have no tile (they run on strips.cuh)."""
    csrc = pathlib.Path(lorenzo_kernel.__file__).resolve().parent.parent / \
        "csrc"
    src = (csrc / "lorenzo.cu").read_text()
    dims = re.findall(
        r"static constexpr int (b[ijk]) = kRank == 3 \? (\d+) : (\d+);", src)
    assert [d[0] for d in dims] == ["bi", "bj", "bk"]
    assert tuple(int(d[1]) for d in dims) == lorenzo_kernel.TILE3
    assert tuple(int(d[2]) for d in dims) == lorenzo_kernel.TILE2
    assert ("using LorenzoGeo = Geo<TileShape<LorenzoTile<kRank>, 1>>;"
            in src)
    for rank in (3, 2):
        assert f"LorenzoGeo<{rank}>" in src
    assert "kWide" not in src and "LorenzoGeo<3, double>" not in src
    assert "struct TileShape {" in (csrc / "tiles.cuh").read_text()


def _shape3(shape):
    return (1,) * (3 - len(shape)) + tuple(shape)


@pytest.mark.parametrize("shape", [
    (3, 5, 7), (9, 17, 70), (33, 9, 65), (1, 1, 4097), (4097, 1, 1),
    (1, 4097, 1), (40, 70), (70, 130), (1800, 3600), (100, 500, 500),
    (256, 256, 256)])
def test_tile_order_covers_and_respects_dependencies(shape):
    """Every point lies in exactly one tile; every tile's three
    predecessors are claimed before it; the prefix counts delimit the
    tile-diagonals."""
    shape3 = _shape3(shape)
    tile = lorenzo_kernel.tile_of(shape3)
    assert tile[0] * tile[1] % 32 == 0
    grid, order, starts = tiles.tile_order(shape3, tile)
    ntiles = int(np.prod(grid))
    np.testing.assert_array_equal(np.sort(order), np.arange(ntiles))
    # the ragged tiles' extents add up to the lattice, and every point's
    # tile is in the grid
    ext = [np.minimum(b, r - b * np.arange(n))
           for r, b, n in zip(shape3, tile, grid)]
    assert all((e > 0).all() for e in ext)
    assert int(np.prod([e.sum() for e in ext])) == int(np.prod(shape3))
    assert all((r - 1) // b == n - 1 for r, b, n in zip(shape3, tile, grid))
    rank = np.empty(ntiles, np.int64)
    rank[order] = np.arange(ntiles)
    rank = rank.reshape(grid)
    assert (rank[1:] > rank[:-1]).all()
    assert (rank[:, 1:] > rank[:, :-1]).all()
    assert (rank[:, :, 1:] > rank[:, :, :-1]).all()
    S = np.indices(grid).sum(axis=0).reshape(-1)[order]
    assert starts[0] == 0 and starts[-1] == ntiles
    assert starts.size == sum(grid) - 1
    for d in range(starts.size - 1):
        assert (S[starts[d]:starts[d + 1]] == d).all()


def _nb(R, i, j, k):
    return R[i, j, k] if min(i, j, k) >= 0 else np.float32(0)


def _pred7_np(R, i, j, k):
    """pred7 in lorenzo.cu's op order, numpy float32 scalars."""
    p = _nb(R, i, j, k - 1) + _nb(R, i, j - 1, k)
    p = p + _nb(R, i - 1, j, k)
    p = p - _nb(R, i, j - 1, k - 1)
    p = p - _nb(R, i - 1, j, k - 1)
    p = p - _nb(R, i - 1, j - 1, k)
    return p + _nb(R, i - 1, j - 1, k - 1)


def _quant_np(cur, pred):
    """lorenzo.cu's quant: (t, rec)."""
    diff = cur - pred
    itv = np.abs(diff) * RECIP + np.float32(1)
    if not itv < CAP_SZF:
        return 0, cur
    if diff < 0:
        itv = -itv
    tu = int(np.trunc(itv / np.float32(2))) + RADIUS
    rec = pred + np.float32(2 * (tu - RADIUS)) * RP
    return (tu, rec) if np.abs(cur - rec) <= RP else (0, cur)


def _walk_tiles(shape3, point):
    """Visit the lattice as the kernel does: tiles in tile_order, and in
    a tile the step s = li + lj + lk, lanes (li, lj) in order; every
    in-lattice neighbour must be done before its point."""
    tile = lorenzo_kernel.tile_of(shape3)
    grid, order, _ = tiles.tile_order(shape3, tile)
    done = np.zeros(shape3, bool)
    offs = [(a, b, c) for a in (0, 1) for b in (0, 1) for c in (0, 1)][1:]
    for flat in order:
        org = [int(n) * b for n, b in zip(np.unravel_index(flat, grid),
                                          tile)]
        ext = [min(b, r - o) for b, r, o in zip(tile, shape3, org)]
        for s in range(sum(ext) - 2):
            for li in range(ext[0]):
                for lj in range(ext[1]):
                    lk = s - li - lj
                    if not 0 <= lk < ext[2]:
                        continue
                    i, j, k = org[0] + li, org[1] + lj, org[2] + lk
                    assert all(done[i - a, j - b, k - c] for a, b, c in offs
                               if min(i - a, j - b, k - c) >= 0)
                    point(i, j, k)
                    done[i, j, k] = True
    assert done.all()


WALK_SHAPES = [(3, 5, 7), (9, 17, 70), (5, 20), (70, 130)]


@pytest.mark.parametrize("use_mean", [False, True])
@pytest.mark.parametrize("shape", WALK_SHAPES)
def test_k1_tile_walk_matches_quantize_plain(shape, use_mean):
    """The tiled K1's order and per-point arithmetic, walked in numpy,
    equal quantize_plain bit for bit (which the tests above hold to the
    Pallas kernels)."""
    data, t_reg, rec_reg, reg, mm = _k1_inputs(shape, 8)
    shape3 = _shape3(shape)
    data, t_reg, rec_reg, reg, mm = (a.reshape(shape3) for a in
                                     (data, t_reg, rec_reg, reg, mm))
    t = np.zeros(shape3, np.int32)
    R = np.zeros(shape3, np.float32)

    def point(i, j, k):
        if reg[i, j, k]:
            t[i, j, k], R[i, j, k] = t_reg[i, j, k], rec_reg[i, j, k]
            return
        q, rec = _quant_np(data[i, j, k], _pred7_np(R, i, j, k))
        if use_mean:
            if q != 0 and q <= RADIUS:
                q -= 1
            if mm[i, j, k]:
                q, rec = RADIUS, MEAN
        t[i, j, k], R[i, j, k] = q, rec

    _walk_tiles(shape3, point)
    t_p, R_p = _k1_plain(_k1_inputs(shape, 8), use_mean)
    np.testing.assert_array_equal(t_p.numpy().reshape(shape3), t)
    np.testing.assert_array_equal(R_p.numpy().reshape(shape3).view(np.uint32),
                                  R.view(np.uint32))


@pytest.mark.parametrize("shape", WALK_SHAPES)
def test_k2_tile_walk_matches_decode_plain(shape):
    """The tiled K2, walked in numpy, equals decode_plain bit for bit."""
    km, kv, q = _k2_inputs(shape, 9)
    shape3 = _shape3(shape)
    km3, kv3, q3 = (a.reshape(shape3) for a in (km, kv, q))
    R = np.zeros(shape3, np.float32)

    def point(i, j, k):
        R[i, j, k] = (kv3[i, j, k] if km3[i, j, k]
                      else _pred7_np(R, i, j, k) + q3[i, j, k])

    _walk_tiles(shape3, point)
    got = lorenzo_kernel.decode_plain(*(torch.from_numpy(a)
                                        for a in (km, kv, q)))
    np.testing.assert_array_equal(got.numpy().reshape(shape3).view(np.uint32),
                                  R.view(np.uint32))
