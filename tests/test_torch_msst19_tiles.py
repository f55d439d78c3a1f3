"""The tiled K8/K9 (``csrc/msst19.cu`` on ``csrc/tiles.cuh``) on the CPU:
their tile shapes against the CUDA source, and a numpy walk of their
claim order and in-tile steps against the plain versions.

The walk visits the tiles in ``tiles.tile_order`` and each tile's points
by step s = li + lj + lk, and computes each point only from a per-tile
buffer filled the way the kernel fills its halo: the three low faces,
and with a two-deep k-halo the point (0, 0, -2) on the lattice's first
row, each read from what an earlier tile published (its high faces and,
two-deep, its point (0, 0, nk - 2)); reading an unpublished point fails.
The plain versions are held to the Pallas T11/T12 in interpret mode by
``tests/test_torch_msst19.py``.  Inputs from numpy seeds; tolerance:
exact (equal bits).
"""

import pathlib
import re

import numpy as np
import pytest
import torch
torch.set_num_threads(1)  # xdist workers share the cores: one thread each

from sz_tpu_torch.core import pwr
from sz_tpu_torch.gpu import msst19_engine, msst19_kernel, tiles

F32, F64 = np.float32, np.float64


def test_tiles_match_the_cuda_source():
    """TILE3 / TILE2 (float data) and TILE3_F64 / TILE2_F64 (K8d/K9d),
    from which the wrappers make the claim order, are the tile shapes
    msst19.cu compiles (Msst19Tile<3, V> / <2, V>; a double tile may
    differ where kWide), which it hands to tiles.cuh's TileShape with a
    two-deep k-halo."""
    src = (pathlib.Path(msst19_kernel.__file__).resolve().parent.parent
           / "csrc" / "msst19.cu").read_text()
    dims = re.findall(
        r"static constexpr int (b[ijk]) = kRank == 3 \? (\d+) : "
        r"(?:kWide \? (\d+) : )?(\d+);", src)
    assert [d[0] for d in dims] == ["bi", "bj", "bk"]
    assert "static constexpr bool kWide = sizeof(V) == 8;" in src
    assert tuple(int(d[1]) for d in dims) == msst19_kernel.TILE3
    assert tuple(int(d[1]) for d in dims) == msst19_kernel.TILE3_F64
    assert tuple(int(d[3]) for d in dims) == msst19_kernel.TILE2
    assert tuple(int(d[2] or d[3]) for d in dims) == msst19_kernel.TILE2_F64
    assert "using Msst19Geo = Geo<TileShape<Msst19Tile<kRank, V>, 2>>;" in src
    for rank in (3, 2):
        for v in ("float", "double"):
            assert f"Msst19Geo<{rank}, {v}>" in src
    assert msst19_kernel.TILE2[0] == msst19_kernel.TILE2_F64[0] == 1
    assert all(b[0] * b[1] % 32 == 0 and b[2] >= 2
               for b in (msst19_kernel.TILE3, msst19_kernel.TILE2,
                         msst19_kernel.TILE3_F64, msst19_kernel.TILE2_F64))


def _shared_bytes(tile, value_bytes):
    """tiles.cuh's shared_bytes for a rule with kArrays 3 and no flags:
    the tile with its two-deep k-halo at the bank-spreading pitches."""
    def pitch(lo, want):
        return lo + ((want - lo) % 32 + 32) % 32
    bi, bj, bk = tile
    P = pitch(bk + 2, 2)
    Q = pitch((bj + 1) * P, bj + 1)
    return (bi + 1) * Q * (2 * value_bytes + 4)


def test_tiles_fit_a_block():
    """Every tile's shared memory fits a block's 232,448 bytes (the float
    2-D tile's shape in double would not: the reason K9d is shorter on
    k); the figures msst19.cu's note gives."""
    limit = 232448
    assert _shared_bytes(msst19_kernel.TILE3_F64, 8) == 106740
    assert _shared_bytes(msst19_kernel.TILE2_F64, 8) == 172840
    assert _shared_bytes(msst19_kernel.TILE2, 8) == 256040 > limit
    for tile, vb in ((msst19_kernel.TILE3, 4), (msst19_kernel.TILE2, 4),
                     (msst19_kernel.TILE3_F64, 8),
                     (msst19_kernel.TILE2_F64, 8)):
        assert _shared_bytes(tile, vb) <= limit


# --- the point rules, numpy scalars in msst19.cu's op order ---------------

def _pred(buf, a, b, c, i, j, k, rank):
    """predict() of msst19.cu: point (i, j, k) at buffer index (a, b, c),
    from the magnitudes of its neighbours in the buffer."""
    def nb(di, dj, dk):
        return abs(buf[a - di, b - dj, c - dk])

    A = nb(0, 0, 1)
    if rank == 2:
        if j == 0:
            if k == 0:
                return F32(0)
            return A if k == 1 else (A * A) / nb(0, 0, 2)
        return nb(0, 1, 0) if k == 0 else (A * nb(0, 1, 0)) / nb(0, 1, 1)
    B, C = F64(nb(0, 1, 0)), F64(nb(1, 0, 0))
    if i == 0:
        if j == 0:
            if k == 0:
                return F32(0)
            if k == 1:
                return A
            return F32(F64(A) * F64(A) / F64(nb(0, 0, 2)))
        return F32(B) if k == 0 else F32(F64(A) * B / F64(nb(0, 1, 1)))
    if j == 0:
        return F32(C) if k == 0 else F32(F64(A) * C / F64(nb(1, 0, 1)))
    if k == 0:
        return F32(B * C / F64(nb(1, 1, 0)))
    num = F64(A) * B * C * F64(nb(1, 1, 1))
    den = F64(nb(0, 1, 1)) * F64(nb(1, 1, 0)) * F64(nb(1, 0, 1))
    return F32(num / den)


def _lookup(ratio, tab, base, top, bits):
    b = int(F64(ratio).view(np.int64)) & 0x7FFFFFFFFFFFFFFF
    expo = (b >> 52) - base
    if not 0 <= expo <= top - base:
        return 0
    return int(tab[(expo << bits) + ((b & 0xFFFFFFFFFFFFF) >> (52 - bits))]) \
        & 0xFFFF


def _recon(pred, s, pt):
    return F32(F64(abs(pred)) * pt[s])


class _Rule:
    """The encode or decode point of one lattice: ``point`` computes the
    value the kernel leaves in its shared copy (the encode also its
    state)."""

    def __init__(self, shape3, rank, tables, data=None, types=None,
                 known=None):
        self.rank = rank
        tab, pt, self.base, self.top, self.bits, ign = tables
        self.tab, self.pt = tab.numpy(), pt.numpy()
        self.mask = np.uint32(msst19_kernel._mask_i32(ign) & 0xFFFFFFFF)
        self.data, self.known = data, known
        self.types = (np.zeros(shape3, np.int32) if types is None
                      else types)
        self.encode = data is not None

    def point(self, buf, a, b, c, i, j, k):
        pred = _pred(buf, a, b, c, i, j, k, self.rank)
        if not self.encode:
            s = int(self.types[i, j, k])
            return _recon(pred, s, self.pt) if s else self.known[i, j, k]
        cur = abs(self.data[i, j, k])
        s = 0 if i == j == k == 0 else _lookup(
            cur / pred, self.tab, self.base, self.top, self.bits)
        self.types[i, j, k] = s
        if s:
            return _recon(pred, s, self.pt)
        return (np.array(cur, F32).view(np.uint32) & self.mask).view(F32)


def _walk(shape3, tile, rule, depth=2):
    """The tiled kernel in numpy: returns the lattice it writes.  Each
    tile's buffer has a k-halo two deep; ``depth`` = 1 leaves the point
    (0, 0, -2) unloaded and unpublished (NaN), as a one-deep halo would."""
    grid, order, _ = tiles.tile_order(shape3, tile)
    pub = np.zeros(shape3, F32)          # what the tiles published
    published = np.zeros(shape3, bool)
    out = np.zeros(shape3, F32)
    for flat in order:
        T = [int(v) for v in np.unravel_index(flat, grid)]
        o = [t * b for t, b in zip(T, tile)]
        n = [min(b, r - x) for b, r, x in zip(tile, shape3, o)]
        follows = [t + 1 < g for t, g in zip(T, grid)]
        buf = np.full((n[0] + 1, n[1] + 1, n[2] + 2), np.nan, F32)

        def load(li, lj, lk):
            p = (o[0] + li, o[1] + lj, o[2] + lk)
            if min(p) < 0:
                v = F32(0)
            else:
                assert published[p], f"tile {T} reads unpublished {p}"
                v = pub[p]
            buf[li + 1, lj + 1, lk + 2] = v

        for lj in range(-1, n[1]):
            for lk in range(-1, n[2]):
                load(-1, lj, lk)
        for li in range(n[0]):
            for lk in range(-1, n[2]):
                load(li, -1, lk)
            for lj in range(n[1]):
                load(li, lj, -1)
        if depth == 2 and T[0] == T[1] == 0 and T[2] > 0:
            load(0, 0, -2)
        with np.errstate(all="ignore"):
            for s in range(sum(n) - 2):
                for li in range(n[0]):
                    for lj in range(n[1]):
                        lk = s - li - lj
                        if 0 <= lk < n[2]:
                            buf[li + 1, lj + 1, lk + 2] = rule.point(
                                buf, li + 1, lj + 1, lk + 2, o[0] + li,
                                o[1] + lj, o[2] + lk)
        box = tuple(slice(x, x + m) for x, m in zip(o, n))
        out[box] = buf[1:, 1:, 2:]
        faces = [tuple(slice(None) if a != ax else n[a] - 1
                       for a in range(3))
                 for ax in range(3) if follows[ax]]
        if depth == 2 and T[0] == T[1] == 0 and follows[2]:
            faces.append((0, 0, n[2] - 2))
        for f in faces:
            pub[box][f] = out[box][f]
            published[box][f] = True
    return out


def _inputs(shape, seed, signed=True):
    """A float32 field (no zeros; signed, or positive and smooth) with
    outliers that escape, and
    its tables as the PW_REL path makes them for 256 intervals (a tiny
    field's optimizer picks 65,536, under which nothing escapes)."""
    rng = np.random.default_rng(seed)
    axes = np.meshgrid(*[np.linspace(0.1, 4 * np.pi, m) for m in shape],
                       indexing="ij")
    f = np.exp(np.sin(axes[0]) * np.cos(axes[-1]))
    f = f * (1 + 0.05 * rng.standard_normal(shape))
    x = (f - np.median(f) if signed else f).astype(F32)
    x[rng.random(shape) < 0.03] *= F32(1000)
    x[x == 0] = F32(0.5)
    iv = 256      # ratios within 1.001^±128: the outliers escape
    cache = pwr._cache_table(iv, 1e-3, 3)
    rl = msst19_engine.req_length(1e-3, len(shape))
    return x, (torch.from_numpy(cache.table.reshape(-1).view(np.int16)),
               torch.from_numpy(pwr._precision_table(iv, 1e-3, 3)),
               cache.base_index, cache.top_index, cache.bits,
               max(32 - rl, 0))


def _family(shape):
    if len(shape) == 3:
        return (msst19_kernel.TILE3, msst19_kernel.wavefront3d_encode_plain,
                msst19_kernel.wavefront3d_decode_plain)
    return (msst19_kernel.TILE2, msst19_kernel.lines2d_encode_plain,
            msst19_kernel.lines2d_decode_plain)


def _known(x, types, ign):
    mask = msst19_kernel._mask_i32(ign)
    return torch.where(types == 0, (x.view(torch.int32) & mask).view(
        torch.float32), torch.zeros_like(x))


def _bits(a):
    return np.asarray(a, F32).view(np.uint32)


WALK_SHAPES = [(3, 5, 7), (9, 17, 70), (2, 3, 200), (33, 9, 65), (5, 200),
               (1, 300), (70, 130), (300, 1)]


@pytest.mark.parametrize("shape", WALK_SHAPES)
def test_tile_walk_matches_plain(shape):
    """The tiled K8 (rank 3) or K9 (rank 2), both directions, walked in
    numpy, equal the plain versions bit for bit; the decode rebuilds the
    encode's reconstruction."""
    tile, enc_p, dec_p = _family(shape)
    x, tables = _inputs(shape, 21)
    shape3 = (1,) * (3 - len(shape)) + shape
    xt = torch.from_numpy(x)
    t_p, R_p = enc_p(xt, *tables)
    assert int((t_p == 0).sum()) > 1          # escapes past the first point
    enc = _Rule(shape3, len(shape), tables, data=x.reshape(shape3))
    R_w = _walk(shape3, tile, enc)
    np.testing.assert_array_equal(enc.types, t_p.numpy().reshape(shape3))
    np.testing.assert_array_equal(_bits(R_w), _bits(R_p.numpy()).reshape(
        shape3))
    known = _known(xt, t_p, tables[-1])
    o_p = dec_p(t_p, known, tables[1])
    dec = _Rule(shape3, len(shape), tables, types=t_p.numpy().reshape(shape3),
                known=known.numpy().reshape(shape3))
    o_w = _walk(shape3, tile, dec)
    np.testing.assert_array_equal(_bits(o_w), _bits(o_p.numpy()).reshape(
        shape3))
    np.testing.assert_array_equal(_bits(np.abs(o_w)), _bits(R_w))


@pytest.mark.parametrize("shape", [(2, 3, 200), (5, 200)])
def test_one_deep_halo_breaks_the_first_row(shape):
    """Without the (0, 0, -2) point the first row's A*A/A2 reads an
    unloaded slot in every k-tile after the first: the walk must then
    differ from the plain version, so the tests above cover that trap (a
    positive smooth field, whose first row predicts without escapes)."""
    tile, enc_p, _ = _family(shape)
    x, tables = _inputs(shape, 22, signed=False)
    shape3 = (1,) * (3 - len(shape)) + shape
    assert shape3[2] > tile[2]
    enc = _Rule(shape3, len(shape), tables, data=x.reshape(shape3))
    R_w = _walk(shape3, tile, enc, depth=1)
    t_p, R_p = enc_p(torch.from_numpy(x), *tables)
    assert not (np.array_equal(enc.types, t_p.numpy().reshape(shape3))
                and np.array_equal(_bits(R_w),
                                   _bits(R_p.numpy()).reshape(shape3)))
