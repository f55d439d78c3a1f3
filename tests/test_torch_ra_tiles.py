"""K12/K13's decomposition on the CPU: the tables and the index maths the
kernels of ``csrc/ra.cu`` read or compute, modelled in numpy and held to
the plain versions and to sz_tpu.

- ``ra_kernel.diag_table`` (the Lorenzo blocks' anti-diagonal walk at
  ranks 2 and 3): every cell once, every stencil neighbour on an earlier
  diagonal or the border, no diagonal wider than a warp, and a walk
  in table order equal to the raster walk of sz_tpu's numpy oracle, both
  ways, bit for bit;
- the rank-1 staging (32 blocks a warp through a 32 x 33 tile, kChunk
  cells a block a stage; constants read from ra.cu): each lane walks its
  own block's cells in raster order, every cell is loaded and stored
  once;
- K13's escape ranks (a ballot and popc over each 32-cell chunk of a
  block, plus a running count) against the raster cumulative
  sum, and the plain decode against sz_tpu's oracle on the same
  lattices: no escape at all, a block whose every cell escapes, escapes
  that straddle chunks, escapes only in the cells a rank-3 warp stages
  last, one escape in a block's last cell, a strided selection as a
  region makes; one escape too many raises, as sz_tpu's oracle does;
- the region layout through the API: at ranks 1-3 a crop that is not
  block-aligned, a one-block region and the whole field equal
  ``sz_tpu.decompress_region`` / ``sz_tpu.decompress``.

Inputs from numpy seeds.  Tolerance: exact -- equal bits.
"""

import dataclasses
import re

import numpy as np
import pytest
import torch
torch.set_num_threads(1)  # xdist workers share the cores: one thread each

import sz_tpu
from sz_tpu import config as jcfg
from sz_tpu.core import rablock as jrb

import sz_tpu_torch
from sz_tpu_torch.config import ErrorBoundMode, SZConfig
from sz_tpu_torch.core import rablock
from sz_tpu_torch.gpu import ra_engine, ra_kernel

from _chip_smoke import REPO, SMOKE

CPU = torch.device("cpu")
F32, F64 = np.float32, np.float64


def _ra_cu(name: str) -> int:
    text = (REPO / "sz_tpu_torch" / "csrc" / "ra.cu").read_text()
    return int(re.search(rf"constexpr int {name} = (\d+);", text)[1])


def _field(shape, seed):
    """chip_smoke's exact field (rank 1: a column of a 2-D one)."""
    if len(shape) == 1:
        return np.ascontiguousarray(SMOKE.field((shape[0], 2), seed)[:, 0])
    return SMOKE.field(shape, seed)


def _bordered(s, rank, bs):
    """A bordered (bs+1)^rank index -> its coordinates there."""
    b1 = bs + 1
    out = []
    for _ in range(rank):
        out.append(s % b1)
        s //= b1
    return out[::-1]


# --- the diagonal tables --------------------------------------------------

@pytest.mark.parametrize("rank,bs", [(3, 6), (2, 16)])
def test_diag_table(rank, bs):
    tab = ra_kernel.diag_table(rank, bs)
    assert tab.shape == (rank * (bs - 1) + 1, 32) and tab.dtype == np.int32
    cells, self_idx, nbrs, _ = ra_kernel._cell_tables(rank, bs)
    ent = tab[tab >= 0]
    ci, s = ent & 0xFFFF, ent >> 16
    assert sorted(ci) == list(range(bs ** rank))       # every cell once
    np.testing.assert_array_equal(s, np.asarray(self_idx)[ci])
    diag_of = np.empty(bs ** rank, np.int64)
    for d, row in enumerate(tab):
        live = row[row >= 0]
        assert (row[len(live):] < 0).all()             # lanes 0.. take cells
        diag_of[live & 0xFFFF] = d
        # raster order within the diagonal, and i + j (+ k) = d
        assert list(live & 0xFFFF) == sorted(live & 0xFFFF)
        assert all(sum(cells[c]) == d for c in live & 0xFFFF)
    assert max((tab >= 0).sum(axis=1)) == {3: 27, 2: 16}[rank]
    for c, nb7 in enumerate(nbrs):                     # the stencil
        for n in nb7:
            co = _bordered(n, rank, bs)
            if min(co) == 0:
                continue                               # the zero border
            nc = int(np.ravel_multi_index([v - 1 for v in co], [bs] * rank))
            assert diag_of[nc] < diag_of[c]
    with pytest.raises(ValueError, match="wider"):   # 8^3: 48 cells wide
        ra_kernel.diag_table(3, 8)


# (name, maker, bound): ranks 2 and 3, the mean flush, random data under a
# bound that most points escape
WALK_CASES = [
    ("3d", lambda: SMOKE.field((13, 14, 20), 3), 1e-3),
    ("3d_mean", lambda: SMOKE.ra_mean_field((20, 21, 22), 9), 1e-3),
    ("2d", lambda: SMOKE.field((40, 50), 4), 1e-3),
    ("2d_mean", lambda: SMOKE.ra_mean_field((60, 50), 10), 1e-3),
    ("3d_1e-6", lambda: np.random.default_rng(1).standard_normal(
        (12, 12, 18)).astype(F32), 1e-6),
]


def _prepared(make, rp):
    x = np.ascontiguousarray(make())
    return x, rablock.prepare(x, rp, SZConfig(random_access=True))


def _escapes(p, types):
    esc = types == 0
    base = np.concatenate([[0], np.cumsum(esc.sum(axis=1))[:-1]])
    return p.blocks.reshape(len(types), -1)[esc], base


@pytest.mark.parametrize("name,make,rp", WALK_CASES,
                         ids=[c[0] for c in WALK_CASES])
def test_diag_walk_matches_raster(name, make, rp):
    """The anti-diagonal walk of K12/K13 (diag_table's order, every block
    walked as a Lorenzo block would be, the predictor picked at the end
    as in the oracle) gives sz_tpu's raster types and values bit for
    bit; K13's escapes come by their raster rank."""
    x, p = _prepared(make, rp)
    rank, bs, nb = x.ndim, p.bs, p.blocks.shape[0]
    rp64, cap, radius = F64(rp), p.intervals, p.intervals // 2
    cells = jrb._cells(rank, bs)
    flat = p.blocks.reshape(nb, -1)
    reg, lor = ~p.indicator, p.indicator
    mean32 = F32(p.mean)
    order = [int(e) & 0xFFFF for row in ra_kernel.diag_table(rank, bs)
             for e in row if e >= 0]
    assert order != list(range(len(cells)))
    types = np.full((nb, len(cells)), -1, np.int32)
    R = np.zeros((nb,) + (bs + 1,) * rank, F32)
    for ci in order:
        cell, cur = cells[ci], flat[:, ci]
        t_r, rec_r = jrb._quant_cell(cur, jrb._reg_pred(p.qc_full, cell,
                                                        rank), rp64, cap,
                                     radius)
        t_l, rec_l = jrb._quant_cell(cur, jrb._lorenzo_cell(R, cell, rank),
                                     rp64, cap - 2, radius)
        if p.use_mean:
            flush = np.abs((cur - mean32).astype(F64)) <= rp64
            t_l, rec_l = np.where(flush, 1, t_l), np.where(flush, mean32,
                                                           rec_l)
        types[:, ci] = np.where(reg, t_r, t_l)
        R[(slice(None),) + tuple(c + 1 for c in cell)] = np.where(reg, cur,
                                                                  rec_l)
    want = jrb._encode_blocks_np(p.blocks, p.indicator, p.qc_full, rank, bs,
                                 rp, cap, p.use_mean, p.mean)
    np.testing.assert_array_equal(types, want)
    assert lor.any() and (rp > 1e-6 or (want == 0).mean() > 0.5)

    unpred, base = _escapes(p, want)
    rank_in_block = np.cumsum(want == 0, axis=1) - 1
    escv = np.where(want == 0, unpred[np.clip(base[:, None] + rank_in_block,
                                              0, max(len(unpred) - 1, 0))]
                    if len(unpred) else 0, 0).astype(F32)
    vals = np.zeros((nb, len(cells)), F32)
    R = np.zeros((nb,) + (bs + 1,) * rank, F32)
    for ci in order:
        cell, t = cells[ci], want[:, ci]
        pred = np.where(reg, jrb._reg_pred(p.qc_full, cell, rank),
                        jrb._lorenzo_cell(R, cell, rank))
        v = (pred.astype(F64) + (2 * (t - radius)).astype(F64)
             * rp64).astype(F32)
        if p.use_mean:
            v = np.where(lor & (t == 1), mean32, v)
        v = np.where(t == 0, escv[:, ci], v)
        vals[:, ci] = v
        R[(slice(None),) + tuple(c + 1 for c in cell)] = v
    host = jrb._decode_blocks_np(want, nb, rank, bs, lor, reg, p.qc_full,
                                 rp64, radius, p.use_mean, mean32, unpred,
                                 base)
    np.testing.assert_array_equal(vals.view(np.uint32), host.view(np.uint32))


# --- rank 1: the staging tile ---------------------------------------------

@pytest.mark.parametrize("nb", [1, 5, 32, 33, 257, 300])
def test_rank1_staging(nb):
    """encode_lanes / decode_lanes: warp w of CTA c takes blocks
    b0 = (c kWarps + w) 32 ..; per stage c0 the tile T[r][l] holds cell
    c0 + l of block b0 + r (a 128-byte load a block), lane l walks
    T[l][0..kChunk) (its own block's cells c0.. in order) and the tile
    goes back by the same rows."""
    bs, warps, chunk = 256, _ra_cu("kWarps"), _ra_cu("kChunk")
    assert bs % chunk == 0 and chunk == 32
    ctas = -(-nb // (32 * warps))
    loads = np.zeros(nb * bs, np.int64)
    stores = np.zeros(nb * bs, np.int64)
    for c in range(ctas):
        for w in range(warps):
            b0 = (c * warps + w) * 32
            if b0 >= nb:
                continue
            rows = min(32, nb - b0)
            walked = [[] for _ in range(rows)]
            for c0 in range(0, bs, chunk):
                r, lane = np.meshgrid(np.arange(rows), np.arange(32),
                                      indexing="ij")
                T = np.full((32, chunk + 1), -1, np.int64)
                T[r, lane] = (b0 + r) * bs + c0 + lane      # the loads
                np.add.at(loads, T[r, lane].ravel(), 1)
                for ln in range(rows):                    # the walk
                    walked[ln] += list(T[ln, :chunk])
                np.add.at(stores, T[r, lane].ravel(), 1)  # the stores
            for ln in range(rows):
                assert walked[ln] == list(range((b0 + ln) * bs,
                                                (b0 + ln + 1) * bs))
    assert (loads == 1).all() and (stores == 1).all()


# --- K13's escape ranks ---------------------------------------------------

def _ballot_ranks(types):
    """decode_group's ranks: per block, chunks of 32 raster cells (a
    warp), each escape's rank the popcount of the chunk's escapes below
    its lane plus the count of the chunks before (-1 where no escape)."""
    nb, ncell = types.shape
    out = np.full(types.shape, -1, np.int64)
    for b in range(nb):
        run = 0
        for c0 in range(0, ncell, 32):
            esc = [c0 + g < ncell and types[b, c0 + g] == 0
                   for g in range(32)]
            mask = sum(1 << g for g in range(32) if esc[g])
            for g in range(32):
                if esc[g]:
                    out[b, c0 + g] = run + bin(mask & ((1 << g) - 1)).count(
                        "1")
            run += bin(mask).count("1")
    return out


@pytest.mark.parametrize("kind", ["none", "all", "straddle", "strided",
                                  "tail", "last"])
@pytest.mark.parametrize("shape", [(13, 14, 20), (40, 50), (3000,)],
                         ids=["3d", "2d", "1d"])
def test_escape_ranks(shape, kind):
    x, p = _prepared(lambda: _field(shape, 5), 1e-3)
    rank, bs, nb = x.ndim, p.bs, p.blocks.shape[0]
    radius = p.intervals // 2
    types = jrb._encode_blocks_np(p.blocks, p.indicator, p.qc_full, rank,
                                  bs, 1e-3, p.intervals, p.use_mean, p.mean)
    types[types == 0] = radius                          # no escape at all
    vals = np.random.default_rng(3).standard_normal(types.shape).astype(F32)
    if kind == "all":
        types[nb // 2] = 0
    elif kind in ("straddle", "strided"):
        cells = [c for c in (0, 15, 16, 31, 32, 33, 63, 64, 95, 100, 215,
                             255) if c < types.shape[1]]
        types[::2, cells[::2]] = 0
        types[1::3, cells[1::2]] = 0
    elif kind in ("tail", "last"):
        SMOKE.ra_escape_layout(types, kind, radius)
    esc = types == 0
    unpred = vals[esc]
    base = np.concatenate([[0], np.cumsum(esc.sum(axis=1))[:-1]])
    if kind == "none":
        assert len(unpred) == 0
    if rank > 1:
        want = np.where(esc, np.cumsum(esc, axis=1) - 1, -1)
        np.testing.assert_array_equal(_ballot_ranks(types), want)
    if kind == "strided":
        start = tuple(min(bs + 1, r - 1) for r in shape)
        sel, grid, lo, ext = rablock.region_blocks(shape, bs, start, shape)
        assert len(sel) < nb and (np.diff(sel) > 1).any() or rank == 1
    else:
        sel, grid, lo, ext = rablock.region_blocks(shape, bs, (0,) * rank,
                                                   shape)
    out = ra_engine.decode_blocks(types[sel], rank, bs, p.indicator[sel],
                                  p.qc_full[sel], 1e-3, radius, p.use_mean,
                                  p.mean, unpred, base[sel], grid, lo, ext,
                                  device=CPU)
    host = jrb._decode_blocks_np(types[sel], len(sel), rank, bs,
                                 p.indicator[sel], ~p.indicator[sel],
                                 p.qc_full[sel], F64(1e-3), radius,
                                 p.use_mean, F32(p.mean), unpred, base[sel])
    perm = [q for d in range(rank) for q in (d, rank + d)]
    host = host.reshape(*grid, *([bs] * rank)).transpose(perm).reshape(
        [g * bs for g in grid])[tuple(slice(a, a + e)
                                      for a, e in zip(lo, ext))]
    np.testing.assert_array_equal(out.numpy().view(np.uint32),
                                  host.view(np.uint32))


@pytest.mark.parametrize("shape", [(13, 14, 20), (40, 50), (3000,)],
                         ids=["3d", "2d", "1d"])
def test_escape_past_the_end_raises(shape):
    """Types that call for one escape more than the stream holds: the
    plain K13 counts it (NaN in its cell), the engine raises, as sz_tpu's
    numpy oracle does."""
    x, p = _prepared(lambda: _field(shape, 5), 1e-3)
    rank, bs = x.ndim, p.bs
    radius = p.intervals // 2
    types = jrb._encode_blocks_np(p.blocks, p.indicator, p.qc_full, rank,
                                  bs, 1e-3, p.intervals, p.use_mean, p.mean)
    SMOKE.ra_escape_layout(types, "last", radius)    # an inner cell
    unpred = np.zeros(0, F32)
    base = np.zeros(len(types), np.int64)
    sel, grid, lo, ext = rablock.region_blocks(shape, bs, (0,) * rank,
                                               shape)
    args = (p.indicator, p.qc_full, 1e-3, radius, p.use_mean, p.mean)
    out, bad = ra_kernel.ra_decode_plain(
        torch.from_numpy(types), torch.from_numpy(unpred),
        torch.from_numpy(base), torch.from_numpy(p.indicator.astype(
            np.uint8)), torch.from_numpy(p.qc_full), rank, bs, *args[2:],
        grid, lo, ext)
    assert int(bad) == 1 and int(torch.isnan(out).sum()) >= 1
    with pytest.raises(ValueError, match="1 escapes past the 0"):
        ra_engine.decode_blocks(types, rank, bs, *args, unpred, base, grid,
                                lo, ext, device=CPU)
    with pytest.raises(IndexError):
        jrb._decode_blocks_np(types, len(sel), rank, bs, p.indicator,
                              ~p.indicator, p.qc_full, F64(1e-3), radius,
                              p.use_mean, F32(p.mean), unpred, base)


def test_escape_cases_on_cpu():
    """chip_smoke.ra_escape_cases (phase 2's K13 escape layouts) runs its
    cases through on CPU tensors, where K13's wrapper is the plain
    version: the layouts are made and one escape too many is counted."""
    rows = SMOKE.ra_escape_cases(CPU)
    assert len(rows) == 3 * 3 * 2
    assert any(r["past_the_end"] == [1, 1] for r in rows)
    assert all(r["past_the_end"] == [0, 0] for r in rows
               if r["case"] != "past_the_end")


# --- the region layout, through the API -----------------------------------

def _jconfig(cfg):
    jc = jcfg.SZConfig(**{f.name: getattr(cfg, f.name)
                          for f in dataclasses.fields(cfg)
                          if hasattr(jcfg.SZConfig, f.name)})
    return dataclasses.replace(jc, engine="numpy")


REGIONS = {
    (13, 14, 20): {"crop": ((1, 5, 7), (11, 13, 19)),
                   "one_block": ((7, 8, 9), (10, 11, 12))},
    (40, 50): {"crop": ((15, 17), (33, 49)),
               "one_block": ((17, 3), (30, 9))},
    (3000,): {"crop": ((255,), (2049,)), "one_block": ((300,), (400,))},
}


@pytest.mark.parametrize("kind", ["crop", "one_block", "whole"])
@pytest.mark.parametrize("shape", list(REGIONS), ids=["3d", "2d", "1d"])
def test_region_layout(shape, kind):
    x = _field(shape, 11)
    cfg = SZConfig(random_access=True).with_bound(ErrorBoundMode.ABS, 1e-3)
    blob = sz_tpu.compress(x, _jconfig(cfg))
    if kind == "whole":
        got = sz_tpu_torch.decompress(blob, shape, device="cpu")
        want = sz_tpu.decompress(blob, shape, np.float32)
    else:
        start, end = REGIONS[shape][kind]
        sel, _, lo, _ = rablock.region_blocks(shape, rablock.BLOCK_SIZE[
            len(shape)], start, end)
        assert (len(sel) == 1) == (kind == "one_block") and any(lo)
        got = sz_tpu_torch.decompress_region(blob, shape, start, end,
                                             device="cpu")
        want = sz_tpu.decompress_region(blob, shape, start, end)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
