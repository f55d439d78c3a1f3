"""Block geometry and the compact block-major stream order, in torch.

Counterparts of ``sz_tpu.tpu.engine._geom_small``, ``_corner_parts``,
``_corner_stream``, ``_corner_box_stream``, ``_corner_unstream`` and
``_pos_to_lat_expr`` (``_dev_loc``'s offset vectors reach the device
through ``sz_tpu_torch.state.from_numpy_state``).  Pure data movement
(slices, reshapes, permutes, concatenations and integer index math), so
any formulation is exact; the per-axis corner decomposition is kept
because it needs no n-sized index vector.

SZ's stream order: blocks row-major over the block grid, points row-major
within each block.  Along each axis the ``split`` early blocks (length
``early``) precede the late blocks (length ``late``), so the lattice
splits into at most 2^rank corner boxes whose blocks all have one size,
and each box is one blocked permute.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from sz_tpu_torch.core import blocks as B


@functools.lru_cache(maxsize=16)
def geom_small(shape: tuple, block_size: int) -> dict:
    """Per-dimension geometry vectors (host numpy, O(r) each): the
    DimBlocks, in-block offset ``loc``, block id ``bid`` and block length
    ``cnt`` per coordinate, block stream offsets and the block count."""
    dbs = [B.dim_blocks(r, block_size) for r in shape]
    loc, bid, cnt = [], [], []
    for db in dbs:
        counts = db.counts()
        bid.append(np.repeat(np.arange(db.num, dtype=np.int32), counts))
        loc.append((np.arange(db.r)
                    - np.repeat(db.starts(), counts)).astype(np.int32))
        cnt.append(np.repeat(counts, counts).astype(np.int32))
    grids = np.meshgrid(*[db.counts() for db in dbs], indexing="ij")
    bsizes = np.prod(np.stack([g.ravel() for g in grids]), axis=0)
    offsets = np.concatenate([[0], np.cumsum(bsizes)[:-1]]).astype(np.int64)
    return {"dbs": dbs, "loc": loc, "bid": bid, "cnt": cnt,
            "offsets": offsets,
            "nblocks": int(np.prod([db.num for db in dbs]))}


def dev_bid(shape: tuple, block_size: int, device) -> tuple:
    """The per-axis block-id vectors on ``device`` (int64, for
    index_select)."""
    g = geom_small(tuple(shape), block_size)
    return tuple(torch.from_numpy(b.astype(np.int64)).to(device)
                 for b in g["bid"])


def corner_parts(dbs) -> list:
    """Per-axis [(lattice offset, block count, block length)]: the
    ``split`` early blocks, then the late blocks."""
    parts = []
    for db in dbs:
        p = []
        if db.split:
            p.append((0, db.split, db.early))
        if db.num - db.split:
            p.append((db.split * db.early, db.num - db.split, db.late))
        parts.append(p)
    return parts


def corner_stream(x: torch.Tensor, dbs) -> torch.Tensor:
    """Lattice -> compact block-major stream (n elements, flat)."""
    rank = x.dim()
    parts = corner_parts(dbs)
    perm = (tuple(2 * i for i in range(rank))
            + tuple(2 * i + 1 for i in range(rank)))

    def rec(region, ax, csizes, esizes):
        # region: (c0, E0, .., c_{ax-1}, E_{ax-1}, shape_ax, ..)
        if ax == rank:
            eprod = int(np.prod(esizes, dtype=np.int64))
            return region.permute(perm).reshape(csizes + (eprod,))
        outs = []
        for off, cnt, esz in parts[ax]:
            sub = region.narrow(2 * ax, off, cnt * esz)
            sub = sub.reshape(tuple(region.shape[:2 * ax]) + (cnt, esz)
                              + tuple(region.shape[2 * ax + 1:]))
            r = rec(sub, ax + 1, csizes + (cnt,), esizes + (esz,))
            # fold this axis' block count into the flat tail
            r = r.reshape(tuple(r.shape[:ax])
                          + (r.shape[ax] * r.shape[ax + 1],)
                          + tuple(r.shape[ax + 2:]))
            outs.append(r)
        return outs[0] if len(outs) == 1 else torch.cat(outs, ax)

    return rec(x, 0, (), ()).reshape(-1)


def corner_unstream(x: torch.Tensor, dbs, shape: tuple) -> torch.Tensor:
    """Compact block-major stream -> lattice (inverse of corner_stream)."""
    rank = len(shape)
    parts = [[(cnt, esz) for _, cnt, esz in p] for p in corner_parts(dbs)]

    def box_to_lattice(seg, esizes):
        cs = tuple(seg.shape[:-1])
        perm = tuple(v for i in range(rank) for v in (i, rank + i))
        out_shape = tuple(c * e for c, e in zip(cs, esizes))
        return seg.reshape(cs + esizes).permute(perm).reshape(out_shape)

    def rec(seg, ax, eprod, esizes):
        if ax == rank:
            return box_to_lattice(seg, esizes)
        inner = int(np.prod(shape[ax + 1:], dtype=np.int64))
        outs, off = [], 0
        for cnt, esz in parts[ax]:
            ln = cnt * esz * eprod * inner
            sub = seg.narrow(seg.dim() - 1, off, ln)
            sub = sub.reshape(tuple(seg.shape[:-1])
                              + (cnt, esz * eprod * inner))
            outs.append(rec(sub, ax + 1, eprod * esz, esizes + (esz,)))
            off += ln
        return outs[0] if len(outs) == 1 else torch.cat(outs, ax)

    return rec(x, 0, 1, ())


def pos_to_lat(pos: torch.Tensor, dbs, shape: tuple) -> torch.Tensor:
    """Compact-stream position -> lattice flat index (int64), in closed
    form: invert the per-axis block-cumulative point counts, then the
    in-block mixed radix.  Positions >= n map to n."""
    rank = len(shape)
    n = int(np.prod(shape))
    pos = pos.to(torch.int64)
    oob = pos >= n
    w = pos
    coords, esz = [], []
    eprod = torch.ones((), dtype=torch.int64, device=pos.device)
    for ax, db in enumerate(dbs):
        inner = int(np.prod(shape[ax + 1:], dtype=np.int64))
        u = torch.div(w, eprod * inner, rounding_mode="floor")
        cs = db.split * db.early
        b = torch.where(u < cs,
                        torch.div(u, max(db.early, 1), rounding_mode="floor"),
                        db.split + torch.div(u - cs, max(db.late, 1),
                                             rounding_mode="floor"))
        C = torch.where(b < db.split, b * db.early,
                        cs + (b - db.split) * db.late)
        E = torch.where(b < db.split, db.early, db.late).to(torch.int64)
        w = w - C * eprod * inner
        coords.append(C)
        esz.append(E)
        eprod = eprod * E
    lat = torch.zeros_like(pos)
    for ax in range(rank):
        tail = torch.ones((), dtype=torch.int64, device=pos.device)
        for j in range(ax + 1, rank):
            tail = tail * esz[j]
        e = torch.remainder(torch.div(w, tail, rounding_mode="floor"),
                            esz[ax])
        lat = lat * shape[ax] + (coords[ax] + e)
    return torch.where(oob, torch.full_like(lat, n), lat)
