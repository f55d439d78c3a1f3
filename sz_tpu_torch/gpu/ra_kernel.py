"""K12 ``ra_encode`` and K13 ``ra_decode``: the random-access block
codec's per-block quantization and reconstruction.

CUDA kernels in ``csrc/ra.cu`` (one ``__global__`` a rank:
``ra_{encode,decode}{1d,2d,3d}_kernel``).  K12 replaces the XLA scan
``sz_tpu/tpu/ra_engine.py::_encode_fn``, K13 ``::_decode_fn``: a scan
over the bs^rank cells of a block, vectorised over every block.  On the
card a warp takes a block at ranks 2 and 3: regression cells a lane
each, Lorenzo blocks along their anti-diagonals in the order of
:func:`diag_table`; at rank 1 a lane takes a block, 32 blocks a warp
staged through a shared tile.  K13 reads the escapes in stream order (a
ballot ranks each block's) and writes the region in the field's
row-major layout.  ``ra.cu``'s note has the arithmetic, the design and
what bounds it.

Beside each kernel sits its plain torch version: ``ra_engine``'s scan
over cells, vectorised over blocks, with each float and double operation
a separate torch op; the plain decode places the escapes with a
cumulative sum and de-blocks with ``permute``.  The wrappers take it only
for CPU tensors; for CUDA tensors they launch the kernel or raise.

Arguments: ``blocks`` float32 (nb, bs^rank), the edge-padded blocks in
raster order; ``lor`` uint8 (nb,), 1 for a Lorenzo block and 0 for a
regression block; ``qc`` float32 (nb, rank + 1), each block's quantized
regression coefficients (any value on Lorenzo blocks); ``rp`` the bound
(a double); ``cap`` the interval count, ``radius`` half of it; ``mean``
the float32 mean of the use_mean flush.  The decoder takes ``types``
int32 (nsel, bs^rank) of the selected blocks (raster order over their
grid), ``unpred`` float32, every escape of the stream in stream order,
``esc_base`` int64 (nsel,), the index in ``unpred`` of each block's
first escape, and the region: ``grid`` the selection's blocks along
each axis, ``lo`` the offset of the region's first cell in the
selection's first block, ``ext`` the region's extents (``rablock.
region_blocks`` computes all four).  It returns the region and an int64
device scalar, the count of escapes its types call for past the end of
``unpred`` (a corrupt stream; they decode to NaN): the engine reads it
where it synchronises and raises.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from sz_tpu_torch.gpu import _build
from sz_tpu_torch.gpu import device as devmod

_F32, _F64, _I32, _I64 = torch.float32, torch.float64, torch.int32, torch.int64


# --- plain versions -------------------------------------------------------

@functools.lru_cache(maxsize=8)
def _cell_tables(rank: int, bs: int):
    """Per cell, in raster order: its coordinates, its index in the
    bordered (bs+1)^rank buffer and its Lorenzo neighbours' indices there
    (7 for rank 3 in the C's operand order, 3 for rank 2, 1 for rank 1),
    and the buffer's size."""
    b1 = bs + 1
    cells = [tuple(int(v) for v in c)
             for c in np.ndindex(*([bs] * rank))]

    def at(*c1):
        flat = 0
        for v in c1:
            flat = flat * b1 + v
        return flat

    self_idx, nbrs = [], []
    for c in cells:
        c1 = [v + 1 for v in c]
        self_idx.append(at(*c1))
        if rank == 3:
            i, j, k = c1
            nbrs.append([at(i, j, k - 1), at(i, j - 1, k), at(i - 1, j, k),
                         at(i, j - 1, k - 1), at(i - 1, j, k - 1),
                         at(i - 1, j - 1, k), at(i - 1, j - 1, k - 1)])
        elif rank == 2:
            i, j = c1
            nbrs.append([at(i, j - 1), at(i - 1, j), at(i - 1, j - 1)])
        else:
            nbrs.append([c1[0] - 1])
    return cells, self_idx, nbrs, b1 ** rank


def _reg_pred(qc, cell):
    """qc0*ii + qc1*jj (+ qc2*kk) + last, a float chain left to right."""
    p = qc[:, 0] * float(cell[0])
    for e in range(1, len(cell)):
        p = p + qc[:, e] * float(cell[e])
    return p + qc[:, len(cell)]


def _lorenzo(R, nb7):
    if len(nb7) == 7:
        p = R[:, nb7[0]] + R[:, nb7[1]]
        p = p + R[:, nb7[2]]
        p = p - R[:, nb7[3]]
        p = p - R[:, nb7[4]]
        p = p - R[:, nb7[5]]
        return p + R[:, nb7[6]]
    if len(nb7) == 3:
        return R[:, nb7[0]] + R[:, nb7[1]] - R[:, nb7[2]]
    return R[:, nb7[0]]


def _rebuild(pred, t, radius: int, rp64):
    """f32(f64(pred) + f64(2 (t - radius)) * rp)."""
    return (pred.to(_F64) + (2 * (t - radius)).to(_F64) * rp64).to(_F32)


def ra_encode_plain(blocks, lor, qc, rank: int, bs: int, rp: float, cap: int,
                    radius: int, use_mean: bool, mean: float):
    nb, dev = blocks.shape[0], blocks.device
    cells, self_idx, nbrs, rsize = _cell_tables(rank, bs)
    lorb = lor != 0
    regb = ~lorb
    rp64 = torch.tensor(float(rp), dtype=_F64, device=dev)
    mean32 = torch.tensor(np.float32(mean), device=dev)
    ccap = torch.where(regb, float(cap), float(cap - 2)).to(_F64)
    R = torch.zeros((nb, rsize), dtype=_F32, device=dev)
    types = torch.zeros((nb, len(cells)), dtype=_I32, device=dev)
    for ci, cell in enumerate(cells):
        cur = blocks[:, ci]
        pred = torch.where(regb, _reg_pred(qc, cell), _lorenzo(R, nbrs[ci]))
        diff = (cur - pred).to(_F64)
        itv = diff.abs() / rp64 + 1.0
        within = itv < ccap
        itv = torch.where(diff < 0, -itv, itv)
        # the truncation only where it is in range (C: within first)
        t = torch.where(within, itv / 2, 0.0).trunc().to(_I32) + radius
        rec = _rebuild(pred, t, radius, rp64)
        ok = within & ((cur - rec).to(_F64).abs() <= rp64)
        t = torch.where(ok, t, 0)
        rec = torch.where(ok, rec, cur)
        if use_mean:
            flush = lorb & ((cur - mean32).to(_F64).abs() <= rp64)
            t = torch.where(flush, 1, t)
            rec = torch.where(flush, mean32, rec)
        R[:, self_idx[ci]] = torch.where(regb, cur, rec)
        types[:, ci] = t
    return types


def ra_decode_plain(types, unpred, esc_base, lor, qc, rank: int, bs: int,
                    rp: float, radius: int, use_mean: bool, mean: float,
                    grid, lo, ext):
    nb, dev = types.shape[0], types.device
    cells, self_idx, nbrs, rsize = _cell_tables(rank, bs)
    # each escape's value at its cell: its raster rank among the block's;
    # past the end of unpred NaN, counted
    esc = types == 0
    take = (esc_base[:, None] + torch.cumsum(esc, dim=1) - 1)[esc]
    n = unpred.numel()
    bad = (take >= n).sum()
    escv = torch.zeros(types.shape, dtype=_F32, device=dev)
    escv[esc] = torch.cat([unpred, unpred.new_full((1,), float("nan"))])[
        take.clamp(max=n)]
    del take
    lorb = lor != 0
    rp64 = torch.tensor(float(rp), dtype=_F64, device=dev)
    mean32 = torch.tensor(np.float32(mean), device=dev)
    R = torch.zeros((nb, rsize), dtype=_F32, device=dev)
    vals = torch.zeros((nb, len(cells)), dtype=_F32, device=dev)
    for ci, cell in enumerate(cells):
        t = types[:, ci]
        pred = torch.where(lorb, _lorenzo(R, nbrs[ci]), _reg_pred(qc, cell))
        val = _rebuild(pred, t, radius, rp64)
        if use_mean:
            val = torch.where(lorb & (t == 1), mean32, val)
        val = torch.where(t == 0, escv[:, ci], val)
        R[:, self_idx[ci]] = val
        vals[:, ci] = val
    # the block-aligned region in the field's layout, then the crop
    perm = [p for d in range(rank) for p in (d, rank + d)]
    full = vals.reshape(*grid, *([bs] * rank)).permute(perm).reshape(
        tuple(g * bs for g in grid))
    return (full[tuple(slice(a, a + e) for a, e in zip(lo, ext))]
            .contiguous(), bad)


@functools.lru_cache(maxsize=8)
def diag_table(rank: int, bs: int) -> np.ndarray:
    """K12/K13's walk of a Lorenzo block (ranks 2 and 3, a warp a
    block): int32 (rank (bs - 1) + 1, 32), row d the cells of the
    anti-diagonal i + j (+ k) = d in raster order, lane l's entry
    ``ci | s << 16`` (ci the raster cell, s its index in the bordered
    buffer of ``_cell_tables``), -1 where the diagonal has no l-th
    cell."""
    cells, self_idx, _, _ = _cell_tables(rank, bs)
    tab = np.full((rank * (bs - 1) + 1, 32), -1, np.int32)
    fill = [0] * len(tab)
    for ci, cell in enumerate(cells):
        d = sum(cell)
        if fill[d] == 32:
            raise ValueError(f"diagonal {d} of a {bs}^{rank} block is wider "
                             f"than a warp")
        tab[d, fill[d]] = ci | self_idx[ci] << 16
        fill[d] += 1
    return tab


@functools.lru_cache(maxsize=8)
def _diag_on(dev, rank: int, bs: int):
    return devmod.cache_tensor(diag_table(rank, bs), dev)


# --- wrappers -------------------------------------------------------------

def _check(name, rank, bs, lattice, lor, qc, more=()):
    """Validate the (nb, bs^rank) lattice tensors ((tensor, dtype), ...),
    lor, qc and the other tensors; returns the device type."""
    if rank not in (1, 2, 3) or bs < 1:
        raise ValueError(f"{name}: rank 1-3 and a positive block size")
    nb = lattice[0][0].shape[0]
    for t, dt in lattice:
        if t.shape != (nb, bs ** rank) or t.dtype != dt:
            raise ValueError(f"{name}: ({nb}, {bs ** rank}) {dt} expected")
    if lor.shape != (nb,) or lor.dtype != torch.uint8:
        raise ValueError(f"{name}: lor must be uint8 ({nb},)")
    if qc.shape != (nb, rank + 1) or qc.dtype != _F32:
        raise ValueError(f"{name}: qc must be float32 ({nb}, {rank + 1})")
    tensors = [t for t, _ in lattice] + [lor, qc, *more]
    dev = tensors[0].device
    if dev.type not in ("cpu", "cuda") or any(t.device != dev
                                              for t in tensors):
        raise ValueError(f"{name}: tensors on one cpu or cuda device")
    if dev.type == "cuda":
        from sz_tpu_torch.core.rablock import BLOCK_SIZE  # imports this
        if not all(t.is_contiguous() for t in tensors):
            raise ValueError(f"{name}: contiguous tensors required")
        if bs != BLOCK_SIZE[rank]:
            raise ValueError(f"{name}: the kernel takes blocks of "
                             f"{BLOCK_SIZE[rank]} a side at rank {rank}")
        if any(t.data_ptr() % 16 for t, _ in lattice):
            raise ValueError(f"{name}: 16-byte aligned blocks required")
    return dev.type


def _check_region(rank, bs, nsel, grid, lo, ext):
    """The region geometry as int tuples, checked against the selection."""
    grid, lo, ext = (tuple(int(v) for v in a) for a in (grid, lo, ext))
    if not len(grid) == len(lo) == len(ext) == rank:
        raise ValueError(f"ra_decode: grid, lo and ext of rank {rank}")
    if int(np.prod(grid)) != nsel:
        raise ValueError(f"ra_decode: a grid of {grid} blocks for {nsel}")
    for g, a, e in zip(grid, lo, ext):
        if a < 0 or e < 0 or a + e > g * bs or g * bs >= 2 ** 31:
            raise ValueError(f"ra_decode: the region {lo} + {ext} lies "
                             f"outside the {grid} blocks")
    return grid, lo, ext


def _p(t):
    return ctypes.c_void_p(None if t is None else t.data_ptr())


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def ra_encode(blocks, lor, qc, rank: int, bs: int, rp: float, cap: int,
              radius: int, use_mean: bool, mean: float):
    """K12: the int32 types (nb, bs^rank) of every block."""
    kind = _check("ra_encode", rank, bs, [(blocks, _F32)], lor, qc)
    if kind == "cpu":
        return ra_encode_plain(blocks, lor, qc, rank, bs, rp, cap, radius,
                               use_mean, mean)
    diag = (devmod.cached(_diag_on(blocks.device, rank, bs))
            if rank > 1 else None)
    types = torch.empty(blocks.shape, dtype=_I32, device=blocks.device)
    rc = _build.lib().sz_ra_encode(
        _p(blocks), _p(lor), _p(qc), blocks.shape[0], rank, _p(diag),
        float(rp), int(cap), int(radius), int(bool(use_mean)),
        float(np.float32(mean)), _p(types), _stream(blocks))
    _build.check(rc, "ra_encode")
    _build.launched(ra_encode)
    return types


def ra_decode(types, unpred, esc_base, lor, qc, rank: int, bs: int,
              rp: float, radius: int, use_mean: bool, mean: float, grid, lo,
              ext):
    """K13: the float32 region of extents ``ext`` (row-major), and the
    count of escapes past the end of ``unpred`` (an int64 scalar)."""
    kind = _check("ra_decode", rank, bs, [(types, _I32)], lor, qc,
                  (unpred, esc_base))
    nsel = types.shape[0]
    if unpred.dim() != 1 or unpred.dtype != _F32:
        raise ValueError("ra_decode: unpred must be 1-D float32")
    if esc_base.shape != (nsel,) or esc_base.dtype != _I64:
        raise ValueError(f"ra_decode: esc_base must be int64 ({nsel},)")
    grid, lo, ext = _check_region(rank, bs, nsel, grid, lo, ext)
    if kind == "cpu":
        return ra_decode_plain(types, unpred, esc_base, lor, qc, rank, bs,
                               rp, radius, use_mean, mean, grid, lo, ext)
    out = torch.empty(ext, dtype=_F32, device=types.device)
    bad = torch.zeros((), dtype=_I64, device=types.device)
    if out.numel() == 0:
        return out, bad
    diag = (devmod.cached(_diag_on(types.device, rank, bs))
            if rank > 1 else None)
    pad = 3 - rank
    rc = _build.lib().sz_ra_decode(
        _p(types), _p(unpred), unpred.numel(), _p(esc_base), _p(lor),
        _p(qc), _p(diag), rank, *grid, *[1] * pad, *lo, *[0] * pad, *ext,
        *[1] * pad, float(rp), int(radius), int(bool(use_mean)),
        float(np.float32(mean)), _p(out), _p(bad), _stream(types))
    _build.check(rc, "ra_decode")
    _build.launched(ra_decode)
    return out, bad


ra_encode.launches = ra_decode.launches = 0
