"""The tile grid and claim order of the tiled wavefront kernels (K1/K2 in
``csrc/lorenzo.cu``, K8/K9 in ``csrc/msst19.cu``, both on the machinery
of ``csrc/tiles.cuh``).

A kernel claims the tiles of its lattice from a global counter in the
order made here, so every tile's three predecessors (one lower on one
axis) are claimed before it; each kernel family keeps its own tile
shapes (``lorenzo_kernel.TILE3``/``TILE2``, ``msst19_kernel.TILE3``/
``TILE2``), mirrored from its CUDA source.  Made in Python so that the
CPU tests reach the geometry the kernels use.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from sz_tpu_torch.gpu import device as devmod


def tile_order(shape3, tile):
    """The tiles of a rank-3 lattice in the order the kernel claims them.

    Returns ``(grid, order, starts)``: ``grid`` the tiles per axis;
    ``order[n]`` the flat index ``(I * grid[1] + J) * grid[2] + K`` of the
    n-th tile, by tile-diagonal ``S = I + J + K``, then I, then J, so each
    tile's predecessors (one lower on one axis) come before it;
    ``starts[S]`` the first number of diagonal S (prefix counts of tiles
    per diagonal; ``starts[-1]`` is the tile count)."""
    grid = tuple(-(-int(r) // int(b)) for r, b in zip(shape3, tile))
    S = np.indices(grid).sum(axis=0).reshape(-1)
    order = np.argsort(S, kind="stable").astype(np.int32)
    starts = np.zeros(max(sum(grid) - 1, 0), dtype=np.int64)
    np.cumsum(np.bincount(S, minlength=starts.size - 1), out=starts[1:])
    return grid, order, starts


@functools.lru_cache(maxsize=32)
def _order_on(shape3, tile, device):
    """(order on ``device``, tile count): made once per lattice shape."""
    _, order, _ = tile_order(shape3, tile)
    return devmod.cache_tensor(order, device), int(order.size)


def tiled(shape3, tile, device):
    """A kernel's tile arguments for one call on a rank-3 lattice: the
    claim order, fresh zero flags (the last is the claim counter) and the
    tile count, as C arguments; and the flags tensor, which the caller
    keeps alive until the launch is queued."""
    order, ntiles = _order_on(tuple(shape3), tuple(tile), device)
    devmod.cached(order)
    flags = torch.zeros(ntiles + 1, dtype=torch.int32, device=device)
    return (ctypes.c_void_p(order.data_ptr()),
            ctypes.c_void_p(flags.data_ptr()), ntiles), flags

