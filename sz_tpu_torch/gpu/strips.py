"""The unit grid, claim order and scratch of the warp-strip kernels (K10/K11
in ``csrc/classic.cu``, K1d/K2d in ``csrc/lorenzo.cu``, K16/K17 in
``csrc/intc.cu``, all on the machinery of ``csrc/strips.cuh``).

A launch walks ``nvol`` volumes of r1 x r2 x r3 (rank 2: one plane).  A
unit is a group of a block's warps: rank 3, ``warps`` consecutive planes
of one strip of LANES rows; rank 2, ``warps`` consecutive strips of the
plane.  The kernel claims the units from a global counter in the order
made here, so every unit's predecessors come first.  The constants mirror
``strips.cuh`` (a CPU test holds them equal); each kernel family keeps
its own warps a block and ring length (``classic_kernel.WARPS`` and
``RING``, ``lorenzo_kernel.WARPS_F64`` and ``RING_F64``,
``int_kernel.WARPS`` and ``RING``).  Made in Python
so that the CPU tests reach the geometry the kernels use.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from sz_tpu_torch.gpu import device as devmod

# strips.cuh's constants: rows a strip (a lane each), steps a slot chunk
# (staging, output, hand-offs), and steps between two in-block progress
# marks by rank
LANES, CHUNK = 32, 16
GROUP = {2: 8, 3: 4}


def strip_grid(rank: int, r1: int, r2: int, warps: int) -> tuple:
    """(ng, ns): a volume's units, ng plane groups x ns strip groups.
    Rank 3: groups of ``warps`` planes, one strip of LANES rows each;
    rank 2: one plane, groups of ``warps`` strips."""
    strips = -(-r2 // LANES)
    if rank == 2:
        return 1, -(-strips // warps)
    return -(-r1 // warps), strips


def strip_order(rank: int, nvol: int, r1: int, r2: int,
                warps: int) -> np.ndarray:
    """The units (v, g, s), numbered (v * ng + g) * ns + s, in the order
    the kernel claims them: by diagonal g + s, then volume, then g.  A
    unit's predecessors (g - 1, s), (g, s - 1) and (g - 1, s - 1) of its
    volume lie on earlier diagonals, so they come first; a 4-D field's
    volumes interleave, diagonal by diagonal."""
    ng, ns = strip_grid(rank, r1, r2, warps)
    v, g, s = (a.reshape(-1) for a in np.meshgrid(
        np.arange(nvol), np.arange(ng), np.arange(ns), indexing="ij"))
    return np.lexsort((g, v, g + s)).astype(np.int32)


def lattice(shape) -> tuple:
    """(rank, nvol, r1, r2, r3) of the one launch on a field of ``shape``:
    rank 2 is one plane, rank 3 one volume, rank 4 its q1 volumes of a
    rank-3 lattice."""
    shape = tuple(int(s) for s in shape)
    if len(shape) == 2:
        return (2, 1, 1) + shape
    if len(shape) == 3:
        return (3, 1) + shape
    return (3,) + shape


def scratch_sizes(rank: int, nvol: int, r1: int, r2: int, r3: int,
                  warps: int) -> tuple:
    """(rows, planes, flags) entries of a launch's scratch: the published
    last rows [nvol][ns][r1][r3] (rank 2: [ns][r3]), the published last
    planes by slot (column + row) [nvol][ng][r2][r3 + LANES] (rank 3;
    rank 2 none), and the flags [units][warps + 1] with the claim
    counter."""
    ng, ns = strip_grid(rank, r1, r2, warps)
    rows = nvol * ns * (r1 if rank == 3 else 1) * r3
    planes = nvol * ng * r2 * (r3 + LANES) if rank == 3 else 0
    return rows, planes, nvol * ng * ns * (warps + 1) + 1


def shared_bytes(warps: int, item: int, stage_bytes: int, ring: int) -> int:
    """Dynamic shared memory of a block (strips.cuh ``shared_bytes``):
    warps + 1 value rings of LANES + 1 rows of ring + 1 ``item``-byte
    values, warps staging regions of ``stage_bytes``, and the progress
    marks."""
    return ((warps + 1) * (LANES + 1) * (ring + 1) * item
            + warps * stage_bytes + (warps + 1) * 4)


@functools.lru_cache(maxsize=32)
def _order_on(rank: int, nvol: int, r1: int, r2: int, warps: int, device):
    """The claim order on ``device``, made once per lattice shape."""
    return devmod.cache_tensor(strip_order(rank, nvol, r1, r2, warps),
                               device)


def strip_args(lat: tuple, warps: int, dtype, device) -> tuple:
    """A launch's strip arguments for the lattice ``lat`` = (rank, nvol,
    r1, r2, r3) and blocks of ``warps`` warps: (order, flags, rows,
    planes) as C arguments and the unit count, and the tensors, which the
    caller keeps alive until the launch is queued (rows and planes of
    the values' ``dtype``)."""
    rank, nvol, r1, r2, r3 = lat
    order = devmod.cached(_order_on(rank, nvol, r1, r2, warps, device))
    n_rows, n_planes, n_flags = scratch_sizes(rank, nvol, r1, r2, r3, warps)
    flags = torch.zeros(n_flags, dtype=torch.int32, device=device)
    rows = torch.empty(max(n_rows, 1), dtype=dtype, device=device)
    planes = torch.empty(max(n_planes, 1), dtype=dtype, device=device)
    keep = (order, flags, rows, planes)
    return (*(ctypes.c_void_p(t.data_ptr()) for t in keep),
            int(order.numel())), keep
