"""K12 ``ra_encode`` and K13 ``ra_decode``: the random-access block
codec's per-block quantization and reconstruction.

CUDA kernels in ``csrc/ra.cu`` (one ``__global__`` a rank:
``ra_{encode,decode}{1d,2d,3d}_kernel``).  K12 replaces the XLA scan
``sz_tpu/tpu/ra_engine.py::_encode_fn``, K13 ``::_decode_fn``: a scan
over the bs^rank cells of a block, vectorised over every block.  On the
card one thread walks one block in raster order, its Lorenzo
reconstruction in a two-plane ring in shared memory; ``ra.cu``'s note
has the arithmetic, the design and what bounds it.

Beside each kernel sits its plain torch version: ``ra_engine``'s scan
over cells, vectorised over blocks, with each float and double operation
a separate torch op.  The wrappers take it only for CPU tensors; for CUDA
tensors they launch the kernel or raise.

Arguments: ``blocks`` float32 (nb, bs^rank), the edge-padded blocks in
raster order; ``lor`` uint8 (nb,), 1 for a Lorenzo block and 0 for a
regression block; ``qc`` float32 (nb, rank + 1), each block's quantized
regression coefficients (any value on Lorenzo blocks); ``rp`` the bound
(a double); ``cap`` the interval count, ``radius`` half of it; ``mean``
the float32 mean of the use_mean flush.  The decoder takes ``types``
int32 (nb, bs^rank) and ``escv`` float32 of the same shape, the escapes'
values placed at their cells (anything elsewhere).
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from sz_tpu_torch.gpu import _build

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


def ra_decode_plain(types, escv, lor, qc, rank: int, bs: int, rp: float,
                    radius: int, use_mean: bool, mean: float):
    nb, dev = types.shape[0], types.device
    cells, self_idx, nbrs, rsize = _cell_tables(rank, bs)
    lorb = lor != 0
    rp64 = torch.tensor(float(rp), dtype=_F64, device=dev)
    mean32 = torch.tensor(np.float32(mean), device=dev)
    R = torch.zeros((nb, rsize), dtype=_F32, device=dev)
    out = torch.zeros((nb, len(cells)), dtype=_F32, device=dev)
    for ci, cell in enumerate(cells):
        t = types[:, ci]
        pred = torch.where(lorb, _lorenzo(R, nbrs[ci]), _reg_pred(qc, cell))
        val = _rebuild(pred, t, radius, rp64)
        if use_mean:
            val = torch.where(lorb & (t == 1), mean32, val)
        val = torch.where(t == 0, escv[:, ci], val)
        R[:, self_idx[ci]] = val
        out[:, ci] = val
    return out


# --- wrappers -------------------------------------------------------------

def _check(name, rank, bs, lattice, lor, qc):
    """Validate the (nb, bs^rank) lattice tensors ((tensor, dtype), ...),
    lor and qc; returns the device type."""
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
    tensors = [t for t, _ in lattice] + [lor, qc]
    dev = tensors[0].device
    if dev.type not in ("cpu", "cuda") or any(t.device != dev
                                              for t in tensors):
        raise ValueError(f"{name}: tensors on one cpu or cuda device")
    if dev.type == "cuda" and not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name}: contiguous tensors required")
    return dev.type


def _p(t):
    return ctypes.c_void_p(t.data_ptr())


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def ra_encode(blocks, lor, qc, rank: int, bs: int, rp: float, cap: int,
              radius: int, use_mean: bool, mean: float):
    """K12: the int32 types (nb, bs^rank) of every block."""
    kind = _check("ra_encode", rank, bs, [(blocks, _F32)], lor, qc)
    if kind == "cpu":
        return ra_encode_plain(blocks, lor, qc, rank, bs, rp, cap, radius,
                               use_mean, mean)
    types = torch.empty(blocks.shape, dtype=_I32, device=blocks.device)
    rc = _build.lib().sz_ra_encode(
        _p(blocks), _p(lor), _p(qc), blocks.shape[0], rank, bs, float(rp),
        int(cap), int(radius), int(bool(use_mean)), float(np.float32(mean)),
        _p(types), _stream(blocks))
    _build.check(rc, "ra_encode")
    ra_encode.launches += 1
    return types


def ra_decode(types, escv, lor, qc, rank: int, bs: int, rp: float,
              radius: int, use_mean: bool, mean: float):
    """K13: the float32 values (nb, bs^rank) of every block."""
    kind = _check("ra_decode", rank, bs, [(types, _I32), (escv, _F32)], lor,
                  qc)
    if kind == "cpu":
        return ra_decode_plain(types, escv, lor, qc, rank, bs, rp, radius,
                               use_mean, mean)
    out = torch.empty(types.shape, dtype=_F32, device=types.device)
    rc = _build.lib().sz_ra_decode(
        _p(types), _p(escv), _p(lor), _p(qc), types.shape[0], rank, bs,
        float(rp), int(radius), int(bool(use_mean)), float(np.float32(mean)),
        _p(out), _stream(types))
    _build.check(rc, "ra_decode")
    ra_decode.launches += 1
    return out


ra_encode.launches = ra_decode.launches = 0
