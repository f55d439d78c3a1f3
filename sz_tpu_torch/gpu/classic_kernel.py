"""K10 ``classic_quantize`` and K11 ``classic_decode``: the positional
Lorenzo recurrence of the classic SZ1.4 codec on 2-D, 3-D and 4-D
fields, encode and decode, float32 and float64.

CUDA kernels in ``csrc/classic.cu``.  They replace no Pallas kernel:
the JAX package solves this recurrence in XLA, a plane scan with a
per-plane fixpoint and a serial scan pinning the first row
(``sz_tpu/tpu/classic_engine.py::_encode_fn`` and ``::_decode_fn``).
Here each call is one persistent launch on the tile machinery of
``csrc/tiles.cuh`` (shared with K1/K2 and K8/K9) with a k-halo two deep
for the first row's 2a - b predictor, which computes each point once, in
dependency order; a 4-D field is one launch a volume (its volumes are
independent), each counted.  Bound by the dependency chain across the
tiles, not by bytes or arithmetic; ``classic.cu``'s note has the rules
and the three numeric forms (``core.classic_nd.Form``).

Beside each kernel sits its plain torch version: an anti-diagonal
wavefront over s = i + j + k, each diagonal one vectorized exact step,
with every operation of the point rule a separate torch op in the
kernel's order.  The wrappers take it only for CPU tensors; for CUDA
tensors they launch the kernel or raise.

Arguments: ``rp`` and ``recip`` are the precision and its reciprocal in
the form's RT (float32 for float32 data of rank 2-3, else float64);
``median`` and ``req_length`` give an escape's reconstruction (the value
less the median, its low width - req_length bits cleared, plus the
median).  The encoder returns the int32 types (0 an escape) and the
reconstruction; the decoder takes the types and ``known`` (the escapes'
values in place, anything elsewhere) and returns the reconstruction.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from sz_tpu_torch.gpu import _build, tiles
from sz_tpu_torch.gpu.msst19_kernel import _diag

_F32, _F64, _I32, _I64 = torch.float32, torch.float64, torch.int32, torch.int64

# the tiles (bi, bj, bk) of each rank and element type, as classic.cu
# compiles them (ClassicTile: K1/K2's LorenzoTile shapes)
TILE3 = (8, 16, 32)
TILE2 = (1, 64, 96)
TILE3_F64 = (8, 16, 32)
TILE2_F64 = (1, 64, 64)


def tile_of(rank: int, dtype) -> tuple:
    """The tile a launch on a rank-``rank`` lattice of ``dtype`` takes
    (a 4-D volume is rank 3)."""
    if dtype == _F64:
        return TILE3_F64 if rank == 3 else TILE2_F64
    return TILE3 if rank == 3 else TILE2


def is_dbl(dtype, rank: int) -> bool:
    """The double form: float64 data, or float32 data of rank 4."""
    return dtype == _F64 or rank == 4


def _mask(req_length: int, dtype) -> int:
    """The kept bits of an escape as a signed bit pattern of the data's
    width."""
    width = 64 if dtype == _F64 else 32
    ign = max(width - req_length, 0)
    m = (~((1 << ign) - 1)) & ((1 << width) - 1) if ign < width else 0
    return m - (1 << width) if m >= 1 << (width - 1) else m


# --- plain versions -------------------------------------------------------

def _volumes(t):
    """A field as (volumes, r1, r2, r3): rank 2 is one volume of one
    layer, rank 3 one volume, rank 4 its q1 volumes."""
    if t.dim() == 2:
        return t.reshape(1, 1, *t.shape)
    if t.dim() == 3:
        return t.unsqueeze(0)
    return t


def _pred_plain(R, fg, i, j, k, r3: int, r23: int):
    """The positional predictor of the cells of one diagonal from their
    neighbours in the guard-padded flat volume R (``fg``: their padded
    indices).  Every case is computed for every cell and the cell's own
    case is selected; the cases a cell does not use may read anything."""
    A, B, D, A2 = R[fg - 1], R[fg - r3], R[fg - r3 - 1], R[fg - 2]
    C, E, F = R[fg - r23], R[fg - r23 - r3], R[fg - r23 - 1]
    G = R[fg - r23 - r3 - 1]
    j0, k0, k1 = j == 0, k == 0, k == 1
    lay0 = torch.where(j0 & k0, torch.zeros_like(A), torch.where(
        j0 & k1, A, torch.where(j0, A * 2 - A2, torch.where(
            k0, B, (A + B) - D))))
    p3 = A + B
    p3 = p3 + C
    p3 = p3 - D
    p3 = p3 - E
    p3 = p3 - F
    p3 = p3 + G
    layk = torch.where(j0 & k0, C, torch.where(
        j0, (A + C) - F, torch.where(k0, (B + C) - E, p3)))
    return torch.where(i == 0, lay0, layk)


def _recon_plain(pred, t, radius: int, rp, dbl: bool):
    """pred + 2(t - radius) * rp: in the data's type, or in double and
    rounded once."""
    m = 2 * (t.to(_I64) - radius)
    if dbl:
        return (pred.to(_F64) + m.to(_F64) * float(rp)).to(pred.dtype)
    return pred + m.to(pred.dtype) * torch.tensor(rp, dtype=pred.dtype,
                                                  device=pred.device)


def _quantize_plain(cur, pred, rp, recip, intervals: int, radius: int,
                    dbl: bool):
    """(types, reconstructions) of one diagonal's cells; type 0 where the
    cell escapes."""
    diff = cur - pred
    m = diff.abs().to(_F64) * float(recip) + 1.0
    itv = m if dbl else m.to(_F32)
    within = itv < intervals
    itv = torch.where(within, torch.where(diff < 0, -itv, itv),
                      torch.zeros_like(itv))
    t = torch.trunc(itv / 2).to(_I64) + radius
    rec = _recon_plain(pred, t, radius, rp, dbl)
    ok = within & ~((cur - rec).abs().to(_F64) > float(rp))
    return torch.where(ok, t, 0), rec


def _escape_plain(cur, median, mask: int):
    """An escape's reconstruction (_esc_recon_dev)."""
    ity = _I64 if cur.dtype == _F64 else _I32
    med = torch.tensor(median, dtype=cur.dtype, device=cur.device)
    norm = cur - med
    return (norm.view(ity) & mask).view(cur.dtype) + med


def _volume_plain(vol, step):
    """The wavefront over one (r1, r2, r3) volume: ``step(fi, pred)``
    gives the (types, values) of a diagonal's cells from their flat
    indices and predictions."""
    r1, r2, r3 = vol.shape
    r23, n = r2 * r3, vol.numel()
    guard = r23 + r3 + 2
    R = torch.zeros(guard + n, dtype=vol.dtype, device=vol.device)
    types = torch.zeros(n, dtype=_I32, device=vol.device)
    for d in range(r1 + r2 + r3 - 2):
        i, j, k = _diag(d, r1, r2, r3, vol.device)
        fi = (i * r2 + j) * r3 + k
        pred = _pred_plain(R, fi + guard, i, j, k, r3, r23)
        t, v = step(fi, pred)
        R[fi + guard] = v
        types[fi] = t.to(_I32)
    return types.reshape(vol.shape), R[guard:].reshape(vol.shape)


def classic_quantize_plain(data, rp, recip, intervals: int, radius: int,
                           median, req_length: int):
    dbl = is_dbl(data.dtype, data.dim())
    mask = _mask(req_length, data.dtype)
    types = torch.empty(data.shape, dtype=_I32, device=data.device)
    R = torch.empty_like(data)
    for v, vol in enumerate(_volumes(data)):
        flat = vol.reshape(-1)

        def step(fi, pred):
            cur = flat[fi]
            t, rec = _quantize_plain(cur, pred, rp, recip, intervals,
                                     radius, dbl)
            t = torch.where(fi == 0, 0, t)     # the first point escapes
            return t, torch.where(t != 0, rec,
                                  _escape_plain(cur, median, mask))

        tv, rv = _volume_plain(vol, step)
        _volumes(types)[v] = tv
        _volumes(R)[v] = rv
    return types, R


def classic_decode_plain(types, known, rp, radius: int):
    dbl = is_dbl(known.dtype, known.dim())
    out = torch.empty_like(known)
    vt = _volumes(types)
    for v, kv in enumerate(_volumes(known)):
        t_all, k_all = vt[v].reshape(-1).to(_I64), kv.reshape(-1)

        def step(fi, pred):
            t = t_all[fi]
            return t, torch.where(t != 0, _recon_plain(pred, t, radius, rp,
                                                       dbl), k_all[fi])

        _volumes(out)[v] = _volume_plain(kv, step)[1]
    return out


# --- wrappers -------------------------------------------------------------

def _check(name: str, data, *others):
    """Validate a float32 or float64 field of rank 2-4 and (tensor,
    dtype) pairs of its shape; returns the device type ('cpu' or
    'cuda')."""
    if data.dim() not in (2, 3, 4):
        raise ValueError(f"{name}: a rank-2, 3 or 4 lattice is required")
    if data.dtype not in (_F32, _F64):
        raise ValueError(f"{name}: float32 or float64 data required")
    for t, dt in others:
        if t.shape != data.shape or t.dtype != dt:
            raise ValueError(f"{name}: inputs of shape {tuple(data.shape)}"
                             f" and dtypes [{dt}, {data.dtype}]")
    tensors = [data] + [t for t, _ in others]
    dev = data.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {dev}")
    if any(t.device != dev for t in tensors):
        raise ValueError(f"{name}: tensors on one device")
    if dev.type == "cuda" and not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name}: contiguous tensors required")
    return dev.type


def _p(t):
    return ctypes.c_void_p(t.data_ptr())


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def _launches(x):
    """(rank of each launch, its (r1, r2, r3), the volumes' views): one
    launch for rank 2 or 3, one a volume for rank 4."""
    if x.dim() == 2:
        return 2, (1, *x.shape), [x]
    if x.dim() == 3:
        return 3, tuple(x.shape), [x]
    return 3, tuple(x.shape[1:]), list(x)


def classic_quantize(data, rp, recip, intervals: int, radius: int, median,
                     req_length: int):
    """K10 encode: the int32 types of a float32 or float64 field of rank
    2-4 and its reconstruction."""
    kind = _check("classic_quantize", data)
    if kind == "cpu":
        return classic_quantize_plain(data, rp, recip, intervals, radius,
                                      median, req_length)
    dbl, f64 = is_dbl(data.dtype, data.dim()), data.dtype == _F64
    width = 64 if f64 else 32
    ign = max(width - int(req_length), 0)
    types = torch.empty(data.shape, dtype=_I32, device=data.device)
    R = torch.empty_like(data)
    rank, lat, vols = _launches(data)
    lib = _build.lib()
    for x, t, r in zip(vols, _launches(types)[2], _launches(R)[2]):
        targs, flags = tiles.tiled(lat, tile_of(rank, data.dtype),
                                   data.device)
        if f64:
            rc = lib.sz_classic_quantize_f64(
                _p(x), _p(t), _p(r), rank, *lat, float(rp), float(recip),
                intervals, radius, float(median), ign, *targs, _stream(x))
        elif dbl:
            rc = lib.sz_classic_quantize_4d(
                _p(x), _p(t), _p(r), *lat, float(rp), float(recip),
                intervals, radius, float(median), ign, *targs, _stream(x))
        else:
            rc = lib.sz_classic_quantize(
                _p(x), _p(t), _p(r), rank, *lat, float(np.float32(rp)),
                float(rp), float(recip), intervals, radius, float(median),
                ign, *targs, _stream(x))
        _build.check(rc, "classic_quantize")
        classic_quantize.launches += 1
    return types, R


def classic_decode(types, known, rp, radius: int):
    """K11 decode: the reconstruction of a rank 2-4 field from its types
    and the escapes' values."""
    kind = _check("classic_decode", known, (types, _I32))
    if kind == "cpu":
        return classic_decode_plain(types, known, rp, radius)
    dbl, f64 = is_dbl(known.dtype, known.dim()), known.dtype == _F64
    out = torch.empty_like(known)
    rank, lat, vols = _launches(known)
    lib = _build.lib()
    for t, x, o in zip(_launches(types)[2], vols, _launches(out)[2]):
        targs, flags = tiles.tiled(lat, tile_of(rank, known.dtype),
                                   known.device)
        if f64:
            rc = lib.sz_classic_decode_f64(_p(t), _p(x), _p(o), rank, *lat,
                                           float(rp), radius, *targs,
                                           _stream(x))
        elif dbl:
            rc = lib.sz_classic_decode_4d(_p(t), _p(x), _p(o), *lat,
                                          float(rp), radius, *targs,
                                          _stream(x))
        else:
            rc = lib.sz_classic_decode(_p(t), _p(x), _p(o), rank, *lat,
                                       float(np.float32(rp)), radius,
                                       *targs, _stream(x))
        _build.check(rc, "classic_decode")
        classic_decode.launches += 1
    return out


classic_quantize.launches = classic_decode.launches = 0
