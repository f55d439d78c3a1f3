"""K10 ``classic_quantize`` and K11 ``classic_decode``: the positional
Lorenzo recurrence of the classic SZ1.4 codec on 2-D, 3-D and 4-D
fields, encode and decode, float32 and float64.

CUDA kernels in ``csrc/classic.cu`` on the strip machinery of
``csrc/strips.cuh`` (shared with K1d/K2d).  They replace no Pallas kernel:
the JAX package solves this recurrence in XLA, a plane scan with a
per-plane fixpoint and a serial scan pinning the first row
(``sz_tpu/tpu/classic_engine.py::_encode_fn`` and ``::_decode_fn``).
Here each call is one launch that computes each point once, in
dependency order: a warp walks a strip of 32 rows of one plane, a lane
a row, skewed by its lane, its neighbours in registers and shuffles; a
block's warps walk consecutive planes (rank 3) or strips (rank 2) and
hand their rows on through shared-memory rings, blocks through device
scratch, chunk by chunk, in the claim order
:func:`sz_tpu_torch.gpu.strips.strip_order` makes (a 4-D field's volumes
side by side in that one order).
``classic.cu``'s note has the rules, the three numeric forms
(``core.classic_nd.Form``) and the bound, and K10's fourth, the subblock
form of ``compress_region`` (:func:`classic_quantize_sub`: double, a
division by rp, no epsilon recheck).

Beside each kernel sits its plain torch version: an anti-diagonal
wavefront over s = i + j + k, each diagonal one vectorized exact step,
with every operation of the point rule a separate torch op in the
kernel's order.  The wrappers take it only for CPU tensors; for CUDA
tensors they launch the kernel or raise.

Arguments: ``rp`` and ``recip`` are the precision and its reciprocal in
the form's RT (float32 for float32 data of rank 2-3, else float64);
``median`` and ``req_length`` give an escape's reconstruction (the value
less the median, its low width - req_length bits cleared, plus the
median).  The encoder returns the int32 types (0 an escape) and, when
``want_R``, the reconstruction; the decoder takes the types and the
escapes' values in raster order (``_decode_fn``'s ``unpred_pad``) and
returns the reconstruction.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from sz_tpu_torch.gpu import _build
from sz_tpu_torch.gpu import strips
from sz_tpu_torch.gpu.msst19_kernel import _diag
from sz_tpu_torch.gpu.strips import LANES, lattice

_F32, _F64, _I32, _I64 = torch.float32, torch.float64, torch.int32, torch.int64

# classic.cu's slots of a ring row and warps a block by element type (the
# other strip constants are strips.cuh's, in gpu/strips.py)
RING = 64
WARPS = {_F32: 6, _F64: 4}


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
                    dbl: bool, sub: bool = False):
    """(types, reconstructions) of one diagonal's cells; type 0 where the
    cell escapes.  ``sub``: the subblock form (dbl, |diff| / rp, no
    recheck)."""
    diff = cur - pred
    if sub:
        m = diff.abs().to(_F64) / float(rp) + 1.0
    else:
        m = diff.abs().to(_F64) * float(recip) + 1.0
    itv = m if dbl else m.to(_F32)
    within = itv < intervals
    itv = torch.where(within, torch.where(diff < 0, -itv, itv),
                      torch.zeros_like(itv))
    t = torch.trunc(itv / 2).to(_I64) + radius
    rec = _recon_plain(pred, t, radius, rp, dbl)
    if sub:
        return torch.where(within, t, 0), rec
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
                           median, req_length: int, want_R: bool = True,
                           sub: bool = False):
    dbl = sub or is_dbl(data.dtype, data.dim())
    mask = _mask(req_length, data.dtype)
    types = torch.empty(data.shape, dtype=_I32, device=data.device)
    R = torch.empty_like(data)
    for v, vol in enumerate(_volumes(data)):
        flat = vol.reshape(-1)

        def step(fi, pred):
            cur = flat[fi]
            t, rec = _quantize_plain(cur, pred, rp, recip, intervals,
                                     radius, dbl, sub)
            t = torch.where(fi == 0, 0, t)     # the first point escapes
            return t, torch.where(t != 0, rec,
                                  _escape_plain(cur, median, mask))

        tv, rv = _volume_plain(vol, step)
        _volumes(types)[v] = tv
        _volumes(R)[v] = rv
    return types, (R if want_R else None)


def _known_plain(types, escapes):
    """The escapes' values in place, 0 elsewhere: each type 0 takes the
    escape of its raster rank (``_decode_fn``'s cumsum)."""
    t = types.reshape(-1)
    is_esc = t == 0
    if escapes.numel() == 0:
        return torch.zeros(types.shape, dtype=escapes.dtype,
                           device=types.device)
    rank = (torch.cumsum(is_esc.to(_I64), 0) - 1).clamp(
        0, escapes.numel() - 1)
    known = torch.where(is_esc, escapes[rank], torch.zeros(
        (), dtype=escapes.dtype, device=types.device))
    return known.reshape(types.shape)


def classic_decode_plain(types, escapes, rp, radius: int):
    known = _known_plain(types, escapes)
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


# --- the strips: units, claim order, scratch ------------------------------

def shared_bytes(dtype, decode: bool) -> int:
    """Dynamic shared memory of a block (strips.cuh ``shared_bytes`` of
    classic.cu's rule): the value rings of the data's type, one staging
    array (K10: the data's type, K11: int32 types)."""
    item = 8 if dtype == _F64 else 4
    return strips.shared_bytes(WARPS[dtype], item,
                               LANES * (RING + 1) * (4 if decode else item),
                               RING)


def _strips(lat: tuple, dtype, device) -> tuple:
    """A launch's strip arguments (:func:`strips.strip_args`) for blocks
    of WARPS[dtype] warps."""
    return strips.strip_args(lat, WARPS[dtype], dtype, device)


def escape_row_base(types):
    """(row_base, n_esc) of a type field: the escapes (type 0) before
    each row of its last axis in raster order (int64, an exclusive scan
    of the rows' counts), and their count, a 0-d tensor."""
    rows = (types.reshape(-1, types.shape[-1]) == 0).sum(1)
    incl = torch.cumsum(rows, 0)
    return incl - rows, incl[-1]


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
    return _device(name, data, *(t for t, _ in others))


def _device(name: str, *tensors):
    """The tensors' one device type ('cpu' or 'cuda'); CUDA tensors must
    be contiguous."""
    dev = tensors[0].device
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


def _quantize(wrapper, data, rp, recip, intervals: int, radius: int,
              median, req_length: int, want_R: bool, sub: bool):
    """K10 in one of its forms (``sub``: the subblock form); counts the
    launch on ``wrapper``."""
    name = wrapper.__name__
    kind = _check(name, data)
    if kind == "cpu":
        return classic_quantize_plain(data, rp, recip, intervals, radius,
                                      median, req_length, want_R, sub)
    dbl, f64 = is_dbl(data.dtype, data.dim()), data.dtype == _F64
    width = 64 if f64 else 32
    ign = max(width - int(req_length), 0)
    types = torch.empty(data.shape, dtype=_I32, device=data.device)
    R = torch.empty_like(data) if want_R else None
    if data.numel() == 0:
        return types, R
    lat = lattice(data.shape)
    rank, nvol, r1, r2, r3 = lat
    sargs, keep = _strips(lat, data.dtype, data.device)
    r_ptr = _p(R) if want_R else None
    lib = _build.lib()
    if sub:
        entry = (lib.sz_classic_quantize_sub_f64 if f64
                 else lib.sz_classic_quantize_sub)
        rc = entry(_p(data), _p(types), r_ptr, *lat, float(rp), intervals,
                   radius, float(median), ign, *sargs, _stream(data))
    elif f64:
        rc = lib.sz_classic_quantize_f64(
            _p(data), _p(types), r_ptr, *lat, float(rp), float(recip),
            intervals, radius, float(median), ign, *sargs, _stream(data))
    elif dbl:
        rc = lib.sz_classic_quantize_4d(
            _p(data), _p(types), r_ptr, nvol, r1, r2, r3, float(rp),
            float(recip), intervals, radius, float(median), ign, *sargs,
            _stream(data))
    else:
        rc = lib.sz_classic_quantize(
            _p(data), _p(types), r_ptr, *lat, float(np.float32(rp)),
            float(rp), float(recip), intervals, radius, float(median), ign,
            *sargs, _stream(data))
    _build.check(rc, name)
    _build.launched(wrapper)
    del keep
    return types, R


def classic_quantize(data, rp, recip, intervals: int, radius: int, median,
                     req_length: int, want_R: bool = True):
    """K10 encode: the int32 types of a float32 or float64 field of rank
    2-4 and, when ``want_R``, its reconstruction (else None)."""
    return _quantize(classic_quantize, data, rp, recip, intervals, radius,
                     median, req_length, want_R, False)


def classic_quantize_sub(data, rp, intervals: int, radius: int, median,
                         req_length: int, want_R: bool = True):
    """K10's subblock form (``compress_region``): as
    :func:`classic_quantize`, quantizing in double on ``rp`` (the double
    precision), dividing, with no epsilon recheck, in every dtype and
    rank (``classic_quantize2d_sub_kernel`` and its siblings)."""
    return _quantize(classic_quantize_sub, data, rp, None, intervals,
                     radius, median, req_length, want_R, True)


def classic_decode(types, escapes, rp, radius: int, row_base=None):
    """K11 decode: the reconstruction of a rank 2-4 field from its int32
    types and the escapes' values in raster order (1-D, the field's
    dtype).  ``row_base``: :func:`escape_row_base`'s first result, where
    the caller has it (else computed here)."""
    name = "classic_decode"
    if types.dim() not in (2, 3, 4) or types.dtype != _I32:
        raise ValueError(f"{name}: int32 types of rank 2, 3 or 4 required")
    if escapes.dim() != 1 or escapes.dtype not in (_F32, _F64):
        raise ValueError(f"{name}: escapes of shape (n,), float32 or "
                         f"float64, required; got {tuple(escapes.shape)}")
    kind = _device(name, types, escapes)
    if kind == "cpu":
        return classic_decode_plain(types, escapes, rp, radius)
    dbl, f64 = is_dbl(escapes.dtype, types.dim()), escapes.dtype == _F64
    out = torch.empty(types.shape, dtype=escapes.dtype, device=types.device)
    if types.numel() == 0:
        return out
    if row_base is None:
        row_base = escape_row_base(types)[0]
    if (row_base.dtype != _I64 or row_base.device != types.device
            or row_base.numel() != types.numel() // types.shape[-1]):
        raise ValueError(f"{name}: row_base must be escape_row_base(types)")
    lat = lattice(types.shape)
    rank, nvol, r1, r2, r3 = lat
    sargs, keep = _strips(lat, escapes.dtype, types.device)
    lib = _build.lib()
    head = (_p(types), _p(escapes), int(escapes.numel()), _p(row_base),
            _p(out))
    if f64:
        rc = lib.sz_classic_decode_f64(*head, *lat, float(rp), radius,
                                       *sargs, _stream(out))
    elif dbl:
        rc = lib.sz_classic_decode_4d(*head, nvol, r1, r2, r3, float(rp),
                                      radius, *sargs, _stream(out))
    else:
        rc = lib.sz_classic_decode(*head, *lat, float(np.float32(rp)),
                                   radius, *sargs, _stream(out))
    _build.check(rc, "classic_decode")
    _build.launched(classic_decode)
    del keep
    return out


classic_quantize.launches = classic_decode.launches = 0
classic_quantize_sub.launches = 0
