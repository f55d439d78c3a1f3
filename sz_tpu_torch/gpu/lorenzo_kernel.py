"""K1 ``wavefront_quantize`` and K2 ``wavefront_decode``: the Lorenzo
recurrence of the SZ2.1 regression codec, encode and decode, on float32
lattices; K1d ``wavefront_quantize_f64`` and K2d ``wavefront_decode_f64``
on float64 ones (the ports of the XLA fixpoints that run float64 in
``sz_tpu/tpu/engine.py::_quantize_fn`` and ``::_decode_fn``).  K1 and K2
pick their form by the data's dtype.

CUDA kernels in ``csrc/lorenzo.cu``, one launch per call that computes
each point once in dependency order (K1/K2 replace
``sz_tpu/tpu/pallas_kernels.py::plane_quantize`` and ``::strip_quantize``,
``sz_tpu/tpu/wf_quantize.py::wavefront_quantize`` and
``::wavefront_decode``, and the XLA plane scan of
``sz_tpu/tpu/engine.py::_decode_fn``).  K1/K2 run tile by tile on the
tile machinery of ``csrc/tiles.cuh`` shared with K8/K9; K1d/K2d run as
warp strips on the machinery of ``csrc/strips.cuh`` shared with K10/K11
(a lane a row, neighbours in registers and shuffles).  Bound on the H100
by the dependency chain, not by bytes; the source notes in ``tiles.cuh``,
``strips.cuh`` and ``lorenzo.cu`` have the detail.  The claim orders are
made in Python (:func:`sz_tpu_torch.gpu.tiles.tile_order`,
:func:`sz_tpu_torch.gpu.strips.strip_order`), so the CPU tests reach the
geometry the kernels use.

Beside each kernel sits its plain torch version, in the data's dtype:
the per-plane fixpoint of ``engine.py:957-1003`` (encode) and the plane
scan of ``engine.py:1646-1680`` (decode).  The wrappers take the plain
version only for CPU tensors; for CUDA tensors they launch the kernel or
raise.
Rank-2 lattices run as one plane (r1 = 1; K1d/K2d in their rank-2
strip form), which is exact: the extra zero-valued neighbour terms change
no value.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from sz_tpu_torch.config import float_type
from sz_tpu_torch.gpu import _build, strips, tiles
from sz_tpu_torch.gpu.stages import quant, scalar

F32 = torch.float32
F64 = torch.float64


def _as3d(x: torch.Tensor) -> torch.Tensor:
    return x if x.dim() == 3 else x.unsqueeze(0)


def _pred_plane(P, Qp):
    """Plane Lorenzo stencil, op order of engine.py:962-971.  P: current
    plane; Qp: previous plane zero-padded on top/left."""
    Pp = F.pad(P, (1, 0, 1, 0))
    p = Pp[1:, :-1] + Pp[:-1, 1:]   # (x,y,z-1)+(x,y-1,z)
    p = p + Qp[1:, 1:]              # (x-1,y,z)
    p = p - Pp[:-1, :-1]            # (x,y-1,z-1)
    p = p - Qp[1:, :-1]             # (x-1,y,z-1)
    p = p - Qp[:-1, 1:]             # (x-1,y-1,z)
    p = p + Qp[:-1, :-1]            # (x-1,y-1,z-1)
    return p


def quantize_plain(data, t_reg, rec_reg, reg_pts, mean_mask, rp, recip,
                   cap_szf, radius: int, mean, *, use_mean: bool):
    """Plain torch K1 (and K1d): per-plane fixpoint iteration to the
    bit-exact serial result (engine.py:957-1003), in data's dtype.
    Returns (t int32, R)."""
    shape = tuple(data.shape)
    data, t_reg, rec_reg, reg_pts = (_as3d(a) for a in
                                     (data, t_reg, rec_reg, reg_pts))
    if use_mean:
        mean_mask = _as3d(mean_mask)
    dev, dt = data.device, data.dtype
    rp_t, recip_t, cap_t, mean_t = (scalar(v, dev, dt)
                                    for v in (rp, recip, cap_szf, mean))
    r1, r2, r3 = data.shape
    t_out = torch.empty(data.shape, dtype=torch.int32, device=dev)
    R_out = torch.empty(data.shape, dtype=dt, device=dev)
    prev = torch.zeros((r2, r3), dtype=dt, device=dev)
    for x in range(r1):
        d, regp = data[x], reg_pts[x]
        Qp = F.pad(prev, (1, 0, 1, 0))

        def pstep(P):
            t_l, rec_l = quant(d, _pred_plane(P, Qp), rp_t, recip_t, cap_t,
                               radius)
            if use_mean:
                meanp = mean_mask[x]
                t_l = torch.where((t_l != 0) & (t_l <= radius), t_l - 1, t_l)
                t_l = torch.where(meanp, radius, t_l)
                rec_l = torch.where(meanp, mean_t, rec_l)
            return (torch.where(regp, t_reg[x], t_l),
                    torch.where(regp, rec_reg[x], rec_l))

        P = d
        for _ in range(r2 + r3 + 4):
            P_new = pstep(P)[1]
            done = torch.equal(P_new, P)
            P = P_new
            if done:
                break
        tp, P = pstep(P)
        t_out[x] = tp
        R_out[x] = P
        prev = P
    return t_out.reshape(shape), R_out.reshape(shape)


def decode_plain(known_mask, known, q_lor):
    """Plain torch K2 (and K2d): per-plane fixpoint reconstruction
    R = known_mask ? known : pred(R) + q_lor (engine.py:1646-1680), in
    known's dtype."""
    shape = tuple(known.shape)
    known_mask, known, q_lor = (_as3d(a) for a in (known_mask, known, q_lor))
    r1, r2, r3 = known.shape
    dev = known.device
    R = torch.empty(known.shape, dtype=known.dtype, device=dev)
    prev = torch.zeros((r2, r3), dtype=known.dtype, device=dev)
    for x in range(r1):
        km, kv, qx = known_mask[x], known[x], q_lor[x]
        Qp = F.pad(prev, (1, 0, 1, 0))
        P = torch.where(km, kv, torch.zeros_like(kv))
        for _ in range(r2 + r3 + 4):
            P_new = torch.where(km, kv, _pred_plane(P, Qp) + qx)
            done = torch.equal(P_new, P)
            P = P_new
            if done:
                break
        R[x] = P
        prev = P
    return R.reshape(shape)


# the tile (bi, bj, bk) of a float32 lattice with r1 > 1 and of one with
# r1 = 1, as lorenzo.cu compiles them (LorenzoTile<3>, LorenzoTile<2>):
# one thread a k-row (bi * bj threads a block, a multiple of 32), k the
# contiguous axis; picked by a sweep on the H100 (PERF.md)
TILE3 = (8, 16, 32)
TILE2 = (1, 64, 96)

# K1d's and K2d's strips (lorenzo.cu LorenzoStrip) by (kind, rank): slots
# of a ring row, warps a block, and a warp's staging region (kStageBytes:
# X, for K1d its int32 T, and per flag array 3 slot chunks x LANES rows x
# 24 bytes)
RING_F64 = {3: 32, 2: 64}
WARPS_F64 = {("quantize", 3): 8, ("decode", 3): 10, ("quantize", 2): 4,
             ("decode", 2): 4}
_ITEM_FLAGS = {"quantize": (12, 2), "decode": (8, 1)}
STAGE_BYTES_F64 = {
    (kind, rank): (strips.LANES * (RING_F64[rank] + 1) * _ITEM_FLAGS[kind][0]
                   + _ITEM_FLAGS[kind][1] * 3 * strips.LANES * 24)
    for kind, rank in WARPS_F64}


def tile_of(shape3):
    """The tile K1/K2 use for a rank-3 lattice shape."""
    return TILE3 if shape3[0] > 1 else TILE2


def strip_lattice(shape) -> tuple:
    """(rank, nvol, r1, r2, r3) of K1d's or K2d's one launch on a lattice
    of ``shape``: a rank-2 lattice is one plane in the rank-2 form, a
    rank-3 one one volume."""
    shape = tuple(int(s) for s in shape)
    return (2, 1, 1) + shape if len(shape) == 2 else (3, 1) + shape


def shared_bytes_f64(kind: str, rank: int) -> int:
    """A K1d (``kind`` "quantize") or K2d ("decode") block's dynamic
    shared memory on a rank-``rank`` lattice (strips.cuh
    ``shared_bytes``)."""
    return strips.shared_bytes(WARPS_F64[kind, rank], 8,
                               STAGE_BYTES_F64[kind, rank], RING_F64[rank])


def _ptr(t):
    return ctypes.c_void_p(t.data_ptr()) if t is not None else None


def _aligned8(t):
    """``t``, or a copy of it where its data is not 8-byte aligned: K1d/K2d
    stage the flag bytes as aligned 8-byte blocks."""
    return t if t is None or t.data_ptr() % 8 == 0 else t.clone()


def _check_shapes(name, *tensors):
    shape = tensors[0].shape
    if len(shape) not in (2, 3):
        raise ValueError(f"{name}: rank-2 or rank-3 lattices only")
    if any(t.shape != shape for t in tensors):
        raise ValueError(f"{name}: all inputs must have shape {tuple(shape)}")


def _check_cuda(name, *tensors):
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev or not t.is_contiguous():
            raise ValueError(f"{name}: inputs must be contiguous tensors on "
                             f"one device")


def wavefront_quantize(data, t_reg, rec_reg, reg_pts, mean_mask, rp, recip,
                       cap_szf, radius: int, mean, *, use_mean: bool,
                       want_R: bool = False):
    """K1: Lorenzo predict+quantize of a rank-3 (or rank-2) float32
    lattice, merging precomputed regression points (t_reg/rec_reg where
    reg_pts) and the use_mean flush (mean_mask); a float64 lattice goes to
    K1d (:func:`wavefront_quantize_f64`).  Returns the int32 type lattice,
    and the reconstruction R when want_R."""
    if data.dtype == F64:
        return wavefront_quantize_f64(
            data, t_reg, rec_reg, reg_pts, mean_mask, rp, recip, cap_szf,
            radius, mean, use_mean=use_mean, want_R=want_R)
    return _quantize(wavefront_quantize, "sz_wavefront_quantize", F32, data,
                     t_reg, rec_reg, reg_pts, mean_mask, rp, recip, cap_szf,
                     radius, mean, use_mean, want_R)


def wavefront_quantize_f64(data, t_reg, rec_reg, reg_pts, mean_mask, rp,
                           recip, cap_szf, radius: int, mean, *,
                           use_mean: bool, want_R: bool = False):
    """K1d: :func:`wavefront_quantize` on a float64 lattice, the rule in
    double (``regnd._np_quant`` with T = float64), as warp strips; R is
    written only when ``want_R``."""
    return _quantize(wavefront_quantize_f64, "sz_wavefront_quantize_f64",
                     F64, data, t_reg, rec_reg, reg_pts, mean_mask, rp, recip,
                     cap_szf, radius, mean, use_mean, want_R)


def _quantize(wrapper, entry, dt, data, t_reg, rec_reg, reg_pts, mean_mask,
              rp, recip, cap_szf, radius, mean, use_mean, want_R):
    """K1 or K1d (``entry``, element type ``dt``: K1 tiled and writing R
    always, K1d on the strips and writing R only when asked for); counts a
    launch on ``wrapper``."""
    name = wrapper.__name__
    ins = [data, t_reg, rec_reg, reg_pts] + ([mean_mask] if use_mean else [])
    _check_shapes(name, *ins)
    if data.device.type == "cpu":
        t, R = quantize_plain(data, t_reg, rec_reg, reg_pts, mean_mask, rp,
                              recip, cap_szf, radius, mean,
                              use_mean=use_mean)
        return (t, R) if want_R else t
    if data.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {data.device}")
    _check_cuda(name, *ins)
    if (data.dtype != dt or rec_reg.dtype != dt
            or t_reg.dtype != torch.int32 or reg_pts.dtype != torch.bool
            or (use_mean and mean_mask.dtype != torch.bool)):
        raise TypeError(f"{name}: dtypes {dt}/i32/{dt}/bool/bool")
    T = float_type(dt)
    t = torch.empty(data.shape, dtype=torch.int32, device=data.device)
    if dt == F64:
        reg_pts = _aligned8(reg_pts)
        mean_mask = _aligned8(mean_mask if use_mean else None)
    head = (_ptr(data), _ptr(t_reg), _ptr(rec_reg), _ptr(reg_pts),
            _ptr(mean_mask if use_mean else None), _ptr(t))
    scal = (float(T(rp)), float(T(recip)), float(T(cap_szf)), float(T(mean)),
            int(radius), int(bool(use_mean)))
    stream = torch.cuda.current_stream(data.device).cuda_stream
    if dt == F64:
        R = (torch.empty(data.shape, dtype=dt, device=data.device)
             if want_R else None)
        lat = strip_lattice(data.shape)
        sargs, keep = strips.strip_args(lat, WARPS_F64["quantize", lat[0]],
                                        dt, data.device)
        rc = getattr(_build.lib(), entry)(
            *head, _ptr(R), lat[0], *lat[2:], *scal, *sargs, stream)
        del keep
    else:
        shape3 = tuple(_as3d(data).shape)
        R = torch.empty(data.shape, dtype=dt, device=data.device)
        targs, flags = tiles.tiled(shape3, tile_of(shape3), data.device)
        rc = getattr(_build.lib(), entry)(*head, _ptr(R), *shape3, *scal,
                                          *targs, stream)
    _build.check(rc, name)
    _build.launched(wrapper)
    return (t, R) if want_R else t


wavefront_quantize.launches = 0
wavefront_quantize_f64.launches = 0


def wavefront_decode(known_mask, known, q_lor):
    """K2: reconstruction R = known_mask ? known : pred7(R) + q_lor in
    dependency order, for a rank-3 (or rank-2) float32 lattice; a float64
    lattice goes to K2d (:func:`wavefront_decode_f64`)."""
    if known.dtype == F64:
        return wavefront_decode_f64(known_mask, known, q_lor)
    return _decode(wavefront_decode, "sz_wavefront_decode", F32, known_mask,
                   known, q_lor)


def wavefront_decode_f64(known_mask, known, q_lor):
    """K2d: :func:`wavefront_decode` on a float64 lattice, as warp
    strips."""
    return _decode(wavefront_decode_f64, "sz_wavefront_decode_f64", F64,
                   known_mask, known, q_lor)


def _decode(wrapper, entry, dt, known_mask, known, q_lor):
    """K2 or K2d (``entry``, element type ``dt``); counts a launch on
    ``wrapper``."""
    name = wrapper.__name__
    _check_shapes(name, known, known_mask, q_lor)
    if known.device.type == "cpu":
        return decode_plain(known_mask, known, q_lor)
    if known.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {known.device}")
    _check_cuda(name, known_mask, known, q_lor)
    if (known_mask.dtype != torch.bool or known.dtype != dt
            or q_lor.dtype != dt):
        raise TypeError(f"{name}: dtypes bool/{dt}/{dt}")
    R = torch.empty(known.shape, dtype=dt, device=known.device)
    if dt == F64:
        known_mask = _aligned8(known_mask)
    head = (_ptr(known_mask), _ptr(known), _ptr(q_lor), _ptr(R))
    stream = torch.cuda.current_stream(known.device).cuda_stream
    if dt == F64:
        lat = strip_lattice(known.shape)
        sargs, keep = strips.strip_args(lat, WARPS_F64["decode", lat[0]],
                                        dt, known.device)
        rc = getattr(_build.lib(), entry)(*head, lat[0], *lat[2:], *sargs,
                                          stream)
        del keep
    else:
        shape3 = tuple(_as3d(known).shape)
        targs, flags = tiles.tiled(shape3, tile_of(shape3), known.device)
        rc = getattr(_build.lib(), entry)(*head, *shape3, *targs, stream)
    _build.check(rc, name)
    _build.launched(wrapper)
    return R


wavefront_decode.launches = 0
wavefront_decode_f64.launches = 0
