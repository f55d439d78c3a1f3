"""K8 ``wavefront3d_encode``/``wavefront3d_decode`` and K9
``lines2d_encode``/``lines2d_decode``: the multiplicative recurrence of
the MSST19 PW_REL codec, encode and decode; K8d/K9d, the same names with
``_f64``, their forms for float64 data.

CUDA kernels in ``csrc/msst19.cu``.  K8 replaces T11,
``sz_tpu/tpu/msst19_kernel.py::_make_wf_kernel`` (``encode``/``decode``
-> ``_wf_call``), the 3-D wavefront; K9 replaces T12, ``::_make_wf2_kernel``
(``encode2d``/``decode2d`` -> ``_wf2_call``), the 2-D line kernel.  The
TPU forms computed the f64 chain in software and found the state with a
stairstep search limited to 4096 boundary states; here the chain is
native IEEE f64 and the state one indexed load of the cache table, so
every table runs on the card (the 1e-4 and 1e-5 bounds included).
K8d/K9d replace the JAX engine's XLA scans on float64 data
(``sz_tpu/tpu/msst19_engine.py`` ``_wf3_encode_fn``/``_wf3_decode_fn``,
``_wf2_encode_fn``/``_wf2_decode_fn``): the chain in double throughout,
nothing rounded to float, on double tiles (``TILE3_F64``, ``TILE2_F64``).
Each
call is one persistent launch on the tile machinery of
``csrc/tiles.cuh`` (shared with K1/K2), with a k-halo two deep for the
first row's (k-2) neighbour; the claim order is made here
(:func:`sz_tpu_torch.gpu.tiles.tiled`).  Bound by the dependency chain
across the tiles (at 512^3 by the tiles' busy time over the resident
blocks), not by bytes or arithmetic; ``msst19.cu``'s note has the
detail.

Beside each kernel sits its plain torch version: an anti-diagonal
wavefront on tensors in the form of ``sz_tpu.core.pwr``'s
``_encode_msst19_fast``/``_decode_msst19_fast`` (each diagonal, or each
line of a rank-2 field, one vectorized exact step), with every f64
product and quotient a separate torch op.  The wrappers take it only for
CPU tensors; for CUDA tensors they launch the kernel or raise.

Tables: ``table`` is the cache table flattened, its uint16 states carried
as int16 bit patterns; ``pt`` the float64 precision table; ``base``,
``top`` and ``bits`` the cache table's exponent window and mantissa
bits (``core.pwr.CacheTable``); ``ign`` = max(32 - req_length, 0)
(float64 data: 64 - req_length), the low bits an escape's
reconstruction clears.  The encoders return the int32 types and the
magnitude reconstruction in the data's type; the decoders take
the types and ``known`` (the escapes' signed values in place, anything
elsewhere) and return the reconstruction: escapes signed, the rest
magnitudes.
"""

from __future__ import annotations

import ctypes

import torch

from sz_tpu_torch.gpu import _build, tiles

_F32, _F64, _I32, _I64 = torch.float32, torch.float64, torch.int32, torch.int64


def _mask_i32(ign: int) -> int:
    """~(2^ign - 1) as an int32 bit pattern."""
    m = (~((1 << ign) - 1)) & 0xFFFFFFFF if ign < 32 else 0
    return m - (1 << 32) if m >= 1 << 31 else m


# --- plain versions -------------------------------------------------------

def _diag(d: int, r1: int, r2: int, r3: int, dev):
    """(i, j, k) int64 index vectors of the cells with i + j + k == d."""
    i_lo, i_hi = max(0, d - (r2 - 1) - (r3 - 1)), min(r1 - 1, d)
    i = torch.arange(i_lo, i_hi + 1, dtype=_I64, device=dev)
    e = d - i
    j_lo = (e - (r3 - 1)).clamp(min=0)
    lens = torch.minimum(e, torch.full_like(e, r2 - 1)) - j_lo + 1
    seg = torch.repeat_interleave(torch.arange(len(i), device=dev), lens)
    starts = torch.cumsum(lens, 0) - lens
    j = j_lo[seg] + torch.arange(int(lens.sum()), dtype=_I64,
                                 device=dev) - starts[seg]
    i = i[seg]
    return i, j, d - i - j


def _pred_plain(R, fg, i, j, k, r3: int, r23: int, rank: int):
    """The predictor of the cells of one diagonal from the magnitudes of
    their neighbours in the guard-padded flat lattice R (``fg``: their
    padded indices), in R's dtype.  Every case is computed for every cell
    and the cell's own case is selected; the cases a cell does not use
    may read anything.  The chain is double (rounded once to R's dtype)
    for float 3-D fields and for float64 data of either rank, float for
    float 2-D fields."""
    V = R.dtype
    A, B = R[fg - 1].abs(), R[fg - r3].abs()
    Dg, A2 = R[fg - r3 - 1].abs(), R[fg - 2].abs()
    j0, k0, k1 = j == 0, k == 0, k == 1
    zero = torch.zeros_like(A)
    if rank == 3 or V == _F64:
        a, b, dg, a2 = (t.to(_F64) for t in (A, B, Dg, A2))
        lin = (a * a / a2).to(V)
        p2 = (a * b / dg).to(V)
    else:
        lin = A * A / A2
        p2 = A * B / Dg
    pred0 = torch.where(j0 & k0, zero, torch.where(
        j0 & k1, A, torch.where(j0, lin, torch.where(k0, B, p2))))
    if rank == 2:
        return pred0
    C, E = R[fg - r23].abs(), R[fg - r23 - r3].abs()
    F, G = R[fg - r23 - 1].abs(), R[fg - r23 - r3 - 1].abs()
    c, e, f, g = (t.to(_F64) for t in (C, E, F, G))
    rw = (a * c / f).to(V)
    cl = (b * c / e).to(V)
    p3 = (a * b * c * g / (dg * e * f)).to(V)
    predk = torch.where(j0 & k0, C, torch.where(
        j0, rw, torch.where(k0, cl, p3)))
    return torch.where(i == 0, pred0, predk)


def _lookup_plain(ratio, tab, base: int, top: int, bits: int):
    """CacheTable.lookup on the bits of float64(ratio); 0 outside."""
    b = ratio.to(_F64).view(_I64) & 0x7FFFFFFFFFFFFFFF
    expo = (b >> 52) - base
    ok = (expo >= 0) & (expo <= top - base)
    key = (expo << bits) + ((b & 0x000FFFFFFFFFFFFF) >> (52 - bits))
    return torch.where(ok, tab[torch.where(ok, key, 0)], 0)


def _recon_plain(pred, s, pt):
    """f64(|pred|) * pt[s] in pred's dtype; NaN for a type past the
    table."""
    ok = s < pt.numel()
    ptx = torch.where(ok, pt[torch.where(ok, s, 0)], float("nan"))
    return (pred.abs().to(_F64) * ptx).to(pred.dtype)


def _trunc_plain(cur, ign: int):
    """|cur| with its low ``ign`` bits cleared (an escape's
    reconstruction)."""
    if cur.dtype == _F32:
        return (cur.view(_I32) & _mask_i32(ign)).view(_F32)
    m = (~((1 << ign) - 1)) & (2 ** 64 - 1) if ign < 64 else 0
    return (cur.view(_I64) & (m - 2 ** 64 if m >= 2 ** 63 else m)).view(_F64)


def _vol(t):
    return t if t.dim() == 3 else t.unsqueeze(0)


def _encode_plain(data, table, pt, base, top, bits, ign):
    shape, dev, rank = data.shape, data.device, data.dim()
    r1, r2, r3 = _vol(data).shape
    r23, n = r2 * r3, data.numel()
    guard = r23 + r3 + 2
    cur_all = data.reshape(-1).abs()
    tab = table.reshape(-1).to(_I64) & 0xFFFF
    R = torch.zeros(guard + n, dtype=data.dtype, device=dev)
    types = torch.zeros(n, dtype=_I32, device=dev)
    for d in range(r1 + r2 + r3 - 2):
        i, j, k = _diag(d, r1, r2, r3, dev)
        fi = (i * r2 + j) * r3 + k
        pred = _pred_plain(R, fi + guard, i, j, k, r3, r23, rank)
        cur = cur_all[fi]
        s = _lookup_plain(cur / pred, tab, base, top, bits)
        if d == 0:
            s = torch.zeros_like(s)          # the first point escapes
        R[fi + guard] = torch.where(s != 0, _recon_plain(pred, s, pt),
                                    _trunc_plain(cur, ign))
        types[fi] = s.to(_I32)
    return types.reshape(shape), R[guard:].reshape(shape)


def _decode_plain(types, known, pt):
    shape, dev, rank = types.shape, types.device, types.dim()
    r1, r2, r3 = _vol(types).shape
    r23, n = r2 * r3, types.numel()
    guard = r23 + r3 + 2
    t_all, kv_all = types.reshape(-1).to(_I64), known.reshape(-1)
    out = torch.zeros(guard + n, dtype=known.dtype, device=dev)
    for d in range(r1 + r2 + r3 - 2):
        i, j, k = _diag(d, r1, r2, r3, dev)
        fi = (i * r2 + j) * r3 + k
        pred = _pred_plain(out, fi + guard, i, j, k, r3, r23, rank)
        s = t_all[fi]
        out[fi + guard] = torch.where(s != 0, _recon_plain(pred, s, pt),
                                      kv_all[fi])
    return out[guard:].reshape(shape)


# one plain version each way for K8, K9 and their float64 forms: the
# rank and the dtype come from the tensors
wavefront3d_encode_plain = lines2d_encode_plain = _encode_plain
wavefront3d_decode_plain = lines2d_decode_plain = _decode_plain



# --- wrappers -------------------------------------------------------------

# the tiles (bi, bj, bk) of K8 (any r1) and K9 (r1 = 1), as msst19.cu
# compiles them (Msst19Tile<3, V>, Msst19Tile<2, V>): one thread a k-row, k
# the contiguous axis; K1/K2's shapes (lorenzo_kernel.TILE3 / TILE2).  The
# float64 forms K8d / K9d hold doubles: the 2-D tile is shorter on k to
# fit a block's shared memory
TILE3 = (8, 16, 32)
TILE2 = (1, 64, 96)
TILE3_F64 = (8, 16, 32)
TILE2_F64 = (1, 64, 64)


def _check(name: str, rank: int, lattice, *more):
    """Validate ((tensor, dtype), ...) of one lattice shape and the
    tables; returns the device type ('cpu' or 'cuda')."""
    shape = lattice[0][0].shape
    if len(shape) != rank:
        raise ValueError(f"{name}: a rank-{rank} lattice is required")
    for t, dt in lattice:
        if t.shape != shape or t.dtype != dt:
            raise ValueError(f"{name}: inputs of shape {tuple(shape)} and "
                             f"dtypes {[str(d) for _, d in lattice]}")
    for t, dt in more:
        if t.dim() != 1 or t.dtype != dt or t.numel() == 0:
            raise ValueError(f"{name}: tables must be non-empty 1-D "
                             f"{dt} tensors")
    tensors = [t for t, _ in lattice + list(more)]
    dev = tensors[0].device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {dev}")
    if any(t.device != dev for t in tensors):
        raise ValueError(f"{name}: tensors on one device")
    if dev.type == "cuda" and not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name}: contiguous tensors required")
    return dev.type


def _check_window(name, table, base, top, bits):
    if not 0 <= bits <= 52 or top < base or \
            table.numel() != (top - base + 1) << bits:
        raise ValueError(f"{name}: the cache table must hold "
                         f"(top - base + 1) << bits states")


def _p(t):
    return ctypes.c_void_p(t.data_ptr())


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def _encode(wrapper, rank: int, V, tile, plain, data, table, pt, base: int,
            top: int, bits: int, ign: int):
    """An encode wrapper's body: check, then the plain version on the
    CPU or one launch of the kernel behind ``sz_<wrapper name>``."""
    name = wrapper.__name__
    kind = _check(name, rank, [(data, V)], (table, torch.int16), (pt, _F64))
    _check_window(name, table, base, top, bits)
    if kind == "cpu":
        return plain(data, table, pt, base, top, bits, ign)
    types = torch.empty(data.shape, dtype=_I32, device=data.device)
    R = torch.empty(data.shape, dtype=V, device=data.device)
    shape3 = data.shape if rank == 3 else (1, *data.shape)
    targs, flags = tiles.tiled(shape3, tile, data.device)
    rc = getattr(_build.lib(), "sz_msst19_" + name)(
        _p(data), _p(table), _p(pt), pt.numel(), base, top, bits, ign,
        _p(types), _p(R), *data.shape, *targs, _stream(data))
    _build.check(rc, name)
    _build.launched(wrapper)
    return types, R


def _decode(wrapper, rank: int, V, tile, plain, types, known, pt):
    """A decode wrapper's body, as :func:`_encode`."""
    name = wrapper.__name__
    kind = _check(name, rank, [(types, _I32), (known, V)], (pt, _F64))
    if kind == "cpu":
        return plain(types, known, pt)
    out = torch.empty(types.shape, dtype=V, device=types.device)
    shape3 = types.shape if rank == 3 else (1, *types.shape)
    targs, flags = tiles.tiled(shape3, tile, types.device)
    rc = getattr(_build.lib(), "sz_msst19_" + name)(
        _p(types), _p(known), _p(pt), pt.numel(), _p(out), *types.shape,
        *targs, _stream(types))
    _build.check(rc, name)
    _build.launched(wrapper)
    return out


def wavefront3d_encode(data, table, pt, base: int, top: int, bits: int,
                       ign: int):
    """K8 encode: states of a rank-3 float32 field (int32) and its
    magnitude reconstruction (float32)."""
    return _encode(wavefront3d_encode, 3, _F32, TILE3,
                   wavefront3d_encode_plain, data, table, pt, base, top,
                   bits, ign)


def wavefront3d_decode(types, known, pt):
    """K8 decode: the rank-3 reconstruction from the types and the
    escapes' values."""
    return _decode(wavefront3d_decode, 3, _F32, TILE3,
                   wavefront3d_decode_plain, types, known, pt)


def lines2d_encode(data, table, pt, base: int, top: int, bits: int,
                   ign: int):
    """K9 encode: states of a rank-2 float32 field (int32) and its
    magnitude reconstruction (float32)."""
    return _encode(lines2d_encode, 2, _F32, TILE2, lines2d_encode_plain,
                   data, table, pt, base, top, bits, ign)


def lines2d_decode(types, known, pt):
    """K9 decode: the rank-2 reconstruction from the types and the
    escapes' values."""
    return _decode(lines2d_decode, 2, _F32, TILE2, lines2d_decode_plain,
                   types, known, pt)


def wavefront3d_encode_f64(data, table, pt, base: int, top: int, bits: int,
                           ign: int):
    """K8d encode: states of a rank-3 float64 field and its magnitude
    reconstruction (float64); ``ign`` = max(64 - req_length, 0)."""
    return _encode(wavefront3d_encode_f64, 3, _F64, TILE3_F64,
                   wavefront3d_encode_plain, data, table, pt, base, top,
                   bits, ign)


def wavefront3d_decode_f64(types, known, pt):
    """K8d decode: the rank-3 float64 reconstruction."""
    return _decode(wavefront3d_decode_f64, 3, _F64, TILE3_F64,
                   wavefront3d_decode_plain, types, known, pt)


def lines2d_encode_f64(data, table, pt, base: int, top: int, bits: int,
                       ign: int):
    """K9d encode: states of a rank-2 float64 field and its magnitude
    reconstruction (float64)."""
    return _encode(lines2d_encode_f64, 2, _F64, TILE2_F64,
                   lines2d_encode_plain, data, table, pt, base, top,
                   bits, ign)


def lines2d_decode_f64(types, known, pt):
    """K9d decode: the rank-2 float64 reconstruction."""
    return _decode(lines2d_decode_f64, 2, _F64, TILE2_F64,
                   lines2d_decode_plain, types, known, pt)


wavefront3d_encode.launches = wavefront3d_decode.launches = 0
lines2d_encode.launches = lines2d_decode.launches = 0
wavefront3d_encode_f64.launches = wavefront3d_decode_f64.launches = 0
lines2d_encode_f64.launches = lines2d_decode_f64.launches = 0
