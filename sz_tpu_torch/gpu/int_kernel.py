"""K16 ``int_quantize`` and K17 ``int_decode``: the positional Lorenzo
recurrence of the integer codecs (int8 to uint64) on 2-D, 3-D and 4-D
fields, encode and decode; and the interval optimizer's samples
(:func:`optimizer_samples_int`).

CUDA kernels in ``csrc/intc.cu``, a point rule on the strip machinery of
``csrc/strips.cuh`` (shared with K10/K11 and K1d/K2d).  They replace no
Pallas kernel: the JAX package runs this recurrence in host C over
OpenMP blocks (``sz_tpu/native/core.c`` ``intnd_encode2`` /
``intnd_encode_wf`` and ``intnd_decode`` / ``intnd_decode_wf``), the
reference's SZ_compress_intXX_{2,3,4}D_MDQ (e.g. sz_int32.c) and their
decoders.  Each call is one launch in the claim order of
:func:`sz_tpu_torch.gpu.strips.strip_order` (a 4-D field's volumes side
by side in that one order).  ``intc.cu``'s note has the rule and the
bound.

The arithmetic is the reference's: the encoder predicts in int64 and
wraps the prediction to AN bits (int32 for int32 data, int64 for the
rest) and the difference to DN bits (a C int for the 8-, 16- and 32-bit
types, int64 for uint32, int64 and uint64); the quantizer is IEEE double
(``|diff| / rp + 1``, ``pred + 2 (t - radius) rp``) and C's conversions
of a double to an integer truncate, giving x86's "integer indefinite"
(the type's minimum) out of range; the decoder predicts in int64 and
wraps each value to the output type.  The 4-D encoder codes cell
(l, 0, 0, 1) of every volume with the volume's element 0 as its value
and, where it escapes, stores the field's first element
(``sz_tpu/core/intc.py:_quant_quirk_4d``).

The kernels run each launch in one of the forms that ``intc.cu``'s note
proves bit-equal to that arithmetic, picked here from the dtype, rp (or
interval2), the intervals and the data's range (:func:`quantize_form`,
:func:`decode_form`): a 32-bit ring where the values fit it, and K16's
integer form (a multiply-high for the divide), its reciprocal form (a
multiply, the divide only on lanes near a boundary) or the exact double
chain; K17's integer form or its double chain.  The plain versions keep
the reference's double arithmetic for every form.

Unsigned types of 16 bits and more travel as the signed type of their
width (their bits unchanged, :func:`carrier`); ``dtype`` (a numpy dtype)
says what the bits mean.  Beside each kernel sits its plain torch
version: an anti-diagonal wavefront over s = i + j + k in int64, each
diagonal one vectorized step with explicit wraps.  The wrappers take it
only for CPU tensors; for CUDA tensors they launch the kernel or raise.
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import numpy as np
import torch

from sz_tpu_torch.core import intc
from sz_tpu_torch.gpu import _build
from sz_tpu_torch.gpu import strips
from sz_tpu_torch.gpu.classic_kernel import (_known_plain, _volume_plain,
                                             _volumes, escape_row_base)
from sz_tpu_torch.gpu.strips import LANES, lattice

_I32, _I64 = torch.int32, torch.int64

# intc.cu's slots of a ring row by rank and warps a block (the other
# strip constants are strips.cuh's, in gpu/strips.py)
RING = {2: 64, 3: 32}
WARPS = 4

# K16's ring forms (sz_int_quantize's form, in its order): (ring value,
# staged slot) bytes.  K17's ring holds the output type: int32 for 8-,
# 16- and 32-bit outputs, int64 for 64-bit ones; its slots hold types.
QUANT_FORMS = {"r32": (4, 4), "small": (8, 4), "u32": (8, 4),
               "i64": (8, 8)}
# the arithmetic forms (intc.cu Arith)
ARITH = {"exact": 0, "recip": 1, "integer": 2}
# intc.cu's __launch_bounds__ blocks an SM (kMin*) by ring value bytes,
# staged slot bytes and rank
MIN_BLOCKS = {(4, 4, 3): 4, (4, 4, 2): 3, (8, 4, 3): 2, (8, 4, 2): 1,
              (8, 8, 3): 2, (8, 8, 2): 1}
# K17's integer form takes interval2 up to this magnitude (intc.cu's note)
I2_MAX = 1 << 20

# the encoder's (AN, DN) bits by dtype: its prediction's and difference's
# widths (core.intc.SPECS)
FORMS = {dt: (8 * np.dtype(s.arith_nd).itemsize,
              8 * np.dtype(s.diff_nd).itemsize)
         for dt, s in intc.SPECS.items()}

_CARRIER = {1: torch.int8, 2: torch.int16, 4: torch.int32, 8: torch.int64}


def carrier(dtype) -> torch.dtype:
    """The torch dtype that carries an integer numpy ``dtype``'s bits:
    torch.uint8 for uint8, else the signed type of its width."""
    dt = np.dtype(dtype)
    return torch.uint8 if dt == np.uint8 else _CARRIER[dt.itemsize]


def torch_dtype(dtype) -> torch.dtype:
    """The torch dtype of an integer numpy ``dtype`` (torch.uint16, 32 and
    64 are views of their carriers, with few operators)."""
    return getattr(torch, np.dtype(dtype).name)


def to_carrier(a: np.ndarray, device) -> torch.Tensor:
    """A host integer array as its carrier tensor on ``device``."""
    a = np.ascontiguousarray(a)
    if a.dtype.kind == "u" and a.itemsize > 1:
        a = a.view(f"i{a.itemsize}")
    return torch.from_numpy(a).to(device)


def widen(t: torch.Tensor, dtype) -> torch.Tensor:
    """A carrier tensor's values as int64, by ``dtype``'s signedness."""
    dt = np.dtype(dtype)
    w = t.to(_I64)
    if dt.kind == "u" and dt.itemsize in (2, 4):
        w = w & ((1 << (8 * dt.itemsize)) - 1)
    return w


def _wrap(v: torch.Tensor, bits: int, signed: bool = True) -> torch.Tensor:
    """wrap_bits (core.c:2189): int64 ``v`` to its low ``bits`` bits,
    sign-extended when ``signed``."""
    if bits >= 64:
        return v
    u = v & ((1 << bits) - 1)
    if signed:
        u = u - ((u >> (bits - 1)) << bits)
    return u


def _x86_ll(v: torch.Tensor) -> torch.Tensor:
    """(int64_t)trunc(v) as x86 computes it: INT64_MIN out of range and
    for NaN."""
    ok = (v >= -2.0 ** 63) & (v < 2.0 ** 63)
    return torch.where(ok, torch.where(ok, v, 0.0).to(_I64), -2 ** 63)


def _x86_int(v: torch.Tensor) -> torch.Tensor:
    """(int)v as x86 computes it, in int64: INT32_MIN out of range and
    for NaN."""
    ok = (v > -2147483649.0) & (v < 2147483648.0)
    return torch.where(ok, torch.where(ok, v, 0.0).to(_I64), -2 ** 31)


def _quantize_plain(cur, pred, rp: float, intervals: int, radius: int,
                    an: int, dn: int):
    """(types, AN-wrapped reconstructions, in range) of one diagonal's
    cells (ienc_quant, core.c:2224)."""
    diff = _wrap(cur - pred, dn)
    itv = torch.where(diff < 0, -diff, diff).to(torch.float64) / rp + 1.0
    within = itv < intervals
    t = _x86_int(torch.where(diff < 0, -itv, itv) / 2) + radius
    v = pred.to(torch.float64) + 2.0 * (t - radius).to(torch.float64) * rp
    return t, _wrap(_x86_ll(v), an), within


def int_quantize_plain(data, dtype, rp: float, intervals: int, radius: int,
                       quirk4d: bool = False):
    """K16's plain version: the int32 types of a rank 2-4 field."""
    an, dn = FORMS[np.dtype(dtype)]
    x = widen(data, dtype)
    first = _wrap(x.reshape(-1)[:1], an)
    types = torch.empty(data.shape, dtype=_I32, device=data.device)
    # the 4-D quirk's cell (l, 0, 0, 1) is flat index 1 of its volume
    quirk = quirk4d and data.shape[-1] > 1
    for v, vol in enumerate(_volumes(x)):
        flat = vol.reshape(-1)

        def step(fi, pred):
            pred = _wrap(pred, an)
            cur = flat[fi]
            if quirk:   # the volume's element 0 is pred at index 1
                cur = torch.where(fi == 1, pred, cur)
            t, rec, within = _quantize_plain(cur, pred, float(rp),
                                             intervals, radius, an, dn)
            esc = _wrap(cur, an)
            if quirk:
                esc = torch.where(fi == 1, first, esc)
            escaped = ~within | (fi == 0)      # the first point escapes
            return (torch.where(escaped, 0, t),
                    torch.where(escaped, esc, rec))

        _volumes(types)[v] = _volume_plain(vol, step)[0]
    return types


def int_decode_plain(types, escapes, dtype, interval2: float, radius: int):
    """K17's plain version: the field (in its carrier dtype) from its
    int32 types and its escapes' values in raster order (int64, already
    the output type's values)."""
    dt = np.dtype(dtype)
    bits, signed = 8 * dt.itemsize, dt.kind == "i"
    known = _known_plain(types, escapes)
    out = torch.empty(types.shape, dtype=_I64, device=types.device)
    vt = _volumes(types)
    for v, kv in enumerate(_volumes(known)):
        t_all, k_all = vt[v].reshape(-1).to(_I64), kv.reshape(-1)

        def step(fi, pred):
            t = t_all[fi]
            val = pred.to(torch.float64) + (t - radius).to(
                torch.float64) * float(interval2)
            rec = _wrap(_x86_ll(val), bits, signed)
            return t, torch.where(t != 0, rec, k_all[fi])

        _volumes(out)[v] = _volume_plain(kv, step)[1]
    return out.to(carrier(dt))


# --- the interval optimizer's samples -------------------------------------

def optimizer_samples_int(data, dtype, sample_distance: int) -> np.ndarray:
    """The int64 |Lorenzo error| at every point the integer interval
    optimizer samples (optimize_intervals_intXX_{1,2,3,4}D, e.g.
    sz_int32.c:29,75): rank 1, |x[i - 1] - x[i]| at every multiple of
    ``sample_distance`` from 2; ranks 2-4, every point with all indices
    at least 1 whose index sum is a multiple of it, the 2-D or 3-D
    stencil on the last axes (rank 4: the 3-D one).  Gathered where
    ``data`` lies, by index vectors of the samples alone (a point's row
    offset and its columns), in int64 with wraps as numpy; downloaded
    once.  Returns the errors (numpy int64) in raster order."""
    sd = int(sample_distance)
    shape = tuple(int(r) for r in data.shape)
    flat = data.reshape(-1)
    dev = data.device
    if len(shape) == 1:
        idx = torch.arange(-(-2 // sd) * sd, shape[0], sd, device=dev)
        d = widen(flat[idx], dtype)
        return (widen(flat[idx - 1], dtype) - d).abs().cpu().numpy()
    rl = shape[-1]
    off = torch.zeros((), dtype=_I64, device=dev)
    s = torch.zeros((), dtype=_I64, device=dev)
    for r in shape[:-1]:
        a = torch.arange(1, r, dtype=_I64, device=dev)
        off = (off.unsqueeze(-1) * r + a).reshape(-1)
        s = (s.unsqueeze(-1) + a).reshape(-1)
    k0 = torch.remainder(-s, sd)
    k0 = torch.where(k0 == 0, sd, k0)
    kk = k0[:, None] + sd * torch.arange(-(-rl // sd) + 1, dtype=_I64,
                                         device=dev)[None, :]
    idx = (off[:, None] * rl + kk)[kk < rl]
    del off, s, k0, kk

    def at(o):
        return widen(flat[idx - o], dtype)

    r3 = rl
    if len(shape) == 2:
        pred = at(1) + at(r3) - at(r3 + 1)
    else:
        r23 = shape[-2] * r3
        pred = (at(1) + at(r3) + at(r23) - at(r3 + 1) - at(r23 + 1)
                - at(r23 + r3) + at(r23 + r3 + 1))
    return (pred - at(0)).abs().cpu().numpy()


# --- the forms ------------------------------------------------------------

def value_bound(dtype) -> int:
    """The largest |value| of ``dtype``."""
    info = np.iinfo(np.dtype(dtype))
    return max(abs(int(info.min)), abs(int(info.max)))


def ring_form(dtype, rp: float) -> str:
    """K16's ring form (QUANT_FORMS) for data of ``dtype`` under ``rp``:
    r32 for int32, and for 8- and 16-bit data where 8 M0 + 7 rp + 28 <
    2^31 for the type's largest |value| M0 (intc.cu's note), else the
    type's int64 form."""
    dt = np.dtype(dtype)
    if dt.itemsize == 8:
        return "i64"
    if dt == np.int32:
        return "r32"
    rp = float(rp)
    if 0 < rp < 2 ** 31 and 8 * value_bound(dt) + 7 * rp + 28 < 2 ** 31:
        return "r32"
    return "small" if dt.itemsize <= 2 else "u32"


class QuantForm(NamedTuple):
    """K16's launch form: the ring form, the arithmetic form and the
    constants sz_int_quantize takes after ``arith``."""
    ring: str
    arith: str
    consts: tuple   # rp, rcp_h, rp2, lo_z, hi_z, tol_z, magic, P, thr


def quantize_form(dtype, rp: float, intervals: int) -> QuantForm:
    """K16's form for one launch (intc.cu's note): the integer form on a
    32-bit ring where rp is an integer P, 1 <= P < 2^31 and P intervals <
    2^51 (the r32i kernel); the reciprocal form where rp is not an
    integer, 2^-1000 < rp < 2^1000 and intervals >= 2; else the exact
    double chain."""
    ring = ring_form(dtype, rp)
    rp, n = float(rp), int(intervals)
    rcp_h = rp2 = lo = hi = tol = 0.0
    magic = p = thr = 0
    if ring == "r32" and rp.is_integer() and 1 <= rp < 2 ** 31 \
            and rp * n < 2 ** 51:
        arith, p = "integer", int(rp)
        magic = (1 << 64) // (2 * p) + 1
        thr = min(max(n - 1, 0) * p, 2 ** 32 - 1)
    elif not rp.is_integer() and 2.0 ** -1000 < rp < 2.0 ** 1000 \
            and n >= 2:
        arith = "recip"
        rcp_h, rp2 = (1.0 / rp) * 0.5, 2.0 * rp
        tol = n * 2.0 ** -49
        lo, hi = n / 2 - tol, n / 2 + tol
    else:
        arith = "exact"
    return QuantForm(ring, arith, (rp, rcp_h, rp2, lo, hi, tol, magic, p,
                                   thr))


def decode_form(dtype, interval2: float) -> tuple:
    """K17's form for one launch: ("integer", I2) where the output has 32
    bits or less and interval2 is an integer I2 with |I2| <= I2_MAX, else
    ("exact", 0), the double chain."""
    i2 = float(interval2)
    if np.dtype(dtype).itemsize <= 4 and i2.is_integer() and \
            abs(i2) <= I2_MAX:
        return "integer", int(i2)
    return "exact", 0


# --- the strips -----------------------------------------------------------

def shared_bytes(item: int, slot: int, rank: int) -> int:
    """Dynamic shared memory of a block (strips.cuh ``shared_bytes`` of
    intc.cu's rules): value rings of ``item``-byte values and one staging
    array of ``slot``-byte slots a warp, RING[rank] slots a row."""
    ring = RING[rank]
    return strips.shared_bytes(WARPS, item, LANES * (ring + 1) * slot, ring)


def kernels() -> dict:
    """intc.cu's eighteen kernels: name -> (ring value bytes, staged slot
    bytes, rank, the blocks an SM its __launch_bounds__ asks).  K16's
    r32i kernels run the integer form, its r32 kernels the double forms
    on the same ring."""
    out = {}
    for form in ("r32i", *QUANT_FORMS):
        item, slot = QUANT_FORMS[form.removesuffix("i")]
        for r in (2, 3):
            out[f"int_quantize{r}d_{form}_kernel"] = (
                item, slot, r, MIN_BLOCKS[item, slot, r])
    for bits in (8, 16, 32, 64):
        item = 8 if bits == 64 else 4
        for r in (2, 3):
            out[f"int_decode{r}d_{bits}_kernel"] = (
                item, 4, r, MIN_BLOCKS[item, 4, r])
    return out


def kernel_info(name: str) -> dict:
    """Kernel ``name`` (:func:`kernels`) on the current card, from the
    runtime: the resident blocks an SM at its shared bytes, its registers
    a thread and its local bytes a thread (stack and spills)."""
    out = (ctypes.c_int * 3)()
    _build.check(_build.lib().sz_int_kernel_info(
        list(kernels()).index(name), out), "int_kernel_info")
    return dict(blocks_an_sm=out[0], registers=out[1], local_bytes=out[2])


# --- wrappers -------------------------------------------------------------

def _check(name: str, data, dtype):
    dt = np.dtype(dtype)
    if dt not in FORMS:
        raise ValueError(f"{name}: an integer dtype is required, not {dt}")
    if data.dim() not in (2, 3, 4):
        raise ValueError(f"{name}: a rank-2, 3 or 4 lattice is required")
    if data.dtype != carrier(dt):
        raise ValueError(f"{name}: {dt} travels as {carrier(dt)}, "
                         f"not {data.dtype}")
    if data.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {data.device}")
    if data.device.type == "cuda" and not data.is_contiguous():
        raise ValueError(f"{name}: a contiguous tensor is required")
    return data.device.type


def _p(t):
    return ctypes.c_void_p(t.data_ptr())


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def _ring_dtype(item: int):
    return _I32 if item == 4 else _I64


def int_quantize(data, dtype, rp: float, intervals: int, radius: int,
                 quirk4d: bool = False):
    """K16 encode: the int32 types (0 an escape) of a rank 2-4 integer
    field ``data`` (its carrier tensor) of numpy dtype ``dtype``;
    ``quirk4d``: the 4-D encoder's cell (l, 0, 0, 1)."""
    kind = _check("int_quantize", data, dtype)
    if kind == "cpu":
        return int_quantize_plain(data, dtype, rp, intervals, radius,
                                  quirk4d)
    dt = np.dtype(dtype)
    types = torch.empty(data.shape, dtype=_I32, device=data.device)
    if data.numel() == 0:
        return types
    form = quantize_form(dt, rp, intervals)
    lat = lattice(data.shape)
    sargs, keep = strips.strip_args(
        lat, WARPS, _ring_dtype(QUANT_FORMS[form.ring][0]), data.device)
    rc = _build.lib().sz_int_quantize(
        _p(data), _p(types), *lat, dt.itemsize, int(dt.kind == "i"),
        list(QUANT_FORMS).index(form.ring), ARITH[form.arith], *form.consts,
        int(intervals), int(radius), int(bool(quirk4d)), *sargs,
        _stream(data))
    _build.check(rc, "int_quantize")
    _build.launched(int_quantize)
    del keep
    return types


def int_decode(types, escapes, dtype, interval2: float, radius: int,
               row_base=None):
    """K17 decode: the field (its carrier tensor) of numpy dtype ``dtype``
    from its int32 types (rank 2-4) and its escapes' values in raster
    order (int64, already values of ``dtype``).  ``row_base``:
    :func:`escape_row_base`'s first result, where the
    caller has it (else computed here)."""
    name = "int_decode"
    dt = np.dtype(dtype)
    if dt not in FORMS:
        raise ValueError(f"{name}: an integer dtype is required, not {dt}")
    if types.dim() not in (2, 3, 4) or types.dtype != _I32:
        raise ValueError(f"{name}: int32 types of rank 2, 3 or 4 required")
    if escapes.dim() != 1 or escapes.dtype != _I64:
        raise ValueError(f"{name}: int64 escapes of shape (n,) required")
    if types.device != escapes.device or types.device.type not in (
            "cpu", "cuda"):
        raise ValueError(f"{name}: tensors on one cpu or cuda device")
    if types.device.type == "cpu":
        return int_decode_plain(types, escapes, dt, interval2, radius)
    if not (types.is_contiguous() and escapes.is_contiguous()):
        raise ValueError(f"{name}: contiguous tensors required")
    out = torch.empty(types.shape, dtype=carrier(dt), device=types.device)
    if types.numel() == 0:
        return out
    if row_base is None:
        row_base = escape_row_base(types)[0]
    if (row_base.dtype != _I64 or row_base.device != types.device
            or row_base.numel() != types.numel() // types.shape[-1]):
        raise ValueError(f"{name}: row_base must be escape_row_base(types)")
    arith, i2 = decode_form(dt, interval2)
    lat = lattice(types.shape)
    sargs, keep = strips.strip_args(
        lat, WARPS, _ring_dtype(8 if dt.itemsize == 8 else 4), types.device)
    rc = _build.lib().sz_int_decode(
        _p(types), _p(escapes), int(escapes.numel()), _p(row_base), _p(out),
        *lat, dt.itemsize, int(dt.kind == "i"), float(interval2),
        ARITH[arith], i2, int(radius), *sargs, _stream(out))
    _build.check(rc, "int_decode")
    _build.launched(int_decode)
    del keep
    return out


int_quantize.launches = int_decode.launches = 0
