"""The integer codecs, int8 to uint64 at ranks 1 to 4 (the port's copy of
``sz_tpu.core.intc``): SZ_compress_intXX_{1,2,3,4}D_MDQ (e.g.
sz_int32.c:228, sz_uint16.c) and their decoders.

Lorenzo prediction on integers: rank 1 from the previous reconstruction,
ranks 2-4 by the positional Lorenzo stencil of SZ1.4 (a 4-D field as
independent 3-D volumes).  The widths are the reference's: the 1-D
kernel predicts in ``arith_1d`` (int32 wraps in int32, uint32 in uint32,
the rest in int64); the 2-D to 4-D kernels predict in ``arith_nd`` and
form the difference in ``diff_nd`` (a C int for the 8- and 16-bit types).
The quantizer works in double and C's double-to-integer conversion
truncates.  Escapes store (value - min) big-endian in the fewest bytes
that hold the range (compressInt32Value etc., dataCompression.c:408-477).
The container is TightDataPointStorageI (TightDataPointStorageI.c:
334-470).

Rank 1 runs its serial recurrence in the host runtime
(``native/host.c``), as ``sz_tpu`` does; ranks 2-4 run on the device
given (``gpu/int_engine.py``: the sample gather, K16/K17).  Here are the
host parts both use: the range, the interval optimizer's histogram, the
escapes' bytes and the container.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from sz_tpu_torch import native
from sz_tpu_torch.config import VERSION, DataType
from sz_tpu_torch.core import classic
from sz_tpu_torch.core.optimizer import round_up_to_power_of_2
from sz_tpu_torch.format import bytes_util as bu


@dataclasses.dataclass(frozen=True)
class ISpec:
    dt: DataType
    esize: int
    arith_1d: object  # the width of the 1-D kernel's prediction chain
    arith_nd: object  # the width of the 2-D to 4-D kernels' prediction
    diff_nd: object   # the width of their difference


SPECS = {
    np.dtype(np.int8): ISpec(DataType.INT8, 1, np.int64, np.int64, np.int32),
    np.dtype(np.uint8): ISpec(DataType.UINT8, 1, np.int64, np.int64,
                              np.int32),
    np.dtype(np.int16): ISpec(DataType.INT16, 2, np.int64, np.int64,
                              np.int32),
    np.dtype(np.uint16): ISpec(DataType.UINT16, 2, np.int64, np.int64,
                               np.int32),
    np.dtype(np.int32): ISpec(DataType.INT32, 4, np.int32, np.int32,
                              np.int32),
    np.dtype(np.uint32): ISpec(DataType.UINT32, 4, np.uint32, np.int64,
                               np.int64),
    np.dtype(np.int64): ISpec(DataType.INT64, 8, np.int64, np.int64,
                              np.int64),
    np.dtype(np.uint64): ISpec(DataType.UINT64, 8, np.int64, np.int64,
                               np.int64),
}

_SIZE_CODE = {1: 0, 2: 4, 4: 8, 8: 12}
# unsigned types carried as signed ones whose int64 value is unsigned
_FLIPPED = (np.dtype(np.uint16), np.dtype(np.uint32))


def range_size_int(flat, dtype=None):
    """computeRangeSize_int (dataCompression.c:37): (min, max - min) in
    int64.  ``flat`` is a numpy array, or a carrier tensor
    (``gpu.int_kernel.carrier``) of numpy ``dtype`` scanned where it lies
    (min and max do not depend on order; an unsigned type of 16 or 32
    bits is scanned with its sign bit flipped, its order as a signed
    type) and two scalars come down."""
    if not torch.is_tensor(flat):
        # in the array's own type (no int64 copy); uint64 reads as int64
        v = flat.view(np.int64) if flat.dtype == np.uint64 else flat
        mn = int(v.min())
        return mn, int(v.max()) - mn
    dt = np.dtype(dtype)
    bias = 1 << (8 * dt.itemsize - 1) if dt in _FLIPPED else 0
    x = flat ^ -bias if bias else flat
    mn, mx = (int(a) + bias for a in torch.stack(torch.aminmax(x)).cpu())
    return mn, mx - mn


def byte_size_per_value(value_range: int) -> int:
    """computeByteSizePerIntValue (dataCompression.c:24)."""
    for size, top in ((1, 256), (2, 65536), (4, 4294967296)):
        if value_range <= top:
            return size
    return 8


def optimize_intervals(perr: np.ndarray, total: int, rp: float,
                       max_range_radius: int, pred_threshold) -> int:
    """The finish of optimize_intervals_intXX_{1,2,3,4}D (e.g.
    sz_int32.c:29,75): the histogram of the radius indices of the
    sampled |Lorenzo errors| ``perr`` (int64) and its first bin past
    ``total * pred_threshold``, rounded up to a power of two (at least
    32)."""
    radius_index = ((perr.astype(np.float64) / rp + 1.0) / 2.0) \
        .astype(np.int64)
    np.minimum(radius_index, max_range_radius - 1, out=radius_index)
    # C casts the quotient through (uint64_t): negatives wrap to huge
    # values and clamp to the last bin
    radius_index[radius_index < 0] = max_range_radius - 1
    hist = np.bincount(radius_index, minlength=max_range_radius)
    target = int(total * pred_threshold)
    over = np.flatnonzero(np.cumsum(hist) > target)
    i = int(over[0]) if len(over) else max_range_radius - 1
    return max(round_up_to_power_of_2(2 * (i + 1)), 32)


def _optimize_intervals_1d(flat: np.ndarray, rp: float,
                           max_range_radius: int, sample_distance: int,
                           pred_threshold) -> int:
    """optimize_intervals_intXX_1D (e.g. sz_int32.c:29): |previous-value
    error| histogram over every sample_distance-th index from 2."""
    d = flat.astype(np.int64)
    idx = np.arange(2, d.size)
    idx = idx[idx % sample_distance == 0]
    return optimize_intervals(np.abs(d[idx - 1] - d[idx]),
                              d.size // sample_distance, rp,
                              max_range_radius, pred_threshold)


def exact_bytes(vals: np.ndarray, min_value: int, byte_size: int,
                esize: int) -> bytes:
    """The escapes' bytes (ienc_store, compressInt32Value etc.): each
    value (int64, as the type reads it) less ``min_value``, modulo the
    type's width, its low ``byte_size`` bytes big-endian."""
    off = (vals.astype(np.int64).view(np.uint64)
           - np.uint64(int(min_value) % (1 << 64)))
    be = off.astype(">u8").view(np.uint8).reshape(-1, 8)
    return be[:, 8 - byte_size:].tobytes()


def exact_values(exact: bytes, count: int, min_value: int, byte_size: int,
                 dtype) -> np.ndarray:
    """The first ``count`` escape values of ``exact`` as int64 values of
    ``dtype`` (the decoder's INXT: the ``byte_size``-byte big-endian
    offset plus ``min_value``, wrapped to the type)."""
    dt = np.dtype(dtype)
    raw = np.frombuffer(exact, np.uint8, count=count * byte_size) \
        .reshape(count, byte_size)
    full = np.zeros((count, 8), np.uint8)
    full[:, 8 - byte_size:] = raw
    v = full.view(">u8").reshape(-1) + np.uint64(int(min_value) % (1 << 64))
    return v.astype(f"u{dt.itemsize}").view(dt).astype(np.int64)


@dataclasses.dataclass
class ITDPS:
    """TightDataPointStorageI fields."""

    ds_length: int
    intervals: int
    min_value: int
    real_precision: float
    exact_byte_size: int
    type_array: bytes
    exact_bytes: bytes
    exact_data_num: int
    max_quant_intervals: int = 65536


def compress_int(data, real_precision: float, *, mn: int, byte_size: int,
                 max_range_radius: int, sample_distance: int,
                 pred_threshold, opt_quant_mode: int = 1,
                 fixed_intervals: int = 0, dtype=None, device) -> ITDPS:
    """The integer encode of a non-constant field of rank 1 to 4 (rank 1:
    n >= 2) whose minimum ``mn`` and escape width ``byte_size`` the
    caller has from :func:`range_size_int`.  Rank 1 is a host array;
    ranks 2-4 a host array or a carrier tensor of numpy ``dtype``, encoded
    on ``device`` (``gpu/int_engine.py``)."""
    if data.ndim > 1:
        from sz_tpu_torch.gpu import int_engine   # it imports this module
        return int_engine.compress(
            data, real_precision, mn=mn, byte_size=byte_size,
            max_range_radius=max_range_radius,
            sample_distance=sample_distance, pred_threshold=pred_threshold,
            opt_quant_mode=opt_quant_mode, fixed_intervals=fixed_intervals,
            dtype=dtype, device=device)
    spec = SPECS[data.dtype]
    flat = np.ascontiguousarray(data)
    rp = float(real_precision)
    if opt_quant_mode == 1:
        intervals = _optimize_intervals_1d(flat, rp, max_range_radius,
                                           sample_distance, pred_threshold)
    else:
        intervals = fixed_intervals
    types, exact, nexact = native.int1d_encode(
        flat, rp, intervals, intervals // 2, spec.arith_1d, mn, byte_size,
        spec.esize)
    type_array, _ = classic.encode_types(types, intervals, device)
    return ITDPS(ds_length=flat.size, intervals=intervals, min_value=mn,
                 real_precision=rp, exact_byte_size=byte_size,
                 type_array=type_array, exact_bytes=exact,
                 exact_data_num=nexact,
                 max_quant_intervals=max_range_radius * 2)


def decompress_int(t: ITDPS, shape: tuple, dtype, *, device,
                   as_tensor: bool = False):
    """The integer decode of a field of ``shape`` (its size-1 dimensions
    dropped): rank 1 on the host (types on the device), ranks 2-4 on
    ``device`` (``gpu/int_engine.py``).  Returns numpy, or with
    ``as_tensor`` (ranks 2-4) the carrier tensor on ``device``."""
    if len(shape) > 1:
        from sz_tpu_torch.gpu import int_engine
        return int_engine.decompress(t, shape, dtype, device=device,
                                     as_tensor=as_tensor)
    spec = SPECS[np.dtype(dtype)]
    types = classic.decode_types(t.type_array, shape[0],
                                 device).cpu().numpy()
    return native.int1d_decode(types, 2 * t.real_precision,
                               t.intervals // 2, dtype, t.min_value,
                               t.exact_byte_size, spec.esize, t.exact_bytes)


def itdps_to_bytes(t: ITDPS, dtype, header_params: bytes, sz_mode: int,
                   size_type: int = 8) -> bytes:
    """[ver3][sameByte][params][exactByteSize u8][dsLen ST]
    [maxQI u32 BE][intervals u32 BE][minValue i64 BE][realPrecision f64 BE]
    [typeArraySize ST][exactDataNum ST][exactBytesSize ST]
    [typeArray][exactBytes]"""
    same_byte = (sz_mode << 1) | _SIZE_CODE[SPECS[np.dtype(dtype)].esize]
    if size_type == 8:
        same_byte |= 0x40
    return b"".join([
        bytes(VERSION), bytes([same_byte]), header_params,
        bytes([t.exact_byte_size]), bu.size_be(t.ds_length, size_type),
        bu.i32_be(t.max_quant_intervals), bu.i32_be(t.intervals),
        int(t.min_value).to_bytes(8, "big", signed=True),
        bu.f64_be(t.real_precision),
        bu.size_be(len(t.type_array), size_type),
        bu.size_be(t.exact_data_num, size_type),
        bu.size_be(len(t.exact_bytes), size_type),
        t.type_array, t.exact_bytes])


def store_ori_int(data: np.ndarray, header_params: bytes,
                  size_type: int = 8) -> bytes:
    """SZ_compress_args_<int>_StoreOriData (e.g. sz_uint16.c:320):
    verbatim big-endian values behind the isLossless flag byte.  The 1-D
    trigger passes dataLength+2 (sz_uint16.c:363: the reference reads two
    elements past the array); the same count is written, zero-padded."""
    spec = SPECS[data.dtype]
    pad = 2 if data.ndim == 1 else 0
    same_byte = 0x10 | (0x40 if size_type == 8 else 0)
    be = data.reshape(-1).astype(data.dtype.newbyteorder(">"))
    return (bytes(VERSION) + bytes([same_byte]) + header_params
            + bu.size_be(data.size + pad, size_type) + be.tobytes()
            + b"\x00" * (pad * spec.esize))


def same_int(value, n: int, header_params: bytes, sz_mode: int,
             size_type: int = 8) -> bytes:
    """The allSameData stream of a constant field of ``n`` values
    ``value`` (a numpy scalar of the field's dtype; sz_uint16.c:1252,
    TightDataPointStorageI.c:356-375): one big-endian value."""
    dt = np.dtype(type(value))
    same_byte = 0x01 | (sz_mode << 1) | _SIZE_CODE[SPECS[dt].esize]
    if size_type == 8:
        same_byte |= 0x40
    v = np.array([value], dtype=dt.newbyteorder(">"))
    return (bytes(VERSION) + bytes([same_byte]) + header_params
            + bu.size_be(n, size_type) + v.tobytes())


def itdps_from_bytes(body: bytes, meta_len: int) -> ITDPS:
    """Parse a TightDataPointStorageI stream (itdps_to_bytes' layout)."""
    pos = 3
    size_type = 8 if body[pos] & 0x40 else 4
    pos += 1 + meta_len
    exact_byte_size = body[pos]
    pos += 1
    vals = []
    for width in (size_type, 4, 4, 8, 8, size_type, size_type, size_type):
        vals.append(bytes(body[pos:pos + width]))
        pos += width
    ds_length = int.from_bytes(vals[0], "big")
    ta_size = int.from_bytes(vals[5], "big")
    eb_size = int.from_bytes(vals[7], "big")
    type_array = bytes(body[pos:pos + ta_size])
    exact = bytes(body[pos + ta_size:pos + ta_size + eb_size])
    return ITDPS(ds_length=ds_length,
                 intervals=int.from_bytes(vals[2], "big", signed=True),
                 min_value=int.from_bytes(vals[3], "big", signed=True),
                 real_precision=float(np.frombuffer(vals[4], ">f8")[0]),
                 exact_byte_size=exact_byte_size, type_array=type_array,
                 exact_bytes=exact,
                 exact_data_num=int.from_bytes(vals[6], "big"),
                 max_quant_intervals=int.from_bytes(vals[1], "big",
                                                    signed=True))

