"""The 1-D integer codec (the port's copy of the 1-D part of
``sz_tpu.core.intc``): what the random-access codec nests, its per-block
escape counts (int32) and Huffman stream sizes (uint16), each a whole SZ
stream under ABS 0.5 (sz_float.c:10052-10095).

SZ_compress_intXX_1D_MDQ (e.g. sz_int32.c:228, sz_uint16.c) predicts
each value from the previous reconstruction, in the width of the type's
1-D arithmetic (int32 wraps in int32, uint32 in uint32, the rest in
int64); the quantizer works in double and C's double-to-integer
conversion truncates.  Escapes store (value - min) big-endian in the
fewest bytes that hold the range (compressInt32Value etc.,
dataCompression.c:408-477).  The recurrence is serial and runs in the
host runtime (``native/host.c``); the type stream's histogram (K3),
bit-pack (K4) and Huffman decode (K5-K7) run on the device given, as the
classic 1-D codec's do.  The container is TightDataPointStorageI
(TightDataPointStorageI.c:334-470).

Only rank 1 is here: integer fields of every rank (ROADMAP 1.10) still
raise at the public entry points.
"""

from __future__ import annotations

import dataclasses

import numpy as np

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


SPECS = {
    np.dtype(np.int8): ISpec(DataType.INT8, 1, np.int64),
    np.dtype(np.uint8): ISpec(DataType.UINT8, 1, np.int64),
    np.dtype(np.int16): ISpec(DataType.INT16, 2, np.int64),
    np.dtype(np.uint16): ISpec(DataType.UINT16, 2, np.int64),
    np.dtype(np.int32): ISpec(DataType.INT32, 4, np.int32),
    np.dtype(np.uint32): ISpec(DataType.UINT32, 4, np.uint32),
    np.dtype(np.int64): ISpec(DataType.INT64, 8, np.int64),
    np.dtype(np.uint64): ISpec(DataType.UINT64, 8, np.int64),
}

_SIZE_CODE = {1: 0, 2: 4, 4: 8, 8: 12}


def range_size_int(flat: np.ndarray):
    """computeRangeSize_int (dataCompression.c:37): (min, max - min) in
    int64."""
    v = flat.astype(np.int64)
    mn = int(v.min())
    return mn, int(v.max()) - mn


def byte_size_per_value(value_range: int) -> int:
    """computeByteSizePerIntValue (dataCompression.c:24)."""
    for size, top in ((1, 256), (2, 65536), (4, 4294967296)):
        if value_range <= top:
            return size
    return 8


def _optimize_intervals_1d(flat: np.ndarray, rp: float,
                           max_range_radius: int, sample_distance: int,
                           pred_threshold) -> int:
    """optimize_intervals_intXX_1D (e.g. sz_int32.c:29): |previous-value
    error| histogram over every sample_distance-th index from 2."""
    d = flat.astype(np.int64)
    idx = np.arange(2, d.size)
    idx = idx[idx % sample_distance == 0]
    perr = np.abs(d[idx - 1] - d[idx])
    radius_index = ((perr.astype(np.float64) / rp + 1.0) / 2.0) \
        .astype(np.int64)
    np.minimum(radius_index, max_range_radius - 1, out=radius_index)
    radius_index[radius_index < 0] = max_range_radius - 1
    hist = np.bincount(radius_index, minlength=max_range_radius)
    target = int(d.size // sample_distance * pred_threshold)
    over = np.flatnonzero(np.cumsum(hist) > target)
    i = int(over[0]) if len(over) else max_range_radius - 1
    return max(round_up_to_power_of_2(2 * (i + 1)), 32)


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


def compress_int(data: np.ndarray, real_precision: float, *,
                 max_range_radius: int, sample_distance: int,
                 pred_threshold, opt_quant_mode: int = 1,
                 fixed_intervals: int = 0, device) -> ITDPS:
    """The 1-D integer encode of ``data`` (n >= 2, not constant)."""
    spec = SPECS[data.dtype]
    flat = np.ascontiguousarray(data).reshape(-1)
    if data.ndim != 1:
        raise NotImplementedError(
            "integer fields of rank > 1 are not ported yet (ROADMAP 1.10)")
    rp = float(real_precision)
    mn, vrange = range_size_int(flat)
    byte_size = byte_size_per_value(vrange)
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


def decompress_int(t: ITDPS, n: int, dtype, *, device) -> np.ndarray:
    """The 1-D integer decode: types on the device, the chain on the
    host."""
    spec = SPECS[np.dtype(dtype)]
    types = classic.decode_types(t.type_array, n, device).cpu().numpy()
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


def same_int(data: np.ndarray, header_params: bytes, sz_mode: int,
             size_type: int = 8) -> bytes:
    """The allSameData stream of a constant field (sz_uint16.c:1252,
    TightDataPointStorageI.c:356-375): one big-endian value."""
    spec = SPECS[data.dtype]
    same_byte = 0x01 | (sz_mode << 1) | _SIZE_CODE[spec.esize]
    if size_type == 8:
        same_byte |= 0x40
    v = np.array([data.reshape(-1)[0]], dtype=data.dtype.newbyteorder(">"))
    return (bytes(VERSION) + bytes([same_byte]) + header_params
            + bu.size_be(data.size, size_type) + v.tobytes())


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

