"""Outer stream header: version bytes, flag byte, serialized parameters
(the port's copy of ``sz_tpu.format.metadata``).

Wire layout (reference: initRandomAccessBytes dataCompression.c:686,
convertSZParamsToBytes ByteToolkit.c:874, parser
TightDataPointStorageF.c:54-130):

    [0:3]   version major/minor/build (2,1,12)
    [3]     flag byte ("sameByte"):
              bit0 same-value stream        bit4 lossless (verbatim) stream
              bit1 random access            bit5 PW_REL
              bit2 protect value range      bit6 size_t is 8 bytes
              bit3 MSST19 accel pw_rel      bit7 regression (SZ2.1) stream
    [4:4+M] M=28 (float) / 36 (double) serialized params:
              [0]  packed: optQuantMode(1b) dataEndian(1b) sysEndian(1b)
                   szMode(2b) gzipMode(2b)
              [1:3]  sampleDistance  (i16 BE)
              [3:5]  predThreshold*10000 (i16 BE)
              [5]    errorBoundMode(4b) | dataType(4b)
              [6:10] bound slot 1 (f32 BE)   [10:14] bound slot 2 (f32 BE)
              [14]   sol_ID
              [16:20] max_quant_intervals (u32 BE)
              [20:..] fmin,fmax (f32 BE x2) or dmin,dmax (f64 BE x2)
"""

from __future__ import annotations

import dataclasses

import numpy as np

from sz_tpu_torch.config import (
    META_DATA_BYTE_LENGTH, META_DATA_BYTE_LENGTH_DOUBLE, VERSION, DataType,
    ErrorBoundMode, Lossless, SZConfig,
)
from sz_tpu_torch.format import bytes_util as bu


def meta_length(data_type: DataType) -> int:
    return (META_DATA_BYTE_LENGTH_DOUBLE if data_type == DataType.DOUBLE
            else META_DATA_BYTE_LENGTH)


def _gzip_mode_bits(cfg: SZConfig) -> int:
    # ByteToolkit.c:921-935: only zlib's named levels map; anything else -> 0.
    if cfg.lossless == Lossless.GZIP:
        return {1: 0, 0: 1, 9: 2}.get(cfg.lossless_level, 0)
    return 0  # zstd default level 3 matches no case -> 0


def serialize_params(cfg: SZConfig, data_type: DataType,
                     fmin, fmax) -> bytes:
    """convertSZParamsToBytes (ByteToolkit.c:874)."""
    out = bytearray(meta_length(data_type))
    flag = cfg.opt_quant_mode & 1
    flag = (flag << 1) | (0 if cfg.data_endian_little else 1)
    flag = (flag << 1) | 0  # sysEndianType: little
    flag = (flag << 2) | int(cfg.sz_mode)
    flag = (flag << 2) | _gzip_mode_bits(cfg)
    out[0] = flag
    out[1:3] = bu.i16_be(cfg.sample_distance)
    out[3:5] = bu.i16_be(int(np.float32(cfg.pred_threshold) * 10000))
    ebm = int(cfg.error_bound_mode)
    out[5] = ((ebm << 4) | (int(data_type) & 0x17)) & 0xFF

    mode = cfg.error_bound_mode
    if mode == ErrorBoundMode.ABS:
        out[6:10] = bu.f32_be(cfg.abs_err_bound)
    elif mode == ErrorBoundMode.REL:
        out[10:14] = bu.f32_be(cfg.rel_bound_ratio)
    elif mode in (ErrorBoundMode.ABS_AND_REL, ErrorBoundMode.ABS_OR_REL):
        out[6:10] = bu.f32_be(cfg.abs_err_bound)
        out[10:14] = bu.f32_be(cfg.rel_bound_ratio)
    elif mode == ErrorBoundMode.PSNR:
        out[6:10] = bu.f32_be(cfg.psnr)
        # the reference writes zeros at [9:13] here (ByteToolkit.c:933),
        # clobbering the psnr float's last byte after the fact
        out[9:13] = b"\x00\x00\x00\x00"
    elif mode in (ErrorBoundMode.ABS_AND_PW_REL, ErrorBoundMode.ABS_OR_PW_REL):
        out[6:10] = bu.f32_be(cfg.abs_err_bound)
        out[10:14] = bu.f32_be(cfg.pw_rel_bound_ratio)
    elif mode in (ErrorBoundMode.REL_AND_PW_REL, ErrorBoundMode.REL_OR_PW_REL):
        out[6:10] = bu.f32_be(cfg.rel_bound_ratio)
        out[10:14] = bu.f32_be(cfg.pw_rel_bound_ratio)
    elif mode == ErrorBoundMode.PW_REL:
        out[10:14] = bu.f32_be(cfg.pw_rel_bound_ratio)

    out[14] = cfg.sol_id & 0xFF
    if cfg.opt_quant_mode == 1:
        out[16:20] = bu.u32_be(cfg.max_quant_intervals)
    else:
        out[16:20] = bu.u32_be(cfg.quantization_intervals)

    if data_type == DataType.FLOAT:
        out[20:24] = bu.f32_be(fmin)
        out[24:28] = bu.f32_be(fmax)
    elif data_type == DataType.DOUBLE:
        out[20:28] = bu.f64_be(fmin)
        out[28:36] = bu.f64_be(fmax)
    return bytes(out)


@dataclasses.dataclass
class ParsedParams:
    """Decoded parameter block (convertBytesToSZParams ByteToolkit.c:985)."""

    opt_quant_mode: int
    data_endian_little: bool
    sz_mode: int
    gzip_mode_bits: int
    sample_distance: int
    pred_threshold: float
    error_bound_mode: int
    data_type: int
    bound1: np.float32
    bound2: np.float32
    sol_id: int
    max_quant_intervals: int
    fmin: float
    fmax: float


def parse_params(b: bytes, data_type: DataType) -> ParsedParams:
    flag = b[0]
    if data_type == DataType.DOUBLE:
        fmin = float(bu.read_f64_be(b, 20))
        fmax = float(bu.read_f64_be(b, 28))
    else:
        fmin = float(bu.read_f32_be(b, 20))
        fmax = float(bu.read_f32_be(b, 24))
    return ParsedParams(
        opt_quant_mode=(flag & 0x40) >> 6,
        data_endian_little=((flag & 0x20) >> 5) == 0,
        sz_mode=(flag & 0x0C) >> 2,
        gzip_mode_bits=flag & 0x03,
        sample_distance=bu.read_u16_be(b, 1),
        pred_threshold=bu.read_u16_be(b, 3) / 10000.0,
        error_bound_mode=(b[5] >> 4) & 0x0F,
        data_type=b[5] & 0x0F,
        bound1=bu.read_f32_be(b, 6),
        bound2=bu.read_f32_be(b, 10),
        sol_id=b[14],
        max_quant_intervals=bu.read_u32_be(b, 16),
        fmin=fmin,
        fmax=fmax,
    )


def make_flag_byte(*, same: bool = False, lossless: bool = False,
                   pw_rel: bool = False, size_type: int = 8,
                   regression: bool = False, random_access: bool = False,
                   protect_range: bool = False, msst19: bool = False) -> int:
    flag = 0
    if same:
        flag |= 0x01
    if random_access:
        flag |= 0x02
    if protect_range:
        flag |= 0x04
    if msst19:
        flag |= 0x08
    if lossless:
        flag |= 0x10
    if pw_rel:
        flag |= 0x20
    if size_type == 8:
        flag |= 0x40
    if regression:
        flag |= 0x80
    return flag


def make_header(cfg: SZConfig, data_type: DataType, fmin, fmax,
                **flag_kw) -> bytes:
    """3 version bytes + flag byte + param block."""
    flag = make_flag_byte(size_type=cfg.size_type,
                          protect_range=cfg.protect_value_range, **flag_kw)
    return (bytes(VERSION) + bytes([flag])
            + serialize_params(cfg, data_type, fmin, fmax))


@dataclasses.dataclass
class ParsedHeader:
    version: tuple
    same: bool
    random_access: bool
    protect_range: bool
    msst19: bool
    lossless: bool
    pw_rel: bool
    size_type: int
    regression: bool
    params: ParsedParams
    body_offset: int  # offset right after the param block


def parse_header(blob: bytes, data_type: DataType) -> ParsedHeader:
    version = tuple(blob[0:3])
    # checkVersion2 (conf.c:427, enforced TightDataPointStorageF.c:63):
    # any producer >= 2.1.8 is accepted; older streams must match the
    # current version exactly
    given = version[0] * 10000 + version[1] * 100 + version[2]
    if given < 20108 and version != tuple(VERSION):
        raise ValueError(
            f"unsupported stream version {version[0]}.{version[1]}."
            f"{version[2]} (pre-2.1.8 streams are rejected, "
            "TightDataPointStorageF.c:63)")
    flag = blob[3]
    mlen = meta_length(data_type)
    return ParsedHeader(
        version=version,
        same=bool(flag & 0x01),
        random_access=bool(flag & 0x02),
        protect_range=bool(flag & 0x04),
        msst19=bool(flag & 0x08),
        lossless=bool(flag & 0x10),
        pw_rel=bool(flag & 0x20),
        size_type=8 if flag & 0x40 else 4,
        regression=bool(flag & 0x80),
        params=parse_params(blob[4:4 + mlen], data_type),
        body_offset=4 + mlen,
    )
