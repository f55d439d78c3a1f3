"""Classic (SZ1.4-style) TightDataPointStorage container (the port's copy
of ``sz_tpu.format.tdps``; the PW_REL/MSST19 codec serializes through it).

Layout after [version|flag|params|dsLength] (writer
convertTDPStoBytes_float TightDataPointStorageF.c:379-479, parser
new_TightDataPointStorageF_fromFlatBytes :54-265; double variants in
TightDataPointStorageD.c):

    [max_quant_intervals u32 BE]
    (PW_REL only) [radExpo u8][segment_size ST][pwrErrBoundBytes_size u32]
    [intervals u32 BE]
    [medianValue f32/f64 BE]
    [reqLength u8]
    (MSST19 only) [plus_bits u8][max_bits u8]
    [realPrecision f64 BE]
    [typeArray_size ST][exactDataNum ST][exactMidBytes_size ST]
    (PW_REL only) [minLogValue f32 BE]
    [typeArray: framed Huffman (nodeCount u32|stateNum u32|tree|bits)]
    (PW_REL only) [pwrErrBoundBytes]
    [leadNumArray 2-bit packed][exactMidBytes][residualMidBits]
"""

from __future__ import annotations

import dataclasses

from sz_tpu_torch.config import DataType
from sz_tpu_torch.format import bytes_util as bu


@dataclasses.dataclass
class TDPS:
    data_type: DataType
    ds_length: int
    intervals: int
    median_value: float
    req_length: int
    real_precision: float  # double
    type_array: bytes  # framed huffman stream
    lead_num: bytes  # 2-bit packed
    exact_mid_bytes: bytes
    residual_mid_bits: bytes
    exact_data_num: int
    max_quant_intervals: int = 65536
    # PW_REL extras
    rad_expo: int = 0
    segment_size: int = 0
    pwr_err_bound_bytes: bytes = b""
    min_log_value: float = 0.0
    is_pwr: bool = False
    # MSST19 extras
    msst19: bool = False
    plus_bits: int = 0
    max_bits: int = 0


def to_bytes(t: TDPS, size_type: int = 8) -> bytes:
    out = bytearray()
    out += bu.u32_be(t.max_quant_intervals)
    if t.is_pwr:
        out += bytes([t.rad_expo & 0xFF])
        out += bu.size_be(t.segment_size, size_type)
        out += bu.u32_be(len(t.pwr_err_bound_bytes))
    out += bu.u32_be(t.intervals)
    if t.data_type == DataType.FLOAT:
        out += bu.f32_be(t.median_value)
    else:
        out += bu.f64_be(t.median_value)
    out += bytes([t.req_length & 0xFF])
    if t.is_pwr and t.msst19:
        out += bytes([t.plus_bits & 0xFF, t.max_bits & 0xFF])
    out += bu.f64_be(t.real_precision)
    out += bu.size_be(len(t.type_array), size_type)
    out += bu.size_be(t.exact_data_num, size_type)
    out += bu.size_be(len(t.exact_mid_bytes), size_type)
    if t.is_pwr:
        # minLogValue: f32 for float streams, f64 for double streams
        # (TightDataPointStorageD.c:458 doubleToBytes)
        if t.data_type == DataType.FLOAT:
            out += bu.f32_be(t.min_log_value)
        else:
            out += bu.f64_be(t.min_log_value)
    out += t.type_array
    if t.is_pwr:
        out += t.pwr_err_bound_bytes
    out += t.lead_num
    out += t.exact_mid_bytes
    out += t.residual_mid_bits
    return bytes(out)


def from_bytes(body: bytes, data_type: DataType, *, is_pwr: bool,
               msst19: bool, size_type: int = 8) -> TDPS:
    pos = 0
    max_quant = bu.read_u32_be(body, pos)
    pos += 4
    rad_expo = 0
    segment_size = 0
    pwr_size = 0
    if is_pwr:
        rad_expo = body[pos]
        pos += 1
        segment_size = bu.read_size_be(body, pos, size_type)
        pos += size_type
        pwr_size = bu.read_u32_be(body, pos)
        pos += 4
    intervals = bu.read_u32_be(body, pos)
    pos += 4
    if data_type == DataType.FLOAT:
        median = bu.read_f32_be(body, pos)
        pos += 4
    else:
        median = bu.read_f64_be(body, pos)
        pos += 8
    req_length = body[pos]
    pos += 1
    plus_bits = max_bits = 0
    if is_pwr and msst19:
        plus_bits = body[pos]
        max_bits = body[pos + 1]
        pos += 2
    real_precision = float(bu.read_f64_be(body, pos))
    pos += 8
    type_array_size = bu.read_size_be(body, pos, size_type)
    pos += size_type
    exact_data_num = bu.read_size_be(body, pos, size_type)
    pos += size_type
    exact_mid_size = bu.read_size_be(body, pos, size_type)
    pos += size_type
    min_log = 0.0
    if is_pwr:
        if data_type == DataType.FLOAT:
            min_log = float(bu.read_f32_be(body, pos))
            pos += 4
        else:
            min_log = float(bu.read_f64_be(body, pos))
            pos += 8
    type_array = body[pos:pos + type_array_size]
    pos += type_array_size
    pwr_bytes = b""
    if is_pwr:
        pwr_bytes = body[pos:pos + pwr_size]
        pos += pwr_size
    lead_size = (exact_data_num * 2 + 7) // 8
    lead = body[pos:pos + lead_size]
    pos += lead_size
    mid = body[pos:pos + exact_mid_size]
    pos += exact_mid_size
    resi = body[pos:]
    return TDPS(data_type=data_type, ds_length=0, intervals=intervals,
                median_value=float(median), req_length=req_length,
                real_precision=real_precision, type_array=type_array,
                lead_num=lead, exact_mid_bytes=mid, residual_mid_bits=resi,
                exact_data_num=exact_data_num,
                max_quant_intervals=max_quant, rad_expo=rad_expo,
                segment_size=segment_size, pwr_err_bound_bytes=pwr_bytes,
                min_log_value=min_log, is_pwr=is_pwr, msst19=msst19,
                plus_bits=plus_bits, max_bits=max_bits)

