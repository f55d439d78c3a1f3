"""PaSTRI app codec — pattern-scaled compression of GAMESS two-electron
integral blocks (reference: sz/src/pastri.c:33, pastriD.h:483,
pastriF.h:483, pastriGeneral.h bit helpers).  The port's copy of
``sz_tpu.apps.pastri``: a host codec in numpy, as there.

Each block of bSize = sbSize*sbNum values is modeled as an outer product
of one pattern sub-block (sbSize) and per-sub-block scales (sbNum), all
quantized; residuals (ECQ) are mostly 0/±1 and bit-packed.  Four
encodings are chosen per block by projected size: UCSparse(0),
UCNonSparse(1), CSparse(2), CNonSparse(3) — LSB-first bit packing
(writeBits_Fast), little-endian fields.

Upstream quirks replicated for byte parity:
  * the batch header is the raw 72-byte pastri_params struct memcpy
    (pastri.c:41), including 4 padding bytes;
  * the float variant's projected sizes scale fixed header bytes by
    dataSize/8 (pastriF.h:150-160), under-counting the real 9-byte
    header, so float batch blocks can overlap; writes OR into the
    shared buffer exactly like writeBits_Fast on the calloc'd output;
  * mode-1 decode advances bSize*8 bytes even for floats
    (pastriF.h:601), desynchronizing float batches — kept bug-for-bug.
"""

from __future__ import annotations

import dataclasses
import struct

import numpy as np


# ---------------------------------------------------------------------------
# Parameters (pastri_params, pastri.h:63-80)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class PastriParams:
    bf: tuple  # 4 basis-function types
    original_eb: float
    data_size: int = 8  # 8 (double) | 4 (float)
    num_blocks: int = 1
    # derived (SZ_pastriPreprocessParameters, pastri.c:21)
    idx_range: tuple = None
    sb_size: int = 0
    sb_num: int = 0
    b_size: int = 0
    used_eb: float = 0.0

    def __post_init__(self):
        ir = tuple((b + 1) * (b + 2) // 2 for b in self.bf)
        self.idx_range = ir
        self.sb_size = ir[2] * ir[3]
        self.sb_num = ir[0] * ir[1]
        self.b_size = self.sb_size * self.sb_num
        self.used_eb = self.original_eb * 0.999

    def to_bytes(self) -> bytes:
        """Raw struct memcpy layout (72 bytes incl. tail padding)."""
        return struct.pack(
            "<ddii4i4iiii4x", self.original_eb, self.used_eb,
            self.num_blocks, self.data_size, *self.bf, *self.idx_range,
            self.sb_size, self.sb_num, self.b_size)

    @classmethod
    def from_bytes(cls, b: bytes) -> "PastriParams":
        vals = struct.unpack_from("<ddii4i4iiii", b, 0)
        p = cls(bf=tuple(vals[4:8]), original_eb=vals[0],
                data_size=vals[3], num_blocks=vals[2])
        # trust the serialized derived fields (they're what the
        # producer used)
        p.used_eb = vals[1]
        p.idx_range = tuple(vals[8:12])
        p.sb_size = vals[12]
        p.sb_num = vals[13]
        p.b_size = vals[14]
        return p


PARAMS_BYTES = 72


# ---------------------------------------------------------------------------
# Bit helpers (pastriGeneral.h)
# ---------------------------------------------------------------------------

def _bits_needed_double(x: float) -> int:
    """bitsNeeded_double: (((bits<<1)>>53)-1022) & (x!=0 mask)."""
    if x == 0:
        return 0
    u = np.float64(x).view(np.uint64)
    return int(((int(u) << 1) & 0xFFFFFFFFFFFFFFFF) >> 53) - 1022


def _bits_needed_float(x) -> int:
    """bitsNeeded_float: casts the float to double, same formula."""
    return _bits_needed_double(float(np.float32(x)))


def _bits_needed_u64(x: int) -> int:
    return int(x).bit_length()


class _BitWriter:
    """writeBits_Fast: LSB-first within a little-endian byte stream,
    OR-ing into the buffer (so overlapping float-batch writes replicate
    the upstream behavior)."""

    def __init__(self, buf: bytearray, base: int):
        self.buf = buf
        self.base = base
        self.pos = 0  # bits relative to base

    def write(self, nbits: int, value: int):
        v = int(value) & ((1 << nbits) - 1)
        bitpos = self.pos
        byte = self.base + (bitpos >> 3)
        shift = bitpos & 7
        acc = v << shift
        nb = (shift + nbits + 7) // 8
        for k in range(nb):
            self.buf[byte + k] |= (acc >> (8 * k)) & 0xFF
        self.pos += nbits


class _BitReader:
    def __init__(self, buf: bytes, base: int):
        self.buf = buf
        self.base = base
        self.pos = 0

    def read(self, nbits: int) -> int:
        bitpos = self.pos
        byte = self.base + (bitpos >> 3)
        shift = bitpos & 7
        acc = int.from_bytes(self.buf[byte:byte + 8], "little")
        self.pos += nbits
        return (acc >> shift) & ((1 << nbits) - 1)

    def read_signed(self, nbits: int) -> int:
        v = self.read(nbits)
        if nbits > 0 and v & (1 << (nbits - 1)):
            v -= 1 << nbits
        # clamp into int64 like the C locals (relevant only on desynced
        # float batches, where the reference decoder is equally UB)
        v &= 0xFFFFFFFFFFFFFFFF
        return v - (1 << 64) if v >= (1 << 63) else v


# ---------------------------------------------------------------------------
# Quantizers (pastriD.h:4, pastriF.h:4)
# ---------------------------------------------------------------------------

def _quantize_d(x: float, bin_size: float) -> int:
    y = np.float64(x) / np.float64(bin_size)
    half = 0.5 if not np.signbit(y) else -0.5
    return int(np.float64(y) + np.float64(half))  # trunc toward zero


def _quantize_f(x, bin_size) -> int:
    y = np.float32(x) / np.float32(bin_size)  # float division
    half = 0.5 if not np.signbit(y) else -0.5
    return int(np.float64(y) + np.float64(half))


def _mul_i64(a: int, b: int) -> int:
    """int64 product with C wraparound semantics."""
    v = (int(a) * int(b)) & 0xFFFFFFFFFFFFFFFF
    return v - (1 << 64) if v >= (1 << 63) else v


# ---------------------------------------------------------------------------
# Per-block compress (pastri_{double,float}_Compress)
# ---------------------------------------------------------------------------

def _pattern_match(data: np.ndarray, p: PastriParams, is_double: bool):
    eb = p.used_eb
    absd = np.abs(data.astype(np.float64))
    non_zeros = int(np.count_nonzero(absd > eb))
    # serial argmax with strict > (first max wins)
    ext_idx = int(np.argmax(absd)) if len(absd) else 0
    abs_ext = float(absd[ext_idx]) if len(absd) else 0.0
    pattern_idx = (ext_idx // p.sb_size) * p.sb_size
    pattern_ext = data[ext_idx]
    bin_size = 2 * eb  # double

    q = _quantize_d if is_double else _quantize_f
    patternQ = np.array(
        [q(data[pattern_idx + i], bin_size) for i in range(p.sb_size)],
        dtype=np.int64)

    if is_double:
        pattern_bits = _bits_needed_double(
            abs(float(pattern_ext)) / bin_size + 1) + 1
    else:
        pattern_bits = _bits_needed_float(
            np.float32(abs(float(pattern_ext)) / bin_size + 1)) + 1
    scale_bits = pattern_bits
    denom = (1 << (scale_bits - 1)) - 1
    if is_double:
        scales_bin_size = 1.0 / float(denom)
    else:
        scales_bin_size = float(np.float32(1.0) / np.float32(denom))

    local_ext = ext_idx % p.sb_size
    ext_zero = pattern_ext == 0
    scalesQ = np.zeros(p.sb_num, np.int64)
    for sb in range(p.sb_num):
        if ext_zero:
            v = 0.0
        elif is_double:
            v = float(data[sb * p.sb_size + local_ext]) \
                / float(pattern_ext)
        else:
            v = np.float32(data[sb * p.sb_size + local_ext]) \
                / np.float32(pattern_ext)
        scalesQ[sb] = (_quantize_d if is_double else _quantize_f)(
            v, scales_bin_size)

    ECQ = np.zeros(p.b_size, np.int64)
    if is_double:
        ps_bin = np.float64(scales_bin_size) * np.float64(bin_size)
    else:
        ps_bin = np.float32(np.float64(scales_bin_size)
                            * np.float64(bin_size))
    ecq_ext = 0
    ecq1s = 0
    ecq_others = 0
    for sb in range(p.sb_num):
        sq = int(scalesQ[sb])
        for i in range(p.sb_size):
            j = sb * p.sb_size + i
            prod = _mul_i64(sq, int(patternQ[i]))
            if is_double:
                v = np.float64(prod) * ps_bin - np.float64(data[j])
                e = _quantize_d(v, bin_size)
            else:
                v = np.float32(np.float32(prod) * ps_bin) \
                    - np.float32(data[j])
                e = _quantize_f(v, np.float32(bin_size))
            ECQ[j] = e
            ae = abs(e)
            if ae > ecq_ext:
                ecq_ext = ae
            if e == 1 or e == -1:
                ecq1s += 1
            elif e != 0:
                ecq_others += 1
    return dict(non_zeros=non_zeros, patternQ=patternQ, scalesQ=scalesQ,
                ECQ=ECQ, pattern_bits=pattern_bits,
                scale_bits=scale_bits, scales_bin_size=scales_bin_size,
                bin_size=bin_size, ecq_ext=ecq_ext, ecq1s=ecq1s,
                ecq_others=ecq_others)


def _encode_block(data: np.ndarray, p: PastriParams, bp: dict,
                  out: bytearray, base: int, is_double: bool) -> int:
    """pastri_*_Encode; returns numOutBytes (the projected size the
    batch advances by, even when the float variant under-counts)."""
    ecq_bits = _bits_needed_u64(bp["ecq_ext"]) + 1
    idx_bits = _bits_needed_u64(p.b_size)
    ds = p.data_size
    esize = 8 if is_double else 4
    nz = bp["non_zeros"]
    pb, sb_bits = bp["pattern_bits"], bp["scale_bits"]
    ecq1s, others = bp["ecq1s"], bp["ecq_others"]
    num_outliers = ecq1s + others

    uc_sparse = ds * (1 + 2 + nz * 16)
    uc_nonsparse = ds * (1 + p.b_size * 8)
    if ecq_bits == 2:
        c_sparse = (ds * (1 + 4 + 1 + 1 + 2) + pb * p.sb_size
                    + sb_bits * p.sb_num + ecq1s * (1 + idx_bits))
        c_nonsparse = (ds * (1 + 4 + 1 + 1) + pb * p.sb_size
                       + sb_bits * p.sb_num + p.b_size + ecq1s)
    else:
        c_sparse = (ds * (1 + 4 + 1 + 1 + 2) + pb * p.sb_size
                    + sb_bits * p.sb_num + ecq1s * (2 + idx_bits)
                    + others * (1 + idx_bits + ecq_bits))
        c_nonsparse = (ds * (1 + 4 + 1 + 1) + pb * p.sb_size
                       + sb_bits * p.sb_num + p.b_size + ecq1s * 2
                       + others * (1 + ecq_bits))
    ucs_b = (uc_sparse + 7) // 8
    ucn_b = (uc_nonsparse + 7) // 8
    cs_b = (c_sparse + 7) // 8
    cn_b = (c_nonsparse + 7) // 8
    ECQ = bp["ECQ"]
    fmt = "<d" if is_double else "<f"

    if ucs_b < ucn_b and ucs_b < cs_b and ucs_b < cn_b:
        out[base + 0] = 0
        struct.pack_into("<H", out, base + 1, nz)
        pos = base + 3
        ir = p.idx_range
        eb = p.used_eb
        for i0 in range(ir[0]):
            for i1 in range(ir[1]):
                for i2 in range(ir[2]):
                    for i3 in range(ir[3]):
                        j = ir[3] * (i2 + ir[2] * (i1 + i0 * ir[1])) + i3
                        if abs(float(data[j])) > eb:
                            struct.pack_into("<HHHH", out, pos,
                                             i0, i1, i2, i3)
                            pos += 8
                            struct.pack_into(fmt, out, pos, data[j])
                            pos += esize
        return ucs_b
    if ucn_b < ucs_b and ucn_b < cs_b and ucn_b < cn_b:
        out[base + 0] = 1
        raw = np.asarray(data).tobytes()
        out[base + 1:base + 1 + len(raw)] = raw
        return ucn_b
    if cs_b < ucn_b and cs_b < ucs_b and cs_b < cn_b:
        out[base + 0] = 2
        out[base + 5] = pb & 0xFF
        out[base + 6] = ecq_bits & 0xFF
        struct.pack_into("<H", out, base + 7, num_outliers)
        w = _BitWriter(out, base)
        w.pos = 9 * 8
        for v in bp["patternQ"]:
            w.write(pb, int(v))
        for v in bp["scalesQ"]:
            w.write(sb_bits, int(v))
        if ecq_bits == 2:
            for i in range(p.b_size):
                e = int(ECQ[i])
                if e == 1:
                    w.write(idx_bits, i)
                    w.write(1, 0)
                elif e == -1:
                    w.write(idx_bits, i)
                    w.write(1, 1)
        else:
            for i in range(p.b_size):
                e = int(ECQ[i])
                if e == 0:
                    continue
                w.write(idx_bits, i)
                if e == 1:
                    w.write(1, 0)
                    w.write(1, 0)
                elif e == -1:
                    w.write(1, 0)
                    w.write(1, 1)
                else:
                    w.write(1, 1)
                    w.write(ecq_bits, e)
        struct.pack_into("<I", out, base + 1, (w.pos + 7) // 8)
        return cs_b
    # CNonSparse
    out[base + 0] = 3
    out[base + 5] = pb & 0xFF
    out[base + 6] = ecq_bits & 0xFF
    w = _BitWriter(out, base)
    w.pos = 7 * 8
    for v in bp["patternQ"]:
        w.write(pb, int(v))
    for v in bp["scalesQ"]:
        w.write(sb_bits, int(v))
    if ecq_bits == 2:
        for i in range(p.b_size):
            e = int(ECQ[i])
            if e == 0:
                w.write(1, 1)
            elif e == 1:
                w.write(1, 0)
                w.write(1, 0)
            else:
                w.write(1, 0)
                w.write(1, 1)
    else:
        for i in range(p.b_size):
            e = int(ECQ[i])
            if e == 0:
                w.write(1, 1)
            elif e == 1:
                w.write(1, 0)
                w.write(1, 0)
                w.write(1, 0)
            elif e == -1:
                w.write(1, 0)
                w.write(1, 0)
                w.write(1, 1)
            else:
                w.write(1, 0)
                w.write(1, 1)
                w.write(ecq_bits, e)
    struct.pack_into("<I", out, base + 1, (w.pos + 7) // 8)
    return cn_b


# ---------------------------------------------------------------------------
# Per-block decode (pastri_*_Decode)
# ---------------------------------------------------------------------------

def _decode_block(buf: bytes, base: int, p: PastriParams,
                  is_double: bool):
    """Returns (values ndarray, numReadBytes)."""
    T = np.float64 if is_double else np.float32
    esize = 8 if is_double else 4
    idx_bits = _bits_needed_u64(p.b_size)
    mode = buf[base]
    data = np.zeros(p.b_size, T)
    if mode == 0:
        (nz,) = struct.unpack_from("<H", buf, base + 1)
        pos = base + 3
        ir = p.idx_range
        fmt = "<d" if is_double else "<f"
        for _ in range(nz):
            i0, i1, i2, i3 = struct.unpack_from("<HHHH", buf, pos)
            pos += 8
            j = ir[3] * (i2 + ir[2] * (i1 + i0 * ir[1])) + i3
            data[j] = struct.unpack_from(fmt, buf, pos)[0]
            pos += esize
        return data, pos - base
    if mode == 1:
        data = np.frombuffer(buf, dtype=T, count=p.b_size,
                             offset=base + 1).copy()
        # upstream advances bSize*8 regardless of dataSize
        # (pastriD.h:601 / pastriF.h:601) — kept bug-for-bug
        return data, p.b_size * 8
    pb = buf[base + 5]
    ecq_bits = buf[base + 6]
    patternQ = np.zeros(p.sb_size, np.int64)
    scalesQ = np.zeros(p.sb_num, np.int64)
    ECQ = np.zeros(p.b_size, np.int64)
    r = _BitReader(buf, base)
    if mode == 2:
        (num_outliers,) = struct.unpack_from("<H", buf, base + 7)
        r.pos = 9 * 8
    else:
        r.pos = 7 * 8
    for j in range(p.sb_size):
        patternQ[j] = r.read_signed(pb)
    for j in range(p.sb_num):
        scalesQ[j] = r.read_signed(pb)
    if mode == 2:
        # out-of-range indexes can only appear on desynced float
        # batches (upstream UB); drop them instead of faulting
        if ecq_bits == 2:
            for _ in range(num_outliers):
                j = r.read(idx_bits)
                v = 1 if r.read(1) == 0 else -1
                if j < p.b_size:
                    ECQ[j] = v
        else:
            for _ in range(num_outliers):
                j = r.read(idx_bits)
                if r.read(1) == 0:
                    v = 1 if r.read(1) == 0 else -1
                else:
                    v = r.read_signed(ecq_bits)
                if j < p.b_size:
                    ECQ[j] = v
    else:
        if ecq_bits == 2:
            for j in range(p.b_size):
                if r.read(1) == 0:
                    ECQ[j] = 1 if r.read(1) == 0 else -1
        else:
            for j in range(p.b_size):
                if r.read(1) == 1:
                    continue
                if r.read(1) == 0:
                    ECQ[j] = 1 if r.read(1) == 0 else -1
                else:
                    ECQ[j] = r.read_signed(ecq_bits)
    # PredictData (pastri_*_PredictData)
    denom = (1 << (pb - 1)) - 1
    if is_double:
        scales_bin = 1.0 / float(denom)
        bin_size = p.used_eb * 2
        ps_bin = np.float64(scales_bin) * np.float64(bin_size)
        prod = (scalesQ[np.arange(p.b_size) // p.sb_size]
                * patternQ[np.arange(p.b_size) % p.sb_size])
        data = (prod.astype(np.float64) * ps_bin
                - ECQ.astype(np.float64) * np.float64(bin_size))
    else:
        scales_bin = np.float32(1.0) / np.float32(denom)
        bin_size = p.used_eb * 2
        ps_bin = np.float32(np.float64(scales_bin) * np.float64(bin_size))
        prod = (scalesQ[np.arange(p.b_size) // p.sb_size]
                * patternQ[np.arange(p.b_size) % p.sb_size])
        data = (prod.astype(np.float32) * ps_bin
                - ECQ.astype(np.float32) * np.float32(bin_size)
                ).astype(np.float32)
    return data.astype(T), (r.pos + 7) // 8


# ---------------------------------------------------------------------------
# Batch drivers (SZ_pastriCompressBatch / SZ_pastriDecompressBatch)
# ---------------------------------------------------------------------------

def compress_batch(params: PastriParams, data: np.ndarray) -> bytes:
    """data: numBlocks * bSize values (f64 or f32 per params.data_size)."""
    is_double = params.data_size == 8
    T = np.float64 if is_double else np.float32
    data = np.ascontiguousarray(data, T).reshape(-1)
    assert data.size == params.num_blocks * params.b_size
    out = bytearray(params.num_blocks * params.b_size
                    * params.data_size + PARAMS_BYTES + 4096)
    out[:PARAMS_BYTES] = params.to_bytes()
    pos = PARAMS_BYTES
    for b in range(params.num_blocks):
        block = data[b * params.b_size:(b + 1) * params.b_size]
        bp = _pattern_match(block, params, is_double)
        nbytes = _encode_block(block, params, bp, out, pos, is_double)
        pos += nbytes
    return bytes(out[:pos])


def decompress_batch(blob: bytes):
    """Returns (PastriParams, values ndarray of numBlocks*bSize)."""
    p = PastriParams.from_bytes(blob)
    is_double = p.data_size == 8
    T = np.float64 if is_double else np.float32
    out = np.zeros(p.num_blocks * p.b_size, T)
    pos = PARAMS_BYTES
    for b in range(p.num_blocks):
        vals, nread = _decode_block(blob, pos, p, is_double)
        out[b * p.b_size:(b + 1) * p.b_size] = vals
        pos += nread
    return p, out
