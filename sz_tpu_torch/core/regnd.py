"""Body layout and host stages of the SZ2.1 blocked-regression codec (the
port's copy of the parts of ``sz_tpu.core.regnd`` the main path runs).

Float32 only.  Reference kernels:
  3D: SZ_compress_float_3D_MDQ_nonblocked_with_blocked_regression
      (sz_float.c:6527) / decoder (szd_float.c:3483)
  2D: sz_float.c:5516 (block_size=16, 3 coeffs, use_mean forced 0,
      noise=0.81*eb)

The point quantization and reconstruction run on the card
(``sz_tpu_torch/gpu``); here are the per-rank constants, the region
iteration the device stages share, the coefficient chain (host runtime),
and the body's serialization and parsing.  The coefficients' Huffman
streams are packed and decoded by caller-supplied functions (the card's
K4 and K5-K7 on the main path), so no Huffman coding runs on the host.
"""

from __future__ import annotations

import dataclasses
import itertools
import struct

import numpy as np

from sz_tpu_torch import native
from sz_tpu_torch.core import blocks as B
from sz_tpu_torch.format import bytes_util as bu
from sz_tpu_torch.format import huffman

COEFF_CAPACITY = 65536
COEFF_RADIUS = COEFF_CAPACITY // 2


@dataclasses.dataclass
class EncodeResult:
    body: bytes
    quantization_intervals: int
    use_mean: bool
    reg_count: int
    total_unpred: int


@dataclasses.dataclass(frozen=True)
class _Spec:
    """Rank-dependent constants (float32)."""

    rank: int
    T: type  # numpy scalar type
    block_size: int
    ncoeff: int
    noise_factor: float
    rel_param_err_expr: float  # 0.025 (3D) | 0.15/3 (2D), as C double
    esize: int  # element byte size
    fmt_le: str = "<f4"


def _spec(rank: int, dtype) -> _Spec:
    if np.dtype(dtype) != np.float32:
        raise NotImplementedError("float64 is not ported yet (ROADMAP 1.3)")
    if rank == 3:
        return _Spec(3, np.float32, 6, 4, 1.22, 0.025, 4)
    if rank == 2:
        return _Spec(2, np.float32, 16, 3, 0.81, 0.15 / 3, 4)
    raise ValueError(f"rank {rank} unsupported by regression codec")


def _regions(db: B.DimBlocks):
    return [(0, db.split, db.early), (db.split, db.num, db.late)]


def _iter_regions(dbs):
    """Yield (ranges, lens) for the cartesian product of early/late regions."""
    for combo in itertools.product(*[_regions(db) for db in dbs]):
        ranges = [(c[0], c[1]) for c in combo]
        lens = [c[2] for c in combo]
        if all(r0 < r1 for r0, r1 in ranges):
            yield ranges, lens


def _flat_block_idx(dbs, ranges, nb):
    grids = np.meshgrid(*[np.arange(r0, r1) for r0, r1 in ranges],
                        indexing="ij")
    idx = grids[0]
    for d in range(1, len(dbs)):
        idx = idx * dbs[d].num + grids[d]
    return idx.ravel()


def quantize_coeff_chain(coeffs, use_reg, real_precision, dbs, spec: _Spec,
                         use_mean: bool):
    """Delta-quantize the regression blocks' coefficients in block order
    (sz_float.c:6787-6814).  Returns (ctypes[nc, nreg], unpred per coeff,
    qcoeffs[nreg, nc], precision[nc])."""
    T = spec.T
    rel = T(spec.rel_param_err_expr)
    precision = [T(rel * real_precision / T(db.late))
                 for db in dbs[:spec.rank]] + [T(rel * real_precision)]
    precision = np.array(precision, dtype=T)
    ct, ulist, qc = native.coeff_chain(
        np.ascontiguousarray(coeffs[np.flatnonzero(use_reg)], dtype=T),
        precision, use_mean, COEFF_CAPACITY, COEFF_RADIUS)
    return ct, [list(u) for u in ulist], qc, precision


def assemble_body(spec: _Spec, rp, quantization_intervals: int,
                  use_mean: bool, mean, use_reg, ctypes, cunpred, cprec,
                  unpred_arr, size_type: int, *, freq, tables,
                  encoded: bytes, encode_coeff_types) -> EncodeResult:
    """Serialize the regression-codec body (sz_float.c:7392-7473) from
    already-computed streams: the type histogram ``freq``, its Huffman
    ``tables`` and the packed type stream ``encoded``.
    ``encode_coeff_types(tables, symbols)`` Huffman-packs each
    coefficient's type stream to bytes (``huffman.encode``'s result)."""
    reg_count = int(np.count_nonzero(use_reg))
    total_unpred = len(unpred_arr)
    out = bytearray()
    out += bu.i32_be(spec.block_size)
    out += bu.f32_be(rp)
    out += bu.i32_be(quantization_intervals)
    out += bu.i32_be(len(tables.tree_bytes))
    out += bu.i32_be(tables.node_count)
    out += tables.tree_bytes
    out += bytes([1 if use_mean else 0])
    out += bu.f32_le(mean)
    out += bu.pack_bits_1(~np.asarray(use_reg, dtype=bool))
    if reg_count > 0:
        for e in range(spec.ncoeff):
            ct = huffman.build_tables(ctypes[e], 2 * COEFF_CAPACITY)
            cenc = encode_coeff_types(ct, ctypes[e])
            out += bu.f32_be(cprec[e])
            out += bu.i32_be(COEFF_RADIUS)
            out += bu.i32_be(len(ct.tree_bytes))
            out += bu.i32_be(ct.node_count)
            out += ct.tree_bytes
            out += bu.size_be(len(cenc), size_type)
            out += cenc
            out += bu.i32_be(len(cunpred[e]))
            out += np.array(cunpred[e], dtype=spec.fmt_le).tobytes()
    out += struct.pack("<Q", total_unpred)
    out += unpred_arr.astype(spec.fmt_le).tobytes()
    out += encoded
    return EncodeResult(body=bytes(out),
                        quantization_intervals=quantization_intervals,
                        use_mean=use_mean, reg_count=reg_count,
                        total_unpred=total_unpred)


@dataclasses.dataclass
class ParsedBody:
    """A regression-codec body before point reconstruction.  The type
    stream stays coded: ``tree`` and ``encoded`` carry it to the device
    decoder."""

    spec: object
    dbs: list
    rp: object
    intervals: int
    use_mean: int
    mean: object
    indicator: np.ndarray  # 1 = Lorenzo, 0 = regression, per block
    qcoeffs: np.ndarray    # reconstructed coeffs, one row per reg block
    unpred: np.ndarray     # escape values, stream order
    tree: tuple            # (L, R, C, T, node_count) of the type stream
    encoded: bytes         # the Huffman-coded type stream


def parse_body(body: bytes, shape, dtype, size_type: int,
               decode_coeff_types) -> ParsedBody:
    """Parse a body (``sz_tpu.core.regnd.parse_body`` with
    ``raw_types=True``).  ``decode_coeff_types(tree, encoded, count)``
    decodes each coefficient's Huffman-coded type stream to an int32
    array; ``tree`` is (L, R, C, T, node_count)."""
    rank = len(shape)
    spec = _spec(rank, dtype)
    T = spec.T
    pos = 0
    block_size = bu.read_i32_be(body, pos)
    pos += 4
    rp = bu.read_f32_be(body, pos)
    pos += 4
    intervals = bu.read_i32_be(body, pos)
    pos += 4
    tree_size = bu.read_i32_be(body, pos)
    pos += 4
    node_count = bu.read_i32_be(body, pos)
    pos += 4
    L, R, C, Tt = huffman.deserialize_tree(body[pos:pos + tree_size],
                                           node_count)
    pos += tree_size
    use_mean = body[pos]
    pos += 1
    mean = bu.read_f32_le(body, pos)
    pos += 4

    dbs = [B.dim_blocks(r, block_size) for r in shape]
    num_blocks = int(np.prod([db.num for db in dbs]))
    ind_len = (num_blocks - 1) // 8 + 1
    indicator = bu.unpack_bits_1(body[pos:pos + ind_len], num_blocks)
    pos += ind_len
    reg_count = int(np.count_nonzero(indicator == 0))

    nc = spec.ncoeff
    coeff_types = np.zeros((nc, reg_count), dtype=np.int32)
    coeff_unpred = [np.zeros(0, dtype=T)] * nc
    cprec = np.zeros(nc, dtype=T)
    cradius = np.zeros(nc, dtype=np.int64)
    if reg_count > 0:
        for e in range(nc):
            cprec[e] = bu.read_f32_be(body, pos)
            pos += 4
            cradius[e] = bu.read_i32_be(body, pos)
            pos += 4
            tsz = bu.read_i32_be(body, pos)
            pos += 4
            ncnt = bu.read_i32_be(body, pos)
            pos += 4
            ctree = huffman.deserialize_tree(body[pos:pos + tsz], ncnt)
            pos += tsz
            tasz = bu.read_size_be(body, pos, size_type)
            pos += size_type
            coeff_types[e] = decode_coeff_types(
                (*ctree, ncnt), body[pos:pos + tasz], reg_count)
            pos += tasz
            ucnt = bu.read_i32_be(body, pos)
            pos += 4
            coeff_unpred[e] = np.frombuffer(body, dtype=spec.fmt_le,
                                            count=ucnt, offset=pos).copy()
            pos += spec.esize * ucnt

    total_unpred = struct.unpack_from("<Q", body, pos)[0]
    pos += 8
    unpred = np.frombuffer(body, dtype=spec.fmt_le, count=total_unpred,
                           offset=pos)
    pos += spec.esize * total_unpred
    qcoeffs = native.coeff_chain_decode(coeff_types, cprec, cradius,
                                        coeff_unpred)
    return ParsedBody(spec=spec, dbs=dbs, rp=rp, intervals=intervals,
                      use_mean=use_mean, mean=mean, indicator=indicator,
                      qcoeffs=qcoeffs, unpred=unpred,
                      tree=(L, R, C, Tt, node_count), encoded=body[pos:])
