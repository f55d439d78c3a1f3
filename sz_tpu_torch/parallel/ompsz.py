"""sz_omp byte-format codec — SZ_compress_float_3D_MDQ_openmp parity (the
port's copy of ``sz_tpu.parallel.ompsz``).

The reference's OpenMP codec (sz_omp.c:63) splits the grid into a
2^a x 2^b x 2^c thread grid, compresses each block independently with
the block-local classic kernel (SZ_compress_float_3D_MDQ_RA_block,
sz_float.c:4704: first element predicted from itself via the "mean"
seed, raw escape values, no cross-block strips), merges per-thread
histograms into ONE shared Huffman tree (Huffman_init_openmp,
sz_omp.c:1049 — identical tree to the serial build from merged
frequencies), and concatenates per-block streams with exclusive-scan
offsets.  This module reproduces that byte format exactly, on the host as
``sz_tpu`` does: each block's recurrence is the host runtime's
(``native/host.c`` ``ompblock_encode_*`` / ``ompblock_decode_*``), the
blocks run at once on a thread pool (the C releases the GIL), and the
per-block Huffman streams are packed and decoded by the host runtime too.
The card's form of the same idea, self-contained slab streams each
compressed where its slab lies, is ``parallel/slab.py``.

Stream layout (sz_omp.c:233-325):
  [3B version][sameByte][params][thread_num i32BE][realPrecision f32BE]
  [intervals i32BE][treeSize i32BE][nodeCount i32BE][tree]
  [unpredictable_count u32 LE x blocks][mean f32 LE x blocks]
  [unpred f32 LE x total][block_sizes u64 LE x blocks][block streams]
"""

from __future__ import annotations

import concurrent.futures as _cf
import math

import numpy as np

from sz_tpu_torch import native
from sz_tpu_torch.config import DEFAULT_CONFIG, DataType, SZConfig
from sz_tpu_torch.core import classic_nd
from sz_tpu_torch.format import bytes_util as bu
from sz_tpu_torch.format import huffman
from sz_tpu_torch.format import metadata as md

F32 = np.float32


def thread_grid(thread_num: int):
    """2^a x 2^b x 2^c factorization (sz_omp.c:90-118)."""
    order = int(math.log2(thread_num))
    b = order // 3
    rem = order % 3
    if rem == 0:
        nx, ny = 1 << b, 1 << b
    elif rem == 1:
        nx, ny = 1 << (b + 1), 1 << b
    else:
        nx, ny = 1 << (b + 1), 1 << (b + 1)
    nz = (1 << order) // (nx * ny)
    return nx, ny, nz


def _block_counts(r: int, num: int):
    """SZ_COMPUTE_BLOCKCOUNT (sz.h:117): split by block COUNT."""
    early = late = r // num
    split = r % num
    if split:
        early += 1
    return split, early, late


def _block_ranges(r: int, num: int):
    split, early, late = _block_counts(r, num)
    offs, cnts = [], []
    for i in range(num):
        if i < split:
            offs.append(i * early)
            cnts.append(early)
        else:
            offs.append(i * late + split)
            cnts.append(late)
    return offs, cnts


def _encode_streams(tables, block_types) -> list:
    """Each block's types packed with the shared code, byte-aligned
    (Huffman.c:205's encode, a block at a time)."""
    out = []
    for t in block_types:
        _sizes, data = native.huff_encode_blocks(
            np.asarray(t, np.int32).reshape(1, -1), tables.code_hi,
            tables.code_lo, tables.code_len)
        out.append(data)
    return out


def compress_omp(data: np.ndarray, real_precision, thread_num: int = 4,
                 cfg: SZConfig = DEFAULT_CONFIG) -> bytes:
    """SZ_compress_{float,double}_3D_MDQ_openmp byte-format analog."""
    if data.dtype == np.float64:
        return _compress_omp_d(data, real_precision, thread_num, cfg)
    data = np.ascontiguousarray(data, F32)
    assert data.ndim == 3, "the reference OpenMP float codec is 3D-only"
    r1, r2, r3 = data.shape
    rp = F32(real_precision)  # the entry takes a C float

    if cfg.quantization_intervals == 0:
        intervals = classic_nd.optimize_intervals(
            data, float(real_precision), cfg.max_range_radius,
            cfg.sample_distance, np.float32(cfg.pred_threshold))
    else:
        intervals = cfg.quantization_intervals
    radius = intervals // 2

    nx, ny, nz = thread_grid(thread_num)
    thread_num = nx * ny * nz
    xo, xc = _block_ranges(r1, nx)
    yo, yc = _block_ranges(r2, ny)
    zo, zc = _block_ranges(r3, nz)

    num_elements = r1 * r2 * r3
    result_type = np.zeros(num_elements, np.int32)
    means = np.zeros(thread_num, F32)

    def _one(tid):
        i = tid // (ny * nz)
        j = (tid % (ny * nz)) // nz
        k = tid % nz
        block = np.ascontiguousarray(
            data[xo[i]:xo[i] + xc[i], yo[j]:yo[j] + yc[j],
                 zo[k]:zo[k] + zc[k]])
        means[tid] = block[0, 0, 0]
        t, u = native.ompblock_encode(block, rp, intervals, radius)
        # type array layout (sz_omp.c:183): block-major at type_offset
        toff = (xo[i] * r2 * r3 + yo[j] * xc[i] * r3
                + zo[k] * xc[i] * yc[j])
        result_type[toff:toff + t.size] = t
        return t, u

    # blocks are independent; the native kernels release the GIL, so a
    # thread pool mirrors the reference's OpenMP parallel-for (with
    # deterministic output: blocks write disjoint slices)
    with _cf.ThreadPoolExecutor() as _ex:
        results = list(_ex.map(_one, range(thread_num)))
    block_types = [t for t, _ in results]
    unpreds = [u for _, u in results]

    state_num = 2 * int(intervals)
    tables = huffman.build_tables(result_type, state_num)

    out = bytearray()
    out += md.make_header(cfg, DataType.FLOAT, F32(0), F32(0),
                          regression=True)
    out += bu.i32_be(thread_num)
    out += bu.f32_be(rp)
    out += bu.i32_be(int(intervals))
    out += bu.i32_be(len(tables.tree_bytes))
    out += bu.i32_be(tables.node_count)
    out += tables.tree_bytes
    out += np.array([len(u) for u in unpreds],
                    dtype="<u4").tobytes()
    out += means.astype("<f4").tobytes()
    for u in unpreds:
        out += u.astype("<f4").tobytes()
    streams = _encode_streams(tables, block_types)
    out += np.array([len(s) for s in streams], dtype="<u8").tobytes()
    for s in streams:
        out += s
    return bytes(out)


def _compress_omp_d(data: np.ndarray, real_precision, thread_num: int,
                    cfg: SZConfig) -> bytes:
    """SZ_compress_double_3D_MDQ_openmp (sz_omp.c:578).  Upstream
    quirk replicated: initRandomAccessBytes writes the 36-byte double
    params block but the payload starts at 3+1+MetaDataByteLength
    (the FLOAT length, 28) — the params tail is overwritten
    (sz_omp.c:733 `meta_data_offset = 3 + 1 + MetaDataByteLength`)."""
    data = np.ascontiguousarray(data, np.float64)
    assert data.ndim == 3
    r1, r2, r3 = data.shape
    rp64 = np.float64(real_precision)

    if cfg.quantization_intervals == 0:
        intervals = classic_nd.optimize_intervals(
            data, float(real_precision), cfg.max_range_radius,
            cfg.sample_distance, np.float64(cfg.pred_threshold))
    else:
        intervals = cfg.quantization_intervals
    radius = intervals // 2

    nx, ny, nz = thread_grid(thread_num)
    thread_num = nx * ny * nz
    xo, xc = _block_ranges(r1, nx)
    yo, yc = _block_ranges(r2, ny)
    zo, zc = _block_ranges(r3, nz)

    num_elements = r1 * r2 * r3
    result_type = np.zeros(num_elements, np.int32)
    means = np.zeros(thread_num, np.float64)

    def _one(tid):
        i = tid // (ny * nz)
        j = (tid % (ny * nz)) // nz
        k = tid % nz
        block = np.ascontiguousarray(
            data[xo[i]:xo[i] + xc[i], yo[j]:yo[j] + yc[j],
                 zo[k]:zo[k] + zc[k]])
        means[tid] = block[0, 0, 0]
        t, u = native.ompblock_encode(block, rp64, intervals, radius)
        toff = (xo[i] * r2 * r3 + yo[j] * xc[i] * r3
                + zo[k] * xc[i] * yc[j])
        result_type[toff:toff + t.size] = t
        return t, u

    with _cf.ThreadPoolExecutor() as _ex:
        results = list(_ex.map(_one, range(thread_num)))
    block_types = [t for t, _ in results]
    unpreds = [u for _, u in results]

    state_num = 2 * int(intervals)
    tables = huffman.build_tables(result_type, state_num)

    out = bytearray()
    out += md.make_header(cfg, DataType.DOUBLE, np.float64(0),
                          np.float64(0), regression=True)[:32]
    out += bu.i32_be(thread_num)
    out += bu.f64_be(rp64)
    out += bu.i32_be(int(intervals))
    out += bu.i32_be(len(tables.tree_bytes))
    out += bu.i32_be(tables.node_count)
    out += tables.tree_bytes
    out += np.array([len(u) for u in unpreds], dtype="<u4").tobytes()
    out += means.astype("<f8").tobytes()
    for u in unpreds:
        out += u.astype("<f8").tobytes()
    streams = _encode_streams(tables, block_types)
    out += np.array([len(s) for s in streams], dtype="<u8").tobytes()
    for s in streams:
        out += s
    return bytes(out)


def _decompress_omp_d(blob: bytes, shape) -> np.ndarray:
    """decompressDataSeries_double_3D_openmp analog (sz_omp.c:872)."""
    r1, r2, r3 = (int(s) for s in shape)
    pos = 32  # 3 + 1 + MetaDataByteLength (float length — see quirk)
    thread_num = bu.read_i32_be(blob, pos)
    pos += 4
    rp64 = np.float64(bu.read_f64_be(blob, pos))
    pos += 8
    intervals = bu.read_i32_be(blob, pos)
    pos += 4
    tree_size = bu.read_i32_be(blob, pos)
    pos += 4
    node_count = bu.read_i32_be(blob, pos)
    pos += 4
    L, R, C, Tt = huffman.deserialize_tree(blob[pos:pos + tree_size],
                                           node_count)
    pos += tree_size
    radius = intervals // 2

    nx, ny, nz = thread_grid(thread_num)
    nb = nx * ny * nz
    xo, xc = _block_ranges(r1, nx)
    yo, yc = _block_ranges(r2, ny)
    zo, zc = _block_ranges(r3, nz)

    ucnt = np.frombuffer(blob, dtype="<u4", count=nb, offset=pos)
    pos += 4 * nb
    means = np.frombuffer(blob, dtype="<f8", count=nb, offset=pos)
    pos += 8 * nb
    total_unpred = int(ucnt.sum())
    unpred = np.frombuffer(blob, dtype="<f8", count=total_unpred,
                           offset=pos)
    pos += 8 * total_unpred
    uoff = np.concatenate([[0], np.cumsum(ucnt.astype(np.int64))])
    bsizes = np.frombuffer(blob, dtype="<u8", count=nb, offset=pos)
    pos += 8 * nb
    boff = np.concatenate([[0], np.cumsum(bsizes.astype(np.int64))])

    out = np.zeros((r1, r2, r3), np.float64)

    def _one(tid):
        i = tid // (ny * nz)
        j = (tid % (ny * nz)) // nz
        k = tid % nz
        bshape = (xc[i], yc[j], zc[k])
        n = int(np.prod(bshape))
        a = pos + int(boff[tid])
        types = native.huff_tree_decode_blocks(
            L, R, C, Tt, blob, np.array([a]), bsizes[tid:tid + 1], n)[0]
        u = unpred[int(uoff[tid]):int(uoff[tid + 1])]
        out[xo[i]:xo[i] + bshape[0], yo[j]:yo[j] + bshape[1],
            zo[k]:zo[k] + bshape[2]] = native.ompblock_decode(
            types, bshape, means[tid], rp64, radius, u, np.float64)

    with _cf.ThreadPoolExecutor() as _ex:
        list(_ex.map(_one, range(nb)))
    return out


def decompress_omp(blob: bytes, shape, dtype=np.float32) -> np.ndarray:
    """decompressDataSeries_float_3D_openmp analog (sz_omp.c:366)."""
    if np.dtype(dtype) == np.float64:
        return _decompress_omp_d(blob, shape)
    r1, r2, r3 = (int(s) for s in shape)
    mlen = md.meta_length(DataType.FLOAT)
    pos = 4 + mlen
    thread_num = bu.read_i32_be(blob, pos)
    pos += 4
    rp = bu.read_f32_be(blob, pos)
    pos += 4
    intervals = bu.read_i32_be(blob, pos)
    pos += 4
    tree_size = bu.read_i32_be(blob, pos)
    pos += 4
    node_count = bu.read_i32_be(blob, pos)
    pos += 4
    L, R, C, Tt = huffman.deserialize_tree(blob[pos:pos + tree_size],
                                           node_count)
    pos += tree_size
    radius = intervals // 2

    nx, ny, nz = thread_grid(thread_num)
    nb = nx * ny * nz
    xo, xc = _block_ranges(r1, nx)
    yo, yc = _block_ranges(r2, ny)
    zo, zc = _block_ranges(r3, nz)

    ucnt = np.frombuffer(blob, dtype="<u4", count=nb, offset=pos)
    pos += 4 * nb
    means = np.frombuffer(blob, dtype="<f4", count=nb, offset=pos)
    pos += 4 * nb
    total_unpred = int(ucnt.sum())
    unpred = np.frombuffer(blob, dtype="<f4", count=total_unpred,
                           offset=pos)
    pos += 4 * total_unpred
    uoff = np.concatenate([[0], np.cumsum(ucnt.astype(np.int64))])
    bsizes = np.frombuffer(blob, dtype="<u8", count=nb, offset=pos)
    pos += 8 * nb
    boff = np.concatenate([[0], np.cumsum(bsizes.astype(np.int64))])

    out = np.zeros((r1, r2, r3), F32)

    def _one(tid):
        i = tid // (ny * nz)
        j = (tid % (ny * nz)) // nz
        k = tid % nz
        bshape = (xc[i], yc[j], zc[k])
        n = int(np.prod(bshape))
        a = pos + int(boff[tid])
        types = native.huff_tree_decode_blocks(
            L, R, C, Tt, blob, np.array([a]), bsizes[tid:tid + 1], n)[0]
        u = unpred[int(uoff[tid]):int(uoff[tid + 1])]
        out[xo[i]:xo[i] + bshape[0], yo[j]:yo[j] + bshape[1],
            zo[k]:zo[k] + bshape[2]] = native.ompblock_decode(
            types, bshape, means[tid], rp, radius, u, F32)

    with _cf.ThreadPoolExecutor() as _ex:
        list(_ex.map(_one, range(nb)))
    return out
