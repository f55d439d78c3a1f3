"""The random-access block codec's host container (the port's copy of
``sz_tpu.core.rablock``): the reference's randomAccess=1 body, whose
blocks each carry their own Huffman stream (one shared table), so any
region decodes from its blocks alone.

Reference (float only upstream): SZ_compress_float_{1,2,3}D_MDQ_
decompression_random_access_with_blocked_regression (sz_float.c:8151,
8711, 9358), decompressDataSeries_float_{1,2,3}D_decompression_given_
areas_with_blocked_regression (szd_float.c:6567, 6872, 7213), the entry
SZ_decompress_args_randomaccess_float (szd_float.c:7597).

What differs from the regression codec: blocks of 256 / 16 / 6 a side
(rank 1 / 2 / 3), padded by edge replication; no strips between blocks
(every block predicts from itself alone); the quantizer in double; the
mean-flush code 1; the bound and the coefficient precisions as f64
big-endian; the per-block escape counts (int32) and Huffman stream
sizes (uint16) nested as whole SZ integer streams under ABS 0.5
(sz_float.c:10052-10095).

Here: the padding, the regression coefficients (float accumulation in
the C's order) and the predictor selection in numpy, vectorised over the
blocks; the coefficient chain, the per-block Huffman streams and their
decode in the host runtime (``host.c``); the type lattice's histogram
(K3) and the per-block quantization and reconstruction (K12 / K13,
``gpu/ra_engine.py``) on the device given; the nested integer streams
through ``framing``.
"""

from __future__ import annotations

import dataclasses
import struct

import numpy as np

from sz_tpu_torch import framing, native
from sz_tpu_torch.config import ErrorBoundMode
from sz_tpu_torch.core import optimizer as opt
from sz_tpu_torch.format import bytes_util as bu
from sz_tpu_torch.format import huffman
from sz_tpu_torch.gpu import device as devmod
from sz_tpu_torch.gpu import hist_kernel, ra_engine
from sz_tpu_torch.utils import trace as _tr

BLOCK_SIZE = {1: 256, 2: 16, 3: 6}
NOISE_FACTOR = {1: 0.5, 2: 0.81, 3: 1.22}
# `float rel_param_err` in C (sz_float.c:8323,8938,9654): the constant
# rounds to float32 before the double-precision products
REL_PARAM_ERR = {1: float(np.float32(0.1 / 2)),
                 2: float(np.float32(0.15 / 3)),
                 3: float(np.float32(0.025))}
COEFF_CAP = 65536
COEFF_RADIUS = COEFF_CAP // 2

F32 = np.float32
F64 = np.float64


def _num_blocks(shape, bs):
    return [(r - 1) // bs + 1 for r in shape]


def region_blocks(shape, bs: int, start, end) -> tuple:
    """The blocks that cover the region [start, end): their indices in
    raster order over their grid, that grid (blocks along each axis), the
    region's offset in the first block and its extents -- K13's
    selection and region."""
    nums = _num_blocks(shape, bs)
    sb = [s // bs for s in start]
    eb = [(e - 1) // bs + 1 for e in end]
    grids = np.meshgrid(*[np.arange(a, b) for a, b in zip(sb, eb)],
                        indexing="ij")
    sel = grids[0]
    for d in range(1, len(shape)):
        sel = sel * nums[d] + grids[d]
    grid = tuple(max(b - a, 0) for a, b in zip(sb, eb))
    lo = tuple(s - a * bs for s, a in zip(start, sb))
    ext = tuple(max(e - s, 0) for s, e in zip(start, end))
    return sel.ravel(), grid, lo, ext


def _padded_blocks(data: np.ndarray, bs: int) -> np.ndarray:
    """(nb, bs^rank) block array with per-dimension edge replication
    (the pointer-clamping fill of sz_float.c:9402-9417)."""
    rank = data.ndim
    nums = _num_blocks(data.shape, bs)
    idx = [np.minimum(np.arange(n * bs), r - 1)
           for n, r in zip(nums, data.shape)]
    P = data[np.ix_(*idx)]
    shp = []
    for n in nums:
        shp += [n, bs]
    perm = list(range(0, 2 * rank, 2)) + list(range(1, 2 * rank, 2))
    return np.ascontiguousarray(
        P.reshape(shp).transpose(perm)).reshape(int(np.prod(nums)),
                                                *([bs] * rank))


def _reg_coeffs(blocks: np.ndarray, rank: int, bs: int) -> np.ndarray:
    """Per-block least-squares plane coefficients, the serial
    accumulation order kept (sz_float.c:9419-9446; 2D :8763; 1D :8193)."""
    nb = blocks.shape[0]
    zeros = [np.zeros(nb, F32) for _ in range(rank + 1)]
    if rank == 3:
        fx, fy, fz, f = zeros
        for ii in range(bs):
            sum_x = np.zeros(nb, F32)
            for jj in range(bs):
                sum_y = np.zeros(nb, F32)
                for kk in range(bs):
                    cur = blocks[:, ii, jj, kk]
                    sum_y += cur
                    fz += cur * F32(kk)
                fy += sum_y * F32(jj)
                sum_x += sum_y
            fx += sum_x * F32(ii)
            f += sum_x
        coeff = F32(1.0 / (bs * bs * bs))
        a, b, c = ((2 * s / F32(bs - 1) - f) * F32(6) * coeff / F32(bs + 1)
                   for s in (fx, fy, fz))
        d = (f * coeff - (F32(bs - 1) * a / F32(2)
                          + F32(bs - 1) * b / F32(2)
                          + F32(bs - 1) * c / F32(2)))
        return np.stack([a, b, c, d], axis=1)
    if rank == 2:
        fx, fy, f = zeros
        for ii in range(bs):
            sum_x = np.zeros(nb, F32)
            for jj in range(bs):
                cur = blocks[:, ii, jj]
                sum_x += cur
                fy += cur * F32(jj)
            fx += sum_x * F32(ii)
            f += sum_x
        coeff = F32(1.0 / (bs * bs))
        a, b = ((2 * s / F32(bs - 1) - f) * F32(6) * coeff / F32(bs + 1)
                for s in (fx, fy))
        c = f * coeff - (F32(bs - 1) * a / F32(2) + F32(bs - 1) * b / F32(2))
        return np.stack([a, b, c], axis=1)
    fx, f = zeros
    for ii in range(bs):
        cur = blocks[:, ii]
        fx += cur * F32(ii)
        f += cur
    coeff = F32(1.0 / bs)
    a = (2 * fx / F32(bs - 1) - f) * F32(6) * coeff / F32(bs + 1)
    b = f * coeff - F32(bs - 1) * a / F32(2)
    return np.stack([a, b], axis=1)


def _acc(err32, step64):
    """err_sz += <double expr>: the float accumulator takes a double right
    side (sz_float.c:9535 uses fabs, not fabsf), so each step rounds
    double to float once."""
    return (err32.astype(F64) + step64).astype(F32)


def _select(blocks, coeffs, rank, bs, noise, use_mean, mean):
    """The predictor of each block from its sampled diagonal points: True
    for Lorenzo, False for regression."""
    nb = blocks.shape[0]
    err_sz = np.zeros(nb, F32)
    err_reg = np.zeros(nb, F32)
    noise64 = F64(F32(noise))
    mean32 = F32(mean)

    def sample(bufc, regc):
        nonlocal err_sz, err_reg
        bc = tuple(c - 1 for c in bufc)   # the buffer has a 1-cell border
        cur = blocks[(slice(None),) + bc]
        if rank == 3:
            bi, bj, bk = bc
            p = blocks[:, bi, bj, bk - 1] + blocks[:, bi, bj - 1, bk]
            p = p + blocks[:, bi - 1, bj, bk]
            p = p - blocks[:, bi, bj - 1, bk - 1]
            p = p - blocks[:, bi - 1, bj, bk - 1]
            p = p - blocks[:, bi - 1, bj - 1, bk]
            p = p + blocks[:, bi - 1, bj - 1, bk - 1]
            pr = (coeffs[:, 0] * F32(regc[0]) + coeffs[:, 1] * F32(regc[1])
                  + coeffs[:, 2] * F32(regc[2]) + coeffs[:, 3])
        elif rank == 2:
            bi, bj = bc
            p = blocks[:, bi, bj - 1] + blocks[:, bi - 1, bj] \
                - blocks[:, bi - 1, bj - 1]
            pr = (coeffs[:, 0] * F32(regc[0]) + coeffs[:, 1] * F32(regc[1])
                  + coeffs[:, 2])
        else:
            (bi,) = bc
            p = blocks[:, bi - 1]
            pr = coeffs[:, 0] * F32(regc[0]) + coeffs[:, 1]
        step = np.abs(p - cur).astype(F64) + noise64
        if use_mean:
            step = np.minimum(step, np.abs(mean32 - cur).astype(F64))
        err_sz = _acc(err_sz, step)
        err_reg = _acc(err_reg, np.abs(pr - cur).astype(F64))

    if rank == 3:
        for i in range(2, bs + 1):
            bmi = bs - i + 1
            sample((i, i, i), (i - 1, i - 1, i - 1))
            sample((i, i, bmi + 1), (i - 1, i - 1, bmi))
            sample((i, bmi + 1, i), (i - 1, bmi, i - 1))
            sample((i, bmi + 1, bmi + 1), (i - 1, bmi, bmi))
    elif rank == 2:
        for i in range(2, bs + 1):
            bmi = bs - i + 1
            sample((i, i), (i - 1, i - 1))
            sample((i, bmi + 1), (i - 1, bmi))
    else:
        sd = int(np.sqrt(bs)) + 1  # sz_float.c:8249
        for i in range(2, bs + 1, sd):
            sample((i,), (i - 1,))
    return ~(err_reg < err_sz)


def _decode_streams(tree, data, offsets, sizes, count: int) -> np.ndarray:
    """(len(offsets), count) symbols of per-block Huffman streams under
    one tree; a tree whose root is a leaf codes one symbol in no bits."""
    L, R, C, T = tree
    if T[0]:
        return np.full((len(offsets), count), int(C[0]), np.int32)
    return native.huff_tree_decode_blocks(L, R, C, T, data, offsets, sizes,
                                          count)


@dataclasses.dataclass
class RAStream:
    body: bytes
    intervals: int
    use_mean: bool
    reg_count: int
    total_unpred: int


@dataclasses.dataclass
class Blocks:
    """What K12 takes, and the container's other inputs: the padded
    blocks (nb, bs, ...) and their predictor (``indicator``: True for
    Lorenzo), the quantized coefficients of every block (zero on Lorenzo
    blocks), the interval count and the mean flush; the coefficient
    chain's types, escapes and precisions."""
    bs: int
    blocks: np.ndarray
    indicator: np.ndarray
    qc_full: np.ndarray
    intervals: int
    use_mean: bool
    mean: np.float32
    reg_count: int
    ctypes: np.ndarray
    cunpred: list
    precision: list


def prepare(data: np.ndarray, rp: float, cfg) -> Blocks:
    """The host stages before K12 (sz_float.c:9358-9712): padding, the
    regression coefficients, the interval optimizer and mean, the
    predictor selection and the coefficient chain."""
    rank = data.ndim
    if rank not in BLOCK_SIZE:
        raise ValueError(f"random-access codec: rank {rank}")
    data = np.ascontiguousarray(data, F32)
    bs = BLOCK_SIZE[rank]
    nb = int(np.prod(_num_blocks(data.shape, bs)))
    flat = data.reshape(-1)
    with _tr.trace("blocks"):
        blocks = _padded_blocks(data, bs)
        coeffs = _reg_coeffs(blocks, rank, bs)
    use_mean, mean = False, F32(0)
    with _tr.trace("optimizer"):
        if cfg.quantization_intervals == 0:
            fd = {1: opt.optimize_intervals_1d_freq_dense,
                  2: opt.optimize_intervals_2d_freq_dense,
                  3: opt.optimize_intervals_3d_freq_dense}[rank]
            intervals, dense_pos, max_freq, mean_freq = fd(
                flat, *data.shape, rp, cfg.max_range_radius,
                cfg.sample_distance, np.float32(cfg.pred_threshold), T=F32)
            use_mean = bool(mean_freq > 0.5) or bool(mean_freq > max_freq)
            if use_mean:
                # double-accumulated mean (sz_float.c:9471-9481)
                vals = flat[np.abs((flat - dense_pos).astype(F64)) < rp]
                if len(vals):
                    mean = F32(native.seq_sum(vals.astype(F64)) / len(vals))
        else:
            intervals = cfg.quantization_intervals
    with _tr.trace("select"):
        noise = F32(F64(rp) * NOISE_FACTOR[rank])
        indicator = _select(blocks, coeffs, rank, bs, noise, use_mean, mean)
        reg_idx = np.flatnonzero(~indicator)
    with _tr.trace("coeff_chain"):
        rel = REL_PARAM_ERR[rank]
        precision = [rel * rp / bs] * rank + [rel * rp]
        ctypes_, cunpred, qcoeffs = native.ra_coeff_chain(
            coeffs[reg_idx], precision, COEFF_CAP, COEFF_RADIUS)
        qc_full = np.zeros((nb, rank + 1), F32)
        qc_full[reg_idx] = qcoeffs
    return Blocks(bs=bs, blocks=blocks, indicator=indicator, qc_full=qc_full,
                  intervals=int(intervals), use_mean=use_mean, mean=mean,
                  reg_count=len(reg_idx), ctypes=ctypes_, cunpred=cunpred,
                  precision=precision)


def compress_ra(data: np.ndarray, real_precision, cfg, *,
                device, devices=None) -> RAStream:
    """The randomAccess body from the block-size field on (the caller
    frames it with the header and the element count); byte-equal to
    ``sz_tpu.core.rablock.compress_ra``, with ``n_devices`` too.
    ``devices`` splits the block batch's K12 and K3 over several devices
    (``ra_engine.encode_blocks``); the rest runs on ``device``."""
    dev = devmod.resolve(device)
    rank = data.ndim
    rp = float(real_precision)
    p = prepare(data, rp, cfg)
    bs, blocks, intervals = p.bs, p.blocks, p.intervals
    nb, ncell = blocks.shape[0], bs ** rank
    use_mean, mean, reg_count = p.use_mean, p.mean, p.reg_count
    indicator, ctypes_, cunpred, precision = (p.indicator, p.ctypes,
                                              p.cunpred, p.precision)

    parts = ra_engine.encode_blocks(blocks, indicator, p.qc_full, rank, bs,
                                    rp, intervals, use_mean, mean,
                                    device=dev, devices=devices)
    state_num = 2 * int(intervals)
    with _tr.trace("quantize"):
        hists = []
        for t in parts:
            with devmod.current(t.device):
                hists.append(hist_kernel.histogram(t.reshape(-1),
                                                   int(intervals) // 2))
        hist = sum(h.cpu().numpy().astype(np.int64) for h in hists)
    freq = np.zeros(2 * state_num, np.int64)
    m = min(hist_kernel.NBINS, 2 * state_num)
    freq[:m] = hist[:m]
    with _tr.trace("download"):
        types = [t.cpu().numpy() for t in parts]
        types = types[0] if len(types) == 1 else np.concatenate(types)
        del parts
    with _tr.trace("escapes"):
        esc_mask = types == 0
        bw_counts = esc_mask.sum(axis=1).astype(np.int32)
        unpred_arr = blocks.reshape(nb, ncell)[esc_mask]
        total_unpred = int(bw_counts.sum())
    with _tr.trace("huffman_tree"):
        tables = huffman.build_tables(None, state_num, freq=freq)
    with _tr.trace("bitpack"):
        sizes_u32, streams_blob = native.huff_encode_blocks(
            types, tables.code_hi, tables.code_lo, tables.code_len)
        bsizes = sizes_u32.astype(np.uint16)
    with _tr.trace("nested_streams"):
        cfg_int = dataclasses.replace(cfg,
                                      error_bound_mode=ErrorBoundMode.ABS,
                                      abs_err_bound=0.5)
        bw_blob = framing._compress_int(bw_counts, cfg_int, dev)
        sizes_blob = framing._compress_int(bsizes, cfg_int, dev)

    with _tr.trace("assemble"):
        out = bytearray()
        out += bu.i32_be(bs)
        out += bu.f64_be(rp)
        out += bu.i32_be(int(intervals))
        out += bu.i32_be(len(tables.tree_bytes))
        out += bu.i32_be(tables.node_count)
        out += tables.tree_bytes
        out += bytes([1 if use_mean else 0])
        out += bu.f32_le(mean)
        out += bu.pack_bits_1(indicator)
        if reg_count > 0:
            for e in range(rank + 1):
                ct = huffman.build_tables(ctypes_[e], 2 * COEFF_CAP)
                cenc = huffman.encode(ct, ctypes_[e])
                out += bu.f64_be(precision[e])
                out += bu.i32_be(COEFF_RADIUS)
                out += bu.i32_be(len(ct.tree_bytes))
                out += bu.i32_be(ct.node_count)
                out += ct.tree_bytes
                # sizeToBytes writes SZ_SIZE_TYPE bytes but the stream
                # advances sizeof(size_t) = 8 (sz_float.c:10040 quirk)
                sz_field = bu.size_be(len(cenc), cfg.size_type)
                out += sz_field + b"\x00" * (8 - len(sz_field))
                out += cenc
                out += bu.i32_be(len(cunpred[e]))
                out += np.asarray(cunpred[e], dtype="<f4").tobytes()
        out += struct.pack("<Q", total_unpred)
        out += struct.pack("<Q", len(bw_blob))
        out += bw_blob
        out += unpred_arr.astype("<f4").tobytes()
        out += struct.pack("<Q", len(sizes_blob))
        out += sizes_blob
        out += streams_blob
    return RAStream(body=bytes(out), intervals=int(intervals),
                    use_mean=use_mean, reg_count=reg_count,
                    total_unpred=total_unpred)


def decompress_ra(body, shape, start=None, end=None, size_type: int = 8, *,
                  device, as_tensor: bool = False, devices=None):
    """Decode the region [start, end) (per-dimension corners, end
    exclusive; None: the whole field) of a randomAccess body, touching
    only the blocks it covers (the given_areas decoders,
    szd_float.c:6567/6872/7213); bit-equal to
    ``sz_tpu.core.rablock.decompress_ra``, with ``n_devices`` too.
    ``devices`` splits the blocks' K13 over several devices by rows of
    the region (``ra_engine.decode_blocks``).  Returns float32 numpy, or
    the tensor on ``device`` when ``as_tensor``."""
    dev = devmod.resolve(device)
    shape = tuple(int(r) for r in shape)
    rank = len(shape)
    start = tuple(int(s) for s in (start if start is not None
                                   else (0,) * rank))
    end = tuple(int(e) for e in (end if end is not None else shape))
    body = memoryview(body)

    with _tr.trace("parse_body"):
        pos = 0
        bs = bu.read_i32_be(body, pos)
        nums = _num_blocks(shape, bs)
        nb = int(np.prod(nums))
        ncell = bs ** rank
        rp = float(bu.read_f64_be(body, pos + 4))
        intervals = bu.read_i32_be(body, pos + 12)
        tree_size = bu.read_i32_be(body, pos + 16)
        node_count = bu.read_i32_be(body, pos + 20)
        pos += 24
        tree = huffman.deserialize_tree(body[pos:pos + tree_size],
                                        node_count)
        pos += tree_size
        use_mean = body[pos]
        mean = bu.read_f32_le(body, pos + 1)
        pos += 5
        ind_len = (nb - 1) // 8 + 1
        indicator = bu.unpack_bits_1(body[pos:pos + ind_len],
                                     nb).astype(bool)
        pos += ind_len
        reg_count = int(np.count_nonzero(~indicator))
        nc = rank + 1
        ctypes_ = np.zeros((nc, max(reg_count, 1)), np.int32)
        cunpred = [np.zeros(0, F32)] * nc
        precision = np.zeros(nc, F64)
        cradius = np.zeros(nc, np.int64)
        if reg_count > 0:
            for e in range(nc):
                precision[e] = bu.read_f64_be(body, pos)
                cradius[e] = bu.read_i32_be(body, pos + 8)
                tsz = bu.read_i32_be(body, pos + 12)
                ncnt = bu.read_i32_be(body, pos + 16)
                pos += 20
                ctree = huffman.deserialize_tree(body[pos:pos + tsz], ncnt)
                pos += tsz
                tasz = bu.read_size_be(body, pos, size_type)
                pos += 8   # the sizeof(size_t) advance quirk
                ctypes_[e] = _decode_streams(ctree, body, [pos], [tasz],
                                             reg_count)[0]
                pos += tasz
                ucnt = bu.read_i32_be(body, pos)
                pos += 4
                cunpred[e] = np.frombuffer(body, dtype="<f4", count=ucnt,
                                           offset=pos).copy()
                pos += 4 * ucnt
        total_unpred, bw_size = struct.unpack_from("<QQ", body, pos)
        pos += 16
    with _tr.trace("nested_streams"):
        bw_counts = framing._decompress_int(bytes(body[pos:pos + bw_size]),
                                            nb, np.int32, dev)
        pos += bw_size
        unpred = np.frombuffer(body, dtype="<f4", count=total_unpred,
                               offset=pos).copy()
        pos += 4 * total_unpred
        ts_size = struct.unpack_from("<Q", body, pos)[0]
        pos += 8
        bsizes = framing._decompress_int(bytes(body[pos:pos + ts_size]), nb,
                                         np.uint16, dev)
        pos += ts_size
    stream_base = pos

    with _tr.trace("coeff_chain"):
        qcoeffs = native.ra_coeff_chain_decode(ctypes_, precision, cradius,
                                               cunpred, reg_count)
        qc_full = np.zeros((nb, nc), F32)
        qc_full[np.flatnonzero(~indicator)] = qcoeffs
    unpred_offsets = np.concatenate(
        [[0], np.cumsum(bw_counts.astype(np.int64))])
    stream_offsets = np.concatenate([[0], np.cumsum(bsizes.astype(np.int64))])

    sel, grid, lo, ext = region_blocks(shape, bs, start, end)
    with _tr.trace("huffman_blocks"):
        types = _decode_streams(tree, body, stream_base + stream_offsets[sel],
                                bsizes[sel].astype(np.int64), ncell)
    out = ra_engine.decode_blocks(
        types, rank, bs, indicator[sel], qc_full[sel], rp,
        int(intervals) // 2, bool(use_mean), F32(mean), unpred,
        unpred_offsets[sel], grid, lo, ext, device=dev, devices=devices)
    if as_tensor:
        return out
    with _tr.trace("download"):
        return out.cpu().numpy()
