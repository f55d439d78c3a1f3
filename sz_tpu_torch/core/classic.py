"""The classic SZ1.4 container's host stages (the port's copy of
``sz_tpu.core.classic``): the exact-value escape stream, float32 and
float64, raw (MSST19) or offset by the median (the classic codec), and
the classic 1-D codec.

Escapes store the value's binary representation truncated to
``req_length`` bits, with leading-byte dedup against the previous escape
(addExactData dataCompression.c:575, updateLossyCompElement
CompressElement.c:230); the batched stream and its decode run in the host
runtime (``native/host.c``).

The 1-D codec (SZ_compress_float_1D_MDQ sz_float.c:353-524,
SZ_compress_double_1D_MDQ sz_double.c:260-395, decompressDataSeries_
float_1D szd_float.c:185) predicts each value from the previous
reconstruction: a serial recurrence, which runs in ``host.c`` as in the
JAX package.  Its type stream's histogram (K3), Huffman bit-pack (K4) and
Huffman decode (K5-K7) run on the device given.  Float and double differ
on purpose: float state = ((int)(err*recip + 1)) >> 1 with a
machine-epsilon recheck, double state = (int)((err*recip + 1) * 0.5)
without one.
"""

from __future__ import annotations

import numpy as np
import torch

from sz_tpu_torch import native
from sz_tpu_torch import state as state_mod
from sz_tpu_torch.config import data_type, float_type
from sz_tpu_torch.core.optimizer import intervals_from_errors
from sz_tpu_torch.format import bytes_util as bu
from sz_tpu_torch.format import huffman
from sz_tpu_torch.format.tdps import TDPS
from sz_tpu_torch.gpu import device as devmod
from sz_tpu_torch.gpu import fsm_kernel, hist_kernel, pack_kernel
from sz_tpu_torch.utils import trace as _tr


def get_exponent(value, T) -> int:
    """The unbiased binary exponent of ``value`` as a ``T``
    (getExponent_float/_double, ByteToolkit.c:308-360)."""
    if T is np.float32:
        bits = np.float32(value).view(np.int32)
        return int((int(bits) & 0x7F800000) >> 23) - 127
    bits = np.float64(value).view(np.int64)
    return int((int(bits) & 0x7FF0000000000000) >> 52) - 1023


def compute_req_length(real_precision: float, rad_expo: int, T):
    """The escapes' kept bits (sz_float.c:44-56): (req_length,
    median_zeroed); past the type's width the median offset is
    dropped."""
    req_expo = get_exponent(np.float64(real_precision), np.float64)
    if T is np.float32:
        req, lo, hi = 9 + rad_expo - req_expo + 1, 9, 32
    else:
        req, lo, hi = 12 + rad_expo - req_expo, 12, 64
    if req > hi:
        return hi, True
    return max(req, lo), False


def req_length_median(rp, value_range, median, T):
    """(req_length, median) of a classic stream: the kept bits of an
    escape, and the median, zeroed where req_length is clamped to the
    type's width."""
    rad_expo = get_exponent(T(value_range) / T(2), T)
    req_length, median_zeroed = compute_req_length(float(rp), rad_expo, T)
    return req_length, T(0) if median_zeroed else T(median)


class ExactEncoder:
    """Escape-value stream builder in ``T``; ``median`` None is the raw
    form (MSST19: no offset)."""

    def __init__(self, req_length: int, median=None, T=np.float32):
        self.req_length = req_length
        self.resi_bits_len = req_length % 8
        self.T = T
        self.raw = median is None
        self.median = T(0) if median is None else T(median)
        self.prev = bytes(np.dtype(T).itemsize)
        self._lead = []
        self.mid_bytes = bytearray()
        self._resi = []

    def exact_count(self) -> int:
        return sum(len(a) for a in self._lead)

    def add_batch(self, values) -> np.ndarray:
        """Append ``values`` in order; returns their reconstructions."""
        vals = np.ascontiguousarray(values, dtype=self.T)
        if vals.size == 0:
            return vals
        lead, mid, resi, recon, prev = native.exact_stream(
            vals, self.req_length, self.median, self.raw, self.prev)
        self.add_parts(lead, mid, resi)
        self.prev = prev
        return recon

    def add_parts(self, lead, mid: bytes, resi) -> None:
        """Append a stream the host runtime built whole (a 1-D encode)."""
        self._lead.append(lead)
        self.mid_bytes += mid
        if resi.size:
            self._resi.append(resi)

    def lead_packed(self) -> bytes:
        lead = (np.concatenate(self._lead) if self._lead
                else np.zeros(0, np.uint8))
        return bu.pack_bits_2(lead)

    def resi_packed(self) -> bytes:
        """convertIntArray2ByteArray_fast_dynamic (TypeManager.c:377):
        MSB-first fixed-width bitstream."""
        if self.resi_bits_len == 0 or not self._resi:
            return b""
        return native.pack_w_bits(np.concatenate(self._resi),
                                  self.resi_bits_len)


class ExactDecoder:
    """Inverse of :class:`ExactEncoder` over a TDPS's escape stream;
    ``raw`` False adds the stream's median."""

    def __init__(self, tdps, T=np.float32, raw: bool = True):
        self.T = T
        self.raw = raw
        self.median = T(tdps.median_value)
        self.req_length = tdps.req_length
        self.lead = bu.unpack_bits_2(tdps.lead_num, tdps.exact_data_num)
        self.mid = tdps.exact_mid_bytes
        self.resi = tdps.residual_mid_bits

    def next_batch(self, k: int) -> np.ndarray:
        """All ``k`` escape values at once; ``k`` must be the stream's
        escape count (``exact_data_num``), else the stream is corrupt."""
        if k != len(self.lead):
            raise ValueError(f"corrupt stream: {k} escapes coded, "
                             f"{len(self.lead)} stored")
        if k == 0:
            return np.zeros(0, dtype=self.T)
        return native.classic1d_decode(
            np.zeros(k, np.int32), self.T(0), 0, self.req_length,
            self.median, self.raw, self.lead, self.mid, self.resi, self.T)


# ---------------------------------------------------------------------------
# The type stream on the device: K3, the Huffman tree, K4; K5-K7
# ---------------------------------------------------------------------------

def encode_types(types, intervals: int, dev) -> tuple:
    """(framed Huffman type array, longest code) of a type stream (numpy
    or a tensor on ``dev``): the histogram (K3) and the bit-pack (K4) on
    the device, the tree on the host; equal to
    ``huffman.encode_with_tree_max_bits`` of the JAX package."""
    if torch.is_tensor(types):
        t = types.reshape(-1)
    else:
        with _tr.trace("upload"):
            t = torch.from_numpy(np.ascontiguousarray(
                types, np.int32).reshape(-1)).to(dev)
            devmod.sync(dev)
    with _tr.trace("quantize"):
        hist = hist_kernel.histogram(t, int(intervals) // 2).cpu().numpy()
    state_num = 2 * int(intervals)
    freq = np.zeros(2 * state_num, np.int64)
    m = min(hist_kernel.NBINS, 2 * state_num)
    freq[:m] = hist[:m]
    with _tr.trace("huffman_tree"):
        tables = huffman.build_tables(None, state_num, freq=freq)
    total_bits = int((freq[:len(tables.code_len)]
                      * tables.code_len.astype(np.int64)).sum())
    tt = state_mod.table_tensors(tables, dev)
    with _tr.trace("bitpack_device"):
        packed = pack_kernel.pack_bits(t, tt["code_hi"], tt["code_lo"],
                                       tt["code_len"], total_bits)
        devmod.sync(dev)
    with _tr.trace("stream_download"):
        body = packed.cpu().numpy().tobytes()
    type_array = (bu.u32_be(tables.node_count) + bu.u32_be(state_num // 2)
                  + tables.tree_bytes + body)
    return type_array, int(tables.code_len.max())


def decode_types(type_array, n: int, dev) -> torch.Tensor:
    """The int32 type stream of a framed Huffman type array, decoded on
    the device (K5-K7)."""
    with _tr.trace("stream_upload"):
        node_count = bu.read_u32_be(type_array, 0)
        tsize = huffman.tree_bytes_size(node_count)
        tree = huffman.deserialize_tree(type_array[8:8 + tsize], node_count)
        coded = fsm_kernel.upload((*tree, node_count),
                                  type_array[8 + tsize:], dev)
        devmod.sync(dev)
    with _tr.trace("huffman_device"):
        types, scans = fsm_kernel.decode_coded(coded, n, dev)
        devmod.sync(dev)
    _tr.count("fsm_scans", scans)
    return types


# ---------------------------------------------------------------------------
# The classic 1-D codec
# ---------------------------------------------------------------------------

def optimize_intervals_1d(flat: np.ndarray, real_precision: float,
                          max_range_radius: int, sample_distance: int,
                          pred_threshold) -> int:
    """optimize_intervals_float_1D_opt (sz_float.c:5070): previous-value
    prediction errors of every sample_distance-th value from index 2."""
    sidx = np.arange(2, len(flat), sample_distance, dtype=np.int64)
    pred_err = np.abs((flat[sidx - 1] - flat[sidx]).astype(np.float64))
    return intervals_from_errors(pred_err, len(sidx), float(real_precision),
                                 max_range_radius, pred_threshold)


def optimize_intervals_1d_subblock(flat: np.ndarray, real_precision: float,
                                   max_range_radius: int,
                                   sample_distance: int,
                                   pred_threshold) -> int:
    """optimize_intervals_float_1D_subblock (sz_float.c:3231): the 2a - b
    prediction errors of the values from index 2 whose local index is a
    multiple of sample_distance, of n // sample_distance samples."""
    sidx = np.arange(2, len(flat))
    sidx = sidx[sidx % sample_distance == 0]
    pred = 2 * flat[sidx - 1] - flat[sidx - 2]
    pred_err = np.abs((pred - flat[sidx]).astype(np.float64))
    return intervals_from_errors(pred_err, len(flat) // sample_distance,
                                 float(real_precision), max_range_radius,
                                 pred_threshold)


def compress_1d(data: np.ndarray, real_precision: float, value_range,
                median, *, max_range_radius: int, sample_distance: int,
                pred_threshold, opt_quant_mode: int = 1,
                fixed_intervals: int = 0, subblock: bool = False,
                device) -> TDPS:
    """The classic 1-D encode; the TDPS is byte-equal to
    ``sz_tpu.core.classic.compress_1d``'s.  ``subblock`` takes
    SZ_compress_args3's kernel (sz_float.c:3444): its own optimizer, the
    quantizer and the stored precision in double."""
    dev = devmod.resolve(device)
    T = float_type(data.dtype)
    flat = np.ascontiguousarray(data, dtype=T).reshape(-1)
    n = flat.size
    rp = T(real_precision)   # the float kernel receives float precision
    rp_kept = float(real_precision) if subblock else float(rp)
    if opt_quant_mode == 1:
        with _tr.trace("optimizer"):
            if subblock:
                intervals = optimize_intervals_1d_subblock(
                    flat, real_precision, max_range_radius,
                    sample_distance, pred_threshold)
            else:
                intervals = optimize_intervals_1d(
                    flat, float(rp), max_range_radius, sample_distance,
                    pred_threshold)
    else:
        intervals = fixed_intervals
    radius = intervals // 2
    req_length, median = req_length_median(rp_kept, value_range, median, T)
    with _tr.trace("quantize"):
        types, lead, mid, resi, _cnt = native.classic1d_encode(
            flat, rp, int(intervals), radius, req_length, median,
            subblock=subblock, rp64=float(real_precision))
    enc = ExactEncoder(req_length, median, T)
    enc.add_parts(lead, mid, resi)
    type_array, _ = encode_types(types, intervals, dev)
    return TDPS(
        data_type=data_type(T), ds_length=n, intervals=intervals,
        median_value=float(median), req_length=req_length,
        real_precision=rp_kept, type_array=type_array,
        lead_num=enc.lead_packed(), exact_mid_bytes=bytes(enc.mid_bytes),
        residual_mid_bits=enc.resi_packed(),
        exact_data_num=enc.exact_count(),
        max_quant_intervals=max_range_radius * 2)


def decompress_1d(tdps: TDPS, n: int, dtype, *, device) -> np.ndarray:
    """The classic 1-D decode, bit-equal to
    ``sz_tpu.core.classic.decompress_1d``: the types decoded on the
    device, the recurrence on the host."""
    dev = devmod.resolve(device)
    T = float_type(dtype)
    types = decode_types(tdps.type_array, n, dev)
    with _tr.trace("download"):
        types = types.cpu().numpy()
    radius = tdps.intervals // 2
    interval2 = (T(tdps.real_precision * 2) if T is np.float64
                 else T(np.float32(tdps.real_precision) * np.float32(2)))
    lead = bu.unpack_bits_2(tdps.lead_num, tdps.exact_data_num)
    if int((types == 0).sum()) != len(lead):
        raise ValueError("corrupt stream: the escape count differs from "
                         "the stored one")
    with _tr.trace("decode_fixpoint"):
        return native.classic1d_decode(
            types, interval2, radius, tdps.req_length, T(tdps.median_value),
            False, lead, tdps.exact_mid_bytes, tdps.residual_mid_bits, T)
