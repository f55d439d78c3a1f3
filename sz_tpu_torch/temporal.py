"""Temporal (time-series) compression, multi-variable and multi-step (the
port's copy of ``sz_tpu.temporal``).

The reference's temporal mode (szMode=SZ_TEMPORAL_COMPRESSION, built with
HAVE_TIMECMPR): a registry of variables (SZ_registerVar sz.c:975,
VarSet.c), each variable's history, the previous step's reconstruction,
a choice per step between a snapshot (the classic spatial codec) and a
temporal step (every point predicted from the same index of the history,
SZ_compress_float_1D_MDQ_ts sz_float_ts.c:69), and one frame a step
(SZ_compress_ts sz.c:1071-1141):

    [currentStep u32 BE][var_count u16 LE]
    per var: [var_id u8][compressType u8][dataType u8]
             [compressedSize u64 LE][payload = full SZ stream]

Each variable's history is a tensor on the compressor's device in both
directions.  A temporal step is elementwise against it: K14
(``gpu/temporal_kernel.ts_quantize``) quantizes a step and rebuilds the
next history, K15 (``ts_decode``) restores one; the type stream runs
through K3/K4 (encode) and K5-K7 (decode), and only the optimizer's
samples, the escape values, the histogram and the coded streams cross
the link.  The escape values' ordered lead-byte chain is built on the
host.  Frames are byte-equal to ``sz_tpu.temporal.TemporalCompressor``'s
and decodes and histories bit-equal, in float32 and float64.
"""

from __future__ import annotations

import dataclasses
import struct

import numpy as np
import torch

from sz_tpu_torch import api, framing
from sz_tpu_torch.config import (CompressionType, DataType, ErrorBoundMode,
                                 SZConfig, SZMode, data_type, float_type,
                                 np_dtype)
from sz_tpu_torch.core import classic
from sz_tpu_torch.core.optimizer import round_up_to_power_of_2
from sz_tpu_torch.format import bytes_util as bu
from sz_tpu_torch.format import lossless as ll
from sz_tpu_torch.format import metadata as md
from sz_tpu_torch.format import tdps as tdps_mod
from sz_tpu_torch.format.tdps import TDPS
from sz_tpu_torch.gpu import device as devmod
from sz_tpu_torch.gpu import temporal_kernel as tk
from sz_tpu_torch.utils import trace as _tr

_TORCH = {np.float32: torch.float32, np.float64: torch.float64}


# ---------------------------------------------------------------------------
# The temporal 1-D codec (sz_float_ts.c:69-208 / sz_double_ts.c)
# ---------------------------------------------------------------------------

def _ts_sample_idx(n: int, sample_distance: int) -> np.ndarray:
    """Sampling indices of the ts optimizer walk (sz_float_ts.c:28)."""
    idx = np.arange(2, n)
    return idx[idx % sample_distance == 0]


def _optimize_1d_ts_tail(cur_s, prev_s, n, real_precision,
                         max_range_radius, sample_distance,
                         pred_threshold) -> int:
    """Histogram and selection over the sampled values (the float
    subtraction first, then the widening, as the reference does)."""
    rp = float(real_precision)
    pred_err = np.abs((prev_s - cur_s).astype(np.float64)) \
        .astype(cur_s.dtype)
    radius_index = ((pred_err.astype(np.float64) / rp + 1.0) / 2.0) \
        .astype(np.int64)
    np.minimum(radius_index, max_range_radius - 1, out=radius_index)
    hist = np.bincount(radius_index, minlength=max_range_radius)
    total = n // sample_distance
    target = int(total * pred_threshold)
    csum = np.cumsum(hist)
    over = np.flatnonzero(csum > target)
    i = int(over[0]) if len(over) else max_range_radius - 1
    return max(round_up_to_power_of_2(2 * (i + 1)), 32)


def optimize_intervals_1d_ts(flat, prev, real_precision, max_range_radius,
                             sample_distance, pred_threshold) -> int:
    """optimize_intervals_float_1D_ts (sz_float_ts.c:28).  ``flat`` and
    ``prev`` are numpy arrays or tensors; tensors are sampled where they
    lie (the indices made there) and the samples come down in one
    copy."""
    n = len(flat)
    if torch.is_tensor(flat):
        first = -(-2 // sample_distance) * sample_distance
        idx = torch.arange(first, max(first, n), sample_distance,
                           device=flat.device)
        cur_s, prev_s = torch.stack((flat[idx], prev[idx])).cpu().numpy()
    else:
        idx = _ts_sample_idx(n, sample_distance)
        cur_s, prev_s = flat[idx], prev[idx]
    return _optimize_1d_ts_tail(cur_s, prev_s, n, real_precision,
                                max_range_radius, sample_distance,
                                pred_threshold)


def _on(values, T, dev) -> torch.Tensor:
    """``values`` (numpy or a tensor) as a contiguous 1-D ``T`` tensor on
    ``dev``; a host array is uploaded once."""
    if torch.is_tensor(values) and values.device == dev:
        return values.reshape(-1).to(_TORCH[T]).contiguous()
    with _tr.trace("upload"):
        t = torch.from_numpy(np.ascontiguousarray(
            framing._host(values), dtype=T).reshape(-1)).to(dev)
        devmod.sync(dev)
    return t


def compress_1d_ts(data, prev, real_precision: float, value_range, median,
                   *, max_range_radius: int, sample_distance: int,
                   pred_threshold, opt_quant_mode: int = 1,
                   fixed_intervals: int = 0, device="cuda"):
    """One temporal step of a float32 or float64 field against ``prev``
    (its history): (TDPS, the reconstruction as a tensor on ``device``).
    The TDPS is byte-equal to ``sz_tpu.temporal.compress_1d_ts``'s and the
    reconstruction bit-equal.  ``real_precision`` is a double here (the
    classic 1-D codec's is a float)."""
    dev = devmod.resolve(device)
    T = float_type(data.dtype)
    flat = _on(data, T, dev)
    prev = _on(prev, T, dev)
    n = flat.numel()
    rp = float(real_precision)
    if opt_quant_mode == 1:
        with _tr.trace("optimizer"):
            intervals = optimize_intervals_1d_ts(
                flat, prev, rp, max_range_radius, sample_distance,
                pred_threshold)
    else:
        intervals = fixed_intervals
    radius = intervals // 2
    req_length, median = classic.req_length_median(rp, value_range, median,
                                                   T)
    with _tr.trace("ts_quantize"):
        types, recon, vals, count = tk.ts_quantize(
            flat, prev, rp, intervals, radius, req_length, median)
        n_esc = int(count)
    with _tr.trace("escape_stream"):
        enc = classic.ExactEncoder(req_length, median, T)
        enc.add_batch(vals[:n_esc].cpu().numpy())
    del vals
    type_array, _ = classic.encode_types(types, intervals, dev)
    t = TDPS(
        data_type=data_type(T), ds_length=n, intervals=intervals,
        median_value=float(median), req_length=req_length,
        real_precision=rp, type_array=type_array,
        lead_num=enc.lead_packed(), exact_mid_bytes=bytes(enc.mid_bytes),
        residual_mid_bits=enc.resi_packed(),
        exact_data_num=enc.exact_count(),
        max_quant_intervals=max_range_radius * 2)
    return t, recon


def decompress_1d_ts(tdps: TDPS, prev, n: int, dtype, *,
                     device="cuda") -> torch.Tensor:
    """decompressDataSeries_float_1D_ts (szd_float_ts.c:19): the types
    decoded on the device (K5-K7), the escape values on the host, the
    restore on the device (K15).  Returns the field as a 1-D tensor on
    ``device``, bit-equal to ``sz_tpu.temporal.decompress_1d_ts``.
    Raises ValueError when the types call for another number of escapes
    than the stream stores."""
    dev = devmod.resolve(device)
    T = float_type(dtype)
    prev = _on(prev, T, dev)
    if prev.numel() != n:
        raise ValueError(f"a history of {prev.numel()} points for {n}")
    types = classic.decode_types(tdps.type_array, n, dev)
    with _tr.trace("escape_decode"):
        vals = classic.ExactDecoder(tdps, T, raw=False).next_batch(
            tdps.exact_data_num)
        vals = torch.from_numpy(vals).to(dev)
    with _tr.trace("ts_restore"):
        out, seen = tk.ts_decode(types, prev, vals, tdps.intervals // 2,
                                 tdps.real_precision * 2)
        seen = int(seen)
    if seen != tdps.exact_data_num:
        raise ValueError(f"corrupt stream: {seen} escapes coded, "
                         f"{tdps.exact_data_num} stored")
    return out


# ---------------------------------------------------------------------------
# Variable registry and the frame of a step
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Variable:
    """SZ_Variable analog (VarSet.c)."""

    var_id: int
    name: str
    shape: tuple
    dtype: object
    cfg: SZConfig
    hist: torch.Tensor = None  # the previous step's reconstruction
    last_snapshot_step: int = 0
    compress_type: int = 0


class TemporalCompressor:
    """SZ_registerVar + SZ_compress_ts/SZ_decompress_ts analog, on
    ``device`` ('cuda', the default, runs the Hopper kernels; a CUDA
    request without a card raises).

    The same class drives both directions; decompression needs the same
    registration order and ids (as in the reference, where the
    decompressor registers the variables again).  Each variable's
    history is a tensor on ``device``."""

    def __init__(self, snapshot_step: int = 5, *, device="cuda"):
        self.device = devmod.resolve(device)
        self.snapshot_step = snapshot_step
        self.vars: dict[int, Variable] = {}
        self.order: list[int] = []
        self.current_step = 0

    def register(self, var_id: int, name: str, shape, dtype,
                 cfg: SZConfig = None) -> None:
        cfg = cfg or SZConfig().with_bound(ErrorBoundMode.ABS, 1e-4)
        cfg = dataclasses.replace(cfg, sz_mode=SZMode.TEMPORAL_COMPRESSION,
                                  snapshot_cmpr_step=self.snapshot_step)
        self.vars[var_id] = Variable(var_id, name, tuple(shape),
                                     np_dtype(dtype), cfg)
        self.order.append(var_id)

    # -- compression ------------------------------------------------------

    def _step_payload(self, v: Variable, data,
                      cmpr_type: CompressionType) -> bytes:
        cfg, dev = v.cfg, self.device
        T = np.float32 if v.dtype == np.float32 else np.float64
        dt = DataType.FLOAT if T is np.float32 else DataType.DOUBLE
        use_ts = (cmpr_type == CompressionType.FORCE_TEMPORAL
                  or (cmpr_type == CompressionType.PERIO_TEMPORAL
                      and self.current_step % self.snapshot_step != 0))
        if use_ts and v.hist is not None:
            flat = _on(data, T, dev)
            n = flat.numel()
            with _tr.trace("range"):
                if torch.is_tensor(data):
                    lo, hi = torch.stack(torch.aminmax(flat)).cpu().numpy()
                else:   # the host array's own scan, as sz_tpu's
                    host = data.reshape(-1).astype(T, copy=False)
                    lo, hi = host.min(), host.max()
            fmin = T(lo)
            value_range = T(T(hi) - fmin)
            fmax = T(fmin + value_range)
            rp, _ = framing._resolve_precision(cfg, float(value_range), n,
                                               dt)
            hdr_cfg = dataclasses.replace(cfg, abs_err_bound=rp)
            median = T(fmin + value_range / T(2))
            t, recon = compress_1d_ts(
                flat, v.hist, rp, value_range, median,
                max_range_radius=cfg.max_range_radius,
                sample_distance=cfg.sample_distance,
                pred_threshold=np.float32(cfg.pred_threshold),
                opt_quant_mode=cfg.opt_quant_mode,
                fixed_intervals=cfg.quantization_intervals, device=dev)
            v.compress_type = 1
            v.hist = recon
            header = md.make_header(hdr_cfg, dt, fmin, fmax)
            body = (header + bu.size_be(n, cfg.size_type)
                    + tdps_mod.to_bytes(t, cfg.size_type))
            with _tr.trace("lossless"):
                return ll.compress(body, cfg.lossless, cfg.lossless_level)
        # snapshot step: the spatial classic codec; the history is its own
        # reconstruction (the decode of the stream just built)
        snap_cfg = dataclasses.replace(cfg, with_regression=False)
        payload = api.compress(data.reshape(v.shape), snap_cfg, device=dev)
        v.compress_type = 0
        v.last_snapshot_step = self.current_step
        v.hist = api.decompress(payload, v.shape, v.dtype, device=dev,
                                as_tensor=True).reshape(-1)
        return payload

    def compress_step(self, arrays: dict, cmpr_type: CompressionType =
                      CompressionType.PERIO_TEMPORAL) -> bytes:
        """arrays: {var_id: numpy array or tensor}.  Returns the step's
        frame.  A tensor on the compressor's device is compressed where it
        lies on temporal steps (downloaded on snapshot steps, as
        ``api.compress``'s classic route does); any other input is a host
        array, uploaded once."""
        frames = []
        for vid in self.order:
            v = self.vars[vid]
            data = arrays[vid]
            if not (torch.is_tensor(data) and data.device == self.device):
                data = framing._host(data)
            frames.append((v, self._step_payload(v, data, cmpr_type)))
        out = bytearray()
        out += bu.u32_be(self.current_step)
        out += struct.pack("<H", len(frames))
        for v, payload in frames:
            out += bytes([v.var_id & 0xFF, v.compress_type & 0xFF,
                          (DataType.FLOAT if v.dtype == np.float32
                           else DataType.DOUBLE) & 0xFF])
            out += struct.pack("<Q", len(payload))
            out += payload
        self.current_step += 1
        return bytes(out)

    # -- decompression ----------------------------------------------------

    def decompress_step(self, blob: bytes, as_tensor: bool = False) -> dict:
        """{var_id: numpy array, or a tensor on the compressor's device
        when ``as_tensor`` (the variable's history itself: the next step
        decodes against it, so it is not to be written to)}; updates each
        variable's history.  Ids that are not registered are skipped."""
        dev = self.device
        pos = 0
        step = bu.read_u32_be(blob, pos)
        pos += 4
        (nvars,) = struct.unpack_from("<H", blob, pos)
        pos += 2
        out = {}
        for _ in range(nvars):
            var_id = blob[pos]
            ctype = blob[pos + 1]
            pos += 3  # id, compressType, dataType
            (csize,) = struct.unpack_from("<Q", blob, pos)
            pos += 8
            payload = blob[pos:pos + csize]
            pos += csize
            v = self.vars.get(var_id)
            if v is None:
                continue
            n = int(np.prod(v.shape))
            if ctype == 0:
                data = api.decompress(payload, v.shape, v.dtype, device=dev,
                                      as_tensor=True)
            else:
                if v.hist is None:
                    raise ValueError(f"variable {var_id}: a temporal step "
                                     f"before any snapshot")
                T = np.float32 if v.dtype == np.float32 else np.float64
                dt = DataType.FLOAT if T is np.float32 else DataType.DOUBLE
                inner = ll.decompress(
                    payload, expected_size=n * np.dtype(T).itemsize * 2 + 64)
                hdr = md.parse_header(inner, dt)
                off = hdr.body_offset + hdr.size_type
                t = tdps_mod.from_bytes(inner[off:], dt, is_pwr=False,
                                        msst19=False,
                                        size_type=hdr.size_type)
                data = decompress_1d_ts(t, v.hist, n, T,
                                        device=dev).reshape(v.shape)
            v.hist = data.reshape(-1)
            if not as_tensor:   # never a view of the history
                data = (data.numpy().copy() if data.device.type == "cpu"
                        else data.cpu().numpy())
            out[var_id] = data
        self.current_step = step + 1
        return out
