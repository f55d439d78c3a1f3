"""Whole-stream framing of float streams (the port's copy of the framing
helpers of ``sz_tpu.api``): bound resolution (with the MSST19 range and
sign scan for PW_REL), the header, the constant-field and verbatim
fallbacks, the lossless wrap and the decode clamp.  Mirrors
SZ_compress_args_float / SZ_decompress_args_float (sz_float.c:2811-3039,
szd_float.c:50-176) and their double twins.

A field may be a torch tensor on the compute device: its range is then
scanned there (min and max do not depend on order, so the result is
exact), and it is downloaded only where a fallback needs its values (the
constant stream's first value, the StoreOri verbatim copy).

Integer streams of rank 1 to 4 are framed here too (``_compress_int`` /
``_decompress_int``, SZ_compress_args_int32 sz_int32.c:1193 and its
decoder): the public entry points' integer route, and the 1-D streams the
random-access body nests.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from sz_tpu_torch.config import DataType, ErrorBoundMode, SZConfig, SZMode
from sz_tpu_torch.core import intc, pwr
from sz_tpu_torch.format import bytes_util as bu
from sz_tpu_torch.format import lossless as ll
from sz_tpu_torch.format import metadata as md
from sz_tpu_torch.format import tdps as tdps_mod
from sz_tpu_torch.gpu import int_kernel
from sz_tpu_torch.utils import stats as _stats
from sz_tpu_torch.utils import trace as _tr


def _host(values) -> np.ndarray:
    """``values`` as a host array: a tensor is downloaded (under the
    ``device_input_download`` span), anything else goes through
    ``np.asarray``."""
    if not torch.is_tensor(values):
        return np.asarray(values)
    with _tr.trace("device_input_download"):
        return values.detach().cpu().numpy()


def _filter_dims(shape) -> tuple:
    """filterDimension (sz.c:162-282): drop size-1 dims."""
    dims = [int(d) for d in shape if int(d) > 1]
    return tuple(dims) if dims else (1,)


def _resolve_precision(cfg: SZConfig, value_range: float, n: int,
                       dt: DataType = DataType.FLOAT):
    """Bound-mode resolution (sz_float.c:2852-2868, dataCompression.c:311).

    Returns (real_precision double, effective_mode_for_codec).
    """
    mode = cfg.error_bound_mode
    if mode == ErrorBoundMode.PSNR:
        # computeABSErrBoundFromPSNR (conf.c:54); predThreshold is stored as
        # float in the reference, so round it through float32 first
        pt = float(np.float32(cfg.pred_threshold))
        v1 = cfg.psnr + 10 * math.log10(1 - 2.0 / 3.0 * pt)
        rp = value_range * (10.0 ** (v1 / -20.0))
        return rp, ErrorBoundMode.ABS
    if mode == ErrorBoundMode.NORM:
        rp = math.sqrt(3.0 / n) * cfg.norm_err
        return rp, ErrorBoundMode.ABS
    if mode == ErrorBoundMode.ABS:
        return cfg.abs_err_bound, mode
    if mode == ErrorBoundMode.REL:
        return cfg.rel_bound_ratio * value_range, mode
    if mode in (ErrorBoundMode.ABS_AND_REL, ErrorBoundMode.ABS_OR_REL):
        # getRealPrecision_float uses min_f/max_f (float32 compare+result,
        # dataCompression.c:310-340); the double path stays in float64
        a, b = cfg.abs_err_bound, cfg.rel_bound_ratio * value_range
        if dt == DataType.FLOAT:
            a, b = float(np.float32(a)), float(np.float32(b))
        pick = min if mode == ErrorBoundMode.ABS_AND_REL else max
        return pick(a, b), mode
    if mode.is_pw_rel:
        # every mode >= PW_REL behaves as plain PW_REL in 2.1.12.4
        # (sz_float.c:2888)
        return 0.0, ErrorBoundMode.PW_REL
    raise ValueError(f"unsupported bound mode {mode}")


def accelerated_pw_rel(cfg: SZConfig) -> bool:
    """PW_REL through MSST19 (sz_float.c:2888-2890): the accelerated
    codec unless it is switched off or the ratio is below 1e-5."""
    return (cfg.error_bound_mode.is_pw_rel and cfg.accelerate_pw_rel
            and not (cfg.pw_rel_bound_ratio < 0.000009999))


def _fp_stream_params(data: np.ndarray, cfg: SZConfig, dt: DataType):
    """Range scan + bound resolution + header-config rewrite for one
    float stream (sz_float.c:2838-2868).

    Returns (fmin, fmax, value_range, rp, eff_mode, hdr_cfg, range_info);
    range_info is the MSST19 scan (``pwr.range_size_msst19``: also the
    signs and nearZero) for accelerated PW_REL, else None.  ``data`` may
    be a tensor (not under PW_REL): the range is then scanned where it
    lies and two scalars come down.
    """
    T = np.float32 if dt == DataType.FLOAT else np.float64
    flat = data.reshape(-1)
    range_info = None
    if accelerated_pw_rel(cfg):
        range_info = pwr.range_size_msst19(data)
        fmin, value_range = range_info[0], range_info[1]
    elif torch.is_tensor(flat):
        # computeRangeSize on the device: order-independent, so exact
        fmin, fmax = torch.stack(torch.aminmax(flat)).cpu().numpy()
        fmin = T(fmin)
        value_range = T(T(fmax) - fmin)
    else:
        # computeRangeSize (dataCompression.c:102/148): order-independent
        fmin = T(flat.min())
        value_range = T(T(flat.max()) - fmin)
    out = _fp_params_from_range(cfg, dt, fmin, value_range, flat.shape[0])
    return (*out[:6], range_info)


def _fp_params_from_range(cfg: SZConfig, dt: DataType, fmin, value_range,
                          n: int):
    """Bound resolution + header rewrite from an already-computed range.
    The reference serializes max as min+range (sz_float.c:2847), which
    can differ from the true max by one ulp."""
    T = np.float32 if dt == DataType.FLOAT else np.float64
    fmax = T(fmin + value_range)
    rp, eff_mode = _resolve_precision(cfg, float(value_range), n, dt)
    hdr_cfg = cfg
    if cfg.error_bound_mode in (ErrorBoundMode.PSNR, ErrorBoundMode.NORM):
        # the reference rewrites errorBoundMode=ABS + absErrBound before
        # serializing params (sz_float.c:2853-2867)
        hdr_cfg = dataclasses.replace(
            cfg, error_bound_mode=ErrorBoundMode.ABS, abs_err_bound=rp)
    elif not cfg.error_bound_mode.is_pw_rel:
        hdr_cfg = dataclasses.replace(cfg, abs_err_bound=rp)
    return fmin, fmax, value_range, rp, eff_mode, hdr_cfg, None


def _frame_regression_stream(cfg, hdr_cfg, dt, fmin, fmax, flat, n,
                             res) -> bytes:
    """Header + element count + body, the StoreOriData fallback and the
    lossless wrap: the tail of SZ_compress_args_float
    (sz_float.c:2978-3039)."""
    header = md.make_header(hdr_cfg, dt, fmin, fmax, regression=True,
                            random_access=cfg.random_access)
    return _recorded(dt, n, _finish(
        cfg, hdr_cfg, dt, fmin, fmax, flat, n,
        header + bu.size_be(n, cfg.size_type) + res.body))


def _frame_pwrel_stream(cfg, hdr_cfg, dt, fmin, fmax, flat, n,
                        tdps) -> bytes:
    """The same tail around a PW_REL TDPS body (sz_float.c:2888-2997):
    the header carries the PW_REL and MSST19 flags."""
    tdps.segment_size = cfg.segment_size
    header = md.make_header(hdr_cfg, dt, fmin, fmax, pw_rel=True,
                            msst19=bool(tdps.msst19))
    return _finish(cfg, hdr_cfg, dt, fmin, fmax, flat, n,
                   header + bu.size_be(n, cfg.size_type)
                   + tdps_mod.to_bytes(tdps, cfg.size_type))


def _frame_classic_stream(cfg, hdr_cfg, dt, fmin, fmax, flat, n,
                          tdps) -> bytes:
    """The same tail around a classic (SZ1.4) TDPS body
    (sz_float.c:3016-3039): a header without the regression flag."""
    header = md.make_header(hdr_cfg, dt, fmin, fmax)
    return _recorded(dt, n, _finish(
        cfg, hdr_cfg, dt, fmin, fmax, flat, n,
        header + bu.size_be(n, cfg.size_type)
        + tdps_mod.to_bytes(tdps, cfg.size_type)))


def _frame_ra_stream(cfg, hdr_cfg, dt, fmin, fmax, n, body) -> bytes:
    """Header (the regression and random-access flags), element count and
    a random-access body, and the lossless wrap; the reference's RA path
    has no StoreOriData fallback (sz_float.c:2913-2985)."""
    out = (md.make_header(hdr_cfg, dt, fmin, fmax, regression=True,
                          random_access=True)
           + bu.size_be(n, cfg.size_type) + body)
    if cfg.sz_mode != SZMode.BEST_SPEED:
        out = ll.compress(out, cfg.lossless, cfg.lossless_level)
    return _recorded(dt, n, out)


def _recorded(dt: DataType, n: int, out: bytes) -> bytes:
    """``out``, its size and the field's recorded in the stats
    (sz_tpu/api.py:341-347, :405-410, :429-434)."""
    esize = 4 if dt == DataType.FLOAT else 8
    _stats.record(original_size=n * esize, compressed_size=len(out))
    return out


def _finish(cfg, hdr_cfg, dt, fmin, fmax, flat, n, body) -> bytes:
    """The StoreOriData fallback and the lossless wrap of a framed
    body."""
    T = np.float32 if dt == DataType.FLOAT else np.float64
    esize = np.dtype(T).itemsize
    mlen = md.meta_length(dt)
    if len(body) >= n * esize + 3 + mlen + cfg.size_type + 1:
        body = _store_ori(hdr_cfg, dt, fmin, fmax, flat, n)
    if cfg.sz_mode == SZMode.BEST_SPEED:
        return body
    return ll.compress(body, cfg.lossless, cfg.lossless_level)


def _constant_stream(cfg, dt, fmin, fmax, value, n) -> bytes:
    """SZ_compress_args_float_withinRange (sz_float.c:2728): header with the
    'same' flag + one big-endian value.  Never lossless-wrapped (the size
    check in SZ_decompress_args_float:62 relies on the exact length)."""
    header = md.make_header(cfg, dt, fmin, fmax, same=True)
    val = bu.f32_be(value) if dt == DataType.FLOAT else bu.f64_be(value)
    return header + bu.size_be(n, cfg.size_type) + val


def _store_ori(cfg, dt, fmin, fmax, flat, n) -> bytes:
    """StoreOriData (sz_float.c:526): verbatim big-endian values (a
    tensor's downloaded here, the one place it is needed whole)."""
    header = md.make_header(cfg, dt, fmin, fmax, lossless=True)
    be = _host(flat).astype(
        ">f4" if dt == DataType.FLOAT else ">f8").tobytes()
    return header + bu.size_be(n, cfg.size_type) + be


def _protect_clamp(out, hdr, T):
    """protectValueRange decode clamp (szd_float.c:161-176): values
    outside [fmin, fmax] snap to the bound; NaNs pass through."""
    if not hdr.protect_range:
        return out
    mn, mx = T(hdr.params.fmin), T(hdr.params.fmax)
    return np.where(out < mn, mn, np.where(out > mx, mx, out))


def _compress_int(data, cfg: SZConfig, device, dtype=None) -> bytes:
    """sz_tpu.compress of an integer field of rank 1 to 4:
    SZ_compress_args_int32 (sz_int32.c:1193) and its twins; the constant
    stream, the integer codec, the StoreOriData fallback and the lossless
    wrap.  ``data`` is a numpy array or (ranks 2-4) a carrier tensor
    (``gpu.int_kernel.carrier``) of numpy ``dtype`` on ``device``, scanned
    and encoded where it lies."""
    if torch.is_tensor(data):
        dt = np.dtype(dtype)
    else:
        data = np.ascontiguousarray(data)
        dt = data.dtype
    data = data.reshape(_filter_dims(data.shape))
    spec = intc.SPECS[dt]
    n = int(np.prod(data.shape))
    mn, vrange = intc.range_size_int(data.reshape(-1), dt)
    if cfg.error_bound_mode == ErrorBoundMode.PSNR:
        pt = float(np.float32(cfg.pred_threshold))
        rp = vrange * (10.0 ** ((cfg.psnr + 10 * math.log10(
            1 - 2.0 / 3.0 * pt)) / -20.0))
    else:
        rp, _ = _resolve_precision(cfg, float(vrange), n)
    hdr_cfg = dataclasses.replace(cfg, abs_err_bound=rp)
    params = md.serialize_params(hdr_cfg, spec.dt, 0.0, 0.0)
    if vrange == 0:
        first = _host(data.reshape(-1)[:1]).view(dt)[0]
        body = intc.same_int(first, n, params, int(cfg.sz_mode),
                             cfg.size_type)
    else:
        t = intc.compress_int(
            data, rp, mn=mn, byte_size=intc.byte_size_per_value(vrange),
            max_range_radius=cfg.max_range_radius,
            sample_distance=cfg.sample_distance,
            pred_threshold=np.float32(cfg.pred_threshold),
            opt_quant_mode=1 if cfg.quantization_intervals == 0 else 0,
            fixed_intervals=cfg.quantization_intervals, dtype=dt,
            device=device)
        body = intc.itdps_to_bytes(t, dt, params, int(cfg.sz_mode),
                                   cfg.size_type)
        if len(body) > n * spec.esize:
            body = intc.store_ori_int(_host(data).view(dt), params,
                                      cfg.size_type)
    if cfg.sz_mode == SZMode.BEST_SPEED:
        return body
    return ll.compress(body, cfg.lossless, cfg.lossless_level)


def _decompress_int(blob: bytes, dims, dtype, device,
                    as_tensor: bool = False):
    """sz_tpu.decompress of an integer stream of a field of ``dims`` (its
    size-1 dimensions dropped; an int: a 1-D field of that many values).
    Returns numpy of ``dims``, or with ``as_tensor`` a tensor of ``dtype``
    on ``device`` (ranks 2-4 decode there; an unsigned type is a view of
    its carrier)."""
    dims = (dims,) if isinstance(dims, int) else tuple(dims)
    dtype = np.dtype(dtype)
    n = int(np.prod(dims))
    inner = ll.decompress(blob, expected_size=n * dtype.itemsize * 2 + 128)
    flag = inner[3]
    off = 4 + md.meta_length(DataType.FLOAT) + (8 if flag & 0x40 else 4)
    be = dtype.newbyteorder(">")
    if flag & 0x10:   # StoreOriData, verbatim (sz_uint16.c:320)
        out = np.frombuffer(inner, be, count=n, offset=off).astype(dtype)
    elif flag & 0x01:   # allSameData (TightDataPointStorageI.c:356)
        v = np.frombuffer(inner, be, count=1, offset=off)[0]
        out = np.full(n, v, dtype=dtype)
    else:
        t = intc.itdps_from_bytes(inner, md.meta_length(DataType.FLOAT))
        out = intc.decompress_int(t, dims, dtype, device=device,
                                  as_tensor=as_tensor)
    if as_tensor and not torch.is_tensor(out):
        out = int_kernel.to_carrier(out, device).view(
            int_kernel.torch_dtype(dtype))
    return out.reshape(dims)
