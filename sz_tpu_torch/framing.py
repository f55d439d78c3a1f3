"""Whole-stream framing of float streams (the port's copy of the framing
helpers of ``sz_tpu.api``): bound resolution, the header, the
constant-field and verbatim fallbacks, the lossless wrap and the decode
clamp.  Mirrors SZ_compress_args_float / SZ_decompress_args_float
(sz_float.c:2811-3039, szd_float.c:50-176).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

from sz_tpu_torch.config import DataType, ErrorBoundMode, SZConfig, SZMode
from sz_tpu_torch.format import bytes_util as bu
from sz_tpu_torch.format import lossless as ll
from sz_tpu_torch.format import metadata as md


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


def _fp_stream_params(data: np.ndarray, cfg: SZConfig, dt: DataType):
    """Range scan + bound resolution + header-config rewrite for one
    float stream (sz_float.c:2838-2868).

    Returns (fmin, fmax, value_range, rp, eff_mode, hdr_cfg, range_info).
    """
    T = np.float32 if dt == DataType.FLOAT else np.float64
    flat = data.reshape(-1)
    # computeRangeSize (dataCompression.c:102/148): order-independent
    fmin = T(flat.min())
    value_range = T(T(flat.max()) - fmin)
    out = _fp_params_from_range(cfg, dt, fmin, value_range, data.size)
    return (*out[:6], None)


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
    T = np.float32 if dt == DataType.FLOAT else np.float64
    header = md.make_header(hdr_cfg, dt, fmin, fmax, regression=True,
                            random_access=cfg.random_access)
    body = header + bu.size_be(n, cfg.size_type) + res.body
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
    """StoreOriData (sz_float.c:526): verbatim big-endian values."""
    header = md.make_header(cfg, dt, fmin, fmax, lossless=True)
    be = np.asarray(flat).astype(
        ">f4" if dt == DataType.FLOAT else ">f8").tobytes()
    return header + bu.size_be(n, cfg.size_type) + be


def _protect_clamp(out, hdr, T):
    """protectValueRange decode clamp (szd_float.c:161-176): values
    outside [fmin, fmax] snap to the bound; NaNs pass through."""
    if not hdr.protect_range:
        return out
    mn, mx = T(hdr.params.fmin), T(hdr.params.fmax)
    return np.where(out < mn, mn, np.where(out > mx, mx, out))
