"""Host stages of the MSST19 point-wise-relative (PW_REL) codec: the
port's copy of what ``sz_tpu.core.pwr`` runs on the host around the
device wavefront.

MSST19 quantizes multiplicatively, directly on the (zero-replaced)
data: a state indexes the geometric precision table
(1+e)^(inv*(i-radius)) and is found by a bit-sliced lookup on the
prediction ratio (MultiLevelCacheTableWideInterval.c).  These two tables
are the state the encoder and the decoder must share bit for bit, so
both are built here exactly as the reference builds them: libm ``pow``
per entry, and the cache table's state machine in the host runtime.

The other PW_REL codec, pre-log (``accelerate_pw_rel`` off, or a ratio
below 1e-5), maps the magnitudes through log2 on the host and runs the
classic codec on the log field: ``compress_prelog`` /
``decompress_prelog``.

Reference: SZ_compress_args_float_NoCkRngeNoGzip_3D_pwr_pre_log_MSST19
(sz_float_pwr.c:1965-2000), computeRangeSize_float_MSST19
(dataCompression.c:121), the opt_MSST19 interval optimizers
(sz_float.c), the pre-log entry points (sz_float_pwr.c:1792-1915,
szd_float_pwr.c:1331).
"""

from __future__ import annotations

import functools
import math

import numpy as np

from sz_tpu_torch import native
from sz_tpu_torch.config import Lossless
from sz_tpu_torch.core import classic
from sz_tpu_torch.core.optimizer import round_up_to_power_of_2
from sz_tpu_torch.format import lossless as ll
from sz_tpu_torch.gpu import classic_engine


def range_size_msst19(data: np.ndarray):
    """(min, value_range, median, signs u8[n], positive, nearZero) of a
    float32 or float64 field, in its dtype.

    Literal semantics: signs/positive consider only i>=1 (the reference
    loop starts at 1), nearZero starts at data[0] and updates on strictly
    smaller nonzero magnitudes."""
    T = data.dtype.type
    fmin, fmax, near, signs, positive = native.range_scan(data.reshape(-1))
    vrange = T(fmax - fmin)
    median = T(fmin + vrange / T(2))
    return fmin, vrange, median, signs, positive, T(near)


# ---------------------------------------------------------------------------
# MSST19 tables (MultiLevelCacheTableWideInterval.c)
# ---------------------------------------------------------------------------

def _expo_index(value: float) -> int:
    return int(np.float64(value).view(np.uint64)) >> 52


def _required_bits(precision: float) -> int:
    return -((int(np.float64(precision).view(np.uint64)) >> 52) - 1023)


class CacheTable:
    """TopLevelTableWideInterval replica: state lookup keyed on the
    (exponent, truncated-mantissa) bits of the prediction ratio.
    ``table[expo - base_index, mantissa >> (52 - bits)]`` is the state
    for a ratio whose biased exponent lies in [base_index, top_index]."""

    def __init__(self, precision_table: np.ndarray, precision: float,
                 plus_bits: int):
        count = len(precision_table)
        self.bits = _required_bits(precision) + plus_bits
        bottom = precision_table[1] / (1 + precision)
        top = precision_table[count - 1] / (1 - precision)
        self.base_index = _expo_index(bottom)
        self.top_index = _expo_index(top)
        nsub = self.top_index - self.base_index + 1
        self.table = native.msst19_build_table(
            precision_table, precision, self.bits, self.base_index, nsub)


@functools.lru_cache(maxsize=8)
def _cache_table(intervals: int, ratio: float,
                 plus_bits: int) -> CacheTable:
    """The table depends only on (intervals, ratio, plus_bits)."""
    return CacheTable(_precision_table(intervals, ratio, plus_bits),
                      ratio, plus_bits)


def _precision_table(intervals: int, ratio: float,
                     plus_bits: int) -> np.ndarray:
    """precisionTable[i] = pow(1+ratio, inv*(i-radius)).  libm pow per
    element (math.pow), not np.power: the two differ in the last ulp and
    the decoder multiplies by these entries directly, so the table must
    be the reference's bit for bit."""
    radius = intervals // 2
    inv = 2.0 - 2.0 ** (-plus_bits)
    base = 1.0 + ratio
    return np.array([math.pow(base, inv * (i - radius))
                     for i in range(intervals)], dtype=np.float64)


# ---------------------------------------------------------------------------
# MSST19 interval optimizers (sz_float.c opt_MSST19 variants)
# ---------------------------------------------------------------------------

def _radius_index(v: float, max_range_radius: int) -> int:
    """C: (uint64_t) cast of the double — inf/NaN/negative-overflow all
    come out of cvttsd2si as INT64_MIN, i.e. a huge uint64, and get
    clamped to maxRangeRadius-1."""
    if not np.isfinite(v) or v >= max_range_radius or v < 0:
        return max_range_radius - 1
    return min(int(v), max_range_radius - 1)


def _finish_intervals(hist, total, max_range_radius, pred_threshold):
    target = int(total * pred_threshold)
    csum = np.cumsum(hist)
    over = np.flatnonzero(csum > target)
    i = int(over[0]) if len(over) else max_range_radius - 1
    return max(round_up_to_power_of_2(2 * (i + 1)), 32)


def _walk_positions(shape, sample_distance: int) -> list:
    """The optimizers' sampling-walk positions (pure control flow of the
    serial walk below, which is data-independent when no sampled value
    is zero — guaranteed after the driver's zero replacement unless
    nearZero is itself 0)."""
    n = 1
    for r in shape:
        n *= r
    out = []
    if len(shape) == 1:
        out = list(range(2, n, sample_distance))
    elif len(shape) == 2:
        r1, r2 = shape
        offset_count = sample_distance - 1
        pos = r2 + offset_count
        n1 = 1
        while pos < n:
            out.append(pos)
            offset_count += sample_distance
            if offset_count >= r2:
                n1 += 1
                oc2 = n1 % sample_distance
                pos += (r2 + sample_distance - offset_count) \
                    + (sample_distance - oc2)
                offset_count = sample_distance - oc2
                if offset_count == 0:
                    offset_count += 1
            else:
                pos += sample_distance
    else:
        r1, r2, r3 = shape
        r23 = r2 * r3
        offset_count = sample_distance - 2
        pos = r23 + r3 + offset_count
        n1 = n2 = 1
        while pos < n:
            out.append(pos)
            offset_count += sample_distance
            if offset_count >= r3:
                n2 += 1
                if n2 == r2:
                    n1 += 1
                    n2 = 1
                    pos += r3
                oc2 = (n1 + n2) % sample_distance
                pos += (r3 + sample_distance - offset_count) \
                    + (sample_distance - oc2)
                offset_count = sample_distance - oc2
                if offset_count == 0:
                    offset_count += 1
            else:
                pos += sample_distance
    return out


def _radius_index_vec(v: np.ndarray, mrr: int) -> np.ndarray:
    """Vectorized _radius_index (the C (uint64_t) cast semantics)."""
    with np.errstate(all="ignore"):
        bad = ~np.isfinite(v) | (v >= mrr) | (v < 0)
        idx = np.trunc(np.where(bad, 0, v)).astype(np.int64)
    return np.where(bad, mrr - 1, np.minimum(idx, mrr - 1))


def _optimize_intervals_msst19_fast(data, ratio, max_range_radius,
                                    sample_distance, pred_threshold):
    """Vectorized optimizer; returns None (fall back to the serial walk)
    if any sampled value is zero — there the reference's walk becomes
    data-dependent."""
    pos = np.asarray(_walk_positions(data.shape, sample_distance),
                     np.int64)
    if pos.size == 0:
        return _finish_intervals(np.zeros(max_range_radius, np.int64),
                                 0, max_range_radius, pred_threshold)
    divider = np.float64(np.float32(np.log2(1 + ratio) * 2))
    mrr = max_range_radius
    f = data.reshape(-1)
    cur = f[pos]
    if bool((cur == 0).any()):
        return None
    with np.errstate(all="ignore"):
        if data.ndim == 1:
            perr = np.abs(cur.astype(np.float64)
                          / f[pos - 1].astype(np.float64))
            v = np.abs(np.log2(perr) / divider + 0.5)
        elif data.ndim == 2:
            r2 = data.shape[1]
            pred = f[pos - 1] + f[pos - r2] - f[pos - r2 - 1]
            perr = np.abs(pred.astype(np.float64)
                          / cur.astype(np.float64)).astype(np.float32)
            v = np.abs(np.log2(perr.astype(np.float64)) / divider + 0.5)
        else:
            r2, r3 = data.shape[1:]
            r23 = r2 * r3
            p = f[pos - 1] + f[pos - r3]
            p = (p + f[pos - r23]).astype(np.float32)
            p = (p - f[pos - 1 - r23]).astype(np.float32)
            p = (p - f[pos - r3 - 1]).astype(np.float32)
            p = (p - f[pos - r3 - r23]).astype(np.float32)
            p = (p + f[pos - r3 - r23 - 1]).astype(np.float32)
            perr = np.abs(cur.astype(np.float64)
                          / p.astype(np.float64)).astype(np.float32)
            v = np.abs(np.log2(perr.astype(np.float64)) / divider + 0.5)
    hist = np.bincount(_radius_index_vec(v, mrr), minlength=mrr)
    return _finish_intervals(hist, len(pos), mrr, pred_threshold)


def _optimize_intervals_msst19(data: np.ndarray, ratio: float,
                               max_range_radius: int, sample_distance: int,
                               pred_threshold: float) -> int:
    """optimize_intervals_float_{2,3}D_opt_MSST19: the interval count
    that covers ``pred_threshold`` of the sampled prediction ratios."""
    fast = _optimize_intervals_msst19_fast(
        data, ratio, max_range_radius, sample_distance, pred_threshold)
    if fast is not None:
        return fast
    divider = np.float64(np.float32(np.log2(1 + ratio) * 2))
    hist = np.zeros(max_range_radius, dtype=np.int64)
    total = 0
    f32 = data.reshape(-1)
    n = f32.size
    with np.errstate(all="ignore"):
        if data.ndim == 1:
            pos = 2
            while pos < n:
                cur = np.float64(f32[pos])
                if cur == 0:
                    pos += sample_distance
                    continue
                total += 1
                perr = abs(cur / np.float64(f32[pos - 1]))
                hist[_radius_index(abs(np.log2(perr) / divider + 0.5),
                                   max_range_radius)] += 1
                pos += sample_distance
        elif data.ndim == 2:
            r1, r2 = data.shape
            offset_count = sample_distance - 1
            pos = r2 + offset_count
            n1 = 1
            while pos < n:
                cur = f32[pos]
                if cur == 0:
                    pos += sample_distance
                    continue
                total += 1
                pred = f32[pos - 1] + f32[pos - r2] - f32[pos - r2 - 1]
                perr = np.float32(abs(np.float64(pred) / np.float64(cur)))
                ridx = _radius_index(
                    abs(np.log2(np.float64(perr)) / divider + 0.5),
                    max_range_radius)
                hist[ridx] += 1
                offset_count += sample_distance
                if offset_count >= r2:
                    n1 += 1
                    oc2 = n1 % sample_distance
                    pos += (r2 + sample_distance - offset_count) \
                        + (sample_distance - oc2)
                    offset_count = sample_distance - oc2
                    if offset_count == 0:
                        offset_count += 1
                else:
                    pos += sample_distance
        else:
            r1, r2, r3 = data.shape
            r23 = r2 * r3
            offset_count = sample_distance - 2
            pos = r23 + r3 + offset_count
            n1 = n2 = 1
            while pos < n:
                cur = f32[pos]
                if cur == 0:
                    pos += sample_distance
                    continue
                total += 1
                p = f32[pos - 1] + f32[pos - r3]
                p = np.float32(p + f32[pos - r23])
                p = np.float32(p - f32[pos - 1 - r23])
                p = np.float32(p - f32[pos - r3 - 1])
                p = np.float32(p - f32[pos - r3 - r23])
                p = np.float32(p + f32[pos - r3 - r23 - 1])
                perr = np.float32(abs(np.float64(cur) / np.float64(p)))
                ridx = _radius_index(
                    abs(np.log2(np.float64(perr)) / divider + 0.5),
                    max_range_radius)
                hist[ridx] += 1
                offset_count += sample_distance
                if offset_count >= r3:
                    n2 += 1
                    if n2 == r2:
                        n1 += 1
                        n2 = 1
                        pos += r3
                    oc2 = (n1 + n2) % sample_distance
                    pos += (r3 + sample_distance - offset_count) \
                        + (sample_distance - oc2)
                    offset_count = sample_distance - oc2
                    if offset_count == 0:
                        offset_count += 1
                else:
                    pos += sample_distance
    return _finish_intervals(hist, total, max_range_radius, pred_threshold)


# ---------------------------------------------------------------------------
# The accelerated PW_REL driver (sz_float_pwr.c:1965-2000)
# ---------------------------------------------------------------------------

def compress_pwrel(data: np.ndarray, pw_ratio: float, *, range_info,
                   encode, **kw):
    """Zero replacement, the MSST19 encode (``encode(work, pw_ratio,
    fmax, near_zero, **kw)`` -> TDPS, the device engine), then
    ``min_log_value`` and, for a field with negative values, the
    zstd-3 sign bitmap.  ``range_info`` is the
    :func:`range_size_msst19` tuple; float32 or float64 data."""
    T = np.float32 if data.dtype == np.float32 else np.float64
    fmin, vrange, _median, signs, positive, near_zero = range_info
    fmax = T(fmin + vrange)
    # multiplier is a float variable assigned from double pow()
    multiplier = T(np.power(1.0 + pw_ratio, -3.0001))
    work = np.array(data, dtype=T, copy=True)
    flat = work.reshape(-1)
    flat[flat == 0] = T(near_zero * multiplier)
    tdps = encode(work, pw_ratio, fmax, near_zero, **kw)
    tdps.min_log_value = float(T(
        np.float64(near_zero) / ((1 + pw_ratio) * (1 + pw_ratio))))
    if not positive:
        tdps.pwr_err_bound_bytes = ll.compress(signs.tobytes(),
                                               Lossless.ZSTD, 3)
    return tdps


# ---------------------------------------------------------------------------
# Pre-log PW_REL (sz_float_pwr.c:1792/1853/1915; szd_float_pwr.c:1331)
# ---------------------------------------------------------------------------

def compress_prelog(data: np.ndarray, pw_ratio: float, fmin, fmax, *,
                    max_range_radius: int, sample_distance: int,
                    pred_threshold, opt_quant_mode: int = 1,
                    fixed_intervals: int = 0, device):
    """Pre-log PW_REL: log2 of the magnitudes on the host (glibc, per
    element: ``native.v_log2``; CUDA's log2 differs in the last ulp, and
    float64 streams serialize these values), zeros flushed below the
    smallest log, then the classic codec on the log field (1-D on the
    host, ranks 2-3 through K10), ``min_log_value`` and, for a field with
    negative values, the zstd-3 sign bitmap.  The TDPS is byte-equal to
    ``sz_tpu.core.pwr.compress_prelog``'s."""
    T = np.float32 if data.dtype == np.float32 else np.float64
    flat = np.ascontiguousarray(data, dtype=T).reshape(-1)
    signs = (flat < 0).astype(np.uint8)
    positive = not bool(signs.any())
    # max_abs_log seed from min/max (sz_float_pwr.c:1799-1802)
    if fmin == 0:
        max_abs = abs(math.log2(abs(float(fmax))))
    elif fmax == 0:
        max_abs = abs(math.log2(abs(float(fmin))))
    else:
        max_abs = max(abs(math.log2(abs(float(fmin)))),
                      abs(math.log2(abs(float(fmax)))))
    max_abs = T(max_abs)
    min_log = max_abs
    log_data = np.abs(flat)
    pos_mask = log_data > 0
    log_data[pos_mask] = native.v_log2(log_data[pos_mask]).astype(T)
    if pos_mask.any():
        max_abs = max(max_abs, log_data[pos_mask].max())
        min_log = min(min_log, log_data[pos_mask].min())
    # the log field's range, before the zero flush
    lmin = T(log_data.min())
    lrange = T(T(log_data.max()) - lmin)
    lmedian = T(lmin + lrange / T(2))
    if abs(np.float64(min_log)) > max_abs:
        max_abs = T(abs(np.float64(min_log)))
    # float kernels subtract maxAbsLog*1.2e-7 (sz_float_pwr.c:1927), the
    # double kernels 2.23e-16 (sz_double_pwr.c:1939)
    eps = 1.2e-7 if T is np.float32 else 2.23e-16
    rp = float(math.log2(1.0 + pw_ratio) - np.float64(max_abs) * eps)
    log_data[flat == 0] = T(np.float64(min_log) - 2.0001 * rp)
    shaped = log_data.reshape(data.shape)
    kw = dict(max_range_radius=max_range_radius,
              sample_distance=sample_distance, pred_threshold=pred_threshold,
              opt_quant_mode=opt_quant_mode, fixed_intervals=fixed_intervals,
              device=device)
    if data.ndim == 1:
        tdps = classic.compress_1d(shaped, rp, lrange, lmedian, **kw)
    else:
        tdps = classic_engine.compress(shaped, rp, lrange, lmedian, **kw)
    tdps.is_pwr = True
    tdps.min_log_value = float(T(np.float64(min_log) - 1.0001 * rp))
    if not positive:
        tdps.pwr_err_bound_bytes = ll.compress(signs.tobytes(),
                                               Lossless.ZSTD, 3)
    return tdps


def decompress_prelog(tdps, shape, dtype, *, device) -> np.ndarray:
    """The pre-log decode: the classic body, then on the host glibc exp2,
    the zeros below ``min_log_value`` and the signs; bit-equal to
    ``sz_tpu.core.pwr.decompress_pwrel``'s pre-log branch."""
    T = np.float32 if np.dtype(dtype) == np.float32 else np.float64
    n = int(np.prod(shape))
    if len(shape) == 1:
        out = classic.decompress_1d(tdps, n, T, device=device)
    else:
        out = classic_engine.decompress(tdps, shape, T, device=device)
    out = np.asarray(out).reshape(-1)
    zero = out < T(tdps.min_log_value)
    res = np.where(zero, T(0), native.v_exp2(out).astype(T))
    if len(tdps.pwr_err_bound_bytes):
        signs = np.frombuffer(
            ll.decompress(bytes(tdps.pwr_err_bound_bytes), expected_size=n),
            dtype=np.uint8, count=n)
        res = np.where(signs.astype(bool), -res, res)
    return res.reshape(shape)
