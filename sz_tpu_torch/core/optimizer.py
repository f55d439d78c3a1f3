"""Quantization-interval optimizer (the port's copy of the 2-D/3-D part
of ``sz_tpu.core.optimizer``).

Replicates optimize_intervals_float_{2D,3D}_with_freq_and_dense_pos
(sz_float.c:6396/5405): strided sampling walks whose index sequences are
pure integer arithmetic (independent of the data), a histogram of
Lorenzo prediction errors in units of 2*eb, and a value-frequency
histogram that locates the densest value ("dense_pos") for the
mean-flush optimization.  The walks are cached per shape; the
histograms are vectorized in numpy; the one ordered reduction (the
strided mean) runs in the host runtime's ``seq_sum_f32``.
"""

from __future__ import annotations

import functools

import numpy as np

from sz_tpu_torch import native


def round_up_to_power_of_2(v: int) -> int:
    """roundUpToPowerOf2 (conf.c:35)."""
    if v <= 1:
        return v
    return 1 << (v - 1).bit_length()


@functools.lru_cache(maxsize=64)
def _mean_walk_indices_3d(r1: int, r2: int, r3: int) -> np.ndarray:
    """First sampling walk of the 3D optimizer (sz_float.c:6399-6419):
    stride ~sqrt(len) with -1 adjustments at r3 / r2*r3 boundaries."""
    length = r1 * r2 * r3
    mean_distance = int(np.sqrt(length))
    idx = []
    pos = 0
    offset_count = 0
    offset_count_2 = 0
    while pos < length:
        idx.append(pos)
        pos += mean_distance
        offset_count += mean_distance
        offset_count_2 += mean_distance
        if offset_count >= r3:
            offset_count = 0
            pos -= 1
        if offset_count_2 >= r2 * r3:
            offset_count_2 = 0
            pos -= 1
    return np.array(idx, dtype=np.int64)


@functools.lru_cache(maxsize=64)
def _mean_walk_indices_2d(r1: int, r2: int) -> np.ndarray:
    """2D mean walk (sz_float.c:5407-5418): plain sqrt(len) stride."""
    length = r1 * r2
    mean_distance = int(np.sqrt(length))
    return np.arange(0, length, mean_distance, dtype=np.int64)


@functools.lru_cache(maxsize=64)
def _sample_walk_indices_3d(r1: int, r2: int, r3: int,
                            sample_distance: int) -> np.ndarray:
    """Second 3D sampling walk (sz_float.c:6442-6485); counter-driven."""
    length = r1 * r2 * r3
    r23 = r2 * r3
    offset_count = sample_distance - 2
    pos = r23 + r3 + offset_count
    n1_count = 1
    n2_count = 1
    idx = []
    while pos < length:
        idx.append(pos)
        offset_count += sample_distance
        if offset_count >= r3:
            n2_count += 1
            if n2_count == r2:
                n1_count += 1
                n2_count = 1
                pos += r3
            offset_count_2 = (n1_count + n2_count) % sample_distance
            pos += (r3 + sample_distance - offset_count) + \
                   (sample_distance - offset_count_2)
            offset_count = sample_distance - offset_count_2
            if offset_count == 0:
                offset_count += 1
        else:
            pos += sample_distance
    return np.array(idx, dtype=np.int64)


@functools.lru_cache(maxsize=64)
def _sample_walk_indices_2d(r1: int, r2: int,
                            sample_distance: int) -> np.ndarray:
    """2D sampling walk (sz_float.c:5438-5473)."""
    length = r1 * r2
    offset_count = sample_distance - 1
    pos = r2 + offset_count
    n1_count = 1
    idx = []
    while pos < length:
        idx.append(pos)
        offset_count += sample_distance
        if offset_count >= r2:
            n1_count += 1
            offset_count_2 = n1_count % sample_distance
            pos += (r2 + sample_distance - offset_count) + \
                   (sample_distance - offset_count_2)
            offset_count = sample_distance - offset_count_2
            if offset_count == 0:
                offset_count += 1
        else:
            pos += sample_distance
    return np.array(idx, dtype=np.int64)


def _finish(cur, pred, mean, rp, sample_count, max_range_radius,
            pred_threshold, T):
    """Common histogram + selection logic shared by 2D/3D."""
    # C: fabs(pred_value - *data_pos) -- subtraction in T, then double fabs
    pred_err = np.abs((pred - cur).astype(np.float64))
    freq_count = int(np.count_nonzero(pred_err < rp))

    radius_index = ((pred_err / rp + 1.0) / 2.0).astype(np.int64)
    np.minimum(radius_index, max_range_radius - 1, out=radius_index)
    # C casts the quotient through (uint64_t): negatives wrap to huge
    # values and clamp to the last bin
    radius_index[radius_index < 0] = max_range_radius - 1
    intervals = np.bincount(radius_index, minlength=max_range_radius)

    range_ = 8192
    radius = 4096
    mean_diff = (cur - mean).astype(np.float64)
    with np.errstate(invalid="ignore", over="ignore"):
        # C casts the double quotient with cvttsd2si: NaN/inf/overflow all
        # yield INT64_MIN, exactly like numpy's int64 cast on x86
        trunc = np.trunc(mean_diff / rp).astype(np.int64)
        freq_index = np.where(mean_diff > 0, trunc + radius,
                              trunc - 1 + radius)
    freq_index = np.clip(freq_index, 0, range_ - 1)
    freq_intervals = np.bincount(freq_index, minlength=range_)

    max_freq = T(freq_count * 1.0 / sample_count)

    target = int(sample_count * pred_threshold)
    csum = np.cumsum(intervals)
    over = np.flatnonzero(csum > target)
    i = int(over[0]) if len(over) else max_range_radius - 1
    pow2 = max(round_up_to_power_of_2(2 * (i + 1)), 32)

    pair = freq_intervals[1:range_ - 2] + freq_intervals[2:range_ - 1]
    max_index = int(np.argmax(pair)) + 1
    max_sum = int(pair[max_index - 1])
    dense_pos = T(np.float64(mean) + rp * (max_index + 1 - radius))
    mean_freq = T(max_sum * 1.0 / sample_count)
    return int(pow2), dense_pos, max_freq, mean_freq


def _walk_mean(flat, midx, T):
    mean = native.seq_sum_f32(flat[midx])
    if len(midx) > 0:
        mean = T(mean / T(len(midx)))
    return mean


def optimize_intervals_3d_freq_dense(flat, r1, r2, r3, real_precision,
                                     max_range_radius, sample_distance,
                                     pred_threshold, T=np.float32):
    """(quantization_intervals, dense_pos, max_freq, mean_freq)."""
    r23 = r2 * r3
    mean = _walk_mean(flat, _mean_walk_indices_3d(r1, r2, r3), T)
    sidx = _sample_walk_indices_3d(r1, r2, r3, sample_distance)
    d = flat
    cur = d[sidx]
    pred = d[sidx - 1] + d[sidx - r3]
    pred = pred + d[sidx - r23]
    pred = pred - d[sidx - 1 - r23]
    pred = pred - d[sidx - r3 - 1]
    pred = pred - d[sidx - r3 - r23]
    pred = pred + d[sidx - r3 - r23 - 1]
    return _finish(cur, pred, mean, float(real_precision), len(sidx),
                   max_range_radius, pred_threshold, T)


def optimize_intervals_2d_freq_dense(flat, r1, r2, real_precision,
                                     max_range_radius, sample_distance,
                                     pred_threshold, T=np.float32):
    mean = _walk_mean(flat, _mean_walk_indices_2d(r1, r2), T)
    sidx = _sample_walk_indices_2d(r1, r2, sample_distance)
    d = flat
    cur = d[sidx]
    pred = d[sidx - 1] + d[sidx - r2] - d[sidx - r2 - 1]
    return _finish(cur, pred, mean, float(real_precision), len(sidx),
                   max_range_radius, pred_threshold, T)


def decide_use_mean(mean_freq, max_freq, rank: int) -> bool:
    """The mean-flush decision (sz_float.c:6496-6502) with the 2D force
    off (sz_float.c:5615)."""
    if rank == 2:
        return False
    return bool(mean_freq > 0.5) or bool(mean_freq > max_freq)


def fold_mean(vals: np.ndarray, T=np.float32):
    """mean = seq_sum(vals)/len in T (sz_float.c:6811-6817); T(0) when
    the dense cluster is empty."""
    if len(vals):
        return T(native.seq_sum_f32(vals) / T(len(vals)))
    return T(0)
