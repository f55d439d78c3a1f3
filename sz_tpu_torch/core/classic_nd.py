"""Host front end of the classic SZ1.4 codec on 2-D, 3-D and 4-D fields
(the port's copy of what ``sz_tpu.core.classic_nd`` computes around the
recurrence): the interval optimizer, the quantizer's numeric form, the
escapes' kept bits and the median.  The recurrence itself is K10/K11
(``gpu/classic_kernel.py``), driven by ``gpu/classic_engine.py``.

Reference: SZ_compress_float_{2,3,4}D_MDQ (sz_float.c:610/946/1479),
SZ_compress_double_{2,3,4}D_MDQ, optimize_intervals_float_{2D,3D}_opt
(sz_float.c:5015/4644) and optimize_intervals_float_4D (sz_float.c:298).

Three numeric forms (``Form``): float32 data on ranks 2-3 quantizes with
float ``realPrecision`` and ``recip`` and rounds ``itvNum`` to float;
the float 4-D kernel declares ``double itvNum`` and keeps the precision
double (sz_float.c:1496); float64 data is double throughout.  A fourth,
the subblock form of SZ_compress_args3 (``SZ_compress_float_{2,3,4}D_
MDQ_subblock``, sz_float.c:3566/3777/4118), quantizes every dtype and
rank in double, dividing by the precision, with no epsilon recheck; its
optimizer samples on the region's global coordinates
(:func:`optimize_intervals_subblock`).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from sz_tpu_torch.core import classic
from sz_tpu_torch.core import optimizer as opt


@dataclasses.dataclass(frozen=True)
class Form:
    """The quantizer's types: T the data's, RT the precision's, the
    reconstruction's and itvNum's; ``dbl`` when RT is double; ``sub``
    the subblock form (RT double, a division, no recheck)."""
    T: type
    RT: type
    sub: bool = False

    @property
    def dbl(self) -> bool:
        return self.RT is np.float64


def form(T, ndim: int, sub: bool = False) -> Form:
    """The numeric form of the kernel for ``T`` data of rank ``ndim``
    (``sub``: the subblock form)."""
    dbl = T is np.float64 or ndim == 4 or sub
    return Form(T, np.float64 if dbl else T, sub)


def _sample_4d(shape, sample_distance: int) -> np.ndarray:
    """Flat indices of the 4-D optimizer's modular grid: (i, j, k, l) in
    [1, r)^4 with (i + j + k + l) % sample_distance == 0, in raster
    order.  For each (i, j, k) the l's are one residue class, so the grid
    is built without a 4-D mesh."""
    r1, r2, r3, r4 = shape
    sd = sample_distance
    i, j, k = np.meshgrid(np.arange(1, r1), np.arange(1, r2),
                          np.arange(1, r3), indexing="ij")
    base = ((i * r2 + j) * r3 + k).reshape(-1).astype(np.int64) * r4
    first = (-(i + j + k).reshape(-1)) % sd
    first[first == 0] = sd             # l starts at 1
    count = np.maximum((r4 - 1 - first) // sd + 1, 0)
    row = np.repeat(np.arange(base.size), count)
    step = np.arange(row.size) - np.repeat(np.cumsum(count) - count, count)
    return base[row] + first[row] + step * sd


def optimize_intervals(data: np.ndarray, real_precision: float,
                       max_range_radius: int, sample_distance: int,
                       pred_threshold) -> int:
    """classic_nd._optimize_intervals_nd of the JAX package: the 2-D and
    3-D sampling walks of the freq_dense optimizers, and the 4-D modular
    grid, whose predictor reads index - r3 where the 7-point stencil has
    index - r4 (sz_float.c:298, kept as the reference has it)."""
    flat = data.reshape(-1)
    rp = float(real_precision)
    if data.ndim == 4:
        r1, r2, r3, r4 = data.shape
        r34 = r3 * r4
        idx = _sample_4d(data.shape, sample_distance)
        d = flat
        pred = d[idx - 1] + d[idx - r3]
        pred = pred + d[idx - r34]
        pred = pred - d[idx - 1 - r34]
        pred = pred - d[idx - r4 - 1]
        pred = pred - d[idx - r4 - r34]
        pred = pred + d[idx - r4 - r34 - 1]
        total = (r1 - 1) * (r2 - 1) * (r3 - 1) * (r4 - 1) // sample_distance
    elif data.ndim == 2:
        r1, r2 = data.shape
        idx = opt._sample_walk_indices_2d(r1, r2, sample_distance)
        pred = flat[idx - 1] + flat[idx - r2] - flat[idx - r2 - 1]
        total = len(idx)
    else:
        r1, r2, r3 = data.shape
        r23 = r2 * r3
        idx = opt._sample_walk_indices_3d(r1, r2, r3, sample_distance)
        d = flat
        pred = d[idx - 1] + d[idx - r3]
        pred = pred + d[idx - r23]
        pred = pred - d[idx - 1 - r23]
        pred = pred - d[idx - r3 - 1]
        pred = pred - d[idx - r3 - r23]
        pred = pred + d[idx - r3 - r23 - 1]
        total = len(idx)
    pred_err = np.abs((pred - flat[idx]).astype(np.float64))
    return opt.intervals_from_errors(pred_err, total, rp, max_range_radius,
                                     pred_threshold)


def optimize_intervals_subblock(data: np.ndarray, origin,
                                real_precision: float,
                                max_range_radius: int, sample_distance: int,
                                pred_threshold) -> int:
    """optimize_intervals_float_{2,3,4}D_subblock (sz_float.c:3278/3330/
    3382): the points of [1, r)^rank whose GLOBAL coordinates (local plus
    ``origin``) sum to a multiple of sample_distance, predicted by the
    2-D Lorenzo (rank 2) or the 3-D Lorenzo over the last three axes
    (ranks 3 and 4, sz_float.c:3410), of size // sample_distance
    samples."""
    grids = np.meshgrid(*[np.arange(1, r) for r in data.shape],
                        indexing="ij")
    gsum = sum(g + int(o) for g, o in zip(grids, origin))
    loc = [g[(gsum % sample_distance) == 0] for g in grids]
    d = data
    if data.ndim == 2:
        i, j = loc
        pred = d[i, j - 1] + d[i - 1, j] - d[i - 1, j - 1]
        cur = d[i, j]
    else:
        head = tuple(loc[:-3])     # rank 4: the outer index stays
        i, j, k = loc[-3:]
        pred = d[head + (i, j, k - 1)] + d[head + (i, j - 1, k)]
        pred = pred + d[head + (i - 1, j, k)]
        pred = pred - d[head + (i, j - 1, k - 1)]
        pred = pred - d[head + (i - 1, j, k - 1)]
        pred = pred - d[head + (i - 1, j - 1, k)]
        pred = pred + d[head + (i - 1, j - 1, k - 1)]
        cur = d[head + (i, j, k)]
    pred_err = np.abs((pred - cur).astype(np.float64))
    return opt.intervals_from_errors(pred_err, data.size // sample_distance,
                                     float(real_precision),
                                     max_range_radius, pred_threshold)


@dataclasses.dataclass(frozen=True)
class Params:
    """What the recurrence needs besides the field: the precision in RT
    and its reciprocal, the interval count and radius, the escapes' kept
    bits and the median (as the stream stores them)."""
    form: Form
    rp: np.floating
    recip: np.floating
    intervals: int
    radius: int
    req_length: int
    median: np.floating


def params(data: np.ndarray, real_precision: float, value_range, median, *,
           max_range_radius: int, sample_distance: int, pred_threshold,
           opt_quant_mode: int = 1, fixed_intervals: int = 0,
           subblock_origin=None) -> Params:
    """compress_nd's set-up: the float 2-D/3-D kernels receive
    realPrecision narrowed to float, the float 4-D and every double kernel
    keep it double; req_length from the narrowed precision.  With
    ``subblock_origin`` (the region's corner in the whole field), the
    subblock form and its optimizer."""
    sub = subblock_origin is not None
    f = form(data.dtype.type, data.ndim, sub)
    rp = f.RT(real_precision)
    recip = f.RT(f.RT(1) / rp)
    if opt_quant_mode == 1 and sub:
        intervals = optimize_intervals_subblock(
            data, subblock_origin, real_precision, max_range_radius,
            sample_distance, pred_threshold)
    elif opt_quant_mode == 1:
        intervals = optimize_intervals(data, float(real_precision),
                                       max_range_radius, sample_distance,
                                       pred_threshold)
    else:
        intervals = fixed_intervals
    req_length, median = classic.req_length_median(rp, value_range, median,
                                                   f.T)
    return Params(f, rp, recip, int(intervals), int(intervals) // 2,
                  req_length, median)
