"""``compress`` / ``decompress`` / ``decompress_region`` /
``compress_region`` / ``get_metadata`` of the PyTorch port, for the slice it covers: float32 and float64 fields of rank 1 to 4
under any error bound that resolves to an absolute one (ABS, REL,
ABS_AND_REL, ABS_OR_REL, PSNR, NORM) through the SZ2.1
blocked-regression codec (ranks 2-4, rank 4 folded to 3), the
random-access block codec (float32 with ``random_access``, ranks 1-3) or
the classic SZ1.4 codec (rank 1, regression off, rank 4 with random
access, and float64 with random access); and under any point-wise
relative bound (PW_REL and the modes above it) through the MSST19 codec
(both dtypes, when it is accelerated: ``accelerate_pw_rel`` and a ratio
of at least 1e-5, the reference's default route) or the pre-log codec
(the rest).  ``decompress_region`` decodes a region of a random-access
stream from the blocks that cover it.  ``compress_region`` compresses a
region of a larger field (SZ_compress_args3) through the classic codec's
subblock form: K10's on ranks 2-4, the host 1-D recurrence's on rank 1.

``compress`` also takes a torch tensor.  One on the compute device (a
field a simulation holds on the card) is compressed where it lies, as
``sz_tpu`` compresses a ``jax.Array`` (``_try_compress_device``): the
range scan, the optimizer's gathers and every lattice-sized stage run on
the device, and the field crosses to the host only where the format
needs it whole (the verbatim StoreOri fallback, a PW_REL bound, whose
scans run on the host, the classic codec, whose optimizer and 1-D
recurrence run there, or the random-access codec, whose blocks are cut
there).  A tensor elsewhere is taken as a host array.

The stream framing (range scan, bound resolution, header, constant and
verbatim fallbacks, lossless wrap, decode clamp) is ``framing.py``, the
port's copy of ``sz_tpu.api``'s.  Both entry points run on the card
unless the caller passes ``device="cpu"``.  Every configuration outside
the slice raises ``NotImplementedError`` naming its ROADMAP item; nothing
is routed to a host codec.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from sz_tpu_torch import framing, native
from sz_tpu_torch.config import (DEFAULT_CONFIG, MIN_NUM_OF_ELEMENTS,
                                 DataType, ErrorBoundMode, SZConfig, SZMode,
                                 data_type, float_type, np_dtype)
from sz_tpu_torch.core import classic, pwr, rablock
from sz_tpu_torch.format import bytes_util as bu
from sz_tpu_torch.format import lossless as ll
from sz_tpu_torch.format import metadata as md
from sz_tpu_torch.format import tdps as tdps_mod
from sz_tpu_torch.gpu import device as devmod
from sz_tpu_torch.gpu import (classic_engine, engine, int_kernel,
                              msst19_engine)


def _check_slice(dtype) -> bool:
    """True for the eight integer dtypes, False for float32 and float64;
    TypeError for any other."""
    dt = np_dtype(dtype)
    if dt.kind in "iu" and dt.itemsize in (1, 2, 4, 8):
        return True
    if dt not in (np.float32, np.float64):
        raise TypeError(f"unsupported dtype {dt}")
    return False


def _compress_int(data, cfg: SZConfig, dev, on_dev: bool) -> bytes:
    """The integer route (sz_tpu/api.py:187-188), before the float path
    and MIN_NUM_OF_ELEMENTS: a tensor on ``dev`` of rank 2-4 stays there
    (as its carrier, made contiguous there if it is not); rank 1 is
    downloaded, as the 1-D float route does."""
    dt = np_dtype(data.dtype)
    if on_dev and len(framing._filter_dims(data.shape)) >= 2:
        x = data.view(int_kernel.carrier(dt)).contiguous()
        return framing._compress_int(x, cfg, dev, dt)
    return framing._compress_int(framing._host(data), cfg, dev)


def _ra_route(cfg: SZConfig, dtype, ndim: int) -> bool:
    """The random-access block codec takes float32 fields of rank 1-3
    (sz_tpu/api.py:332); rank 4 ignores the flag (the classic codec on
    the folded lattice) and float64 has no random-access codec (the
    classic codec), as in the reference (sz_float.c:3010, sz_double.c)."""
    return (cfg.random_access and not cfg.error_bound_mode.is_pw_rel
            and np_dtype(dtype) == np.float32 and ndim <= 3)


def _regression_route(cfg: SZConfig, ndim: int) -> bool:
    """The SZ2.1 regression codec takes ranks 2-4 with regression on and
    random access off (sz_tpu/api.py:350-392); the classic codec the
    rest of the absolute bounds: rank 1, regression off, and rank 4
    with random access (on its folded 3-D lattice)."""
    return (not cfg.error_bound_mode.is_pw_rel and cfg.with_regression
            and not cfg.random_access and ndim >= 2)


def compress(data, cfg: SZConfig = DEFAULT_CONFIG, *,
             device="cuda") -> bytes:
    """Compress a float32 or float64 field into an SZ2 stream, byte-equal
    to ``sz_tpu.compress(data, cfg)``, with the device stages on
    ``device`` ('cuda' runs the Hopper kernels).  ``data`` is a numpy
    array or a torch tensor; a tensor on ``device`` stays there (made
    contiguous there if it is not) on the regression codec's route."""
    dev = devmod.resolve(device)
    native.tune_malloc()
    on_dev = torch.is_tensor(data) and data.device == dev
    data = data.detach() if on_dev else framing._host(data)
    dims = framing._filter_dims(data.shape)
    if _check_slice(data.dtype):
        return _compress_int(data, cfg, dev, on_dev)
    n = int(np.prod(dims))
    if n <= MIN_NUM_OF_ELEMENTS:
        # SZ_skip_compress_float: raw bytes
        return framing._host(data).tobytes()
    if on_dev and not _regression_route(cfg, len(dims)):
        # the PW_REL scans, the classic optimizer and the 1-D recurrence
        # run on the host (sz_tpu materializes a jax.Array here too)
        data, on_dev = framing._host(data), False
    if on_dev:
        data = data.contiguous()   # copied where it lies, if at all
    data = data.reshape(dims)
    dt = data_type(data.dtype)
    T = float_type(data.dtype)
    flat = data.reshape(-1)
    (fmin, fmax, value_range, rp, _mode, hdr_cfg,
     range_info) = framing._fp_stream_params(data, cfg, dt)
    if value_range <= rp:
        return framing._constant_stream(hdr_cfg, dt, fmin, fmax,
                                        framing._host(flat[:1])[0], n)
    ra = _ra_route(cfg, data.dtype, data.ndim)   # before the 4-D fold
    if data.ndim == 4 and (cfg.error_bound_mode.is_pw_rel
                           or cfg.with_regression):
        # fold 4-D to 3-D (sz_float.c:2989-2997, :3010); the classic
        # codec without regression has a 4-D kernel
        d = data.shape
        data = data.reshape(d[0] * d[1], d[2], d[3])
    kw = dict(max_range_radius=cfg.max_range_radius,
              sample_distance=cfg.sample_distance,
              pred_threshold=np.float32(cfg.pred_threshold),
              opt_quant_mode=cfg.opt_quant_mode,
              fixed_intervals=cfg.quantization_intervals, device=dev)
    if cfg.error_bound_mode.is_pw_rel:
        if range_info is not None:   # the accelerated codec, MSST19
            tdps = pwr.compress_pwrel(
                data, cfg.pw_rel_bound_ratio, range_info=range_info,
                encode=msst19_engine.compress, plus_bits=cfg.plus_bits,
                **kw)
        else:
            tdps = pwr.compress_prelog(data, cfg.pw_rel_bound_ratio, fmin,
                                       fmax, **kw)
        return framing._frame_pwrel_stream(cfg, hdr_cfg, dt, fmin, fmax,
                                           flat, n, tdps)
    if ra:
        res = rablock.compress_ra(data, rp, cfg, device=dev)
        return framing._frame_ra_stream(cfg, hdr_cfg, dt, fmin, fmax, n,
                                        res.body)
    if not _regression_route(cfg, data.ndim):
        # classic SZ1.4 (sz_float.c:353/610/946/1479)
        median = T(fmin + value_range / T(2))
        body = (classic.compress_1d if data.ndim == 1
                else classic_engine.compress)
        tdps = body(data, rp, value_range, median, **kw)
        return framing._frame_classic_stream(cfg, hdr_cfg, dt, fmin, fmax,
                                             flat, n, tdps)
    res = engine.compress(data, rp, size_type=cfg.size_type, **kw)
    return framing._frame_regression_stream(cfg, hdr_cfg, dt, fmin, fmax, flat,
                                         n, res)


def _clamp_tensor(out: torch.Tensor, hdr) -> torch.Tensor:
    """framing._protect_clamp for a torch tensor."""
    if not hdr.protect_range:
        return out
    T = float_type(out.dtype)
    mn = torch.tensor(T(hdr.params.fmin), device=out.device)
    mx = torch.tensor(T(hdr.params.fmax), device=out.device)
    return torch.where(out < mn, mn, torch.where(out > mx, mx, out))


def decompress(blob: bytes, shape, dtype=np.float32, *, device="cuda",
               as_tensor: bool = False):
    """Decode an SZ2 float32 or float64 stream, bit-equal to
    ``sz_tpu.decompress``: the regression codec's, the classic codec's
    (1-D to 4-D), and PW_REL's (MSST19 on float32, pre-log on both).
    Returns numpy, or a tensor on ``device`` when ``as_tensor``."""
    dev = devmod.resolve(device)
    native.tune_malloc()
    dims = framing._filter_dims(shape)
    if _check_slice(dtype):
        out = framing._decompress_int(blob, dims, np_dtype(dtype), dev,
                                      as_tensor)
        return out.reshape(tuple(shape))
    n = int(np.prod(dims))
    T = np_dtype(dtype).type

    def finish(out):
        if as_tensor:
            t = out if torch.is_tensor(out) else torch.from_numpy(
                np.ascontiguousarray(out)).to(dev)
            return t.reshape(tuple(shape))
        return out.reshape(shape)

    if n <= MIN_NUM_OF_ELEMENTS:
        return finish(np.frombuffer(blob, dtype=T, count=n).copy())
    dt = data_type(T)
    esize = np.dtype(T).itemsize
    mlen = md.meta_length(dt)
    if len(blob) not in (8 + 4 + mlen, 8 + 8 + mlen):
        inner = ll.decompress(blob, expected_size=n * esize + 4 + mlen + 8)
    else:
        inner = blob
    if DataType(inner[4 + 5] & 0x0F) != dt:
        raise TypeError(f"stream does not hold {np.dtype(T).name} data")
    hdr = md.parse_header(inner, dt)
    off = hdr.body_offset + hdr.size_type
    if hdr.lossless:
        out = np.frombuffer(inner, dtype=f">f{esize}", count=n, offset=off)
        return finish(framing._protect_clamp(out.astype(T), hdr, T))
    if hdr.same:
        v = np.frombuffer(inner, dtype=f">f{esize}", count=1, offset=off)[0]
        return finish(framing._protect_clamp(np.full(n, v, dtype=T), hdr, T))
    body = memoryview(inner)[off:]
    if hdr.regression and hdr.random_access:
        # the reference's random-access entry has no decode clamp
        return finish(rablock.decompress_ra(body, dims,
                                            size_type=hdr.size_type,
                                            device=dev, as_tensor=as_tensor))
    dims3 = (dims[0] * dims[1], dims[2], dims[3]) if len(dims) == 4 else dims
    if hdr.regression and len(dims) > 1:
        out = engine.decompress(body, dims3, T, size_type=hdr.size_type,
                                device=dev, as_tensor=as_tensor)
    else:
        # classic, and 1-D data in a regression-flagged stream
        # (sz_tpu/api.py:540-548)
        t = tdps_mod.from_bytes(body, dt, is_pwr=hdr.pw_rel,
                                msst19=hdr.pw_rel and hdr.msst19,
                                size_type=hdr.size_type)
        if hdr.pw_rel and hdr.msst19:
            out = msst19_engine.decompress(t, dims3, T, device=dev,
                                           as_tensor=as_tensor)
        elif hdr.pw_rel:
            out = pwr.decompress_prelog(t, dims3, T, device=dev)
        elif len(dims) == 1:
            out = classic.decompress_1d(t, n, T, device=dev)
        else:
            out = classic_engine.decompress(t, dims, T, device=dev,
                                            as_tensor=as_tensor)
    if torch.is_tensor(out):
        return finish(_clamp_tensor(out, hdr))
    return finish(framing._protect_clamp(out, hdr, T))


def decompress_region(blob: bytes, shape, start, end, dtype=np.float32, *,
                      device="cuda", as_tensor: bool = False):
    """Decode the region [start, end) (end exclusive, in the field's
    dimensions after size-1 ones are dropped) of a random-access stream
    from the blocks that cover it alone (SZ_decompress_args_randomaccess,
    szd_float.c:7597), bit-equal to ``sz_tpu.decompress_region``.  Raises
    ValueError for any other stream, as the reference does
    (szd_float.c:7681)."""
    dev = devmod.resolve(device)
    native.tune_malloc()
    dims = framing._filter_dims(shape)
    _check_slice(dtype)
    n = int(np.prod(dims))
    dt = data_type(dtype)   # TypeError for an integer dtype
    mlen = md.meta_length(dt)
    if len(blob) not in (8 + 4 + mlen, 8 + 8 + mlen):
        inner = ll.decompress(
            blob, expected_size=n * np_dtype(dtype).itemsize + 4 + mlen + 8)
    else:
        inner = blob
    hdr = md.parse_header(inner, dt)
    if not (hdr.regression and hdr.random_access):
        raise ValueError(
            "region decode requires a random-access stream "
            "(compress with SZConfig(random_access=True))")
    off = hdr.body_offset + hdr.size_type
    return rablock.decompress_ra(memoryview(inner)[off:], dims, start, end,
                                 size_type=hdr.size_type, device=dev,
                                 as_tensor=as_tensor)


def compress_region(data, start, end, cfg: SZConfig = DEFAULT_CONFIG, *,
                    mode: ErrorBoundMode = None, abs_bound: float = None,
                    rel_bound: float = None, device="cuda") -> bytes:
    """Compress the region [start, end) (end exclusive; the reference takes
    inclusive corners) of a float32 or float64 field into a classic stream
    of the region's shape, byte-equal to ``sz_tpu.compress_region``
    (SZ_compress_args3, sz.c:403; SZ_compress_args_float_subblock,
    sz_float.c:3046).  Decode it with ``decompress(blob, region_shape)``.

    The bound comes from ``mode`` / ``abs_bound`` / ``rel_bound`` (cfg's
    where not given); the reference's quirks are kept: the header's
    params block is ``cfg`` unmodified and its fmin/fmax are zeros;
    PW_REL raises NotImplementedError (the reference produces nothing,
    sz_float.c:3104); a region whose value range is at most the precision
    gives the constant stream; the quantizer is the subblock form (double,
    a division, no epsilon recheck).  ``data`` is a numpy array or a torch
    tensor (taken to the host: the region is cut there); the recurrence of
    ranks 2-4 runs on ``device``."""
    dev = devmod.resolve(device)
    native.tune_malloc()
    data = framing._host(data)
    if np_dtype(data.dtype) not in (np.float32, np.float64):
        raise TypeError(f"subblock compression: {data.dtype}")
    dt = data_type(data.dtype)
    T = float_type(data.dtype)
    start = tuple(int(s) for s in start)
    end = tuple(int(e) for e in end)
    region = np.ascontiguousarray(
        data[tuple(slice(s, e) for s, e in zip(start, end))], dtype=T)
    if region.ndim > 4:
        raise NotImplementedError("subblock supports up to 4D")
    n = region.size
    flat = region.reshape(-1)
    # computeRangeSize_float_subblock (dataCompression.c:196)
    fmin = T(flat.min())
    value_range = T(T(flat.max()) - fmin)
    fmax = T(fmin + value_range)
    bound_cfg = cfg
    if mode is not None:
        bound_cfg = dataclasses.replace(
            cfg, error_bound_mode=mode,
            abs_err_bound=cfg.abs_err_bound if abs_bound is None
            else abs_bound,
            rel_bound_ratio=cfg.rel_bound_ratio if rel_bound is None
            else rel_bound)
    rp, eff_mode = framing._resolve_precision(bound_cfg, float(value_range),
                                              n, dt)
    if eff_mode == ErrorBoundMode.PW_REL:
        raise NotImplementedError(
            "subblock does not support point-wise relative bounds "
            "(sz_float.c:3104)")
    if value_range <= rp:
        # the reference leaves this a TODO (sz_float.c:3095) and produces
        # nothing; the constant stream, as sz_tpu emits
        return framing._constant_stream(cfg, dt, fmin, fmax, flat[0], n)
    median = T(fmin + value_range / T(2))
    kw = dict(max_range_radius=cfg.max_range_radius,
              sample_distance=cfg.sample_distance,
              pred_threshold=np.float32(cfg.pred_threshold),
              opt_quant_mode=1 if cfg.quantization_intervals == 0 else 0,
              fixed_intervals=cfg.quantization_intervals, device=dev)
    if region.ndim == 1:
        t = classic.compress_1d(region, rp, value_range, median,
                                subblock=True, **kw)
    else:
        t = classic_engine.compress(region, rp, value_range, median,
                                    subblock_origin=start, **kw)
    # SZ_compress_args3 never runs computeRangeSize into confparams: the
    # header's fmin/fmax serialize as zeros
    body = (md.make_header(cfg, dt, T(0), T(0)) + bu.size_be(n, cfg.size_type)
            + tdps_mod.to_bytes(t, cfg.size_type))
    if cfg.sz_mode == SZMode.BEST_SPEED:
        return body
    return ll.compress(body, cfg.lossless, cfg.lossless_level)


def get_metadata(blob: bytes) -> dict:
    """SZ_getMetadata (sz.c:683): the header of a float stream, as
    ``sz_tpu.get_metadata`` reads it."""
    inner = ll.decompress(blob, 0)
    dt = DataType(inner[4 + 5] & 0x0F)   # the params block's type nibble
    hdr = md.parse_header(inner, dt)
    return {
        "version": hdr.version,
        "data_type": dt,
        "is_constant": hdr.same,
        "is_lossless": hdr.lossless,
        "regression": hdr.regression,
        "size_type": hdr.size_type,
        "num_elements": bu.read_size_be(inner, hdr.body_offset,
                                        hdr.size_type),
        "error_bound_mode": hdr.params.error_bound_mode,
        "bound1": float(hdr.params.bound1),
        "bound2": float(hdr.params.bound2),
        "max_quant_intervals": hdr.params.max_quant_intervals,
        "fmin": hdr.params.fmin,
        "fmax": hdr.params.fmax,
    }
