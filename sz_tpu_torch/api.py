"""``compress`` / ``decompress`` of the PyTorch port, for the slice it
covers: float32 fields of rank 2 or 3 (rank 4 folds to 3) through the
SZ2.1 blocked-regression codec, under any error bound that resolves to
an absolute one (ABS, REL, ABS_AND_REL, ABS_OR_REL, PSNR, NORM).

The stream framing (range scan, bound resolution, header, constant and
verbatim fallbacks, lossless wrap, decode clamp) is ``framing.py``, the
port's copy of ``sz_tpu.api``'s.  Both entry points run on the card
unless the caller passes ``device="cpu"``.  Every configuration outside
the slice raises ``NotImplementedError`` naming its ROADMAP item; nothing
is routed to a host codec.
"""

from __future__ import annotations

import numpy as np
import torch

from sz_tpu_torch import framing, native
from sz_tpu_torch.config import (DEFAULT_CONFIG, MIN_NUM_OF_ELEMENTS,
                                 DataType, SZConfig)
from sz_tpu_torch.format import bytes_util as bu
from sz_tpu_torch.format import lossless as ll
from sz_tpu_torch.format import metadata as md
from sz_tpu_torch.gpu import device as devmod
from sz_tpu_torch.gpu import engine


def _check_slice(dtype, ndim: int, cfg: SZConfig = None) -> None:
    dt = np.dtype(dtype)
    if dt.kind in "iu":
        raise NotImplementedError(
            "integer data is not ported yet (ROADMAP 1.10)")
    if dt == np.float64:
        raise NotImplementedError("float64 is not ported yet (ROADMAP 1.3)")
    if dt != np.float32:
        raise TypeError(f"unsupported dtype {dt}")
    if ndim == 1:
        raise NotImplementedError(
            "1-D data (classic codec) is not ported yet (ROADMAP 1.4)")
    if cfg is None:
        return
    if cfg.error_bound_mode.is_pw_rel:
        raise NotImplementedError(
            "PW_REL bounds are not ported yet (ROADMAP 1.5)")
    if not cfg.with_regression:
        raise NotImplementedError(
            "the classic codec (with_regression=False) is not ported yet "
            "(ROADMAP 1.4)")
    if cfg.random_access:
        raise NotImplementedError(
            "random-access streams are not ported yet (ROADMAP 1.6)")


def compress(data, cfg: SZConfig = DEFAULT_CONFIG, *,
             device="cuda") -> bytes:
    """Compress a float32 numpy array into an SZ2 stream, byte-equal to
    ``sz_tpu.compress(data, cfg)``, with the device stages on
    ``device`` ('cuda' runs the Hopper kernels)."""
    dev = devmod.resolve(device)
    native.tune_malloc()
    data = np.asarray(data)
    dims = framing._filter_dims(data.shape)
    _check_slice(data.dtype, len(dims), cfg)
    n = int(np.prod(dims))
    if n <= MIN_NUM_OF_ELEMENTS:
        return data.tobytes()   # SZ_skip_compress_float: raw bytes
    data = data.reshape(dims)
    dt = DataType.FLOAT
    flat = data.reshape(-1)
    (fmin, fmax, value_range, rp, _mode, hdr_cfg,
     _range_info) = framing._fp_stream_params(data, cfg, dt)
    if value_range <= rp:
        return framing._constant_stream(hdr_cfg, dt, fmin, fmax, flat[0], n)
    if data.ndim == 4:
        # the regression codec folds 4-D to 3-D (sz_float.c:3010)
        d = data.shape
        data = data.reshape(d[0] * d[1], d[2], d[3])
    res = engine.compress(
        data, rp, max_range_radius=cfg.max_range_radius,
        sample_distance=cfg.sample_distance,
        pred_threshold=np.float32(cfg.pred_threshold),
        opt_quant_mode=1 if cfg.quantization_intervals == 0 else 0,
        fixed_intervals=cfg.quantization_intervals,
        size_type=cfg.size_type, device=dev)
    return framing._frame_regression_stream(cfg, hdr_cfg, dt, fmin, fmax, flat,
                                         n, res)


def _clamp_tensor(out: torch.Tensor, hdr) -> torch.Tensor:
    """framing._protect_clamp for a torch tensor."""
    if not hdr.protect_range:
        return out
    mn = torch.tensor(np.float32(hdr.params.fmin), device=out.device)
    mx = torch.tensor(np.float32(hdr.params.fmax), device=out.device)
    return torch.where(out < mn, mn, torch.where(out > mx, mx, out))


def decompress(blob: bytes, shape, dtype=np.float32, *, device="cuda",
               as_tensor: bool = False):
    """Decode an SZ2 float32 regression stream, bit-equal to
    ``sz_tpu.decompress``.  Returns numpy, or a tensor on ``device`` when
    ``as_tensor``."""
    dev = devmod.resolve(device)
    native.tune_malloc()
    dims = framing._filter_dims(shape)
    _check_slice(dtype, len(dims))
    n = int(np.prod(dims))
    T = np.float32

    def finish(out):
        if as_tensor:
            t = out if torch.is_tensor(out) else torch.from_numpy(
                np.ascontiguousarray(out)).to(dev)
            return t.reshape(tuple(shape))
        return out.reshape(shape)

    if n <= MIN_NUM_OF_ELEMENTS:
        return finish(np.frombuffer(blob, dtype=T, count=n).copy())
    dt = DataType.FLOAT
    mlen = md.meta_length(dt)
    if len(blob) not in (8 + 4 + mlen, 8 + 8 + mlen):
        inner = ll.decompress(blob, expected_size=n * 4 + 4 + mlen + 8)
    else:
        inner = blob
    if DataType(inner[4 + 5] & 0x0F) != dt:
        raise TypeError("stream does not hold float32 data")
    hdr = md.parse_header(inner, dt)
    off = hdr.body_offset + hdr.size_type
    if hdr.lossless:
        out = np.frombuffer(inner, dtype=">f4", count=n, offset=off)
        return finish(framing._protect_clamp(out.astype(T), hdr, T))
    if hdr.same:
        v = bu.read_f32_be(inner, off)
        return finish(framing._protect_clamp(np.full(n, v, dtype=T), hdr, T))
    if hdr.pw_rel:
        raise NotImplementedError(
            "PW_REL streams are not ported yet (ROADMAP 1.5)")
    if not hdr.regression:
        raise NotImplementedError(
            "classic (SZ1.4) streams are not ported yet (ROADMAP 1.4)")
    if hdr.random_access:
        raise NotImplementedError(
            "random-access streams are not ported yet (ROADMAP 1.6)")
    dims3 = (dims[0] * dims[1], dims[2], dims[3]) if len(dims) == 4 else dims
    out = engine.decompress(memoryview(inner)[off:], dims3, T,
                            size_type=hdr.size_type,
                            device=dev, as_tensor=as_tensor)
    if as_tensor:
        return finish(_clamp_tensor(out, hdr))
    return finish(framing._protect_clamp(out, hdr, T))
