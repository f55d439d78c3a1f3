"""pysz-compatible facade (swig/pysz.h ConfigBuilder/Compressor; the
port's copy of ``sz_tpu.pysz``, its codec calls on ``device``).

Drop-in style API for users of the reference's Python bindings:

    from sz_tpu_torch.pysz import ConfigBuilder, Compressor
    cfg = (ConfigBuilder().errorBoundMode(ABS).absErrBound(1e-4).build())
    c = Compressor(cfg)                     # device="cuda" by default
    blob = c.Compress(data)                 # numpy array in
    out = c.Decompress(blob, data.shape, data.dtype)
"""

from __future__ import annotations

import dataclasses

import numpy as np

from sz_tpu_torch import api
from sz_tpu_torch.apps import exafel
from sz_tpu_torch.config import (DEFAULT_CONFIG, ErrorBoundMode, Lossless,
                                 SZConfig, SZMode)

# error-bound-mode constants, as the reference exports them
ABS = int(ErrorBoundMode.ABS)
REL = int(ErrorBoundMode.REL)
ABS_AND_REL = int(ErrorBoundMode.ABS_AND_REL)
ABS_OR_REL = int(ErrorBoundMode.ABS_OR_REL)
PSNR = int(ErrorBoundMode.PSNR)
NORM = int(ErrorBoundMode.NORM)
PW_REL = int(ErrorBoundMode.PW_REL)

SZ_BEST_SPEED = int(SZMode.BEST_SPEED)
SZ_BEST_COMPRESSION = int(SZMode.BEST_COMPRESSION)
SZ_DEFAULT_COMPRESSION = int(SZMode.DEFAULT_COMPRESSION)

GZIP_COMPRESSOR = int(Lossless.GZIP)
ZSTD_COMPRESSOR = int(Lossless.ZSTD)


class Config:
    def __init__(self, cfg: SZConfig, app: str = "SZ"):
        self.cfg = cfg
        self.app = app


class ConfigBuilder:
    """Fluent builder mirroring swig/pysz.h:52-81."""

    def __init__(self):
        self._cfg = DEFAULT_CONFIG
        self._app = "SZ"

    def _set(self, **kw) -> "ConfigBuilder":
        self._cfg = dataclasses.replace(self._cfg, **kw)
        return self

    def app(self, name: str):
        self._app = name
        return self

    def absErrBound(self, v):
        return self._set(abs_err_bound=float(v))

    def relBoundRatio(self, v):
        return self._set(rel_bound_ratio=float(v))

    def pw_relBoundRatio(self, v):
        return self._set(pw_rel_bound_ratio=float(v))

    def psnr(self, v):
        return self._set(psnr=float(v))

    def errorBoundMode(self, v):
        return self._set(error_bound_mode=ErrorBoundMode(v))

    def szMode(self, v):
        return self._set(sz_mode=SZMode(v))

    def gzipMode(self, v):
        return self._set(lossless_level=int(v))

    def losslessCompressor(self, v):
        return self._set(lossless=Lossless(v))

    def maxRangeRadius(self, v):
        return self._set(max_quant_intervals=2 * int(v))

    def max_quant_intervals(self, v):
        return self._set(max_quant_intervals=int(v))

    def quantization_intervals(self, v):
        return self._set(quantization_intervals=int(v))

    def predThreshold(self, v):
        return self._set(pred_threshold=float(v))

    def sampleDistance(self, v):
        return self._set(sample_distance=int(v))

    def segment_size(self, v):
        return self._set(segment_size=int(v))

    def snapshotCmprStep(self, v):
        return self._set(snapshot_cmpr_step=int(v))

    def randomAccess(self, v):
        return self._set(random_access=bool(v))

    def accelerate_pw_rel_compression(self, v):
        return self._set(accelerate_pw_rel=bool(v))

    def plus_bits(self, v):
        return self._set(plus_bits=int(v))

    def sol_ID(self, v):
        return self._set(sol_id=int(v))

    def dataType(self, v):
        return self  # inferred from the numpy array

    def predictionMode(self, v):
        return self

    def pwr_type(self, v):
        return self._set(pwr_type=int(v))

    def build(self) -> Config:
        return Config(self._cfg, self._app)


class Compressor:
    """Compressor facade (swig/pysz.h Compress/Decompress<T>).

    app codecs: "SZ"/"SZ2.0"/"SZ2.1" (default), "SZ1.4" (classic
    kernels), "SZ_Transpose", "ExaFEL" (pass exafel_params=ExaFELConfig,
    see sz_tpu_torch.apps.exafel).  The codec runs on ``device``."""

    def __init__(self, config: Config = None, exafel_params=None, *,
                 device="cuda"):
        self.config = config or Config(DEFAULT_CONFIG)
        self.exafel_params = exafel_params
        self.device = device

    def Compress(self, data: np.ndarray) -> bytes:
        app = self.config.app
        cfg = self.config.cfg
        if app == "SZ1.4":
            cfg = dataclasses.replace(cfg, with_regression=False)
        elif app == "SZ_Transpose":
            return api.compress(
                np.ascontiguousarray(np.asarray(data).T).reshape(-1), cfg,
                device=self.device)
        elif app == "ExaFEL":
            return exafel.compress(self.exafel_params, np.asarray(data),
                                   device=self.device)
        elif app not in ("SZ", "SZ2.0", "SZ2.1"):
            raise NotImplementedError(f"app codec {app!r}")
        return api.compress(np.asarray(data), cfg, device=self.device)

    def Decompress(self, blob: bytes, shape, dtype) -> np.ndarray:
        app = self.config.app
        if app == "SZ_Transpose":
            rshape = tuple(reversed(tuple(shape)))
            flat = api.decompress(blob, (int(np.prod(shape)),), dtype,
                                  device=self.device)
            return np.ascontiguousarray(flat.reshape(rshape).T)
        if app == "ExaFEL":
            shape4 = tuple(shape) if len(shape) == 4 else (1, *shape)
            return exafel.decompress(self.exafel_params, blob, *shape4,
                                     device=self.device)
        return api.decompress(blob, shape, dtype, device=self.device)


# convenience aliases matching the reference example/test.py usage
def compress(data, cfg: SZConfig = DEFAULT_CONFIG, *, device="cuda") -> bytes:
    return api.compress(data, cfg, device=device)


def decompress(blob, shape, dtype=np.float32, *,
               device="cuda") -> np.ndarray:
    return api.decompress(blob, shape, dtype, device=device)
