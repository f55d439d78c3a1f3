"""Immutable configuration (the port's copy of ``sz_tpu.config``).

One frozen dataclass passed explicitly replaces the reference's mutable
globals (``confparams_cpr``, sz.c:35-53).  Field defaults mirror the
reference defaults installed when no config file is given
(conf.c:99-141); the enums and constants keep the reference's values
(defines.h), because they are serialized into the stream header.
"""

from __future__ import annotations

import dataclasses
import enum


class ErrorBoundMode(enum.IntEnum):
    """Error bound modes (defines.h:29-41)."""

    ABS = 0
    REL = 1  # value-range relative (VR_REL)
    ABS_AND_REL = 2
    ABS_OR_REL = 3
    PSNR = 4
    NORM = 5
    PW_REL = 10
    ABS_AND_PW_REL = 11
    ABS_OR_PW_REL = 12
    REL_AND_PW_REL = 13
    REL_OR_PW_REL = 14

    @property
    def is_pw_rel(self) -> bool:
        """errorBoundMode >= PW_REL: the pointwise-relative family
        (sz_float.c:2888)."""
        return self >= ErrorBoundMode.PW_REL


class DataType(enum.IntEnum):
    """Data types (defines.h:43-52)."""

    FLOAT = 0
    DOUBLE = 1
    UINT8 = 2
    INT8 = 3
    UINT16 = 4
    INT16 = 5
    UINT32 = 6
    INT32 = 7
    UINT64 = 8
    INT64 = 9


class SZMode(enum.IntEnum):
    """Lossless-stage gate (defines.h:67-70)."""

    BEST_SPEED = 0
    BEST_COMPRESSION = 1
    DEFAULT_COMPRESSION = 2
    TEMPORAL_COMPRESSION = 3


class Lossless(enum.IntEnum):
    """Final lossless backend (defines.h:103-104)."""

    GZIP = 0  # zlib
    ZSTD = 1


# Streams with <= this many elements are stored verbatim (defines.h:27).
MIN_NUM_OF_ELEMENTS = 20

# Serialized parameter block lengths (defines.h:97-98).
META_DATA_BYTE_LENGTH = 28
META_DATA_BYTE_LENGTH_DOUBLE = 36

VERSION = (2, 1, 12)  # stream-compatible with SZ 2.1.12.x


@dataclasses.dataclass(frozen=True)
class SZConfig:
    """Immutable analog of ``sz_params`` (sz.h:164-198).

    Defaults equal the reference's no-config-file defaults (conf.c:99-141)
    except ``error_bound_mode``, which callers almost always override.
    """

    error_bound_mode: ErrorBoundMode = ErrorBoundMode.PSNR
    abs_err_bound: float = 1e-4
    rel_bound_ratio: float = 1e-4
    pw_rel_bound_ratio: float = 1e-3
    psnr: float = 90.0
    norm_err: float = 0.0

    sz_mode: SZMode = SZMode.BEST_COMPRESSION
    lossless: Lossless = Lossless.ZSTD
    # zstd level when lossless==ZSTD (conf.c:117: default 3);
    # zlib level when lossless==GZIP (conf.c:119: default 1).
    lossless_level: int = 3

    max_quant_intervals: int = 65536
    quantization_intervals: int = 0  # 0 => optimize automatically
    pred_threshold: float = 0.99
    sample_distance: int = 100

    with_regression: bool = True  # SZ 2.1 blocked regression vs SZ 1.4
    random_access: bool = False
    protect_value_range: bool = False

    sol_id: int = 101  # SZ (defines.h:21)
    data_endian_little: bool = True
    size_type: int = 8  # sizeof(size_t) on the producing system

    @property
    def max_range_radius(self) -> int:
        return self.max_quant_intervals // 2

    @property
    def opt_quant_mode(self) -> int:
        return 1 if self.quantization_intervals == 0 else 0

    def with_bound(self, mode: ErrorBoundMode, value: float) -> "SZConfig":
        """Return a new config with the given bound mode/value set."""
        kw = {"error_bound_mode": ErrorBoundMode(mode)}
        if mode in (ErrorBoundMode.ABS, ErrorBoundMode.ABS_AND_REL,
                    ErrorBoundMode.ABS_OR_REL, ErrorBoundMode.ABS_AND_PW_REL,
                    ErrorBoundMode.ABS_OR_PW_REL):
            kw["abs_err_bound"] = value
        elif mode in (ErrorBoundMode.REL, ErrorBoundMode.REL_AND_PW_REL,
                      ErrorBoundMode.REL_OR_PW_REL):
            kw["rel_bound_ratio"] = value
        elif mode == ErrorBoundMode.PW_REL:
            kw["pw_rel_bound_ratio"] = value
        elif mode == ErrorBoundMode.PSNR:
            kw["psnr"] = value
        elif mode == ErrorBoundMode.NORM:
            kw["norm_err"] = value
        return dataclasses.replace(self, **kw)


DEFAULT_CONFIG = SZConfig()
