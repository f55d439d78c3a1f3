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

import numpy as np


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


def np_dtype(dtype) -> np.dtype:
    """The numpy dtype of a numpy dtype-like or a torch dtype."""
    if type(dtype).__module__ == "torch":
        return np.dtype(str(dtype).removeprefix("torch."))
    return np.dtype(dtype)


def float_type(dtype) -> type:
    """np.float32 or np.float64 for a float32 or float64 dtype (numpy or
    torch), the two the codecs take; TypeError for any other."""
    T = np_dtype(dtype).type
    if T not in (np.float32, np.float64):
        raise TypeError(f"float32 or float64 expected, not {np_dtype(dtype)}")
    return T


def data_type(dtype) -> DataType:
    """The stream's DataType of a float32 or float64 dtype."""
    return DataType.FLOAT if float_type(dtype) is np.float32 else \
        DataType.DOUBLE


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


class CompressionType(enum.IntEnum):
    """Per-step choice in temporal mode (defines.h:79-81)."""

    FORCE_SNAPSHOT = 0
    FORCE_TEMPORAL = 1
    PERIO_TEMPORAL = 2


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
    accelerate_pw_rel: bool = True  # MSST19 when applicable
    plus_bits: int = 3

    snapshot_cmpr_step: int = 5  # temporal mode snapshot period
    segment_size: int = 36  # legacy pwr segment size
    pwr_type: int = 0  # SZ_PWR_MIN_TYPE

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

    @classmethod
    def from_file(cls, path) -> "SZConfig":
        """Load an sz.config INI — SZ_ReadConf (conf.c:74-391).

        Mirrors iniparser semantics, including the config-file-path
        defaults that DIFFER from the no-file defaults (predThreshold 0,
        sampleDistance 0, segment_size 0, bounds 0, protectValueRange
        YES when the key is absent): a stream produced after loading a
        config file serializes those values, so faithful loading is part
        of byte parity."""
        import configparser

        cp = configparser.ConfigParser(inline_comment_prefixes=("#", ";"),
                                       strict=False)
        cp.optionxform = str.lower  # iniparser lowercases keys
        with open(path) as f:
            cp.read_string(f.read())

        def get(key, default=None):
            for sec in ("PARAMETER", "parameter", "ENV", "env"):
                if cp.has_option(sec, key.lower()):
                    return cp.get(sec, key.lower()).strip().strip('"')
            return default

        kw = {}
        sol = get("sol_name", "SZ")
        kw["sol_id"] = {"SZ": 101, "PASTRI": 103,
                        "SZ_Transpose": 104}.get(sol, 101)
        kw["data_endian_little"] = get(
            "dataEndianType", "LITTLE_ENDIAN_DATA") != "BIG_ENDIAN_DATA"
        mqi = int(get("max_quant_intervals", 65536))
        qi = int(get("quantization_intervals", 0))
        if qi > 0:
            qi = 1 << (qi - 1).bit_length()  # roundUpToPowerOf2
            mqi = qi
        kw["max_quant_intervals"] = mqi
        kw["quantization_intervals"] = qi
        kw["pred_threshold"] = float(get("predThreshold", 0.0))
        kw["sample_distance"] = int(get("sampleDistance", 0))
        kw["sz_mode"] = {"SZ_BEST_SPEED": SZMode.BEST_SPEED,
                         "SZ_DEFAULT_COMPRESSION":
                             SZMode.DEFAULT_COMPRESSION,
                         "SZ_BEST_COMPRESSION": SZMode.BEST_COMPRESSION,
                         }[get("szMode", "SZ_BEST_COMPRESSION")]
        lossless = get("losslessCompressor", "ZSTD_COMPRESSOR")
        kw["lossless"] = (Lossless.GZIP if lossless == "GZIP_COMPRESSOR"
                          else Lossless.ZSTD)
        if kw["lossless"] == Lossless.GZIP:
            kw["lossless_level"] = {
                "Gzip_NO_COMPRESSION": 0, "Gzip_BEST_SPEED": 1,
                "Gzip_BEST_COMPRESSION": 9,
                "Gzip_DEFAULT_COMPRESSION": -1,
            }.get(get("gzipMode", "Gzip_BEST_SPEED"), 1)
        else:
            kw["lossless_level"] = {
                "Zstd_BEST_SPEED": 1, "Zstd_HIGH_SPEED": 3,
                "Zstd_HIGH_COMPRESSION": 19, "Zstd_BEST_COMPRESSION": 22,
                "Zstd_DEFAULT_COMPRESSION": 3,
            }.get(get("zstdMode", "Zstd_HIGH_SPEED"), 3)
        kw["with_regression"] = get("withLinearRegression",
                                    "YES").upper() == "YES"
        kw["protect_value_range"] = get("protectValueRange",
                                        "YES").upper() == "YES"
        kw["random_access"] = bool(int(get("randomAccess", 0)))
        kw["snapshot_cmpr_step"] = int(get("snapshotCmprStep", 5))
        ebm = get("errorBoundMode")
        if ebm is None:
            raise ValueError("errorBoundMode missing in config "
                             "(conf.c:174 exits)")
        names = {m.name: m for m in ErrorBoundMode}
        names["VR_REL"] = ErrorBoundMode.REL
        kw["error_bound_mode"] = names[ebm.upper()]
        kw["abs_err_bound"] = float(get("absErrBound", 0.0))
        kw["rel_bound_ratio"] = float(get("relBoundRatio", 0.0))
        kw["psnr"] = float(get("psnr", 0.0))
        kw["norm_err"] = float(get("normErr", 0.0))
        kw["pw_rel_bound_ratio"] = float(get("pw_relBoundRatio", 0.0))
        kw["segment_size"] = int(get("segment_size", 0))
        kw["accelerate_pw_rel"] = bool(int(
            get("accelerate_pw_rel_compression", 1)))
        kw["pwr_type"] = {"MIN": 0, "AVG": 1, "MAX": 2}.get(
            get("pwr_type", "MIN"), 1)
        kw["plus_bits"] = 3  # conf.c:97, not configurable via INI
        return cls(**kw)



DEFAULT_CONFIG = SZConfig()
