"""Typed binary file I/O with endian handling (rw.c / rwf.c analogs; the
port's copy of ``sz_tpu.io``).

The reference's readers (`readFloatData` rw.c:425, `readDoubleData`,
`readByteData`, and the writers) byte-swap when the file's
`dataEndianType` (sz.config) differs from the machine
(`sysEndianType`).  numpy dtype strings carry the same information, so
these helpers are thin but keep the reference's semantics: a config
says how the FILE is laid out, and arrays in memory are always native.
"""

from __future__ import annotations

import os

import numpy as np

from sz_tpu_torch.config import SZConfig


def _file_dtype(dtype, big_endian: bool) -> np.dtype:
    dt = np.dtype(dtype)
    if dt.itemsize == 1:
        return dt
    return dt.newbyteorder(">" if big_endian else "<")


def read_array(path, dtype, count: int = -1, *,
               big_endian: bool = False,
               cfg: SZConfig | None = None) -> np.ndarray:
    """readXData (rw.c): typed read with endian swap to native.

    `big_endian` (or the config's dataEndianType when a config is
    given) describes the FILE; the returned array is native-endian."""
    if cfg is not None:
        big_endian = not cfg.data_endian_little
    raw = np.fromfile(path, dtype=_file_dtype(dtype, big_endian),
                      count=count)
    return raw.astype(np.dtype(dtype), copy=False)


def write_array(data: np.ndarray, path, *, big_endian: bool = False,
                cfg: SZConfig | None = None) -> None:
    """writeXData_inBytes (rw.c): typed write in the requested file
    endianness."""
    if cfg is not None:
        big_endian = not cfg.data_endian_little
    np.asarray(data).astype(
        _file_dtype(data.dtype, big_endian), copy=False).tofile(path)


def check_file_size(path) -> int:
    """checkFileSize (rw.c:27)."""
    return os.path.getsize(path)
