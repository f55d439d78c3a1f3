"""Final lossless stage: zstd / zlib wrap and unwrap, with format sniffing.

Mirrors sz_lossless_compress / sz_lossless_decompress /
is_lossless_compressed_data (utility.c:156-215).  zstd is the vendored
1.3.5 release of ``sz_tpu_torch.native`` (the reference's own), so outer
frames are byte-equal to the reference binary's.  SZ_TPU_SYSTEM_ZSTD=1
takes the ``zstandard`` package's encoder instead, as ``sz_tpu`` does
(multithreaded from 4 MB; standard frames, other bytes); where that
package is absent it raises RuntimeError.  Decoding always takes the
vendored decoder, which reads either frame.
"""

from __future__ import annotations

import os
import zlib

from sz_tpu_torch import native
from sz_tpu_torch.config import Lossless

_ZSTD_MAGIC = b"\x28\xb5\x2f\xfd"
_ZLIB_MAGIC = {(0x78, 0x01), (0x78, 0x5E), (0x78, 0x9C), (0x78, 0xDA),
               (0x78, 0x20), (0x78, 0x7D), (0x78, 0xBB), (0x78, 0xF9)}


def _system_zstd(data: bytes, level: int) -> bytes:
    """The zstandard package's frame of ``data``, with its content size
    (the decoder's sniffing needs it, utility.c:158-161)."""
    try:
        import zstandard
    except ImportError:
        raise RuntimeError("zstandard module unavailable") from None
    threads = -1 if len(data) >= (4 << 20) else 0
    return zstandard.ZstdCompressor(level=level, write_content_size=True,
                                    write_checksum=False,
                                    threads=threads).compress(data)


def compress(data: bytes, backend: Lossless, level: int) -> bytes:
    if backend == Lossless.ZSTD:
        if os.environ.get("SZ_TPU_SYSTEM_ZSTD") == "1":
            return _system_zstd(data, level)
        return native.zstd_compress(data, level)
    if backend == Lossless.GZIP:
        # zlib_compress5 (callZlib.c:205): plain zlib stream at `level`
        return zlib.compress(data, level)
    raise ValueError(f"unknown lossless backend {backend}")


def sniff(blob: bytes):
    """is_lossless_compressed_data (utility.c:156): Lossless or None."""
    if blob[:4] == _ZSTD_MAGIC:
        return Lossless.ZSTD
    if len(blob) >= 2 and (blob[0], blob[1]) in _ZLIB_MAGIC:  # isZlibFormat
        return Lossless.GZIP
    return None


def decompress(blob: bytes, expected_size: int) -> bytes:
    """Unwrap a zstd or zlib frame; any other blob is returned as it is
    (an SZ_BEST_SPEED stream is not wrapped).  ``expected_size`` bounds a
    zstd frame whose header carries no content size."""
    backend = sniff(blob)
    if backend is None:
        return blob
    if backend == Lossless.ZSTD:
        n = native.zstd_frame_content_size(blob)
        return native.zstd_decompress(blob, n if n >= 0 else expected_size)
    return zlib.decompress(blob)
