"""The SZRA slab container (the port's copy of ``sz_tpu.ra``, bytes
equal).

A field is cut along axis 0 into slabs; each slab is an ordinary SZ2
stream, decodable alone (by the port, by ``sz_tpu`` or by the reference
binary), and an offset index gives O(1) access to any slab:

    [magic "SZRA" 4B][version u8][dtype u8][rank u8][slab_axis u8=0]
    [shape rank*u64 LE][n_slabs u32 LE][slab_starts (n+1)*u64 LE]
    [offsets (n+1)*u64 LE][payload_0]...[payload_{n-1}]

This is also the multi-device container: ``parallel/slab.py`` compresses
the slabs on several devices, streams or processes, and the ordered
concatenation happens here (the MPI-rank-independent chunk pattern of the
reference's HDF5 filter, test_mpio.c).  Every entry point runs on the
card unless the caller passes ``device="cpu"``.
"""

from __future__ import annotations

import struct

import numpy as np

from sz_tpu_torch import api
from sz_tpu_torch.config import DEFAULT_CONFIG, SZConfig

MAGIC = b"SZRA"

_DT_CODE = {np.dtype(np.float32): 0, np.dtype(np.float64): 1}
_CODE_DT = {v: k for k, v in _DT_CODE.items()}


def _slab_bounds(r0: int, n_slabs: int) -> np.ndarray:
    """Equal-ish slab starts along axis 0 (last slab takes the remainder)."""
    base = r0 // n_slabs
    starts = np.arange(n_slabs + 1, dtype=np.uint64) * base
    starts[-1] = r0
    return starts


def compress(data: np.ndarray, cfg: SZConfig = DEFAULT_CONFIG,
             slab_points: int = 1 << 22, n_slabs: int = None, *,
             device="cuda") -> bytes:
    """Compress into the container, one slab after another on
    ``device``; byte-equal to ``sz_tpu.ra.compress``.

    Each slab (along axis 0) is an independent SZ stream; slab size
    defaults to ~4M points.  n_slabs overrides (e.g. = the device count
    of a multi-device encode)."""
    data = np.asarray(data)
    if data.dtype not in _DT_CODE:
        raise TypeError(f"random-access container: {data.dtype}")
    shape = data.shape
    r0 = shape[0]
    if n_slabs is None:
        per_slab = max(1, int(slab_points // max(
            1, int(np.prod(shape[1:])))))
        n_slabs = max(1, (r0 + per_slab - 1) // per_slab)
    n_slabs = min(n_slabs, r0)
    starts = _slab_bounds(r0, n_slabs)

    payloads = []
    for s in range(n_slabs):
        a, b = int(starts[s]), int(starts[s + 1])
        payloads.append(api.compress(data[a:b], cfg, device=device))
    return build_container(shape, data.dtype, starts, payloads)


def build_container(shape, dtype, starts: np.ndarray, payloads) -> bytes:
    """Assemble the container from per-slab payload streams (the ordered
    concatenation of the parallel codec, sz_omp.c:313-325: offsets are
    the exclusive scan of payload sizes)."""
    n_slabs = len(payloads)
    out = bytearray()
    out += MAGIC
    out += bytes([1, _DT_CODE[np.dtype(dtype)], len(shape), 0])
    for r in shape:
        out += struct.pack("<Q", r)
    out += struct.pack("<I", n_slabs)
    out += np.asarray(starts).astype("<u8").tobytes()
    offsets = np.zeros(n_slabs + 1, dtype=np.uint64)
    for i, p in enumerate(payloads):
        offsets[i + 1] = offsets[i] + len(p)
    out += offsets.astype("<u8").tobytes()
    for p in payloads:
        out += p
    return bytes(out)


class Reader:
    """Parsed container with O(1) slab access (a region decode touches
    only the slabs it covers, SZ_decompress_args_randomaccess analog,
    szd_float.c:7597)."""

    def __init__(self, blob: bytes):
        if blob[:4] != MAGIC:
            raise ValueError("not an SZRA container")
        ver, dtc, rank, axis = blob[4:8]
        pos = 8
        self.shape = tuple(
            struct.unpack_from("<Q", blob, pos + 8 * i)[0]
            for i in range(rank))
        pos += 8 * rank
        (self.n_slabs,) = struct.unpack_from("<I", blob, pos)
        pos += 4
        self.starts = np.frombuffer(blob, dtype="<u8",
                                    count=self.n_slabs + 1, offset=pos)
        pos += 8 * (self.n_slabs + 1)
        self.offsets = np.frombuffer(blob, dtype="<u8",
                                     count=self.n_slabs + 1, offset=pos)
        pos += 8 * (self.n_slabs + 1)
        self.base = pos
        self.blob = blob
        self.dtype = _CODE_DT[dtc]

    def slab_bytes(self, i: int) -> bytes:
        a = self.base + int(self.offsets[i])
        b = self.base + int(self.offsets[i + 1])
        return self.blob[a:b]

    def decode_slab(self, i: int, device="cuda", as_tensor: bool = False):
        """Slab ``i`` decoded on ``device``: numpy, or the tensor there
        when ``as_tensor``."""
        a, b = int(self.starts[i]), int(self.starts[i + 1])
        shp = (b - a, *self.shape[1:])
        return api.decompress(self.slab_bytes(i), shp, self.dtype,
                              device=device, as_tensor=as_tensor)

    def decode_region(self, start0: int, end0: int,
                      device="cuda") -> np.ndarray:
        """Decode rows [start0, end0) of axis 0, touching only the
        slabs that intersect the region."""
        first = int(np.searchsorted(self.starts, start0, "right") - 1)
        last = int(np.searchsorted(self.starts, end0, "left"))
        parts = []
        for i in range(first, last):
            sl = self.decode_slab(i, device)
            a = int(self.starts[i])
            lo = max(start0 - a, 0)
            hi = min(int(self.starts[i + 1]), end0) - a
            parts.append(sl[lo:hi])
        return np.concatenate(parts, axis=0)

    def decode(self, device="cuda") -> np.ndarray:
        return self.decode_region(0, int(self.shape[0]), device)


def decompress(blob: bytes, device="cuda") -> np.ndarray:
    """The whole field of a container, bit-equal to
    ``sz_tpu.ra.decompress``."""
    return Reader(blob).decode(device)
