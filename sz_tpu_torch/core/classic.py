"""The exact-value escape stream of the classic container, float32 and
raw mode (no median offset) only: what the MSST19 PW_REL codec uses of
``sz_tpu.core.classic`` (the port's copy).

Escapes store the value's binary representation truncated to
``req_length`` bits, with leading-byte dedup against the previous escape
(addExactData dataCompression.c:575, updateLossyCompElement
CompressElement.c:230); the batched stream and its decode run in the host
runtime (``native/host.c``).
"""

from __future__ import annotations

import numpy as np

from sz_tpu_torch import native
from sz_tpu_torch.format import bytes_util as bu


def get_exponent(value, T) -> int:
    """The unbiased binary exponent of ``value`` as a ``T``
    (getExponent_float/_double, ByteToolkit.c:308-360)."""
    if T is np.float32:
        bits = np.float32(value).view(np.int32)
        return int((int(bits) & 0x7F800000) >> 23) - 127
    bits = np.float64(value).view(np.int64)
    return int((int(bits) & 0x7FF0000000000000) >> 52) - 1023


class ExactEncoder:
    """Raw-mode float32 escape-value stream builder."""

    def __init__(self, req_length: int):
        self.req_length = req_length
        self.resi_bits_len = req_length % 8
        self.prev = bytes(4)
        self._lead = []
        self.mid_bytes = bytearray()
        self._resi = []

    def exact_count(self) -> int:
        return sum(len(a) for a in self._lead)

    def add_batch(self, values) -> np.ndarray:
        """Append ``values`` in order; returns their reconstructions."""
        vals = np.ascontiguousarray(values, dtype=np.float32)
        if vals.size == 0:
            return vals
        lead, mid, resi, recon, prev = native.exact_stream(
            vals, self.req_length, np.float32(0), True, self.prev)
        self._lead.append(lead)
        self.mid_bytes += mid
        if resi.size:
            self._resi.append(resi)
        self.prev = prev
        return recon

    def lead_packed(self) -> bytes:
        lead = (np.concatenate(self._lead) if self._lead
                else np.zeros(0, np.uint8))
        return bu.pack_bits_2(lead)

    def resi_packed(self) -> bytes:
        """convertIntArray2ByteArray_fast_dynamic (TypeManager.c:377):
        MSB-first fixed-width bitstream."""
        if self.resi_bits_len == 0 or not self._resi:
            return b""
        return native.pack_w_bits(np.concatenate(self._resi),
                                  self.resi_bits_len)


class ExactDecoder:
    """Inverse of :class:`ExactEncoder` over a TDPS's escape stream."""

    def __init__(self, tdps):
        self.req_length = tdps.req_length
        self.lead = bu.unpack_bits_2(tdps.lead_num, tdps.exact_data_num)
        self.mid = tdps.exact_mid_bytes
        self.resi = tdps.residual_mid_bits

    def next_batch(self, k: int) -> np.ndarray:
        """All ``k`` escape values at once; ``k`` must be the stream's
        escape count (``exact_data_num``), else the stream is corrupt."""
        if k != len(self.lead):
            raise ValueError(f"corrupt stream: {k} escapes coded, "
                             f"{len(self.lead)} stored")
        if k == 0:
            return np.zeros(0, dtype=np.float32)
        return native.classic1d_decode(
            np.zeros(k, np.int32), np.float32(0), 0, self.req_length,
            np.float32(0), True, self.lead, self.mid, self.resi)
