"""The codec's per-call state as device tensors.

The SZ codec has no weights; what it carries through a call is host-built
state: the quantized regression coefficients per block (``lc_full``), the
per-block predictor choice (``use_reg``), the per-axis in-block offsets
(``loc``), the scalars ``rp``, ``recip``, ``intervals`` and ``mean``, and
once the histogram is known the Huffman code table.  The JAX engine keeps
all of it as numpy; :func:`from_numpy_state` puts the same numpy values on
a torch device, so tests can hand both sides the same state.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class CodecState:
    lc_full: torch.Tensor          # (nblocks, ncoeff) float32
    use_reg: torch.Tensor          # (nblocks,) bool
    loc: tuple                     # per-axis in-block offsets, int32
    rp: np.float32
    recip: np.float32
    intervals: int
    mean: np.float32
    code_hi: torch.Tensor = None   # (state_num,) int64 bit patterns
    code_lo: torch.Tensor = None   # (state_num,) int64 bit patterns
    code_len: torch.Tensor = None  # (state_num,) int32

    def with_tables(self, tables) -> "CodecState":
        """This state plus a ``huffman.HuffmanTables``' code table."""
        dev = self.lc_full.device
        return dataclasses.replace(self, **table_tensors(tables, dev))

    def to_numpy(self) -> dict:
        """The numpy values this state was built from (uint64 halves)."""
        out = {"lc_full": self.lc_full.cpu().numpy(),
               "use_reg": self.use_reg.cpu().numpy(),
               "loc": tuple(l.cpu().numpy() for l in self.loc),
               "rp": self.rp, "recip": self.recip,
               "intervals": self.intervals, "mean": self.mean}
        if self.code_len is not None:
            out["code_hi"] = self.code_hi.cpu().numpy().view(np.uint64)
            out["code_lo"] = self.code_lo.cpu().numpy().view(np.uint64)
            out["code_len"] = self.code_len.cpu().numpy()
        return out


def table_tensors(tables, device) -> dict:
    def u64(a):
        return torch.from_numpy(
            np.ascontiguousarray(a, dtype=np.uint64).view(np.int64)).to(device)

    return {"code_hi": u64(tables.code_hi), "code_lo": u64(tables.code_lo),
            "code_len": torch.from_numpy(
                np.asarray(tables.code_len, dtype=np.int32)).to(device)}


def from_numpy_state(*, lc_full, use_reg, loc, rp, recip, intervals, mean,
                     device, tables=None) -> CodecState:
    """Numpy codec state -> :class:`CodecState` on ``device``.  ``tables``
    (optional) is a ``huffman.HuffmanTables``."""
    st = CodecState(
        lc_full=torch.from_numpy(
            np.ascontiguousarray(lc_full, dtype=np.float32)).to(device),
        use_reg=torch.from_numpy(np.asarray(use_reg, dtype=bool)).to(device),
        loc=tuple(torch.from_numpy(np.asarray(l, dtype=np.int32)).to(device)
                  for l in loc),
        rp=np.float32(rp), recip=np.float32(recip),
        intervals=int(intervals), mean=np.float32(mean))
    return st if tables is None else st.with_tables(tables)
