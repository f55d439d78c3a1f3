"""The random-access block codec's device stages: the port of
``sz_tpu.tpu.ra_engine.encode_blocks`` / ``decode_blocks``, identical
type lattices and reconstructions.

``encode_blocks`` uploads the edge-padded blocks, their predictor
indicator and coefficients and runs K12 (``gpu/ra_kernel.py``);
``decode_blocks`` places each selected block's escapes at their cells
with a cumulative sum on the device (the JAX engine does this on the
host, ``ra_engine.py:280-287``) and runs K13.  Span names follow the
other engines; each device span ends with a synchronize.  Sharding the
blocks over several devices (``ra_engine._shard_over_blocks``, ROADMAP
1.8) is not ported.
"""

from __future__ import annotations

import numpy as np
import torch

from sz_tpu_torch.gpu import device as devmod
from sz_tpu_torch.gpu import ra_kernel
from sz_tpu_torch.utils import trace as _tr


def _up(a, dtype, dev):
    return torch.from_numpy(np.ascontiguousarray(a, dtype)).to(dev)


def encode_blocks(blocks: np.ndarray, indicator: np.ndarray,
                  qcoeffs_full: np.ndarray, rank: int, bs: int, rp,
                  intervals: int, use_mean: bool, mean, *,
                  device) -> torch.Tensor:
    """The int32 type lattice (nb, bs^rank) of every block, on
    ``device``; ``indicator`` True for a Lorenzo block."""
    dev = devmod.resolve(device)
    nb = blocks.shape[0]
    with _tr.trace("upload"):
        b = _up(blocks.reshape(nb, bs ** rank), np.float32, dev)
        lor = _up(indicator, np.uint8, dev)
        qc = _up(qcoeffs_full, np.float32, dev)
        devmod.sync(dev)
    with _tr.trace("quantize"):
        types = ra_kernel.ra_encode(b, lor, qc, rank, bs, float(rp),
                                    int(intervals), int(intervals) // 2,
                                    bool(use_mean), np.float32(mean))
        devmod.sync(dev)
    return types


def decode_blocks(types: np.ndarray, rank: int, bs: int,
                  lor_sel: np.ndarray, qc_sel: np.ndarray, rp, radius: int,
                  use_mean: bool, mean, unpred: np.ndarray,
                  esc_base: np.ndarray, *, device) -> torch.Tensor:
    """The float32 values (nsel, bs^rank) of the selected blocks, on
    ``device``: ``types`` their type lattices, ``esc_base`` the index in
    ``unpred`` of each one's first escape."""
    dev = devmod.resolve(device)
    with _tr.trace("stream_upload"):
        t = _up(types, np.int32, dev)
        lor = _up(lor_sel, np.uint8, dev)
        qc = _up(qc_sel, np.float32, dev)
        up = _up(unpred, np.float32, dev)
        base = _up(esc_base, np.int64, dev)
        devmod.sync(dev)
    with _tr.trace("escapes"):
        esc = t == 0
        take = base[:, None] + torch.cumsum(esc, dim=1) - 1
        escv = torch.zeros(t.shape, dtype=torch.float32, device=dev)
        if up.numel():
            escv[esc] = up[take[esc]]
        del take
        devmod.sync(dev)
    with _tr.trace("decode_fixpoint"):
        out = ra_kernel.ra_decode(t, escv, lor, qc, rank, bs, float(rp),
                                  int(radius), bool(use_mean),
                                  np.float32(mean))
        devmod.sync(dev)
    return out
