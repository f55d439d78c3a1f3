"""The random-access block codec's device stages: the port of
``sz_tpu.tpu.ra_engine.encode_blocks`` / ``decode_blocks``, identical
type lattices and reconstructions.

``encode_blocks`` uploads the edge-padded blocks, their predictor
indicator and coefficients and runs K12 (``gpu/ra_kernel.py``);
``decode_blocks`` uploads the selected blocks' types, the escapes in
stream order and each block's first escape, and runs K13, which ranks
the escapes itself (the JAX engine places them per cell on the host,
``ra_engine.py:280-287``) and writes the region in the field's layout.
Span names follow the other engines; each device span ends with a
synchronize.  Sharding the blocks over several devices
(``ra_engine._shard_over_blocks``, ROADMAP 1.8) is not ported.
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
                  esc_base: np.ndarray, grid, lo, ext, *,
                  device) -> torch.Tensor:
    """The float32 region of extents ``ext`` on ``device``: ``types`` the
    type lattices of the selected blocks (raster order over their
    ``grid``), ``esc_base`` the index in ``unpred`` of each one's first
    escape, ``lo`` the region's offset in the first block.  Raises
    ValueError where the types call for more escapes than ``unpred``
    holds."""
    dev = devmod.resolve(device)
    with _tr.trace("stream_upload"):
        t = _up(types, np.int32, dev)
        lor = _up(lor_sel, np.uint8, dev)
        qc = _up(qc_sel, np.float32, dev)
        up = _up(unpred, np.float32, dev)
        base = _up(esc_base, np.int64, dev)
        devmod.sync(dev)
    with _tr.trace("decode_fixpoint"):
        out, bad = ra_kernel.ra_decode(t, up, base, lor, qc, rank, bs,
                                       float(rp), int(radius), bool(use_mean),
                                       np.float32(mean), grid, lo, ext)
        devmod.sync(dev)
        bad = int(bad)
    if bad:
        raise ValueError(f"corrupt random-access stream: its types call for "
                         f"{bad} escapes past the {len(unpred)} it holds")
    return out
