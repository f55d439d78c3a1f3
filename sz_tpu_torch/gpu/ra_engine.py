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
synchronize.

The blocks are independent, so a ``devices`` list splits the batch over
several devices (``ra_engine._shard_over_blocks``, which pads the batch
to the mesh and drops the copies): the encode's blocks in contiguous
parts, one a device; the decode's selected blocks by rows of their grid
along its slowest axis, each device writing its rows of the region.
The work is queued on every device before any is waited for.
"""

from __future__ import annotations

import numpy as np
import torch

from sz_tpu_torch.gpu import device as devmod
from sz_tpu_torch.gpu import ra_kernel
from sz_tpu_torch.utils import trace as _tr


def _up(a, dtype, dev):
    return torch.from_numpy(np.ascontiguousarray(a, dtype)).to(dev)


def _devices(device, devices) -> list:
    return [devmod.resolve(d) for d in (devices or [device])]


def _sync(devs) -> None:
    for d in set(devs):
        devmod.sync(d)


def _parts(n: int, k: int) -> list:
    """[a, b) of k contiguous parts of n items, the empty ones left
    out."""
    cut = [n * i // k for i in range(k + 1)]
    return [(a, b) for a, b in zip(cut[:-1], cut[1:]) if b > a]


def encode_blocks(blocks: np.ndarray, indicator: np.ndarray,
                  qcoeffs_full: np.ndarray, rank: int, bs: int, rp,
                  intervals: int, use_mean: bool, mean, *, device,
                  devices=None) -> list:
    """The int32 type lattices (nb_p, bs^rank) of every block, in block
    order: one tensor on ``device``, or with ``devices`` one a device for
    contiguous parts of the blocks.  ``indicator`` True for a Lorenzo
    block."""
    devs = _devices(device, devices)
    nb = blocks.shape[0]
    parts = list(zip(devs, _parts(nb, len(devs)))) or [(devs[0], (0, 0))]
    flat = blocks.reshape(nb, bs ** rank)
    with _tr.trace("upload"):
        ins = []
        for dev, (a, b) in parts:
            with devmod.current(dev):
                ins.append((_up(flat[a:b], np.float32, dev),
                            _up(indicator[a:b], np.uint8, dev),
                            _up(qcoeffs_full[a:b], np.float32, dev)))
        _sync(devs)
    with _tr.trace("quantize"):
        types = []
        for (dev, _), (b, lor, qc) in zip(parts, ins):
            with devmod.current(dev):
                types.append(ra_kernel.ra_encode(
                    b, lor, qc, rank, bs, float(rp), int(intervals),
                    int(intervals) // 2, bool(use_mean), np.float32(mean)))
        _sync(devs)
    return types


def _row_parts(grid, lo, ext, bs: int, k: int) -> list:
    """The region's rows by block rows of its grid, in k parts: ((first
    block, last block + 1) in raster order, the part's grid, offset and
    extents) a part, the empty ones left out."""
    per = int(np.prod(grid[1:]))
    out = []
    for ga, gb in _parts(grid[0], k):
        a = max(lo[0], ga * bs)
        b = min(lo[0] + ext[0], gb * bs)
        out.append(((ga * per, gb * per), (gb - ga, *grid[1:]),
                    (a - ga * bs, *lo[1:]), (b - a, *ext[1:])))
    return out


def decode_blocks(types: np.ndarray, rank: int, bs: int,
                  lor_sel: np.ndarray, qc_sel: np.ndarray, rp, radius: int,
                  use_mean: bool, mean, unpred: np.ndarray,
                  esc_base: np.ndarray, grid, lo, ext, *, device,
                  devices=None) -> torch.Tensor:
    """The float32 region of extents ``ext`` on ``device``: ``types`` the
    type lattices of the selected blocks (raster order over their
    ``grid``), ``esc_base`` the index in ``unpred`` of each one's first
    escape, ``lo`` the region's offset in the first block.  With
    ``devices`` each device decodes a part of the grid's rows and the
    parts meet on ``device``.  Raises ValueError where the types call for
    more escapes than ``unpred`` holds."""
    dev = devmod.resolve(device)
    devs = _devices(device, devices)
    grid, lo, ext = tuple(grid), tuple(lo), tuple(ext)
    parts = _row_parts(grid, lo, ext, bs, len(devs)) if grid[0] else []
    parts = (list(zip(devs, parts)) if len(parts) > 1
             else [(dev, ((0, len(types)), grid, lo, ext))])
    with _tr.trace("stream_upload"):
        ins = []
        for d, ((a, b), *_) in parts:
            with devmod.current(d):
                ins.append((_up(types[a:b], np.int32, d),
                            _up(lor_sel[a:b], np.uint8, d),
                            _up(qc_sel[a:b], np.float32, d),
                            _up(unpred, np.float32, d),
                            _up(esc_base[a:b], np.int64, d)))
        _sync(devs)
    with _tr.trace("decode_fixpoint"):
        outs = []
        for (d, (_, g, o, e)), (t, lor, qc, up, base) in zip(parts, ins):
            with devmod.current(d):
                outs.append(ra_kernel.ra_decode(
                    t, up, base, lor, qc, rank, bs, float(rp), int(radius),
                    bool(use_mean), np.float32(mean), g, o, e))
        _sync(devs)
        bad = sum(int(b) for _, b in outs)
        out = (outs[0][0] if len(outs) == 1 else
               torch.cat([o.to(dev) for o, _ in outs]))
    if bad:
        raise ValueError(f"corrupt random-access stream: its types call for "
                         f"{bad} escapes past the {len(unpred)} it holds")
    return out
