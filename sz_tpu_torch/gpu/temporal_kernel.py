"""K14 ``ts_quantize`` and K15 ``ts_decode``: the temporal codec's step
against the previous step's reconstruction, float32 and float64.

CUDA kernels in ``csrc/temporal.cu``, two launches a call: pass A
(``ts_quantize_kernel``, ``ts_decode_kernel`` and their ``_f64`` forms)
streams every point in tiles (:data:`QUANTIZE_TILE` and
:data:`DECODE_TILE` points) by 16-byte accesses, blocks independent of
each other, and stages each tile's escapes at their rank in the tile;
pass B (``ts_quantize_escapes_kernel``,
``ts_decode_escapes_kernel`` and their ``_f64`` forms) reads the tile
counts and the staged escapes and places them.  K14 replaces the XLA step
``sz_tpu/temporal.py::_ts_device_step_fn`` (and the float32
``_ts_step_jax``), K15 ``::_ts_decode_fn``; their arithmetic is the host
contract of ``compress_1d_ts`` / ``decompress_1d_ts`` (``temporal.cu``'s
note has it, with the design and what bounds it).  :func:`head` picks
where the 16-byte slots start, so a view at any storage offset runs in
the kernels.

Beside each kernel sits its plain torch version, each float and double
operation a separate torch op; the plain K15 places the escapes with a
cumulative sum.  The wrappers take it only for CPU tensors; for CUDA
tensors they launch the kernels or raise.

K14 takes ``cur`` and ``prev`` (1-D, one float dtype), the bound ``rp``
(a double), the interval count, ``radius`` (half of it), the escapes'
kept bits ``req_length`` and the ``median``.  It returns the int32
types, the reconstruction (the next step's history), the escape values
compacted in index order at the front of a buffer of ``n``, and their
count (an int64 scalar).  The first two points always escape.  K15
takes the int32 types, ``prev``, ``vals`` (the stream's escape values in
order), ``radius`` and ``interval2`` (twice the stream's precision, a
double), and returns the field and the count of escapes the types call
for (an int64 scalar; past the end of ``vals`` they decode to NaN): the
caller compares it with the stream's count.  Besides its outputs a call
takes a scratch buffer on the device: K14 a value a point (the staged
escapes), K15 an int32 a point (their positions), and an int32 a tile.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from sz_tpu_torch.gpu import _build

_I32, _I64 = torch.int32, torch.int64
_FLOATS = (torch.float32, torch.float64)
_BITS = {torch.float32: torch.int32, torch.float64: torch.int64}

# the tiling of temporal.cu (a CPU test holds them equal)
THREADS = 256          # kThreads: a block
VEC = 4                # kVec: points a 16-byte slot
QUANTIZE_SLOTS = 2     # kQuantizeSlots: K14's slots a thread
DECODE_SLOTS = 4       # kDecodeSlots: K15's
QUANTIZE_TILE = THREADS * QUANTIZE_SLOTS * VEC   # points a tile of pass A
DECODE_TILE = THREADS * DECODE_SLOTS * VEC
GROUP = 32             # kGroup: tiles pass B scans at once
PLACE_BLOCKS = 256     # kPlaceBlocks: pass B's most blocks


def esc_mask(dtype, req_length: int) -> int:
    """The escape truncation's mask as an unsigned integer of the type's
    width: the top ``req_length`` bits (all of them past the width)."""
    width = 32 if dtype == torch.float32 else 64
    ign = max(width - int(req_length), 0)
    return ~((1 << ign) - 1) & ((1 << width) - 1)


def _signed(mask: int, dtype) -> int:
    width = 32 if dtype == torch.float32 else 64
    return mask - (1 << width) if mask >> (width - 1) else mask


# --- plain versions -------------------------------------------------------

def ts_quantize_plain(cur, prev, rp: float, intervals: int, radius: int,
                      req_length: int, median):
    T, dev, n = cur.dtype, cur.device, cur.numel()
    rp = float(rp)
    check_radius = (int(intervals) - 1) * rp
    interval2 = 2 * rp
    med = torch.tensor(median, dtype=T, device=dev)
    pae = (cur - prev).abs()
    pae64 = pae.double()
    cand = pae64 <= check_radius
    q = (pae64 / rp + 1) / 2
    # the state only where it is a candidate (0 for rp = 0's 0/0)
    state = torch.where(cand & ~q.isnan(), q, 0.0).trunc().to(_I32)
    s = torch.where(cur >= prev, state, -state)
    rec = (prev.double() + s.double() * interval2).to(T)
    bad = (cur - rec).abs().double() > rp
    esc = ~cand | bad
    esc[:2] = True
    bits = (cur - med).view(_BITS[T]) & _signed(esc_mask(T, req_length), T)
    types = torch.where(esc, 0, radius + s).to(_I32)
    recon = torch.where(esc, bits.view(T) + med, rec)
    vals = torch.zeros(n, dtype=T, device=dev)
    count = esc.sum()
    vals[:int(count)] = cur[esc]
    return types, recon, vals, count


def ts_decode_plain(types, prev, vals, radius: int, interval2: float):
    out = (prev.double() + (types - int(radius)).double() * float(interval2)
           ).to(prev.dtype)
    esc = types == 0
    take = torch.cumsum(esc, 0)[esc] - 1
    m = vals.numel()
    out[esc] = torch.cat([vals, vals.new_full((1,), float("nan"))])[
        take.clamp(max=m)]
    return out, esc.sum()


# --- wrappers -------------------------------------------------------------

def _check(name, pairs, more=()):
    """Validate the 1-D point tensors ((tensor, dtype), ...) of one length
    and the other tensors; returns the device type."""
    n = pairs[0][0].numel()
    for t, dt in pairs:
        if t.dim() != 1 or t.numel() != n:
            raise ValueError(f"{name}: 1-D tensors of {n} points expected")
        if t.dtype != dt:
            raise ValueError(f"{name}: {dt} expected, not {t.dtype}")
    tensors = [t for t, _ in pairs] + list(more)
    dev = tensors[0].device
    if dev.type not in ("cpu", "cuda") or any(t.device != dev
                                              for t in tensors):
        raise ValueError(f"{name}: tensors on one cpu or cuda device")
    if dev.type == "cuda" and not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name}: contiguous tensors required")
    return dev.type


def _p(t):
    return ctypes.c_void_p(t.data_ptr())


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def head(arrays) -> int:
    """The first point (0 to VEC - 1) from which the kernels' slots of
    VEC points start, given the streamed arrays as (address, element
    size): the one at which the most bytes a point are 16-byte aligned
    (the smallest on a tie).  An array not aligned there is read or
    written a point at a time."""
    def aligned_bytes(h):
        return sum(es for addr, es in arrays if (addr + es * h) % 16 == 0)
    return max(range(VEC), key=lambda h: (aligned_bytes(h), -h))


def tiles(n: int, h: int, tile: int) -> int:
    """Pass A's tiles of ``tile`` points (QUANTIZE_TILE or DECODE_TILE),
    the first starting at point h - VEC (or 0 where h is 0)."""
    return (n + (VEC - h) % VEC + tile - 1) // tile


def _stage_bytes(n: int, item: int) -> int:
    """The scratch's staging, ``item`` bytes a point, rounded up to 16
    bytes: the tile counts follow it."""
    return -(-n * item // 16) * 16


def _scratch(n: int, item: int, h: int, tile: int, dev):
    """The staging and the tile counts, in one buffer."""
    return torch.empty(_stage_bytes(n, item) + 4 * tiles(n, h, tile),
                       dtype=torch.uint8, device=dev)


def _quantize_outputs(cur, prev) -> tuple:
    """K14's outputs for ``cur`` and ``prev``, its head and scratch:
    (types, recon, vals, count, head, scratch)."""
    n, es, dev = cur.numel(), cur.element_size(), cur.device
    types = torch.empty(n, dtype=_I32, device=dev)
    recon = torch.empty_like(cur)
    h = head([(cur.data_ptr(), es), (prev.data_ptr(), es),
              (types.data_ptr(), 4), (recon.data_ptr(), es)])
    return (types, recon, torch.empty_like(cur),
            torch.empty((), dtype=_I64, device=dev), h,
            _scratch(n, es, h, QUANTIZE_TILE, dev))


def _quantize_launch(cur, prev, rp: float, intervals: int, radius: int,
                     req_length: int, median, outs) -> None:
    """K14's two launches into ``outs`` (from _quantize_outputs)."""
    types, recon, vals, count, h, scratch = outs
    T, n = cur.dtype, cur.numel()
    stage = scratch.data_ptr()
    rp = float(rp)
    f64 = T == torch.float64
    fn = (_build.lib().sz_ts_quantize_f64 if f64
          else _build.lib().sz_ts_quantize)
    rc = fn(_p(cur), _p(prev), n, rp, (int(intervals) - 1) * rp, 2 * rp,
            int(radius), esc_mask(T, req_length),
            float(np.float64(median) if f64 else np.float32(median)), h,
            _p(types), _p(recon), _p(vals), _p(count), stage,
            stage + _stage_bytes(n, cur.element_size()), _stream(cur))
    _build.check(rc, "ts_quantize")


def ts_quantize(cur, prev, rp: float, intervals: int, radius: int,
                req_length: int, median):
    """K14: (types int32, reconstruction, compact escape values, their
    count) of one step."""
    T = cur.dtype
    if T not in _FLOATS:
        raise ValueError(f"ts_quantize: float32 or float64, not {T}")
    kind = _check("ts_quantize", [(cur, T), (prev, T)])
    if kind == "cpu":
        return ts_quantize_plain(cur, prev, rp, intervals, radius,
                                 req_length, median)
    outs = _quantize_outputs(cur, prev)
    _quantize_launch(cur, prev, rp, intervals, radius, req_length, median,
                     outs)
    _build.launched(ts_quantize)
    return outs[:4]


def _decode_outputs(types, prev) -> tuple:
    """K15's output for ``types`` and ``prev``, its head and scratch:
    (out, count, head, scratch)."""
    n, es, dev = prev.numel(), prev.element_size(), prev.device
    out = torch.empty_like(prev)
    h = head([(types.data_ptr(), 4), (prev.data_ptr(), es),
              (out.data_ptr(), es)])
    return (out, torch.empty((), dtype=_I64, device=dev), h,
            _scratch(n, 4, h, DECODE_TILE, dev))


def _decode_launch(types, prev, vals, radius: int, interval2: float,
                   outs) -> None:
    """K15's two launches into ``outs`` (from _decode_outputs)."""
    out, count, h, scratch = outs
    n = prev.numel()
    stage = scratch.data_ptr()
    fn = (_build.lib().sz_ts_decode_f64 if prev.dtype == torch.float64
          else _build.lib().sz_ts_decode)
    rc = fn(_p(types), _p(prev), n, _p(vals), vals.numel(), int(radius),
            float(interval2), h, _p(out), _p(count), stage,
            stage + _stage_bytes(n, 4), _stream(prev))
    _build.check(rc, "ts_decode")


def ts_decode(types, prev, vals, radius: int, interval2: float):
    """K15: (the field, the escapes its types call for as an int64
    scalar)."""
    T = prev.dtype
    if T not in _FLOATS:
        raise ValueError(f"ts_decode: float32 or float64, not {T}")
    if vals.dim() != 1 or vals.dtype != T:
        raise ValueError(f"ts_decode: vals must be 1-D {T}")
    kind = _check("ts_decode", [(types, _I32), (prev, T)], (vals,))
    if kind == "cpu":
        return ts_decode_plain(types, prev, vals, radius, interval2)
    outs = _decode_outputs(types, prev)
    _decode_launch(types, prev, vals, radius, interval2, outs)
    _build.launched(ts_decode)
    return outs[:2]


ts_quantize.launches = ts_decode.launches = 0
