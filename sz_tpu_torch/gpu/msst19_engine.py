"""The MSST19 PW_REL codec on a torch device: the port of
``sz_tpu.tpu.msst19_engine.compress`` / ``decompress``, with identical
bytes and bits.

Encode: the interval optimizer and the two tables on the host
(``core.pwr``), the recurrence on the device (K8 for rank 3, K9 for rank
2), the histogram of the raster-order types (K3), the escapes' values
gathered in raster order, the escape stream and the Huffman tree on the
host, the bit-pack on the device (K4), the TDPS container.  Decode: the
Huffman decode on the device (K5-K7), the escape stream on the host, the
escapes placed in raster order, the recurrence (K8/K9), then the zero
flush and the sign bitmap (``decompress_pwrel``'s restore,
szd_float_pwr.c:1425), all on the device.

The chain is native IEEE f64 on the card, so every table runs there:
the TPU engine's envelope (4096 boundary states), its host bail-out past
it and its decode-verify fallback have no counterpart.  Float64 data
runs the same stages through the double forms of the recurrence (K8d,
K9d; the 1-D recurrence in ``host.c``), which the JAX package runs as
XLA scans on its CPU backend.  Span names follow the JAX engine; each
device span ends with a synchronize.
"""

from __future__ import annotations

import numpy as np
import torch

from sz_tpu_torch import native
from sz_tpu_torch.config import DataType
from sz_tpu_torch.core import classic
from sz_tpu_torch.core import pwr
from sz_tpu_torch.format import bytes_util as bu
from sz_tpu_torch.format import lossless as ll
from sz_tpu_torch.format.tdps import TDPS
from sz_tpu_torch.gpu import device as devmod
from sz_tpu_torch.gpu import msst19_kernel
from sz_tpu_torch.utils import trace as _tr


def req_length(ratio: float, rank: int, dtype=np.float32) -> int:
    """The escapes' kept bits: computeReqLength_float_MSST19 (9 - expo)
    for float data of ranks 1 and 3, but the float 2-D kernel calls the
    double variant (12 - expo; sz_float.c quirk, kept), as does every
    rank of double data."""
    if rank != 2 and np.dtype(dtype) == np.float32:
        return 9 - classic.get_exponent(np.float32(ratio), np.float32)
    return 12 - classic.get_exponent(np.float64(ratio), np.float64)


# the recurrence's wrappers by (rank, data type): K8/K9 and their
# float64 forms K8d/K9d
_ENCODE = {(3, np.float32): "wavefront3d_encode",
           (2, np.float32): "lines2d_encode",
           (3, np.float64): "wavefront3d_encode_f64",
           (2, np.float64): "lines2d_encode_f64"}
_DECODE = {k: v.replace("encode", "decode") for k, v in _ENCODE.items()}


def compress(work: np.ndarray, pw_ratio: float, fmax, near_zero, *,
             max_range_radius: int, sample_distance: int,
             pred_threshold: float, plus_bits: int = 3,
             opt_quant_mode: int = 1, fixed_intervals: int = 0,
             device) -> TDPS:
    """Port of ``sz_tpu.tpu.msst19_engine.compress`` for a float32 or
    float64 field of rank 1-3 whose zeros the caller has replaced; the
    TDPS is byte-equal to ``sz_tpu.core.pwr.compress_msst19``'s.  Rank 1
    runs the serial recurrence on the host (``host.c``, as in the JAX
    package), its type stream through K3/K4 as the others'."""
    dev = devmod.resolve(device)
    T = np.float64 if work.dtype == np.float64 else np.float32
    work = np.ascontiguousarray(work, dtype=T)
    rank = work.ndim
    if rank not in (1, 2, 3):
        raise ValueError("the MSST19 engine takes fields of rank 1-3")
    ratio = float(pw_ratio)
    if opt_quant_mode == 1:
        with _tr.trace("optimizer"):
            intervals = pwr._optimize_intervals_msst19(
                work, ratio, max_range_radius, sample_distance,
                pred_threshold)
    else:
        intervals = fixed_intervals
    ptable = pwr._precision_table(intervals, ratio, plus_bits)
    cache = pwr._cache_table(int(intervals), ratio, int(plus_bits))
    median = T(np.sqrt(np.float64(abs(T(near_zero * fmax)))))
    rl = req_length(ratio, rank, T)
    enc = classic.ExactEncoder(rl, None, T)
    if rank == 1:
        with _tr.trace("quantize"):
            types, lead, mid, resi, _ = native.msst19_encode1d(
                work, cache.table, cache.base_index, cache.top_index,
                cache.bits, ptable, rl)
        enc.add_parts(lead, mid, resi)
    else:
        with _tr.trace("upload"):
            x = torch.from_numpy(work).to(dev)
            tab = torch.from_numpy(cache.table.reshape(-1).view(np.int16)).to(
                dev)
            pt = torch.from_numpy(ptable).to(dev)
            devmod.sync(dev)
        with _tr.trace("quantize"):
            encode = getattr(msst19_kernel, _ENCODE[rank, T])
            types, _rec = encode(x, tab, pt, cache.base_index,
                                 cache.top_index, cache.bits,
                                 max(8 * np.dtype(T).itemsize - rl, 0))
            del _rec
            types = types.reshape(-1)
            devmod.sync(dev)
        with _tr.trace("escapes"):
            enc.add_batch(x.reshape(-1)[types == 0].cpu().numpy())
        del x
    type_array, max_len = classic.encode_types(types, intervals, dev)
    return TDPS(
        data_type=DataType.FLOAT if T is np.float32 else DataType.DOUBLE,
        ds_length=work.size, intervals=intervals,
        median_value=float(median), req_length=rl, real_precision=ratio,
        type_array=type_array, lead_num=enc.lead_packed(),
        exact_mid_bytes=bytes(enc.mid_bytes),
        residual_mid_bits=enc.resi_packed(),
        exact_data_num=enc.exact_count(),
        max_quant_intervals=max_range_radius * 2, is_pwr=True, msst19=True,
        plus_bits=plus_bits, max_bits=max_len)


def restore(out: torch.Tensor, thr, signs) -> torch.Tensor:
    """decompress_pwrel's MSST19 epilogue (szd_float_pwr.c:1425): values
    below ``thr`` (min_log_value) flush to zero (only non-negative ones
    when there is a sign bitmap), then the bitmap's sign bits are set on
    the rest.  ``signs``: uint8 tensor, or None.  ``out``: float32 or
    float64 (the threshold in its type, the sign bit 31 or 63)."""
    f64 = out.dtype == torch.float64
    thr = torch.tensor((np.float64 if f64 else np.float32)(thr),
                       device=out.device)
    if signs is None:
        return torch.where(out < thr, torch.zeros_like(out), out)
    zero = (out < thr) & (out >= 0)
    out = torch.where(zero, torch.zeros_like(out), out)
    bits, width = (torch.int64, 64) if f64 else (torch.int32, 32)
    u = out.view(bits)
    flip = (signs != 0) & ~zero
    return torch.where(flip, u | -2 ** (width - 1), u).view(out.dtype)


def decompress(tdps: TDPS, shape, dtype=np.float32, *, device,
               as_tensor: bool = False):
    """Port of ``sz_tpu.tpu.msst19_engine.decompress``: the MSST19 decode
    of float32 or float64 data with the sign and zero restore, bit-equal
    to ``sz_tpu.core.pwr.decompress_pwrel``.  Rank 1 decodes its types on
    the device and runs the recurrence on the host.  Returns numpy, or
    the device tensor when ``as_tensor``."""
    dev = devmod.resolve(device)
    T = np.float64 if np.dtype(dtype) == np.float64 else np.float32
    shape = tuple(int(s) for s in shape)
    if len(shape) not in (1, 2, 3):
        raise ValueError("the MSST19 engine takes fields of rank 1-3")
    n = int(np.prod(shape))
    intervals = int(tdps.intervals)
    types = classic.decode_types(tdps.type_array, n, dev)
    counts = torch.stack([(types == 0).sum(),
                          (types >= intervals).sum()]).cpu()
    n_esc, n_bad = int(counts[0]), int(counts[1])
    if n_bad:
        raise ValueError(f"corrupt stream: {n_bad} types past the "
                         f"{intervals} intervals")
    ptable = pwr._precision_table(intervals, tdps.real_precision,
                                  tdps.plus_bits)
    signs = None
    if len(tdps.pwr_err_bound_bytes):
        signs = np.frombuffer(ll.decompress(bytes(tdps.pwr_err_bound_bytes),
                                            expected_size=n),
                              dtype=np.uint8, count=n).copy()
    if len(shape) == 1:
        if n_esc != tdps.exact_data_num:
            raise ValueError(f"corrupt stream: {n_esc} escapes coded, "
                             f"{tdps.exact_data_num} stored")
        with _tr.trace("decode_fixpoint"):
            out = native.msst19_decode1d(
                types.cpu().numpy(), ptable, tdps.req_length,
                bu.unpack_bits_2(tdps.lead_num, tdps.exact_data_num),
                tdps.exact_mid_bytes, tdps.residual_mid_bits, T)
            out = torch.from_numpy(out).to(dev)
    else:
        with _tr.trace("escapes"):
            unpred = classic.ExactDecoder(tdps, T).next_batch(n_esc)
            known = torch.zeros(n, dtype=torch.from_numpy(unpred).dtype,
                                device=dev)
            known[types == 0] = torch.from_numpy(unpred).to(dev)
        with _tr.trace("decode_fixpoint"):
            pt = torch.from_numpy(ptable).to(dev)
            decode = getattr(msst19_kernel, _DECODE[len(shape), T])
            out = decode(types.reshape(shape), known.reshape(shape), pt)
            del known
            devmod.sync(dev)
    del types
    s_dev = None if signs is None else torch.from_numpy(
        signs.reshape(shape)).to(dev)
    out = restore(out, tdps.min_log_value, s_dev)
    devmod.sync(dev)
    if as_tensor:
        return out
    with _tr.trace("download"):
        return out.cpu().numpy()
