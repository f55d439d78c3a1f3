"""The classic SZ1.4 codec on 2-D, 3-D and 4-D fields on a torch device:
the port of ``sz_tpu.tpu.classic_engine.compress`` / ``decompress``,
with identical bytes and bits (``sz_tpu.core.classic_nd.compress_nd`` /
``decompress_nd``).

Encode: the interval optimizer's sample walk, the precision's form and
the escapes' kept bits on the host (``core.classic_nd``); upload; the
recurrence K10 (types only) and the histogram of its types K3 on the
device; the escapes' values gathered in raster order; the escape stream
and the Huffman tree on the host; the bit-pack K4 on the device; the
TDPS.  Decode: the Huffman decode K5-K7 on the device, each row's escape
count and their exclusive scan, the escape stream on the host, the
recurrence K11 on the compact escapes.  Span names
follow the JAX engine; each device span ends with a synchronize.
"""

from __future__ import annotations

import numpy as np
import torch

from sz_tpu_torch.config import data_type, float_type
from sz_tpu_torch.core import classic, classic_nd
from sz_tpu_torch.format.tdps import TDPS
from sz_tpu_torch.gpu import classic_kernel
from sz_tpu_torch.gpu import device as devmod
from sz_tpu_torch.utils import trace as _tr


def compress(data: np.ndarray, real_precision: float, value_range, median,
             *, max_range_radius: int, sample_distance: int, pred_threshold,
             opt_quant_mode: int = 1, fixed_intervals: int = 0,
             subblock_origin=None, device) -> TDPS:
    """Classic encode of a float32 or float64 rank-2/3/4 field; the TDPS
    is byte-equal to ``sz_tpu.core.classic_nd.compress_nd``'s.  With
    ``subblock_origin`` (a region's corner in its field,
    SZ_compress_args3), K10 runs the subblock form."""
    dev = devmod.resolve(device)
    T = float_type(data.dtype)
    data = np.ascontiguousarray(data, dtype=T)
    with _tr.trace("optimizer"):
        p = classic_nd.params(
            data, real_precision, value_range, median,
            max_range_radius=max_range_radius,
            sample_distance=sample_distance, pred_threshold=pred_threshold,
            opt_quant_mode=opt_quant_mode, fixed_intervals=fixed_intervals,
            subblock_origin=subblock_origin)
    with _tr.trace("upload"):
        x = torch.from_numpy(data).to(dev)
        devmod.sync(dev)
    with _tr.trace("quantize"):
        if p.form.sub:
            types, _ = classic_kernel.classic_quantize_sub(
                x, p.rp, p.intervals, p.radius, p.median, p.req_length,
                want_R=False)
        else:
            types, _ = classic_kernel.classic_quantize(
                x, p.rp, p.recip, p.intervals, p.radius, p.median,
                p.req_length, want_R=False)
        types = types.reshape(-1)
        devmod.sync(dev)
    with _tr.trace("escapes"):
        esc_vals = x.reshape(-1)[types == 0].cpu().numpy()
    del x
    enc = classic.ExactEncoder(p.req_length, p.median, T)
    enc.add_batch(esc_vals)
    type_array, _ = classic.encode_types(types, p.intervals, dev)
    return TDPS(
        data_type=data_type(T), ds_length=data.size, intervals=p.intervals,
        median_value=float(p.median), req_length=p.req_length,
        real_precision=float(p.rp), type_array=type_array,
        lead_num=enc.lead_packed(), exact_mid_bytes=bytes(enc.mid_bytes),
        residual_mid_bits=enc.resi_packed(),
        exact_data_num=enc.exact_count(),
        max_quant_intervals=max_range_radius * 2)


def decompress(tdps: TDPS, shape, dtype, *, device,
               as_tensor: bool = False):
    """Classic decode, bit-equal to ``sz_tpu.core.classic_nd.
    decompress_nd``.  Returns numpy, or the device tensor when
    ``as_tensor``."""
    dev = devmod.resolve(device)
    T = float_type(dtype)
    shape = tuple(int(s) for s in shape)
    n = int(np.prod(shape))
    f = classic_nd.form(T, len(shape))
    types = classic.decode_types(tdps.type_array, n, dev).reshape(shape)
    row_base, esc_count = classic_kernel.escape_row_base(types)
    counts = torch.stack([esc_count,
                          (types >= int(tdps.intervals)).sum()]).cpu()
    n_esc, n_bad = int(counts[0]), int(counts[1])
    if n_bad:
        raise ValueError(f"corrupt stream: {n_bad} types past the "
                         f"{tdps.intervals} intervals")
    with _tr.trace("escapes"):
        vals = classic.ExactDecoder(tdps, T, raw=False).next_batch(n_esc)
        esc = torch.from_numpy(vals).to(dev)
    with _tr.trace("decode_fixpoint"):
        out = classic_kernel.classic_decode(
            types, esc, f.RT(tdps.real_precision),
            int(tdps.intervals) // 2, row_base=row_base)
        del types, esc, row_base
        devmod.sync(dev)
    if as_tensor:
        return out
    with _tr.trace("download"):
        return out.cpu().numpy()
