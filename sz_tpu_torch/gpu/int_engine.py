"""The integer codecs on 2-D, 3-D and 4-D fields on a torch device: the
port of ``sz_tpu.core.intc.compress_int`` / ``decompress_int`` at those
ranks (which run the reference's kernels in host C), with identical bytes
and bits.

Encode: the upload (where the field is a host array), the interval
optimizer's samples gathered on the device and their histogram on the
host, the recurrence K16 (types only), the escapes' values gathered in
raster order and downloaded once (the 4-D encoder's cell (l, 0, 0, 1)
stores the field's first element where it escapes), their min-offset
bytes on the host, the type histogram K3 and bit-pack K4
(``classic.encode_types``), the ITDPS.  Decode: the Huffman decode K5-K7
on the device, each row's escape count and their exclusive scan, the
escape bytes parsed on the host into values of the type, the recurrence
K17 on the compact escapes.  Span names follow ``classic_engine``; each
device span ends with a synchronize.
"""

from __future__ import annotations

import numpy as np
import torch

from sz_tpu_torch.core import classic, intc
from sz_tpu_torch.gpu import device as devmod
from sz_tpu_torch.gpu import int_kernel
from sz_tpu_torch.gpu.classic_kernel import escape_row_base
from sz_tpu_torch.utils import trace as _tr


def compress(data, real_precision: float, *, mn: int, byte_size: int,
             max_range_radius: int, sample_distance: int, pred_threshold,
             opt_quant_mode: int = 1, fixed_intervals: int = 0, dtype=None,
             device) -> intc.ITDPS:
    """Integer encode of a rank 2-4 field: a numpy array, or a carrier
    tensor (``int_kernel.carrier``) of numpy ``dtype`` on ``device``; the
    ITDPS is byte-equal to ``sz_tpu.core.intc.compress_int``'s."""
    dev = devmod.resolve(device)
    if torch.is_tensor(data):
        dt, x = np.dtype(dtype), data
    else:
        dt = data.dtype
        with _tr.trace("upload"):
            x = int_kernel.to_carrier(data, dev)
            devmod.sync(dev)
    spec = intc.SPECS[dt]
    shape = tuple(int(r) for r in x.shape)
    rp = float(real_precision)
    with _tr.trace("optimizer"):
        if opt_quant_mode == 1:
            perr = int_kernel.optimizer_samples_int(x, dt, sample_distance)
            intervals = intc.optimize_intervals(perr, perr.size, rp,
                                                max_range_radius,
                                                pred_threshold)
        else:
            intervals = fixed_intervals
    quirk = len(shape) == 4 and shape[-1] > 1
    with _tr.trace("quantize"):
        types = int_kernel.int_quantize(x, dt, rp, intervals,
                                        intervals // 2, quirk4d=quirk)
        esc = types.reshape(-1) == 0
        counts = [esc.sum(), (types < 0).sum()]
        if quirk:   # each volume's escapes and its cell 1's type
            vols = esc.reshape(shape[0], -1)
            counts += [vols.sum(1), types.reshape(shape[0], -1)[:, 1]]
        counts = [c.cpu() for c in counts]
    if int(counts[1]):
        # sz_tpu's type histogram (np.bincount) refuses them alike
        raise ValueError(f"{int(counts[1])} negative type codes: a "
                         "difference of -2^63 quantized out of int range")
    with _tr.trace("escapes"):
        vals = x.reshape(-1)[esc].cpu().numpy().view(dt).astype(np.int64)
        if quirk:
            # the quirk cell's escape stores the field's first element
            before = np.cumsum(counts[2].numpy()) - counts[2].numpy()
            vals[before[counts[3].numpy() == 0] + 1] = vals[0]
    del x, esc
    exact = intc.exact_bytes(vals, mn, byte_size, spec.esize)
    type_array, _ = classic.encode_types(types, intervals, dev)
    # the 2-D to 4-D kernels store the escapes' byte count as their
    # exactDataNum (sz_int32.c:511/794/1102)
    return intc.ITDPS(
        ds_length=int(np.prod(shape)), intervals=intervals, min_value=mn,
        real_precision=rp, exact_byte_size=byte_size, type_array=type_array,
        exact_bytes=exact, exact_data_num=len(exact),
        max_quant_intervals=max_range_radius * 2)


def decompress(t: intc.ITDPS, shape, dtype, *, device,
               as_tensor: bool = False):
    """Integer decode of a rank 2-4 field, bit-equal to
    ``sz_tpu.core.intc.decompress_int``.  Returns numpy of ``dtype``, or
    the device tensor of ``dtype`` when ``as_tensor`` (an unsigned type
    as a view of its carrier)."""
    dev = devmod.resolve(device)
    dt = np.dtype(dtype)
    shape = tuple(int(s) for s in shape)
    n = int(np.prod(shape))
    types = classic.decode_types(t.type_array, n, dev).reshape(shape)
    row_base, esc_count = escape_row_base(types)
    with _tr.trace("escapes"):
        k = min(int(esc_count), len(t.exact_bytes) // t.exact_byte_size)
        vals = intc.exact_values(t.exact_bytes, k, t.min_value,
                                 t.exact_byte_size, dt)
        esc = torch.from_numpy(vals).to(dev)
    with _tr.trace("decode_fixpoint"):
        out = int_kernel.int_decode(types, esc, dt, 2 * t.real_precision,
                                    int(t.intervals) // 2,
                                    row_base=row_base)
        del types, esc, row_base
        devmod.sync(dev)
    if as_tensor:
        return out.view(int_kernel.torch_dtype(dt))
    with _tr.trace("download"):
        return out.cpu().numpy().view(dt)
