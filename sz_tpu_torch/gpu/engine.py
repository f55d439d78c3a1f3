"""Main-path entry points of the SZ2.1 blocked-regression codec on a
torch device: the port of ``sz_tpu.tpu.engine.compress`` / ``decompress``.

Same split as the JAX engine with its device decode on, with identical
bytes: the lattice-sized work (coefficient sums, predictor selection,
the regression predictor, the Lorenzo recurrence K1, the stream reorder,
the histogram K3, the escape gather and the Huffman bit-pack K4; on
decode the Huffman decode K5-K7, the staging, the prelude and the
reconstruction K2) runs on the device; the interval optimizer, the
coefficient chain, the Huffman tree and the body layout run on the host
(``sz_tpu_torch.core``, ``sz_tpu_torch.format``).  Span names follow the
JAX engine so per-layer times read under the same names; each device
span ends with a synchronize, so it times the device work.
"""

from __future__ import annotations

import numpy as np
import torch

from sz_tpu_torch import state as state_mod
from sz_tpu_torch.core import optimizer as opt
from sz_tpu_torch.core import regnd
from sz_tpu_torch.core.regnd import EncodeResult
from sz_tpu_torch.format import huffman
from sz_tpu_torch.gpu import device as devmod
from sz_tpu_torch.gpu import fsm_kernel
from sz_tpu_torch.gpu import geometry as geo
from sz_tpu_torch.gpu import hist_kernel, lorenzo_kernel, pack_kernel, stages
from sz_tpu_torch.utils import trace as _tr


def compress(data: np.ndarray, real_precision, *, max_range_radius: int,
             sample_distance: int, pred_threshold, opt_quant_mode: int = 1,
             fixed_intervals: int = 0, size_type: int = 8,
             device) -> EncodeResult:
    """Port of ``sz_tpu.tpu.engine.compress`` for a float32 rank-2/3
    host array; the result's body is byte-equal to ``regnd.compress``."""
    dev = devmod.resolve(device)
    rank = data.ndim
    spec = regnd._spec(rank, data.dtype)
    T = spec.T
    shape = tuple(int(r) for r in data.shape)
    bs = spec.block_size
    rp = T(real_precision)
    recip = T(T(1) / rp)
    g = geo.geom_small(shape, bs)
    dbs = g["dbs"]

    data = np.ascontiguousarray(data, dtype=T)
    flat = data.reshape(-1)
    with _tr.trace("upload"):
        x = torch.from_numpy(data).to(dev)
        devmod.sync(dev)
    with _tr.trace("coeff_sums"):
        sums = stages.coeff_sums(x, bs).cpu().numpy()
    with _tr.trace("coeff_finalize"):
        coeffs = stages.finalize_coeffs(sums, shape, bs, T)

    use_mean = False
    mean = T(0)
    if opt_quant_mode == 1:
        with _tr.trace("optimizer"):
            optimize = (opt.optimize_intervals_3d_freq_dense if rank == 3
                        else opt.optimize_intervals_2d_freq_dense)
            intervals, dense_pos, max_freq, mean_freq = optimize(
                flat, *shape, float(real_precision), max_range_radius,
                sample_distance, pred_threshold, T=T)
            use_mean = opt.decide_use_mean(mean_freq, max_freq, rank)
            if use_mean:
                mean = stages.dense_mean(x, dense_pos, rp)
    else:
        intervals = fixed_intervals

    noise = T(np.float64(rp) * spec.noise_factor)
    with _tr.trace("select"):
        use_reg = stages.select(x, torch.from_numpy(coeffs).to(dev), noise,
                                mean, use_mean, bs).cpu().numpy()
    with _tr.trace("coeff_chain"):
        ctypes_, cunpred, qcoeffs, cprec = regnd.quantize_coeff_chain(
            coeffs, use_reg, rp, dbs, spec, use_mean)
    lc_full = np.zeros((g["nblocks"], spec.ncoeff), dtype=T)
    lc_full[np.flatnonzero(use_reg)] = qcoeffs
    st = state_mod.from_numpy_state(
        lc_full=lc_full, use_reg=use_reg, loc=g["loc"], rp=rp, recip=recip,
        intervals=intervals, mean=mean, device=dev)

    with _tr.trace("quantize"):
        t_lat = quantize(x, st, use_mean, bs)
        tp = geo.corner_stream(t_lat, dbs)
        hist = hist_kernel.histogram(t_lat.reshape(-1)).cpu().numpy()
        del t_lat
    n_esc = int(hist[0])
    with _tr.trace("escapes"):
        unpred_arr = (stages.escape_values(x, tp, dbs).cpu().numpy()
                      if n_esc else np.zeros(0, T))
    state_num = 2 * intervals
    freq = np.zeros(2 * state_num, np.int64)
    freq[:min(65536, 2 * state_num)] = hist[:min(65536, 2 * state_num)]

    with _tr.trace("huffman_tree"):
        tables = huffman.build_tables(None, state_num, freq=freq)
    total_bits = int((freq[:len(tables.code_len)]
                      * tables.code_len.astype(np.int64)).sum())
    st = st.with_tables(tables)
    with _tr.trace("bitpack_device"):
        packed = pack_kernel.pack_bits(tp, st.code_hi, st.code_lo,
                                       st.code_len, total_bits)
        devmod.sync(dev)
    with _tr.trace("stream_download"):
        encoded = packed.cpu().numpy().tobytes()

    with _tr.trace("assemble"):
        return regnd.assemble_body(
            spec, rp, intervals, use_mean, mean, use_reg, ctypes_, cunpred,
            cprec, unpred_arr, size_type, freq=freq, tables=tables,
            encoded=encoded,
            encode_coeff_types=lambda t, syms: _pack(t, syms, dev))


def _pack(tables, syms: np.ndarray, dev) -> bytes:
    """A (small) coefficient type stream Huffman-packed by K4."""
    tt = state_mod.table_tensors(tables, dev)
    total_bits = int(tables.code_len[syms].astype(np.int64).sum())
    packed = pack_kernel.pack_bits(
        torch.from_numpy(np.ascontiguousarray(syms, np.int32)).to(dev),
        tt["code_hi"], tt["code_lo"], tt["code_len"], total_bits)
    return packed.cpu().numpy().tobytes()


def quantize(x: torch.Tensor, st, use_mean: bool,
             block_size: int) -> torch.Tensor:
    """Type lattice of the whole field: the regression predictor and its
    quantization (plain torch), then the Lorenzo recurrence (K1)."""
    t_reg, rec_reg, reg_pts, mean_mask = stages.quantize_inputs(
        x, st, use_mean, block_size)
    cap = np.int64(st.intervals)
    return lorenzo_kernel.wavefront_quantize(
        x, t_reg, rec_reg, reg_pts, mean_mask, st.rp, st.recip,
        np.float32(cap - 2), int(st.intervals) // 2, st.mean,
        use_mean=use_mean)


def decompress(body: bytes, shape, dtype=np.float32, size_type: int = 8, *,
               device, as_tensor: bool = False):
    """Port of ``sz_tpu.tpu.engine.decompress`` with the device Huffman
    decode (``device_decode_policy`` on); output bit-equal to
    ``regnd.decompress``.  Only the coded bytes cross to the device.
    Returns numpy, or the device tensor when ``as_tensor``.  ``body`` may
    be a memoryview: the coded stream is then never copied on the host
    before its upload."""
    dev = devmod.resolve(device)
    body = memoryview(body)
    shape = tuple(int(r) for r in shape)
    n = int(np.prod(shape))

    def decode_coeff_types(tree, encoded, count):
        return fsm_kernel.decode(tree, encoded, count, dev)[0].cpu().numpy()

    with _tr.trace("parse_body"):
        p = regnd.parse_body(body, shape, dtype, size_type,
                             decode_coeff_types)
    spec = p.spec
    T = spec.T
    with _tr.trace("stream_upload"):
        coded = fsm_kernel.upload(p.tree, p.encoded, dev)
        devmod.sync(dev)
    with _tr.trace("huffman_device"):
        types, steps = fsm_kernel.decode_coded(coded, n, dev)
        del coded
        devmod.sync(dev)
    _tr.count("fsm_steps", steps)
    g = geo.geom_small(shape, spec.block_size)
    use_reg = p.indicator == 0
    lc_full = np.zeros((g["nblocks"], spec.ncoeff), dtype=T)
    lc_full[np.flatnonzero(use_reg)] = p.qcoeffs
    rp = T(p.rp)
    st = state_mod.from_numpy_state(
        lc_full=lc_full, use_reg=use_reg, loc=g["loc"], rp=rp,
        recip=T(T(1) / rp), intervals=p.intervals, mean=p.mean, device=dev)
    with _tr.trace("delattice"):
        t_lat, unpred_lat = stages.delattice(
            types, torch.from_numpy(np.array(p.unpred, dtype=T)).to(dev),
            g["dbs"], shape)
        del types
        devmod.sync(dev)
    with _tr.trace("decode_fixpoint"):
        known_mask, known, q_lor = stages.decode_inputs(
            t_lat, unpred_lat, st, bool(p.use_mean), spec.block_size)
        del t_lat, unpred_lat
        out = lorenzo_kernel.wavefront_decode(known_mask, known, q_lor)
        devmod.sync(dev)
    if as_tensor:
        return out
    with _tr.trace("download"):
        return out.cpu().numpy()
