"""The device stages that are not kernels, in plain torch.

Counterparts of ``sz_tpu.tpu.engine``'s XLA stages: ``_quant``,
``_coeff_sums_fn``, ``_finalize_coeffs`` (host numpy), ``_select_fn``,
the regression predictor of ``_quantize_fn``, the stream/histogram/escape
epilogue, ``_escapes2_fn``, ``_delattice3_fn`` and the decode prelude of
``_decode_fn``.

Bit-exactness rule: each JAX float op is one torch op, in the same
order, so each rounds once as in the serial C.  No ``alpha=``,
``addcmul``, ``lerp`` or ``torch.compile``; no float reductions on values
that reach the stream -- sums loop over in-block positions in C order,
vectorized over blocks.  Float scalars enter as 0-dim float32 tensors on
the data's device.
"""

from __future__ import annotations

import numpy as np
import torch

from sz_tpu_torch.core import blocks as B
from sz_tpu_torch.core import optimizer as opt
from sz_tpu_torch.core import regnd

from sz_tpu_torch.gpu import geometry as geo

F32 = torch.float32


def scalar(v, device) -> torch.Tensor:
    """A float32 0-dim tensor on ``device``."""
    return torch.tensor(np.float32(v), dtype=F32, device=device)


def quant(cur, pred, rp, recip, capf, radius: int):
    """engine._quant: predict -> quantize with escape + epsilon recheck.
    rp, recip, capf: 0-dim float32 tensors.  Returns (t int32, rec)."""
    diff = cur - pred
    itv = diff.abs() * recip + 1.0
    within = itv < capf
    itv = torch.where(diff < 0, -itv, itv)
    t = (itv / 2.0).to(torch.int32) + radius
    rec = pred + (2 * (t - radius)).to(F32) * rp
    ok = within & ((cur - rec).abs() <= rp)
    return torch.where(ok, t, 0), torch.where(ok, rec, cur)


def _region_blocks(data, dbs, ranges, lens):
    """All blocks of one uniform region as (*lens, nblk), contiguous so
    one in-block position is one contiguous vector over blocks."""
    rank = len(dbs)
    starts = [db.start(r0) for db, (r0, _) in zip(dbs, ranges)]
    nb = [r1 - r0 for r0, r1 in ranges]
    sub = data[tuple(slice(s, s + n * ln)
                     for s, n, ln in zip(starts, nb, lens))]
    shp = []
    for n_, ln in zip(nb, lens):
        shp += [n_, ln]
    perm = list(range(1, 2 * rank, 2)) + list(range(0, 2 * rank, 2))
    s = sub.reshape(shp).permute(perm).contiguous()
    nblk = int(np.prod(nb))
    flat_idx = torch.from_numpy(
        regnd._flat_block_idx(dbs, ranges, nb).astype(np.int64)).to(
        data.device)
    return s.reshape(tuple(lens) + (nblk,)), flat_idx


def coeff_sums(data: torch.Tensor, block_size: int) -> torch.Tensor:
    """Per-block regression sums [fx, fy(, fz), f] (nblocks, rank+1), in
    the serial C accumulation order (sz_float.c:6596-6637)."""
    shape = tuple(data.shape)
    rank = len(shape)
    dbs = [B.dim_blocks(r, block_size) for r in shape]
    nblocks = int(np.prod([db.num for db in dbs]))
    out = torch.zeros((nblocks, rank + 1), dtype=F32, device=data.device)
    for ranges, lens in regnd._iter_regions(dbs):
        s, flat_idx = _region_blocks(data, dbs, ranges, lens)
        z = torch.zeros(s.shape[-1], dtype=F32, device=data.device)
        if rank == 3:
            fx = fy = fz = fsum = z
            for i in range(lens[0]):
                sum_x = z
                for j in range(lens[1]):
                    sum_y = z
                    for k in range(lens[2]):
                        cur = s[i, j, k]
                        sum_y = sum_y + cur
                        fz = fz + cur * float(k)
                    sum_x = sum_x + sum_y
                    fy = fy + sum_y * float(j)
                fx = fx + sum_x * float(i)
                fsum = fsum + sum_x
            cols = torch.stack([fx, fy, fz, fsum], dim=1)
        else:
            fx = fy = fsum = z
            for i in range(lens[0]):
                sum_x = z
                for j in range(lens[1]):
                    cur = s[i, j]
                    sum_x = sum_x + cur
                    fy = fy + cur * float(j)
                fx = fx + sum_x * float(i)
                fsum = fsum + sum_x
            cols = torch.stack([fx, fy, fsum], dim=1)
        out[flat_idx] = cols
    return out


def finalize_coeffs(sums: np.ndarray, shape, block_size: int,
                    T=np.float32) -> np.ndarray:
    """Closed-form plane coefficients from the block sums, on the host so
    the divisions round exactly like C (sz_float.c:6627-6637)."""
    dbs = geo.geom_small(tuple(shape), block_size)["dbs"]
    rank = len(shape)
    grids = np.meshgrid(*[db.counts() for db in dbs], indexing="ij")
    lens = [gr.ravel().astype(np.int64) for gr in grids]
    with np.errstate(all="ignore"):
        if rank == 3:
            fx, fy, fz, f = (sums[:, i].astype(T) for i in range(4))
            cbx, cby, cbz = lens
            coeff = (1.0 / (cbx * cby * cbz)).astype(T)
            a = (2 * fx / (cbx - 1).astype(T) - f) * T(6) * coeff \
                / (cbx + 1).astype(T)
            b = (2 * fy / (cby - 1).astype(T) - f) * T(6) * coeff \
                / (cby + 1).astype(T)
            c = (2 * fz / (cbz - 1).astype(T) - f) * T(6) * coeff \
                / (cbz + 1).astype(T)
            d = (f * coeff - ((cbx - 1).astype(T) * a / T(2)
                              + (cby - 1).astype(T) * b / T(2)
                              + (cbz - 1).astype(T) * c / T(2)))
            return np.stack([a, b, c, d], axis=1)
        fx, fy, f = (sums[:, i].astype(T) for i in range(3))
        cbx, cby = lens
        coeff = (1.0 / (cbx * cby)).astype(T)
        a = (2 * fx / (cbx - 1).astype(T) - f) * T(6) * coeff \
            / (cbx + 1).astype(T)
        b = (2 * fy / (cby - 1).astype(T) - f) * T(6) * coeff \
            / (cby + 1).astype(T)
        c = (f * coeff - ((cbx - 1).astype(T) * a / T(2)
                          + (cby - 1).astype(T) * b / T(2)))
        return np.stack([a, b, c], axis=1)


def _select_samples(lens, rank: int):
    """In-block flat indices of each sampled point and its Lorenzo
    neighbours, plus its regression position coefficients
    (sz_float.c:6746-6786; 2-D quirk a*(i-1) at sz_float.c:6023)."""
    bs = min(lens)
    idxs, pcs = [], []
    for i in range(1, bs):
        bmi = bs - i
        if rank == 3:
            pts = (((i, i, i), (i, i, i)),
                   ((i, i, bmi), (i, i, bmi)),
                   ((i, bmi, i), (i, bmi, i)),
                   ((i, bmi, bmi), (i, bmi, bmi)))
        else:
            pts = (((i, i), (i, i)),
                   ((i, bmi), (i - 1, bmi)))
        for pidx, pcoef in pts:
            if rank == 3:
                pi, pj, pk = pidx
                _, cby, cbz = lens

                def fi(a, b, c):
                    return (a * cby + b) * cbz + c

                nb = [fi(pi, pj, pk), fi(pi, pj, pk - 1),
                      fi(pi, pj - 1, pk), fi(pi - 1, pj, pk),
                      fi(pi, pj - 1, pk - 1), fi(pi - 1, pj, pk - 1),
                      fi(pi - 1, pj - 1, pk),
                      fi(pi - 1, pj - 1, pk - 1)]
            else:
                pi, pj = pidx
                cby = lens[1]
                nb = [pi * cby + pj, pi * cby + pj - 1,
                      (pi - 1) * cby + pj, (pi - 1) * cby + pj - 1]
            idxs.append(nb)
            pcs.append([float(np.float32(c)) for c in pcoef])
    return idxs, pcs


def select(data: torch.Tensor, coeffs: torch.Tensor, noise, mean,
           use_mean: bool, block_size: int) -> torch.Tensor:
    """Predictor selection per block (sz_float.c:6746-6786): True where
    the regression predictor's sampled error beats Lorenzo's."""
    shape = tuple(data.shape)
    rank = len(shape)
    dev = data.device
    dbs = [B.dim_blocks(r, block_size) for r in shape]
    nblocks = int(np.prod([db.num for db in dbs]))
    noise_t = scalar(noise, dev)
    mean_t = scalar(mean, dev)
    use_reg = torch.zeros(nblocks, dtype=torch.bool, device=dev)
    for ranges, lens in regnd._iter_regions(dbs):
        s, flat_idx = _region_blocks(data, dbs, ranges, lens)
        s2 = s.reshape(-1, s.shape[-1])        # (in-block position, nblk)
        cf = coeffs[flat_idx].T.contiguous()   # (ncoeff, nblk)
        z = torch.zeros(s2.shape[1], dtype=F32, device=dev)
        err_sz = err_reg = z
        idxs, pcs = _select_samples(lens, rank)
        for nbi, pc in zip(idxs, pcs):
            cur = s2[nbi[0]]
            if rank == 3:
                p = s2[nbi[1]] + s2[nbi[2]]
                p = p + s2[nbi[3]]
                p = p - s2[nbi[4]]
                p = p - s2[nbi[5]]
                p = p - s2[nbi[6]]
                p = p + s2[nbi[7]]
                pr = cf[0] * pc[0] + cf[1] * pc[1]
                pr = pr + cf[2] * pc[2]
                pr = pr + cf[3]
            else:
                p = s2[nbi[1]] + s2[nbi[2]]
                p = p - s2[nbi[3]]
                pr = cf[0] * pc[0] + cf[1] * pc[1]
                pr = pr + cf[2]
            e = (p - cur).abs() + noise_t
            if use_mean:
                e = torch.minimum(e, (mean_t - cur).abs())
            err_sz = err_sz + e
            err_reg = err_reg + (pr - cur).abs()
        use_reg[flat_idx] = err_reg < err_sz
    return use_reg


def dense_mean(data: torch.Tensor, dense_pos, rp):
    """Mean of the dense-value cluster: |x - dense_pos| < rp selected on
    the device in flat order, folded sequentially on the host in the C
    order (sz_float.c:6811-6817)."""
    m = (data - scalar(dense_pos, data.device)).abs() < scalar(rp, data.device)
    vals = data.reshape(-1)[m.reshape(-1)]
    return opt.fold_mean(vals.cpu().numpy(), np.float32)


def expand_blocks(lc_full: torch.Tensor, use_reg: torch.Tensor,
                  shape: tuple, block_size: int):
    """Block -> point expansion: (per-point coefficient lattices, per-point
    regression mask), by per-axis index_select on the block grid."""
    g = geo.geom_small(tuple(shape), block_size)
    nbs = tuple(db.num for db in g["dbs"])
    aug = torch.cat([lc_full, use_reg.to(F32)[:, None]], dim=1).T
    lcb = aug.reshape((aug.shape[0],) + nbs)
    for ax, b in enumerate(geo.dev_bid(shape, block_size, lc_full.device)):
        lcb = lcb.index_select(ax + 1, b)
    return lcb[:-1], lcb[-1] != 0


def regression_predict(lcb: torch.Tensor, loc) -> torch.Tensor:
    """Position-only regression predictor per point (engine.py:830-842)."""
    fl = [l.to(F32) for l in loc]
    if len(loc) == 3:
        return (lcb[0] * fl[0][:, None, None] + lcb[1] * fl[1][None, :, None]
                + lcb[2] * fl[2][None, None, :] + lcb[3])
    return lcb[0] * fl[0][:, None] + lcb[1] * fl[1][None, :] + lcb[2]


def quantize_inputs(data: torch.Tensor, st, use_mean: bool,
                    block_size: int):
    """Everything the Lorenzo recurrence (K1) takes besides the data:
    (t_reg, rec_reg, reg_pts, mean_mask or None) per point."""
    dev = data.device
    lcb, reg_pts = expand_blocks(st.lc_full, st.use_reg, tuple(data.shape),
                                 block_size)
    pred_reg = regression_predict(lcb, st.loc)
    del lcb
    rp, recip = scalar(st.rp, dev), scalar(st.recip, dev)
    capf = scalar(np.float32(st.intervals), dev)
    t_reg, rec_reg = quant(data, pred_reg, rp, recip, capf,
                           st.intervals // 2)
    del pred_reg
    mean_mask = None
    if use_mean:
        mean_mask = (~reg_pts) & ((data - scalar(st.mean, dev)).abs() <= rp)
    return t_reg, rec_reg, reg_pts, mean_mask


def escape_values(data: torch.Tensor, tp: torch.Tensor, dbs) -> torch.Tensor:
    """Escape (type 0) values in stream order (``_escapes2_fn``): stream
    positions of the zeros, mapped to the lattice in closed form."""
    pos = torch.nonzero(tp == 0).reshape(-1)
    lat = geo.pos_to_lat(pos, dbs, tuple(data.shape))
    return data.reshape(-1)[lat]


def delattice(types: torch.Tensor, unpred: torch.Tensor, dbs, shape: tuple):
    """Decode staging (``_delattice3_fn``): compact type stream ->
    (int32 type lattice, escape-value lattice)."""
    n = int(np.prod(shape))
    tp = types[:n].to(torch.int32)
    t_lat = geo.corner_unstream(tp, dbs, shape)
    unpred_lat = torch.zeros(n, dtype=F32, device=types.device)
    pos = torch.nonzero(tp == 0).reshape(-1)
    unpred_lat[geo.pos_to_lat(pos, dbs, shape)] = unpred[:pos.numel()]
    return t_lat, unpred_lat.reshape(shape)


def decode_inputs(t_lat: torch.Tensor, unpred_lat: torch.Tensor, st,
                  use_mean: bool, block_size: int):
    """Decode prelude of ``_decode_fn`` (engine.py:1576-1618): the known
    points (escapes, regression blocks, mean flushes), their values and
    the Lorenzo-side correction 2*(t-radius)*rp per point."""
    dev = t_lat.device
    shape = tuple(t_lat.shape)
    radius = st.intervals // 2
    rp = scalar(st.rp, dev)
    lcb, reg_pts = expand_blocks(st.lc_full, st.use_reg, shape, block_size)
    pred_reg = regression_predict(lcb, st.loc)
    del lcb
    esc = t_lat == 0
    t_adj = t_lat
    if use_mean:
        # use_mean index shift on the Lorenzo side (szd_float.c:3697)
        t_adj = torch.where((~reg_pts) & (t_lat < radius), t_lat + 1, t_lat)
    q_lor = (2 * (t_adj - radius)).to(F32) * rp
    q_reg = (2 * (t_lat - radius)).to(F32) * rp
    reg_val = pred_reg + q_reg
    known_mask = esc | reg_pts
    if use_mean:
        known_mask = known_mask | ((~reg_pts) & (t_lat == radius))
    known = torch.where(esc, unpred_lat,
                        torch.where(reg_pts, reg_val, scalar(st.mean, dev)))
    return known_mask, known, q_lor
