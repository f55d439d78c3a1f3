"""K10/K11's strip decomposition on the CPU: the claim order and the
hand-offs the kernels of ``csrc/classic.cu`` read, modelled in numpy and
held to the plain versions and to sz_tpu.

- ``strips.strip_order`` (the units the kernel claims): every
  unit once, each unit's predecessors (g - 1, s), (g, s - 1) and
  (g - 1, s - 1) earlier, a 4-D field's volumes interleaved diagonal by
  diagonal, on the ragged edges (strips of 31, 33 and 65 rows, plane
  counts no multiple of a block's warps, one row, one plane, 128
  volumes of 8^3);
- a numpy model of the strip walk in the kernel's order: warps as
  coroutines that stop at each of the kernel's waits (a progress mark in
  shared memory, a flag in device memory), run in a random interleaving
  that the waits allow; each lane walks its row skewed by its lane, B
  comes from the lane above (the shuffle), C and E from the ring of the
  plane above, the rows above from the ring's row -1, every ring slot
  tagged with the point it holds and every read checked against the
  point the step needs; staging and output by column chunks, the last
  rows and plane published by chunk with their flags (the walk of
  ``csrc/strips.cuh`` in its column-chunk mode, shared with K1d/K2d).
  Its types and reconstruction (K10) and its decode from the compact
  escapes (K11) equal the plain wavefront's and sz_tpu's XLA _encode_fn /
  _decode_fn, in all three numeric forms, on rows of 1, 2, CHUNK - 1 and
  CHUNK + 1 columns as well;
- the compact escapes' raster ranks (``escape_row_base``) against
  _decode_fn's cumsum: no escape, every point, one in the last point,
  one on each row's first point, escapes across a chunk's edge;
- x * 0.5 against x / 2, and the float recheck |x| > rp_dn against
  |(double)x| > rp, on the edge values (subnormals, the largest finite
  value, +-0, +-inf, NaN).

Inputs from numpy seeds.  Tolerance: exact -- equal bits.
"""

import numpy as np
import pytest
import torch
torch.set_num_threads(1)  # xdist workers share the cores: one thread each

import jax.numpy as jnp

from sz_tpu.tpu import classic_engine as jce

from sz_tpu_torch.core import classic_nd as tcn
from sz_tpu_torch.gpu import classic_kernel as ck
from sz_tpu_torch.gpu import strips

from _chip_smoke import SMOKE

F32, F64 = np.float32, np.float64
PITCH, MASK = ck.RING + 1, ck.RING - 1


def _bits(a):
    a = np.ascontiguousarray(a)
    return a.view(np.uint32 if a.dtype == np.float32 else np.uint64)


# --- the claim order --------------------------------------------------------

# (rank, nvol, r1, r2) of the ragged edges
ORDER_CASES = [(3, 1, 7, 31), (3, 1, 13, 33), (3, 1, 5, 65), (3, 1, 1, 70),
               (3, 1, 9, 1), (3, 128, 8, 8), (3, 6, 7, 33), (3, 1, 40, 5),
               (2, 1, 1, 31), (2, 1, 1, 33), (2, 1, 1, 65), (2, 1, 1, 1),
               (2, 1, 1, 1000), (2, 1, 1, 5000)]


@pytest.mark.parametrize("warps", [4, 6])
@pytest.mark.parametrize("rank,nvol,r1,r2", ORDER_CASES)
def test_strip_order(rank, nvol, r1, r2, warps):
    ng, ns = strips.strip_grid(rank, r1, r2, warps)
    order = strips.strip_order(rank, nvol, r1, r2, warps)
    assert order.dtype == np.int32
    assert sorted(order.tolist()) == list(range(nvol * ng * ns))
    pos = np.empty(order.size, np.int64)
    pos[order] = np.arange(order.size)
    u = np.arange(order.size)
    v, g, s = u // (ng * ns), (u // ns) % ng, u % ns
    # every unit's predecessors come earlier
    for dg, ds in ((1, 0), (0, 1), (1, 1)):
        has = (g >= dg) & (s >= ds)
        pred = (v * ng + g - dg) * ns + s - ds
        assert (pos[pred[has]] < pos[u[has]]).all()
    # by diagonal, the volumes side by side within one
    d = (g + s)[order]
    assert (np.diff(d) >= 0).all()
    if nvol > 1:
        first = order[:nvol]
        assert sorted((first // (ng * ns)).tolist()) == list(range(nvol))
    # the units cover the lattice: rank 3 groups of warps planes, rank 2
    # groups of warps strips of LANES rows
    if rank == 3:
        assert ng == -(-r1 // warps) and ns == -(-r2 // strips.LANES)
    else:
        assert ng == 1 and ns == -(-(-(-r2 // strips.LANES)) // warps)


# --- the model of the strip walk -------------------------------------------

def _key(v, i, j, k, r1, r2, r3):
    return ((v * r1 + i) * r2 + j) * r3 + k


class _Model:
    """The strip walk of one K10 (decode False) or K11 call, in numpy.

    Each warp is a coroutine that yields a predicate at each of the
    kernel's waits; ``run`` resumes, at random, warps whose predicate
    holds.  Rings and scratch carry a tag per entry (the point's raster
    key, -1 for none) beside the value, and every read of a neighbour the
    predictor uses is checked against the point it must hold."""

    def __init__(self, shape, dtype, p, decode, seed, warps=None):
        self.rank, self.nvol, self.r1, self.r2, self.r3 = strips.lattice(shape)
        self.V = dtype
        self.dbl = p.form.dbl
        self.p = p
        self.decode = decode
        self.W = warps or ck.WARPS[torch.float64 if dtype == F64
                                   else torch.float32]
        self.G = strips.GROUP[self.rank]
        self.ng, self.ns = strips.strip_grid(self.rank, self.r1, self.r2,
                                         self.W)
        self.nunits = self.nvol * self.ng * self.ns
        self.order = strips.strip_order(self.rank, self.nvol, self.r1, self.r2,
                                    self.W)
        self.nc = -(-self.r3 // strips.CHUNK)
        n_rows, n_planes, n_flags = strips.scratch_sizes(
            self.rank, self.nvol, self.r1, self.r2, self.r3, self.W)
        self.rows = np.full(max(n_rows, 1), np.nan, dtype)
        self.rows_tag = np.full(max(n_rows, 1), -1, np.int64)
        self.planes = np.full(max(n_planes, 1), np.nan, dtype)
        self.planes_tag = np.full(max(n_planes, 1), -1, np.int64)
        self.flags = np.zeros(n_flags, np.int64)
        self.rng = np.random.default_rng(seed)
        self.reads = 0
        self.skip_wait = False   # drop the wait on the warp before

    def _escape(self, rank):
        """K11's escape of a raster rank: past the stream its last value
        (_decode_fn's clip), none in an empty stream."""
        if self.esc.size == 0:
            return self.V(0)
        return self.esc[min(int(rank), self.esc.size - 1)]

    def key(self, v, i, j, k):
        ok = (i >= 0) & (j >= 0) & (j < self.r2) & (k >= 0) & (k < self.r3)
        return np.where(ok, _key(v, i, j, k, self.r1, self.r2, self.r3), -2)

    def check(self, tag, want, used):
        """A read of a neighbour: where `used`, the tag must be `want`."""
        self.reads += int(used.sum())
        bad = used & (want >= 0) & (tag != want)
        assert not bad.any(), (tag[bad][:4], want[bad][:4])

    # --- the arithmetic of a step, as classic.cu computes it -------------

    def predict(self, i, j, k, A, A2, B, D, C, E, F, G):
        V = self.V
        with np.errstate(all="ignore"):
            j0, k0 = j == 0, k == 0
            if i == 0:
                row = np.where(k == 1, A, V(2) * A - A2)
                rest = np.where(k0, B, (A + B) - D)
                return np.where(j0, np.where(k0, V(0), row), rest)
            p = A + B
            p = p + C
            p = p - D
            p = p - E
            p = p - F
            p = p + G
            row = np.where(k0, C, (A + C) - F)
            col = np.where(k0, (B + C) - E, p)
            return np.where(j0, row, col)

    def quantize(self, cur, pred):
        """(t, rec): h = trunc(+-itv / 2) kept in the form's type, 2h as
        h + h, the recheck against rp rounded down to V."""
        p, V = self.p, self.V
        with np.errstate(all="ignore"):
            diff = cur - pred
            m = np.abs(diff.astype(F64)) * F64(p.recip) + 1.0
            if self.dbl:
                within = m < p.intervals
                h = np.trunc(np.where(diff < 0, -m, m) * 0.5)
                rec = (pred.astype(F64) + (h + h) * F64(p.rp)).astype(V)
            else:
                itv = m.astype(F32)
                within = itv < F32(p.intervals)
                h = np.trunc(np.where(diff < 0, -itv, itv) * F32(0.5))
                rec = pred + (h + h) * F32(p.rp)
            rp_dn = F64(p.rp).astype(V)
            if V is F32 and float(rp_dn) > float(p.rp):
                rp_dn = np.nextafter(rp_dn, F32(-np.inf))
            ok = within & ~(np.abs(cur - rec) > rp_dn)
            half = np.where(ok, h, 0).astype(np.int64)
        return np.where(ok, half + p.radius, 0).astype(np.int32), rec

    def recon(self, pred, t):
        p, V = self.p, self.V
        m = 2 * (t.astype(np.int64) - p.radius)
        with np.errstate(all="ignore"):
            if self.dbl:
                return (pred.astype(F64) + m.astype(F64) * F64(p.rp)).astype(V)
            return pred + m.astype(F32) * F32(p.rp)

    def esc_recon(self, cur):
        ity = np.int64 if self.V is F64 else np.int32
        mask = ck._mask(self.p.req_length, torch.float64 if self.V is F64
                        else torch.float32)
        med = self.V(self.p.median)
        with np.errstate(all="ignore"):
            norm = cur - med
            return (norm.view(ity) & ity(mask)).view(self.V) + med

    # --- one warp's walk of unit u (classic.cu walk) ---------------------

    def walk(self, blk, u, v, gi, si, w):
        W, G, C_, V = self.W, self.G, strips.CHUNK, self.V
        r1, r2, r3, rank = self.r1, self.r2, self.r3, self.rank
        lanes = np.arange(strips.LANES)
        mark = blk["mark"]
        i = gi * W + w if rank == 3 else 0
        j0 = strips.LANES * (si if rank == 3 else si * W + w)
        if i >= r1 or j0 >= r2:
            mark[w] = 1 << 30
            return
        rows = min(strips.LANES, r2 - j0)
        up, own = blk["val"][w], blk["val"][w + 1]
        upt, owt = blk["tag"][w], blk["tag"][w + 1]
        nxt = blk["val"][w + 2] if w + 2 <= W else None
        nxt_t = blk["tag"][w + 2] if w + 2 <= W else None
        st, st_t, st_kind = blk["st"][w], blk["st_tag"][w], blk["kind"][w]
        has_next = w + 1 < W
        feed_next = (rank == 2 and has_next and rows == strips.LANES
                     and j0 + strips.LANES < r2)
        last_step = r3 + rows - 2
        xs = r3 + strips.LANES
        nsc = (last_step + C_) // C_
        pub_rows = (rank == 3 or w == W - 1) and si + 1 < self.ns
        pub_plane = rank == 3 and w == W - 1 and gi + 1 < self.ng
        src = self.x if not self.decode else self.types_in
        src_row = None
        if si > 0 and (rank == 3 or w == 0):
            src_flag = (u - 1) * (W + 1) + (w if rank == 3 else W - 1)
            src_row = ((v * self.ns + si - 1) * r1 + i) * r3
        row_key = lambda r, col: self.key(v, i, j0 + r, col)

        def stage(c):
            for r in range(rows):
                col = c * C_ + np.arange(C_)
                col = col[col < r3]
                x = (col + r) & MASK
                st[r, x] = src[v, i, j0 + r, col]
                st_t[r, x] = row_key(r, col)
                st_kind[r, x] = 0          # a value (K10) or a type (K11)

        def output(c):
            col = c * C_ + np.arange(C_)
            col = col[col < r3]
            for r in range(rows):
                x = (col + r) & MASK
                want = row_key(r, col)
                assert (owt[r + 1, x] == want).all()
                if not self.decode:
                    assert (st_t[r, x] == want).all() and \
                        (st_kind[r, x] == 1).all()
                    self.types_out[v, i, j0 + r, col] = st[r, x]
                self.R_out[v, i, j0 + r, col] = own[r + 1, x]
                if pub_rows and r == strips.LANES - 1:
                    at = ((v * self.ns + si) * r1 + i) * r3 + col
                    self.rows[at] = own[r + 1, x]
                    self.rows_tag[at] = want
            if pub_rows:
                self.flags[u * (W + 1) + w] = c + 1

        def publish_plane(c):
            x = c * C_ + np.arange(C_)
            base = ((v * self.ng + gi) * r2 + j0) * xs
            for r in range(rows):
                ok = (x - r >= 0) & (x - r < r3)
                at = base + r * xs + x[ok]
                self.planes[at] = own[r + 1, x[ok] & MASK]
                self.planes_tag[at] = owt[r + 1, x[ok] & MASK]
                assert (owt[r + 1, x[ok] & MASK] ==
                        row_key(r, x[ok] - r)).all()
            self.flags[u * (W + 1) + W] = c + 1

        def halo(c):
            col = c * C_ + np.arange(C_)
            col = col[col < r3]
            if src_row is not None:
                f = src_flag
                yield lambda: self.flags[f] >= c + 1
                own[0, (col - 1) & MASK] = self.rows[src_row + col]
                owt[0, (col - 1) & MASK] = self.rows_tag[src_row + col]
            if rank == 3 and w == 0 and gi > 0 and si > 0:
                f = (u - self.ns - 1) * (W + 1) + W - 1
                yield lambda: self.flags[f] >= c + 1
                at = ((v * self.ns + si - 1) * r1 + i - 1) * r3 + col
                up[0, (col - 1) & MASK] = self.rows[at]
                upt[0, (col - 1) & MASK] = self.rows_tag[at]

        def plane_above(c):
            f = (u - self.ns) * (W + 1) + W
            yield lambda: self.flags[f] >= c + 1
            x = c * C_ + np.arange(C_)
            x = x[x < xs]
            base = ((v * self.ng + gi - 1) * r2 + j0) * xs
            for r in range(rows):
                up[r + 1, x & MASK] = self.planes[base + r * xs + x]
                upt[r + 1, x & MASK] = self.planes_tag[base + r * xs + x]

        # K11's escape cursor
        eidx = np.zeros(strips.LANES, np.int64)
        enext = np.zeros(strips.LANES, V)
        if self.decode:
            rb = self.row_base[(v * r1 + i) * r2 + j0 + lanes[:rows]]
            eidx[:rows] = rb
            for ln in range(strips.LANES):
                enext[ln] = self._escape(eidx[ln])
        A = np.zeros(strips.LANES, V)
        A2, Bp, Cp, Ep = A.copy(), A.copy(), A.copy(), A.copy()
        Ak, A2k, Bk, Ck, Ek = (np.full(strips.LANES, -3, np.int64)
                               for _ in range(5))
        stage(0)
        for p in range(self.nc + 3):
            s0 = p * C_
            if p >= 3:
                output(p - 3)
            if pub_plane and 1 <= p and p - 1 < nsc:
                publish_plane(p - 1)
            if p + 1 < self.nc:
                stage(p + 1)
            if p < self.nc:
                if rank == 3 and has_next:
                    yield lambda: mark[w + 1] >= s0 - 48
                yield from halo(p)
            if rank == 3 and w == 0 and gi > 0 and p < nsc:
                yield from plane_above(p)
            s = s0
            while s < s0 + C_ and s <= last_step:
                if w > 0 and not self.skip_wait:
                    need = s + G + (0 if rank == 3 else 31)
                    yield lambda: mark[w - 1] >= need
                if has_next:
                    need2 = s + G - (63 if rank == 3 else 95)
                    yield lambda: mark[w + 1] >= need2
                # the group's inputs (slot s + q; row -1 and E at s + q - 1)
                xq = [(s + q) & MASK for q in range(G)]
                xm = [(s + q - 1) & MASK for q in range(G)]
                xin = [st[lanes, xq[q]].copy() for q in range(G)]
                xin_t = [st_t[lanes, xq[q]].copy() for q in range(G)]
                xin_kind = [st_kind[lanes, xq[q]].copy() for q in range(G)]
                hb = [own[0, xm[q]] for q in range(G)]
                hb_t = [owt[0, xm[q]] for q in range(G)]
                Cv = [up[lanes + 1, xq[q]].copy() for q in range(G)]
                Cv_t = [upt[lanes + 1, xq[q]].copy() for q in range(G)]
                Ev = [up[lanes, xm[q]].copy() for q in range(G)]
                Ev_t = [upt[lanes, xm[q]].copy() for q in range(G)]
                Rv, tv = [], []
                if self.decode:
                    em = np.zeros(strips.LANES, np.int64)
                    for q in range(G):
                        k = s + q - lanes
                        act = (lanes < rows) & (k >= 0) & (k < r3)
                        em |= (act & (xin[q].astype(np.int64) == 0)) << q
                    ev = [np.zeros(strips.LANES, V) for _ in range(G)]
                    if em.any():
                        for q in range(G):
                            before = np.array([bin(int(e) & ((1 << q) - 1))
                                               .count("1") for e in em])
                            on = (em >> q) & 1 == 1
                            far = np.array([self._escape(e) for e in
                                            eidx + before], V)
                            ev[q] = np.where(on, np.where(
                                before == 0, enext, far), V(0))
                for q in range(G):
                    k = s + q - lanes
                    j = j0 + lanes
                    act = (lanes < rows) & (k >= 0) & (k < r3)
                    # B: the lane above's last result (shuffle), lane 0
                    # the ring's row -1
                    B = np.concatenate([[hb[q]], A[:-1]]).astype(V)
                    Bk_ = np.concatenate([[hb_t[q]], Ak[:-1]])
                    # every neighbour the predictor uses holds its point
                    ii = i
                    self.check(Ak, self.key(v, ii, j, k - 1), act & (k >= 1))
                    self.check(A2k, self.key(v, ii, j, k - 2),
                               act & (k >= 2) & (j == 0) & (ii == 0))
                    self.check(Bk_, self.key(v, ii, j - 1, k), act & (j >= 1))
                    self.check(Bk, self.key(v, ii, j - 1, k - 1),
                               act & (j >= 1) & (k >= 1))
                    if rank == 3 and ii > 0:
                        self.check(Cv_t[q], self.key(v, ii - 1, j, k), act)
                        self.check(Ev_t[q], self.key(v, ii - 1, j - 1, k),
                                   act & (j >= 1))
                        self.check(Ck, self.key(v, ii - 1, j, k - 1),
                                   act & (k >= 1))
                        self.check(Ek, self.key(v, ii - 1, j - 1, k - 1),
                                   act & (j >= 1) & (k >= 1))
                    self.check(xin_t[q], self.key(v, ii, j, k), act)
                    assert not (act & (xin_kind[q] != 0)).any()
                    pred = self.predict(ii, j, k, A, A2, B, Bp, Cv[q], Ev[q],
                                        Cp, Ep)
                    if self.decode:
                        t = xin[q].astype(np.int32)
                        R = self.recon(pred, t)
                        if em.any():
                            R = np.where(t == 0, ev[q], R)
                    else:
                        t, rec = self.quantize(xin[q], pred)
                        first = (ii == 0) & (j == 0) & (k == 0)
                        t = np.where(first, 0, t).astype(np.int32)
                        R = np.where(t != 0, rec, self.esc_recon(xin[q]))
                        tv.append(t)
                    Rv.append(R.astype(V))
                    A2, A, Bp, Cp, Ep = A, R.astype(V), B, Cv[q], Ev[q]
                    A2k, Ak, Bk, Ck, Ek = (Ak, self.key(v, ii, j, k), Bk_,
                                           Cv_t[q], Ev_t[q])
                if self.decode and em.any():
                    cnt = np.array([bin(int(e)).count("1") for e in em])
                    for ln in np.nonzero(cnt)[0]:
                        eidx[ln] += cnt[ln]
                        enext[ln] = self._escape(eidx[ln])
                # the group's results into the rings
                for q in range(G):
                    k = s + q - lanes
                    act = (lanes < rows) & (k >= 0) & (k < r3)
                    x = xq[q]
                    own[lanes[act] + 1, x] = Rv[q][act]
                    owt[lanes[act] + 1, x] = self.key(v, i, j0 + lanes[act],
                                                      k[act])
                    if not self.decode:
                        st[lanes[act], x] = tv[q][act]
                        st_kind[lanes[act], x] = 1
                    if feed_next and act[-1]:
                        nxt[0, (s + q - strips.LANES) & MASK] = Rv[q][-1]
                        nxt_t[0, (s + q - strips.LANES) & MASK] = self.key(
                            v, i, j0 + strips.LANES - 1, k[-1])
                mark[w] = s + G
                s += G
        mark[w] = 1 << 30

    def block(self, blk):
        """A persistent block: claim a unit, run its warps, repeat."""
        while True:
            n = self.counter
            self.counter += 1
            if n >= self.nunits:
                return
            u = int(self.order[n])
            si, gi = u % self.ns, (u // self.ns) % self.ng
            v = u // (self.ns * self.ng)
            blk["mark"][:] = 0
            warps = [self.walk(blk, u, v, gi, si, w) for w in range(self.W)]
            waits = [None] * self.W
            live = set(range(self.W))
            while live:
                ready = [w for w in live if waits[w] is None or waits[w]()]
                if not ready:
                    yield lambda: any(waits[w]() for w in live)
                    continue
                w = ready[self.rng.integers(len(ready))]
                try:
                    waits[w] = next(warps[w])
                except StopIteration:
                    live.discard(w)
                    # let other blocks run now and then
                yield None

    def run(self, x=None, types=None, esc=None, blocks=3):
        shape4 = (self.nvol, self.r1, self.r2, self.r3)
        V = self.V
        if self.decode:
            self.types_in = types.reshape(shape4)
            counts = (types.reshape(-1, self.r3) == 0).sum(1)
            self.row_base = np.cumsum(counts) - counts
            self.esc = esc
        else:
            self.x = x.reshape(shape4)
            self.types_out = np.full(shape4, -1, np.int32)
        self.R_out = np.full(shape4, np.nan, V)
        self.counter = 0
        blks = []
        for _ in range(blocks):
            blk = dict(
                val=np.full((self.W + 2, strips.LANES + 1, PITCH), np.nan, V),
                tag=np.full((self.W + 2, strips.LANES + 1, PITCH), -1, np.int64),
                st=np.zeros((self.W, strips.LANES, PITCH), V if not self.decode
                            else np.int64),
                st_tag=np.full((self.W, strips.LANES, PITCH), -1, np.int64),
                kind=np.full((self.W, strips.LANES, PITCH), -1, np.int8),
                mark=np.zeros(self.W, np.int64))
            blks.append(self.block(blk))
        waits = [None] * blocks
        live = set(range(blocks))
        while live:
            ready = [b for b in live if waits[b] is None or waits[b]()]
            assert ready, "every block waits: the order deadlocks"
            b = ready[self.rng.integers(len(ready))]
            try:
                waits[b] = next(blks[b])
            except StopIteration:
                live.discard(b)
        return self.types_out if not self.decode else None, self.R_out


def _xla(x, p, types=None, esc=None):
    """sz_tpu's _encode_fn types (and, with types, _decode_fn's values)."""
    T = x.dtype.type
    dstr = np.dtype(T).str.lstrip("<>=")
    vshape = jce._vshape(x.shape)
    if types is None:
        ts, _, _, _ = jce._encode_fn(vshape, dstr, p.form.dbl, "cpu")(
            jnp.asarray(x), T(p.rp), np.float64(p.rp), np.float64(p.recip),
            jnp.asarray(p.intervals, jnp.int32),
            jnp.asarray(p.radius, jnp.int32),
            jnp.asarray(p.req_length, jnp.int32), T(p.median))
        return np.asarray(ts).astype(np.int32)
    pad = np.zeros(max(esc.size, 1), T)
    pad[:esc.size] = esc
    out, _ = jce._decode_fn(vshape, dstr, p.form.dbl, "cpu")(
        jnp.asarray(types.reshape(-1).astype(np.uint16)), jnp.asarray(pad),
        T(p.rp), np.float64(p.rp), jnp.asarray(p.radius, jnp.int32))
    return np.asarray(out)


# (shape, dtype, rp, seed): the three forms; strips of 31, 33 and 65
# rows; plane counts no multiple of the warps; rows of 1, 2, CHUNK - 1
# and CHUNK + 1 columns; one row; one plane; 4-D volumes
MODEL_CASES = [
    ((13, 33, 17), F32, 1e-3, 1), ((7, 31, 15), F32, 1e-4, 2),
    ((5, 65, 2), F32, 1e-3, 3), ((9, 40, 1), F32, 1e-3, 4),
    ((1, 70, 20), F32, 1e-3, 5), ((4, 1, 40), F32, 1e-3, 6),
    ((65, 17), F32, 1e-4, 7), ((33, 40), F32, 1e-3, 8), ((1, 100), F32,
                                                       1e-3, 9),
    ((3, 7, 33, 17), F32, 1e-4, 10), ((9, 5, 6, 15), F32, 1e-4, 11),
    ((11, 33, 17), F64, 1e-6, 12), ((40, 35), F64, 1e-6, 13),
    ((2, 9, 40, 3), F64, 1e-4, 14),
    ((20, 34, 16), F32, 1e-7, 15),     # random data: nearly all escape
]
MODEL_IDS = ["x".join(map(str, c[0])) + "_" + np.dtype(c[1]).name
             for c in MODEL_CASES]


def _case_field(shape, dtype, rp, seed):
    noise = None if rp < 1e-6 and dtype is F32 else 0.1
    return SMOKE.classic_field(shape, dtype, rp, seed, noise)


@pytest.mark.parametrize("shape,dtype,rp,seed", MODEL_CASES, ids=MODEL_IDS)
def test_strip_walk_model(shape, dtype, rp, seed):
    """The model of the strip walk (random interleavings that the waits
    allow, every neighbour read checked against the point it must hold)
    gives the plain versions' types and reconstruction, and sz_tpu's XLA
    types; its decode from the compact escapes gives them back, and
    _decode_fn's values."""
    x, p = _case_field(shape, dtype, rp, seed)
    m = _Model(shape, dtype, p, False, seed)
    t_m, R_m = m.run(x=x)
    assert m.reads > 0
    t_p, R_p = ck.classic_quantize_plain(
        torch.from_numpy(x), p.rp, p.recip, p.intervals, p.radius, p.median,
        p.req_length)
    np.testing.assert_array_equal(t_m.reshape(-1), t_p.numpy().reshape(-1))
    np.testing.assert_array_equal(_bits(R_m).reshape(-1),
                                  _bits(R_p.numpy()).reshape(-1))
    np.testing.assert_array_equal(t_m.reshape(-1), _xla(x, p))
    types = t_m.reshape(shape)
    esc = R_m.reshape(-1)[types.reshape(-1) == 0]
    d = _Model(shape, dtype, p, True, seed + 1)
    _, D_m = d.run(types=types, esc=esc)
    np.testing.assert_array_equal(_bits(D_m).reshape(-1),
                                  _bits(R_m).reshape(-1))
    np.testing.assert_array_equal(
        _bits(D_m).reshape(-1),
        _bits(_xla(x, p, types=types, esc=esc)).reshape(-1))


@pytest.mark.parametrize("keep", [0, 1, 2])
def test_strip_walk_model_short_escapes(keep):
    """A stream with fewer escape values than type-0 points (none, one,
    half): each rank past the end takes the last value, as _decode_fn
    clips, in the model, the plain K11 and sz_tpu alike."""
    shape, dtype = (9, 33, 20), F32
    x, p = _case_field(shape, dtype, 1e-7, 30 + keep)
    t, R = ck.classic_quantize_plain(
        torch.from_numpy(x), p.rp, p.recip, p.intervals, p.radius, p.median,
        p.req_length)
    esc = R.numpy().reshape(-1)[t.numpy().reshape(-1) == 0]
    esc = esc[:[0, 1, esc.size // 2][keep]]
    _, D_m = _Model(shape, dtype, p, True, 31).run(types=t.numpy(), esc=esc)
    D_p = ck.classic_decode_plain(t, torch.from_numpy(esc), p.rp, p.radius)
    np.testing.assert_array_equal(_bits(D_m).reshape(-1),
                                  _bits(D_p.numpy()).reshape(-1))
    if esc.size:
        np.testing.assert_array_equal(
            _bits(D_m).reshape(-1),
            _bits(_xla(x, p, types=t.numpy(), esc=esc)).reshape(-1))


def test_strip_walk_model_128_volumes():
    """128 volumes of 8^3 in one launch's order (the cl_f64_4d golden's
    shape and dtype)."""
    for dtype, rp in ((F64, 1e-6),):
        x, p = _case_field((128, 8, 8, 8), dtype, rp, 16)
        t_m, R_m = _Model(x.shape, dtype, p, False, 17).run(x=x, blocks=5)
        t_p, R_p = ck.classic_quantize_plain(
            torch.from_numpy(x), p.rp, p.recip, p.intervals, p.radius,
            p.median, p.req_length)
        np.testing.assert_array_equal(t_m.reshape(-1),
                                      t_p.numpy().reshape(-1))
        np.testing.assert_array_equal(_bits(R_m).reshape(-1),
                                      _bits(R_p.numpy()).reshape(-1))


def test_strip_walk_model_catches_a_missing_wait():
    """The model's checks bite: without the wait on the plane above's
    progress, some interleaving reads a ring slot before it holds its
    point."""
    x, p = _case_field((13, 33, 40), F32, 1e-3, 21)
    m = _Model(x.shape, F32, p, False, 21)
    m.skip_wait = True
    with pytest.raises(AssertionError, match="tag|\\["):
        m.run(x=x)


# --- the compact escapes' raster ranks -------------------------------------

def _escape_layout(kind, shape, radius, rng):
    t = rng.integers(radius - 3, radius + 4, size=shape).astype(np.int32)
    flat = t.reshape(-1)
    r3 = shape[-1]
    if kind == "all":
        flat[:] = 0
    elif kind == "last":
        flat[-1] = 0
    elif kind == "row_starts":
        flat[::r3] = 0
    elif kind == "chunk_edge":
        for c in range(strips.CHUNK - 2, r3, strips.CHUNK):
            flat[c::r3][::2] = 0
            if c + 2 < r3:
                flat[c + 2::r3][::3] = 0
    elif kind == "random":
        flat[rng.random(flat.size) < 0.3] = 0
    return t


@pytest.mark.parametrize("kind", ["none", "all", "last", "row_starts",
                                  "chunk_edge", "random"])
@pytest.mark.parametrize("shape", [(5, 9, 40), (33, 70), (3, 4, 5, 35)])
def test_escape_ranks(kind, shape):
    """escape_row_base's ranks are _decode_fn's cumsum of t == 0: each
    escape's raster rank is its row's base plus its rank in the row; the
    plain decode on the compact escapes equals _decode_fn's."""
    rng = np.random.default_rng(len(kind) * 7 + len(shape))
    radius = 64
    t = _escape_layout(kind, shape, radius, rng)
    rb, n_esc = ck.escape_row_base(torch.from_numpy(t))
    flat = t.reshape(-1)
    want = np.cumsum(flat == 0) - 1
    r3 = shape[-1]
    row_rank = np.cumsum((flat == 0).reshape(-1, r3), axis=1) - 1
    got = (rb.numpy()[:, None] + row_rank).reshape(-1)
    np.testing.assert_array_equal(got[flat == 0], want[flat == 0])
    assert int(n_esc) == int((flat == 0).sum())
    dtype = F64 if len(shape) == 3 else F32
    esc = rng.standard_normal(int(n_esc)).astype(dtype)
    rp = 1e-3
    x = np.zeros(shape, dtype)
    p = tcn.Params(tcn.form(dtype, len(shape)), tcn.form(dtype, len(shape))
                   .RT(rp), 0, 2 * radius, radius, 32, dtype(0))
    got = ck.classic_decode_plain(torch.from_numpy(t), torch.from_numpy(esc),
                                  p.rp, radius).numpy()
    np.testing.assert_array_equal(
        _bits(got).reshape(-1),
        _bits(_xla(x, p, types=t, esc=esc)).reshape(-1))


# --- x * 0.5 for x / 2, and the float recheck ------------------------------

def _edge_values(T):
    fi = np.finfo(T)
    ity = np.uint32 if T is F32 else np.uint64
    sub = np.array([1, 2, 3, 0x7F, 0x12345], ity).view(T)
    vals = np.concatenate([
        sub, -sub, [fi.tiny, fi.tiny * 3, fi.max, -fi.max, np.nextafter(
            fi.max, 0), T(0), -T(0), T(np.inf), -T(np.inf), T(np.nan),
            T(1), T(-3), T(2.5), fi.eps, fi.smallest_subnormal]]).astype(T)
    rng = np.random.default_rng(5)
    rand = rng.integers(0, np.iinfo(ity).max, 4000, dtype=ity).view(T)
    return np.concatenate([vals, rand])


@pytest.mark.parametrize("T", [F32, F64])
def test_half_by_multiply(T):
    """x * 0.5 rounds to the bits of x / 2 (subnormal results, the
    largest finite value, +-0, +-inf, NaN as NaN), and so does the
    truncation K10 takes of it."""
    x = _edge_values(T)
    with np.errstate(all="ignore"):
        a, b = x * T(0.5), x / T(2)
    nan = np.isnan(b)
    assert (np.isnan(a) == nan).all()
    np.testing.assert_array_equal(_bits(a[~nan]), _bits(b[~nan]))
    with np.errstate(all="ignore"):
        np.testing.assert_array_equal(_bits(np.trunc(a[~nan])),
                                      _bits(np.trunc(b[~nan])))
        # 2 * (int)h as the float h + h, for every h a type can take
        h = np.trunc(np.linspace(-70000, 70000, 9001)).astype(T)
        np.testing.assert_array_equal(
            _bits(h + h), _bits((2 * h.astype(np.int64)).astype(T)))


@pytest.mark.parametrize("rp", [1e-3, 1e-4, 1e-6, 1e-7, 0.1, 3.0,
                                2.0 ** -149, 0.0, 1e-40, 3.4028235e38,
                                1e39])
def test_float_recheck(rp):
    """For a float difference d, |(double)d| > rp iff |d| > rp rounded
    down to float (classic.cu down_to_float)."""
    rp64 = F64(rp)
    with np.errstate(over="ignore"):
        r = F32(rp64)
    if not np.isfinite(r):
        r = np.finfo(F32).max
    if F64(r) > rp64:
        r = np.nextafter(r, F32(-np.inf))
    d = np.concatenate([_edge_values(F32), np.array(
        [np.nextafter(r, F32(0)), r, np.nextafter(r, F32(np.inf)), -r],
        F32)])
    with np.errstate(all="ignore"):
        want = np.abs(d.astype(F64)) > rp64
        got = np.abs(d) > r
    np.testing.assert_array_equal(got, want)
