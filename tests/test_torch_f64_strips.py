"""K1d/K2d's strip decomposition on the CPU: the claim order and the
hand-offs the float64 kernels of ``csrc/lorenzo.cu`` (on the machinery of
``csrc/strips.cuh``) read, modelled in numpy and held to the plain
versions and to sz_tpu.

- ``strips.strip_order`` for K1d's and K2d's blocks (``WARPS_F64``): every
  unit once, each unit's predecessors earlier, on the ragged edges;
- a numpy model of the strip walk in the kernel's order: warps as
  coroutines that stop at each of the kernel's waits (a progress mark in
  shared memory, a flag in device memory), run in a random interleaving
  that the waits allow; each lane walks its row skewed by its lane, B
  comes from the lane above (the shuffle), C and E from the ring of the
  plane above, the rows above from the ring's row -1, every ring slot and
  every flag bit tagged with the point it holds and every read of a
  neighbour inside the lattice checked against the point the step needs
  (outside it the rule selects 0.0: the ring holds other points there);
  staging by slot chunks (X from the source the flag picks, K1d's
  t_reg), the flags as each lane's bits by column mod 32, and the output
  by slot chunks, K1d's types written over t_reg.  Its types and
  reconstruction (K1d) and its decode (K2d, on the inputs a decoder
  derives from them) equal quantize_plain / decode_plain and sz_tpu's
  XLA _quantize_fn / _decode_fn in float64, bit for bit;
- itv * 0.5 against itv / 2, and trunc of it, on |itv| >= 1 (both signs,
  near the largest finite value), +-inf and NaN.

Inputs from numpy seeds.  Tolerance: exact -- equal bits.
"""

import pathlib

import numpy as np
import pytest
import torch
torch.set_num_threads(1)  # xdist workers share the cores: one thread each

import jax.numpy as jnp

from sz_tpu.tpu import engine as jeng

from sz_tpu_torch import state
from sz_tpu_torch.core import regnd as tregnd
from sz_tpu_torch.gpu import geometry as geo
from sz_tpu_torch.gpu import lorenzo_kernel as lk
from sz_tpu_torch.gpu import stages, strips

F64 = np.float64
LANES, CHUNK = strips.LANES, strips.CHUNK
INTERVALS = 64


def _bits(a):
    return np.ascontiguousarray(a, F64).view(np.uint64)


# --- the claim order --------------------------------------------------------

# (rank, r1, r2): strips of 31, 33 and 65 rows, plane counts no multiple
# of a block's warps, one plane, one row
ORDER_CASES = [(3, 7, 31), (3, 13, 33), (3, 11, 65), (3, 1, 70), (3, 9, 1),
               (3, 512, 512), (2, 1, 31), (2, 1, 33), (2, 1, 65),
               (2, 1, 1), (2, 1, 1800)]


@pytest.mark.parametrize("kind", ["quantize", "decode"])
@pytest.mark.parametrize("rank,r1,r2", ORDER_CASES)
def test_strip_order_f64_blocks(rank, r1, r2, kind):
    warps = lk.WARPS_F64[kind, rank]
    ng, ns = strips.strip_grid(rank, r1, r2, warps)
    order = strips.strip_order(rank, 1, r1, r2, warps)
    assert sorted(order.tolist()) == list(range(ng * ns))
    pos = np.empty(order.size, np.int64)
    pos[order] = np.arange(order.size)
    g, s = np.arange(order.size) // ns, np.arange(order.size) % ns
    for dg, ds in ((1, 0), (0, 1), (1, 1)):
        has = (g >= dg) & (s >= ds)
        pred = (g - dg) * ns + s - ds
        assert (pos[pred[has]] < pos[np.arange(order.size)[has]]).all()
    if rank == 3:
        assert (ng, ns) == (-(-r1 // warps), -(-r2 // LANES))
    else:
        assert (ng, ns) == (1, -(-(-(-r2 // LANES)) // warps))


def test_f64_blocks_fit_one_an_sm():
    """K1d's and K2d's blocks (lorenzo.cu LorenzoStrip: W warps, rings of
    RING_F64 slots, the staging region's X, T and flag words) fit one
    block's shared memory; the mirrors are the source's."""
    src = (pathlib.Path(lk.__file__).resolve().parent.parent / "csrc"
           / "lorenzo.cu").read_text()
    assert ("static constexpr int W = kRank == 2 ? {} : kDec ? {} : {};"
            .format(lk.WARPS_F64["quantize", 2], lk.WARPS_F64["decode", 3],
                    lk.WARPS_F64["quantize", 3]) in src)
    assert lk.WARPS_F64["quantize", 2] == lk.WARPS_F64["decode", 2]
    assert "static constexpr int kRing = kRank == 3 ? {} : {};".format(
        lk.RING_F64[3], lk.RING_F64[2]) in src
    for const in ("kFlags = kDec ? 1 : 2;", "kSeg = 24;", "kFlagSlots = 3;",
                  "kOffT = G::kRingS * 8;",
                  "kOffF = kOffT + (kDec ? 0 : G::kRingS * 4);"):
        assert f"static constexpr int {const}" in src
    for (kind, rank), w in lk.WARPS_F64.items():
        sb, ring = lk.STAGE_BYTES_F64[kind, rank], lk.RING_F64[rank]
        assert lk.shared_bytes_f64(kind, rank) == strips.shared_bytes(
            w, 8, sb, ring) <= 232448
    assert lk.STAGE_BYTES_F64["quantize", 3] == 17280
    assert lk.STAGE_BYTES_F64["decode", 3] == 10752


# --- the model of the strip walk -------------------------------------------

class _Model:
    """The strip walk of one K1d (decode False) or K2d call, in numpy.

    Each warp is a coroutine that yields a predicate at each of the
    kernel's waits; ``run`` resumes, at random, warps whose predicate
    holds.  Rings, staging slots, flag bits and scratch carry a tag per
    entry (the point's raster key or column, -1 for none) beside the
    value, and every read of a neighbour the predictor uses is checked
    against the point it must hold."""

    def __init__(self, shape, decode, seed):
        self.rank, _, self.r1, self.r2, self.r3 = lk.strip_lattice(shape)
        self.decode = decode
        self.W = lk.WARPS_F64["decode" if decode else "quantize", self.rank]
        self.RING = lk.RING_F64[self.rank]
        self.G = strips.GROUP[self.rank]
        self.ng, self.ns = strips.strip_grid(self.rank, self.r1, self.r2,
                                             self.W)
        self.nunits = self.ng * self.ns
        self.order = strips.strip_order(self.rank, 1, self.r1, self.r2,
                                        self.W)
        self.nc = -(-self.r3 // CHUNK)
        n_rows, n_planes, n_flags = strips.scratch_sizes(
            self.rank, 1, self.r1, self.r2, self.r3, self.W)
        self.rows = np.full(max(n_rows, 1), np.nan)
        self.rows_tag = np.full(max(n_rows, 1), -1, np.int64)
        self.planes = np.full(max(n_planes, 1), np.nan)
        self.planes_tag = np.full(max(n_planes, 1), -1, np.int64)
        self.flags = np.zeros(n_flags, np.int64)
        self.rng = np.random.default_rng(seed)
        self.reads = 0

    def key(self, i, j, k):
        ok = (i >= 0) & (j >= 0) & (j < self.r2) & (k >= 0) & (k < self.r3)
        return np.where(ok, (i * self.r2 + j) * self.r3 + k, -2)

    def check(self, tag, want, used):
        """A read of a neighbour: where `used`, the tag must be `want`."""
        self.reads += int(used.sum())
        bad = used & (tag != want)
        assert not bad.any(), (tag[bad][:4], want[bad][:4])

    # --- the arithmetic of a step, as lorenzo.cu's LorenzoStrip ----------

    def point(self, x, t_reg, f0, f1, i, j, k, A, B, D, C, E, F, G):
        z = F64(0)
        iz, jz, kz = i == 0, j == 0, k == 0
        A = np.where(kz, z, A)
        B = np.where(jz, z, B)
        C = np.where(iz, z, C)
        D = np.where(jz | kz, z, D)
        E = np.where(iz | jz, z, E)
        F = np.where(iz | kz, z, F)
        G = np.where(iz | jz | kz, z, G)
        with np.errstate(all="ignore"):
            p = A + B
            p = p + C
            p = p - D
            p = p - F
            p = p - E
            p = p + G
            if self.decode:
                return np.where(f0, x, p + x), None
            a = self.args
            diff = x - p
            itv = np.abs(diff) * a["recip"] + 1.0
            within = itv < a["cap"]
            h = np.trunc(np.where(diff < 0, -itv, itv) * 0.5)
            rec = p + (h + h) * a["rp"]
            ok = within & (np.abs(x - rec) <= a["rp"])
            t = np.where(ok, np.where(ok, h, 0).astype(np.int64)
                         + a["radius"], 0)
            rec = np.where(ok, rec, x)
        if a["use_mean"]:
            t = np.where((t != 0) & (t <= a["radius"]), t - 1, t)
            t = np.where(f1, a["radius"], t)
            rec = np.where(f1, a["mean"], rec)
        return np.where(f0, x, rec), np.where(f0, t_reg, t)

    # --- one warp's walk of unit u (strips.cuh walk) ---------------------

    def walk(self, blk, u, gi, si, w):
        W, G, C_ = self.W, self.G, CHUNK
        RING, MASK = self.RING, self.RING - 1
        r1, r2, r3, rank = self.r1, self.r2, self.r3, self.rank
        lanes = np.arange(LANES)
        mark = blk["mark"]
        i = gi * W + w if rank == 3 else 0
        j0 = LANES * (si if rank == 3 else si * W + w)
        if i >= r1 or j0 >= r2:
            mark[w] = 1 << 30
            return
        rows = min(LANES, r2 - j0)
        up, own = blk["val"][w], blk["val"][w + 1]
        upt, owt = blk["tag"][w], blk["tag"][w + 1]
        nxt = blk["val"][w + 2] if w + 2 <= W else None
        nxt_t = blk["tag"][w + 2] if w + 2 <= W else None
        X, X_t = blk["X"][w], blk["X_t"][w]
        T, T_t, T_kind = blk["T"][w], blk["T_t"][w], blk["T_kind"][w]
        # the lanes' flag bits by column mod 32, tagged with the column;
        # the flag words' buffer, 3 slot chunks, tagged with the chunk
        m0 = np.zeros((LANES, 32), bool)
        m1 = np.zeros((LANES, 32), bool)
        m_t = np.full((LANES, 32), -1, np.int64)
        fbuf_t = np.full(3, -1, np.int64)
        has_next = w + 1 < W
        feed_next = (rank == 2 and has_next and rows == LANES
                     and j0 + LANES < r2)
        last_step = r3 + rows - 2
        xs = r3 + LANES
        nsc = (last_step + C_) // C_
        pub_rows = (rank == 3 or w == W - 1) and si + 1 < self.ns
        pub_plane = rank == 3 and w == W - 1 and gi + 1 < self.ng
        src_row = None
        src_done = (r3 - 1 + LANES - 1) // C_ + 1
        if si > 0 and (rank == 3 or w == 0):
            src_flag = (u - 1) * (W + 1) + (w if rank == 3 else W - 1)
            src_row = ((si - 1) * r1 + i) * r3
        row_key = lambda r, col: self.key(i, j0 + r, col)
        inp = self.inputs

        def chunk_cols(c, r):
            """Row r's columns of slot chunk c on the lattice."""
            col = c * C_ - r + np.arange(C_)
            return col[(col >= 0) & (col < r3)]

        def copy_flags(c):
            fbuf_t[c % 3] = c

        def stage(c):
            assert fbuf_t[c % 3] == c        # the chunk's flag words landed
            for r in range(rows):
                col = chunk_cols(c, r)
                x = (col + r) & MASK
                f0 = inp["f0"][i, j0 + r, col]
                X[r, x] = np.where(f0, inp["src1"][i, j0 + r, col],
                                   inp["src0"][i, j0 + r, col])
                X_t[r, x] = row_key(r, col)
                if not self.decode:
                    T[r, x] = inp["t_reg"][i, j0 + r, col]
                    T_t[r, x] = row_key(r, col)
                    T_kind[r, x] = 0           # t_reg, not yet a type
                m0[r, col & 31] = f0
                m1[r, col & 31] = inp["f1"][i, j0 + r, col]
                m_t[r, col & 31] = col
            if c + 2 < nsc:
                copy_flags(c + 2)

        def output(c):
            for r in range(rows):
                col = chunk_cols(c, r)
                x = (col + r) & MASK
                want = row_key(r, col)
                assert (owt[r + 1, x] == want).all()
                if not self.decode:
                    assert (T_t[r, x] == want).all() and \
                        (T_kind[r, x] == 1).all()
                    self.types_out[i, j0 + r, col] = T[r, x]
                self.R_out[i, j0 + r, col] = own[r + 1, x]
                if pub_rows and r == LANES - 1:
                    at = (si * r1 + i) * r3 + col
                    self.rows[at] = own[r + 1, x]
                    self.rows_tag[at] = want
            if pub_rows:
                self.flags[u * (W + 1) + w] = c + 1

        def publish_plane(c):
            x = c * C_ + np.arange(C_)
            base = (gi * r2 + j0) * xs
            for r in range(rows):
                ok = (x - r >= 0) & (x - r < r3)
                at = base + r * xs + x[ok]
                self.planes[at] = own[r + 1, x[ok] & MASK]
                self.planes_tag[at] = owt[r + 1, x[ok] & MASK]
            self.flags[u * (W + 1) + W] = c + 1

        def halo(c):
            col = c * C_ + np.arange(C_)
            col = col[col < r3]
            need = min((c * C_ + C_ - 1 + LANES - 1) // C_ + 1, src_done)
            if src_row is not None:
                f = src_flag
                yield lambda: self.flags[f] >= need
                own[0, (col - 1) & MASK] = self.rows[src_row + col]
                owt[0, (col - 1) & MASK] = self.rows_tag[src_row + col]
            if rank == 3 and w == 0 and gi > 0 and si > 0:
                f = (u - self.ns - 1) * (W + 1) + W - 1
                yield lambda: self.flags[f] >= need
                at = ((si - 1) * r1 + i - 1) * r3 + col
                up[0, (col - 1) & MASK] = self.rows[at]
                upt[0, (col - 1) & MASK] = self.rows_tag[at]

        def plane_above(c):
            f = (u - self.ns) * (W + 1) + W
            yield lambda: self.flags[f] >= c + 1
            x = c * C_ + np.arange(C_)
            x = x[x < xs]
            base = ((gi - 1) * r2 + j0) * xs
            for r in range(rows):
                up[r + 1, x & MASK] = self.planes[base + r * xs + x]
                upt[r + 1, x & MASK] = self.planes_tag[base + r * xs + x]

        # a lane's last results carry garbage off the lattice, as the
        # kernel's lanes do
        A = self.rng.standard_normal(LANES)
        Bp, Cp, Ep = A.copy(), A.copy(), A.copy()
        Ak, Bk, Ck, Ek = (np.full(LANES, -3, np.int64) for _ in range(4))
        copy_flags(0)
        if nsc > 1:
            copy_flags(1)
        stage(0)
        for p in range(nsc + 1):
            s0 = p * C_
            if p >= 1:
                output(p - 1)
            if pub_plane and p >= 1:
                publish_plane(p - 1)
            if p + 1 < nsc:
                stage(p + 1)
            if p < self.nc:
                if rank == 3 and has_next:
                    yield lambda: mark[w + 1] >= s0 + C_ - RING
                yield from halo(p)
            if rank == 3 and w == 0 and gi > 0 and p < nsc:
                yield from plane_above(p)
            s = s0
            while s < s0 + C_ and s <= last_step:
                if w > 0:
                    need = s + G + (0 if rank == 3 else 31)
                    yield lambda: mark[w - 1] >= need
                if has_next:
                    need2 = s + G - (RING - 1 if rank == 3
                                     else RING + LANES - 1)
                    yield lambda: mark[w + 1] >= need2
                # the group's inputs (slot s + q; row -1 and E at s + q - 1)
                xq = [(s + q) & MASK for q in range(G)]
                xm = [(s + q - 1) & MASK for q in range(G)]
                ld = []
                for q in range(G):
                    k = s + q - lanes
                    b = k & 31
                    ld.append(dict(
                        x=X[lanes, xq[q]].copy(), x_t=X_t[lanes, xq[q]].copy(),
                        t=T[lanes, xq[q]].copy(), t_t=T_t[lanes, xq[q]].copy(),
                        t_kind=T_kind[lanes, xq[q]].copy(),
                        f0=m0[lanes, b].copy(), f1=m1[lanes, b].copy(),
                        f_t=m_t[lanes, b].copy(),
                        hb=own[0, xm[q]], hb_t=owt[0, xm[q]],
                        C=up[lanes + 1, xq[q]].copy(),
                        C_t=upt[lanes + 1, xq[q]].copy(),
                        E=up[lanes, xm[q]].copy(),
                        E_t=upt[lanes, xm[q]].copy()))
                Rv, tv = [], []
                for q in range(G):
                    L = ld[q]
                    k = s + q - lanes
                    j = j0 + lanes
                    act = (lanes < rows) & (k >= 0) & (k < r3)
                    B = np.concatenate([[L["hb"]], A[:-1]])
                    Bk_ = np.concatenate([[L["hb_t"]], Ak[:-1]])
                    # every neighbour inside the lattice holds its point
                    self.check(Ak, self.key(i, j, k - 1), act & (k >= 1))
                    self.check(Bk_, self.key(i, j - 1, k), act & (j >= 1))
                    self.check(Bk, self.key(i, j - 1, k - 1),
                               act & (j >= 1) & (k >= 1))
                    if i > 0:
                        self.check(L["C_t"], self.key(i - 1, j, k), act)
                        self.check(L["E_t"], self.key(i - 1, j - 1, k),
                                   act & (j >= 1))
                        self.check(Ck, self.key(i - 1, j, k - 1),
                                   act & (k >= 1))
                        self.check(Ek, self.key(i - 1, j - 1, k - 1),
                                   act & (j >= 1) & (k >= 1))
                    self.check(L["x_t"], self.key(i, j, k), act)
                    self.check(L["f_t"], k, act)
                    if not self.decode:   # a regression point reads t_reg
                        used = act & L["f0"]
                        self.check(L["t_t"], self.key(i, j, k), used)
                        assert not (used & (L["t_kind"] != 0)).any()
                    R, t = self.point(L["x"], L["t"], L["f0"], L["f1"], i, j,
                                      k, A, B, Bp, L["C"], L["E"], Cp, Ep)
                    Rv.append(R)
                    tv.append(t)
                    A, Bp, Cp, Ep = R, B, L["C"], L["E"]
                    Ak, Bk, Ck, Ek = (self.key(i, j, k), Bk_, L["C_t"],
                                      L["E_t"])
                # the group's results into the rings
                for q in range(G):
                    k = s + q - lanes
                    act = (lanes < rows) & (k >= 0) & (k < r3)
                    x = xq[q]
                    own[lanes[act] + 1, x] = Rv[q][act]
                    owt[lanes[act] + 1, x] = self.key(i, j0 + lanes[act],
                                                      k[act])
                    if not self.decode:
                        T[lanes[act], x] = tv[q][act]
                        T_t[lanes[act], x] = self.key(i, j0 + lanes[act],
                                                      k[act])
                        T_kind[lanes[act], x] = 1
                    if feed_next and act[-1]:
                        nxt[0, (s + q - LANES) & MASK] = Rv[q][-1]
                        nxt_t[0, (s + q - LANES) & MASK] = self.key(
                            i, j0 + LANES - 1, k[-1])
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
            si, gi = u % self.ns, u // self.ns
            blk["mark"][:] = 0
            warps = [self.walk(blk, u, gi, si, w) for w in range(self.W)]
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
                yield None

    def run(self, inputs, args=None, blocks=3):
        """inputs (numpy, rank-3 shaped): K1d src0 = data, src1 =
        rec_reg, f0 = reg, f1 = the mean flags, t_reg; K2d src0 = q_lor,
        src1 = known, f0 = known_mask, f1 = 0."""
        shape3 = (self.r1, self.r2, self.r3)
        self.inputs = {k: v.reshape(shape3) for k, v in inputs.items()}
        self.args = args
        self.types_out = np.full(shape3, -1, np.int64)
        self.R_out = np.full(shape3, np.nan)
        self.counter = 0
        W, PITCH = self.W, self.RING + 1
        blks = []
        for _ in range(blocks):
            blk = dict(
                val=np.full((W + 2, LANES + 1, PITCH), np.nan),
                tag=np.full((W + 2, LANES + 1, PITCH), -1, np.int64),
                X=np.full((W, LANES, PITCH), np.nan),
                X_t=np.full((W, LANES, PITCH), -1, np.int64),
                T=np.full((W, LANES, PITCH), -7, np.int64),
                T_t=np.full((W, LANES, PITCH), -1, np.int64),
                T_kind=np.full((W, LANES, PITCH), -1, np.int8),
                mark=np.zeros(W, np.int64))
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
        return self.types_out, self.R_out


# --- cases: codec states, the model against the plain versions and sz_tpu

def _field(shape, seed):
    rng = np.random.default_rng(seed)
    grids = np.meshgrid(*[np.arange(r) for r in shape], indexing="ij")
    plane = 0.01 * sum((k + 1) * g for k, g in enumerate(grids))
    x = plane + np.sin(0.3 * sum(grids)) + 1e-3 * rng.standard_normal(shape)
    x.reshape(-1)[::7] = x.reshape(-1)[3]          # a dense value cluster
    x.reshape(-1)[5::41] += 0.5                   # escapes
    return x


def _codec_state(data, seed, regression):
    """A float64 codec state: regression coefficients near the field's
    plane on all, none or 40 % of the blocks."""
    shape = data.shape
    bs = tregnd._spec(len(shape), F64).block_size
    g = geo.geom_small(shape, bs)
    rng = np.random.default_rng(seed)
    nb, nc = g["nblocks"], len(shape) + 1
    use_reg = {"all": np.ones(nb, bool), "none": np.zeros(nb, bool),
               "mixed": rng.random(nb) < 0.4}[regression]
    lc_full = np.zeros((nb, nc), F64)
    lc_full[use_reg] = (rng.standard_normal((int(use_reg.sum()), nc)) * 0.01
                        + np.array([0.01 * (k + 1) for k in range(nc - 1)]
                                   + [0.0]))
    rp = F64(1e-3)
    return dict(lc_full=lc_full, use_reg=use_reg, loc=g["loc"], rp=rp,
                recip=F64(F64(1) / rp), intervals=INTERVALS,
                mean=F64(data.reshape(-1)[3])), bs


# (shape, use_mean, regression, xla): strips of 31, 33 and 65 rows,
# plane counts no multiple of a block's warps (5 and 6), rows of 1, 2,
# CHUNK - 1 and CHUNK + 1 columns, one row, one plane; rank 2 with the
# mean flush off, as the codec forces it (sz_float.c:5615).  sz_tpu's XLA
# fixpoints (a compile per shape, about 2 s each on the CPU) on one
# rank-3 and one rank-2 shape with every kind of regression; the plain
# versions, which test_torch_f64.py holds to them, everywhere
MODEL_CASES = [
    ((7, 31, 20), True, "mixed", True), ((7, 31, 20), True, "none", True),
    ((7, 31, 20), True, "all", True), ((13, 33, 17), False, "mixed", False),
    ((6, 65, 15), True, "none", False), ((11, 9, 1), True, "mixed", False),
    ((8, 40, 2), False, "all", False), ((4, 1, 70), True, "mixed", False),
    ((1, 70, 24), True, "mixed", False), ((9, 33, 16), True, "none", False),
    ((70, 33), False, "mixed", True), ((70, 33), False, "none", True),
    ((70, 33), False, "all", True), ((65, 17), False, "none", False),
    ((1, 100), False, "mixed", False),
]
MODEL_IDS = ["x".join(map(str, c[0])) + f"_{'mean' if c[1] else 'nomean'}"
             f"_{c[2]}" for c in MODEL_CASES]


@pytest.mark.parametrize("shape,use_mean,regression,xla", MODEL_CASES,
                         ids=MODEL_IDS)
def test_f64_strip_walk_model(shape, use_mean, regression, xla):
    """The model of K1d's strip walk (random interleavings that the waits
    allow, every neighbour read checked against the point it must hold)
    gives quantize_plain's and sz_tpu's _quantize_fn types and
    reconstruction; K2d's walk on the decoder's inputs gives them back,
    and decode_plain's and _decode_fn's values."""
    data = _field(shape, sum(shape))
    raw, bs = _codec_state(data, len(shape) + shape[-1], regression)
    st = state.from_numpy_state(device="cpu", **raw)
    x = torch.from_numpy(data)
    t_reg, rec_reg, reg_pts, mm = stages.quantize_inputs(x, st, use_mean, bs)
    radius = INTERVALS // 2
    cap = F64(INTERVALS - 2)
    m = _Model(shape, False, sum(shape))
    t_m, R_m = m.run(
        dict(src0=data, src1=rec_reg.numpy(), f0=reg_pts.numpy(),
             f1=(mm.numpy() if use_mean else np.zeros(shape, bool)),
             t_reg=t_reg.numpy().astype(np.int64)),
        dict(rp=raw["rp"], recip=raw["recip"], cap=cap, radius=radius,
             mean=raw["mean"], use_mean=use_mean))
    assert m.reads > 0
    t_m = t_m.reshape(shape)
    R_m = R_m.reshape(shape)
    t_p, R_p = lk.quantize_plain(x, t_reg, rec_reg, reg_pts, mm, raw["rp"],
                                 raw["recip"], cap, radius, raw["mean"],
                                 use_mean=use_mean)
    np.testing.assert_array_equal(t_m, t_p.numpy())
    np.testing.assert_array_equal(_bits(R_m), _bits(R_p.numpy()))
    if xla:
        iperm = jeng._dev_geom(shape, bs)["iperm"]
        t_stream, _, _, R_j, _ = jeng._quantize_fn(
            shape, "float64", bs, use_mean, "cpu")(
            data, raw["lc_full"], raw["use_reg"], tuple(raw["loc"]), iperm,
            raw["rp"], raw["recip"], jnp.asarray(INTERVALS, jnp.int32),
            raw["mean"])
        np.testing.assert_array_equal(_bits(R_m), _bits(np.asarray(R_j)))
        np.testing.assert_array_equal(
            t_m.reshape(-1)[np.asarray(iperm)].astype(np.uint16),
            np.asarray(t_stream))
    # K2d on what a decoder derives from the types
    t = torch.from_numpy(t_m.astype(np.int32))
    unpred_lat = torch.where(t == 0, x, torch.zeros_like(x))
    km, kv, q = stages.decode_inputs(t, unpred_lat, st, use_mean, bs)
    d = _Model(shape, True, sum(shape) + 1)
    _, D_m = d.run(dict(src0=q.numpy(), src1=kv.numpy(), f0=km.numpy(),
                        f1=np.zeros(shape, bool),
                        t_reg=np.zeros(shape, np.int64)))
    D_m = D_m.reshape(shape)
    np.testing.assert_array_equal(_bits(D_m), _bits(R_m))
    np.testing.assert_array_equal(_bits(D_m),
                                  _bits(lk.decode_plain(km, kv, q).numpy()))
    if xla:
        D_j, _ = jeng._decode_fn(shape, "float64", bs, use_mean, "cpu")(
            jnp.asarray(t.numpy()), raw["lc_full"], raw["use_reg"],
            jnp.asarray(unpred_lat.numpy()), tuple(raw["loc"]), raw["rp"],
            jnp.asarray(INTERVALS, jnp.int32), raw["mean"])
        np.testing.assert_array_equal(_bits(D_m), _bits(np.asarray(D_j)))


def test_f64_strip_walk_model_catches_a_missing_select():
    """The model's checks bite: without the rule's select of 0.0 at
    k = 0, the garbage a lane carries off the lattice reaches a point."""
    shape = (3, 33, 20)
    data = _field(shape, 1)
    raw, bs = _codec_state(data, 2, "none")
    st = state.from_numpy_state(device="cpu", **raw)
    x = torch.from_numpy(data)
    t_reg, rec_reg, reg_pts, mm = stages.quantize_inputs(x, st, False, bs)
    km = np.zeros(shape, bool)
    q = rec_reg.numpy() - data
    good = _Model(shape, True, 3).run(dict(
        src0=q, src1=data, f0=km, f1=km, t_reg=np.zeros(shape, np.int64)))[1]
    m = _Model(shape, True, 3)
    plain = m.point
    m.point = lambda x_, t_, f0, f1, i, j, k, A, *rest: plain(
        x_, t_, f0, f1, i, j, k + (k == 0), A, *rest)
    bad = m.run(dict(src0=q, src1=data, f0=km, f1=km,
                     t_reg=np.zeros(shape, np.int64)))[1]
    assert not np.array_equal(_bits(good), _bits(bad))
    np.testing.assert_array_equal(
        _bits(good).reshape(shape),
        _bits(lk.decode_plain(*(torch.from_numpy(a) for a in (
            km, data, q))).numpy()))


# --- itv * 0.5 for itv / 2 --------------------------------------------------

def test_half_by_multiply_f64():
    """itv * 0.5 rounds to the bits of itv / 2 on |itv| >= 1 (both signs,
    the largest finite values, +-inf; NaN as NaN), and so does the
    truncation K1d takes of it; 2 (int)h is h + h for every h within the
    intervals."""
    rng = np.random.default_rng(7)
    fi = np.finfo(F64)
    big = np.array([fi.max, np.nextafter(fi.max, 0), fi.max / 3, 2.0 ** 1000,
                    2.0 ** 53 + 1, 2.0 ** 52 + 0.5, 1.0, np.nextafter(1, 2),
                    1.5, 2.5, 3.0, 65535.999, np.inf])
    rand = np.abs(rng.integers(0, np.iinfo(np.uint64).max, 20000,
                               dtype=np.uint64).view(F64))
    rand = rand[np.isfinite(rand) & (rand >= 1)]
    grid = 1 + rng.random(20000) * 70000
    itv = np.concatenate([big, rand, grid, [np.nan]])
    itv = np.concatenate([itv, -itv])
    with np.errstate(all="ignore"):
        a, b = itv * 0.5, itv / 2
    nan = np.isnan(b)
    assert (np.isnan(a) == nan).all() and nan.sum() == 2
    np.testing.assert_array_equal(_bits(a[~nan]), _bits(b[~nan]))
    np.testing.assert_array_equal(_bits(np.trunc(a[~nan])),
                                  _bits(np.trunc(b[~nan])))
    h = np.trunc(np.linspace(-70000, 70000, 9001))
    np.testing.assert_array_equal(_bits(h + h),
                                  _bits((2 * h.astype(np.int64)).astype(F64)))
