"""Temporal compression in the port, on the CPU, against sz_tpu: the plain
K14 (``ts_quantize``) and K15 (``ts_decode``) against sz_tpu's XLA steps
(``_ts_device_step_fn``, ``_ts_decode_fn``, run by JAX on the CPU) and
against its host codec (``compress_1d_ts`` / ``decompress_1d_ts``) on the
edge cases chip_smoke.py runs the kernels on (``ts_case``), the ts
interval optimizer, whole ``TemporalCompressor``
chains (several variables, float32 and float64, ranks 1-4, every
``CompressionType``, numpy and tensor input) frame for frame with their
decodes and histories after every step, PW_REL (what sz_tpu does, the
port does), the reference library's ts goldens, and a numpy model of the
kernels' two passes (tile ranks, tile prefix, staging, the head peel at
offset inputs) against the plain versions and the XLA step and restore.
Tolerance: exact -- equal bytes, equal bits.
"""

import dataclasses
import pathlib

import numpy as np
import pytest
import torch
torch.set_num_threads(1)  # xdist workers share the cores: one thread each

import sz_tpu.temporal as jtmp
from sz_tpu.config import CompressionType as JType
from sz_tpu.config import ErrorBoundMode as JMode
from sz_tpu.config import SZConfig as JConfig
from sz_tpu.format import tdps as jtdps

from sz_tpu_torch import temporal as ttmp
from sz_tpu_torch.config import CompressionType, ErrorBoundMode, SZConfig
from sz_tpu_torch.core import classic as tclassic
from sz_tpu_torch.format import tdps as ttdps
from sz_tpu_torch.gpu import temporal_kernel as tk

from _chip_smoke import SMOKE
from test_temporal import _norm_frame

GOLDEN = pathlib.Path(__file__).parent / "golden"
KW = dict(max_range_radius=32768, sample_distance=100,
          pred_threshold=np.float32(0.99))


def _bits(a):
    a = np.ascontiguousarray(a)
    return a.view(np.uint32 if a.dtype == np.float32 else np.uint64)


def _median_range(cur):
    T = cur.dtype.type
    vr = T(T(cur.max()) - T(cur.min()))
    return vr, T(T(cur.min()) + vr / T(2))


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("name", SMOKE.TS_CASE_NAMES)
def test_ts_step_matches_host(name, dtype):
    """The port's compress_1d_ts (K14's plain version, the escape stream,
    K3/K4's plain versions) is byte-equal to sz_tpu's host codec and its
    reconstruction bit-equal; K14's escape reconstruction equals the
    exact-value stream's, and the decode (K5-K7, K15) equals sz_tpu's."""
    cur, prev, rp, kw = SMOKE.ts_case(name, dtype)
    vr, med = _median_range(cur)
    t_j, rec_j = jtmp.compress_1d_ts(cur, prev, rp, vr, med, engine="numpy",
                                     **KW, **kw)
    t_t, rec_t = ttmp.compress_1d_ts(cur, prev, rp, vr, med, device="cpu",
                                     **KW, **kw)
    assert ttdps.to_bytes(t_t, 8) == jtdps.to_bytes(t_j, 8)
    np.testing.assert_array_equal(_bits(rec_t.numpy()), _bits(rec_j))
    # K14's escapes and their reconstruction against the encoder's own
    req, m = tclassic.req_length_median(rp, vr, med, dtype)
    types, recon, vals, count = tk.ts_quantize_plain(
        torch.from_numpy(cur), torch.from_numpy(prev), rp, t_t.intervals,
        t_t.intervals // 2, req, m)
    esc = (types == 0).numpy()
    assert esc[:2].all() and int(count) == esc.sum() == t_j.exact_data_num
    np.testing.assert_array_equal(_bits(vals[:int(count)].numpy()),
                                  _bits(cur[esc]))
    enc = tclassic.ExactEncoder(req, m, cur.dtype.type)
    np.testing.assert_array_equal(_bits(recon.numpy()[esc]),
                                  _bits(enc.add_batch(cur[esc])))
    if name == "equal":
        assert (types[2:] == t_t.intervals // 2).all()
    if name == "all_escape":
        assert esc.all()
    want = jtmp.decompress_1d_ts(t_j, prev, cur.size, dtype)
    got = ttmp.decompress_1d_ts(t_t, torch.from_numpy(prev), cur.size, dtype,
                                device="cpu")
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))


@pytest.mark.parametrize("name", ["drift", "nan_inf", "tile_plus_one"])
def test_plain_k14_matches_xla_step(name):
    """ts_quantize_plain against _ts_device_step_fn (float32, the only
    form the XLA step takes): types, reconstruction (the escapes' too),
    the compact escape values and their count."""
    cur, prev, rp, _ = SMOKE.ts_case(name, np.float32)
    vr, med = _median_range(cur)
    intervals = 1024
    req, m = tclassic.req_length_median(rp, vr, med, np.float32)
    n = cur.size
    k = 1 << max(n - 1, 1).bit_length()
    t_x, rec_x, hist_x, vals_x, _ = jtmp._ts_device_step_fn(n, k)(
        cur, prev, np.float64(rp), np.int32(intervals),
        np.int32(intervals // 2), np.int32(req), np.float32(m))
    types, recon, vals, count = tk.ts_quantize_plain(
        torch.from_numpy(cur), torch.from_numpy(prev), rp, intervals,
        intervals // 2, req, m)
    c = int(count)
    assert c == int(np.asarray(hist_x)[0])
    np.testing.assert_array_equal(types.numpy(),
                                  np.asarray(t_x).astype(np.int32))
    np.testing.assert_array_equal(_bits(recon.numpy()),
                                  _bits(np.asarray(rec_x)))
    np.testing.assert_array_equal(_bits(vals[:c].numpy()),
                                  _bits(np.asarray(vals_x)[:c]))


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_plain_k15_matches_xla_restore(dtype):
    """ts_decode_plain against _ts_decode_fn on a step's types, with the
    escapes from the stream; and one escape too many decodes to NaN and
    is counted."""
    cur, prev, rp, _ = SMOKE.ts_case("nan_inf", dtype)
    vr, med = _median_range(cur)
    t_j, _ = jtmp.compress_1d_ts(cur, prev, rp, vr, med, engine="numpy",
                                 **KW)
    types = tclassic.decode_types(t_j.type_array, cur.size,
                                   torch.device("cpu"))
    vals = tclassic.ExactDecoder(t_j, dtype, raw=False).next_batch(
        t_j.exact_data_num)
    n, m = cur.size, vals.size
    k = 1 << max(m - 1, 1).bit_length()
    pad = np.zeros(k, dtype)
    pad[:m] = vals
    want = jtmp._ts_decode_fn(n, k, np.dtype(dtype).str.lstrip("<>="))(
        types.numpy(), prev, np.int32(t_j.intervals // 2),
        np.float64(t_j.real_precision * 2), pad)
    out, seen = tk.ts_decode_plain(types, torch.from_numpy(prev),
                                   torch.from_numpy(vals),
                                   t_j.intervals // 2,
                                   t_j.real_precision * 2)
    assert int(seen) == m
    np.testing.assert_array_equal(_bits(out.numpy()), _bits(np.asarray(want)))
    out, seen = tk.ts_decode_plain(types, torch.from_numpy(prev),
                                   torch.from_numpy(vals[:-1]),
                                   t_j.intervals // 2,
                                   t_j.real_precision * 2)
    last = np.flatnonzero(types.numpy() == 0)[-1]
    assert int(seen) == m and np.isnan(out[last].item())


def test_decode_refuses_a_wrong_escape_count():
    """A stream that stores one escape fewer than its types call for
    raises (K15's count read once), as classic.decompress_1d does."""
    cur, prev, rp, _ = SMOKE.ts_case("drift", np.float32)
    vr, med = _median_range(cur)
    t, _ = ttmp.compress_1d_ts(cur, prev, rp, vr, med, device="cpu", **KW)
    bad = dataclasses.replace(t, exact_data_num=t.exact_data_num - 1)
    with pytest.raises(ValueError, match="corrupt stream"):
        ttmp.decompress_1d_ts(bad, torch.from_numpy(prev), cur.size,
                              np.float32, device="cpu")


@pytest.mark.parametrize("n,sd", [(5000, 100), (20000, 7), (30, 100),
                                  (300, 1), (301, 2)])
def test_optimizer_matches(n, sd):
    """optimize_intervals_1d_ts from numpy and from tensors (the samples
    gathered where they lie) equals sz_tpu's."""
    rng = np.random.default_rng(n + sd)
    prev = rng.standard_normal(n).astype(np.float32)
    cur = (prev + rng.standard_normal(n) * 0.01).astype(np.float32)
    args = (1e-3, 32768, sd, np.float32(0.99))
    want = jtmp.optimize_intervals_1d_ts(cur, prev, *args)
    assert ttmp.optimize_intervals_1d_ts(cur, prev, *args) == want
    assert ttmp.optimize_intervals_1d_ts(
        torch.from_numpy(cur), torch.from_numpy(prev), *args) == want


# the chains' variables: (id, shape, dtype), ranks 1-4, both dtypes
VARS = [(1, (700,), np.float32), (2, (20, 30), np.float64),
        (5, (6, 7, 8), np.float32), (9, (3, 4, 5, 6), np.float64)]


def _steps(count):
    rng = np.random.default_rng(11)
    base = {vid: rng.standard_normal(shape).astype(dt)
            for vid, shape, dt in VARS}
    for s in range(count):
        step = {}
        for vid, shape, dt in VARS:
            x = base[vid] + dt(0.01 * s) + (
                0.002 * rng.standard_normal(shape)).astype(dt)
            x.reshape(-1)[s::17] += dt(1.5)
            step[vid] = x.astype(dt)
        yield step


def _pair(jcfg, tcfg, snapshot_step=3):
    j, t = (jtmp.TemporalCompressor(snapshot_step),
            ttmp.TemporalCompressor(snapshot_step, device="cpu"))
    for vid, shape, dt in VARS:
        j.register(vid, f"v{vid}", shape, dt, jcfg)
        t.register(vid, f"v{vid}", shape, dt, tcfg)
    return j, t


def _same_history(j, t):
    for vid, _, _ in VARS:
        np.testing.assert_array_equal(_bits(np.asarray(j.vars[vid].hist)),
                                      _bits(t.vars[vid].hist.numpy()))


@pytest.mark.parametrize("tensors", [False, True], ids=["numpy", "tensor"])
@pytest.mark.parametrize("ctype", list(CompressionType),
                         ids=[c.name for c in CompressionType])
def test_chain_matches(ctype, tensors):
    """Four steps of four variables: every frame byte-equal to sz_tpu's and
    every history bit-equal after every step; from numpy input the frames
    are also decoded (as numpy and, on odd steps, as tensors), each
    decode and the decoder's histories bit-equal to sz_tpu's.  (A
    tensor's frames are the same bytes, so their decode is the same.)"""
    jc = JConfig(engine="numpy").with_bound(JMode.ABS, 1e-3)
    tc = SZConfig().with_bound(ErrorBoundMode.ABS, 1e-3)
    jenc, tenc = _pair(jc, tc)
    jdec, tdec = _pair(jc, tc)
    kinds = []
    for s, step in enumerate(_steps(4)):
        frame = jenc.compress_step(step, JType(int(ctype)))
        given = ({k: torch.from_numpy(v) for k, v in step.items()}
                 if tensors else step)
        assert tenc.compress_step(given, ctype) == frame, f"step {s}"
        _same_history(jenc, tenc)
        kinds.append(tenc.vars[1].compress_type)
        if tensors:
            continue
        want = jdec.decompress_step(frame)
        got = tdec.decompress_step(frame, as_tensor=s % 2 == 1)
        for vid, shape, dt in VARS:
            g = got[vid].numpy() if s % 2 else got[vid]
            assert isinstance(g, np.ndarray) and g.shape == shape
            assert g.dtype == dt
            np.testing.assert_array_equal(_bits(g), _bits(want[vid]))
        _same_history(jdec, tdec)
        assert tdec.current_step == jdec.current_step == s + 1
    want = {CompressionType.FORCE_SNAPSHOT: [0] * 4,
            CompressionType.FORCE_TEMPORAL: [0, 1, 1, 1],
            CompressionType.PERIO_TEMPORAL: [0, 1, 1, 0]}[ctype]
    assert kinds == want


def test_chain_skips_unknown_ids():
    """A decoder that registers only some of the variables skips the
    others' payloads."""
    tc = SZConfig().with_bound(ErrorBoundMode.ABS, 1e-3)
    _, enc = _pair(tc, tc)
    dec = ttmp.TemporalCompressor(3, device="cpu")
    dec.register(5, "v5", (6, 7, 8), np.float32, tc)
    for step in _steps(2):
        out = dec.decompress_step(enc.compress_step(step))
        assert list(out) == [5]
        assert np.abs(out[5] - step[5]).max() <= 1e-3


@pytest.mark.parametrize("q", [0, 1024], ids=["optimizer", "fixed"])
def test_pw_rel_as_sz_tpu(q):
    """PW_REL resolves to rp = 0 on a temporal step.  With the optimizer
    sz_tpu raises ValueError (its histogram of 0/0 quotients): so does
    the port.  With fixed intervals it emits a stream in which every
    point escapes, losslessly (req_length 32): the port emits the same
    frames and decodes."""
    jc = JConfig(engine="numpy", quantization_intervals=q).with_bound(
        JMode.PW_REL, 1e-3)
    tc = SZConfig(quantization_intervals=q).with_bound(
        ErrorBoundMode.PW_REL, 1e-3)
    j, t = (jtmp.TemporalCompressor(5),
            ttmp.TemporalCompressor(5, device="cpu"))
    jd, td = (jtmp.TemporalCompressor(5),
              ttmp.TemporalCompressor(5, device="cpu"))
    for c in (j, t, jd, td):
        c.register(0, "v", (4096,), np.float32, jc if c in (j, jd) else tc)
    x = (1 + np.random.default_rng(0).random(4096)).astype(np.float32)
    for s in range(3):
        d = (x + np.float32(0.001) * s).astype(np.float32)
        if q == 0 and s > 0:
            with pytest.raises(ValueError):
                j.compress_step({0: d})
            with pytest.raises(ValueError):
                t.compress_step({0: d})
            return
        frame = j.compress_step({0: d})
        assert t.compress_step({0: d}) == frame
        want = jd.decompress_step(frame)[0]
        np.testing.assert_array_equal(_bits(td.decompress_step(frame)[0]),
                                      _bits(want))
        if s:
            np.testing.assert_array_equal(_bits(want), _bits(d))


def test_ts_goldens():
    """The reference library's ts goldens (gen_ts.c: 4096 float32 points,
    snapshotCmprStep 3): the port's frames equal them after _norm_frame
    (the uninitialized params byte of classic payloads), and it decodes
    the golden frames to their .out bit for bit."""
    cfg = SZConfig().with_bound(ErrorBoundMode.ABS, 1e-4)
    enc = ttmp.TemporalCompressor(snapshot_step=3, device="cpu")
    dec = ttmp.TemporalCompressor(snapshot_step=3, device="cpu")
    for c in (enc, dec):
        c.register(1, "v", (4096,), np.float32, cfg)
    for s in range(5):
        data = np.fromfile(GOLDEN / f"ts_step{s}.in", dtype="<f4")
        golden = (GOLDEN / f"ts_step{s}.sz").read_bytes()
        assert _norm_frame(enc.compress_step({1: data})) == \
            _norm_frame(golden), f"step {s}"
        want = np.fromfile(GOLDEN / f"ts_step{s}.out", dtype="<f4")
        np.testing.assert_array_equal(_bits(dec.decompress_step(golden)[1]),
                                      _bits(want), err_msg=f"step {s}")


def test_tile_matches_the_kernel():
    """temporal_kernel's tiling (THREADS, VEC, QUANTIZE_SLOTS,
    DECODE_SLOTS, the two tiles, GROUP, PLACE_BLOCKS: the scratch's tile
    counts, head(), the model below, and ts_case's tile edges) is
    temporal.cu's; the larger tile is a multiple of the smaller, so
    ts_case's edges are both kernels' tile edges."""
    import re
    src = (pathlib.Path(__file__).resolve().parent.parent / "sz_tpu_torch"
           / "csrc" / "temporal.cu").read_text()
    const = {k: int(v) for k, v in re.findall(
        r"constexpr int (kThreads|kVec|kQuantizeSlots|kDecodeSlots|kGroup"
        r"|kPlaceBlocks) = (\d+);", src)}
    assert "static constexpr int kTile = kThreads * kSlots * kVec;" in src
    assert "using QuantizeTiling = Tiling<kQuantizeSlots>;" in src
    assert "using DecodeTiling = Tiling<kDecodeSlots>;" in src
    assert (tk.THREADS, tk.VEC, tk.QUANTIZE_SLOTS, tk.DECODE_SLOTS,
            tk.GROUP, tk.PLACE_BLOCKS) == (
        const["kThreads"], const["kVec"], const["kQuantizeSlots"],
        const["kDecodeSlots"], const["kGroup"], const["kPlaceBlocks"])
    assert tk.QUANTIZE_TILE == tk.THREADS * tk.QUANTIZE_SLOTS * tk.VEC
    assert tk.DECODE_TILE == tk.THREADS * tk.DECODE_SLOTS * tk.VEC
    assert "lookback" not in src
    small, big = sorted((tk.QUANTIZE_TILE, tk.DECODE_TILE))
    assert big % small == 0
    for name, n in (("tile_minus_one", big - 1), ("tile", big),
                    ("tile_plus_one", big + 1),
                    ("tiles_plus_three", 3 * big + 3)):
        assert len(SMOKE.ts_case(name, np.float32)[0]) == n


# --- a numpy model of the kernels' two passes (temporal.cu) ---------------

WARPS = tk.THREADS // 32


def _addr(offset: int, size: int) -> int:
    """An array's address ``offset`` elements of ``size`` bytes into an
    allocation aligned as torch's caching allocator aligns (512 bytes)."""
    return 512 * 97 + offset * size


def _pass_a(esc: np.ndarray, h: int, slots: int) -> tuple:
    """Pass A's index arithmetic on the escape mask ``esc``, ``slots``
    slots a thread, slots from point h - VEC (h > 0) or 0: (the points in
    staging order, a staging slot a point, -1 where none is staged; the
    tile counts).  Every rank is as the kernel forms it: the
    step-and-warp counts' exclusive scan in (step, warp) order, a warp's
    lanes' exclusive scan of their step's escapes, and the point's place
    in its slot."""
    tile = tk.THREADS * slots * tk.VEC
    n, lead = esc.size, (tk.VEC - h) % tk.VEC
    ntiles = tk.tiles(n, h, tile)
    pts = (np.arange(ntiles * tile) - lead).reshape(
        ntiles, slots, tk.THREADS, tk.VEC)
    inside = (pts >= 0) & (pts < n)
    e = np.zeros(pts.shape, bool)
    e[inside] = esc[pts[inside]]
    c = e.sum(-1)                                    # (tile, step, thread)
    per_warp = c.reshape(ntiles, slots * WARPS, 32)
    flat = per_warp.sum(-1)                          # (tile, step * warp)
    s_off = np.cumsum(flat, 1) - flat
    lane = (np.cumsum(per_warp, -1) - per_warp).reshape(c.shape)
    rank = (np.repeat(s_off, 32, 1).reshape(c.shape) + lane)[..., None] \
        + np.cumsum(e, -1) - e
    counts = flat.sum(1).astype(np.int32)
    first = np.maximum(np.arange(ntiles) * tile - lead, 0)
    where = (first[:, None, None, None] + rank)[e]
    ends = np.minimum(np.arange(1, ntiles + 1) * tile - lead, n)
    tile = np.broadcast_to(np.arange(ntiles)[:, None, None, None], e.shape)[e]
    # a tile stages inside its own points, so tiles never overlap
    assert (where >= first[tile]).all() and (where < ends[tile]).all()
    stage = np.full(n, -1, np.int64)
    stage[where] = pts[e]
    assert np.unique(where).size == where.size
    return stage, counts


def _pass_b(counts: np.ndarray) -> tuple:
    """Pass B's blocks, groups and sums over the tile counts: (for each
    tile, the rank in the field of its first escape; the count the last
    block writes).  Each block sums the counts before its first tile
    itself, from a multiple of 4 (whole int4 loads)."""
    ntiles = counts.size
    groups = -(-ntiles // tk.GROUP)
    per = -(-groups // tk.PLACE_BLOCKS)
    blocks = -(-groups // per)
    assert blocks <= tk.PLACE_BLOCKS
    dst = np.full(ntiles, -1, np.int64)
    count = None
    for b in range(blocks):
        g0 = b * per * tk.GROUP
        g1 = min(g0 + per * tk.GROUP, ntiles)
        assert g0 % 4 == 0 and g0 < g1
        base = int(counts[:g0].astype(np.int64).sum())
        for t0 in range(g0, g1, tk.GROUP):
            c = counts[t0:min(t0 + tk.GROUP, g1)].astype(np.int64)
            dst[t0:t0 + c.size] = base + np.cumsum(c) - c
            base += int(c.sum())
        if g1 == ntiles:
            count = base
    return dst, count


def _placed(esc: np.ndarray, h: int, slots: int) -> tuple:
    """Both passes, ``slots`` slots a thread: (the points in the order
    pass B places the escapes, the count)."""
    stage, counts = _pass_a(esc, h, slots)
    lead = (tk.VEC - h) % tk.VEC
    dst, count = _pass_b(counts)
    order = np.full(count, -1, np.int64)
    for t, c in enumerate(counts):
        first = max(t * tk.THREADS * slots * tk.VEC - lead, 0)
        order[dst[t]:dst[t] + c] = stage[first:first + c]
    return order, count


# element offsets of (cur, prev) for K14 and (types, prev) for K15, the
# outputs at offset 0 (the wrapper's torch.empty)
OFFSETS = [(0, 0), (1, 0), (0, 3), (1, 1), (2, 1)]


def _heads(size: int, offsets) -> tuple:
    """(K14's head, K15's head) for inputs at ``offsets``."""
    a, b = offsets
    q = tk.head([(_addr(a, size), size), (_addr(b, size), size),
                 (_addr(0, 4), 4), (_addr(0, size), size)])
    d = tk.head([(_addr(a, 4), 4), (_addr(b, size), size),
                 (_addr(0, size), size)])
    return q, d


@pytest.mark.parametrize("offsets", OFFSETS, ids=str)
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("name", SMOKE.TS_CASE_NAMES)
def test_pass_model_matches_plain(name, dtype, offsets):
    """The model of the two passes, on the escapes of ts_quantize_plain,
    places K14's escape values and K15's escapes as the plain versions
    do, bit for bit, with their counts (K15 also with one escape too
    few: NaN at the last escape), at every head the inputs' offsets
    give."""
    cur, prev, rp, kw = SMOKE.ts_case(name, dtype)
    vr, med = _median_range(cur)
    intervals = kw.get("fixed_intervals", 1024)
    req, m = tclassic.req_length_median(rp, vr, med, dtype)
    types, recon, vals, count = tk.ts_quantize_plain(
        torch.from_numpy(cur), torch.from_numpy(prev), rp, intervals,
        intervals // 2, req, m)
    esc = (types == 0).numpy()
    hq, hd = _heads(np.dtype(dtype).itemsize, offsets)
    order, c = _placed(esc, hq, tk.QUANTIZE_SLOTS)
    assert c == int(count) == esc.sum()
    np.testing.assert_array_equal(_bits(cur[order]),
                                  _bits(vals[:c].numpy()))
    dvals = recon.numpy()[esc]
    order, c = _placed(esc, hd, tk.DECODE_SLOTS)
    for given in (dvals, dvals[:-1]):
        out, seen = tk.ts_decode_plain(types, torch.from_numpy(prev),
                                       torch.from_numpy(given),
                                       intervals // 2, 2 * rp)
        model = out.numpy().copy()
        model[order] = np.concatenate([given, [np.nan] * (c - given.size)]
                                      ).astype(dtype)
        assert int(seen) == c
        np.testing.assert_array_equal(_bits(out.numpy()), _bits(model))
    np.testing.assert_array_equal(_bits(model[order[:-1]]),
                                  _bits(recon.numpy()[order[:-1]]))


EDGES = ["tile_minus_one", "tile", "tile_plus_one", "tiles_plus_three",
         "all_escape"]


@pytest.mark.parametrize("offsets", [(0, 0), (1, 1)], ids=str)
@pytest.mark.parametrize("name", EDGES)
def test_pass_model_matches_xla(name, offsets):
    """The model of the two passes against sz_tpu's XLA step and restore
    (_ts_device_step_fn on float32, _ts_decode_fn in both dtypes) at the
    tile edges and on the all-escape step: K14's compact escape values
    and count, K15's field, exactly."""
    for dtype in (np.float32, np.float64):
        cur, prev, rp, kw = SMOKE.ts_case(name, dtype)
        vr, med = _median_range(cur)
        intervals = kw.get("fixed_intervals", 1024)
        req, m = tclassic.req_length_median(rp, vr, med, dtype)
        n = cur.size
        k = 1 << max(n - 1, 1).bit_length()
        types, recon, _, _ = tk.ts_quantize_plain(
            torch.from_numpy(cur), torch.from_numpy(prev), rp, intervals,
            intervals // 2, req, m)
        esc = (types == 0).numpy()
        hq, hd = _heads(np.dtype(dtype).itemsize, offsets)
        if dtype == np.float32:
            t_x, _, hist_x, vals_x, _ = jtmp._ts_device_step_fn(n, k)(
                cur, prev, np.float64(rp), np.int32(intervals),
                np.int32(intervals // 2), np.int32(req), np.float32(m))
            order, c = _placed(esc, hq, tk.QUANTIZE_SLOTS)
            assert c == int(np.asarray(hist_x)[0])
            np.testing.assert_array_equal(types.numpy(),
                                          np.asarray(t_x).astype(np.int32))
            np.testing.assert_array_equal(_bits(cur[order]),
                                          _bits(np.asarray(vals_x)[:c]))
        dvals = recon.numpy()[esc]
        order, c = _placed(esc, hd, tk.DECODE_SLOTS)
        pad = np.zeros(k, dtype)
        pad[:c] = dvals
        want = np.asarray(jtmp._ts_decode_fn(
            n, k, np.dtype(dtype).str.lstrip("<>="))(
                types.numpy(), prev, np.int32(intervals // 2),
                np.float64(2 * rp), pad))
        model = want.copy()
        model[order] = dvals
        np.testing.assert_array_equal(_bits(model), _bits(want))
        np.testing.assert_array_equal(_bits(want[esc]), _bits(dvals))
        assert (order == np.flatnonzero(esc)).all()


@pytest.mark.parametrize("ntiles", [1, 3, 32, 33, 4 * 32 * 256 + 5,
                                    32 * 256 * 3 + 97])
def test_pass_b_prefix_over_many_blocks(ntiles):
    """Pass B's blocks (several groups a block past GROUP x PLACE_BLOCKS
    tiles) give each tile the exclusive prefix of the tile counts, and
    the count, whatever the counts (none, a whole tile, random)."""
    rng = np.random.default_rng(ntiles)
    for counts in (np.zeros(ntiles, np.int32),
                   np.full(ntiles, tk.DECODE_TILE, np.int32),
                   rng.integers(0, 40, ntiles).astype(np.int32)):
        dst, count = _pass_b(counts)
        c = counts.astype(np.int64)
        np.testing.assert_array_equal(dst, np.cumsum(c) - c)
        assert count == c.sum()


def test_head_aligns_the_most_bytes():
    """head() picks the first point at which the most bytes a point are
    16-byte aligned, the smallest such on a tie; every full slot of an
    array aligned at it is 16-byte aligned."""
    f, d, i = 4, 8, 4
    assert tk.head([(_addr(0, f), f)] * 4) == 0
    # K14 float32 with cur at offset 1: the outputs and prev win
    assert tk.head([(_addr(1, f), f), (_addr(0, f), f), (_addr(0, i), i),
                    (_addr(0, f), f)]) == 0
    # K15 with types and prev at offset 1 outweigh the output
    assert tk.head([(_addr(1, i), i), (_addr(1, f), f),
                    (_addr(0, f), f)]) == 3
    # float64 inputs at offset 1 (16 bytes) against types and recon (12)
    assert tk.head([(_addr(1, d), d), (_addr(1, d), d), (_addr(0, i), i),
                    (_addr(0, d), d)]) == 1
    for size in (4, 8):
        for offsets in OFFSETS:
            for h in _heads(size, offsets):
                lead = (tk.VEC - h) % tk.VEC
                for off, es in ((offsets[0], size), (offsets[1], size),
                                (0, 4), (0, size)):
                    a = _addr(off, es)
                    if (a + es * h) % 16 == 0:
                        starts = np.arange(-lead, 64, tk.VEC)
                        starts = starts[starts >= 0]
                        assert ((a + es * starts) % 16 == 0).all()
