"""The classic SZ1.4 codec of the port on 2-D, 3-D and 4-D fields, on the
CPU, against sz_tpu: the plain K10/K11 against the JAX engine's XLA
recurrences (classic_engine._encode_fn / _decode_fn: types, histogram,
escapes, reconstruction) in all three numeric forms and on the
degenerate shapes, the host front end against classic_nd's, the engine
against compress_nd / decompress_nd (engine="numpy"), the API against
sz_tpu.compress / decompress, and the reference binary's classic
goldens.  Tolerance: exact -- equal bytes, equal bits.
"""

import pathlib
import re

import numpy as np
import pytest
import torch
torch.set_num_threads(1)  # xdist workers share the cores: one thread each

import jax.numpy as jnp

import sz_tpu
from sz_tpu.config import ErrorBoundMode, SZConfig
from sz_tpu.core import classic_nd as jcn
from sz_tpu.format import tdps as jtdps
from sz_tpu.tpu import classic_engine as jce

import sz_tpu_torch
from sz_tpu_torch import config as tcfg
from sz_tpu_torch.core import classic_nd as tcn
from sz_tpu_torch.format import tdps as ttdps
from sz_tpu_torch.gpu import classic_engine as tce
from sz_tpu_torch.gpu import classic_kernel as ck
from sz_tpu_torch.gpu import strips
from sz_tpu_torch.gpu import hist_kernel

GOLDEN = pathlib.Path(__file__).parent / "golden"
KW = dict(max_range_radius=32768, sample_distance=100,
          pred_threshold=np.float32(0.99))


def _field(shape, dtype, seed=0, noise=0.1):
    """tests/test_classic_engine.py's field: a smooth product of sines
    and cosines plus seeded normal noise."""
    rng = np.random.default_rng(seed)
    grids = np.meshgrid(*[np.linspace(0, 6, s) for s in shape],
                        indexing="ij")
    d = np.sin(grids[0] * 2)
    for g in grids[1:]:
        d = d * np.cos(g)
    return (d + noise * rng.standard_normal(shape)).astype(dtype)


def _bits(a):
    a = np.ascontiguousarray(a)
    return a.view(np.uint32 if a.dtype == np.float32 else np.uint64)


def _setup(d, rp):
    vr = d.dtype.type(d.max() - d.min())
    med = d.dtype.type(d.min() + vr / 2)
    return vr, med, tcn.params(d, rp, vr, med, **KW)


# (shape, dtype, rp, noise): tests/test_classic_engine.py's cases, its
# degenerate shapes and escape-heavy case, and 4-D shapes
CASES = [
    ((20, 24, 18), np.float32, 1e-3, 0.1),
    ((40, 52), np.float32, 1e-3, 0.1),
    ((5, 9, 12, 10), np.float32, 1e-4, 0.1),
    ((14, 16, 12), np.float64, 1e-5, 0.1),
    ((3, 2, 2, 2), np.float64, 1e-4, 0.1),
    ((1, 5, 7), np.float32, 1e-3, 0.3),
    ((5, 1, 7), np.float32, 1e-3, 0.3),
    ((5, 7, 1), np.float32, 1e-3, 0.3),
    ((2, 65), np.float32, 1e-3, 0.3),
    ((6, 2, 2), np.float32, 1e-3, 0.3),
    ((30, 40, 20), np.float32, 1e-9, 1.0),
]
IDS = ["f32_3d", "f32_2d", "f32_4d", "f64_3d", "f64_4d", "1x5x7", "5x1x7",
       "5x7x1", "2x65", "6x2x2", "escape_heavy"]


@pytest.mark.parametrize("shape,dtype,rp,noise", CASES, ids=IDS)
def test_plain_k10_k11_match_the_xla_recurrences(shape, dtype, rp, noise):
    """The plain K10 gives _encode_fn's types, histogram and raster-order
    escapes; the plain K11 gives _decode_fn's reconstruction from those
    types and the escapes' stored values, which is also K10's."""
    d = _field(shape, dtype, noise=noise)
    _, _, p = _setup(d, rp)
    T = dtype
    dstr = np.dtype(T).str.lstrip("<>=")
    vshape = jce._vshape(shape)
    ts, hist, esc, _ = jce._encode_fn(vshape, dstr, p.form.dbl, "cpu")(
        jnp.asarray(d), T(p.rp), np.float64(p.rp), np.float64(p.recip),
        jnp.asarray(p.intervals, jnp.int32), jnp.asarray(p.radius,
                                                         jnp.int32),
        jnp.asarray(p.req_length, jnp.int32), T(p.median))
    types, rec = ck.classic_quantize(torch.from_numpy(d), p.rp, p.recip,
                                     p.intervals, p.radius, p.median,
                                     p.req_length)
    t = types.numpy().reshape(-1)
    np.testing.assert_array_equal(t, np.asarray(ts).astype(np.int32))
    np.testing.assert_array_equal(
        hist_kernel.histogram(types.reshape(-1)).numpy(), np.asarray(hist))
    n_esc = int((t == 0).sum())
    if n_esc > jce.ESC_K:   # the engine's second gather
        esc = jce._escapes_fn(d.size, jce.eng._pad_pow2(n_esc), "cpu")(
            ts, jnp.asarray(d.reshape(-1)))
    esc_t = d.reshape(-1)[t == 0]
    np.testing.assert_array_equal(_bits(esc_t),
                                  _bits(np.asarray(esc)[:n_esc]))
    # the decode: the escapes' reconstructions stored, the rest from types
    stored = rec.numpy().reshape(-1)[t == 0]
    pad = np.zeros(max(n_esc, 1), T)
    pad[:n_esc] = stored
    want, _ = jce._decode_fn(vshape, dstr, p.form.dbl, "cpu")(
        jnp.asarray(t.astype(np.uint16)), jnp.asarray(pad), T(p.rp),
        np.float64(p.rp), jnp.asarray(p.radius, jnp.int32))
    got = ck.classic_decode(types, torch.from_numpy(stored), p.rp,
                            p.radius).numpy()
    np.testing.assert_array_equal(_bits(got).reshape(-1),
                                  _bits(np.asarray(want)))
    np.testing.assert_array_equal(_bits(got), _bits(rec.numpy()))


@pytest.mark.parametrize("shape,dtype,rp,noise", CASES[:5], ids=IDS[:5])
def test_front_end_matches_compress_nd(shape, dtype, rp, noise):
    """The optimizer (2-D and 3-D sampling walks, the 4-D modular grid
    with its index - r3 quirk), the numeric form, req_length and the
    median as compress_nd sets them, read back from its TDPS."""
    d = _field(shape, dtype, noise=noise)
    vr, med, p = _setup(d, rp)
    t = jcn.compress_nd(d, rp, vr, med, **KW)
    assert p.intervals == t.intervals == jcn._optimize_intervals_nd(
        d, rp, 32768, 100, np.float32(0.99))
    assert p.req_length == t.req_length
    assert float(p.median) == t.median_value
    assert float(p.rp) == t.real_precision
    assert p.form.dbl == (dtype is np.float64 or d.ndim == 4)


@pytest.mark.parametrize("shape,sd", [((7, 9, 11, 13), 5), ((4, 6, 10, 12),
                                                             100),
                                      ((3, 40, 33, 150), 100),
                                      ((2, 2, 2, 2), 3)])
def test_4d_optimizer_grid_matches(shape, sd):
    """The 4-D modular grid, built without a 4-D mesh, against the JAX
    package's optimizer on sample distances that leave 0 to 3 points a
    row."""
    d = _field(shape, np.float32, noise=0.2)
    for rp in (1e-2, 1e-4):
        assert tcn.optimize_intervals(d, rp, 32768, sd, np.float32(0.99)) \
            == jcn._optimize_intervals_nd(d, rp, 32768, sd, np.float32(0.99))


@pytest.mark.parametrize("shape,dtype,rp,noise", CASES, ids=IDS)
def test_engine_matches_compress_nd(shape, dtype, rp, noise):
    d = _field(shape, dtype, noise=noise)
    vr, med, _ = _setup(d, rp)
    t_j = jcn.compress_nd(d, rp, vr, med, **KW)
    t_t = tce.compress(d, rp, vr, med, device="cpu", **KW)
    assert ttdps.to_bytes(t_t, 8) == jtdps.to_bytes(t_j, 8)
    want = jcn.decompress_nd(t_j, shape, dtype)
    got = tce.decompress(t_t, shape, dtype, device="cpu")
    np.testing.assert_array_equal(_bits(got), _bits(want))


def _cfgs(extra, mode, value):
    return (SZConfig(engine="numpy", **extra).with_bound(
        getattr(ErrorBoundMode, mode), value),
            tcfg.SZConfig(**extra).with_bound(
        getattr(tcfg.ErrorBoundMode, mode), value))


@pytest.mark.parametrize("shape,dtype,extra,mode,value", [
    ((24, 20, 16), np.float32, dict(with_regression=False), "ABS", 1e-3),
    ((40, 52), np.float32, dict(with_regression=False), "REL", 1e-4),
    ((5, 9, 12, 10), np.float32, dict(with_regression=False), "ABS", 1e-4),
    ((14, 16, 12), np.float64, dict(with_regression=False), "PSNR", 80.0),
    ((3, 5, 7, 6), np.float64, dict(with_regression=False), "ABS_AND_REL",
     1e-4),
    ((4, 6, 10, 12), np.float32, dict(random_access=True), "ABS", 1e-3),
    ((4, 6, 10, 12), np.float64, dict(random_access=True), "ABS", 1e-5),
    ((1, 24, 1, 20), np.float32, dict(with_regression=False), "ABS", 1e-3),
    ((30, 40, 20), np.float32, dict(with_regression=False), "ABS", 1e-7),
], ids=["f32_3d", "f32_2d_rel", "f32_4d", "f64_3d_psnr", "f64_4d",
        "f32_4d_random_access", "f64_4d_random_access", "size_one_axes",
        "escape_heavy"])
def test_api_matches_sz_tpu(shape, dtype, extra, mode, value):
    d = _field(shape, dtype, seed=3)
    if mode == "ABS" and value == 1e-7:
        d = np.random.default_rng(1).standard_normal(shape).astype(dtype)
    jc, tc = _cfgs(extra, mode, value)
    blob = sz_tpu.compress(d, jc)
    assert sz_tpu_torch.compress(d, tc, device="cpu") == blob
    want = sz_tpu.decompress(blob, shape, dtype, engine="numpy")
    got = sz_tpu_torch.decompress(blob, shape, dtype, device="cpu")
    np.testing.assert_array_equal(_bits(got), _bits(want))


def test_4d_random_access_is_the_folded_classic_stream():
    """4-D with random access compresses the folded 3-D lattice through
    the classic codec (sz_tpu/api.py:350-392): decoded with the folded
    shape it holds the bound, as sz_tpu's; decoded with the 4-D shape it
    takes the 4-D scheme, bit-equal to sz_tpu's (which is past the
    bound)."""
    shape = (4, 16, 16, 16)
    g = np.meshgrid(*[np.linspace(0, 3, s) for s in shape], indexing="ij")
    d = (np.sin(g[0]) * np.cos(g[1]) + g[2] * g[3]).astype(np.float32)
    jc, tc = _cfgs(dict(random_access=True), "ABS", 1e-3)
    blob = sz_tpu_torch.compress(d, tc, device="cpu")
    assert blob == sz_tpu.compress(d, jc)
    folded = (64, 16, 16)
    got = sz_tpu_torch.decompress(blob, folded, np.float32, device="cpu")
    np.testing.assert_array_equal(_bits(got), _bits(sz_tpu.decompress(
        blob, folded, np.float32, engine="numpy")))
    assert np.abs(got.reshape(shape) - d).max() <= 1e-3
    got4 = sz_tpu_torch.decompress(blob, shape, np.float32, device="cpu")
    np.testing.assert_array_equal(_bits(got4), _bits(sz_tpu.decompress(
        blob, shape, np.float32, engine="numpy")))


# the reference binary's classic streams; the float 4-D one is decoded
# against sz_tpu, since the reference's own float 4-D decoder is broken
# (tests/test_golden_classic_nd.py DECODE_GOLDEN)
GOLDENS = [("cl_f32_2d_abs1e-4", (128, 64), np.float32),
           ("cl_f32_3d_abs1e-4", (128, 8, 8), np.float32),
           ("cl_f32_4d_abs1e-4", (16, 8, 8, 8), np.float32),
           ("cl_f64_3d_abs1e-4", (128, 8, 8), np.float64),
           ("cl_f64_4d_rel1e-3", (128, 8, 8, 8), np.float64)]


@pytest.mark.parametrize("name,shape,dtype", GOLDENS,
                         ids=[g[0] for g in GOLDENS])
def test_classic_goldens_decode_bit_equal(name, shape, dtype):
    blob = (GOLDEN / f"{name}.sz").read_bytes()
    got = sz_tpu_torch.decompress(blob, shape, dtype, device="cpu")
    if name == "cl_f32_4d_abs1e-4":
        want = sz_tpu.decompress(blob, shape, dtype, engine="numpy")
    else:
        want = np.fromfile(GOLDEN / f"{name}.out", dtype=dtype).reshape(
            shape)
    np.testing.assert_array_equal(_bits(got), _bits(want))


def test_wrappers_check_their_inputs():
    x = torch.zeros((4, 5, 6))
    with pytest.raises(ValueError, match="rank-2, 3 or 4"):
        ck.classic_quantize(x[0, 0], 1.0, 1.0, 32, 16, 0.0, 20)
    with pytest.raises(ValueError, match="float32 or float64"):
        ck.classic_quantize(x.to(torch.int32), 1.0, 1.0, 32, 16, 0.0, 20)
    with pytest.raises(ValueError, match="shape"):
        ck.classic_decode(torch.zeros((4, 5, 7), dtype=torch.int32), x,
                          1.0, 16)
    with pytest.raises(ValueError, match="int32 types"):
        ck.classic_decode(torch.zeros((4, 5, 7)), x.reshape(-1), 1.0, 16)
    m = torch.empty((4, 5, 6), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        ck.classic_quantize(m, 1.0, 1.0, 32, 16, 0.0, 20)
    with pytest.raises(ValueError, match="unsupported device"):
        ck.classic_decode(torch.empty((4, 5, 6), dtype=torch.int32,
                                      device="meta"), m.reshape(-1), 1.0, 16)


def test_tiles_mirror_classic_cu():
    """classic_kernel's strip constants are those classic.cu compiles
    (with strips.cuh's, which it includes): rows a strip, columns a chunk,
    ring slots, steps between progress marks, warps a block by element
    type, column chunks; and its shared-memory count is strips.cuh's
    shared_bytes."""
    csrc = pathlib.Path(ck.__file__).parent.parent / "csrc"
    assert '#include "strips.cuh"' in (csrc / "classic.cu").read_text()
    src = "\n".join((csrc / f).read_text() for f in ("classic.cu",
                                                     "strips.cuh"))
    got = dict(re.findall(r"constexpr int (k\w+) = (\d+);", src))
    assert {k: int(got[k]) for k in ("kLanes", "kChunk", "kRing")} == dict(
        kLanes=strips.LANES, kChunk=strips.CHUNK, kRing=ck.RING)
    assert "constexpr int kPitch = kRing + 1;" in src
    group = re.search(r"struct Group \{\s*static constexpr int n = "
                      r"kRank == 3 \? (\d+) : (\d+);", src)
    assert {3: int(group[1]), 2: int(group[2])} == strips.GROUP
    warps = re.search(r"struct Warps \{\s*static constexpr int n = "
                      r"sizeof\(V\) == 8 \? (\d+) : (\d+);", src)
    assert (int(warps[1]), int(warps[2])) == (ck.WARPS[torch.float64],
                                              ck.WARPS[torch.float32])
    assert "constexpr int kRingV = (kLanes + 1) * kPitch;" in src
    assert "constexpr int kRingS = kLanes * kPitch;" in src
    assert ("static constexpr int kStageBytes = Ring<kRing>::kRingS * "
            "sizeof(S);") in src
    assert "static constexpr bool kSlotChunks = false;" in src
    # two float blocks an SM (228 KB, 1 KB reserved a block), one double
    for dtype, dec, per_sm in ((torch.float32, False, 2),
                               (torch.float32, True, 2),
                               (torch.float64, False, 1),
                               (torch.float64, True, 1)):
        b = ck.shared_bytes(dtype, dec)
        assert b <= 227 * 1024
        assert per_sm * (b + 1024) <= 228 * 1024 < (per_sm + 1) * (b + 1024)
