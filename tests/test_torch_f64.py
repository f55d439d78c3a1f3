"""The float64 slice of the port on the CPU: each host copy, each
dtype-generic device stage, the plain K1d/K2d, the device optimizer and
the whole codec against their sz_tpu counterparts in float64, and the
reference's float64 golden streams.  Tolerance: exact throughout --
bodies and streams byte-equal, float results compared as bits.
"""

import pathlib

import numpy as np
import pytest
import torch
torch.set_num_threads(1)  # xdist workers share the cores: one thread each

import jax.numpy as jnp

import sz_tpu
from sz_tpu import native as jnative
from sz_tpu.config import ErrorBoundMode, SZConfig
from sz_tpu.core import optimizer as jopt
from sz_tpu.core import regnd as jregnd
from sz_tpu.format import lossless as jll
from sz_tpu.tpu import engine as jeng

import sz_tpu_torch
from sz_tpu_torch import config as tcfg
from sz_tpu_torch import native as tnative
from sz_tpu_torch import state
from sz_tpu_torch.core import optimizer as topt
from sz_tpu_torch.core import regnd as tregnd
from sz_tpu_torch.gpu import engine as teng
from sz_tpu_torch.gpu import geometry as geo
from sz_tpu_torch.gpu import lorenzo_kernel, stages

GOLDEN = pathlib.Path(__file__).parent / "golden"
F64 = np.float64
KW = dict(max_range_radius=32768, sample_distance=100,
          pred_threshold=np.float32(0.99))


def _bits(a):
    return np.asarray(a, F64).view(np.uint64)


def _synth64():
    return np.fromfile(GOLDEN / "synth_f64_64.dat",
                       dtype="<f8").reshape(64, 64, 64)


def _field(shape, seed):
    """Smooth in one half (Lorenzo wins there), a plane plus strong noise
    in the other (regression wins), with bits below float32's."""
    rng = np.random.default_rng(seed)
    grids = np.meshgrid(*[np.arange(r) for r in shape], indexing="ij")
    ax = 0 if len(shape) == 3 else 1
    noisy = grids[ax] >= shape[ax] // 2
    plane = 0.01 * sum((k + 1) * g for k, g in enumerate(grids))
    return np.where(noisy, plane + 0.2 * rng.standard_normal(shape),
                    plane + np.sin(0.2 * sum(grids))) + 1e-9 * rng.random(
        shape)


def _bs(shape):
    return tregnd._spec(len(shape), F64).block_size


SHAPES = [(25, 14, 20), (13, 19, 7), (40, 33), (17, 50)]


# --- host copies ------------------------------------------------------------

def test_seq_sum_and_fold_mean_match_f64():
    v = np.random.default_rng(0).standard_normal(10001) * 1e3
    assert tnative.seq_sum(v) == jnative.seq_sum(v)
    assert isinstance(tnative.seq_sum(v), np.float64)
    assert topt.seq_sum(v, F64) == jopt.seq_sum(v, F64)
    assert topt.fold_mean(v, F64) == jopt.fold_mean(v, F64)
    assert topt.fold_mean(v[:0], F64) == jopt.fold_mean(v[:0], F64)


@pytest.mark.parametrize("use_mean", [False, True])
@pytest.mark.parametrize("rank", [2, 3])
def test_coeff_chain_and_its_decode_match_f64(rank, use_mean):
    rng = np.random.default_rng(rank)
    nc = rank + 1
    coeffs = rng.standard_normal((500, nc)) * np.array([1e-2] * rank + [1])
    coeffs[::17] *= 1e6   # escapes
    use_reg = rng.random(500) < 0.7
    shape = (40, 41, 42)[:rank]
    spec_t, spec_j = tregnd._spec(rank, F64), jregnd._spec(rank, F64)
    dbs_t = [tregnd.B.dim_blocks(r, spec_t.block_size) for r in shape]
    dbs_j = [jregnd.B.dim_blocks(r, spec_j.block_size) for r in shape]
    rp = F64(1e-4)
    a = tregnd.quantize_coeff_chain(coeffs, use_reg, rp, dbs_t, spec_t,
                                    use_mean)
    b = jregnd.quantize_coeff_chain(coeffs, use_reg, rp, dbs_j, spec_j,
                                    use_mean)
    np.testing.assert_array_equal(a[0], b[0])
    assert [np.asarray(u, F64).tobytes() for u in a[1]] == \
        [np.asarray(u, F64).tobytes() for u in b[1]]
    np.testing.assert_array_equal(_bits(a[2]), _bits(b[2]))
    np.testing.assert_array_equal(_bits(a[3]), _bits(b[3]))
    assert a[2].dtype == F64 and sum(len(u) for u in a[1]) > 0
    cradius = np.full(nc, tregnd.COEFF_RADIUS, np.int64)
    ulist = [np.asarray(u, F64) for u in a[1]]
    dec_t = tnative.coeff_chain_decode(a[0], a[3], cradius, ulist)
    dec_j = jnative.coeff_chain_decode(b[0], b[3], cradius, ulist, F64)
    assert dec_t.dtype == F64
    np.testing.assert_array_equal(_bits(dec_t), _bits(dec_j))
    np.testing.assert_array_equal(_bits(dec_t), _bits(a[2]))


# --- device stages in float64 -----------------------------------------------

@pytest.mark.parametrize("shape", SHAPES)
def test_coeff_sums_and_finalize_match_f64(shape):
    data = _field(shape, 1)
    bs = _bs(shape)
    got = stages.coeff_sums(torch.from_numpy(data), bs).numpy()
    ref = np.asarray(jeng._coeff_sums_fn(shape, "float64", bs, "cpu")(data))
    assert got.dtype == F64
    np.testing.assert_array_equal(_bits(got), _bits(ref))
    np.testing.assert_array_equal(
        _bits(stages.finalize_coeffs(got, shape, bs, F64)),
        _bits(jeng._finalize_coeffs(ref, shape, bs, F64)))


@pytest.mark.parametrize("use_mean", [False, True])
@pytest.mark.parametrize("shape", SHAPES)
def test_select_matches_f64(shape, use_mean):
    data = _field(shape, 2)
    bs = _bs(shape)
    sums = stages.coeff_sums(torch.from_numpy(data), bs).numpy()
    coeffs = stages.finalize_coeffs(sums, shape, bs, F64)
    rp = F64(1e-3)
    noise = F64(rp * tregnd._spec(len(shape), F64).noise_factor)
    mean = F64(0.125)
    got = stages.select(torch.from_numpy(data), torch.from_numpy(coeffs),
                        noise, mean, use_mean, bs).numpy()
    ref = np.asarray(jeng._select_fn(shape, "float64", bs, use_mean, "cpu")(
        data, coeffs, noise, mean))
    np.testing.assert_array_equal(got, ref)
    assert 0 < got.sum() < got.size   # both predictors are chosen somewhere


@pytest.mark.parametrize("shape", SHAPES[:1] + SHAPES[2:3])
def test_escapes_and_delattice_match_f64(shape):
    """The escape gather (``_escapes2_fn``) and the decode staging
    (``_delattice3_fn``) in float64."""
    data = _field(shape, 3)
    bs = _bs(shape)
    dbs = geo.geom_small(shape, bs)["dbs"]
    rng = np.random.default_rng(4)
    t = rng.integers(0, 4, shape).astype(np.int32)
    tp = geo.corner_stream(torch.from_numpy(t), dbs)
    got = stages.escape_values(torch.from_numpy(data), tp, dbs).numpy()
    k = int((t == 0).sum())
    kp = jeng._pad_pow2(k)
    ref = np.asarray(jeng._escapes2_fn(shape, "float64", bs, kp, "cpu")(
        data, jnp.asarray(tp.numpy())))[:k]
    assert got.dtype == F64
    np.testing.assert_array_equal(_bits(got), _bits(ref))
    t_lat, unpred_lat = stages.delattice(tp, torch.from_numpy(got), dbs,
                                         shape)
    pad = np.zeros(kp, F64)
    pad[:k] = got
    jt, ju = jeng._delattice3_fn(shape, "float64", bs, kp, 0, "cpu")(
        jnp.asarray(tp.numpy()), jnp.asarray(pad))
    np.testing.assert_array_equal(t_lat.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(_bits(unpred_lat.numpy()),
                                  _bits(np.asarray(ju)))


def _codec_state(data, seed, intervals):
    """A float64 codec state on random blocks: regression coefficients
    near the field's plane on 40 % of the blocks."""
    shape = data.shape
    bs = _bs(shape)
    g = geo.geom_small(shape, bs)
    rng = np.random.default_rng(seed)
    nb, nc = g["nblocks"], len(shape) + 1
    use_reg = rng.random(nb) < 0.4
    lc_full = np.zeros((nb, nc), F64)
    lc_full[use_reg] = rng.standard_normal((int(use_reg.sum()), nc)) * 0.01
    rp = F64(1e-3)
    st = dict(lc_full=lc_full, use_reg=use_reg, loc=g["loc"], rp=rp,
              recip=F64(F64(1) / rp), intervals=intervals,
              mean=F64(data.reshape(-1)[7]))
    return st, bs


@pytest.mark.parametrize("shape,use_mean", [
    ((9, 17, 20), False), ((9, 17, 20), True), ((30, 41), False)])
def test_k1d_k2d_plain_match_the_xla_fixpoints(shape, use_mean):
    """Plain K1d (stages.quantize_inputs + quantize_plain) against
    engine._quantize_fn in float64, and plain K2d (stages.decode_inputs +
    decode_plain) against engine._decode_fn, which must also rebuild the
    encode's reconstruction (2-D runs with use_mean off, as the codec
    forces it, sz_float.c:5615)."""
    data = _field(shape, 5)
    data.reshape(-1)[::11] = data.reshape(-1)[7]   # a dense value cluster
    raw, bs = _codec_state(data, 6, 64)
    st = state.from_numpy_state(device="cpu", **raw)
    assert st.lc_full.dtype == torch.float64 and isinstance(st.rp, F64)
    x = torch.from_numpy(data)
    t_reg, rec_reg, reg_pts, mm = stages.quantize_inputs(x, st, use_mean, bs)
    t, R = lorenzo_kernel.wavefront_quantize(
        x, t_reg, rec_reg, reg_pts, mm, st.rp, st.recip, F64(64 - 2), 32,
        st.mean, use_mean=use_mean, want_R=True)
    iperm = jeng._dev_geom(shape, bs)["iperm"]
    t_stream, hist, _, R_j, _ = jeng._quantize_fn(
        shape, "float64", bs, use_mean, "cpu")(
        data, raw["lc_full"], raw["use_reg"], tuple(raw["loc"]), iperm,
        raw["rp"], raw["recip"], jnp.asarray(64, jnp.int32), raw["mean"])
    np.testing.assert_array_equal(_bits(R.numpy()), _bits(np.asarray(R_j)))
    np.testing.assert_array_equal(
        t.numpy().reshape(-1)[np.asarray(iperm)].astype(np.uint16),
        np.asarray(t_stream))
    assert 0 < int((t == 0).sum()) < t.numel()   # escapes, and not only
    unpred_lat = torch.where(t == 0, x, torch.zeros_like(x))
    km, kv, q = stages.decode_inputs(t, unpred_lat, st, use_mean, bs)
    D = lorenzo_kernel.wavefront_decode(km, kv, q)
    D_j, _ = jeng._decode_fn(shape, "float64", bs, use_mean, "cpu")(
        jnp.asarray(t.numpy()), raw["lc_full"], raw["use_reg"],
        jnp.asarray(unpred_lat.numpy()), tuple(raw["loc"]), raw["rp"],
        jnp.asarray(64, jnp.int32), raw["mean"])
    np.testing.assert_array_equal(_bits(D.numpy()), _bits(np.asarray(D_j)))
    np.testing.assert_array_equal(_bits(D.numpy()), _bits(R.numpy()))


# --- the device optimizer -----------------------------------------------------

OPT_CASES = [
    ("synth_f64_64", _synth64, 1e-3),
    ("ragged_f64", lambda: _field((25, 14, 20), 7), 1e-3),
    ("2d_f64", lambda: _field((150, 130), 8), 1e-4),
    ("synth_f32_64", lambda: np.fromfile(GOLDEN / "synth_f32_64.dat",
                                         dtype="<f4").reshape(64, 64, 64),
     1e-3),
]


@pytest.mark.parametrize("case", OPT_CASES, ids=[c[0] for c in OPT_CASES])
def test_device_optimizer_matches(case):
    _optimizer_case(case)


def _optimizer_case(case) -> bool:
    """The optimizer's gathers on the device (stages.optimizer_samples)
    and the host tail (optimize_from_samples) against
    engine._device_optimizer and engine._device_dense_mean: intervals,
    dense_pos, max_freq, mean_freq, use_mean and the mean all equal; and
    against the host walk, the plain version."""
    _, make, eb = case
    data = make()
    T = data.dtype.type
    shape, rank = data.shape, data.ndim
    x = torch.from_numpy(data)
    samples, nm, ns = stages.optimizer_samples(x, KW["sample_distance"])
    s = samples.numpy()
    got = topt.optimize_from_samples(
        s[:nm], s[nm:nm + ns], s[nm + ns:], eb, KW["max_range_radius"],
        KW["pred_threshold"], T)
    dstr = np.dtype(T).name
    want = jeng._device_optimizer(
        jnp.asarray(data), shape, rank, eb, KW["max_range_radius"],
        KW["sample_distance"], KW["pred_threshold"], T, dstr, "cpu")
    host = (topt.optimize_intervals_3d_freq_dense if rank == 3
            else topt.optimize_intervals_2d_freq_dense)(
        data.reshape(-1), *shape, eb, KW["max_range_radius"],
        KW["sample_distance"], KW["pred_threshold"], T=T)
    for a, b, c in zip(got, want, host):
        assert type(a) is type(b) or isinstance(a, int)
        assert a == b == c
    use_mean = topt.decide_use_mean(got[3], got[2], rank)
    assert use_mean == jopt.decide_use_mean(want[3], want[2], rank)
    if use_mean:
        rp = T(eb)
        mean = stages.dense_mean(x, got[1], rp)
        assert mean == jeng._device_dense_mean(
            jnp.asarray(data), data.size, want[1], rp, T, dstr, "cpu")
        assert isinstance(mean, T)
    return use_mean


def test_device_optimizer_covers_use_mean():
    """synth_f64_64 takes the mean flush, so the dense mean is held
    above on a float64 field."""
    assert _optimizer_case(OPT_CASES[0]) is True


# --- the whole codec ----------------------------------------------------------

MODES = [(ErrorBoundMode.ABS, 1e-3), (ErrorBoundMode.REL, 1e-4),
         (ErrorBoundMode.PSNR, 80.0), (ErrorBoundMode.NORM, 0.05),
         (ErrorBoundMode.ABS_AND_REL, 1e-3)]


@pytest.mark.parametrize("shape", [(40, 37), (16, 18, 20), (3, 5, 12, 13)],
                         ids=["2d", "3d", "4d"])
@pytest.mark.parametrize("mode,value", MODES, ids=[m.name for m, _ in MODES])
def test_api_matches_sz_tpu_f64(shape, mode, value):
    fold = (shape[0] * shape[1],) + shape[2:] if len(shape) == 4 else shape
    data = _field(fold, 21).reshape(shape)
    ref = sz_tpu.compress(data, SZConfig(engine="numpy").with_bound(
        mode, value))
    cfg = tcfg.SZConfig().with_bound(tcfg.ErrorBoundMode(int(mode)), value)
    got = sz_tpu_torch.compress(data, cfg, device="cpu")
    assert got == ref
    out = sz_tpu_torch.decompress(got, data.shape, F64, device="cpu")
    assert out.dtype == F64 and out.shape == data.shape
    np.testing.assert_array_equal(
        _bits(out), _bits(sz_tpu.decompress(ref, data.shape, F64,
                                            engine="numpy")))
    tens = sz_tpu_torch.decompress(got, data.shape, F64, device="cpu",
                                   as_tensor=True)
    assert tens.dtype == torch.float64
    np.testing.assert_array_equal(_bits(tens.numpy()), _bits(out))


def _dense():
    """60 % of the points at one value: the mean flush (use_mean)."""
    rng = np.random.default_rng(5)
    x = _field((20, 22, 24), 5)
    x[rng.random(x.shape) < 0.6] = 0.5
    return x


@pytest.mark.parametrize("case", ["dense_mean", "escapes"])
def test_engine_matches_oracle_and_jax_engine_f64(case):
    """The engine's body against regnd (the numpy oracle) and the JAX
    engine, with the mean flush on and with escapes past the JAX
    engine's inline 4096."""
    if case == "dense_mean":
        data, eb, extra = _dense(), 1e-3, {}
    else:
        data = np.random.default_rng(3).standard_normal((20, 22, 24))
        eb, extra = 1e-5, dict(opt_quant_mode=0, fixed_intervals=16)
    kw = dict(KW, **extra)
    ref = jregnd.compress(data, eb, **kw)
    got = teng.compress(data, eb, device="cpu", **kw)
    assert got.body == ref.body
    assert got.use_mean == (case == "dense_mean")
    assert jeng.compress(data, eb, **kw).body == got.body
    if extra:
        assert ref.total_unpred > jeng.ESC_K
    out = teng.decompress(got.body, data.shape, F64, device="cpu")
    np.testing.assert_array_equal(
        _bits(out), _bits(jregnd.decompress(ref.body, data.shape, F64)))


GOLDENS = [("f64_3d64_abs1e-3", (64, 64, 64)), ("f64_3d_abs1e-4", (128, 8, 8)),
           ("f64_2d_abs1e-4", (128, 64)), ("f64_4d_rel1e-3", (128, 8, 8, 8))]


@pytest.mark.parametrize("name,shape", GOLDENS, ids=[g[0] for g in GOLDENS])
def test_f64_goldens_decode_bit_equal(name, shape):
    want = np.fromfile(GOLDEN / f"{name}.out", dtype="<f8")
    got = sz_tpu_torch.decompress((GOLDEN / f"{name}.sz").read_bytes(),
                                  shape, F64, device="cpu")
    assert got.shape == shape
    np.testing.assert_array_equal(_bits(got).reshape(-1), _bits(want))


def test_synth_f64_64_gives_the_golden_inner_stream():
    x = _synth64()
    cfg = tcfg.SZConfig().with_bound(tcfg.ErrorBoundMode.ABS, 1e-3)
    cap = 2 * x.nbytes + 64
    got = sz_tpu_torch.compress(x, cfg, device="cpu")
    want = (GOLDEN / "f64_3d64_abs1e-3.sz").read_bytes()
    assert jll.decompress(got, expected_size=cap) == \
        jll.decompress(want, expected_size=cap)
