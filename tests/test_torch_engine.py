"""The ported slice end to end on the CPU: sz_tpu_torch's compress and
decompress (Huffman decode through the plain versions of K5-K7) against
the numpy oracle (sz_tpu.core.regnd), the JAX engine (sz_tpu.tpu.engine,
also with its device FSM decode in interpret mode) and the reference
golden stream.  Tolerance: exact -- bodies and streams byte-equal,
reconstructions bit-equal.
"""

import pathlib

import numpy as np
import pytest
import torch
torch.set_num_threads(1)  # xdist workers share the cores: one thread each

import sz_tpu
from sz_tpu.config import ErrorBoundMode, SZConfig
from sz_tpu.core import regnd
from sz_tpu.tpu import engine as jeng

import sz_tpu_torch
from sz_tpu_torch import config as tcfg
from sz_tpu_torch import state
from sz_tpu_torch.gpu import engine as teng
from sz_tpu_torch.gpu import geometry as geo

GOLDEN = pathlib.Path(__file__).parent / "golden"
KW = dict(max_range_radius=32768, sample_distance=100,
          pred_threshold=np.float32(0.99))


def _synth64():
    return np.fromfile(GOLDEN / "synth_f32_64.dat",
                       dtype="<f4").reshape(64, 64, 64)


def _wave(shape, seed):
    rng = np.random.default_rng(seed)
    n = int(np.prod(shape))
    return (np.sin(np.linspace(0, 9, n, dtype=np.float32))
            + 0.05 * rng.standard_normal(n)).astype(np.float32).reshape(shape)


def _escapes():
    """>4096 escapes (test_tpu_engine.test_engine_escape_overflow_path)."""
    rng = np.random.default_rng(3)
    return rng.standard_normal((48, 48, 48)).astype(np.float32)


CASES = [
    ("synth64_mean", _synth64, 1e-3, {}, True),
    ("ragged_25x14x20", lambda: _wave((25, 14, 20), 8), 1e-3, {}, False),
    ("2d_150x130", lambda: _wave((150, 130), 13), 1e-3, {}, True),
    ("escapes_48", _escapes, 1e-5,
     dict(opt_quant_mode=0, fixed_intervals=16), False),
]


def _bits(a):
    return np.asarray(a).view(np.uint32)


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_slice_matches_oracle_and_jax_engine(case):
    _, make, eb, extra, with_jax = case
    data = make()
    kw = dict(KW, **extra)
    ref = regnd.compress(data, eb, **kw)
    got = teng.compress(data, eb, device="cpu", **kw)
    assert got.body == ref.body
    assert (got.use_mean, got.reg_count, got.total_unpred) == (
        ref.use_mean, ref.reg_count, ref.total_unpred)
    out = teng.decompress(got.body, data.shape, np.float32, device="cpu")
    np.testing.assert_array_equal(
        _bits(out), _bits(regnd.decompress(ref.body, data.shape, np.float32)))
    if with_jax:
        assert jeng.compress(data, eb, **kw).body == got.body
        np.testing.assert_array_equal(
            _bits(out),
            _bits(jeng.decompress(got.body, data.shape, np.float32)))
    if extra:
        assert ref.total_unpred > jeng.ESC_K


def test_decompress_matches_jax_device_decode(monkeypatch):
    """The JAX engine with its device FSM decode forced (Pallas kernels
    A-C in interpret mode; the stream clears its 2^16-bit minimum)."""
    data = _wave((24, 25, 26), 24)
    res = regnd.compress(data, 1e-3, **KW)
    assert len(res.body) * 8 > (1 << 16)
    monkeypatch.setenv("SZ_TPU_DEVICE_DECODE", "force")
    want = jeng.decompress(res.body, data.shape, np.float32)
    got = teng.decompress(res.body, data.shape, np.float32, device="cpu")
    np.testing.assert_array_equal(_bits(got), _bits(want))
    np.testing.assert_array_equal(
        _bits(got), _bits(regnd.decompress(res.body, data.shape,
                                           np.float32)))


def test_decodes_reference_golden():
    from sz_tpu_torch.config import DataType
    from sz_tpu_torch.format import lossless as ll
    from sz_tpu_torch.format import metadata as md
    golden_out = np.fromfile(GOLDEN / "f32_3d64_abs1e-3.out", dtype="<f4")
    blob = (GOLDEN / "f32_3d64_abs1e-3.sz").read_bytes()
    inner = ll.decompress(blob, expected_size=golden_out.nbytes * 2 + 64)
    hdr = md.parse_header(inner, DataType.FLOAT)
    off = hdr.body_offset + hdr.size_type
    out = teng.decompress(inner[off:], (64, 64, 64), np.float32,
                          device="cpu")
    np.testing.assert_array_equal(_bits(out).reshape(-1), _bits(golden_out))
    full = sz_tpu_torch.decompress(blob, (64, 64, 64), np.float32,
                                   device="cpu")
    np.testing.assert_array_equal(_bits(full).reshape(-1), _bits(golden_out))


@pytest.mark.parametrize("mode,value", [
    (ErrorBoundMode.ABS, 1e-3),
    (ErrorBoundMode.REL, 1e-4),
    (ErrorBoundMode.ABS_AND_REL, 1e-3),
    (ErrorBoundMode.PSNR, 80.0),
])
def test_api_matches_host_api(mode, value):
    data = _wave((20, 30, 26), 21)
    ref = sz_tpu.compress(data, SZConfig(engine="numpy").with_bound(
        mode, value))
    cfg = tcfg.SZConfig().with_bound(tcfg.ErrorBoundMode(int(mode)), value)
    got = sz_tpu_torch.compress(data, cfg, device="cpu")
    assert got == ref
    out = sz_tpu_torch.decompress(got, data.shape, np.float32, device="cpu")
    np.testing.assert_array_equal(
        _bits(out), _bits(sz_tpu.decompress(ref, data.shape, np.float32,
                                            engine="numpy")))
    tens = sz_tpu_torch.decompress(got, data.shape, np.float32,
                                   device="cpu", as_tensor=True)
    assert isinstance(tens, torch.Tensor) and tens.shape == data.shape
    np.testing.assert_array_equal(_bits(tens.numpy()), _bits(out))


def test_api_framing_paths():
    """Constant fields, 4-D folding and the clamp of protect_value_range
    go through the port's framing, byte-equal to sz_tpu.api's."""
    cfg = SZConfig(engine="numpy").with_bound(ErrorBoundMode.ABS, 1e-3)
    tc = tcfg.SZConfig().with_bound(tcfg.ErrorBoundMode.ABS, 1e-3)
    const = np.full((10, 12, 14), 2.5, np.float32)
    assert sz_tpu_torch.compress(const, tc, device="cpu") == \
        sz_tpu.compress(const, cfg)
    d4 = _wave((3, 7, 12, 13), 22)
    assert sz_tpu_torch.compress(d4, tc, device="cpu") == \
        sz_tpu.compress(d4, cfg)
    cfgp = SZConfig(engine="numpy", protect_value_range=True).with_bound(
        ErrorBoundMode.ABS, 1e-2)
    tcp = tcfg.SZConfig(protect_value_range=True).with_bound(
        tcfg.ErrorBoundMode.ABS, 1e-2)
    d = _wave((16, 18, 20), 23)
    blob = sz_tpu_torch.compress(d, tcp, device="cpu")
    assert blob == sz_tpu.compress(d, cfgp)
    ref = sz_tpu.decompress(blob, d.shape, np.float32, engine="numpy")
    np.testing.assert_array_equal(
        _bits(sz_tpu_torch.decompress(blob, d.shape, device="cpu")),
        _bits(ref))
    np.testing.assert_array_equal(
        _bits(sz_tpu_torch.decompress(blob, d.shape, device="cpu",
                                      as_tensor=True).numpy()), _bits(ref))


def test_from_numpy_state_round_trips():
    from sz_tpu.format import huffman
    rng = np.random.default_rng(31)
    shape = (13, 19, 7)
    g = geo.geom_small(shape, 6)
    lc = rng.standard_normal((g["nblocks"], 4)).astype(np.float32)
    use_reg = rng.random(g["nblocks"]) < 0.5
    freq = np.zeros(256, np.int64)
    freq[:90] = rng.integers(1, 1 << 40, 90)
    tables = huffman.build_tables(None, 128, freq=freq)
    st = state.from_numpy_state(
        lc_full=lc, use_reg=use_reg, loc=g["loc"], rp=1e-3,
        recip=np.float32(1) / np.float32(1e-3), intervals=256,
        mean=np.float32(0.5), device="cpu", tables=tables)
    back = st.to_numpy()
    np.testing.assert_array_equal(back["lc_full"].view(np.uint32),
                                  lc.view(np.uint32))
    np.testing.assert_array_equal(back["use_reg"], use_reg)
    for a, b in zip(back["loc"], g["loc"]):
        np.testing.assert_array_equal(a, b)
    assert (back["rp"], back["intervals"], back["mean"]) == (
        np.float32(1e-3), 256, np.float32(0.5))
    np.testing.assert_array_equal(back["code_hi"], tables.code_hi)
    np.testing.assert_array_equal(back["code_lo"], tables.code_lo)
    np.testing.assert_array_equal(back["code_len"], tables.code_len)


@pytest.mark.parametrize("shape", [(3, 3, 3), (4, 4, 4), (5, 5, 5),
                                   (2, 2, 10), (5, 5), (6, 6)])
def test_empty_optimizer_sample_walk_raises(shape):
    """ROADMAP 3.1: fields past MIN_NUM_OF_ELEMENTS whose optimizer
    sample walk is empty.  The port refuses them before any device work;
    sz_tpu still divides by the zero count (a later fix there shows
    here)."""
    x = _wave(shape, 71)
    with pytest.raises(NotImplementedError,
                       match=r"empty optimizer sample walk.*ROADMAP 3\.1\)"):
        sz_tpu_torch.compress(x, _ABS3, device="cpu")
    with pytest.raises(ZeroDivisionError):
        sz_tpu.compress(x, SZConfig(engine="numpy").with_bound(
            ErrorBoundMode.ABS, 1e-3))


@pytest.mark.parametrize("shape", [(6, 6, 6), (7, 7, 7), (3, 50)])
def test_smallest_sampled_fields_match_sz_tpu(shape):
    """The smallest shapes whose sample walk is not empty still compress
    byte-equal to sz_tpu and decode bit-equal."""
    x = _wave(shape, 73)
    want = sz_tpu.compress(x, SZConfig(engine="numpy").with_bound(
        ErrorBoundMode.ABS, 1e-3))
    got = sz_tpu_torch.compress(x, _ABS3, device="cpu")
    assert got == want
    out = sz_tpu_torch.decompress(got, shape, np.float32, device="cpu")
    np.testing.assert_array_equal(
        out.view(np.uint32),
        sz_tpu.decompress(want, shape, np.float32).view(np.uint32))


_ABS3 = tcfg.SZConfig().with_bound(tcfg.ErrorBoundMode.ABS, 1e-3)
