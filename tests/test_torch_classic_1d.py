"""The 1-D fields of the port on the CPU, against sz_tpu: the classic 1-D
codec in float32 and float64 (the host recurrence, its type stream
through the plain K3/K4 and K5-K7), its interval optimizer, 1-D data in
a regression-flagged stream, the 1-D MSST19 codec (PW_REL on float32),
and the reference binary's 1-D goldens.  Tolerance: exact -- equal
bytes, equal bits.
"""

import pathlib

import numpy as np
import pytest
import torch
torch.set_num_threads(1)  # xdist workers share the cores: one thread each

import sz_tpu
from sz_tpu.config import ErrorBoundMode, SZConfig
from sz_tpu.core import classic as jclassic
from sz_tpu.format import lossless as jll
from sz_tpu.format import tdps as jtdps

import sz_tpu_torch
from sz_tpu_torch import config as tcfg
from sz_tpu_torch.core import classic as tclassic
from sz_tpu_torch.format import tdps as ttdps

GOLDEN = pathlib.Path(__file__).parent / "golden"
KW = dict(max_range_radius=32768, sample_distance=100,
          pred_threshold=np.float32(0.99))


def _series(n, dtype, seed, noise=0.05):
    """A random walk with a sine on it: a particle-coordinate-like 1-D
    series."""
    rng = np.random.default_rng(seed)
    t = np.linspace(0, 40, n)
    return (np.sin(t) + noise * np.cumsum(rng.standard_normal(n))
            ).astype(dtype)


def _bits(a):
    a = np.ascontiguousarray(a)
    return a.view(np.uint32 if a.dtype == np.float32 else np.uint64)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("rp", [1e-2, 1e-4, 1e-7])
def test_compress_1d_matches(dtype, rp):
    """The TDPS, and its decode, from the same series and bound; 1e-7
    escapes most values (float32 past req_length's clamp)."""
    x = _series(20000, dtype, 7)
    vr = dtype(x.max() - x.min())
    med = dtype(x.min() + vr / 2)
    t_j = jclassic.compress_1d(x, rp, vr, med, **KW)
    t_t = tclassic.compress_1d(x, rp, vr, med, device="cpu", **KW)
    assert ttdps.to_bytes(t_t, 8) == jtdps.to_bytes(t_j, 8)
    want = jclassic.decompress_1d(t_j, x.size, dtype)
    got = tclassic.decompress_1d(t_t, x.size, dtype, device="cpu")
    np.testing.assert_array_equal(_bits(got), _bits(want))


@pytest.mark.parametrize("n,sd", [(5000, 100), (20000, 7), (30, 100)])
def test_optimize_intervals_1d_matches(n, sd):
    x = _series(n, np.float32, 11, noise=0.3)
    for rp in (1e-1, 1e-3, 1e-5):
        assert tclassic.optimize_intervals_1d(x, rp, 32768, sd,
                                              np.float32(0.99)) == \
            jclassic.optimize_intervals_1d(x, rp, 32768, sd,
                                           np.float32(0.99))


def _cfgs(mode, value, **extra):
    return (SZConfig(engine="numpy", **extra).with_bound(
        getattr(ErrorBoundMode, mode), value),
            tcfg.SZConfig(**extra).with_bound(
        getattr(tcfg.ErrorBoundMode, mode), value))


@pytest.mark.parametrize("dtype,mode,value,extra", [
    (np.float32, "ABS", 1e-3, {}),
    (np.float64, "ABS", 1e-6, {}),
    (np.float32, "REL", 1e-4, dict(with_regression=False)),
    (np.float64, "NORM", 1e-2, {}),
    (np.float32, "PSNR", 70.0, dict(quantization_intervals=256)),
    (np.float32, "PW_REL", 1e-3, {}),
    (np.float32, "PW_REL", 1e-2, dict(quantization_intervals=1024)),
], ids=["f32_abs", "f64_abs", "f32_rel_classic", "f64_norm",
        "f32_psnr_fixed_intervals", "f32_pw_rel_msst19",
        "f32_pw_rel_msst19_fixed_intervals"])
def test_api_matches_sz_tpu(dtype, mode, value, extra):
    """Rank 1 takes the classic codec whatever with_regression says, and
    PW_REL on float32 the 1-D MSST19 codec; size-1 axes drop first."""
    x = _series(12000, dtype, 3)
    if mode == "PW_REL":
        x[::9] = 0
    jc, tc = _cfgs(mode, value, **extra)
    for shape in ((12000,), (1, 12000, 1)):
        xs = x.reshape(shape)
        blob = sz_tpu.compress(xs, jc)
        assert sz_tpu_torch.compress(xs, tc, device="cpu") == blob
        want = sz_tpu.decompress(blob, shape, dtype, engine="numpy")
        got = sz_tpu_torch.decompress(blob, shape, dtype, device="cpu")
        assert got.shape == shape
        np.testing.assert_array_equal(_bits(got), _bits(want))


def test_1d_data_in_a_regression_flagged_stream():
    """A 1-D field's body under a header with the regression flag set
    still decodes as classic 1-D (sz_tpu/api.py:540-548)."""
    x = _series(6000, np.float32, 5)
    jc, _ = _cfgs("ABS", 1e-3)
    inner = bytearray(jll.decompress(sz_tpu.compress(x, jc),
                                     expected_size=x.nbytes * 2 + 64))
    inner[3] |= 0x80      # the header's regression flag (metadata.py)
    blob = bytes(inner)
    want = sz_tpu.decompress(blob, x.shape, np.float32, engine="numpy")
    got = sz_tpu_torch.decompress(blob, x.shape, np.float32, device="cpu")
    np.testing.assert_array_equal(_bits(got), _bits(want))


GOLDENS = [("f32_1d_abs1e-4", np.float32), ("f64_1d_abs1e-4", np.float64),
           ("f32_1d_pwrel1e-3", np.float32)]


@pytest.mark.parametrize("name,dtype", GOLDENS, ids=[g[0] for g in GOLDENS])
def test_1d_goldens_decode_bit_equal(name, dtype):
    blob = (GOLDEN / f"{name}.sz").read_bytes()
    want = np.fromfile(GOLDEN / f"{name}.out", dtype=dtype)
    got = sz_tpu_torch.decompress(blob, (8192,), dtype, device="cpu")
    np.testing.assert_array_equal(_bits(got), _bits(want))
