"""Pre-log PW_REL in the port on the CPU, against sz_tpu: the host log2
transform, zero flush and sign bitmap around the classic codec (1-D on
the host, ranks 2-4 through the plain K10/K11), for float32 and float64,
with accelerate_pw_rel off and under ratios below 1e-5 (which the
reference routes to pre-log); the reference binary's pre-log and signed
PW_REL goldens.  Tolerance: exact -- equal bytes, equal bits.
"""

import pathlib

import numpy as np
import pytest
import torch
torch.set_num_threads(1)  # xdist workers share the cores: one thread each

import sz_tpu
from sz_tpu.config import ErrorBoundMode, SZConfig
from sz_tpu.core import pwr as jpwr
from sz_tpu.format import tdps as jtdps

import sz_tpu_torch
from sz_tpu_torch import config as tcfg
from sz_tpu_torch.core import pwr as tpwr
from sz_tpu_torch.format import tdps as ttdps

GOLDEN = pathlib.Path(__file__).parent / "golden"
KW = dict(max_range_radius=32768, sample_distance=100,
          pred_threshold=np.float32(0.99))


def _signed(shape, dtype, seed):
    """A signed smooth field over several decades, with exact zeros."""
    rng = np.random.default_rng(seed)
    grids = np.meshgrid(*[np.linspace(0, 5, s) for s in shape],
                        indexing="ij")
    x = np.sin(sum(grids)) * np.exp(grids[0] - 2)
    x = x + 0.01 * rng.standard_normal(shape)
    x.reshape(-1)[rng.random(x.size) < 0.03] = 0
    return x.astype(dtype)


def _bits(a):
    a = np.ascontiguousarray(a)
    return a.view(np.uint32 if a.dtype == np.float32 else np.uint64)


@pytest.mark.parametrize("shape", [(9000,), (60, 70), (14, 15, 16)],
                         ids=["1d", "2d", "3d"])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_compress_prelog_matches(shape, dtype):
    x = _signed(shape, dtype, 2)
    T = dtype
    fmin = T(x.min())
    fmax = T(fmin + T(T(x.max()) - fmin))
    t_j = jpwr.compress_prelog(x, 1e-3, fmin, fmax, **KW)
    t_t = tpwr.compress_prelog(x, 1e-3, fmin, fmax, device="cpu", **KW)
    assert ttdps.to_bytes(t_t, 8) == jtdps.to_bytes(t_j, 8)
    want = jpwr.decompress_pwrel(t_j, shape, dtype)
    got = tpwr.decompress_prelog(t_t, shape, dtype, device="cpu")
    np.testing.assert_array_equal(_bits(got), _bits(want))


def _cfgs(ratio, **extra):
    return (SZConfig(engine="numpy", **extra).with_bound(
        ErrorBoundMode.PW_REL, ratio),
            tcfg.SZConfig(**extra).with_bound(tcfg.ErrorBoundMode.PW_REL,
                                              ratio))


@pytest.mark.parametrize("shape,dtype,ratio,extra", [
    ((9000,), np.float32, 1e-3, dict(accelerate_pw_rel=False)),
    ((9000,), np.float64, 1e-2, dict(accelerate_pw_rel=False)),
    ((50, 60), np.float32, 1e-6, {}),
    ((50, 60), np.float64, 1e-3, dict(accelerate_pw_rel=False)),
    ((12, 14, 16), np.float32, 1e-3, dict(accelerate_pw_rel=False)),
    ((12, 14, 16), np.float64, 1e-6, {}),
    ((3, 4, 10, 12), np.float32, 1e-6, {}),
    ((3, 4, 10, 12), np.float64, 1e-3, dict(accelerate_pw_rel=False)),
    ((12, 14, 16), np.float32, 1e-3, dict(accelerate_pw_rel=False,
                                          quantization_intervals=512)),
], ids=["f32_1d", "f64_1d", "f32_2d_1e-6", "f64_2d", "f32_3d",
        "f64_3d_1e-6", "f32_4d_1e-6", "f64_4d", "f32_3d_fixed_intervals"])
def test_api_matches_sz_tpu(shape, dtype, ratio, extra):
    """Signed data with zeros (the sign bitmap, the zero flush); a 4-D
    field folds to 3-D; positive data has no bitmap."""
    x = _signed(shape, dtype, 4)
    jc, tc = _cfgs(ratio, **extra)
    for data in (x, np.abs(x) + dtype(0.5)):
        blob = sz_tpu.compress(data, jc)
        assert sz_tpu_torch.compress(data, tc, device="cpu") == blob
        want = sz_tpu.decompress(blob, shape, dtype, engine="numpy")
        got = sz_tpu_torch.decompress(blob, shape, dtype, device="cpu")
        np.testing.assert_array_equal(_bits(got), _bits(want))


def test_v_log2_and_v_exp2_are_glibc():
    """The host runtime's per-element log2/exp2 against sz_tpu's (the
    same glibc calls), on the values where numpy's SIMD forms can differ
    in the last ulp."""
    from sz_tpu import native as jnative
    from sz_tpu_torch import native as tnative
    rng = np.random.default_rng(5)
    v = np.abs(rng.standard_normal(50000)) * 10.0 ** rng.uniform(
        -30, 30, 50000)
    np.testing.assert_array_equal(tnative.v_log2(v).view(np.uint64),
                                  jnative.v_log2(v).view(np.uint64))
    e = rng.uniform(-1070, 1020, 50000)
    np.testing.assert_array_equal(tnative.v_exp2(e).view(np.uint64),
                                  jnative.v_exp2(e).view(np.uint64))


PW_GOLDENS = [("pl_f32_1d_pwrel1e-3", (8192,)),
              ("sg_f32_1d_pwrel1e-3", (4096,))]


@pytest.mark.parametrize("name,shape", PW_GOLDENS,
                         ids=[g[0] for g in PW_GOLDENS])
def test_pwrel_1d_goldens_decode_bit_equal(name, shape):
    """The reference binary's pre-log stream and its signed MSST19
    stream (zeros and a sign bitmap), decoded."""
    blob = (GOLDEN / f"{name}.sz").read_bytes()
    want = np.fromfile(GOLDEN / f"{name}.out", dtype="<f4")
    got = sz_tpu_torch.decompress(blob, shape, np.float32, device="cpu")
    np.testing.assert_array_equal(_bits(got), _bits(want))


def test_synth_signed_compresses_as_sz_tpu():
    """synth_signed.dat (the signed golden's input) under PW_REL 1e-3:
    the port's stream is sz_tpu's, byte for byte, and it decodes as the
    reference's own decode of its stream."""
    x = np.fromfile(GOLDEN / "synth_signed.dat", dtype="<f4")
    jc, tc = _cfgs(1e-3)
    blob = sz_tpu_torch.compress(x, tc, device="cpu")
    assert blob == sz_tpu.compress(x, jc)
    got = sz_tpu_torch.decompress(blob, x.shape, np.float32, device="cpu")
    want = np.fromfile(GOLDEN / "sg_f32_1d_pwrel1e-3.out", dtype="<f4")
    np.testing.assert_array_equal(_bits(got), _bits(want))
