"""The port's MSST19 PW_REL path on the CPU against sz_tpu.

- the plain K8/K9 (``gpu.msst19_kernel``) against the Pallas T11/T12
  (``sz_tpu.tpu.msst19_kernel``) in interpret mode;
- the port's MSST19 engine against the host codec
  (``sz_tpu.core.pwr.compress_msst19``/``decompress_pwrel``) at the bounds
  1e-2 to 1e-5;
- ``sz_tpu_torch.compress``/``decompress`` against ``sz_tpu``'s (engine
  "numpy"): signed fields, fields with zeros, the 4-D fold, 2-D;
- the reference binary's PW_REL goldens.

Inputs from numpy seeds (``tests.test_msst19_engine.synth``).  Tolerance:
exact -- equal bytes, equal bits.  The JAX engine comparison is in
``test_torch_msst19_jax.py``.
"""

import pathlib

import numpy as np
import pytest
import torch
torch.set_num_threads(1)  # xdist workers share the cores: one thread each

import jax.numpy as jnp

import sz_tpu
from sz_tpu.config import ErrorBoundMode as JMode
from sz_tpu.config import SZConfig as JConfig
from sz_tpu.core import pwr as jpwr
from sz_tpu.format import tdps as jtdps
from sz_tpu.tpu import msst19_kernel as pallas

import sz_tpu_torch
from sz_tpu_torch.config import DataType, ErrorBoundMode, SZConfig
from sz_tpu_torch.core import pwr
from sz_tpu_torch.format import tdps as ttdps
from sz_tpu_torch.gpu import msst19_engine, msst19_kernel

from tests.test_msst19_engine import KW, synth

GOLDEN = pathlib.Path(__file__).resolve().parent / "golden"

# the shapes of tests/test_msst19_soft.py::test_kernel_forced_parity
KERNEL_CASES = [((9, 11, 13), 5, False), ((14, 10, 12), 7, True),
                ((4, 3, 3), 9, False), ((26, 31), 11, False),
                ((18, 23), 13, True)]


def _kernel_inputs(shape, seed, signed, ratio=1e-3):
    data = synth(shape, np.float32, seed=seed, signed=signed)
    data[data == 0] = np.float32(0.5)
    iv = pwr._optimize_intervals_msst19(data, ratio, 32768, 100,
                                        np.float32(0.99))
    if pallas.kernel_tables(iv, ratio, 3) is None:
        iv = 4096     # past T11/T12's envelope (a tiny field's optimizer
        #               picks 65536): compare at the largest table they take
    cache = pwr._cache_table(iv, ratio, 3)
    rl = msst19_engine.req_length(ratio, len(shape))
    tables = (torch.from_numpy(cache.table.reshape(-1).view(np.int16)),
              torch.from_numpy(pwr._precision_table(iv, ratio, 3)),
              cache.base_index, cache.top_index, cache.bits, max(32 - rl, 0))
    return data, (iv, ratio, 3), rl, tables


def _plain(shape):
    if len(shape) == 3:
        return msst19_kernel.wavefront3d_encode, msst19_kernel.wavefront3d_decode
    return msst19_kernel.lines2d_encode, msst19_kernel.lines2d_decode


@pytest.mark.parametrize("shape,seed,signed", KERNEL_CASES)
def test_plain_encode_matches_pallas(shape, seed, signed):
    data, key, rl, tables = _kernel_inputs(shape, seed, signed)
    flat = jnp.asarray(data.reshape(-1))
    if len(shape) == 3:
        want = pallas.encode(flat, shape, key, rl, "cpu")
    else:
        want = pallas.encode2d(flat, shape, key, rl, "cpu")
    types, _ = _plain(shape)[0](torch.from_numpy(data), *tables)
    np.testing.assert_array_equal(types.numpy().reshape(-1),
                                  np.asarray(want))
    assert (types == 0).any() and (types != 0).any()


@pytest.mark.parametrize("shape,seed,signed", KERNEL_CASES)
def test_plain_decode_matches_pallas(shape, seed, signed):
    """Decode of the encode's types, with the escapes' stored values (the
    signed data truncated to req_length bits) in place."""
    data, key, rl, tables = _kernel_inputs(shape, seed, signed)
    encode, decode = _plain(shape)
    x = torch.from_numpy(data)
    types, rec = encode(x, *tables)
    mask = msst19_kernel._mask_i32(tables[-1])
    known = torch.where(types == 0, (x.view(torch.int32) & mask).view(
        torch.float32), torch.zeros_like(x))
    kv = jnp.asarray(known.view(torch.int32).numpy().view(np.uint32))
    t_j = jnp.asarray(types.numpy())
    if len(shape) == 3:
        want = pallas.decode(t_j, kv, shape, key, "cpu")
    else:
        want = pallas.decode2d(t_j, kv, shape, key, "cpu")
    out = decode(types, known, tables[1])
    np.testing.assert_array_equal(out.view(torch.int32).numpy().reshape(-1)
                                  .view(np.uint32), np.asarray(want))
    np.testing.assert_array_equal(out.abs().numpy().view(np.uint32),
                                  rec.numpy().view(np.uint32))


# the shapes of tests/test_msst19_engine.py::test_device_matches_host
ENGINE_SHAPES = [(48, 37), (24, 19, 23), (7, 5), (3, 3, 3), (1, 40), (2, 2),
                 (33, 1, 17), (40, 48, 56)]
RATIOS = [1e-2, 1e-3, 1e-4, 1e-5]


@pytest.mark.parametrize("ratio", RATIOS)
@pytest.mark.parametrize("shape", ENGINE_SHAPES)
def test_engine_matches_host_codec(shape, ratio):
    data = synth(shape, np.float32, seed=len(shape))
    fmax = data.max()
    nz = np.abs(data[data != 0]).min()
    want = jpwr.compress_msst19(data, ratio, fmax, nz, **KW)
    got = msst19_engine.compress(data, ratio, fmax, nz, device="cpu", **KW)
    assert ttdps.to_bytes(got) == jtdps.to_bytes(want)
    out = msst19_engine.decompress(ttdps.from_bytes(
        jtdps.to_bytes(want), DataType.FLOAT, is_pwr=True, msst19=True), shape,
        device="cpu")
    np.testing.assert_array_equal(
        out.view(np.uint32),
        jpwr.decompress_pwrel(want, shape, np.float32).view(np.uint32))


def _configs(ratio):
    return (SZConfig().with_bound(ErrorBoundMode.PW_REL, ratio),
            JConfig(engine="numpy").with_bound(JMode.PW_REL, ratio))


def _api_case(name):
    rng = np.random.default_rng(71)
    if name == "signed_zeros_3d":
        x = synth((26, 22, 30), np.float32, 3, signed=True)
        x[rng.random(x.shape) < 0.05] = 0
    elif name == "first_value_zero":       # nearZero stays 0: the
        x = synth((20, 30, 25), np.float32, 5, signed=True)  # serial optimizer
        x[rng.random(x.shape) < 0.02] = 0
        x[0, 0, 0] = 0
    elif name == "fold_4d":
        x = synth((9, 6, 10, 8), np.float32, 3)
    elif name == "signed_zeros_2d":
        x = synth((60, 45), np.float32, 7, signed=True)
        x[rng.random(x.shape) < 0.05] = 0
    elif name == "negative_first_value":   # signs[0] is never set
        x = synth((44, 38), np.float32, 9)
        x[0, 0] = -x[0, 0]
    else:
        x = synth((16, 23, 19), np.float32, 11)
    return x


API_CASES = ["signed_zeros_3d", "first_value_zero", "fold_4d",
             "signed_zeros_2d", "negative_first_value", "positive_3d"]


@pytest.mark.parametrize("ratio", RATIOS)
@pytest.mark.parametrize("name", API_CASES)
def test_api_matches_sz_tpu(name, ratio):
    x = _api_case(name)
    t, j = _configs(ratio)
    blob = sz_tpu.compress(x, j)
    assert sz_tpu_torch.compress(x, t, device="cpu") == blob
    want = sz_tpu.decompress(blob, x.shape, np.float32, engine="numpy")
    got = sz_tpu_torch.decompress(blob, x.shape, np.float32, device="cpu")
    assert got.shape == want.shape
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


@pytest.mark.parametrize("mode", ["ABS_AND_PW_REL", "REL_OR_PW_REL"])
def test_api_pw_rel_family_matches_sz_tpu(mode):
    """Every mode above PW_REL runs as plain PW_REL, with its own header."""
    x = _api_case("signed_zeros_3d")
    t = SZConfig(error_bound_mode=ErrorBoundMode[mode],
                 pw_rel_bound_ratio=1e-3)
    j = JConfig(error_bound_mode=JMode[mode], pw_rel_bound_ratio=1e-3,
                engine="numpy")
    blob = sz_tpu.compress(x, j)
    assert sz_tpu_torch.compress(x, t, device="cpu") == blob


@pytest.mark.parametrize("kw", [
    dict(protect_value_range=True), dict(size_type=4),
    dict(quantization_intervals=2048), dict(sz_mode=0),
    dict(lossless=0, lossless_level=9)],
    ids=["protect_range", "size_type_4", "fixed_intervals", "best_speed",
         "gzip"])
def test_api_options_match_sz_tpu(kw):
    """The framing and optimizer options around the MSST19 body."""
    x = _api_case("signed_zeros_2d")
    t = SZConfig(**kw).with_bound(ErrorBoundMode.PW_REL, 1e-3)
    j = JConfig(engine="numpy", **kw).with_bound(JMode.PW_REL, 1e-3)
    blob = sz_tpu.compress(x, j)
    assert sz_tpu_torch.compress(x, t, device="cpu") == blob
    np.testing.assert_array_equal(
        sz_tpu_torch.decompress(blob, x.shape, device="cpu").view(np.uint32),
        sz_tpu.decompress(blob, x.shape, np.float32,
                          engine="numpy").view(np.uint32))


def test_api_as_tensor_and_point_wise_bound():
    x = _api_case("signed_zeros_3d")
    t, _ = _configs(1e-3)
    blob = sz_tpu_torch.compress(x, t, device="cpu")
    out = sz_tpu_torch.decompress(blob, x.shape, device="cpu",
                                  as_tensor=True)
    assert torch.is_tensor(out) and out.shape == x.shape
    y = out.numpy().astype(np.float64)
    nz = x != 0
    assert (np.abs(y - x)[nz] <= 1e-3 * np.abs(x[nz]) * (1 + 1e-3)).all()
    assert (y[~nz] == 0).all()


@pytest.mark.parametrize("name,shape", [("f32_2d_pwrel1e-3", (128, 64)),
                                        ("f32_3d_pwrel1e-3", (128, 8, 8))])
def test_reference_goldens_decode(name, shape):
    blob = (GOLDEN / f"{name}.sz").read_bytes()
    want = np.fromfile(GOLDEN / f"{name}.out", dtype="<f4")
    got = sz_tpu_torch.decompress(blob, shape, np.float32, device="cpu")
    np.testing.assert_array_equal(got.reshape(-1).view(np.uint32),
                                  want.view(np.uint32))
