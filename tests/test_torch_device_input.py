"""Tensor input to the port's compress on the CPU (``device="cpu"``, so a
CPU tensor lies on the compute device and takes the device-input path:
the range scan, the optimizer's gathers and every lattice stage start
from the tensor).  Each stream must equal the numpy input's and
sz_tpu.compress of the same field as a jax.Array (its
``_try_compress_device`` path; the JAX engine on the CPU for the
``JAX_ENGINE`` cases, the rest materialized as sz_tpu's own default
does on a CPU backend).  The card's copy
of these checks, with the bytes that cross the link, is in
chip_smoke.py and tests/test_torch_gpu.py.  Tolerance: exact (equal
bytes).
"""

import numpy as np
import pytest
import torch
torch.set_num_threads(1)  # xdist workers share the cores: one thread each

import jax
import jax.numpy as jnp

import sz_tpu
from sz_tpu.config import ErrorBoundMode, SZConfig

import sz_tpu_torch
from sz_tpu_torch import config as tcfg
from sz_tpu_torch.config import MIN_NUM_OF_ELEMENTS
from sz_tpu_torch.utils import trace as tr

# a float64 jax.Array needs x64, else jnp.asarray makes it float32;
# sz_tpu's engine turns x64 on when it is imported, and these cases must
# not hang on another module having imported it first
jax.config.update("jax_enable_x64", True)


def _wave(shape, seed, T=np.float32):
    rng = np.random.default_rng(seed)
    n = int(np.prod(shape))
    return (np.sin(np.linspace(0, 9, n)) + 0.05 * rng.standard_normal(n)
            ).astype(T).reshape(shape)


def _dense(T):
    """60 % of the points at one value: the optimizer takes the mean
    flush (use_mean)."""
    rng = np.random.default_rng(5)
    x = _wave((20, 22, 24), 5, T)
    x[rng.random(x.shape) < 0.6] = T(0.5)
    return x


def _spiky(shape, seed):
    """A smooth field with spikes on 3 % of its points: hundreds of
    escapes, yet a stream shorter than the field (no StoreOri)."""
    rng = np.random.default_rng(seed)
    x = _wave(shape, seed)
    spikes = rng.random(shape) < 0.03
    x[spikes] += rng.standard_normal(int(spikes.sum())).astype(
        np.float32) * 100
    return x


# name -> (field maker, bound mode, value, spans the tensor path must show)
CASES = {
    "f32": (lambda: _wave((20, 30, 26), 1), ErrorBoundMode.ABS, 1e-3),
    "f64": (lambda: _wave((20, 30, 26), 2, np.float64), ErrorBoundMode.ABS,
            1e-3),
    "f64_2d_rel": (lambda: _wave((90, 70), 3, np.float64), ErrorBoundMode.REL,
                   1e-4),
    "f32_norm": (lambda: _wave((20, 30, 26), 10), ErrorBoundMode.NORM, 0.5),
    "f64_3d_norm": (lambda: _wave((20, 30, 26), 11, np.float64),
                    ErrorBoundMode.NORM, 0.5),
    "f64_2d_norm": (lambda: _wave((90, 70), 12, np.float64),
                    ErrorBoundMode.NORM, 0.2),
    # abs 1e-3 against rel 1e-4 of a range near 2: the rel bound is picked
    # (and in float32 both are rounded through float32 first)
    "f32_abs_and_rel": (lambda: _wave((20, 30, 26), 13),
                        ErrorBoundMode.ABS_AND_REL, 1e-3),
    # abs 1e-4 under rel's 2e-4: the abs bound is picked
    "f64_abs_and_rel": (lambda: _wave((20, 30, 26), 14, np.float64),
                        ErrorBoundMode.ABS_AND_REL, 1e-4),
    "f32_use_mean": (lambda: _dense(np.float32), ErrorBoundMode.ABS, 1e-3),
    "f64_use_mean": (lambda: _dense(np.float64), ErrorBoundMode.ABS, 1e-3),
    "f32_escapes": (lambda: _spiky((24, 25, 26), 4), ErrorBoundMode.ABS,
                    1e-3),
    "f64_4d_psnr": (lambda: _wave((3, 10, 12, 13), 5, np.float64),
                    ErrorBoundMode.PSNR, 80.0),
    "f32_constant": (lambda: np.full((10, 12, 14), 2.5, np.float32),
                     ErrorBoundMode.ABS, 1e-3),
    "f64_tiny": (lambda: np.arange(MIN_NUM_OF_ELEMENTS,
                                   dtype=np.float64).reshape(4, 5),
                 ErrorBoundMode.ABS, 1e-3),
    "f64_store_ori": (lambda: np.random.default_rng(6).standard_normal(
        (16, 17, 18)), ErrorBoundMode.ABS, 1e-12),
    "f32_pw_rel": (lambda: np.abs(_wave((20, 30, 26), 7)) + 0.5,
                   ErrorBoundMode.PW_REL, 1e-3),
}


# the cases sz_tpu compresses on its device path (JAX engine on the CPU)
JAX_ENGINE = ("f64", "f64_use_mean")


@pytest.mark.parametrize("name", sorted(CASES))
def test_tensor_input_matches_numpy_and_jax_array(name):
    make, mode, value = CASES[name]
    x = make()
    cfg = tcfg.SZConfig().with_bound(tcfg.ErrorBoundMode(int(mode)), value)
    jcfg = SZConfig(engine="jax" if name in JAX_ENGINE else "auto")
    want = sz_tpu.compress(jnp.asarray(x), jcfg.with_bound(mode, value))
    assert sz_tpu_torch.compress(x, cfg, device="cpu") == want
    tr.reset()
    got = sz_tpu_torch.compress(torch.from_numpy(x), cfg, device="cpu")
    spans = {k for k, _ in tr.last_spans()}
    assert got == want
    if x.size <= MIN_NUM_OF_ELEMENTS:
        assert got == x.tobytes()
        return
    # the field was brought down only by a fallback that needs its values
    # (StoreOri, the PW_REL host scans, whose MSST19 path then uploads
    # what it made of them) or, for a constant field, its first value
    down = "device_input_download" in spans
    assert down == (name in ("f64_store_ori", "f32_pw_rel", "f32_constant"))
    if name == "f32_pw_rel":
        return
    # and otherwise compressed where it lay: never uploaded
    assert "upload" not in spans
    if name in ("f64_store_ori", "f32_constant"):
        return
    assert "device_input" in spans and "optimizer" in spans
    out = sz_tpu_torch.decompress(got, x.shape, x.dtype, device="cpu")
    ref = sz_tpu.decompress(want, x.shape, x.dtype, engine="numpy")
    np.testing.assert_array_equal(out, ref)


@pytest.mark.parametrize("T", [np.float32, np.float64])
def test_non_contiguous_tensor(T):
    """A transposed (non-contiguous) tensor and a sliced one compress as
    their contiguous copies do; the copy is made where the tensor lies."""
    x = _wave((20, 24, 28), 8, T)
    cfg = tcfg.SZConfig().with_bound(tcfg.ErrorBoundMode.ABS, 1e-3)
    t = torch.from_numpy(x).permute(2, 0, 1)
    assert not t.is_contiguous()
    want = sz_tpu.compress(jnp.asarray(np.ascontiguousarray(
        x.transpose(2, 0, 1))), SZConfig().with_bound(ErrorBoundMode.ABS,
                                                      1e-3))
    assert sz_tpu_torch.compress(t, cfg, device="cpu") == want
    s = torch.from_numpy(x)[:, ::2, 3:]
    assert sz_tpu_torch.compress(s, cfg, device="cpu") == \
        sz_tpu_torch.compress(np.ascontiguousarray(x[:, ::2, 3:]), cfg,
                              device="cpu")


def test_tensor_is_not_modified():
    x = _wave((20, 24, 28), 9, np.float64)
    t = torch.from_numpy(x.copy())
    cfg = tcfg.SZConfig().with_bound(tcfg.ErrorBoundMode.ABS, 1e-3)
    sz_tpu_torch.compress(t, cfg, device="cpu")
    np.testing.assert_array_equal(t.numpy(), x)


def test_tensor_out_of_slice_raises():
    """Tensors take the routes arrays take: integers (1.10), float64
    under PW_REL (1.3), float64 with random access (3.4, the classic
    codec), float32 with random access (1.6) and a 1-D tensor (1.4), all
    ported, compress to the host array's bytes and to sz_tpu's."""
    pw = tcfg.SZConfig().with_bound(tcfg.ErrorBoundMode.PW_REL, 1e-3)
    ab = tcfg.SZConfig().with_bound(tcfg.ErrorBoundMode.ABS, 1e-3)
    ra = tcfg.SZConfig(random_access=True).with_bound(
        tcfg.ErrorBoundMode.ABS, 1e-3)
    wave = _wave((10, 11, 12), 4, np.float64)
    for x, cfg, jc in (
            ((wave * 1000).astype(np.int32), ab,
             SZConfig().with_bound(ErrorBoundMode.ABS, 1e-3)),
            (wave, pw, SZConfig().with_bound(ErrorBoundMode.PW_REL, 1e-3)),
            (wave, ra, SZConfig(random_access=True).with_bound(
                ErrorBoundMode.ABS, 1e-3)),
            (wave.astype(np.float32), ra, SZConfig(
                random_access=True).with_bound(ErrorBoundMode.ABS, 1e-3)),
            (np.sin(np.linspace(0, 20, 1320)), ab,
             SZConfig().with_bound(ErrorBoundMode.ABS, 1e-3))):
        blob = sz_tpu_torch.compress(torch.from_numpy(x), cfg, device="cpu")
        assert blob == sz_tpu_torch.compress(x, cfg, device="cpu")
        assert blob == sz_tpu.compress(x, jc)
    with pytest.raises(TypeError):
        sz_tpu_torch.compress(torch.ones((10, 11, 12), dtype=torch.float16),
                              ab, device="cpu")
