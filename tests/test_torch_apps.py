"""The port's app codecs and pysz facade against ``sz_tpu``'s on the CPU:
ExaFEL (its SZ stream through the port's codec, ``device="cpu"``),
PaSTRI (a host codec, float64 and float32 batches), the wavelet
pre-transform (D4 coefficients through the port's 1-D double codec) and
``pysz``'s ConfigBuilder / Compressor for each app.  Equal bytes, equal
bits.
"""

import dataclasses

import numpy as np
import pytest
import torch
torch.set_num_threads(1)  # xdist workers share the cores: one thread each

from sz_tpu import pysz as jpysz
from sz_tpu.apps import exafel as jexafel
from sz_tpu.apps import pastri as jpastri
from sz_tpu.apps import wavelet as jwavelet
from sz_tpu.config import ErrorBoundMode as JMode
from sz_tpu.config import SZConfig as JConfig

from sz_tpu_torch import pysz as tpysz
from sz_tpu_torch.apps import exafel as texafel
from sz_tpu_torch.apps import pastri as tpastri
from sz_tpu_torch.apps import wavelet as twavelet
from sz_tpu_torch.config import ErrorBoundMode as TMode
from sz_tpu_torch.config import SZConfig as TConfig


def _bits(a):
    return np.ascontiguousarray(a).view(np.uint8)


def _exafel_case(mod, sz_dim=3, events=3):
    """tests/test_exafel.py's detector: 2 panels of 64 x 48, three bright
    peaks, a masked edge strip."""
    rng = np.random.default_rng(8)
    panels, rows, cols = 2, 64, 48
    data = (100 + 10 * rng.standard_normal(
        (events, panels, rows, cols))).astype(np.float32)
    calib = np.ones((panels, rows, cols), dtype=np.uint8)
    calib[:, :2, :] = 0
    pr = mod.ExaFELConfig(
        calib_panel=calib,
        peaks_segs=np.array([0, 1, 1], dtype=np.uint16),
        peaks_rows=np.array([10, 30, 62], dtype=np.uint16),
        peaks_cols=np.array([12, 40, 2], dtype=np.uint16),
        bin_size=2, tolerance=0.5, sz_dim=sz_dim, peak_size=5)
    for p, r, c in zip(pr.peaks_segs, pr.peaks_rows, pr.peaks_cols):
        data[:, p, max(r - 2, 0):r + 3, max(c - 2, 0):c + 3] += 500
    return pr, data


@pytest.mark.parametrize("sz_dim", [1, 2, 3, 4])
def test_exafel_matches(sz_dim):
    jpr, data = _exafel_case(jexafel, sz_dim)
    tpr, _ = _exafel_case(texafel, sz_dim)
    want = jexafel.compress(jpr, data)
    got = texafel.compress(tpr, data, device="cpu")
    assert got == want
    out = texafel.decompress(tpr, got, *data.shape, device="cpu")
    ref = jexafel.decompress(jpr, want, *data.shape)
    np.testing.assert_array_equal(_bits(out), _bits(ref))


def _gamess_like(mod, params, rng, sparse_block=None, noise=1e-8):
    """tests/test_pastri.py's GAMESS-like integral blocks."""
    pattern = rng.standard_normal(params.sb_size)
    blocks = []
    for b in range(params.num_blocks):
        scales = rng.standard_normal(params.sb_num) * (10.0 ** -(b % 4))
        blk = np.outer(scales, pattern).reshape(-1)
        blk = blk + rng.standard_normal(params.b_size) * noise
        if b == sparse_block:
            blk[:] = 0
            blk[3] = 0.5
            blk[min(100, params.b_size - 1)] = -2.0
        blocks.append(blk)
    return np.concatenate(blocks)


@pytest.mark.parametrize("bf,eb,size,blocks,noise", [
    ((1, 1, 2, 2), 1e-7, 8, 6, 1e-8), ((0, 0, 1, 1), 1e-6, 8, 3, 1e-7),
    ((2, 2, 3, 3), 1e-6, 8, 3, 1e-7), ((1, 1, 2, 2), 1e-4, 4, 4, 1e-5)])
def test_pastri_matches(bf, eb, size, blocks, noise):
    jp = jpastri.PastriParams(bf=bf, original_eb=eb, data_size=size,
                              num_blocks=blocks)
    tp = tpastri.PastriParams(bf=bf, original_eb=eb, data_size=size,
                              num_blocks=blocks)
    data = _gamess_like(jpastri, jp, np.random.default_rng(7),
                        sparse_block=blocks - 2)
    if size == 4:
        data = data.astype(np.float32)
    want = jpastri.compress_batch(jp, data)
    got = tpastri.compress_batch(tp, data)
    assert got == want
    assert tp.to_bytes() == jp.to_bytes()
    if size == 8:   # float batches' decode desyncs upstream
        (_, out), (_, ref) = (tpastri.decompress_batch(got),
                              jpastri.decompress_batch(want))
        np.testing.assert_array_equal(_bits(out), _bits(ref))


def test_pastri_float_single_block_decode():
    tp = tpastri.PastriParams(bf=(1, 1, 2, 2), original_eb=1e-10,
                              data_size=4, num_blocks=1)
    data = np.random.default_rng(13).standard_normal(
        tp.b_size).astype(np.float32)
    blob = tpastri.compress_batch(tp, data)
    assert blob == jpastri.compress_batch(
        jpastri.PastriParams(bf=(1, 1, 2, 2), original_eb=1e-10,
                             data_size=4, num_blocks=1), data)
    np.testing.assert_array_equal(tpastri.decompress_batch(blob)[1], data)


@pytest.mark.parametrize("n", [64, 4096])
def test_wavelet_matches(n):
    x = np.cumsum(np.random.default_rng(n).standard_normal(n))
    jc = JConfig(engine="numpy").with_bound(JMode.ABS, 1e-3)
    tc = TConfig().with_bound(TMode.ABS, 1e-3)
    np.testing.assert_array_equal(twavelet.dwt_forward(x),
                                  jwavelet.dwt_forward(x))
    want = jwavelet.compress_wavelet(x, jc)
    got = twavelet.compress_wavelet(x, tc, device="cpu")
    assert got == want
    out = twavelet.decompress_wavelet(got, n, device="cpu")
    np.testing.assert_array_equal(_bits(out),
                                  _bits(jwavelet.decompress_wavelet(want, n)))
    with pytest.raises(ValueError, match="power-of-two"):
        twavelet.dwt_forward(np.zeros(100))


@pytest.mark.parametrize("app", ["SZ", "SZ1.4", "SZ_Transpose", "ExaFEL"])
def test_pysz_matches(app):
    def build(mod):
        return (mod.ConfigBuilder().app(app).errorBoundMode(mod.ABS)
                .absErrBound(1e-3).sampleDistance(50).predThreshold(0.98)
                .build())

    if app == "ExaFEL":
        jpr, data = _exafel_case(jexafel)
        tpr, _ = _exafel_case(texafel)
    else:
        data = np.cumsum(np.random.default_rng(3).standard_normal(
            (16, 20, 24)), axis=2).astype(np.float32)
        jpr = tpr = None
    jc = jpysz.Compressor(build(jpysz), exafel_params=jpr)
    jc.config.cfg = dataclasses.replace(jc.config.cfg, engine="numpy")
    tc = tpysz.Compressor(build(tpysz), exafel_params=tpr, device="cpu")
    assert dataclasses.asdict(tc.config.cfg) == {
        k: v for k, v in dataclasses.asdict(jc.config.cfg).items()
        if k != "engine"}
    want = jc.Compress(data)
    got = tc.Compress(data)
    assert got == want
    out = tc.Decompress(got, data.shape, np.float32)
    np.testing.assert_array_equal(_bits(out),
                                  _bits(jc.Decompress(want, data.shape,
                                                      np.float32)))
    assert tpysz.compress(data, tc.config.cfg, device="cpu") == \
        jpysz.compress(data, jc.config.cfg)


def test_pysz_defaults_to_the_card():
    assert tpysz.Compressor().device == "cuda"
