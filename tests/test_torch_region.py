"""``compress_region`` (SZ_compress_args3) and ``get_metadata`` of the port
against ``sz_tpu``'s on the CPU: float32 and float64 regions of rank 1-4,
origins at 0 and odd, ABS and REL, fixed and optimised intervals, regions
below and above ``sz_tpu``'s native threshold (2^16 points: its Python
loops below, its C wavefront above), the constant region, PW_REL's
refusal; the regions' decodes through ``decompress``; and the plain
version of K10's subblock form against ``sz_tpu``'s subblock encode
(``sz_tpu.native.classicnd_encode(subblock=True)``) and the subblock
optimizer.  Tolerance: exact (equal bytes, equal bits).
"""

import numpy as np
import pytest
import torch
torch.set_num_threads(1)  # xdist workers share the cores: one thread each

import sz_tpu
from sz_tpu import native as jnative
from sz_tpu.config import ErrorBoundMode as JMode
from sz_tpu.config import SZConfig as JConfig
from sz_tpu.core import classic_nd as jnd

import sz_tpu_torch
from sz_tpu_torch.config import ErrorBoundMode, SZConfig
from sz_tpu_torch.core import classic_nd
from sz_tpu_torch.gpu import classic_kernel


def _field(shape, dtype, seed):
    rng = np.random.default_rng(seed)
    f = np.cumsum(rng.standard_normal(shape), axis=-1) * 0.1
    if len(shape) > 1:
        f = f + np.cumsum(rng.standard_normal(shape), axis=-2) * 0.05
    return f.astype(dtype)


def _both(data, start, end, mode, bound, cfg_kw=None):
    cfg_kw = cfg_kw or {}
    ab = bound if mode == "ABS" else None
    rb = bound if mode == "REL" else None
    want = sz_tpu.compress_region(
        data, start, end, JConfig(engine="numpy", **cfg_kw),
        mode=getattr(JMode, mode), abs_bound=ab, rel_bound=rb)
    got = sz_tpu_torch.compress_region(
        data, start, end, SZConfig(**cfg_kw), mode=getattr(ErrorBoundMode,
                                                           mode),
        abs_bound=ab, rel_bound=rb, device="cpu")
    return got, want


REGIONS = [
    # (id, field shape, start, end): below and above 2^16 region points
    ("1d_small", (6000,), (0,), (5000,)),
    ("1d_odd", (90001,), (123,), (80123,)),
    ("2d_small", (60, 70), (0, 0), (41, 53)),
    ("2d_odd", (300, 290), (7, 3), (290, 270)),
    ("3d_small", (30, 26, 22), (5, 3, 1), (27, 25, 21)),
    ("3d_zero", (50, 45, 41), (0, 0, 0), (49, 45, 40)),
    ("4d_small", (4, 6, 30, 25), (1, 1, 2, 3), (4, 5, 28, 22)),
    ("4d_odd", (5, 9, 60, 64), (1, 3, 1, 5), (5, 9, 59, 63)),
]


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("rid,shape,start,end", REGIONS,
                         ids=[r[0] for r in REGIONS])
@pytest.mark.parametrize("mode,bound", [("ABS", 1e-3), ("REL", 1e-4)])
def test_region_stream_and_decode_match(rid, shape, start, end, dtype, mode,
                                        bound):
    data = _field(shape, dtype, 3)
    got, want = _both(data, start, end, mode, bound)
    assert got == want
    rshape = tuple(e - s for s, e in zip(start, end))
    assert int(np.prod(rshape)) > 1 << 16 or "small" in rid
    out = sz_tpu_torch.decompress(got, rshape, dtype, device="cpu")
    ref = sz_tpu.decompress(want, rshape, dtype, engine="numpy")
    np.testing.assert_array_equal(out.view(np.uint8), ref.view(np.uint8))


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("rank", [1, 2, 3, 4])
def test_region_fixed_intervals(dtype, rank):
    shape = {1: (7000,), 2: (50, 60), 3: (20, 22, 24), 4: (3, 8, 20, 22)}[rank]
    start = tuple(1 for _ in shape)
    end = tuple(s - 1 for s in shape)
    data = _field(shape, dtype, 4)
    got, want = _both(data, start, end, "ABS", 1e-3,
                      {"quantization_intervals": 256})
    assert got == want


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_region_sampling_follows_the_origin(dtype):
    """The optimizer samples on global coordinates: the same values at
    another origin may pick other intervals; both match sz_tpu."""
    data = _field((40, 48, 44), dtype, 8)
    for start in [(0, 0, 0), (1, 0, 0), (3, 5, 7)]:
        end = tuple(s + 30 for s in start)
        got, want = _both(data, start, end, "ABS", 1e-2)
        assert got == want


def test_constant_region_and_best_speed():
    data = np.zeros((20, 20), np.float32)
    got, want = _both(data, (2, 2), (10, 10), "ABS", 1e-3)
    assert got == want
    out = sz_tpu_torch.decompress(got, (8, 8), np.float32, device="cpu")
    np.testing.assert_array_equal(out, np.zeros((8, 8), np.float32))
    d = _field((30, 40), np.float64, 1)
    from sz_tpu_torch.config import SZMode
    from sz_tpu.config import SZMode as JSZMode
    got = sz_tpu_torch.compress_region(
        d, (3, 4), (25, 37), SZConfig(sz_mode=SZMode.BEST_SPEED),
        abs_bound=1e-3, device="cpu")
    want = sz_tpu.compress_region(
        d, (3, 4), (25, 37), JConfig(engine="numpy",
                                     sz_mode=JSZMode.BEST_SPEED),
        abs_bound=1e-3)
    assert got == want


def test_pw_rel_is_refused_as_sz_tpu_refuses():
    data = _field((20, 20), np.float32, 2) + 5
    with pytest.raises(NotImplementedError, match="sz_float.c:3104"):
        sz_tpu_torch.compress_region(data, (0, 0), (10, 10), SZConfig(),
                                     mode=ErrorBoundMode.PW_REL,
                                     device="cpu")
    with pytest.raises(NotImplementedError):
        sz_tpu.compress_region(data, (0, 0), (10, 10), JConfig(),
                               mode=JMode.PW_REL)


def test_compress_region_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        sz_tpu_torch.compress_region(np.zeros((8, 8), np.float32), (0, 0),
                                     (4, 4))


@pytest.mark.parametrize("shape,origin", [
    ((40, 30), (0, 0)), ((40, 30), (3, 8)), ((12, 14, 16), (1, 2, 4)),
    ((3, 7, 9, 11), (2, 1, 1, 3)), ((3, 7, 9, 11), (0, 0, 0, 0))])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_subblock_optimizer_matches(shape, origin, dtype):
    data = _field(shape, dtype, 6)
    want = jnd._optimize_intervals_subblock(data, origin, 1e-3, 32768, 7,
                                            np.float32(0.99))
    got = classic_nd.optimize_intervals_subblock(data, origin, 1e-3, 32768,
                                                 7, np.float32(0.99))
    assert got == want


SUB_SHAPES = [(260, 256), (41, 41, 40), (3, 23, 31, 32)]


@pytest.mark.parametrize("shape", SUB_SHAPES, ids=str)
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_plain_subblock_form_matches_sz_tpu(shape, dtype):
    """K10's plain subblock form: its types equal sz_tpu's C subblock
    encode's (its wavefront kernel past 2^16 points), escapes included;
    an intervals count small enough that some points leave it."""
    data = _field(shape, dtype, 9)
    rp = 2e-3
    intervals, radius = 64, 32
    median = dtype(data.mean())
    req_length = 20 if dtype == np.float32 else 40
    want = jnative.classicnd_encode(
        data, rp, 1.0 / rp, dtype(rp), dtype(1.0 / rp), intervals, radius,
        True, req_length, median, subblock=True)[0]
    types, R = classic_kernel.classic_quantize_sub(
        torch.from_numpy(data), np.float64(rp), intervals, radius, median,
        req_length, want_R=True)
    got = types.reshape(-1).numpy()
    np.testing.assert_array_equal(got, want)
    assert 0 < (got == 0).sum() < got.size
    ok = got != 0
    assert np.abs(R.numpy().reshape(-1)[ok]
                  - data.reshape(-1)[ok]).max() <= rp * (1 + 1e-6)


def test_subblock_form_is_its_own_wrapper():
    """classic_quantize_sub counts its own launches (none on the CPU,
    where it runs the plain version) and reads no reciprocal."""
    data = torch.from_numpy(_field((64, 64), np.float32, 5))
    before = (classic_kernel.classic_quantize.launches,
              classic_kernel.classic_quantize_sub.launches)
    t, R = classic_kernel.classic_quantize_sub(data, np.float64(1e-2), 256,
                                               128, np.float32(0), 20)
    want = classic_kernel.classic_quantize_plain(
        data, np.float64(1e-2), np.float64(7.0), 256, 128, np.float32(0),
        20, sub=True)
    assert torch.equal(t, want[0]) and torch.equal(R, want[1])
    assert (classic_kernel.classic_quantize.launches,
            classic_kernel.classic_quantize_sub.launches) == before


@pytest.mark.parametrize("cid", ["regression", "classic", "pwrel", "const",
                                 "region", "double", "best_speed"])
def test_get_metadata_matches(cid):
    data = _field((20, 24, 28), np.float32, 1)
    jc, tc = JConfig(engine="numpy"), SZConfig()
    if cid == "classic":
        jc = JConfig(engine="numpy", with_regression=False)
        tc = SZConfig(with_regression=False)
    if cid == "double":
        data = data.astype(np.float64)
    if cid == "const":
        data = np.full((20, 24, 28), 3.5, np.float32)
    if cid == "best_speed":
        from sz_tpu.config import SZMode as JSZMode
        from sz_tpu_torch.config import SZMode
        jc = JConfig(engine="numpy", sz_mode=JSZMode.BEST_SPEED)
        tc = SZConfig(sz_mode=SZMode.BEST_SPEED)
    if cid == "pwrel":
        jc = jc.with_bound(JMode.PW_REL, 1e-2)
        tc = tc.with_bound(ErrorBoundMode.PW_REL, 1e-2)
        data = data + 5
    if cid == "region":
        blob = sz_tpu.compress_region(data, (1, 2, 3), (15, 20, 25), jc,
                                      abs_bound=1e-3)
    else:
        blob = sz_tpu.compress(data, jc)
        assert sz_tpu_torch.compress(data, tc, device="cpu") == blob
    want = sz_tpu.get_metadata(blob)
    got = sz_tpu_torch.get_metadata(blob)
    assert list(got) == list(want)
    for k in want:
        assert got[k] == want[k], k
        assert str(got[k]) == str(want[k]), k
