"""The port's SZRA slab container (``sz_tpu_torch.ra``) against
``sz_tpu.ra`` on the CPU: ``compress`` with the default ``slab_points``,
a small one and ``n_slabs`` above the row count, float32 and float64 at
ranks 2-4; ``build_container`` from the port's payloads; ``Reader``'s
slab, region (across slab borders) and whole decodes; the integer
refusal.  Tolerance: exact (equal bytes, equal bits)."""

import numpy as np
import pytest
import torch
torch.set_num_threads(1)  # xdist workers share the cores: one thread each

import sz_tpu_torch
from sz_tpu import ra as jra
from sz_tpu.config import ErrorBoundMode as JMode
from sz_tpu.config import SZConfig as JConfig
from sz_tpu_torch import ra
from sz_tpu_torch.config import ErrorBoundMode, SZConfig

CFG = SZConfig().with_bound(ErrorBoundMode.ABS, 1e-3)
JCFG = JConfig(engine="numpy").with_bound(JMode.ABS, 1e-3)


def _field(shape, dtype, seed=0):
    rng = np.random.default_rng(seed)
    n = int(np.prod(shape))
    return (np.sin(np.linspace(0, 9, n)) + 0.05 * rng.standard_normal(n)
            ).astype(dtype).reshape(shape)


def _same_bits(a, b):
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8))


SHAPES = [(40, 37), (18, 12, 14), (6, 5, 8, 9)]


@pytest.mark.parametrize("kw", [{}, {"slab_points": 300},
                                 {"n_slabs": "rows+3"}],
                         ids=["default", "slab_points_300",
                              "n_slabs_above_rows"])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("shape", SHAPES, ids=["2d", "3d", "4d"])
def test_compress_matches_sz_tpu(shape, dtype, kw):
    x = _field(shape, dtype, seed=len(shape))
    if kw.get("n_slabs") == "rows+3":
        kw = {"n_slabs": shape[0] + 3}
    blob = ra.compress(x, CFG, device="cpu", **kw)
    assert blob == jra.compress(x, JCFG, **kw)
    r, jr = ra.Reader(blob), jra.Reader(blob)
    assert r.n_slabs == jr.n_slabs and r.shape == jr.shape
    assert r.n_slabs == (1 if not kw else
                         min(shape[0], kw.get("n_slabs", r.n_slabs)))
    # the last slab (the remainder) decodes bit-equal to sz_tpu's
    last = r.n_slabs - 1
    _same_bits(r.decode_slab(last, "cpu"),
               jr.decode_slab(last, engine="numpy"))


def test_build_container_from_the_port_payloads():
    x = _field((30, 20, 16), np.float32, seed=3)
    starts = ra._slab_bounds(30, 4)
    np.testing.assert_array_equal(starts, jra._slab_bounds(30, 4))
    payloads = [sz_tpu_torch.compress(x[int(a):int(b)], CFG, device="cpu")
                for a, b in zip(starts[:-1], starts[1:])]
    blob = ra.build_container(x.shape, x.dtype, starts, payloads)
    assert blob == jra.build_container(x.shape, x.dtype, starts, payloads)
    assert blob == jra.compress(x, JCFG, n_slabs=4)
    assert [ra.Reader(blob).slab_bytes(i) for i in range(4)] == payloads


def test_reader_region_across_slab_borders():
    x = _field((24, 20, 18), np.float64, seed=5)
    blob = jra.compress(x, JConfig(engine="numpy").with_bound(JMode.ABS,
                                                              1e-6),
                        n_slabs=4)   # slabs of 6, 6, 6, 6 rows
    r, jr = ra.Reader(blob), jra.Reader(blob)
    region = r.decode_region(5, 19, "cpu")   # slabs 0-3, cut at both ends
    _same_bits(region, jr.decode_region(5, 19, engine="numpy"))
    whole = ra.decompress(blob, device="cpu")
    _same_bits(whole, jra.decompress(blob, engine="numpy"))
    _same_bits(region, whole[5:19])
    assert np.abs(whole - x).max() <= 1e-6


@pytest.mark.parametrize("dtype", [np.int32, np.int16])
def test_integers_raise_type_error(dtype):
    x = np.arange(8 * 9, dtype=dtype).reshape(8, 9)
    with pytest.raises(TypeError, match="random-access container"):
        ra.compress(x, CFG, device="cpu")
    with pytest.raises(TypeError, match="random-access container"):
        jra.compress(x, JCFG)


def test_not_a_container_raises():
    with pytest.raises(ValueError, match="not an SZRA container"):
        ra.Reader(b"SZ\x00\x00" + bytes(60))
