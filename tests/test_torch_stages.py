"""The port's plain-torch device stages (sz_tpu_torch.gpu.stages and
.geometry) against their sz_tpu.tpu.engine counterparts on the CPU.
Tolerance: exact -- float results compared as bits, indices as values.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from sz_tpu.core import regnd
from sz_tpu.tpu import engine as jeng

from sz_tpu_torch.gpu import geometry as geo
from sz_tpu_torch.gpu import stages

SHAPES = [(25, 14, 20), (13, 19, 7), (40, 33), (17, 50)]


def _field(shape, seed):
    """Smooth in one half (Lorenzo wins there); a plane plus strong noise
    in the other (regression wins).  The split runs along an axis that
    has more than one block."""
    rng = np.random.default_rng(seed)
    grids = np.meshgrid(*[np.arange(r) for r in shape], indexing="ij")
    ax = 0 if len(shape) == 3 else 1
    noisy = grids[ax] >= shape[ax] // 2
    plane = 0.01 * sum((k + 1) * g for k, g in enumerate(grids))
    x = np.where(noisy, plane + 0.2 * rng.standard_normal(shape),
                 plane + np.sin(0.2 * sum(grids)))
    return x.astype(np.float32)


def _bs(shape):
    return regnd._spec(len(shape), np.float32).block_size


def _bits(a):
    return np.asarray(a, np.float32).view(np.uint32)


@pytest.mark.parametrize("shape", SHAPES)
def test_geom_small_matches(shape):
    a = geo.geom_small(shape, _bs(shape))
    b = jeng._geom_small(shape, _bs(shape))
    # the port has its own DimBlocks class: compare the fields
    assert [dataclasses.astuple(d) for d in a["dbs"]] == \
        [dataclasses.astuple(d) for d in b["dbs"]]
    assert a["nblocks"] == b["nblocks"]
    for key in ("loc", "bid", "cnt"):
        for x, y in zip(a[key], b[key]):
            np.testing.assert_array_equal(x, y)
    np.testing.assert_array_equal(a["offsets"], b["offsets"])


@pytest.mark.parametrize("shape", SHAPES)
def test_coeff_sums_and_finalize_match(shape):
    data = _field(shape, 1)
    bs = _bs(shape)
    got = stages.coeff_sums(torch.from_numpy(data), bs).numpy()
    ref = np.asarray(jeng._coeff_sums_fn(shape, "float32", bs, "cpu")(data))
    np.testing.assert_array_equal(_bits(got), _bits(ref))
    np.testing.assert_array_equal(
        _bits(stages.finalize_coeffs(got, shape, bs)),
        _bits(jeng._finalize_coeffs(ref, shape, bs, np.float32)))


@pytest.mark.parametrize("use_mean", [False, True])
@pytest.mark.parametrize("shape", SHAPES)
def test_select_matches(shape, use_mean):
    data = _field(shape, 2)
    bs = _bs(shape)
    sums = stages.coeff_sums(torch.from_numpy(data), bs).numpy()
    coeffs = stages.finalize_coeffs(sums, shape, bs)
    rp = np.float32(1e-3)
    noise = np.float32(np.float64(rp) * regnd._spec(len(shape),
                                                    np.float32).noise_factor)
    mean = np.float32(0.125)
    got = stages.select(torch.from_numpy(data), torch.from_numpy(coeffs),
                        noise, mean, use_mean, bs).numpy()
    ref = np.asarray(jeng._select_fn(shape, "float32", bs, use_mean, "cpu")(
        data, coeffs, noise, mean))
    np.testing.assert_array_equal(got, ref)
    assert 0 < got.sum() < got.size   # both predictors are chosen somewhere


@pytest.mark.parametrize("shape", SHAPES)
def test_corner_stream_roundtrip_matches(shape):
    dbs = geo.geom_small(shape, _bs(shape))["dbs"]
    n = int(np.prod(shape))
    x = np.arange(n, dtype=np.int32).reshape(shape)
    got = geo.corner_stream(torch.from_numpy(x), dbs).numpy()
    ref = np.asarray(jeng._corner_stream(jnp.asarray(x), tuple(dbs), shape))
    np.testing.assert_array_equal(got, ref)
    back = geo.corner_unstream(torch.from_numpy(got), dbs, shape).numpy()
    np.testing.assert_array_equal(
        back, np.asarray(jeng._corner_unstream(jnp.asarray(ref), tuple(dbs),
                                               shape)))
    np.testing.assert_array_equal(back, x)


@pytest.mark.parametrize("shape", SHAPES)
def test_pos_to_lat_matches(shape):
    dbs = geo.geom_small(shape, _bs(shape))["dbs"]
    n = int(np.prod(shape))
    pos = np.arange(n + 3, dtype=np.int32)
    got = geo.pos_to_lat(torch.from_numpy(pos), dbs, shape).numpy()
    ref = np.asarray(jeng._pos_to_lat_expr(jnp.asarray(pos), tuple(dbs),
                                           shape))
    np.testing.assert_array_equal(got, ref)
    # the closed form inverts the stream order
    stream = geo.corner_stream(torch.arange(n).reshape(shape), dbs).numpy()
    np.testing.assert_array_equal(got[:n], stream)


@pytest.mark.parametrize("shape", SHAPES[:1] + SHAPES[2:3])
def test_escape_values_matches(shape):
    """Escape gather over the compact stream vs engine._escapes2_fn."""
    data = _field(shape, 3)
    dbs = geo.geom_small(shape, _bs(shape))["dbs"]
    rng = np.random.default_rng(4)
    t = rng.integers(0, 4, shape).astype(np.int32)
    tp = geo.corner_stream(torch.from_numpy(t), dbs)
    got = stages.escape_values(torch.from_numpy(data), tp, dbs).numpy()
    k = int((t == 0).sum())
    ref = np.asarray(jeng._escapes2_fn(shape, "float32", _bs(shape),
                                       jeng._pad_pow2(k), "cpu")(
        data, jnp.asarray(tp.numpy())))[:k]
    np.testing.assert_array_equal(_bits(got), _bits(ref))
