"""The port's random-access block codec on the CPU against sz_tpu.

- the plain K12/K13 (``gpu.ra_kernel`` on CPU tensors) against the JAX
  package's ``ra_engine.encode_blocks`` / ``decode_blocks`` (XLA scans on
  the CPU backend) and against ``rablock``'s host codec (its numpy
  oracle), type lattice for type lattice, reconstruction for
  reconstruction (theirs de-blocked and cropped with numpy);
- the 1-D integer codec (``core.intc`` through ``framing``) against
  ``sz_tpu.compress`` / ``decompress`` of int32 and uint16 arrays;
- the host container (``core.rablock``) against ``sz_tpu.core.rablock``;
- ``sz_tpu_torch.compress`` / ``decompress`` / ``decompress_region``
  against ``sz_tpu``'s at ranks 1-3, regions across block edges, and
  float64 with ``random_access`` (the classic codec, as in sz_tpu).

Inputs from numpy seeds.  Tolerance: exact -- equal bytes, equal bits.
"""

import dataclasses

import numpy as np
import pytest
import torch
torch.set_num_threads(1)  # xdist workers share the cores: one thread each

import sz_tpu
from sz_tpu import config as jcfg
from sz_tpu.core import optimizer as jopt
from sz_tpu.core import rablock as jrb

import sz_tpu_torch
from sz_tpu_torch import framing
from sz_tpu_torch.config import ErrorBoundMode, SZConfig
from sz_tpu_torch.core import optimizer as topt
from sz_tpu_torch.core import rablock
from sz_tpu_torch.gpu import ra_engine, ra_kernel

CPU = torch.device("cpu")


def _field(shape, seed, mean_share=0.0):
    """A random walk with noise; ``mean_share`` of the points set to one
    value (the optimizer then turns the mean flush on); ``mean_share``
    None: white noise (under a tiny bound most points escape)."""
    rng = np.random.default_rng(seed)
    n = int(np.prod(shape))
    if mean_share is None:
        return rng.standard_normal(shape).astype(np.float32)
    x = (np.cumsum(rng.standard_normal(n)) * 0.01
         + rng.uniform(-2e-3, 2e-3, n)).astype(np.float32)
    x[rng.random(n) < mean_share] = np.float32(0.25)
    return x.reshape(shape)


def _jconfig(cfg):
    jc = jcfg.SZConfig(**{f.name: getattr(cfg, f.name)
                          for f in dataclasses.fields(cfg)
                          if hasattr(jcfg.SZConfig, f.name)})
    return dataclasses.replace(jc, engine="numpy")


# (shape, seed, share of one value, bound): each rank, edge blocks
# padded, the mean flush on, white noise under a bound that most points
# escape
CASES = [((12, 20, 25), 1, 0.0, 1e-3), ((13, 14, 20), 2, 0.6, 1e-3),
         ((40, 50), 3, 0.0, 1e-3), ((37, 33), 4, 0.6, 1e-3),
         ((3000,), 5, 0.0, 1e-3), ((1000,), 6, 0.6, 1e-3),
         ((12, 12, 18), 7, None, 1e-7)]
IDS = ["3d", "3d_mean", "2d", "2d_mean", "1d", "1d_mean", "3d_1e-7"]


def _prepared(shape, seed, share, rp):
    x = _field(shape, seed, share)
    p = rablock.prepare(x, rp, SZConfig(random_access=True))
    return x, p


@pytest.mark.parametrize("shape,seed,share,rp", CASES, ids=IDS)
def test_prepare_matches_host_stages(shape, seed, share, rp):
    """Padding, coefficients, optimizer, mean, selection and coefficient
    chain against sz_tpu.core.rablock's."""
    x, p = _prepared(shape, seed, share, rp)
    rank, bs = x.ndim, p.bs
    blocks = jrb._padded_blocks(x, bs)
    np.testing.assert_array_equal(p.blocks, blocks)
    coeffs = jrb._reg_coeffs(blocks, rank, bs)
    np.testing.assert_array_equal(rablock._reg_coeffs(blocks, rank, bs)
                                  .view(np.uint32), coeffs.view(np.uint32))
    ind = jrb._select(blocks, coeffs, rank, bs,
                      np.float32(np.float64(rp) * jrb.NOISE_FACTOR[rank]),
                      p.use_mean, p.mean)
    np.testing.assert_array_equal(p.indicator, ind)
    ct, cu, qc = jrb._coeff_chain(coeffs[~ind], p.precision)
    np.testing.assert_array_equal(p.ctypes, ct)
    for a, b in zip(p.cunpred, cu):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b, np.float32))
    np.testing.assert_array_equal(p.qc_full[~ind].view(np.uint32),
                                  qc.view(np.uint32))
    assert p.use_mean or not share


def _encode_args(p, rank, rp):
    return (rank, p.bs, rp, p.intervals, p.intervals // 2, p.use_mean,
            p.mean)


def _escapes(p, types):
    """The stream's escapes (raster order, block by block) and each
    block's first, as the container carries them."""
    esc = types == 0
    base = np.concatenate([[0], np.cumsum(esc.sum(axis=1))[:-1]])
    return p.blocks.reshape(len(types), -1)[esc], base


def _deblock(vals, grid, lo, ext, bs):
    """(nsel, bs^rank) block values in raster order over ``grid`` -> the
    region of extents ``ext`` at offset ``lo``, in numpy."""
    rank = len(grid)
    perm = [p for d in range(rank) for p in (d, rank + d)]
    full = vals.reshape(*grid, *([bs] * rank)).transpose(perm).reshape(
        [g * bs for g in grid])
    return full[tuple(slice(a, a + e) for a, e in zip(lo, ext))]


@pytest.mark.parametrize("shape,seed,share,rp", CASES, ids=IDS)
def test_plain_k12_k13_match_host_codec(shape, seed, share, rp):
    x, p = _prepared(shape, seed, share, rp)
    nb, rank = p.blocks.shape[0], x.ndim
    b = torch.from_numpy(p.blocks.reshape(nb, -1))
    lor = torch.from_numpy(p.indicator.astype(np.uint8))
    qc = torch.from_numpy(p.qc_full)
    types = ra_kernel.ra_encode(b, lor, qc, *_encode_args(p, rank, rp))
    want = jrb._encode_blocks_np(p.blocks, p.indicator, p.qc_full, rank,
                                 p.bs, rp, p.intervals, p.use_mean, p.mean)
    np.testing.assert_array_equal(types.numpy(), want)
    esc = want == 0
    assert (~esc).any()
    if rp < 1e-6:
        assert esc.mean() > 0.5
    unpred, base = _escapes(p, want)
    sel, grid, lo, ext = rablock.region_blocks(shape, p.bs, (0,) * rank,
                                               shape)
    assert (sel == np.arange(nb)).all() and ext == shape
    out = ra_engine.decode_blocks(want, rank, p.bs, p.indicator, p.qc_full,
                                  rp, p.intervals // 2, p.use_mean, p.mean,
                                  unpred, base, grid, lo, ext, device=CPU)
    host = jrb._decode_blocks_np(want, nb, rank, p.bs, p.indicator,
                                 ~p.indicator, p.qc_full, np.float64(rp),
                                 p.intervals // 2, p.use_mean, p.mean,
                                 unpred, base)
    host = _deblock(host, grid, lo, ext, p.bs)
    assert out.shape == x.shape
    np.testing.assert_array_equal(out.numpy().view(np.uint32),
                                  host.view(np.uint32))
    assert np.abs(out.numpy().astype(np.float64) - x).max() <= rp


@pytest.mark.parametrize("case", [0, 3, 4], ids=["3d_mean_off", "2d_mean",
                                                  "1d"])
def test_plain_k12_k13_match_jax_engine(case):
    """The XLA scans of sz_tpu.tpu.ra_engine on the CPU backend; the
    decode on a region's blocks (a strided selection), whose JAX lattice
    is de-blocked and cropped with numpy."""
    from sz_tpu.tpu import ra_engine as jra
    shape, seed, share, rp = CASES[case]
    x, p = _prepared(shape, seed, share, rp)
    nb, rank = p.blocks.shape[0], x.ndim
    want = jra.encode_blocks(p.blocks, p.indicator, p.qc_full, rank, p.bs,
                             rp, p.intervals, p.use_mean,
                             p.mean).reshape(nb, -1)
    (t_dev,) = ra_engine.encode_blocks(p.blocks, p.indicator, p.qc_full,
                                       rank, p.bs, rp, p.intervals,
                                       p.use_mean, p.mean, device=CPU)
    np.testing.assert_array_equal(t_dev.numpy(), want)
    unpred, base = _escapes(p, want)
    start = tuple(min(p.bs + 1, r - 1) for r in shape)
    end = tuple(r - 1 for r in shape)
    sel, grid, lo, ext = rablock.region_blocks(shape, p.bs, start, end)
    assert len(sel) < nb and all(a > 0 for a in lo)
    jout = jra.decode_blocks(want[sel], rank, p.bs, p.indicator[sel],
                             p.qc_full[sel], rp, p.intervals // 2,
                             p.use_mean, p.mean, unpred, base[sel])
    out = ra_engine.decode_blocks(want[sel], rank, p.bs, p.indicator[sel],
                                  p.qc_full[sel], rp, p.intervals // 2,
                                  p.use_mean, p.mean, unpred, base[sel],
                                  grid, lo, ext, device=CPU)
    np.testing.assert_array_equal(
        out.numpy().view(np.uint32),
        _deblock(np.asarray(jout), grid, lo, ext, p.bs).view(np.uint32))


def test_optimizer_1d_matches():
    x = _field((5000,), 8, 0.3)
    want = jopt.optimize_intervals_1d_freq_dense(
        x, 5000, 1e-3, 32768, 100, np.float32(0.99), T=np.float32)
    got = topt.optimize_intervals_1d_freq_dense(
        x, 5000, 1e-3, 32768, 100, np.float32(0.99), T=np.float32)
    assert [float(v) for v in got] == [float(v) for v in want]


_INT_CASES = [
    (np.int32, lambda r: r.integers(0, 40, 500)),
    (np.uint16, lambda r: r.integers(0, 700, 777)),
    (np.int32, lambda r: r.integers(-3, 3, 2000) * 1000),
    (np.int32, lambda r: np.cumsum(r.integers(-5, 6, 3000))),
    (np.uint16, lambda r: np.full(50, 7)),
    (np.int32, lambda r: np.array([5, 9])),
    (np.uint16, lambda r: r.integers(0, 65535, 40)),
]


@pytest.mark.parametrize("k", range(len(_INT_CASES)))
def test_int_streams_match_sz_tpu(k):
    """The nested streams: 1-D int32 and uint16 under ABS 0.5 (also a
    constant array, two values, and the verbatim fallback), byte-equal
    streams, equal decodes; a lossless-off config as well."""
    dt, make = _INT_CASES[k]
    x = make(np.random.default_rng(k)).astype(dt)
    for cfg in (SZConfig(), SZConfig(sz_mode=0)):
        cfg = cfg.with_bound(ErrorBoundMode.ABS, 0.5)
        blob = sz_tpu.compress(x, _jconfig(cfg))
        assert framing._compress_int(x, cfg, CPU) == blob
        got = framing._decompress_int(blob, x.size, dt, CPU)
        want = sz_tpu.decompress(blob, x.shape, dt)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("shape,seed,share,rp", CASES, ids=IDS)
def test_container_matches_sz_tpu(shape, seed, share, rp):
    x = _field(shape, seed, share)
    cfg = SZConfig(random_access=True).with_bound(ErrorBoundMode.ABS, rp)
    want = jrb.compress_ra(x, rp, _jconfig(cfg))
    got = rablock.compress_ra(x, rp, cfg, device=CPU)
    assert got.body == want.body
    assert (got.use_mean, got.reg_count, got.total_unpred) == (
        want.use_mean, want.reg_count, want.total_unpred)
    out = rablock.decompress_ra(got.body, shape, device=CPU)
    ref = jrb.decompress_ra(want.body, shape)
    np.testing.assert_array_equal(out.view(np.uint32), ref.view(np.uint32))


@pytest.mark.parametrize("shape,region", [
    ((12, 20, 25), ((1, 5, 7), (11, 19, 25))),
    ((40, 50), ((15, 17), (33, 49))),
    ((3000,), ((255,), (2049,))),
], ids=["3d", "2d", "1d"])
def test_api_and_region_match_sz_tpu(shape, region):
    """compress / decompress, and decompress_region of a region whose
    faces cross blocks, against sz_tpu; the region also equals the whole
    decode's."""
    x = _field(shape, 9)
    cfg = SZConfig(random_access=True).with_bound(ErrorBoundMode.ABS, 1e-3)
    blob = sz_tpu.compress(x, _jconfig(cfg))
    assert sz_tpu_torch.compress(x, cfg, device="cpu") == blob
    whole = sz_tpu_torch.decompress(blob, shape, device="cpu")
    want = sz_tpu.decompress(blob, shape, np.float32)
    np.testing.assert_array_equal(whole.view(np.uint32), want.view(np.uint32))
    got = sz_tpu_torch.decompress_region(blob, shape, *region, device="cpu")
    ref = sz_tpu.decompress_region(blob, shape, *region)
    assert got.shape == ref.shape
    np.testing.assert_array_equal(got.view(np.uint32), ref.view(np.uint32))
    corner = whole[tuple(slice(a, b) for a, b in zip(*region))]
    np.testing.assert_array_equal(got, corner)
    t = sz_tpu_torch.decompress_region(blob, shape, *region, device="cpu",
                                       as_tensor=True)
    assert torch.is_tensor(t)
    np.testing.assert_array_equal(t.numpy(), got)


def test_region_of_another_stream_raises():
    x = _field((12, 20, 25), 10)
    blob = sz_tpu_torch.compress(
        x, SZConfig().with_bound(ErrorBoundMode.ABS, 1e-3), device="cpu")
    with pytest.raises(ValueError, match="random-access stream"):
        sz_tpu_torch.decompress_region(blob, x.shape, (0, 0, 0), (4, 4, 4),
                                       device="cpu")


@pytest.mark.parametrize("shape", [(2000,), (30, 41), (10, 11, 12)],
                         ids=["1d", "2d", "3d"])
def test_float64_random_access_matches_sz_tpu(shape):
    """Float64 has no random-access codec: the flag takes the classic
    codec (the 1-D codec on rank 1, classic_nd on ranks 2-3), as
    sz_tpu/api.py:332 falls through."""
    x = _field(shape, 11).astype(np.float64) * np.pi
    cfg = SZConfig(random_access=True).with_bound(ErrorBoundMode.ABS, 1e-4)
    blob = sz_tpu.compress(x, _jconfig(cfg))
    assert sz_tpu_torch.compress(x, cfg, device="cpu") == blob
    got = sz_tpu_torch.decompress(blob, shape, np.float64, device="cpu")
    want = sz_tpu.decompress(blob, shape, np.float64, engine="numpy")
    np.testing.assert_array_equal(got.view(np.uint64), want.view(np.uint64))


def test_tensor_input_downloads():
    """A tensor under random access compresses to the host array's
    bytes (it is downloaded first)."""
    x = _field((13, 14, 20), 12)
    cfg = SZConfig(random_access=True).with_bound(ErrorBoundMode.ABS, 1e-3)
    assert sz_tpu_torch.compress(torch.from_numpy(x), cfg, device="cpu") == \
        sz_tpu_torch.compress(x, cfg, device="cpu")
