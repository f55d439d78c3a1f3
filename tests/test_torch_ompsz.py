"""The sz_omp byte format (``sz_tpu_torch.parallel.ompsz``, the host
runtime's block codec on a thread pool) against ``sz_tpu.parallel.ompsz``:
float32 and float64 fields, thread counts 1, 4 and 8 (blocks of unequal
extents), fixed and optimised intervals; the streams and the decodes of
either package's stream.  Equal bytes, equal bits.
"""

import numpy as np
import pytest
import torch
torch.set_num_threads(1)  # xdist workers share the cores: one thread each

from sz_tpu.config import SZConfig as JConfig
from sz_tpu.parallel import ompsz as jomp

from sz_tpu_torch import native
from sz_tpu_torch.config import SZConfig as TConfig
from sz_tpu_torch.parallel import ompsz as tomp


def _field(shape, dtype, seed=3):
    rng = np.random.default_rng(seed)
    axes = [np.linspace(0, 4 * np.pi, n) for n in shape]
    g = np.meshgrid(*axes, indexing="ij")
    f = np.sin(g[0]) * np.cos(g[1]) * np.cos(g[2])
    return (f + 0.05 * rng.standard_normal(shape)).astype(dtype)


@pytest.mark.parametrize("threads", [1, 4, 8])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("shape", [(24, 20, 17), (33, 40, 27)], ids=str)
def test_omp_bytes_and_decode_match(threads, dtype, shape):
    data = _field(shape, dtype)
    want = jomp.compress_omp(data, 1e-3, threads, JConfig())
    got = tomp.compress_omp(data, 1e-3, threads, TConfig())
    assert got == want
    out = tomp.decompress_omp(want, shape, dtype)
    ref = jomp.decompress_omp(want, shape, dtype)
    np.testing.assert_array_equal(out.view(np.uint8), ref.view(np.uint8))
    assert np.abs(out.astype(np.float64) - data).max() <= 1e-3 * (1 + 1e-6)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_omp_fixed_intervals_and_escapes(dtype):
    data = _field((20, 22, 24), dtype, 5) * 50
    want = jomp.compress_omp(data, 1e-4, 8,
                             JConfig(quantization_intervals=64))
    got = tomp.compress_omp(data, 1e-4, 8,
                            TConfig(quantization_intervals=64))
    assert got == want
    np.testing.assert_array_equal(
        tomp.decompress_omp(got, data.shape, dtype),
        jomp.decompress_omp(got, data.shape, dtype))


def test_thread_grid_and_block_ranges():
    for t in (1, 2, 4, 8, 16, 32, 64):
        assert tomp.thread_grid(t) == jomp.thread_grid(t)
    for r, k in [(17, 4), (40, 8), (5, 8), (64, 2)]:
        assert tomp._block_ranges(r, k) == jomp._block_ranges(r, k)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_block_codec_matches_sz_tpu_native(dtype):
    from sz_tpu import native as jnative
    blk = _field((9, 11, 13), dtype, 7)
    t, u = native.ompblock_encode(blk, dtype(2e-3), 128, 64)
    jt, ju = jnative.ompblock_encode(blk, dtype(2e-3), 128, 64)
    np.testing.assert_array_equal(t, jt)
    np.testing.assert_array_equal(u, ju)
    out = native.ompblock_decode(t, blk.shape, blk.flat[0], dtype(2e-3), 64,
                                 u, dtype)
    np.testing.assert_array_equal(
        out, jnative.ompblock_decode(jt, blk.shape, blk.flat[0],
                                     dtype(2e-3), 64, ju, dtype))
