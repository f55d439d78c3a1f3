"""The float64 oracle constants of chip_smoke.py's main-path phase: its
float64 fields (chip_smoke.field64), compressed and decoded by the host
oracle (sz_tpu, engine="numpy") under ABS 1e-3, hash to the SHA-256
values chip_smoke.py holds the port to on the card.  The fields use
exact float64 arithmetic only, so they are the same bits on any
machine.  Tolerance: exact (equal hashes).
"""

import numpy as np
import pytest
import torch
torch.set_num_threads(1)  # xdist workers share the cores: one thread each

import sz_tpu
from sz_tpu.config import ErrorBoundMode, SZConfig

from _chip_smoke import SMOKE


@pytest.mark.parametrize("name", sorted(SMOKE.ORACLE_F64))
def test_oracle_hashes_f64(name):
    shape, seed, want_stream, want_recon = SMOKE.ORACLE_F64[name]
    x = SMOKE.field64(shape, seed)
    assert x.dtype == np.float64 and x.shape == shape
    cfg = SZConfig(engine="numpy").with_bound(ErrorBoundMode.ABS,
                                              SMOKE.ABS)
    blob = sz_tpu.compress(x, cfg)
    assert SMOKE.sha256(blob) == want_stream
    out = sz_tpu.decompress(blob, shape, np.float64, engine="numpy")
    assert SMOKE.sha256(out.tobytes()) == want_recon
    assert np.abs(out - x).max() <= SMOKE.ABS


@pytest.mark.parametrize("shape,seed", [((256, 256, 256), 42),
                                        ((1800, 3600), 6), ((64, 48, 40), 1)])
def test_field64_uses_exact_float64_arithmetic(shape, seed):
    """field64 is field (exact float32 values) plus integers times 2^-40:
    subtracting either part gives the other back exactly, and the
    remainder is a multiple of 2^-40 below 2^-20, so no operation
    rounded."""
    x = SMOKE.field64(shape, seed)
    base = SMOKE.field(shape, seed).astype(np.float64)
    fine = x - base
    np.testing.assert_array_equal(x - fine, base)
    k = fine * 2.0 ** 40
    np.testing.assert_array_equal(k, np.round(k))
    assert np.abs(k).max() <= 2 ** 20
    rng = np.random.default_rng(seed + 1000)
    np.testing.assert_array_equal(
        k, rng.integers(-2 ** 20, 2 ** 20 + 1, shape).astype(np.float64))
    # bits below float32's: the field is not a float32 field widened
    assert (x.astype(np.float32).astype(np.float64) != x).mean() > 0.9
