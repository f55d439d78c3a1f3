"""The integer oracle constants of chip_smoke.py's main-path phase: its
fields (chip_smoke.int_input: ``field`` scaled by a power of two and
rounded, the same values on any machine), compressed and decoded by the
host oracle (sz_tpu) under each case's bound, hash to the SHA-256 values
chip_smoke.py holds the port to on the card.  Tolerance: exact (equal
hashes).
"""

import numpy as np
import pytest
import torch
torch.set_num_threads(1)  # xdist workers share the cores: one thread each

import sz_tpu
from sz_tpu.config import ErrorBoundMode, SZConfig

from _chip_smoke import SMOKE


@pytest.mark.parametrize("name", sorted(SMOKE.ORACLE_INT))
def test_oracle_hashes_int(name):
    shape, seed, dt, (mode, value), want_stream, want_recon = \
        SMOKE.ORACLE_INT[name]
    x = SMOKE.int_input(shape, seed, dt)
    assert x.shape == shape and x.dtype == np.dtype(dt)
    blob = sz_tpu.compress(x, SZConfig(engine="numpy").with_bound(
        getattr(ErrorBoundMode, mode), value))
    assert SMOKE.sha256(blob) == want_stream
    out = sz_tpu.decompress(blob, x.shape, x.dtype)
    assert SMOKE.sha256(out.tobytes()) == want_recon


def test_int_field_is_exact():
    """int_field's values: field times 2^scale is an integer already
    (no rounding), and an unsigned type's offset lands its values about
    the middle of its range."""
    for dt, (scale, off) in SMOKE.INT_FIELD.items():
        f = SMOKE.field((9, 10, 11), 3).astype(np.float64) * 2.0 ** scale
        x = SMOKE.int_field((9, 10, 11), 3, dt)
        if scale >= 10:
            assert np.array_equal(np.rint(f), f)
        w = x.astype(np.int64) if dt != np.uint64 else \
            x.view(np.int64) ^ np.int64(-2 ** 63)
        assert np.array_equal(w - (off if dt != np.uint64 else 0),
                              np.rint(f).astype(np.int64))
