"""The float64 PW_REL oracle constants of chip_smoke.py's main-path
phase: its float64 PW_REL fields, compressed and decoded by the host
oracle (sz_tpu, engine="numpy"), hash to the SHA-256 values chip_smoke.py
holds the port to on the card (K8d, K9d).  The fields are exact in
float64 (``field64``, zeroed where ``field`` is, or its magnitude plus
2^-6), so they are the same bits on any machine.  Tolerance: exact
(equal hashes).
"""

import numpy as np
import pytest
import torch
torch.set_num_threads(1)  # xdist workers share the cores: one thread each

import sz_tpu
from sz_tpu.config import ErrorBoundMode, SZConfig

from _chip_smoke import SMOKE


@pytest.mark.parametrize("name", sorted(SMOKE.ORACLE_PWREL64))
def test_pwrel64_oracle_hashes(name):
    kind, shape, seed, want_stream, want_recon = SMOKE.ORACLE_PWREL64[name]
    x = SMOKE.pwrel_field64(kind, shape, seed)
    assert x.dtype == np.float64 and x.shape == shape
    cfg = SZConfig(engine="numpy").with_bound(ErrorBoundMode.PW_REL,
                                              SMOKE.PW_REL)
    blob = sz_tpu.compress(x, cfg)
    out = sz_tpu.decompress(blob, shape, np.float64, engine="numpy")
    print(name, SMOKE.sha256(blob), SMOKE.sha256(out.tobytes()))
    assert SMOKE.sha256(blob) == want_stream
    assert SMOKE.sha256(out.tobytes()) == want_recon
    SMOKE.pointwise_err(x, out)


def test_pwrel64_fields_are_exact():
    """The signed field is field64 with field's zeros (so it has zeros
    and negative values); the positive one |field64| + 2^-6, exact."""
    for kind, shape, seed, _, _ in SMOKE.ORACLE_PWREL64.values():
        x = SMOKE.pwrel_field64(kind, shape, seed)
        f = SMOKE.field64(shape, seed)
        if kind == "signed":
            zero = SMOKE.field(shape, seed) == 0
            np.testing.assert_array_equal(x, np.where(zero, 0.0, f))
            assert zero.any() and (x < 0).any()
        else:
            np.testing.assert_array_equal(x - 2.0 ** -6, np.abs(f))
            assert (x > 0).all()
