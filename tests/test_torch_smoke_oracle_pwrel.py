"""The PW_REL oracle constants of chip_smoke.py's main-path phase: its
PW_REL input fields, compressed and decoded by the host oracle (sz_tpu,
engine="numpy"), hash to the SHA-256 values chip_smoke.py holds the
port to on the card.  The fields use exact float32 arithmetic only
(``field`` plus ``abs`` and the addition of 2^-6), so they are the same
bits on any machine; the precision table is libm ``pow`` of the host, so
its hash is printed for a comparison across machines.  Tolerance: exact
(equal hashes).
"""

import numpy as np
import pytest
import torch
torch.set_num_threads(1)  # xdist workers share the cores: one thread each

import sz_tpu
from sz_tpu.config import ErrorBoundMode, SZConfig
from sz_tpu.core import pwr

from _chip_smoke import SMOKE


@pytest.mark.parametrize("name", sorted(SMOKE.ORACLE_PWREL))
def test_pwrel_oracle_hashes(name):
    kind, shape, seed, want_stream, want_recon = SMOKE.ORACLE_PWREL[name]
    x = SMOKE.pwrel_field(kind, shape, seed)
    assert x.dtype == np.float32 and x.shape == shape
    cfg = SZConfig(engine="numpy").with_bound(ErrorBoundMode.PW_REL,
                                              SMOKE.PW_REL)
    blob = sz_tpu.compress(x, cfg)
    out = sz_tpu.decompress(blob, shape, np.float32, engine="numpy")
    print(name, SMOKE.sha256(blob), SMOKE.sha256(out.tobytes()))
    assert SMOKE.sha256(blob) == want_stream
    assert SMOKE.sha256(out.tobytes()) == want_recon
    SMOKE.pointwise_err(x, out)


def test_pwrel_fields_use_exact_float32_arithmetic():
    """abs and + 2^-6 of a field (itself exact) round nowhere."""
    for kind, shape, seed, _, _ in SMOKE.ORACLE_PWREL.values():
        x = SMOKE.pwrel_field(kind, shape, seed)
        f = SMOKE.field(shape, seed).astype(np.float64)
        want = f if kind == "signed" else np.abs(f) + 2.0 ** -6
        np.testing.assert_array_equal(x.astype(np.float64), want)
    signed = SMOKE.pwrel_field("signed", (256, 256, 256), 42)
    assert (signed == 0).any() and (signed < 0).any()


def test_precision_table_hash():
    """The libm pow table at the interval counts the PW_REL cases use;
    printed so a stream mismatch on another machine can be traced."""
    for intervals in (1024, 4096, 65536):
        t = pwr._precision_table(intervals, SMOKE.PW_REL, 3)
        assert t.dtype == np.float64 and t.size == intervals
        print("precision table", intervals, SMOKE.sha256(t.tobytes()))
