"""The random-access oracle constants of chip_smoke.py's main-path
phase: its fields under ABS 1e-3 with ``random_access``, compressed and
decoded by the host oracle (sz_tpu, engine="numpy"), and the 64^3
corner decoded by ``sz_tpu.decompress_region``, hash to the SHA-256
values chip_smoke.py holds the port to on the card (K12, K13).  The
fields use exact float32 arithmetic only (``field``), so they are the
same bits on any machine.  Tolerance: exact (equal hashes).
"""

import numpy as np
import pytest
import torch
torch.set_num_threads(1)  # xdist workers share the cores: one thread each

import sz_tpu
from sz_tpu.config import ErrorBoundMode, SZConfig

from _chip_smoke import SMOKE


def _stream(name):
    maker, shape, seed, _, _ = SMOKE.ORACLE_RA[name]
    x = SMOKE.classic_input(maker, shape, seed)
    cfg = SZConfig(random_access=True, engine="numpy").with_bound(
        ErrorBoundMode.ABS, SMOKE.ABS)
    return x, sz_tpu.compress(x, cfg)


@pytest.mark.parametrize("name", sorted(SMOKE.ORACLE_RA))
def test_ra_oracle_hashes(name):
    want_stream, want_recon = SMOKE.ORACLE_RA[name][3:]
    x, blob = _stream(name)
    out = sz_tpu.decompress(blob, x.shape, np.float32, engine="numpy")
    print(name, SMOKE.sha256(blob), SMOKE.sha256(out.tobytes()))
    assert SMOKE.sha256(blob) == want_stream
    assert SMOKE.sha256(out.tobytes()) == want_recon
    assert np.abs(out.astype(np.float64) - x).max() <= SMOKE.ABS


def test_ra_region_oracle_hash():
    start, end, want = SMOKE.ORACLE_RA_REGION
    x, blob = _stream("ra_256")
    reg = sz_tpu.decompress_region(blob, x.shape, start, end)
    print("ra_256 region", SMOKE.sha256(reg.tobytes()))
    assert reg.shape == tuple(b - a for a, b in zip(start, end))
    assert SMOKE.sha256(reg.tobytes()) == want
    # the region's far faces lie inside blocks (6 does not divide 64)
    assert all(e % 6 for e in end)
