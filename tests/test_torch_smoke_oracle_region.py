"""The compress_region and ExaFEL oracle constants of chip_smoke.py's
surfaces phase: its regions of the Hurricane field (float32, rank 3), of
the CESM-ATM field64 (float64, rank 2) and of the flattened Hurricane
field (2^24 values, rank 1) under ABS 1e-3, compressed by
``sz_tpu.compress_region`` and decoded by ``sz_tpu.decompress`` with the
region's shape, and its ExaFEL case through ``sz_tpu.apps.exafel``, hash
to the SHA-256 values chip_smoke.py holds the port to on the card (K10's
subblock form; K1-K7 under ExaFEL's stream).  The inputs use exact
float32 arithmetic, so they are the same bits on any machine.  The
region's decode holds the bound where ORACLE_REGION says it does.
Tolerance: exact (equal hashes).
"""

import numpy as np
import pytest
import torch
torch.set_num_threads(1)  # xdist workers share the cores: one thread each

import sz_tpu
from sz_tpu.apps import exafel
from sz_tpu.config import ErrorBoundMode, SZConfig

from _chip_smoke import SMOKE


@pytest.mark.parametrize("name", sorted(SMOKE.ORACLE_REGION))
def test_region_oracle_hashes(name):
    maker, shape, seed, start, end, holds, want_stream, want_recon = \
        SMOKE.ORACLE_REGION[name]
    x = SMOKE.region_input(maker, shape, seed)
    cfg = SZConfig(engine="numpy").with_bound(ErrorBoundMode.ABS,
                                              SMOKE.ABS)
    blob = sz_tpu.compress_region(x, start, end, cfg)
    assert SMOKE.sha256(blob) == want_stream
    rshape = tuple(e - s for s, e in zip(start, end))
    out = sz_tpu.decompress(blob, rshape, x.dtype, engine="numpy")
    assert SMOKE.sha256(out.tobytes()) == want_recon
    region = x[tuple(slice(s, e) for s, e in zip(start, end))]
    err = np.abs(out.astype(np.float64) - region).max()
    assert (err <= SMOKE.ABS) == holds


def test_exafel_oracle_hashes():
    data, kw = SMOKE.exafel_inputs()
    assert data.shape == SMOKE.EXAFEL_SHAPE and data.dtype == np.float32
    pr = exafel.ExaFELConfig(**kw)
    blob = exafel.compress(pr, data)
    assert SMOKE.sha256(blob) == SMOKE.ORACLE_EXAFEL[0]
    out = exafel.decompress(pr, blob, *data.shape)
    assert SMOKE.sha256(out.tobytes()) == SMOKE.ORACLE_EXAFEL[1]
    mask = exafel._roi_mask(pr, *data.shape)
    np.testing.assert_array_equal(out[mask == 0], data[mask == 0])
