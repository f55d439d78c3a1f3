"""The multi-device oracle constants of chip_smoke.py (ORACLE_SLAB): its
fields under ABS 1e-3 cut into 4 slabs, compressed into the SZRA
container and decoded by the host oracle (``sz_tpu.ra``,
engine="numpy"), hash to the SHA-256 values chip_smoke.py holds the
port's compress_sharded / decompress_sharded and its four gloo ranks to
on the card.  The fields use exact arithmetic only (``field``,
``field64``), so they are the same bits on any machine.  Tolerance:
exact (equal hashes)."""

import numpy as np
import pytest
import torch
torch.set_num_threads(1)  # xdist workers share the cores: one thread each

from sz_tpu import ra
from sz_tpu.config import ErrorBoundMode, SZConfig

from _chip_smoke import SMOKE


@pytest.mark.parametrize("name", sorted(SMOKE.ORACLE_SLAB))
def test_slab_oracle_hashes(name):
    maker, shape, seed, n, want_blob, want_out = SMOKE.ORACLE_SLAB[name]
    x = SMOKE.classic_input(maker, shape, seed)
    cfg = SZConfig(engine="numpy").with_bound(ErrorBoundMode.ABS, SMOKE.ABS)
    blob = ra.compress(x, cfg, n_slabs=n)
    out = ra.decompress(blob, engine="numpy")
    print(name, SMOKE.sha256(blob), SMOKE.sha256(out.tobytes()))
    assert ra.Reader(blob).n_slabs == n
    assert SMOKE.sha256(blob) == want_blob
    assert SMOKE.sha256(out.tobytes()) == want_out
    assert np.abs(out.astype(np.float64) - x).max() <= SMOKE.ABS
