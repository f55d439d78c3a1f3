"""The classic, 1-D and pre-log oracle constants of chip_smoke.py's
main-path phase: its fields (chip_smoke.classic_input, exact float32 and
float64 arithmetic, the same bits on any machine), compressed and
decoded by the host oracle (sz_tpu, engine="numpy") under each case's
bound, hash to the SHA-256 values chip_smoke.py holds the port to on the
card; so does sz_tpu's stream of synth_signed.dat under PW_REL 1e-3.
Tolerance: exact (equal hashes).
"""

import numpy as np
import pytest
import torch
torch.set_num_threads(1)  # xdist workers share the cores: one thread each

import sz_tpu
from sz_tpu.config import ErrorBoundMode, SZConfig

from _chip_smoke import REPO, SMOKE


@pytest.mark.parametrize("name", sorted(SMOKE.ORACLE_CLASSIC))
def test_oracle_hashes_classic(name):
    maker, shape, seed, (mode, value), over, want_stream, want_recon = \
        SMOKE.ORACLE_CLASSIC[name]
    x = SMOKE.classic_input(maker, shape, seed)
    assert x.size == int(np.prod(shape))
    cfg = SZConfig(engine="numpy", **over).with_bound(
        getattr(ErrorBoundMode, mode), value)
    blob = sz_tpu.compress(x, cfg)
    assert SMOKE.sha256(blob) == want_stream
    out = sz_tpu.decompress(blob, x.shape, x.dtype, engine="numpy")
    assert SMOKE.sha256(out.tobytes()) == want_recon


def test_synth_signed_hash():
    x = np.fromfile(REPO / "tests" / "golden" / "synth_signed.dat",
                    dtype="<f4")
    blob = sz_tpu.compress(x, SZConfig(engine="numpy").with_bound(
        ErrorBoundMode.PW_REL, 1e-3))
    assert SMOKE.sha256(blob) == SMOKE.SYNTH_SIGNED_SHA256
