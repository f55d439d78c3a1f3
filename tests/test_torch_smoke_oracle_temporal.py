"""The temporal oracle constants of chip_smoke.py's main-path phase: its
chain (TS_VARS: float32 on Hurricane ISABEL's grid, float64 on
CESM-ATM's; ABS 1e-3; snapshots at steps 0 and 5, temporal steps 1-4),
compressed and decoded by the host oracle (sz_tpu.temporal with
engine="numpy"), hashes to the SHA-256 values chip_smoke.py holds the
port to on the card (K14, K15).  The steps use exact arithmetic only
(``ts_step``), so they are the same bits on any machine.  Tolerance:
exact (equal hashes).
"""

import numpy as np
import torch
torch.set_num_threads(1)  # xdist workers share the cores: one thread each

from sz_tpu.config import ErrorBoundMode, SZConfig
from sz_tpu.temporal import TemporalCompressor

from _chip_smoke import SMOKE


def test_temporal_oracle_hashes():
    cfg = SZConfig(engine="numpy").with_bound(ErrorBoundMode.ABS, SMOKE.ABS)
    enc = TemporalCompressor(SMOKE.TS_SNAPSHOT_STEP)
    dec = TemporalCompressor(SMOKE.TS_SNAPSHOT_STEP)
    x0 = {}
    for vid, (name, make, shape, seed) in SMOKE.TS_VARS.items():
        x0[vid] = make(shape, seed)
        for c in (enc, dec):
            c.register(vid, name, shape, x0[vid].dtype, cfg)
    kinds = []
    for s, (want_frame, want_dec) in enumerate(SMOKE.ORACLE_TEMPORAL):
        step = {vid: SMOKE.ts_step(x, s, SMOKE.TS_VARS[vid][3])
                for vid, x in x0.items()}
        frame = enc.compress_step(step)
        out = dec.decompress_step(frame)
        got = {vid: SMOKE.sha256(o.tobytes()) for vid, o in out.items()}
        print(s, SMOKE.sha256(frame), got)
        kinds.append([enc.vars[vid].compress_type for vid in x0])
        assert SMOKE.sha256(frame) == want_frame, f"step {s}"
        assert got == want_dec, f"step {s}"
        for vid, x in step.items():
            assert out[vid].dtype == x.dtype
            assert np.abs(out[vid].astype(np.float64) - x).max() <= SMOKE.ABS
    assert kinds == [[0, 0], [1, 1], [1, 1], [1, 1], [1, 1], [0, 0]]
