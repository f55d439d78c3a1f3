"""The temporal oracle constants of chip_smoke.py's main-path phase: its
chain (TS_VARS: float32 on Hurricane ISABEL's grid, float64 on
CESM-ATM's; ABS 1e-3; snapshots at steps 0 and 5, temporal steps 1-4),
compressed and decoded by the host oracle (sz_tpu.temporal with
engine="numpy"), hashes to the SHA-256 values chip_smoke.py holds the
port to on the card (K14, K15).  The steps use exact arithmetic only
(``ts_step``), so they are the same bits on any machine.  Tolerance:
exact (equal hashes).
"""

import multiprocessing

import numpy as np
import torch
torch.set_num_threads(1)  # xdist workers share the cores: one thread each

from sz_tpu.config import ErrorBoundMode, SZConfig
from sz_tpu.temporal import TemporalCompressor

from _chip_smoke import SMOKE


def _chain() -> list:
    """The chain at full size: per step the frame's hash, the decodes'
    hashes, each variable's compression type, dtype and maximum error."""
    cfg = SZConfig(engine="numpy").with_bound(ErrorBoundMode.ABS, SMOKE.ABS)
    enc = TemporalCompressor(SMOKE.TS_SNAPSHOT_STEP)
    dec = TemporalCompressor(SMOKE.TS_SNAPSHOT_STEP)
    x0 = {}
    for vid, (name, make, shape, seed) in SMOKE.TS_VARS.items():
        x0[vid] = make(shape, seed)
        for c in (enc, dec):
            c.register(vid, name, shape, x0[vid].dtype, cfg)
    steps = []
    for s in range(len(SMOKE.ORACLE_TEMPORAL)):
        step = {vid: SMOKE.ts_step(x, s, SMOKE.TS_VARS[vid][3])
                for vid, x in x0.items()}
        frame = enc.compress_step(step)
        out = dec.decompress_step(frame)
        steps.append((
            SMOKE.sha256(frame),
            {vid: SMOKE.sha256(o.tobytes()) for vid, o in out.items()},
            [enc.vars[vid].compress_type for vid in x0],
            {vid: (out[vid].dtype == x.dtype, float(np.abs(
                out[vid].astype(np.float64) - x).max()))
             for vid, x in step.items()}))
        del step, frame, out
    return steps


def test_temporal_oracle_hashes():
    """The chain runs in a process of its own (spawned), which returns
    its 2.7 GB peak when it ends: the xdist worker that runs this test
    keeps no such heap for the tests after it (the suite's conftest stops
    malloc from trimming), and a process killed for memory fails this
    test alone, not the worker."""
    with multiprocessing.get_context("spawn").Pool(1) as pool:
        steps = pool.apply(_chain)
    kinds = []
    for s, (want, got) in enumerate(zip(SMOKE.ORACLE_TEMPORAL, steps)):
        want_frame, want_dec = want
        frame, decodes, kind, errs = got
        print(s, frame, decodes)
        kinds.append(kind)
        assert frame == want_frame, f"step {s}"
        assert decodes == want_dec, f"step {s}"
        for same_dtype, err in errs.values():
            assert same_dtype
            assert err <= SMOKE.ABS
    assert len(steps) == len(SMOKE.ORACLE_TEMPORAL)
    assert kinds == [[0, 0], [1, 1], [1, 1], [1, 1], [1, 1], [0, 0]]
