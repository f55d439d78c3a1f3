"""The oracle constants of chip_smoke.py's main-path phase: its input
fields, compressed and decoded by the host oracle (sz_tpu, engine="numpy"),
hash to the SHA-256 values chip_smoke.py holds the port to on the card.
The fields use exact float32 arithmetic only, so they are the same bits
on any machine.  Tolerance: exact (equal hashes).
"""

import importlib.util
import pathlib

import numpy as np
import pytest

import sz_tpu
from sz_tpu.config import ErrorBoundMode, SZConfig

REPO = pathlib.Path(__file__).resolve().parent.parent


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


SMOKE = _chip_smoke()


@pytest.mark.parametrize("name", sorted(SMOKE.ORACLE))
def test_oracle_hashes(name):
    shape, seed, want_stream, want_recon = SMOKE.ORACLE[name]
    x = SMOKE.field(shape, seed)
    assert x.dtype == np.float32 and x.shape == shape
    cfg = SZConfig(engine="numpy").with_bound(ErrorBoundMode.ABS,
                                              SMOKE.ABS)
    blob = sz_tpu.compress(x, cfg)
    assert SMOKE.sha256(blob) == want_stream
    out = sz_tpu.decompress(blob, shape, np.float32, engine="numpy")
    assert SMOKE.sha256(out.tobytes()) == want_recon
    assert np.abs(out.astype(np.float64) - x).max() <= SMOKE.ABS


def test_fields_use_exact_float32_arithmetic():
    """Each field equals the same formula evaluated in float64, so no
    float32 operation rounded."""
    cases = [(shape, seed) for shape, seed, _, _ in SMOKE.ORACLE.values()]
    # the 512^3 field's extremes along each axis pair, at little memory
    for shape, seed in cases + [((64, 48, 40), 1), ((512, 512, 2), 3),
                                ((512, 2, 512), 4)]:
        x = SMOKE.field(shape, seed)
        rng = np.random.default_rng(seed)
        half = [r // 2 for r in shape]
        axes = [(np.arange(r) - h).astype(np.float64)
                for r, h in zip(shape, half)]
        grids = np.meshgrid(*axes, indexing="ij", sparse=True)
        u, v, w = grids[0], grids[1], grids[-1]

        def p2(m):
            return 2.0 ** -int(np.ceil(np.log2(max(m, 2))))

        ref = (u * v * p2(half[0] * half[1]) + u * u * p2(half[0] ** 2)
               + w * p2(half[-1])
               + rng.integers(-100, 101, shape) * 2.0 ** -10)
        np.testing.assert_array_equal(x.astype(np.float64), ref)
