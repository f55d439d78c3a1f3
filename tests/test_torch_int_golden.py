"""The reference binary's integer goldens (testint_compress, ABS 4 via
int.config; ``tests/golden/int_*``) through the PyTorch port on the CPU:
its stream of each golden's data equals the golden's inner stream (the
params' fmin/fmax, unset for integers, aside: ``test_golden_int._norm``)
and its decode of the golden equals the reference's ``.out``; the 4-D
one holds the reference's stale-value cell at position 1 of every
slice.  Tolerance: exact.
"""

import numpy as np
import pytest
import torch
torch.set_num_threads(1)  # xdist workers share the cores: one thread each

import sz_tpu_torch
from sz_tpu_torch.config import ErrorBoundMode, SZConfig
from sz_tpu_torch.format import lossless

from test_golden_int import CASES, IDS, _load, _norm


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_inner_stream_equals_golden(case):
    data, golden_sz, _ = _load(case)
    cfg = SZConfig().with_bound(ErrorBoundMode.ABS, 4)
    ours = sz_tpu_torch.compress(data, cfg, device="cpu")
    cap = data.nbytes * 4 + 128
    assert _norm(lossless.decompress(ours, expected_size=cap)) == \
        _norm(lossless.decompress(golden_sz, expected_size=cap))


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_decode_equals_golden_out(case):
    data, golden_sz, golden_out = _load(case)
    out = sz_tpu_torch.decompress(golden_sz, data.shape, data.dtype,
                                  device="cpu")
    assert out.dtype == golden_out.dtype
    np.testing.assert_array_equal(out, golden_out)
    t = sz_tpu_torch.decompress(golden_sz, data.shape, data.dtype,
                                device="cpu", as_tensor=True)
    assert t.numpy().tobytes() == golden_out.tobytes()
