"""The port's MSST19 engine against the JAX package's
(``sz_tpu.tpu.msst19_engine``) on the CPU backend, with the softf64 chain
and the Pallas wavefront kernels forced on (interpret mode), as
``tests/test_msst19_soft.py`` runs them.  The bounds 1e-2 and 1e-3 lie
inside the Pallas kernels' envelope; 1e-4 and 1e-5, past it, are held to
the host codec in ``test_torch_msst19.py``.  Tolerance: exact -- equal
bytes, equal bits.
"""

import numpy as np
import pytest
import torch
torch.set_num_threads(1)  # xdist workers share the cores: one thread each

from sz_tpu.format import tdps as jtdps

from sz_tpu_torch.format import tdps as ttdps
from sz_tpu_torch.gpu import msst19_engine

from tests.test_msst19_engine import KW, synth
from tests.test_torch_msst19 import ENGINE_SHAPES


@pytest.mark.parametrize("ratio", [1e-2, 1e-3])
@pytest.mark.parametrize("shape", ENGINE_SHAPES)
def test_engine_matches_jax_engine(monkeypatch, shape, ratio):
    monkeypatch.setenv("SZ_TPU_MSST19_SOFT", "1")
    monkeypatch.setenv("SZ_TPU_MSST19_KERNEL", "1")
    from sz_tpu.tpu import msst19_engine as me

    data = synth(shape, np.float32, seed=len(shape))
    fmax = data.max()
    nz = np.abs(data[data != 0]).min()
    want = me.compress(data, ratio, fmax, nz, **KW)
    got = msst19_engine.compress(data, ratio, fmax, nz, device="cpu", **KW)
    assert ttdps.to_bytes(got) == jtdps.to_bytes(want)
    out = msst19_engine.decompress(got, shape, device="cpu")
    np.testing.assert_array_equal(
        out.view(np.uint32),
        np.asarray(me.decompress(want, shape, np.float32)).view(np.uint32))
