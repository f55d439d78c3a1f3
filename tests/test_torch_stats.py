"""Compression statistics of the PyTorch port (ROADMAP 1.11):
``sz_tpu_torch.utils.stats.collect()`` gathers the same ``SZStats`` as
``sz_tpu.utils.stats.collect()`` for the same call, on the CPU: the
regression codec (float32, float64, rank 2 and 4), the classic codec,
the 1-D codec, the random-access codec, PW_REL (which records nothing in
either) and an integer stream (nothing either); a stats slot is the
calling thread's, and nothing is recorded outside ``collect``.
Tolerance: exact (equal dataclasses).
"""

import dataclasses
import threading

import numpy as np
import pytest
import torch
torch.set_num_threads(1)  # xdist workers share the cores: one thread each

import sz_tpu
from sz_tpu import config as jcfg
from sz_tpu.utils import stats as jstats

import sz_tpu_torch
from sz_tpu_torch.config import ErrorBoundMode, SZConfig
from sz_tpu_torch.utils import stats

_RNG = np.random.default_rng(0)
_X3 = (np.linspace(0, 1, 20 * 24 * 28, dtype=np.float32).reshape(20, 24, 28)
       + np.float32(0.01) * _RNG.standard_normal((20, 24, 28)).astype(
           np.float32))

CASES = {
    "regression": (_X3, {}, ("ABS", 1e-3)),
    "regression_f64_2d": (_X3.astype(np.float64).reshape(80, 168), {},
                          ("ABS", 1e-4)),
    "regression_4d": (_X3.reshape(4, 5, 24, 28), {}, ("REL", 1e-3)),
    "classic": (_X3, dict(with_regression=False), ("ABS", 1e-3)),
    "1d": (_X3.reshape(-1), {}, ("ABS", 1e-3)),
    "pw_rel": (_X3 + np.float32(1), {}, ("PW_REL", 1e-3)),
    "random_access": (_X3, dict(random_access=True), ("ABS", 1e-3)),
    "int32": ((_X3 * 1000).astype(np.int32), {}, ("ABS", 4)),
}


def _configs(over: dict, bound: tuple):
    mode, value = bound
    cfg = SZConfig(**over).with_bound(getattr(ErrorBoundMode, mode), value)
    jc = jcfg.SZConfig(**{f.name: getattr(cfg, f.name)
                          for f in dataclasses.fields(cfg)
                          if hasattr(jcfg.SZConfig, f.name)})
    return cfg, dataclasses.replace(jc, engine="numpy")


@pytest.mark.parametrize("name", sorted(CASES))
def test_stats_equal_sz_tpus(name):
    x, over, bound = CASES[name]
    cfg, jc = _configs(over, bound)
    with jstats.collect() as want:
        sz_tpu.compress(x, jc)
    with stats.collect() as got:
        blob = sz_tpu_torch.compress(x, cfg, device="cpu")
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.report() == want.report()
    if name not in ("pw_rel", "int32"):
        assert got.compressed_size == len(blob)
        assert got.original_size == x.nbytes


def test_stats_slot_is_the_threads():
    """Nothing lands outside collect(), and another thread's compress
    does not land in this thread's slot."""
    cfg, _ = _configs({}, ("ABS", 1e-3))
    assert stats.current() is None
    sz_tpu_torch.compress(_X3, cfg, device="cpu")
    assert stats.current() is None
    with stats.collect() as s:
        t = threading.Thread(target=sz_tpu_torch.compress,
                             args=(_X3, cfg), kwargs=dict(device="cpu"))
        t.start()
        t.join(timeout=120)
        assert not t.is_alive()
        assert s == stats.SZStats()
    assert stats.current() is None
