"""The port's multi-device slab codec (``sz_tpu_torch.parallel.slab``)
against ``sz_tpu.parallel.slab`` on the 8-device CPU mesh of
tests/conftest.py, the port's slabs on ``devices=["cpu"] * 8``: every
case of tests/test_parallel.py (3-D, use_mean, 2-D, float64, REL, the
constant fallback, the region decode, tensor input, the slabs left on
their devices, the decode), PW_REL, a 4-D field, rows that 8 does not
divide, the serial pool (SZ_TPU_HOST_THREADS=1), the pool run twice with
8 threads, the counters under threads, and the random-access block batch
split over devices against ``sz_tpu``'s ``n_devices=3`` and its single
device.  Tolerance: exact (equal bytes, equal bits)."""

import sys
import threading

import numpy as np
import pytest
import torch
torch.set_num_threads(1)  # xdist workers share the cores: one thread each

import sz_tpu_torch
from sz_tpu import ra as jra
from sz_tpu.config import ErrorBoundMode as JMode
from sz_tpu.config import SZConfig as JConfig
from sz_tpu.core import rablock as jrb
from sz_tpu.parallel import slab as jslab
from sz_tpu_torch import ra
from sz_tpu_torch.config import ErrorBoundMode, SZConfig
from sz_tpu_torch.core import rablock
from sz_tpu_torch.gpu import _build
from sz_tpu_torch.parallel import slab
from sz_tpu_torch.utils import trace

CPU8 = ["cpu"] * 8


def synth(shape, dtype=np.float32, seed=0, dense_fraction=0.0):
    """tests/test_parallel.py's field."""
    rng = np.random.default_rng(seed)
    axes = [np.linspace(0, 4 * np.pi, n) for n in shape]
    grids = np.meshgrid(*axes, indexing="ij")
    field = np.sin(grids[0])
    for g in grids[1:]:
        field = field * np.cos(g)
    field = field + 0.05 * rng.standard_normal(shape)
    if dense_fraction:
        mask = rng.random(shape) < dense_fraction
        field[mask] = 0.25
    return field.astype(dtype)


def _configs(mode, bound):
    return (SZConfig().with_bound(getattr(ErrorBoundMode, mode), bound),
            JConfig().with_bound(getattr(JMode, mode), bound))


def _same_bits(a, b):
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8))


def _pwrel_field():
    """tests/test_msst19_engine.py::test_sharded_pwrel_device_container's
    field."""
    shape = (16, 20, 24)
    rng = np.random.default_rng(31)
    axes = [np.linspace(0.1, 4 * np.pi, n) for n in shape]
    g = np.meshgrid(*axes, indexing="ij")
    f = np.exp(np.sin(g[0]) * np.cos(g[-1]))
    f = f * (1 + 0.05 * rng.standard_normal(shape))
    x = np.abs(f).astype(np.float32) + np.float32(0.01)
    x[x == 0] = np.float32(0.5)
    return x


CASES = {
    "3d": (lambda: synth((32, 20, 24)), ("ABS", 1e-3)),
    "3d_use_mean": (lambda: synth((32, 16, 16), dense_fraction=0.4),
                    ("ABS", 1e-3)),
    "2d": (lambda: synth((64, 96)), ("ABS", 1e-4)),
    "double": (lambda: synth((16, 12, 18), np.float64, seed=3),
               ("ABS", 1e-6)),
    "rel": (lambda: synth((32, 14, 10), seed=7), ("REL", 1e-4)),
    "constant": (lambda: np.full((16, 8, 8), 3.25, np.float32),
                 ("ABS", 1e-3)),
    "pw_rel": (_pwrel_field, ("PW_REL", 1e-3)),
    "4d": (lambda: synth((16, 6, 10, 12), seed=11), ("ABS", 1e-3)),
    "rows_not_divisible": (lambda: synth((35, 12, 10), seed=13),
                           ("ABS", 1e-3)),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_compress_sharded_matches_sz_tpu(name):
    """The container equals sz_tpu's sharded one (n_devices=8) and the
    serial ra.compress; every payload equals the port's compress of its
    slab."""
    make, bound = CASES[name]
    x = make()
    cfg, jcfg = _configs(*bound)
    blob = slab.compress_sharded(x, cfg, devices=CPU8)
    assert blob == jslab.compress_sharded(x, jcfg, n_devices=8)
    assert blob == ra.compress(x, cfg, n_slabs=8, device="cpu")
    r = ra.Reader(blob)
    assert r.n_slabs == 8
    a, b = int(r.starts[3]), int(r.starts[4])
    assert r.slab_bytes(3) == sz_tpu_torch.compress(x[a:b], cfg,
                                                    device="cpu")


@pytest.mark.parametrize("name", ["3d_use_mean", "constant", "pw_rel",
                                  "rows_not_divisible"])
def test_decompress_sharded_matches_sz_tpu(name):
    """The decode is bit-equal to sz_tpu's decompress_sharded and to
    ra.decompress, and holds the bound; as_tensor gives the same slabs,
    each on the device that decoded it."""
    make, (mode, bound) = CASES[name]
    x = make()
    cfg, jcfg = _configs(mode, bound)
    blob = jslab.compress_sharded(x, jcfg, n_devices=8)
    out = slab.decompress_sharded(blob, devices=CPU8)
    _same_bits(out, np.asarray(jslab.decompress_sharded(blob, n_devices=8)))
    _same_bits(out, jra.decompress(blob, engine="numpy"))
    if mode == "PW_REL":
        assert (np.abs(out - x) / np.abs(x)).max() <= bound * (1 + 1e-5)
    else:
        assert np.abs(out - x).max() <= bound * (1 + 1e-6)
    parts = slab.decompress_sharded(blob, devices=CPU8, as_tensor=True)
    r = ra.Reader(blob)
    assert len(parts) == r.n_slabs
    for i, p in enumerate(parts):
        assert torch.is_tensor(p) and p.device.type == "cpu"
        assert p.shape == (int(r.starts[i + 1] - r.starts[i]), *x.shape[1:])
    _same_bits(torch.cat(parts).numpy(), out)


def test_sharded_region_decode():
    x = synth((40, 12, 12), seed=5)
    cfg, _ = _configs("ABS", 1e-3)
    blob = slab.compress_sharded(x, cfg, devices=CPU8)
    region = ra.Reader(blob).decode_region(7, 22, "cpu")
    _same_bits(region, jra.decompress(blob, engine="numpy")[7:22])
    _same_bits(region, jra.Reader(blob).decode_region(7, 22,
                                                      engine="numpy"))


def test_tensor_input_gives_the_host_arrays_bytes():
    """A CPU tensor, and a list of slab tensors split as _slab_bounds
    splits the field (the torch form of a sharded array), give the host
    array's container; any other split raises."""
    for shape, dense in (((32, 20, 24), 0.0), ((32, 16, 16), 0.4)):
        x = synth(shape, dense_fraction=dense)
        cfg, jcfg = _configs("ABS", 1e-3)
        host = slab.compress_sharded(x, cfg, devices=CPU8)
        assert host == jslab.compress_sharded(x, jcfg, n_devices=8)
        t = torch.from_numpy(x)
        assert slab.compress_sharded(t, cfg, devices=CPU8) == host
        starts = ra._slab_bounds(shape[0], 8)
        parts = [t[int(a):int(b)] for a, b in zip(starts[:-1], starts[1:])]
        assert slab.compress_sharded(parts, cfg, devices=CPU8) == host
    x = synth((35, 12, 10), seed=13)   # the last slab takes 7 rows
    t = torch.from_numpy(x)
    starts = ra._slab_bounds(35, 8)
    parts = [t[int(a):int(b)] for a, b in zip(starts[:-1], starts[1:])]
    assert slab.compress_sharded(parts, cfg, devices=CPU8) == \
        jslab.compress_sharded(x, jcfg, n_devices=8)
    with pytest.raises(ValueError, match="split"):
        slab.compress_sharded([t[:5], t[5:]], cfg, devices=["cpu"] * 2)
    with pytest.raises(ValueError, match="8 slabs for 4 devices"):
        slab.compress_sharded(parts, cfg, devices=["cpu"] * 4)
    with pytest.raises(ValueError, match="one dtype"):
        slab.compress_sharded([t[:17], t[17:].double()], cfg,
                              devices=["cpu"] * 2)


def test_serial_pool_gives_the_threaded_bytes(monkeypatch):
    x = synth((32, 20, 24), seed=2)
    cfg, _ = _configs("ABS", 1e-3)
    monkeypatch.setenv("SZ_TPU_HOST_THREADS", "8")
    threaded = slab.compress_sharded(x, cfg, devices=CPU8)
    monkeypatch.setenv("SZ_TPU_HOST_THREADS", "1")
    assert slab.compress_sharded(x, cfg, devices=CPU8) == threaded
    assert threaded == ra.compress(x, cfg, n_slabs=8, device="cpu")


def test_pool_of_eight_threads_twice(monkeypatch):
    """Eight slabs in eight threads at once, twice, with a short switch
    interval: the same bytes each time, and the serial container's."""
    x = synth((16, 20, 24), seed=4)
    cfg, _ = _configs("ABS", 1e-3)
    monkeypatch.setenv("SZ_TPU_HOST_THREADS", "8")
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        runs = [slab.compress_sharded(x, cfg, devices=CPU8)
                for _ in range(2)]
    finally:
        sys.setswitchinterval(interval)
    assert runs[0] == runs[1] == ra.compress(x, cfg, n_slabs=8, device="cpu")


def test_counters_lose_no_update_under_threads():
    """trace.count and _build.launched from 16 threads, a short switch
    interval: every increment lands."""
    class Wrapper:
        launches = 0

    trace.reset()
    per = 2000

    def work():
        for _ in range(per):
            trace.count("stress", 1)
            _build.launched(Wrapper)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work) for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert trace.last_counts()["stress"] == 16 * per
    assert Wrapper.launches == 16 * per
    trace.reset()


def test_entry_points_check_their_devices():
    x = synth((16, 8, 8))
    cfg, _ = _configs("ABS", 1e-3)
    with pytest.raises(ValueError, match="n_devices=3"):
        slab.compress_sharded(x, cfg, 3, devices=["cpu"] * 2)
    with pytest.raises(TypeError, match="random-access container"):
        slab.compress_sharded(x.astype(np.int32), cfg, devices=CPU8)
    assert slab.slab_shapes((32, 5, 6), 8) == jslab.slab_shapes((32, 5, 6), 8)
    with pytest.raises(ValueError, match="divide"):
        slab.slab_shapes((30, 5), 8)


def _ra_field(shape, seed):
    rng = np.random.default_rng(seed)
    n = int(np.prod(shape))
    return (np.sin(np.linspace(0, 9, n)) + 0.05 * rng.standard_normal(n)
            ).astype(np.float32).reshape(shape)


# regions whose faces cut blocks (6, 16, 256 a side at ranks 3, 2, 1)
@pytest.mark.parametrize("shape,start,end", [
    ((30, 28, 26), (5, 2, 9), (22, 21, 25)),
    ((48, 36), (7, 3), (45, 35)),
    ((3000,), (300,), (2900,)),
], ids=["3d", "2d", "1d"])
def test_random_access_blocks_over_devices(shape, start, end):
    """compress_ra / decompress_ra with the block batch over devices:
    the body equals sz_tpu's n_devices=3 and single-device ones, the
    whole decode and a region equal theirs bit for bit."""
    x = _ra_field(shape, len(shape) + 77)
    cfg = SZConfig(random_access=True)
    jcfg = JConfig(random_access=True)
    one = rablock.compress_ra(x, 1e-3, cfg, device="cpu")
    split = rablock.compress_ra(x, 1e-3, cfg, device="cpu",
                                devices=["cpu"] * 3)
    assert split.body == one.body
    assert split.body == jrb.compress_ra(x, 1e-3, jcfg, engine="jax",
                                         n_devices=3).body
    assert split.body == jrb.compress_ra(x, 1e-3, jcfg).body
    for lo, hi in ((None, None), (start, end)):
        got = rablock.decompress_ra(split.body, shape, lo, hi, device="cpu",
                                    devices=["cpu"] * 3)
        _same_bits(got, rablock.decompress_ra(split.body, shape, lo, hi,
                                              device="cpu"))
        _same_bits(got, jrb.decompress_ra(split.body, shape, start=lo,
                                          end=hi, engine="jax",
                                          n_devices=3))
    t = rablock.decompress_ra(split.body, shape, start, end, device="cpu",
                              devices=["cpu"] * 3, as_tensor=True)
    assert torch.is_tensor(t)
    _same_bits(t.numpy(), got)
