"""The port's environment variables (README "Runtime configuration
(port)"), as tests/test_routing.py pins ``sz_tpu``'s: the README's table
lists exactly ``KNOBS``, and each knob does what the table says.
"""

import os
import pathlib
import re
import sys
import threading

import numpy as np
import pytest
import torch
torch.set_num_threads(1)  # xdist workers share the cores: one thread each

import sz_tpu_torch
from sz_tpu_torch.config import ErrorBoundMode, Lossless, SZConfig
from sz_tpu_torch.format import lossless as ll
from sz_tpu_torch.parallel import slab
from sz_tpu_torch.utils import trace

REPO = pathlib.Path(__file__).resolve().parents[1]

# variable -> default, as the README's table gives it
KNOBS = {
    "SZ_TPU_TRACE": "unset",
    "SZ_TPU_SYSTEM_ZSTD": "unset",
    "SZ_TPU_HOST_THREADS": "CPU count",
    "SZ_TPU_DEVICE_BITPACK": "not ported",
}


def _readme_table() -> dict:
    text = (REPO / "README.md").read_text()
    sec = text.split("## Runtime configuration (port)", 1)[1]
    sec = sec.split("\n## ", 1)[0]
    rows = re.findall(r"^\| `(SZ_TPU_[A-Z_]+)` \| ([^|]+) \|", sec, re.M)
    return {k: v.strip() for k, v in rows}


def test_readme_table_is_the_knob_table():
    assert _readme_table() == KNOBS


def test_the_port_reads_no_other_knob():
    names = set()
    for f in (REPO / "sz_tpu_torch").rglob("*.py"):
        names |= set(re.findall(r"\bSZ_TPU_[A-Z_]+\b", f.read_text()))
    read = {k for k, v in KNOBS.items() if v != "not ported"}
    assert names == read


@pytest.mark.parametrize("val,prints", [(None, False), ("", False),
                                        ("0", False), ("1", True),
                                        ("yes", True)])
def test_trace_prints_spans(monkeypatch, capsys, val, prints):
    if val is None:
        monkeypatch.delenv("SZ_TPU_TRACE", raising=False)
    else:
        monkeypatch.setenv("SZ_TPU_TRACE", val)
    with trace.trace("probe"):
        pass
    err = capsys.readouterr().err
    assert ("[sz_tpu_torch probe:" in err) is prints
    assert trace.last_spans()[-1][0] == "probe"


def test_trace_enable_overrides_the_variable(monkeypatch, capsys):
    monkeypatch.setenv("SZ_TPU_TRACE", "1")
    try:
        trace.enable(False)
        with trace.trace("quiet"):
            pass
        assert capsys.readouterr().err == ""
        monkeypatch.delenv("SZ_TPU_TRACE")
        trace.enable(True)
        with trace.trace("loud"):
            pass
        assert re.search(r"\[sz_tpu_torch loud: \d+\.\d ms\]",
                         capsys.readouterr().err)
    finally:
        trace.enable(None)


def _field():
    return np.cumsum(np.random.default_rng(2).standard_normal(
        (16, 20, 24)), axis=2).astype(np.float32)


def test_system_zstd_frames(monkeypatch):
    zstandard = pytest.importorskip("zstandard")
    cfg = SZConfig().with_bound(ErrorBoundMode.ABS, 1e-3)
    data = _field()
    monkeypatch.delenv("SZ_TPU_SYSTEM_ZSTD", raising=False)
    vendored = sz_tpu_torch.compress(data, cfg, device="cpu")
    import sz_tpu
    from sz_tpu.config import SZConfig as JConfig
    from sz_tpu.config import ErrorBoundMode as JMode
    jc = JConfig(engine="numpy").with_bound(JMode.ABS, 1e-3)
    assert vendored == sz_tpu.compress(data, jc)
    monkeypatch.setenv("SZ_TPU_SYSTEM_ZSTD", "1")
    system = sz_tpu_torch.compress(data, cfg, device="cpu")
    assert system == sz_tpu.compress(data, jc)   # sz_tpu reads it too
    inner = ll.decompress(vendored, 0)
    assert system == zstandard.ZstdCompressor(
        level=cfg.lossless_level, write_content_size=True,
        write_checksum=False).compress(inner)
    out = sz_tpu_torch.decompress(system, data.shape, device="cpu")
    ref = sz_tpu_torch.decompress(vendored, data.shape, device="cpu")
    np.testing.assert_array_equal(out, ref)
    monkeypatch.setenv("SZ_TPU_SYSTEM_ZSTD", "0")
    assert sz_tpu_torch.compress(data, cfg, device="cpu") == vendored


def test_system_zstd_without_the_package_raises(monkeypatch):
    monkeypatch.setitem(sys.modules, "zstandard", None)
    monkeypatch.setenv("SZ_TPU_SYSTEM_ZSTD", "1")
    with pytest.raises(RuntimeError, match="zstandard"):
        ll.compress(b"x" * 100, Lossless.ZSTD, 3)
    assert ll.compress(b"x" * 100, Lossless.GZIP, 1)[:1] == b"\x78"


@pytest.mark.parametrize("val", ["1", "4", None])
def test_host_threads(monkeypatch, val):
    """SZ_TPU_HOST_THREADS=1 runs the slabs one after another in the
    caller's thread; more (the CPU count when unset) on a pool."""
    if val is None:
        monkeypatch.delenv("SZ_TPU_HOST_THREADS", raising=False)
    else:
        monkeypatch.setenv("SZ_TPU_HOST_THREADS", val)
    serial = val == "1" or (val is None and (os.cpu_count() or 1) <= 1)
    seen = set()

    def fn(i):
        seen.add(threading.get_ident())
        return i * i

    assert slab._pmap_host(fn, 6) == [i * i for i in range(6)]
    assert (seen == {threading.get_ident()}) is serial
    assert (threading.get_ident() in seen) is serial


def test_device_bitpack_is_not_read(monkeypatch):
    """sz_tpu's SZ_TPU_DEVICE_BITPACK=0 route is not ported: the port's
    stream and its K4 route are the same whatever the variable says."""
    cfg = SZConfig().with_bound(ErrorBoundMode.ABS, 1e-3)
    data = _field()
    monkeypatch.delenv("SZ_TPU_DEVICE_BITPACK", raising=False)
    want = sz_tpu_torch.compress(data, cfg, device="cpu")
    monkeypatch.setenv("SZ_TPU_DEVICE_BITPACK", "0")
    from sz_tpu_torch.gpu import pack_kernel
    calls = []
    orig = pack_kernel.pack_bits

    def spy(*a, **k):
        calls.append(1)
        return orig(*a, **k)

    monkeypatch.setattr(pack_kernel, "pack_bits", spy)
    assert sz_tpu_torch.compress(data, cfg, device="cpu") == want
    assert calls
