"""Boundaries of the PyTorch port: it imports neither jax nor anything of
sz_tpu, a CUDA request without a card raises (and CUDA is the default),
every configuration outside the ported slice raises NotImplementedError,
the kernel wrappers never fall back for a non-CPU tensor, and the kernel
build keeps IEEE float semantics."""

import ast
import ctypes
import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest
import torch
torch.set_num_threads(1)  # xdist workers share the cores: one thread each

import sz_tpu_torch
from sz_tpu_torch import ra
from sz_tpu_torch.config import ErrorBoundMode, SZConfig
from sz_tpu_torch.gpu import (_build, fsm_kernel, hist_kernel, lorenzo_kernel,
                              msst19_kernel, pack_kernel, ra_kernel,
                              temporal_kernel)
from sz_tpu_torch.parallel import slab
from sz_tpu_torch.temporal import TemporalCompressor

REPO = pathlib.Path(__file__).resolve().parent.parent

_NO_JAX = """
import sys
import numpy as np
import sz_tpu_torch
from sz_tpu_torch import ErrorBoundMode, SZConfig
rng = np.random.default_rng(0)
x = (np.sin(np.linspace(0, 9, 12 * 13 * 14)) + 0.05 * rng.standard_normal(
    12 * 13 * 14)).astype(np.float32).reshape(12, 13, 14)
cfg = SZConfig().with_bound(ErrorBoundMode.ABS, 1e-3)
blob = sz_tpu_torch.compress(x, cfg, device="cpu")
y = sz_tpu_torch.decompress(blob, x.shape, np.float32, device="cpu")
assert np.abs(y - x).max() <= 1e-3
from sz_tpu_torch.temporal import TemporalCompressor
enc, dec = (TemporalCompressor(2, device="cpu") for _ in range(2))
for c in (enc, dec):
    c.register(0, "v", x.shape, np.float32, cfg)
for s in range(2):
    z = dec.decompress_step(enc.compress_step({0: x + np.float32(s)}))[0]
    assert np.abs(z - x - np.float32(s)).max() <= 1e-3
from sz_tpu_torch import ra
from sz_tpu_torch.parallel import slab
sharded = slab.compress_sharded(x, cfg, devices=["cpu"] * 3)
assert sharded == ra.compress(x, cfg, n_slabs=3, device="cpu")
y = slab.decompress_sharded(sharded, devices=["cpu"] * 3)
assert np.abs(y - x).max() <= 1e-3
bad = sorted(m for m in sys.modules if m == "jax" or m.startswith("jax.")
             or m == "sz_tpu" or m.startswith("sz_tpu."))
assert not bad, bad
print("ok")
"""


def test_port_never_imports_jax():
    """conftest imports jax and sz_tpu in this process, so check in a
    fresh one that only the port was loaded."""
    proc = subprocess.run([sys.executable, "-c", _NO_JAX], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


def _imports_of_sz_tpu(path: pathlib.Path) -> list:
    """Every `import sz_tpu...` / `from sz_tpu... import` in a file,
    other than of sz_tpu_torch."""
    found = []
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        for name in names:
            top = name.split(".")[0]
            if top in ("sz_tpu", "jax", "jaxlib"):
                found.append(f"{path.name}:{node.lineno} {name}")
    return found


def test_no_module_of_the_port_imports_sz_tpu():
    files = sorted((REPO / "sz_tpu_torch").rglob("*.py")) + [
        REPO / "chip_smoke.py", REPO / "tools" / "strip_timing.py",
        REPO / "tools" / "temporal_variants.py",
        REPO / "tools" / "slab_threads.py",
        REPO / "tools" / "codec_walls.py",
        REPO / "tests" / "_torch_mh_worker.py"]
    assert len(files) > 20
    bad = [hit for f in files for hit in _imports_of_sz_tpu(f)]
    assert not bad, bad


def test_cuda_without_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    x = np.zeros((8, 8, 8), np.float32)
    with pytest.raises(RuntimeError, match="cuda"):
        sz_tpu_torch.compress(x, SZConfig(), device="cuda")
    with pytest.raises(RuntimeError, match="cuda"):
        sz_tpu_torch.decompress(b"", (8, 8, 8), device="cuda")
    with pytest.raises(RuntimeError, match="cuda"):
        TemporalCompressor(device="cuda")


def test_tensor_input_without_card_raises(monkeypatch):
    """A tensor handed to compress for the card raises without one: it is
    neither compressed on the CPU nor copied anywhere."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for dt in (torch.float32, torch.float64):
        x = torch.zeros((8, 8, 8), dtype=dt)
        with pytest.raises(RuntimeError, match="cuda"):
            sz_tpu_torch.compress(x, SZConfig(), device="cuda")
        with pytest.raises(RuntimeError, match="cuda"):
            sz_tpu_torch.compress(x, SZConfig())


def test_entry_points_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    x = np.zeros((8, 8, 8), np.float32)
    with pytest.raises(RuntimeError, match="cuda"):
        sz_tpu_torch.compress(x, SZConfig())
    with pytest.raises(RuntimeError, match="cuda"):
        sz_tpu_torch.decompress(b"", (8, 8, 8))
    with pytest.raises(RuntimeError, match="cuda"):
        TemporalCompressor()
    with pytest.raises(RuntimeError, match="cuda"):
        TemporalCompressor(3)
    with pytest.raises(RuntimeError, match="cuda"):
        slab.compress_sharded(x, SZConfig())
    with pytest.raises(RuntimeError, match="cuda"):
        slab.compress_sharded(x, SZConfig(), 2)
    with pytest.raises(RuntimeError, match="cuda"):
        slab.compress_sharded([torch.zeros((4, 8, 8))] * 2, SZConfig())
    with pytest.raises(RuntimeError, match="cuda"):
        slab.decompress_sharded(ra.build_container((8, 8, 8), np.float32,
                                                   ra._slab_bounds(8, 1),
                                                   [b""]))
    with pytest.raises(RuntimeError, match="cuda"):
        ra.compress(x, SZConfig())
    with pytest.raises(RuntimeError, match="cuda"):
        ra.decompress(ra.build_container((8, 8, 8), np.float32,
                                         ra._slab_bounds(8, 1), [b""]))
    with pytest.raises(RuntimeError, match="cuda"):
        sz_tpu_torch.compress_region(x, (0, 0, 0), (4, 4, 4), SZConfig())
    from sz_tpu_torch import cli
    assert cli._build_parser().parse_args(["-p"]).device == "cuda"


_X3 = np.linspace(0, 1, 10 * 11 * 12, dtype=np.float32).reshape(10, 11, 12)
_ABS = SZConfig().with_bound(ErrorBoundMode.ABS, 1e-3)


_PW = SZConfig().with_bound(ErrorBoundMode.PW_REL, 1e-3)


# the configurations that named ROADMAP 1.3, 1.4, 1.6 and 1.10 are
# ported: each case holds the port to sz_tpu's stream and decode (item
# None)
@pytest.mark.parametrize("data,cfg,item", [
    (_X3.astype(np.float64), SZConfig(with_regression=False).with_bound(
        ErrorBoundMode.ABS, 1e-3), None),
    (_X3, SZConfig(accelerate_pw_rel=False).with_bound(ErrorBoundMode.PW_REL,
                                                       1e-3), None),
    (_X3, SZConfig().with_bound(ErrorBoundMode.PW_REL, 1e-6), None),
    (_X3, SZConfig(with_regression=False).with_bound(
        ErrorBoundMode.ABS, 1e-3), None),
    (_X3, SZConfig(random_access=True).with_bound(ErrorBoundMode.ABS, 1e-3),
     None),
    (_X3.reshape(2, 5, 11, 12), SZConfig(random_access=True).with_bound(
        ErrorBoundMode.ABS, 1e-3), None),
    (_X3.reshape(-1), _ABS, None),
    ((_X3 * 100).astype(np.int32), _ABS, None),
    (_X3.reshape(-1), _PW, None),
    (_X3.astype(np.float64), _PW, None),
    (_X3.astype(np.float64), SZConfig(accelerate_pw_rel=False).with_bound(
        ErrorBoundMode.PW_REL, 1e-3), None),
    (_X3.astype(np.float64).reshape(-1), _ABS, None),
], ids=["f64", "pw_rel", "pw_rel_1e-6", "classic", "random_access",
        "random_access_4d", "1d", "int", "pw_rel_1d", "pw_rel_f64",
        "pw_rel_prelog_f64", "1d_f64"])
def test_out_of_slice_raises(data, cfg, item):
    if item is not None:
        with pytest.raises(NotImplementedError, match=f"ROADMAP {item}\\)"):
            sz_tpu_torch.compress(data, cfg, device="cpu")
        return
    import dataclasses
    import sz_tpu
    from sz_tpu import config as jcfg
    jc = jcfg.SZConfig(**{f.name: getattr(cfg, f.name)
                          for f in dataclasses.fields(cfg)
                          if hasattr(jcfg.SZConfig, f.name)})
    jc = dataclasses.replace(jc, engine="numpy")
    blob = sz_tpu.compress(data, jc)
    assert sz_tpu_torch.compress(data, cfg, device="cpu") == blob
    want = sz_tpu.decompress(blob, data.shape, data.dtype, engine="numpy")
    got = sz_tpu_torch.decompress(blob, data.shape, data.dtype, device="cpu")
    np.testing.assert_array_equal(got.view(np.uint8), want.view(np.uint8))


def _stream_of(dtype, shape):
    """sz_tpu's ABS 1e-3 stream of _X3's values in ``dtype`` and
    ``shape``."""
    import sz_tpu
    from sz_tpu.config import ErrorBoundMode as JMode
    from sz_tpu.config import SZConfig as JConfig
    x = _X3.astype(dtype).reshape(shape)
    return x, sz_tpu.compress(x, JConfig(engine="numpy").with_bound(
        JMode.ABS, 1e-3))


# 1-D streams (ROADMAP 1.4) and integer ones (1.10) are ported: those
# cases decode bit-equal to sz_tpu
@pytest.mark.parametrize("dtype,shape,item", [
    (np.float64, (1320,), None),
    (np.float32, (1320,), None),
    (np.int16, (10, 11, 12), None),
], ids=["f64", "1d", "int"])
def test_out_of_slice_decompress_raises(dtype, shape, item):
    if item is not None:
        with pytest.raises(NotImplementedError, match=f"ROADMAP {item}\\)"):
            sz_tpu_torch.decompress(b"\0" * 64, shape, dtype, device="cpu")
        return
    import sz_tpu
    x, blob = _stream_of(dtype, shape)
    got = sz_tpu_torch.decompress(blob, shape, dtype, device="cpu")
    want = sz_tpu.decompress(blob, shape, dtype, engine="numpy")
    np.testing.assert_array_equal(got.view(np.uint8), want.view(np.uint8))


def test_prelog_pw_rel_stream_decode_raises():
    """A stream of the pre-log PW_REL codec (the MSST19 flag off) is
    decoded by the pre-log codec (ported, ROADMAP 1.4), bit-equal to
    sz_tpu, not by another codec; a float64 MSST19 stream (ROADMAP 1.3,
    ported) decodes bit-equal to sz_tpu too."""
    import sz_tpu
    from sz_tpu.config import ErrorBoundMode as JMode
    from sz_tpu.config import SZConfig as JConfig
    cfg = JConfig(accelerate_pw_rel=False, engine="numpy").with_bound(
        JMode.PW_REL, 1e-3)
    blob = sz_tpu.compress(_X3 + 1, cfg)
    got = sz_tpu_torch.decompress(blob, _X3.shape, device="cpu")
    want = sz_tpu.decompress(blob, _X3.shape, engine="numpy")
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    blob64 = sz_tpu.compress((_X3 + 1).astype(np.float64),
                             JConfig(engine="numpy").with_bound(
                                 JMode.PW_REL, 1e-3))
    got = sz_tpu_torch.decompress(blob64, _X3.shape, np.float64,
                                  device="cpu")
    want = sz_tpu.decompress(blob64, _X3.shape, np.float64, engine="numpy")
    np.testing.assert_array_equal(got.view(np.uint64), want.view(np.uint64))


def _msst19_meta():
    m = torch.empty((4, 5, 6), device="meta")
    t = torch.empty((4, 5, 6), dtype=torch.int32, device="meta")
    tab = torch.empty(16, dtype=torch.int16, device="meta")
    pt = torch.empty(8, dtype=torch.float64, device="meta")
    return m, t, tab, pt


def _fsm_coded(device):
    """One byte coded through the codes 0, 10 and 11 (depth 2), on
    ``device``."""
    tree = (np.array([1, 0, 3, 0, 0], np.uint32),
            np.array([2, 0, 4, 0, 0], np.uint32),
            np.array([0, 5, 0, 6, 7], np.uint32),
            np.array([0, 1, 0, 1, 1], np.uint8), 5)
    return fsm_kernel.upload(tree, b"\x5a", device)


def test_wrappers_take_no_fallback_off_cpu():
    """The plain versions run only for CPU tensors; any other device is
    an error, never a silent detour."""
    m = torch.empty((4, 5, 6), device="meta")
    mb = torch.empty((4, 5, 6), dtype=torch.bool, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        lorenzo_kernel.wavefront_decode(mb, m, m)
    with pytest.raises(ValueError, match="unsupported device"):
        lorenzo_kernel.wavefront_quantize(m, m, m, mb, None, 1.0, 1.0, 1.0,
                                          1, 0.0, use_mean=False)
    s = torch.empty(10, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        hist_kernel.histogram(s)
    with pytest.raises(ValueError, match="unsupported device"):
        pack_kernel.pack_bits(s, s, s, s, 8)
    coded = _fsm_coded("meta")
    one = torch.empty(1, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        fsm_kernel.fsm_sweep(coded)
    with pytest.raises(ValueError, match="unsupported device"):
        fsm_kernel.fsm_scan(one[:, None], one[:, None].to(torch.int64))
    with pytest.raises(ValueError, match="unsupported device"):
        fsm_kernel.fsm_emit(coded, one, one.to(torch.int64), 4)
    m, t, tab, pt = _msst19_meta()
    with pytest.raises(ValueError, match="unsupported device"):
        msst19_kernel.wavefront3d_encode(m, tab, pt, 1023, 1023, 4, 13)
    with pytest.raises(ValueError, match="unsupported device"):
        msst19_kernel.wavefront3d_decode(t, m, pt)
    with pytest.raises(ValueError, match="unsupported device"):
        msst19_kernel.lines2d_encode(m[0], tab, pt, 1023, 1023, 4, 10)
    with pytest.raises(ValueError, match="unsupported device"):
        msst19_kernel.lines2d_decode(t[0], m[0], pt)
    m64 = m.double()
    with pytest.raises(ValueError, match="unsupported device"):
        msst19_kernel.wavefront3d_encode_f64(m64, tab, pt, 1023, 1023, 4, 42)
    with pytest.raises(ValueError, match="unsupported device"):
        msst19_kernel.wavefront3d_decode_f64(t, m64, pt)
    with pytest.raises(ValueError, match="unsupported device"):
        msst19_kernel.lines2d_encode_f64(m64[0], tab, pt, 1023, 1023, 4, 42)
    with pytest.raises(ValueError, match="unsupported device"):
        msst19_kernel.lines2d_decode_f64(t[0], m64[0], pt)
    b = torch.empty((3, 216), device="meta")
    lor = torch.empty(3, dtype=torch.uint8, device="meta")
    qc = torch.empty((3, 4), device="meta")
    with pytest.raises(ValueError, match="cpu or cuda"):
        ra_kernel.ra_encode(b, lor, qc, 3, 6, 1e-3, 512, 256, False, 0.0)
    with pytest.raises(ValueError, match="cpu or cuda"):
        ra_kernel.ra_decode(b.int(), b[:, 0], lor.long(), lor, qc, 3, 6,
                            1e-3, 256, False, 0.0, (3, 1, 1), (0, 0, 0),
                            (18, 6, 6))
    for dt in (torch.float32, torch.float64):
        v = torch.empty(100, dtype=dt, device="meta")
        t = torch.empty(100, dtype=torch.int32, device="meta")
        with pytest.raises(ValueError, match="cpu or cuda"):
            temporal_kernel.ts_quantize(v, v, 1e-3, 64, 32, 20, 0.0)
        with pytest.raises(ValueError, match="cpu or cuda"):
            temporal_kernel.ts_decode(t, v, v[:7], 32, 2e-3)


def test_wrappers_check_shapes():
    """Mismatched inputs are refused before any kernel could read past an
    allocation (and before the plain version could broadcast)."""
    x = torch.zeros((4, 5, 6))
    b = torch.zeros((4, 5, 6), dtype=torch.bool)
    with pytest.raises(ValueError, match="shape"):
        lorenzo_kernel.wavefront_quantize(
            x, torch.zeros((4, 5, 7), dtype=torch.int32), x, b, None, 1.0,
            1.0, 1.0, 1, 0.0, use_mean=False)
    with pytest.raises(ValueError, match="shape"):
        lorenzo_kernel.wavefront_decode(b, x, torch.zeros((4, 5)))
    with pytest.raises(ValueError, match="rank"):
        lorenzo_kernel.wavefront_decode(b[0, 0], x[0, 0], x[0, 0])
    s = torch.zeros(10, dtype=torch.int32)
    code = torch.zeros(8, dtype=torch.int64)
    with pytest.raises(ValueError, match="same symbols"):
        pack_kernel.pack_bits(s, code, code, torch.zeros(9, dtype=torch.int32),
                              0)
    bits = torch.zeros(2 * fsm_kernel.F_BITS // 8, dtype=torch.uint8)
    coded = _fsm_coded("cpu")._replace(bits=bits)
    two = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(ValueError, match="whole"):
        fsm_kernel.fsm_sweep(coded._replace(bits=bits[:100]))
    with pytest.raises(ValueError, match="whole"):      # F = 2048 bits
        fsm_kernel.fsm_sweep(coded._replace(bits=bits[:128],
                                            depth=fsm_kernel.F_BITS + 1))
    with pytest.raises(ValueError, match="outside the stream"):
        fsm_kernel.fsm_sweep(coded._replace(total_bits=8 * bits.numel() + 1))
    with pytest.raises(ValueError, match="depth"):
        fsm_kernel.fsm_sweep(coded._replace(depth=0))
    with pytest.raises(ValueError, match="shape"):
        fsm_kernel.fsm_scan(two[:, None], torch.zeros((2, 2),
                                                      dtype=torch.int64))
    with pytest.raises(ValueError, match="depth in 1..2"):
        fsm_kernel.fsm_scan(two[:0, None], torch.zeros((0, 1),
                                                       dtype=torch.int64))
    with pytest.raises(ValueError, match="dtype"):
        fsm_kernel.fsm_emit(coded, two, two, 4)
    t3 = torch.zeros((4, 5, 6), dtype=torch.int32)
    tab = torch.zeros(16, dtype=torch.int16)
    pt = torch.ones(8, dtype=torch.float64)
    with pytest.raises(ValueError, match="rank-3"):
        msst19_kernel.wavefront3d_encode(x[0], tab, pt, 1023, 1023, 4, 13)
    with pytest.raises(ValueError, match="rank-2"):
        msst19_kernel.lines2d_decode(t3, x, pt)
    with pytest.raises(ValueError, match="shape"):
        msst19_kernel.wavefront3d_decode(t3, torch.zeros((4, 5, 7)), pt)
    with pytest.raises(ValueError, match="dtype"):
        msst19_kernel.lines2d_decode(t3[0], x[0].double(), pt)
    with pytest.raises(ValueError, match="tables"):
        msst19_kernel.wavefront3d_decode(t3, x, pt.float())
    with pytest.raises(ValueError, match="cache table"):
        msst19_kernel.wavefront3d_encode(x, tab, pt, 1023, 1024, 4, 13)
    with pytest.raises(ValueError, match="dtype"):     # float32 to K8d
        msst19_kernel.wavefront3d_encode_f64(x, tab, pt, 1023, 1023, 4, 42)
    with pytest.raises(ValueError, match="dtype"):
        msst19_kernel.lines2d_decode_f64(t3[0], x[0], pt)
    blk = torch.zeros((3, 216))
    lor = torch.zeros(3, dtype=torch.uint8)
    qc = torch.zeros((3, 4))
    with pytest.raises(ValueError, match="216"):
        ra_kernel.ra_encode(blk[:, :100], lor, qc, 3, 6, 1e-3, 512, 256,
                            False, 0.0)
    with pytest.raises(ValueError, match="lor"):
        ra_kernel.ra_encode(blk, lor.bool(), qc, 3, 6, 1e-3, 512, 256,
                            False, 0.0)
    region = ((3, 1, 1), (0, 0, 0), (18, 6, 6))
    dec = (3, 6, 1e-3, 256, False, 0.0)
    with pytest.raises(ValueError, match="qc"):
        ra_kernel.ra_decode(blk.int(), blk[:, 0], lor.long(), lor,
                            qc[:, :3], *dec, *region)
    with pytest.raises(ValueError, match="esc_base"):
        ra_kernel.ra_decode(blk.int(), blk[:, 0], lor.int(), lor, qc, *dec,
                            *region)
    with pytest.raises(ValueError, match="unpred"):
        ra_kernel.ra_decode(blk.int(), blk.double()[:, 0], lor.long(), lor,
                            qc, *dec, *region)
    with pytest.raises(ValueError, match="grid"):
        ra_kernel.ra_decode(blk.int(), blk[:, 0], lor.long(), lor, qc, *dec,
                            (2, 1, 1), (0, 0, 0), (12, 6, 6))
    with pytest.raises(ValueError, match="outside"):
        ra_kernel.ra_decode(blk.int(), blk[:, 0], lor.long(), lor, qc, *dec,
                            (3, 1, 1), (1, 0, 0), (18, 6, 6))
    with pytest.raises(ValueError, match="rank"):
        ra_kernel.ra_encode(blk, lor, qc, 4, 6, 1e-3, 512, 256, False, 0.0)
    cur, t = torch.zeros(100), torch.zeros(100, dtype=torch.int32)
    q = (1e-3, 64, 32, 20, 0.0)
    with pytest.raises(ValueError, match="100 points"):
        temporal_kernel.ts_quantize(cur, cur[:99], *q)
    with pytest.raises(ValueError, match="1-D"):
        temporal_kernel.ts_quantize(cur.reshape(10, 10), cur.reshape(10, 10),
                                    *q)
    with pytest.raises(ValueError, match="float64"):
        temporal_kernel.ts_quantize(cur, cur.double(), *q)
    with pytest.raises(ValueError, match="float32 or float64"):
        temporal_kernel.ts_quantize(t, t, *q)
    with pytest.raises(ValueError, match="50 points"):
        temporal_kernel.ts_decode(t[:50], cur, cur[:3], 32, 2e-3)
    with pytest.raises(ValueError, match="int32"):
        temporal_kernel.ts_decode(t.long(), cur, cur[:3], 32, 2e-3)
    with pytest.raises(ValueError, match="vals"):
        temporal_kernel.ts_decode(t, cur, cur[:3].double(), 32, 2e-3)


def test_kernel_build_keeps_ieee_floats():
    flags = " ".join(_build.NVCC_FLAGS)
    assert "--fmad=false" in flags and "-ftz=false" in flags
    assert "-prec-div=true" in flags and "sm_90a" in flags
    assert "fast_math" not in flags and "fast-math" not in flags
    srcs = _build.sources()
    assert {p.name for p in srcs} == {"lorenzo.cu", "hist.cu", "pack.cu",
                                      "fsm.cu", "msst19.cu", "classic.cu",
                                      "ra.cu", "temporal.cu", "intc.cu"}
    assert {p.name for p in _build.headers()} == {"tiles.cuh",
                                                  "lookback.cuh",
                                                  "strips.cuh"}
    for p in srcs + _build.headers():
        text = p.read_text()
        assert "fast_math" not in text and "fmad=true" not in text
        assert "#pragma STDC FP_CONTRACT ON" not in text
        assert "ftz=true" not in text
        # no fused multiply-add written out, in float or double
        assert not re.search(r"\b(__)?fmaf?(_r[nzdu])?\s*\(", text), p.name
        assert not re.search(r"\b__fmaf?_r[nzdu]\s*\(", text), p.name


def test_kernel_digest_follows_headers(tmp_path, monkeypatch):
    """The library's name hashes the headers too, so an edit to
    tiles.cuh alone builds a new library instead of loading a stale one;
    only the .cu files are compiled."""
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    for p in _build.sources() + _build.headers():
        (csrc / p.name).write_bytes(p.read_bytes())
    monkeypatch.setattr(_build, "CSRC", csrc)
    assert [p.suffix for p in _build.sources()] == [".cu"] * 9
    before = _build.library_path()
    header = csrc / "tiles.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    after = _build.library_path()
    assert after != before and after.parent == before.parent
    header.write_text(header.read_text()[:-len("\n// edited\n")])
    assert _build.library_path() == before


def _global_kernels():
    """Names of the __global__ functions the CUDA sources define."""
    names = set()
    for p in sorted((REPO / "sz_tpu_torch" / "csrc").glob("*.cu*")):
        text = p.read_text()
        names.update(re.findall(
            r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s*)?"
            r"(\w+)\s*\(", text))
    return names


def test_profiler_names_cover_every_kernel():
    """Every __global__ kernel of csrc/ matches an entry of chip_smoke.py's
    DEVICE_NAMES (read from its text: the script is not imported), so a
    renamed kernel's device time cannot fall into "torch" unseen."""
    tree = ast.parse((REPO / "chip_smoke.py").read_text())
    table = next(ast.literal_eval(node.value) for node in tree.body
                 if isinstance(node, ast.Assign)
                 and [t.id for t in node.targets] == ["DEVICE_NAMES"])
    parts = [part.split("<")[0] for part, _ in table]
    kernels = _global_kernels()
    assert len(kernels) >= 11
    assert {"ts_quantize_kernel", "ts_quantize_f64_kernel",
            "ts_quantize_escapes_kernel", "ts_quantize_escapes_f64_kernel",
            "ts_decode_kernel", "ts_decode_f64_kernel",
            "ts_decode_escapes_kernel",
            "ts_decode_escapes_f64_kernel"} <= kernels
    missing = sorted(k for k in kernels if not any(p in k for p in parts))
    assert not missing, missing
    # and no entry names a kernel that no longer exists
    stale = sorted(p for p in parts if p not in ("Memcpy", "Memset")
                   and not any(p in k for k in kernels))
    assert not stale, stale


def test_build_signatures_cover_every_entry_point():
    """Every extern "C" entry point of csrc/ has its argument types in
    _build.SIGNATURES (ctypes would pass a pointer as a 32-bit int
    without them), and every signature names an entry point that
    exists."""
    entries = set()
    for p in sorted((REPO / "sz_tpu_torch" / "csrc").glob("*.cu*")):
        entries.update(re.findall(r'extern\s+"C"\s+int\s+(\w+)\s*\(',
                                  p.read_text()))
    assert {"sz_wavefront_quantize_f64", "sz_wavefront_decode_f64"} <= entries
    assert {"sz_ts_quantize", "sz_ts_quantize_f64", "sz_ts_decode",
            "sz_ts_decode_f64"} <= entries
    assert entries == set(_build.SIGNATURES)
    # a float64 entry point takes its scalars as doubles, never floats
    for name, argtypes in _build.SIGNATURES.items():
        if name.endswith("_f64"):
            assert ctypes.c_float not in argtypes, name
