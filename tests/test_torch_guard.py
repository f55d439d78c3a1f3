"""Boundaries of the PyTorch port: it imports neither jax nor anything of
sz_tpu, a CUDA request without a card raises (and CUDA is the default),
every configuration outside the ported slice raises NotImplementedError,
the kernel wrappers never fall back for a non-CPU tensor, and the kernel
build keeps IEEE float semantics."""

import ast
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import sz_tpu_torch
from sz_tpu_torch.config import ErrorBoundMode, SZConfig
from sz_tpu_torch.gpu import (_build, fsm_kernel, hist_kernel, lorenzo_kernel,
                              pack_kernel)

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
        REPO / "chip_smoke.py"]
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


def test_entry_points_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    x = np.zeros((8, 8, 8), np.float32)
    with pytest.raises(RuntimeError, match="cuda"):
        sz_tpu_torch.compress(x, SZConfig())
    with pytest.raises(RuntimeError, match="cuda"):
        sz_tpu_torch.decompress(b"", (8, 8, 8))


_X3 = np.linspace(0, 1, 10 * 11 * 12, dtype=np.float32).reshape(10, 11, 12)
_ABS = SZConfig().with_bound(ErrorBoundMode.ABS, 1e-3)


@pytest.mark.parametrize("data,cfg,item", [
    (_X3.astype(np.float64), _ABS, "1.3"),
    (_X3, SZConfig().with_bound(ErrorBoundMode.PW_REL, 1e-3), "1.5"),
    (_X3, SZConfig(with_regression=False).with_bound(
        ErrorBoundMode.ABS, 1e-3), "1.4"),
    (_X3, SZConfig(random_access=True).with_bound(ErrorBoundMode.ABS, 1e-3),
     "1.6"),
    (_X3.reshape(-1), _ABS, "1.4"),
    ((_X3 * 100).astype(np.int32), _ABS, "1.10"),
], ids=["f64", "pw_rel", "classic", "random_access", "1d", "int"])
def test_out_of_slice_raises(data, cfg, item):
    with pytest.raises(NotImplementedError, match=f"ROADMAP {item}\\)"):
        sz_tpu_torch.compress(data, cfg, device="cpu")


@pytest.mark.parametrize("dtype,shape,item", [
    (np.float64, (10, 11, 12), "1.3"),
    (np.float32, (1320,), "1.4"),
    (np.int16, (10, 11, 12), "1.10"),
], ids=["f64", "1d", "int"])
def test_out_of_slice_decompress_raises(dtype, shape, item):
    with pytest.raises(NotImplementedError, match=f"ROADMAP {item}\\)"):
        sz_tpu_torch.decompress(b"\0" * 64, shape, dtype, device="cpu")


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
    bits = torch.empty(fsm_kernel.F_BITS // 8, dtype=torch.uint8,
                       device="meta")
    trans = torch.empty(6, dtype=torch.int32, device="meta")
    one = torch.empty(1, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        fsm_kernel.fsm_sweep(bits, trans, 8, 2)
    with pytest.raises(ValueError, match="unsupported device"):
        fsm_kernel.fsm_sync(one[:, None], one[:, None].to(torch.int64), 1)
    with pytest.raises(ValueError, match="unsupported device"):
        fsm_kernel.fsm_emit(bits, trans, 8, 2, one,
                            one.to(torch.int64), 4)


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
    trans = torch.zeros(6, dtype=torch.int32)
    two = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(ValueError, match="whole"):
        fsm_kernel.fsm_sweep(bits[:100], trans, 8, 2)
    with pytest.raises(ValueError, match="whole"):      # F = 2048 bits
        fsm_kernel.fsm_sweep(bits[:128], trans, 8, fsm_kernel.F_BITS + 1)
    with pytest.raises(ValueError, match="outside the stream"):
        fsm_kernel.fsm_sweep(bits, trans, 8 * bits.numel() + 1, 2)
    with pytest.raises(ValueError, match="depth"):
        fsm_kernel.fsm_sweep(bits, trans, 8, 0)
    with pytest.raises(ValueError, match="shape"):
        fsm_kernel.fsm_sync(two[:, None], torch.zeros((2, 2),
                                                      dtype=torch.int64), 1)
    with pytest.raises(ValueError, match="dtype"):
        fsm_kernel.fsm_emit(bits, trans, 8, 2, two, two, 4)


def test_kernel_build_keeps_ieee_floats():
    flags = " ".join(_build.NVCC_FLAGS)
    assert "--fmad=false" in flags and "-ftz=false" in flags
    assert "-prec-div=true" in flags and "sm_90a" in flags
    assert "fast_math" not in flags and "fast-math" not in flags
    srcs = _build.sources()
    assert {p.name for p in srcs} == {"lorenzo.cu", "hist.cu", "pack.cu",
                                      "fsm.cu"}
    for p in srcs:
        text = p.read_text()
        assert "fast_math" not in text and "fmad=true" not in text
