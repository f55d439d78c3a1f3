"""Build and load the hand-written Hopper kernels (``sz_tpu_torch/csrc``).

The CUDA sources expose a plain C interface; one ``nvcc`` per source,
all started together, compiles them to objects, which link into one
shared library under ``build/sz_tpu_torch/`` at the repository root,
named by a hash of the sources and flags (an unchanged build is reused),
and ``ctypes`` loads it.  Nothing here runs at import time: the first
CUDA launch calls :func:`lib`.

The flags keep IEEE float semantics: the codec's contract is bit-exact
output, so FMA contraction, flush-to-zero and approximate division are
all off (never ``--use_fast_math``).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile
import time

CSRC = pathlib.Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = (pathlib.Path(__file__).resolve().parents[2] / "build"
             / "sz_tpu_torch")

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-O3", "-std=c++17",
    "--fmad=false", "-prec-div=true", "-prec-sqrt=true", "-ftz=false",
    "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
_F = ctypes.c_float

# argtypes of every C entry point (pointers and the stream as c_void_p:
# a bare Python int would be passed as a 32-bit int and cut)
SIGNATURES = {
    "sz_wavefront_quantize": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                              _F, _F, _F, _F, _I, _I, _P),
    "sz_wavefront_decode": (_P, _P, _P, _P, _I, _I, _I, _P),
    "sz_histogram": (_P, _LL, _P, _P),
    "sz_pack_bits": (_P, _LL, _P, _P, _P, _I, _P, _P, _P, _LL, _P),
    "sz_fsm_sweep": (_P, _P, _I, _LL, _LL, _I, _I, _P, _P, _P),
    "sz_fsm_sync": (_P, _P, _LL, _I, _LL, _P, _P, _P),
    "sz_fsm_emit": (_P, _P, _I, _LL, _LL, _I, _I, _P, _P, _LL, _P, _P),
}

# seconds the last build took (0.0 when a cached library was loaded)
build_seconds = 0.0


def sources() -> list[pathlib.Path]:
    return sorted(CSRC.glob("*.cu"))


def find_nvcc() -> str:
    """nvcc from $CUDA_HOME, then $PATH, then the default toolkit path."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(pathlib.Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    which = shutil.which("nvcc")
    if which:
        cands.append(pathlib.Path(which))
    cands.append(pathlib.Path("/usr/local/cuda/bin/nvcc"))
    for c in cands:
        if c.is_file():
            return str(c)
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def _digest() -> str:
    h = hashlib.sha256()
    for p in sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def library_path() -> pathlib.Path:
    return BUILD_DIR / f"libsz_kernels_{_digest()}.so"


def build() -> pathlib.Path:
    """Compile csrc/*.cu into the hashed library unless it exists.  The
    compiler's resource reports (-Xptxas -v) are kept beside it as .log."""
    global build_seconds
    so = library_path()
    if so.exists():
        build_seconds = 0.0
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = find_nvcc()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [str(pathlib.Path(tmp) / f"{p.stem}.o") for p in sources()]
        procs = [subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", obj],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for src, obj in zip(sources(), objs)]
        logs = [p.communicate()[0] for p in procs]
        if any(p.returncode for p in procs):
            raise RuntimeError("nvcc failed:\n" + "\n".join(logs))
        out = pathlib.Path(tmp) / so.name
        link = subprocess.run([nvcc, "-shared", *objs, "-o", str(out)],
                              capture_output=True, text=True)
        if link.returncode:
            raise RuntimeError(f"nvcc link failed ({link.returncode}):\n"
                               f"{link.stdout}\n{link.stderr}")
        so.with_suffix(".log").write_text("\n".join(logs))
        os.replace(out, so)
    build_seconds = time.perf_counter() - t0
    return so


@functools.lru_cache(maxsize=None)
def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    dll = ctypes.CDLL(str(build()))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(dll, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return dll


def check(rc: int, what: str) -> None:
    """Raise on a non-zero cudaError_t returned by a C entry point."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc}")
