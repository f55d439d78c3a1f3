"""The port's host runtime: ``host.c`` plus the vendored zstd 1.3.5,
compiled by ``cc`` into one shared library and bound with ``ctypes``.

Built at first use (never at import) into ``build/sz_tpu_torch/`` at the
repository root, named by a hash of the sources and flags, so an
unchanged build is reused; a file lock keeps concurrent processes from
compiling it twice.  The objects compile in parallel.  There is no
Python fallback: without ``cc`` the first call raises.

Flags: ``-O3 -ffp-contract=off`` and nothing that changes float
semantics (no ``-march=native``, no fast-math), so the coefficient chain
rounds exactly as the reference's C.  zstd 1.3.5 is the release the
reference vendors, which keeps every outer frame byte-equal to its
binary's (``vendor/zstd/PROVENANCE.md``).
"""

from __future__ import annotations

import ctypes
import fcntl
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile

import numpy as np

_HERE = pathlib.Path(__file__).resolve().parent
_ZSTD = _HERE / "vendor" / "zstd"
BUILD_DIR = (pathlib.Path(__file__).resolve().parents[2] / "build"
             / "sz_tpu_torch")
CFLAGS = ("-O3", "-ffp-contract=off", "-fPIC")

_P = ctypes.c_void_p
_I = ctypes.c_int
_I64 = ctypes.c_int64
_SZ = ctypes.c_size_t
_SIGNATURES = {
    "seq_sum_f32": ((_P, _I64), ctypes.c_float),
    "coeff_chain_f32": ((_P, _I64, _I, _P, _I, _P, _P, _P, _P, _I, _I),
                        None),
    "coeff_chain_decode_f32": ((_P, _I64, _I, _P, _P, _P, _P, _P), None),
    "huff_build_tree": ((_P, _I64, _I64, _P, _P, _P, _P, _P, _P, _P), _I64),
    "ZSTD_compress": ((_P, _SZ, _P, _SZ, _I), _SZ),
    "ZSTD_decompress": ((_P, _SZ, _P, _SZ), _SZ),
    "ZSTD_compressBound": ((_SZ,), _SZ),
    "ZSTD_isError": ((_SZ,), ctypes.c_uint),
    "ZSTD_getFrameContentSize": ((_P, _SZ), ctypes.c_ulonglong),
}


def sources() -> list[pathlib.Path]:
    return [_HERE / "host.c"] + [
        p for sub in ("common", "compress", "decompress")
        for p in sorted((_ZSTD / sub).glob("*.c"))]


def _digest() -> str:
    h = hashlib.sha256(" ".join(CFLAGS).encode())
    for p in sources() + sorted(_ZSTD.rglob("*.h")):
        h.update(str(p.relative_to(_HERE)).encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def library_path() -> pathlib.Path:
    return BUILD_DIR / f"libsz_host_{_digest()}.so"


def build() -> pathlib.Path:
    """Compile the host runtime unless the hashed library exists."""
    so = library_path()
    if so.exists():
        return so
    cc = shutil.which("cc")
    if cc is None:
        raise RuntimeError("sz_tpu_torch needs a C compiler (cc) on PATH "
                           "to build its host runtime")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / "host.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if so.exists():
            return so
        inc = ["-I", str(_ZSTD), "-I", str(_ZSTD / "common")]
        with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
            objs, procs = [], []
            for i, src in enumerate(sources()):
                obj = pathlib.Path(tmp) / f"{i}_{src.stem}.o"
                objs.append(str(obj))
                procs.append(subprocess.Popen(
                    [cc, *CFLAGS, *inc, "-c", str(src), "-o", str(obj)],
                    stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                    text=True))
            errors = [p.communicate()[0] for p in procs]
            if any(p.returncode for p in procs):
                raise RuntimeError("cc failed:\n" + "\n".join(errors))
            out = pathlib.Path(tmp) / so.name
            link = subprocess.run([cc, "-shared", *objs, "-o", str(out),
                                   "-lm", "-lpthread"],
                                  capture_output=True, text=True)
            if link.returncode:
                raise RuntimeError(f"linking the host runtime failed:\n"
                                   f"{link.stdout}{link.stderr}")
            os.replace(out, so)
    return so


@functools.lru_cache(maxsize=None)
def lib() -> ctypes.CDLL:
    """The loaded host runtime (built on first call)."""
    dll = ctypes.CDLL(str(build()))
    for name, (argtypes, restype) in _SIGNATURES.items():
        fn = getattr(dll, name)
        fn.argtypes = argtypes
        fn.restype = restype
    return dll


@functools.lru_cache(maxsize=None)
def tune_malloc() -> None:
    """Raise glibc's mmap threshold (M_MMAP_THRESHOLD = -3) once, as
    sz_tpu's host runtime does, so the codec's large host buffers (the
    field, its reconstruction, the coded stream: hundreds of MB a call)
    come from the reusable heap instead of fresh mmaps that are unmapped
    on free and page-fault again on the next call (the device-to-host
    copy of a 512^3 reconstruction pays those faults).  The entry
    points call it."""
    try:
        ctypes.CDLL("libc.so.6").mallopt(ctypes.c_int(-3),
                                         ctypes.c_int(2**31 - 1))
    except OSError:  # not glibc
        pass


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.c_void_p)


def seq_sum_f32(vals: np.ndarray) -> np.float32:
    """Strictly ordered float32 accumulation (C ``acc += x``)."""
    vals = np.ascontiguousarray(vals, dtype=np.float32)
    return np.float32(lib().seq_sum_f32(_ptr(vals), vals.size))


def coeff_chain(coeffs: np.ndarray, precision: np.ndarray, use_mean: bool,
                capacity: int, radius: int):
    """Encode-side float32 coefficient chain.  Returns (ctypes[nc,nreg],
    unpred per coeff, qcoeffs[nreg,nc])."""
    coeffs = np.ascontiguousarray(coeffs, dtype=np.float32)
    nreg, nc = coeffs.shape
    ct = np.zeros((nc, max(nreg, 1)), dtype=np.int32)
    unpred = np.zeros((nc, max(nreg, 1)), dtype=np.float32)
    ucnt = np.zeros(8, dtype=np.int64)
    qc = np.zeros((nreg, nc), dtype=np.float32)
    if nreg:
        lib().coeff_chain_f32(
            _ptr(coeffs), nreg, nc,
            _ptr(np.ascontiguousarray(precision, np.float32)),
            1 if use_mean else 0, _ptr(ct), _ptr(unpred), _ptr(ucnt),
            _ptr(qc), capacity, radius)
    ulist = [unpred[e, :ucnt[e]].copy() for e in range(nc)]
    return ct[:, :nreg], ulist, qc


def coeff_chain_decode(ctypes_arr: np.ndarray, precision: np.ndarray,
                       cradius: np.ndarray, unpred_list) -> np.ndarray:
    """Decode-side float32 coefficient chain: qcoeffs[nreg, nc]."""
    nc, nreg = ctypes_arr.shape
    stride = max([len(u) for u in unpred_list] + [1])
    up = np.zeros((nc, stride), dtype=np.float32)
    for e, u in enumerate(unpred_list):
        up[e, :len(u)] = u
    qc = np.zeros((nreg, nc), dtype=np.float32)
    lib().coeff_chain_decode_f32(
        _ptr(np.ascontiguousarray(ctypes_arr, np.int32)), nreg, nc,
        _ptr(np.ascontiguousarray(precision, np.float32)),
        _ptr(np.ascontiguousarray(cradius, np.int32)), _ptr(up),
        _ptr(np.array([stride], dtype=np.int64)), _ptr(qc))
    return qc


def huff_build_tree(freq: np.ndarray, state_num: int, node_count: int):
    """Reference-exact Huffman tree build.  Returns
    (code_hi, code_lo, code_len, L, R, C, T)."""
    freq = np.ascontiguousarray(freq, dtype=np.int64)
    code_hi = np.zeros(state_num, dtype=np.uint64)
    code_lo = np.zeros(state_num, dtype=np.uint64)
    code_len = np.zeros(state_num, dtype=np.uint8)
    L = np.zeros(node_count, dtype=np.uint32)
    R = np.zeros(node_count, dtype=np.uint32)
    C = np.zeros(node_count, dtype=np.uint32)
    T = np.zeros(node_count, dtype=np.uint8)
    rc = int(lib().huff_build_tree(
        _ptr(freq), freq.size, state_num, _ptr(code_hi), _ptr(code_lo),
        _ptr(code_len), _ptr(L), _ptr(R), _ptr(C), _ptr(T)))
    if rc != node_count:
        raise ValueError(f"Huffman tree of {node_count} nodes expected, "
                         f"the build returned {rc}")
    return code_hi, code_lo, code_len, L, R, C, T


def zstd_compress(data: bytes, level: int) -> bytes:
    """Single-shot ZSTD_compress with zstd 1.3.5 (utility.c:174)."""
    z = lib()
    bound = z.ZSTD_compressBound(len(data))
    dst = ctypes.create_string_buffer(bound)
    r = z.ZSTD_compress(dst, bound, data, len(data), level)
    if z.ZSTD_isError(r):
        raise RuntimeError(f"ZSTD_compress error code {r}")
    return dst.raw[:r]


def zstd_frame_content_size(blob: bytes) -> int:
    """The frame header's content size, or -1 when unknown or invalid."""
    v = lib().ZSTD_getFrameContentSize(blob, len(blob))
    return -1 if v >= 2**64 - 2 else int(v)


def zstd_decompress(blob: bytes, capacity: int) -> bytes:
    z = lib()
    dst = ctypes.create_string_buffer(capacity)
    r = z.ZSTD_decompress(dst, capacity, blob, len(blob))
    if z.ZSTD_isError(r):
        raise ValueError(f"ZSTD_decompress error code {r}")
    return dst.raw[:r]
