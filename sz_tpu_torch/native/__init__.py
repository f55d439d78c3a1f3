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

from sz_tpu_torch.config import float_type

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
    "seq_sum_f64": ((_P, _I64), ctypes.c_double),
    "coeff_chain_f32": ((_P, _I64, _I, _P, _I, _P, _P, _P, _P, _I, _I),
                        None),
    "coeff_chain_f64": ((_P, _I64, _I, _P, _I, _P, _P, _P, _P, _I, _I),
                        None),
    "coeff_chain_decode_f32": ((_P, _I64, _I, _P, _P, _P, _P, _P), None),
    "coeff_chain_decode_f64": ((_P, _I64, _I, _P, _P, _P, _P, _P), None),
    "huff_build_tree": ((_P, _I64, _I64, _P, _P, _P, _P, _P, _P, _P), _I64),
    "exact_stream_f32": ((_P, _I64, _I, ctypes.c_float, _I, _P, _P, _P, _P,
                          _P, _P), None),
    "exact_stream_f64": ((_P, _I64, _I, ctypes.c_double, _I, _P, _P, _P,
                          _P, _P, _P), None),
    "classic1d_encode_f32": ((_P, _I64, ctypes.c_float, ctypes.c_double, _I,
                              _I, _I, ctypes.c_float, _I, _P, _P, _P, _P,
                              _P), _I64),
    "classic1d_encode_f64": ((_P, _I64, ctypes.c_double, ctypes.c_double,
                              _I, _I, _I, ctypes.c_double, _I, _P, _P, _P,
                              _P, _P), _I64),
    "classic1d_decode_f32": ((_P, _I64, ctypes.c_float, _I, _I,
                              ctypes.c_float, _I, _P, _P, _P, _P), None),
    "classic1d_decode_f64": ((_P, _I64, ctypes.c_double, _I, _I,
                              ctypes.c_double, _I, _P, _P, _P, _P), None),
    "msst19_encode1d_f32": ((_P, _I64, _P, _I64, _I64, _I, _I64, _P, _I,
                             _P, _P, _P, _P, _P), _I64),
    "msst19_decode1d_f32": ((_P, _I64, _P, _I, _P, _P, _P, _P), None),
    "msst19_encode1d_f64": ((_P, _I64, _P, _I64, _I64, _I, _I64, _P, _I,
                             _P, _P, _P, _P, _P), _I64),
    "msst19_decode1d_f64": ((_P, _I64, _P, _I, _P, _P, _P, _P), None),
    "v_log2_f64": ((_P, _P, _I64), None),
    "v_exp2_f64": ((_P, _P, _I64), None),
    "range_scan_f32": ((_P, _I64, _P, _P, _P, _P), _I),
    "range_scan_f64": ((_P, _I64, _P, _P, _P, _P), _I),
    "ra_coeff_chain_f32": ((_P, _I64, _I, _P, _I, _I, _P, _P, _P, _P), None),
    "ra_coeff_chain_decode_f32": ((_P, _I64, _I, _P, _P, _P, _P, _P), None),
    "huff_block_sizes": ((_P, _I64, _I64, _P, _P), _I64),
    "huff_encode_blocks": ((_P, _I64, _I64, _P, _P, _P, _P, _P), None),
    "huff_tree_decode_blocks": ((_P, _P, _P, _P, _P, _P, _P, _I64, _I64, _P),
                                None),
    "int1d_encode": ((_P, _I, _I, _I64, ctypes.c_double, _I, _I, _I, _I,
                      _I64, _I, _I, _P, _P), _I64),
    "int1d_decode": ((_P, _I64, ctypes.c_double, _I, _I, _I, _I64, _I, _I,
                      _P, _P), None),
    "msst19_build_table": ((_P, _I64, ctypes.c_double, _I, _I64, _I64, _P),
                           None),
    "pack_w_bits": ((_P, _I64, _I, _P), None),
    "ompblock_encode_f32": ((_P, _I64, _I64, _I64, ctypes.c_double,
                             ctypes.c_double, ctypes.c_float, _I, _I, _I, _P,
                             _P), _I64),
    "ompblock_encode_f64": ((_P, _I64, _I64, _I64, ctypes.c_double,
                             ctypes.c_double, ctypes.c_double, _I, _I, _I,
                             _P, _P), _I64),
    "ompblock_decode_f32": ((_P, _I64, _I64, _I64, ctypes.c_float,
                             ctypes.c_double, ctypes.c_float, _I, _I, _P, _P),
                            None),
    "ompblock_decode_f64": ((_P, _I64, _I64, _I64, ctypes.c_double,
                             ctypes.c_double, ctypes.c_double, _I, _I, _P,
                             _P), None),
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
    """Raise glibc's mmap threshold (M_MMAP_THRESHOLD = -3), as sz_tpu's
    host runtime does, and its trim threshold (M_TRIM_THRESHOLD = -1), so
    the codec's large host buffers (the field, its reconstruction, the
    coded stream: hundreds of MB a call) come from the reusable heap and
    stay mapped when freed.  Otherwise a buffer freed at the top of the
    heap is given back to the system and page-faults again on the next
    call: the device-to-host copy of a 512^3 reconstruction then pays
    those faults, 0.2-0.3 s more a decompress on an H100 host (PERF.md).
    The entry points call it."""
    try:
        libc = ctypes.CDLL("libc.so.6")
    except OSError:  # not glibc
        return
    for param in (-3, -1):
        libc.mallopt(ctypes.c_int(param), ctypes.c_int(2**31 - 1))


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.c_void_p)


def _suffix(T) -> str:
    return "f32" if T is np.float32 else "f64"


def seq_sum(vals: np.ndarray):
    """Strictly ordered accumulation (C ``T acc += x``) in the dtype of
    ``vals``, float32 or float64."""
    vals = np.ascontiguousarray(vals)
    T = float_type(vals.dtype)
    fn = getattr(lib(), f"seq_sum_{_suffix(T)}")
    return T(fn(_ptr(vals), vals.size))


def coeff_chain(coeffs: np.ndarray, precision: np.ndarray, use_mean: bool,
                capacity: int, radius: int):
    """Encode-side coefficient chain in the dtype of ``coeffs`` (float32
    or float64).  Returns (ctypes[nc,nreg], unpred per coeff,
    qcoeffs[nreg,nc])."""
    coeffs = np.ascontiguousarray(coeffs)
    T = float_type(coeffs.dtype)
    nreg, nc = coeffs.shape
    ct = np.zeros((nc, max(nreg, 1)), dtype=np.int32)
    unpred = np.zeros((nc, max(nreg, 1)), dtype=T)
    ucnt = np.zeros(8, dtype=np.int64)
    qc = np.zeros((nreg, nc), dtype=T)
    if nreg:
        getattr(lib(), f"coeff_chain_{_suffix(T)}")(
            _ptr(coeffs), nreg, nc,
            _ptr(np.ascontiguousarray(precision, T)),
            1 if use_mean else 0, _ptr(ct), _ptr(unpred), _ptr(ucnt),
            _ptr(qc), capacity, radius)
    ulist = [unpred[e, :ucnt[e]].copy() for e in range(nc)]
    return ct[:, :nreg], ulist, qc


def coeff_chain_decode(ctypes_arr: np.ndarray, precision: np.ndarray,
                       cradius: np.ndarray, unpred_list) -> np.ndarray:
    """Decode-side coefficient chain in the dtype of ``precision``
    (float32 or float64): qcoeffs[nreg, nc]."""
    T = float_type(np.asarray(precision).dtype)
    nc, nreg = ctypes_arr.shape
    stride = max([len(u) for u in unpred_list] + [1])
    up = np.zeros((nc, stride), dtype=T)
    for e, u in enumerate(unpred_list):
        up[e, :len(u)] = u
    qc = np.zeros((nreg, nc), dtype=T)
    getattr(lib(), f"coeff_chain_decode_{_suffix(T)}")(
        _ptr(np.ascontiguousarray(ctypes_arr, np.int32)), nreg, nc,
        _ptr(np.ascontiguousarray(precision, T)),
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


def _escape_buffers(n: int, req_length: int):
    """Output buffers of an escape stream of at most n values: lead
    (u8 a value), mid (req_length // 8 bytes a value), resi (u8 a
    value) and the mid count."""
    rb = req_length // 8
    return (np.zeros(max(n, 1), np.uint8),
            np.zeros(max(n * max(rb, 1), 1), np.uint8),
            np.zeros(max(n, 1), np.uint8), np.zeros(1, np.int64))


def _escape_parts(lead, mid, resi, nmid, cnt: int, req_length: int,
                  esize: int):
    """(lead u8[cnt], mid bytes, resi u8 entries) of a finished escape
    stream: resi holds an entry a value only when req_length leaves a
    partial byte."""
    has_resi = (req_length % 8) != 0 and req_length // 8 < esize
    return (lead[:cnt], mid[:int(nmid[0])].tobytes(),
            resi[:cnt] if has_resi else resi[:0])


def exact_stream(vals: np.ndarray, req_length: int, median, raw: bool,
                 prev: bytes):
    """Batched exact-value escape stream of float32 or float64 values
    (the dtype of ``vals``), with the median offset unless ``raw``.
    Returns (lead u8[n], mid bytes, resi u8[<=n], recon, new_prev)."""
    vals = np.ascontiguousarray(vals)
    T = float_type(vals.dtype)
    esize = np.dtype(T).itemsize
    n = vals.size
    lead, mid, resi, nmid = _escape_buffers(n, req_length)
    recon = np.zeros(n, T)
    prev_io = np.zeros(8, np.uint8)
    prev_io[:len(prev)] = np.frombuffer(prev, np.uint8)
    getattr(lib(), f"exact_stream_{_suffix(T)}")(
        _ptr(vals), n, req_length, float(median), 1 if raw else 0,
        _ptr(prev_io), _ptr(lead), _ptr(mid), _ptr(nmid), _ptr(resi),
        _ptr(recon))
    return (*_escape_parts(lead, mid, resi, nmid, n, req_length, esize),
            recon, prev_io[:esize].tobytes())


def classic1d_encode(x: np.ndarray, rp, intervals: int, radius: int,
                     req_length: int, median, *, subblock: bool = False,
                     rp64: float | None = None):
    """The classic 1-D encode of a float32 or float64 field (the dtype of
    ``x``); ``subblock`` takes SZ_compress_args3's kernel, which
    quantizes on ``rp64`` (the double precision; default ``rp``).
    Returns (types i32[n], lead u8, mid bytes, resi u8 entries, escape
    count)."""
    x = np.ascontiguousarray(x)
    T = float_type(x.dtype)
    n = x.size
    types = np.zeros(n, np.int32)
    lead, mid, resi, nmid = _escape_buffers(n, req_length)
    cnt = int(getattr(lib(), f"classic1d_encode_{_suffix(T)}")(
        _ptr(x), n, float(rp), float(rp if rp64 is None else rp64),
        int(intervals), int(radius), req_length, float(median),
        int(subblock), _ptr(types), _ptr(lead), _ptr(mid), _ptr(nmid),
        _ptr(resi)))
    return (types, *_escape_parts(lead, mid, resi, nmid, cnt, req_length,
                                  np.dtype(T).itemsize), cnt)


def _stream_arrays(lead, mid: bytes, resi: bytes):
    lead = np.ascontiguousarray(lead, np.uint8)
    midb = np.frombuffer(mid, np.uint8) if len(mid) else np.zeros(1, np.uint8)
    resb = (np.frombuffer(resi, np.uint8) if len(resi)
            else np.zeros(1, np.uint8))
    return lead, midb, resb


def classic1d_decode(types: np.ndarray, interval2, radius: int,
                     req_length: int, median, raw: bool, lead: np.ndarray,
                     mid: bytes, resi: bytes, T=np.float32) -> np.ndarray:
    """The classic 1-D decoder in ``T`` (escapes from the exact-value
    stream, the rest from the types); with every type 0 it decodes the
    escape stream alone."""
    types = np.ascontiguousarray(types, np.int32)
    n = types.size
    lead, midb, resb = _stream_arrays(lead, mid, resi)
    out = np.zeros(n, T)
    getattr(lib(), f"classic1d_decode_{_suffix(T)}")(
        _ptr(types), n, float(interval2), radius, req_length, float(median),
        1 if raw else 0, _ptr(lead), _ptr(midb), _ptr(resb), _ptr(out))
    return out


def msst19_encode1d(x: np.ndarray, table: np.ndarray, base_index: int,
                    top_index: int, bits: int, ptable: np.ndarray,
                    req_length: int):
    """The 1-D MSST19 encode of a float32 or float64 field (the dtype of
    ``x``) whose zeros the caller replaced.  Returns (types, lead u8, mid
    bytes, resi u8 entries, escape count)."""
    x = np.ascontiguousarray(x)
    T = float_type(x.dtype)
    n = x.size
    table = np.ascontiguousarray(table, np.uint16)
    ptable = np.ascontiguousarray(ptable, np.float64)
    types = np.zeros(n, np.int32)
    lead, mid, resi, nmid = _escape_buffers(n, req_length)
    cnt = int(getattr(lib(), f"msst19_encode1d_{_suffix(T)}")(
        _ptr(x), n, _ptr(table), base_index, top_index, bits,
        table.shape[1], _ptr(ptable), req_length, _ptr(types), _ptr(lead),
        _ptr(mid), _ptr(nmid), _ptr(resi)))
    return (types, *_escape_parts(lead, mid, resi, nmid, cnt, req_length,
                                  np.dtype(T).itemsize), cnt)


def msst19_decode1d(types: np.ndarray, ptable: np.ndarray, req_length: int,
                    lead: np.ndarray, mid: bytes, resi: bytes,
                    T=np.float32) -> np.ndarray:
    """The 1-D MSST19 decode in ``T`` (float32 or float64): before the
    zero and sign restore."""
    types = np.ascontiguousarray(types, np.int32)
    ptable = np.ascontiguousarray(ptable, np.float64)
    lead, midb, resb = _stream_arrays(lead, mid, resi)
    out = np.zeros(types.size, T)
    getattr(lib(), f"msst19_decode1d_{_suffix(T)}")(
        _ptr(types), types.size, _ptr(ptable), req_length, _ptr(lead),
        _ptr(midb), _ptr(resb), _ptr(out))
    return out


def v_log2(x: np.ndarray) -> np.ndarray:
    """glibc log2 per element, in float64 (numpy's SIMD log2 differs in
    the last ulp, which float64 pre-log streams serialize)."""
    x = np.ascontiguousarray(x, np.float64)
    out = np.empty_like(x)
    lib().v_log2_f64(_ptr(x), _ptr(out), x.size)
    return out


def v_exp2(x: np.ndarray) -> np.ndarray:
    """glibc exp2 per element, in float64."""
    x = np.ascontiguousarray(x, np.float64)
    out = np.empty_like(x)
    lib().v_exp2_f64(_ptr(x), _ptr(out), x.size)
    return out


def range_scan(flat: np.ndarray):
    """(fmin, fmax, near, signs u8[n], positive) of a float32 or float64
    field (its dtype) in one pass (computeRangeSize_*_MSST19)."""
    flat = np.ascontiguousarray(flat)
    T = float_type(flat.dtype)
    c = ctypes.c_float if T is np.float32 else ctypes.c_double
    signs = np.zeros(flat.size, np.uint8)
    mn, mx, nr = c(0), c(0), c(0)
    pos = getattr(lib(), f"range_scan_{_suffix(T)}")(
        _ptr(flat), flat.size, _ptr(signs), ctypes.byref(mn),
        ctypes.byref(mx), ctypes.byref(nr))
    return T(mn.value), T(mx.value), T(nr.value), signs, bool(pos)


def msst19_build_table(pt: np.ndarray, precision: float, bits: int,
                       base_index: int, nsub: int) -> np.ndarray:
    """The MSST19 cache table: (nsub, 2^bits) uint16 states."""
    pt = np.ascontiguousarray(pt, np.float64)
    table = np.zeros((nsub, 1 << bits), np.uint16)
    lib().msst19_build_table(_ptr(pt), pt.size, precision, bits, base_index,
                             nsub, _ptr(table))
    return table


def ra_coeff_chain(coeffs: np.ndarray, prec, cap: int, radius: int):
    """The random-access codec's coefficient chain (float32 coefficients,
    double division).  Returns (ctypes (nc, nreg), escape values per
    coefficient, qcoeffs (nreg, nc))."""
    coeffs = np.ascontiguousarray(coeffs, np.float32)
    nreg, nc = coeffs.shape
    ct = np.zeros((nc, max(nreg, 1)), np.int32)
    unpred = np.zeros((nc, max(nreg, 1)), np.float32)
    ucnt = np.zeros(nc, np.int64)
    qc = np.zeros((nreg, nc), np.float32)
    lib().ra_coeff_chain_f32(
        _ptr(coeffs), nreg, nc, _ptr(np.ascontiguousarray(prec, np.float64)),
        cap, radius, _ptr(ct), _ptr(unpred), _ptr(ucnt), _ptr(qc))
    return ct[:, :nreg], [unpred[e, :ucnt[e]].copy() for e in range(nc)], qc


def ra_coeff_chain_decode(ctypes_arr: np.ndarray, prec, cradius,
                          unpred_list, nreg: int) -> np.ndarray:
    """Its decode: qcoeffs (nreg, nc)."""
    ct = np.ascontiguousarray(np.asarray(ctypes_arr)[:, :nreg], np.int32)
    nc = ct.shape[0]
    lens = [len(u) for u in unpred_list]
    off = np.zeros(nc, np.int64)
    np.cumsum(lens[:-1], out=off[1:])
    flat = (np.concatenate([np.asarray(u, np.float32) for u in unpred_list])
            if sum(lens) else np.zeros(1, np.float32))
    qc = np.zeros((nreg, nc), np.float32)
    lib().ra_coeff_chain_decode_f32(
        _ptr(ct), nreg, nc, _ptr(np.ascontiguousarray(prec, np.float64)),
        _ptr(np.ascontiguousarray(cradius, np.int32)), _ptr(flat), _ptr(off),
        _ptr(qc))
    return qc


def huff_encode_blocks(syms: np.ndarray, code_hi: np.ndarray,
                       code_lo: np.ndarray, code_len: np.ndarray):
    """(nb, ncell) int32 symbols coded with one shared table into
    byte-aligned per-block streams.  Returns (sizes u32[nb], bytes)."""
    syms = np.ascontiguousarray(syms, np.int32)
    nb, ncell = syms.shape
    lens = np.ascontiguousarray(code_len, np.uint8)
    sizes = np.zeros(nb, np.uint32)
    total = int(lib().huff_block_sizes(_ptr(syms), nb, ncell, _ptr(lens),
                                       _ptr(sizes)))
    out = np.zeros(total, np.uint8)
    if total:
        lib().huff_encode_blocks(
            _ptr(syms), nb, ncell,
            _ptr(np.ascontiguousarray(code_hi, np.uint64)),
            _ptr(np.ascontiguousarray(code_lo, np.uint64)), _ptr(lens),
            _ptr(sizes), _ptr(out))
    return sizes, out.tobytes()


def huff_tree_decode_blocks(L, R, C, T, data, offsets: np.ndarray,
                            sizes: np.ndarray, count: int) -> np.ndarray:
    """Decode len(offsets) per-block streams of ``count`` symbols each:
    block b's ``sizes[b]`` bytes at ``data[offsets[b]:]``."""
    offsets = np.ascontiguousarray(offsets, np.int64)
    nsel = offsets.size
    buf = np.frombuffer(data, np.uint8)
    out = np.zeros((nsel, count), np.int32)
    if nsel and count:
        lib().huff_tree_decode_blocks(
            _ptr(np.ascontiguousarray(L, np.int32)),
            _ptr(np.ascontiguousarray(R, np.int32)),
            _ptr(np.ascontiguousarray(C, np.int32)),
            _ptr(np.ascontiguousarray(T, np.uint8)), _ptr(buf),
            _ptr(offsets), _ptr(np.ascontiguousarray(sizes, np.int64)),
            nsel, count, _ptr(out))
    return out


def int1d_encode(data: np.ndarray, rp: float, intervals: int, radius: int,
                 a1_dtype, min_value: int, byte_size: int, store_esize: int):
    """The 1-D integer encode: the previous-value chain wrapped to
    ``a1_dtype``.  Returns (types, exact bytes, escape count)."""
    x = np.ascontiguousarray(data)
    n = x.size
    a1 = np.dtype(a1_dtype)
    types = np.zeros(n, np.int32)
    exact = np.zeros(max(n * byte_size, 1), np.uint8)
    cnt = int(lib().int1d_encode(
        _ptr(x), x.dtype.itemsize, 1 if x.dtype.kind == "i" else 0, n,
        float(rp), int(intervals), int(radius), a1.itemsize * 8,
        1 if a1.kind == "i" else 0, int(min_value), byte_size, store_esize,
        _ptr(types), _ptr(exact)))
    return types, exact[:cnt * byte_size].tobytes(), cnt


def int1d_decode(types: np.ndarray, interval2: float, radius: int,
                 out_dtype, min_value: int, byte_size: int, store_esize: int,
                 exact: bytes) -> np.ndarray:
    """Its decode, in ``out_dtype``."""
    types = np.ascontiguousarray(types, np.int32)
    dt = np.dtype(out_dtype)
    eb = (np.frombuffer(exact, np.uint8) if len(exact)
          else np.zeros(1, np.uint8))
    out = np.zeros(types.size, np.int64)
    lib().int1d_decode(
        _ptr(types), types.size, float(interval2), int(radius),
        dt.itemsize * 8, 1 if dt.kind == "i" else 0, int(min_value),
        byte_size, store_esize, _ptr(eb), _ptr(out))
    return out.astype(dt)


def pack_w_bits(vals: np.ndarray, w: int) -> bytes:
    """MSB-first fixed-width (w < 8) bit pack, zero-padded to a byte
    (convertIntArray2ByteArray_fast_dynamic, TypeManager.c:377)."""
    vals = np.ascontiguousarray(vals, np.uint8)
    n = vals.size
    out = np.zeros((n * w + 7) // 8, np.uint8)
    if n:
        lib().pack_w_bits(_ptr(vals), n, w, _ptr(out))
    return out.tobytes()


def ompblock_encode(block: np.ndarray, rp, intervals: int, radius: int):
    """One block of the sz_omp format (the classic scheme, the first value
    predicted from itself, escapes raw): float32 quantizes in float with
    the float reciprocal, float64 in double.  Returns (types i32, the
    escapes' values)."""
    x = np.ascontiguousarray(block)
    T = float_type(x.dtype)
    r1, r2, r3 = x.shape
    types = np.zeros(x.size, np.int32)
    unpred = np.zeros(max(x.size, 1), T)
    f32 = T is np.float32
    recip64 = (float(np.float32(1) / np.float32(rp)) if f32
               else 1.0 / float(rp))
    cnt = int(getattr(lib(), f"ompblock_encode_{_suffix(T)}")(
        _ptr(x), r1, r2, r3, float(rp), recip64, float(rp), int(intervals),
        int(radius), int(not f32), _ptr(types), _ptr(unpred)))
    return types, unpred[:cnt].copy()


def ompblock_decode(types: np.ndarray, shape, mean, rp, radius: int,
                    unpred: np.ndarray, T) -> np.ndarray:
    """The inverse of :func:`ompblock_encode` for a block of ``shape``
    whose first value's seed is ``mean``."""
    T = float_type(T)
    r1, r2, r3 = shape
    out = np.zeros(r1 * r2 * r3, T)
    up = np.ascontiguousarray(unpred, T) if len(unpred) else np.zeros(1, T)
    getattr(lib(), f"ompblock_decode_{_suffix(T)}")(
        _ptr(np.ascontiguousarray(types, np.int32)), r1, r2, r3,
        float(mean), float(rp), float(rp), int(radius),
        int(T is np.float64), _ptr(up), _ptr(out))
    return out.reshape(shape)


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
