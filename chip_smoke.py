#!/usr/bin/env python3
"""Bring-up check of the PyTorch/CUDA port (sz_tpu_torch) on one GPU.

Run from the root of a checkout, on a machine with an NVIDIA Hopper card,
nvcc (CUDA_HOME, PATH or /usr/local/cuda) and a C compiler (cc):

    python3 chip_smoke.py [--out FILE.json]

Phases (one line of numbers each; any failure raises and exits non-zero):
  1. environment: versions, card name and power limit, the kernel build
     (one nvcc per source, in parallel) and the host runtime build (cc);
  2. each Hopper kernel bit-equal to its plain torch version on the
     card, with both times: K1-K4 at their test shapes, and K5-K7 (the
     Huffman decode) on skewed streams, trees past 8192 nodes (table in
     shared memory and in L2), a stream past 2^31 bits, a code of 1100
     bits, and a stream of the 512^3 stream's size whose chunks never
     self-synchronize, each with its K6 steps and decode time;
  3. the main path, sz_tpu_torch.compress/decompress on the card: each
     stream and reconstruction hashes to the SHA-256 of the host
     oracle's (sz_tpu, engine="numpy"; recomputed on the CPU by
     tests/test_torch_smoke_oracle.py), and the reference golden stream
     decodes bit-equal; the launch counters of K1-K7 must all rise;
  4. 512^3 float32 (NYX scale): the error bound holds, compress and
     decompress MB/s (warm, best of 3) with per-span times and counts,
     the kernel launches of one decompress, the device-to-host copy of
     537 MB, the decompress of bench.py's synth field (the earlier
     records' input), and K5-K7 timed against their plain versions on
     the main-path stream.
The last two lines are the kernel record and {"ok": true, "device": ...}.
Without CUDA, or outside a checkout, it fails without a result.  It
imports neither jax nor any module of sz_tpu.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import pathlib
import subprocess
import sys
import time

import numpy as np

REPO = pathlib.Path(__file__).resolve().parent
ABS = 1e-3
HBM_BYTES_PER_S = 3.35e12     # H100 SXM device memory (data sheet)
OPS_PER_S_32BIT = 67e12       # H100 SXM 32-bit rate outside tensor cores


def _log(phase: str, **nums) -> None:
    print(f"[{phase}] " + json.dumps(nums, default=float), flush=True)


# --- phase 3/4 inputs: exact float32 arithmetic, the same on any machine --

def field(shape, seed: int) -> np.ndarray:
    """A smooth saddle + parabola + ramp with uniform integer noise.
    Every term is an integer times a power of two and every partial sum
    fits float32's 24-bit significand, so no operation rounds and the
    field is bit-identical on every machine and numpy build."""
    f32 = np.float32
    rng = np.random.default_rng(seed)
    rank = len(shape)
    half = [r // 2 for r in shape]

    def pow2_at_least(m):
        return f32(2.0 ** -int(np.ceil(np.log2(max(m, 2)))))

    axes = []
    for k, r in enumerate(shape):
        sh = [1] * rank
        sh[k] = r
        axes.append((np.arange(r, dtype=f32) - f32(half[k])).reshape(sh))
    u, v, w = axes[0], axes[1], axes[-1]
    s = u * v * pow2_at_least(half[0] * half[1])
    s = s + u * u * pow2_at_least(half[0] ** 2)
    s = s + w * pow2_at_least(half[-1])
    noise = rng.integers(-100, 101, shape).astype(f32) * f32(2.0 ** -10)
    return (s + noise).astype(f32)


# name -> (shape, seed, SHA-256 of the oracle's stream, of its decode)
ORACLE = {
    "field_256": (
        (256, 256, 256), 42,
        "1be8a98323bdc1df439df6b166d2da863e3687b9368d288343031b5a0d4fb26d",
        "06d602dee1c360a975c3fc7676e85fd5abd84d000bf68d2eeb5115962ed8b89f"),
    "hurricane_100x500x500": (
        (100, 500, 500), 5,
        "74e515e2cb750fcba306414210711ce1847ca961691f96f5dfb2fd1a3fa1e40b",
        "13e09220e3ec7cba4facd18ebf21d0ac83b4b3118dcf25f72a1d4ada27d5f9d4"),
    "cesm_atm_1800x3600": (
        (1800, 3600), 6,
        "4f3d7430841f4949d87180b275066ac3767c7a8966e025623ec621c77740b4e4",
        "55922cef704e700aa34f730f9f96381dd018067bf03ee460893b223173bd32af"),
}


def sha256(b) -> str:
    return hashlib.sha256(b).hexdigest()


# --- timing and comparison helpers ----------------------------------------

def cuda_ms(fn, reps: int) -> float:
    """Mean device milliseconds of fn() over reps runs, after one warm-up."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def bit_equal(a, b) -> bool:
    import torch
    if a.dtype == torch.float32:
        return torch.equal(a.view(torch.int32), b.view(torch.int32))
    return torch.equal(a, b)


def max_abs_err(a, b) -> float:
    """0.0 for bit-equal tensors, else the largest |a - b| (NaN counts as
    infinitely far)."""
    if bit_equal(a, b):
        return 0.0
    return float((a.double() - b.double()).abs().nan_to_num(float("inf"))
                 .max())


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts if t is not None)


def bound(moved_bytes: int, ops: int = 0) -> tuple:
    """(least ms, what bounds it): the bytes the function must move over
    the memory rate, or its operations over the 32-bit peak rate."""
    tb, to = moved_bytes / HBM_BYTES_PER_S, ops / OPS_PER_S_32BIT
    return 1e3 * max(tb, to), ("bytes" if tb >= to else "operations")


# --- phase 2: K1-K4 -------------------------------------------------------

RADIUS = 32
RP = np.float32(1e-3)
RECIP = np.float32(np.float32(1) / RP)
CAP_SZF = np.float32(2 * RADIUS - 2)
MEAN = np.float32(0.25)


def k1_inputs(shape, seed, dev):
    import torch
    rng = np.random.default_rng(seed)
    n = int(np.prod(shape))
    data = (np.sin(np.linspace(0, 12, n, dtype=np.float32))
            + 0.02 * rng.standard_normal(n)).astype(np.float32).reshape(shape)
    data[rng.random(shape) < 0.1] = MEAN
    reg = rng.random(shape) < 0.3
    # regression points: codes >= 1 (an escaped one would carry rec = data)
    t_reg = rng.integers(1, 2 * RADIUS, shape).astype(np.int32)
    rec_reg = (data + rng.uniform(-1e-3, 1e-3, shape)).astype(np.float32)
    mean_mask = (~reg) & (np.abs(data - MEAN) <= RP)
    return [torch.from_numpy(a).to(dev)
            for a in (data, t_reg, rec_reg, reg, mean_mask)]


def k2_inputs(k1_args, t, use_mean: bool):
    """K2's inputs as a decoder derives them from K1's type lattice t
    (stages.decode_inputs): then K2 must rebuild K1's R bit for bit."""
    import torch
    data, _, rec_reg, reg, _ = k1_args
    esc = t == 0
    t_adj = t
    known_mask = esc | reg
    if use_mean:
        t_adj = torch.where((~reg) & (t < RADIUS), t + 1, t)
        known_mask = known_mask | ((~reg) & (t == RADIUS))
    q_lor = (2 * (t_adj - RADIUS)).to(torch.float32) * torch.tensor(
        RP, device=t.device)
    known = torch.where(esc, data, torch.where(reg, rec_reg, torch.tensor(
        MEAN, device=t.device)))
    return known_mask, known, q_lor


def fib_tables():
    """A Huffman table whose codes run past 32 and past 64 bits."""
    from sz_tpu_torch.format import huffman
    fib = [1, 1]
    while len(fib) < 90:
        fib.append(fib[-1] + fib[-2])
    freq = np.zeros(256, np.int64)
    freq[:90] = fib
    return huffman.build_tables(None, 128, freq=freq)


def u64_tensor(a, dev):
    import torch
    return torch.from_numpy(np.ascontiguousarray(
        a, np.uint64).view(np.int64)).to(dev)


def phase_kernels(dev) -> dict:
    """Phase 2, K1-K4: kernel vs plain version on the card (K2 on the
    inputs a decoder derives from K1's output, so it must also rebuild
    K1's R).  Returns the per-kernel record entries (times and bounds at
    the largest shape)."""
    import torch
    from sz_tpu_torch.gpu import hist_kernel as hk
    from sz_tpu_torch.gpu import lorenzo_kernel as lk
    from sz_tpu_torch.gpu import pack_kernel as pk

    entries = {}
    cases = [((64, 64, 64), False), ((64, 64, 64), True),
             ((25, 14, 20), True), ((150, 130), False),
             ((256, 256, 256), True)]
    scal = (RP, RECIP, CAP_SZF, RADIUS, MEAN)
    for shape, use_mean in cases:
        args = k1_inputs(shape, 1, dev)
        if not use_mean:
            args[4] = None
        t_k, R_k = lk.wavefront_quantize(*args, *scal, use_mean=use_mean,
                                         want_R=True)
        t_p, R_p = lk.quantize_plain(*args, *scal, use_mean=use_mean)
        err = max(max_abs_err(t_k, t_p), max_abs_err(R_k, R_p))
        ok = bit_equal(t_k, t_p) and bit_equal(R_k, R_p)
        ms = cuda_ms(lambda: lk.wavefront_quantize(
            *args, *scal, use_mean=use_mean), 5)
        plain_ms = cuda_ms(lambda: lk.quantize_plain(
            *args, *scal, use_mean=use_mean), 1)
        # K1 reads its five inputs and writes t and R
        b_ms, b_by = bound(nbytes(*args, t_k, R_k))
        _log("kernel K1 wavefront_quantize", shape=list(shape),
             use_mean=use_mean, bit_equal=ok, max_abs_err=err, ms=ms,
             plain_ms=plain_ms, bound_ms=b_ms)
        if not ok:
            raise AssertionError(f"K1 differs from its plain version at "
                                 f"{shape} use_mean={use_mean}")
        entries["wavefront_quantize"] = dict(
            max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
            bound_by=b_by, library_ms=None, shape=list(shape))
        dec = k2_inputs(args, t_k, use_mean)
        D_k, D_p = lk.wavefront_decode(*dec), lk.decode_plain(*dec)
        err = max_abs_err(D_k, D_p)
        ok = bit_equal(D_k, D_p) and bit_equal(D_k, R_k)
        ms = cuda_ms(lambda: lk.wavefront_decode(*dec), 5)
        plain_ms = cuda_ms(lambda: lk.decode_plain(*dec), 1)
        b_ms, b_by = bound(nbytes(*dec, D_k))
        _log("kernel K2 wavefront_decode", shape=list(shape),
             use_mean=use_mean, bit_equal=ok, rebuilds_K1_R=ok,
             max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms)
        if not ok:
            raise AssertionError(f"K2 differs from its plain version or "
                                 f"from K1's R at {shape}")
        entries["wavefront_decode"] = dict(
            max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
            bound_by=b_by, library_ms=None, shape=list(shape))

    rng = np.random.default_rng(3)
    n = 1 << 24
    sym = np.clip(rng.normal(32768, 20, n), 0, 65535).astype(np.int32)
    sym[rng.integers(0, n, n // 64)] = rng.integers(0, 65536, n // 64)
    sym[rng.random(n) < 0.02] = -1
    sym_d = torch.from_numpy(sym).to(dev)
    h_k, h_p = hk.histogram(sym_d), hk.histogram_plain(sym_d)
    err, ok = max_abs_err(h_k, h_p), torch.equal(h_k, h_p)
    ms = cuda_ms(lambda: hk.histogram(sym_d), 10)
    plain_ms = cuda_ms(lambda: hk.histogram_plain(sym_d), 10)
    # the library yardstick: torch.bincount on the in-range symbols
    # (bincount refuses the negative holes, so they are dropped first)
    valid = sym_d[sym_d >= 0]
    if not torch.equal(torch.bincount(valid, minlength=hk.NBINS).to(
            torch.int32), h_k):
        raise AssertionError("torch.bincount disagrees with K3")
    library_ms = cuda_ms(lambda: torch.bincount(valid, minlength=hk.NBINS),
                         10)
    b_ms, b_by = bound(nbytes(sym_d, h_k))
    _log("kernel K3 histogram", n=n, bit_equal=ok, max_abs_err=err, ms=ms,
         plain_ms=plain_ms, library_ms=library_ms, bound_ms=b_ms)
    if not ok:
        raise AssertionError("K3 differs from its plain version")
    entries["histogram"] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                                bound_ms=b_ms, bound_by=b_by,
                                library_ms=library_ms, shape=[n])

    tables = fib_tables()
    assert int(tables.code_len.max()) > 64
    s = rng.integers(-1, 90, n).astype(np.int32)
    total_bits = int(np.where(s >= 0, tables.code_len[np.maximum(s, 0)],
                              0).astype(np.int64).sum())
    s_d = torch.from_numpy(s).to(dev)
    hi, lo = u64_tensor(tables.code_hi, dev), u64_tensor(tables.code_lo, dev)
    ln = torch.from_numpy(tables.code_len.astype(np.int32)).to(dev)
    b_k = pk.pack_bits(s_d, hi, lo, ln, total_bits)
    b_p = pk.pack_bits_plain(s_d, hi, lo, ln, total_bits)
    err, ok = max_abs_err(b_k, b_p), torch.equal(b_k, b_p)
    ms = cuda_ms(lambda: pk.pack_bits(s_d, hi, lo, ln, total_bits), 10)
    plain_ms = cuda_ms(lambda: pk.pack_bits_plain(s_d, hi, lo, ln,
                                                  total_bits), 3)
    b_ms, b_by = bound(nbytes(s_d, hi, lo, ln, b_k))
    _log("kernel K4 pack_bits", n=n, total_bits=total_bits,
         max_code_bits=int(tables.code_len.max()), bit_equal=ok,
         max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms)
    if not ok:
        raise AssertionError("K4 differs from its plain version")
    entries["pack_bits"] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                                bound_ms=b_ms, bound_by=b_by,
                                library_ms=None, shape=[n])
    return entries


# --- phase 2: K5-K7 -------------------------------------------------------

def _zipf(rng, n, nstate, a):
    p = 1.0 / np.arange(1, nstate + 1) ** a
    return rng.choice(nstate, size=n, p=p / p.sum()).astype(np.int32)


def _on_card(t, enc, total_bits, dev):
    """(trans, padded coded stream, total bits, longest code) on the card
    for the tree of tables ``t`` (or an (L, R, C, T) tuple) and the coded
    bytes ``enc`` (a uint8 tensor on the card)."""
    import torch
    from sz_tpu_torch.gpu import fsm_kernel as fk
    L, R, C, T = (t.L, t.R, t.C, t.T) if hasattr(t, "L") else t
    depth = fk.code_depth(L, R, T)
    F = fk.chunk_bits(depth)
    bits = torch.zeros(fk.nchunks_of(8 * enc.numel(), F) * (F // 8),
                       dtype=torch.uint8, device=dev)
    bits[:enc.numel()] = enc
    trans = torch.from_numpy(fk.build_trans(L, R, C, T)).to(dev)
    return trans, bits, total_bits, depth


def _packed_on_card(types, nstate, dev):
    """(tables, on-card stream as _on_card gives it): the types
    Huffman-coded by K4 (checked against the plain K4 in phase 2)."""
    import torch
    from sz_tpu_torch.format import huffman
    from sz_tpu_torch.gpu import pack_kernel as pk
    t = huffman.build_tables(types, nstate)
    total = int(t.code_len[types].astype(np.int64).sum())
    enc = pk.pack_bits(torch.from_numpy(types).to(dev),
                       u64_tensor(t.code_hi, dev), u64_tensor(t.code_lo, dev),
                       torch.from_numpy(t.code_len.astype(np.int32)).to(dev),
                       total)
    return t, _on_card(t, enc, 8 * enc.numel(), dev)


def fsm_vs_plain(name, stream, n_sym, want=None, node_count=None) -> dict:
    """K5, every K6 step and K7 against their plain versions on one
    stream (n_sym None: decode every symbol the stream codes), and the
    whole decode timed."""
    import torch
    from sz_tpu_torch.gpu import fsm_kernel as fk
    trans, bits, total_bits, depth = stream
    gk, nk = fk.fsm_sweep(bits, trans, total_bits, depth)
    gp, np_ = fk.fsm_sweep_plain(bits, trans, total_bits, depth)
    ok = {"K5": torch.equal(gk, gp) and torch.equal(nk, np_), "K6": True}
    steps, stride = 0, 1
    while stride < gk.shape[0]:
        gk2, nk2 = fk.fsm_sync(gk, nk, stride)
        gp, np_ = fk.fsm_sync_plain(gk, nk, stride)
        ok["K6"] = ok["K6"] and torch.equal(gk2, gp) and torch.equal(nk2,
                                                                     np_)
        gk, nk, stride, steps = gk2, nk2, 2 * stride, steps + 1
    zero = torch.zeros(1, dtype=torch.int64, device=bits.device)
    entry = torch.cat([zero.to(torch.int32), gk[:-1, 0]])
    off = torch.cat([zero, nk[:-1, 0]])
    total = int(nk[-1, 0])
    del gk, nk, gp, np_
    n = total if n_sym is None else n_sym
    sk = fk.fsm_emit(bits, trans, total_bits, depth, entry, off, n)
    sp = fk.fsm_emit_plain(bits, trans, total_bits, depth, entry, off, n)
    ok["K7"] = torch.equal(sk, sp)
    ok["count"] = n <= total <= n + 7
    if want is not None:
        ok["decodes_input"] = torch.equal(
            sk, want if torch.is_tensor(want) else
            torch.from_numpy(want).to(sk.device))
    del sp
    decode_ms = cuda_ms(lambda: fk.decode_bits(bits, trans, total_bits,
                                               depth, n), 3)
    row = dict(case=name, node_count=node_count or trans.numel() // 2,
               longest_code=depth, chunk_bits=fk.chunk_bits(depth),
               table_in_smem=4 * trans.numel() <= 232448,
               total_bits=total_bits, chunks=int(entry.numel()),
               symbols=n, k6_steps=steps, decode_ms=decode_ms, **ok)
    _log("kernel K5-K7 vs plain", **row)
    if not all(ok.values()):
        raise AssertionError(f"K5-K7 differ from their plain versions on "
                             f"{name}: {ok}")
    return row


def _caterpillar(depth):
    """A complete prefix code whose code k is k ones and a zero (the last
    one ``depth`` ones): (L, R, C, T)."""
    nc = 2 * depth + 1
    L, R = np.zeros(nc, np.uint32), np.zeros(nc, np.uint32)
    C, T = np.zeros(nc, np.uint32), np.zeros(nc, np.uint8)
    for k in range(depth):
        node = 0 if k == 0 else depth + k
        L[node], C[k + 1], T[k + 1] = k + 1, k, 1
        R[node] = depth + k + 1 if k + 1 < depth else 2 * depth
    C[2 * depth], T[2 * depth] = depth, 1
    return L, R, C, T


def _random_bytes(nb, seed, dev):
    import torch
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    return torch.randint(0, 256, (nb,), dtype=torch.uint8, device=dev,
                         generator=gen)


def _fixed3_symbols(enc, code_of):
    """The symbols a fixed-length 3-bit code carries in the bytes enc."""
    import torch
    shifts = torch.arange(7, -1, -1, device=enc.device, dtype=torch.uint8)
    b = ((enc[:, None] >> shifts) & 1).reshape(-1)
    b = b[:b.numel() // 3 * 3].reshape(-1, 3).to(torch.int64)
    sym_of = torch.empty(8, dtype=torch.int32, device=enc.device)
    sym_of[torch.from_numpy(code_of).to(enc.device)] = torch.arange(
        8, dtype=torch.int32, device=enc.device)
    return sym_of[4 * b[:, 0] + 2 * b[:, 1] + b[:, 2]]


# bits of the 512^3 main-path stream (PERF.md): the never-syncing case is
# given that size, so its time is the decode's worst case at full size
NEVER_SYNC_BITS = 908_210_056


def phase_fsm_cases(dev) -> list:
    import torch
    from sz_tpu_torch.format import huffman
    rng = np.random.default_rng(61)
    rows = []
    for name, n, nstate, a in (("skewed_40k", 40000, 600, 1.5),
                               ("skewed_700k", 700_000, 300, 1.4),
                               ("tree_18k_nodes_smem", 400_000, 10000, 0.8),
                               ("tree_80k_nodes_l2", 3_000_000, 40000, 0.6)):
        types = _zipf(rng, n, nstate, a)
        t, stream = _packed_on_card(types, nstate, dev)
        rows.append(fsm_vs_plain(name, stream, n, types, t.node_count))
    # a fixed-length 3-bit code never self-synchronizes, and 1024 % 3 != 0:
    # random bits through it at the size of the 512^3 stream; the symbols
    # are the bits read three at a time
    t = huffman.build_tables(np.arange(8, dtype=np.int32), 8)
    assert set(t.code_len[:8].tolist()) == {3}
    enc = _random_bytes(NEVER_SYNC_BITS // 8 + 1, 5, dev)
    want = _fixed3_symbols(enc, (t.code_hi[:8] >> np.uint64(61)).astype(
        np.int64))
    rows.append(fsm_vs_plain("never_syncs_512^3_size",
                             _on_card(t, enc, 8 * enc.numel(), dev), None,
                             want, t.node_count))
    del enc, want
    # past 2^31 bits: random bytes through a skewed tree (a complete
    # prefix code decodes any bit string)
    t = huffman.build_tables(_zipf(rng, 40000, 600, 1.5), 600)
    enc = _random_bytes((1 << 28) + (1 << 20), 7, dev)
    rows.append(fsm_vs_plain("above_2^31_bits",
                             _on_card(t, enc, 8 * enc.numel(), dev), None,
                             node_count=t.node_count))
    del enc
    # a code of 1100 bits: past the boundary bitmaps (F + D >= 1120) and
    # past one 1024-bit chunk (F = 2048); a run of ones reaches it
    enc = _random_bytes(1 << 20, 9, dev)
    enc[5000:5000 + 140] = 255
    rows.append(fsm_vs_plain("code_of_1100_bits",
                             _on_card(_caterpillar(1100), enc,
                                      8 * enc.numel(), dev), None))
    del enc
    torch.cuda.empty_cache()
    return rows


# --- phase 3: the main path -----------------------------------------------

def phase_main_path(dev, record: dict) -> None:
    import sz_tpu_torch
    from sz_tpu_torch import ErrorBoundMode, SZConfig

    cfg = SZConfig().with_bound(ErrorBoundMode.ABS, ABS)
    rows = []
    for name, (shape, seed, want_stream, want_recon) in ORACLE.items():
        x = field(shape, seed)
        t0 = time.perf_counter()
        blob = sz_tpu_torch.compress(x, cfg, device=dev)
        t1 = time.perf_counter()
        out = sz_tpu_torch.decompress(blob, x.shape, np.float32, device=dev)
        t2 = time.perf_counter()
        if sha256(blob) != want_stream:
            raise AssertionError(f"{name}: stream differs from the oracle")
        if sha256(out.tobytes()) != want_recon:
            raise AssertionError(f"{name}: decode differs from the oracle")
        err = float(np.abs(out.astype(np.float64) - x).max())
        if err > ABS:
            raise AssertionError(f"{name}: error {err} above the bound")
        row = dict(case=name, shape=list(shape), stream_sha256_equal=True,
                   decode_sha256_equal=True, ratio=x.nbytes / len(blob),
                   max_abs_err=err, port_compress_s=t1 - t0,
                   port_decompress_s=t2 - t1)
        _log("main path", **row)
        rows.append(row)
    golden = REPO / "tests" / "golden"
    want = np.fromfile(golden / "f32_3d64_abs1e-3.out", dtype="<f4")
    got = sz_tpu_torch.decompress(
        (golden / "f32_3d64_abs1e-3.sz").read_bytes(), (64, 64, 64),
        np.float32, device=dev)
    if not np.array_equal(got.reshape(-1).view(np.uint32),
                          want.view(np.uint32)):
        raise AssertionError("golden f32_3d64_abs1e-3 decodes differently")
    _log("main path", case="golden_f32_3d64_abs1e-3", decode_bit_equal=True)
    record["main_path"] = rows


# --- phase 4: full size ---------------------------------------------------

def _best_of(fn, reps: int):
    """(best seconds, spans, counts of the best run) over reps runs after
    a warm one; spans and counts from sz_tpu_torch.utils.trace, spans
    summed by name."""
    from sz_tpu_torch.utils import trace as tr
    fn()
    best = None
    for _ in range(reps):
        tr.reset()
        t0 = time.perf_counter()
        fn()
        dt = time.perf_counter() - t0
        if best is None or dt < best[0]:
            spans = {}
            for k, v in tr.last_spans():
                spans[k] = spans.get(k, 0.0) + v
            best = (dt, spans, tr.last_counts())
    return best


def synth(n: int) -> np.ndarray:
    """bench.py's headline field (sin*cos*sin + 0.1 noise + ramp, seed
    42): the 512^3 input of the earlier decompress records in PERF.md.
    Timing only (numpy's sin may differ across builds)."""
    rng = np.random.default_rng(42)
    ax = np.linspace(0, 8 * np.pi, n)
    x, y, z = np.meshgrid(ax, ax, ax, indexing="ij")
    return (np.sin(x) * np.cos(y) * np.sin(z)
            + 0.1 * rng.standard_normal((n, n, n))
            + 0.05 * x * y / 64.0).astype(np.float32)


def phase_full_size(dev, record: dict, wrappers: dict,
                    shape=(512, 512, 512)) -> bytes:
    """512^3 float32 (NYX scale, 537 MB).  Returns its stream."""
    import torch
    import sz_tpu_torch
    from sz_tpu_torch import ErrorBoundMode, SZConfig

    cfg = SZConfig().with_bound(ErrorBoundMode.ABS, ABS)
    x = field(shape, 42)
    mb = x.nbytes / 1e6
    blob = sz_tpu_torch.compress(x, cfg, device=dev)
    out = sz_tpu_torch.decompress(blob, x.shape, np.float32, device=dev)
    err = float(np.abs(out.astype(np.float64) - x).max())
    if err > ABS:
        raise AssertionError(f"512^3: error {err} above the bound")
    tc, spans_c, _ = _best_of(
        lambda: sz_tpu_torch.compress(x, cfg, device=dev), 3)
    td, spans_d, counts_d = _best_of(
        lambda: sz_tpu_torch.decompress(blob, x.shape, np.float32,
                                        device=dev), 3)
    for w in wrappers.values():
        w.launches = 0
    sz_tpu_torch.decompress(blob, x.shape, np.float32, device=dev)
    launches = {k: w.launches for k, w in wrappers.items()}
    # the device-to-host copy of a 537 MB reconstruction, alone
    t = torch.from_numpy(x).to(dev)
    d2h = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        t.cpu()
        d2h.append(time.perf_counter() - t0)
    del t
    row = dict(shape=list(shape), ratio=x.nbytes / len(blob),
               max_abs_err=err, compress_MBps=mb / tc,
               decompress_MBps=mb / td, compress_s=tc, decompress_s=td,
               compress_spans_s=spans_c, decompress_spans_s=spans_d,
               decompress_counts=counts_d, launches_per_decompress=launches,
               d2h_537MB_s=d2h)
    _log("full size 512^3", **row)
    record["full_512"] = row
    # bench.py's synth field: the same decompress on the earlier input
    xs = synth(shape[0])
    blob_s = sz_tpu_torch.compress(xs, cfg, device=dev)
    ts, spans_s, _ = _best_of(
        lambda: sz_tpu_torch.decompress(blob_s, xs.shape, np.float32,
                                        device=dev), 3)
    err = float(np.abs(sz_tpu_torch.decompress(
        blob_s, xs.shape, np.float32, device=dev).astype(np.float64)
        - xs).max())
    if err > ABS:
        raise AssertionError(f"synth 512^3: error {err} above the bound")
    row = dict(shape=list(shape), ratio=xs.nbytes / len(blob_s),
               max_abs_err=err, decompress_MBps=mb / ts, decompress_s=ts,
               decompress_spans_s=spans_s)
    _log("full size 512^3 synth", **row)
    record["synth_512"] = row
    return blob


def phase_fsm_timing(dev, blob: bytes, shape=(512, 512, 512)) -> dict:
    """K5-K7 on the 512^3 main-path stream, each against its plain
    version (K6: one step, stride 1; a decode makes ceil(log2 L))."""
    import torch
    from sz_tpu_torch.config import DataType
    from sz_tpu_torch.core import regnd
    from sz_tpu_torch.format import lossless as ll
    from sz_tpu_torch.format import metadata as md
    from sz_tpu_torch.gpu import fsm_kernel as fk

    n = int(np.prod(shape))
    inner = ll.decompress(blob, n * 4 + 64)
    hdr = md.parse_header(inner, DataType.FLOAT)
    p = regnd.parse_body(
        inner[hdr.body_offset + hdr.size_type:], shape, np.float32,
        hdr.size_type,
        lambda tree, enc, cnt: fk.decode(tree, enc, cnt, dev)[0].cpu().numpy())
    c = fk.upload(p.tree, p.encoded, dev)
    bits, trans, tb, depth = c.bits, c.trans, c.total_bits, c.depth
    g, m = fk.fsm_sweep(bits, trans, tb, depth)
    g1, m1 = fk.fsm_sync(g, m, 1)
    entry, off, _, steps = fk.compose(g, m)
    syms = fk.fsm_emit(bits, trans, tb, depth, entry, off, n)
    errs = {
        "fsm_sweep": max(max_abs_err(a, b) for a, b in zip(
            (g, m), fk.fsm_sweep_plain(bits, trans, tb, depth))),
        "fsm_sync": max(max_abs_err(a, b) for a, b in zip(
            (g1, m1), fk.fsm_sync_plain(g, m, 1))),
        "fsm_emit": max_abs_err(syms, fk.fsm_emit_plain(
            bits, trans, tb, depth, entry, off, n)),
    }
    if any(errs.values()):
        raise AssertionError(f"K5-K7 differ from their plain versions on "
                             f"the 512^3 stream: {errs}")
    runs = {
        "fsm_sweep": (lambda: fk.fsm_sweep(bits, trans, tb, depth),
                      lambda: fk.fsm_sweep_plain(bits, trans, tb, depth),
                      # reads the stream and the table, writes the maps;
                      # walks every coded bit at least once
                      bound(nbytes(bits, trans, g, m), tb)),
        "fsm_sync": (lambda: fk.fsm_sync(g, m, 1),
                     lambda: fk.fsm_sync_plain(g, m, 1),
                     # reads the maps once, writes them once
                     bound(nbytes(g, m, g1, m1))),
        "fsm_emit": (lambda: fk.fsm_emit(bits, trans, tb, depth, entry, off,
                                         n),
                     lambda: fk.fsm_emit_plain(bits, trans, tb, depth, entry,
                                               off, n),
                     bound(nbytes(bits, trans, entry, off, syms), tb)),
    }
    entries = {}
    for name, (kern, plain, (b_ms, b_by)) in runs.items():
        ms = cuda_ms(kern, 5)
        plain_ms = cuda_ms(plain, 1)
        entries[name] = dict(max_abs_err=errs[name], ms=ms,
                             plain_ms=plain_ms,
                             bound_ms=b_ms, bound_by=b_by, library_ms=None,
                             shape=list(g.shape) + [tb])
    decode_ms = cuda_ms(lambda: fk.decode_bits(bits, trans, tb, depth, n), 3)
    _log("kernel K5-K7 at 512^3", node_count=int(p.tree[4]), total_bits=tb,
         chunks=int(g.shape[0]), longest_code=depth, k6_steps=steps,
         decode_ms=decode_ms,
         **{k: {kk: v[kk] for kk in ("ms", "plain_ms", "bound_ms")}
            for k, v in entries.items()})
    return entries


KERNELS = {   # name -> (K id, CUDA source, the TPU kernel it replaces)
    "wavefront_quantize": ("K1", "sz_tpu_torch/csrc/lorenzo.cu",
                           "sz_tpu/tpu/pallas_kernels.py:404"),
    "wavefront_decode": ("K2", "sz_tpu_torch/csrc/lorenzo.cu",
                         "sz_tpu/tpu/wf_quantize.py:351"),
    "histogram": ("K3", "sz_tpu_torch/csrc/hist.cu",
                  "sz_tpu/tpu/hist_kernel.py:74"),
    "pack_bits": ("K4", "sz_tpu_torch/csrc/pack.cu",
                  "sz_tpu/tpu/pack_kernel.py:515"),
    "fsm_sweep": ("K5", "sz_tpu_torch/csrc/fsm.cu",
                  "sz_tpu/tpu/fsm_kernel.py:137"),
    "fsm_sync": ("K6", "sz_tpu_torch/csrc/fsm.cu",
                 "sz_tpu/tpu/fsm_kernel.py:172"),
    "fsm_emit": ("K7", "sz_tpu_torch/csrc/fsm.cu",
                 "sz_tpu/tpu/fsm_kernel.py:298"),
}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", help="also write the full record as JSON")
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 2
    if not (REPO / "sz_tpu_torch" / "csrc").is_dir():
        print("chip_smoke: run it from a checkout of the repository",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    dev = torch.device("cuda", 0)
    record = {}

    # phase 1: environment
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    from sz_tpu_torch import native
    from sz_tpu_torch.gpu import (_build, fsm_kernel, hist_kernel,
                                  lorenzo_kernel, pack_kernel)
    nvcc = subprocess.run([_build.find_nvcc(), "--version"],
                          capture_output=True, text=True, check=True)
    t0 = time.perf_counter()
    _build.lib()
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    native.lib()
    native_s = time.perf_counter() - t0
    env = dict(python=sys.version.split()[0], torch=torch.__version__,
               cuda=torch.version.cuda,
               nvcc=nvcc.stdout.strip().splitlines()[-1],
               device=torch.cuda.get_device_name(0),
               device_count=torch.cuda.device_count(), nvidia_smi=smi,
               kernel_build_s=build_s,
               kernels_compiled=_build.build_seconds > 0,
               host_runtime=native.library_path().name,
               host_runtime_build_s=native_s)
    _log("environment", **env)
    record["environment"] = env
    log = _build.library_path().with_suffix(".log")
    if log.exists():
        record["ptxas"] = [ln for ln in log.read_text().splitlines()
                           if "registers" in ln or "Compiling entry" in ln]

    # phase 2: each kernel against its plain version
    entries = phase_kernels(dev)
    record["fsm_cases"] = phase_fsm_cases(dev)

    # phase 3: the main path; the launch counters cover exactly this run
    wrappers = {"wavefront_quantize": lorenzo_kernel.wavefront_quantize,
                "wavefront_decode": lorenzo_kernel.wavefront_decode,
                "histogram": hist_kernel.histogram,
                "pack_bits": pack_kernel.pack_bits,
                "fsm_sweep": fsm_kernel.fsm_sweep,
                "fsm_sync": fsm_kernel.fsm_sync,
                "fsm_emit": fsm_kernel.fsm_emit}
    for w in wrappers.values():
        w.launches = 0
    phase_main_path(dev, record)
    launches = {k: w.launches for k, w in wrappers.items()}
    _log("main path launches", **launches)
    idle = [k for k, v in launches.items() if v == 0]
    if idle:
        raise AssertionError(f"main path never launched {idle}")

    # phase 4: full size, then K5-K7 timed on its stream
    blob = phase_full_size(dev, record, wrappers)
    entries.update(phase_fsm_timing(dev, blob))

    bad = sorted(m for m in sys.modules
                 if m == "jax" or m.startswith("jax.") or m == "sz_tpu"
                 or m.startswith("sz_tpu."))
    if bad:
        raise AssertionError(f"modules of jax or sz_tpu were imported: "
                             f"{bad}")

    kernels = []
    for name, (kid, src, rep) in KERNELS.items():
        e = entries[name]
        kernels.append(dict(
            name=name, route="cuda", source=src, replaces=rep,
            launches=launches[name], max_abs_err=e["max_abs_err"],
            ms=e["ms"], plain_ms=e["plain_ms"], bound_ms=e["bound_ms"],
            bound_by=e["bound_by"], library_ms=e["library_ms"], id=kid,
            shape=e["shape"]))
    record["kernels"] = kernels
    if args.out:
        out = pathlib.Path(args.out)
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps(record, indent=1, default=float))
    print(json.dumps({"kernels": kernels}, default=float), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
