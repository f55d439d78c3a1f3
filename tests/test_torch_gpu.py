"""Card-only tests of the PyTorch port: each CUDA kernel bit-equal to its
plain torch version (K5-K7 also on the decoded symbols, K8/K9's,
K8d/K9d's and K10/K11's decode also rebuilding their encode's
reconstruction, K13 holding the bound on K12's types), and the main
path, the MSST19 PW_REL path (float32 and float64), the classic codec,
the random-access codec (with region decodes) and temporal compression
(K14/K15) byte-equal to the numpy oracle, on the GPU.  They skip where
torch.cuda.is_available() is false.

This file imports no jax, so it also runs on a machine without it; there
run it without the JAX-side conftest:
    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_gpu.py
Tolerance: exact (equal bits, equal bytes).
"""

import numpy as np
import pytest
import torch
torch.set_num_threads(1)  # xdist workers share the cores: one thread each

import sz_tpu
from sz_tpu.config import ErrorBoundMode as JMode
from sz_tpu.config import SZConfig as JConfig
from sz_tpu.core import regnd
from sz_tpu.format import huffman

import sz_tpu_torch
from sz_tpu_torch.core import pwr
from sz_tpu_torch.gpu import (engine, fsm_kernel, hist_kernel,
                              lorenzo_kernel, msst19_engine, msst19_kernel,
                              pack_kernel)

from _chip_smoke import SMOKE

RADIUS, MEAN = 32, np.float32(0.25)
RP = np.float32(1e-3)
SCALARS = (RP, np.float32(np.float32(1) / RP), np.float32(2 * RADIUS - 2),
           RADIUS, MEAN)
KW = dict(max_range_radius=32768, sample_distance=100,
          pred_threshold=np.float32(0.99))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _bits_equal(a, b):
    if a.dtype == torch.float32:
        return torch.equal(a.view(torch.int32), b.view(torch.int32))
    return torch.equal(a, b)


def _field(shape, seed):
    rng = np.random.default_rng(seed)
    n = int(np.prod(shape))
    return (np.sin(np.linspace(0, 12, n, dtype=np.float32))
            + 0.02 * rng.standard_normal(n)).astype(np.float32).reshape(shape)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [
    (20, 33, 47), (1, 40, 300), (150, 130),
    # no multiple of a tile, smaller than a tile, one row along an axis
    (3, 5, 7), (33, 9, 65), (1, 1, 4097), (4097, 1, 1), (2, 3, 2),
    (7, 20), (4097, 1)])
@pytest.mark.parametrize("use_mean", [False, True])
def test_lorenzo_kernels_match_plain(cuda, shape, use_mean):
    """K1/K2 bit-equal to their plain versions, and a second call on the
    same inputs bit-equal to the first (the flags and the claim counter
    start from zero on every call)."""
    rng = np.random.default_rng(7)
    data = _field(shape, 7)
    data[rng.random(shape) < 0.1] = MEAN
    reg = rng.random(shape) < 0.3
    args = [torch.from_numpy(a).to(cuda) for a in (
        data, rng.integers(0, 2 * RADIUS, shape).astype(np.int32),
        (data + rng.uniform(-1e-3, 1e-3, shape)).astype(np.float32), reg,
        (~reg) & (np.abs(data - MEAN) <= RP))]
    if not use_mean:
        args[4] = None
    k = lorenzo_kernel.wavefront_quantize(*args, *SCALARS,
                                          use_mean=use_mean, want_R=True)
    p = lorenzo_kernel.quantize_plain(*args, *SCALARS, use_mean=use_mean)
    assert _bits_equal(k[0], p[0]) and _bits_equal(k[1], p[1])
    k2 = lorenzo_kernel.wavefront_quantize(*args, *SCALARS,
                                           use_mean=use_mean, want_R=True)
    assert _bits_equal(k2[0], k[0]) and _bits_equal(k2[1], k[1])
    dec = [args[3], args[2], (args[1].to(torch.float32) - RADIUS) * 2 * RP]
    got = lorenzo_kernel.wavefront_decode(*dec)
    assert _bits_equal(got, lorenzo_kernel.decode_plain(*dec))
    assert _bits_equal(lorenzo_kernel.wavefront_decode(*dec), got)


@pytest.mark.gpu
def test_hist_and_pack_kernels_match_plain(cuda):
    rng = np.random.default_rng(9)
    sym = torch.from_numpy(np.clip(rng.normal(32768, 30, 1 << 20), -1,
                                   70000).astype(np.int32)).to(cuda)
    assert torch.equal(hist_kernel.histogram(sym),
                       hist_kernel.histogram_plain(sym))
    fib = [1, 1]
    while len(fib) < 90:
        fib.append(fib[-1] + fib[-2])
    freq = np.zeros(256, np.int64)
    freq[:90] = fib
    tables = huffman.build_tables(None, 128, freq=freq)
    s = rng.integers(-1, 90, 1 << 20).astype(np.int32)
    total = int(np.where(s >= 0, tables.code_len[np.maximum(s, 0)],
                         0).astype(np.int64).sum())

    def u64(a):
        return torch.from_numpy(a.view(np.int64)).to(cuda)

    args = (torch.from_numpy(s).to(cuda), u64(tables.code_hi),
            u64(tables.code_lo),
            torch.from_numpy(tables.code_len.astype(np.int32)).to(cuda))
    got = pack_kernel.pack_bits(*args, total)
    assert torch.equal(got, pack_kernel.pack_bits_plain(*args, total))
    keep = s[s >= 0]
    assert got.cpu().numpy().tobytes() == huffman.encode(tables, keep)


# the K3/K4 edge cases of chip_smoke.py (tests/test_torch_pack_tiles.py
# holds a CPU model of each kernel to the same cases)
PACK_CASES = SMOKE.PACK_CASE_NAMES
HIST_CASES = SMOKE.HIST_CASE_NAMES


@pytest.mark.gpu
@pytest.mark.parametrize("shift", [0, 1, 2, 3])
@pytest.mark.parametrize("name", HIST_CASES)
def test_hist_kernel_edge_cases(cuda, name, shift):
    _, sym, radius = next(c for c in SMOKE.hist_cases() if c[0] == name)
    s = SMOKE.at_offset(sym, shift, cuda)
    got = hist_kernel.histogram(s, radius)
    assert torch.equal(got, hist_kernel.histogram_plain(s))
    assert torch.equal(hist_kernel.histogram(s, radius), got)


@pytest.mark.gpu
def test_hist_kernel_single_bin_2e27(cuda):
    """2^27 symbols on one bin (the register bin, or a window bin)."""
    s = torch.full((1 << 27,), 40000, dtype=torch.int32, device=cuda)
    for radius in (40000, 39000, 5):
        got = hist_kernel.histogram(s, radius)
        assert int(got[40000]) == 1 << 27 and int(got.sum()) == 1 << 27


@pytest.mark.gpu
@pytest.mark.parametrize("shift", [0, 1, 2, 3])
@pytest.mark.parametrize("name", PACK_CASES)
def test_pack_kernel_edge_cases(cuda, name, shift):
    _, sym, (hi, lo, ln) = next(c for c in SMOKE.pack_cases()
                                if c[0] == name)
    total = SMOKE.code_bits(sym, ln)
    args = (SMOKE.at_offset(sym, shift, cuda),
            torch.from_numpy(hi.view(np.int64)).to(cuda),
            torch.from_numpy(lo.view(np.int64)).to(cuda),
            torch.from_numpy(ln).to(cuda))
    got = pack_kernel.pack_bits(*args, total)
    assert torch.equal(got, pack_kernel.pack_bits_plain(*args, total))
    assert torch.equal(pack_kernel.pack_bits(*args, total), got)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(64, 64, 64), (25, 14, 20), (150, 130)])
def test_engine_on_card_matches_oracle(cuda, shape):
    data = _field(shape, 11)
    ref = regnd.compress(data, 1e-3, **KW)
    got = engine.compress(data, 1e-3, device=cuda, **KW)
    assert got.body == ref.body
    out = engine.decompress(got.body, shape, np.float32, device=cuda)
    np.testing.assert_array_equal(
        out.view(np.uint32),
        regnd.decompress(ref.body, shape, np.float32).view(np.uint32))


def _fsm_case(name):
    rng = np.random.default_rng(61)
    if name == "never_syncs":
        types = rng.integers(0, 8, 16000).astype(np.int32)
        return types, 8
    if name == "fixed_9_bits":      # 9 phases that never meet
        return rng.integers(0, 512, 16000).astype(np.int32), 512
    nstate, a, n = {"skewed": (600, 1.5, 40000),
                    "tree_18k_nodes_smem": (10000, 0.8, 400000),
                    "tree_80k_nodes_l2": (40000, 0.6, 2000000)}[name]
    p = 1.0 / np.arange(1, nstate + 1) ** a
    return rng.choice(nstate, size=n, p=p / p.sum()).astype(np.int32), nstate


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["skewed", "tree_18k_nodes_smem",
                                  "tree_80k_nodes_l2", "never_syncs",
                                  "fixed_9_bits"])
def test_fsm_kernels_match_plain(cuda, name):
    types, nstate = _fsm_case(name)
    t = huffman.build_tables(types, nstate)
    enc = huffman.encode(t, types)
    tree = (t.L, t.R, t.C, t.T, t.node_count)
    c = fsm_kernel.upload(tree, enc, cuda)
    k = fsm_kernel.fsm_sweep(c)
    p = fsm_kernel.fsm_sweep_plain(c.bits, c.trans, c.total_bits, c.depth)
    assert torch.equal(k[0], p[0]) and torch.equal(k[1], p[1])
    a = fsm_kernel.fsm_scan(*k)
    b = fsm_kernel.fsm_scan_plain(*k)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    launches = fsm_kernel.fsm_scan.launches
    got, scans = fsm_kernel.decode_coded(c, len(types), cuda)
    assert fsm_kernel.fsm_scan.launches == launches + 1 and scans == 1
    want, scans_cpu = fsm_kernel.decode(tree, enc, len(types), "cpu")
    assert scans_cpu == 1
    np.testing.assert_array_equal(got.cpu().numpy(), types)
    np.testing.assert_array_equal(want.numpy(), types)


@pytest.mark.gpu
@pytest.mark.parametrize("depth", [40, 130, 1100])
def test_fsm_deep_codes_match_plain(cuda, depth):
    """Codes past K5's 32-slot ring (40 bits), past its windowed sweep
    (130 bits: W0's boundary bitmap) and past one 1024-bit chunk (1100
    bits, F = 2048): random bits through a caterpillar tree whose code k
    is k ones and a zero."""
    nc = 2 * depth + 1
    L, R = np.zeros(nc, np.uint32), np.zeros(nc, np.uint32)
    C, T = np.zeros(nc, np.uint32), np.zeros(nc, np.uint8)
    for k in range(depth):
        node = 0 if k == 0 else depth + k
        L[node], C[k + 1], T[k + 1] = k + 1, k, 1
        R[node] = depth + k + 1 if k + 1 < depth else 2 * depth
    C[2 * depth], T[2 * depth] = depth, 1
    raw = np.random.default_rng(depth).integers(0, 256, 50000).astype(
        np.uint8)
    raw[1000:1000 + depth // 8 + 2] = 0xFF      # one code past 1024 bits
    c = fsm_kernel.upload((L, R, C, T, nc), raw.tobytes(), cuda)
    assert c.depth == depth
    k = fsm_kernel.fsm_sweep(c)
    p = fsm_kernel.fsm_sweep_plain(c.bits, c.trans, c.total_bits, c.depth)
    assert torch.equal(k[0], p[0]) and torch.equal(k[1], p[1])
    entry, off, total = fsm_kernel.fsm_scan(*k)
    assert all(torch.equal(x, y) for x, y in
               zip((entry, off, total), fsm_kernel.fsm_scan_plain(*k)))
    total = int(total)
    got = fsm_kernel.fsm_emit(c, entry, off, total)
    want = fsm_kernel.fsm_emit_plain(c.bits, c.trans, c.total_bits,
                                     c.depth, entry, off, total)
    assert torch.equal(got, want)


@pytest.mark.gpu
def test_fsm_tables_match_plain(cuda):
    """Symbols of 2^27 and up: codeword-table entries that fall back to a
    bit walk from the root."""
    types, nstate = _fsm_case("tree_18k_nodes_smem")
    t = huffman.build_tables(types, nstate)
    enc = huffman.encode(t, types)
    C = (t.C.astype(np.int64) + (t.T != 0) * (1 << 27)).astype(np.uint32)
    c = fsm_kernel.upload((t.L, t.R, C, t.T, t.node_count), enc, cuda)
    k = fsm_kernel.fsm_sweep(c)
    p = fsm_kernel.fsm_sweep_plain(c.bits, c.trans, c.total_bits, c.depth)
    assert torch.equal(k[0], p[0]) and torch.equal(k[1], p[1])
    entry, off, _ = fsm_kernel.fsm_scan(*k)
    got = fsm_kernel.fsm_emit(c, entry, off, len(types))
    want = fsm_kernel.fsm_emit_plain(c.bits, c.trans, c.total_bits,
                                     c.depth, entry, off, len(types))
    assert torch.equal(got, want)
    np.testing.assert_array_equal(got.cpu().numpy(), types + (1 << 27))


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["random", "permutation", "constant",
                                  "big_counts"])
@pytest.mark.parametrize("L,D", [(300_001, 28), (70_001, 63), (20_001, 5),
                                 (3_001, 64), (2_001, 200)])
def test_fsm_scan_past_many_tiles(cuda, L, D, kind):
    """K6 on synthetic maps of enough tiles (hundreds to thousands) that
    the look-back meets aggregates and steps back window by window:
    permutations never converge, big counts pass 2^31 in every chunk.
    D > 63 takes the wide path.  Every call equals the plain version."""
    g, n = SMOKE.scan_maps(kind, L, D, L + D, cuda)
    want = fsm_kernel.fsm_scan_plain(g, n)
    for _ in range(3):
        got = fsm_kernel.fsm_scan(g, n)
        assert all(torch.equal(x, y) for x, y in zip(got, want))


@pytest.mark.gpu
def test_fsm_corrupt_stream_raises_on_card(cuda):
    types, nstate = _fsm_case("skewed")
    t = huffman.build_tables(types, nstate)
    enc = huffman.encode(t, types)[:-400]
    with pytest.raises(ValueError, match="corrupt"):
        fsm_kernel.decode((t.L, t.R, t.C, t.T, t.node_count), enc,
                          len(types), cuda)


def _msst19_case(shape, ratio, signed, dev):
    """A zero-free field and its MSST19 tables on ``dev``: (data, table,
    pt, base, top, bits, ign)."""
    data = _field(shape, 13)
    data = data if signed else np.abs(data) + np.float32(0.01)
    data[data == 0] = np.float32(0.5)
    iv = pwr._optimize_intervals_msst19(data, ratio, 32768, 100,
                                        np.float32(0.99))
    cache = pwr._cache_table(iv, ratio, 3)
    rl = msst19_engine.req_length(ratio, len(shape))
    return (torch.from_numpy(data).to(dev),
            torch.from_numpy(cache.table.reshape(-1).view(np.int16)).to(dev),
            torch.from_numpy(pwr._precision_table(iv, ratio, 3)).to(dev),
            cache.base_index, cache.top_index, cache.bits, max(32 - rl, 0))


@pytest.mark.gpu
@pytest.mark.parametrize("shape,ratio,signed", [
    ((20, 33, 47), 1e-3, False), ((30, 26, 34), 1e-5, True),
    ((150, 130), 1e-3, True), ((777, 1031), 1e-4, False),
    # no multiple of a tile, smaller than a tile, one tile wide on i and
    # j but many long on k (the k-2 hand-off on the first row), r1 = 1,
    # a single row and a single column in 2-D
    ((9, 17, 70), 1e-3, True), ((3, 5, 7), 1e-3, False),
    ((2, 3, 4097), 1e-3, False), ((1, 40, 300), 1e-3, True),
    ((1, 5000), 1e-3, False), ((5000, 1), 1e-3, True),
    ((70, 130), 1e-3, True)])
def test_msst19_kernels_match_plain(cuda, shape, ratio, signed):
    """K8/K9 bit-equal to their plain versions both ways, the decode
    rebuilding the encode, and each second call bit-equal to the first
    (the flags and the claim counter start from zero on every call)."""
    args = _msst19_case(shape, ratio, signed, cuda)
    rank3 = len(shape) == 3
    enc = (msst19_kernel.wavefront3d_encode if rank3
           else msst19_kernel.lines2d_encode)
    enc_p = (msst19_kernel.wavefront3d_encode_plain if rank3
             else msst19_kernel.lines2d_encode_plain)
    dec = (msst19_kernel.wavefront3d_decode if rank3
           else msst19_kernel.lines2d_decode)
    dec_p = (msst19_kernel.wavefront3d_decode_plain if rank3
             else msst19_kernel.lines2d_decode_plain)
    t_k, R_k = enc(*args)
    t_p, R_p = enc_p(*args)
    assert _bits_equal(t_k, t_p) and _bits_equal(R_k, R_p)
    t_2, R_2 = enc(*args)
    assert _bits_equal(t_2, t_k) and _bits_equal(R_2, R_k)
    mask = msst19_kernel._mask_i32(args[-1])
    known = torch.where(t_k == 0, (args[0].view(torch.int32) & mask).view(
        torch.float32), torch.zeros_like(args[0]))
    out = dec(t_k, known, args[2])
    assert _bits_equal(out, dec_p(t_k, known, args[2]))
    assert _bits_equal(dec(t_k, known, args[2]), out)
    assert _bits_equal(out.abs(), R_k)


@pytest.mark.gpu
@pytest.mark.parametrize("shape,ratio", [((40, 48, 56), 1e-3),
                                         ((30, 26, 34), 1e-5),
                                         ((300, 200), 1e-3)])
def test_pwrel_on_card_matches_oracle(cuda, shape, ratio):
    data = _field(shape, 17)
    data[::7] = 0
    cfg = JConfig(error_bound_mode=JMode.PW_REL, pw_rel_bound_ratio=ratio,
                  engine="numpy")
    want = sz_tpu.compress(data, cfg)
    got = sz_tpu_torch.compress(data, sz_tpu_torch.SZConfig().with_bound(
        sz_tpu_torch.ErrorBoundMode.PW_REL, ratio), device=cuda)
    assert got == want
    np.testing.assert_array_equal(
        sz_tpu_torch.decompress(want, shape, device=cuda).view(np.uint32),
        sz_tpu.decompress(want, shape, np.float32,
                          engine="numpy").view(np.uint32))


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [
    (20, 33, 47), (150, 130), (3, 5, 7), (33, 9, 65), (1, 1, 4097),
    (4097, 1, 1), (1, 4097), (7, 20)])
@pytest.mark.parametrize("use_mean", [False, True])
def test_lorenzo_f64_kernels_match_plain(cuda, shape, use_mean):
    """K1d/K2d bit-equal to their plain float64 versions, twice, on
    ragged, sub-strip and single-row lattices; K2d rebuilds K1d's
    reconstruction."""
    args = SMOKE.k1_inputs(shape, 7, cuda, "mixed", np.float64)
    if not use_mean:
        args[4] = None
    scal = SMOKE.k1_scalars(np.float64)
    t, R = lorenzo_kernel.wavefront_quantize(*args, *scal, use_mean=use_mean,
                                             want_R=True)
    assert R.dtype == torch.float64
    t_p, R_p = lorenzo_kernel.quantize_plain(*args, *scal,
                                             use_mean=use_mean)
    assert torch.equal(t, t_p) and torch.equal(R.view(torch.int64),
                                               R_p.view(torch.int64))
    t2, R2 = lorenzo_kernel.wavefront_quantize_f64(
        *args, *scal, use_mean=use_mean, want_R=True)
    assert torch.equal(t2, t) and torch.equal(R2.view(torch.int64),
                                              R.view(torch.int64))
    dec = SMOKE.k2_inputs(args, t, use_mean)
    D = lorenzo_kernel.wavefront_decode(*dec)
    assert torch.equal(D.view(torch.int64),
                       lorenzo_kernel.decode_plain(*dec).view(torch.int64))
    assert torch.equal(D.view(torch.int64), R.view(torch.int64))


@pytest.mark.gpu
@pytest.mark.parametrize("case", SMOKE.LORENZO_F64_EDGES,
                         ids=lambda c: "x".join(map(str, c[0])) + "_" + c[2])
def test_lorenzo_f64_strip_edges_match_plain(cuda, case):
    """K1d/K2d on their strips' edges (chip_smoke.LORENZO_F64_EDGES):
    bit-equal to the plain versions, the types the same without R, and
    the same from flag tensors whose data is not 8-byte aligned."""
    shape, use_mean, regression = case
    args = SMOKE.k1_inputs(shape, 11, cuda, regression, np.float64)
    if not use_mean:
        args[4] = None
    scal = SMOKE.k1_scalars(np.float64)
    t, R = lorenzo_kernel.wavefront_quantize(*args, *scal, use_mean=use_mean,
                                             want_R=True)
    t_p, R_p = lorenzo_kernel.quantize_plain(*args, *scal,
                                             use_mean=use_mean)
    assert torch.equal(t, t_p) and torch.equal(R.view(torch.int64),
                                               R_p.view(torch.int64))
    n = args[0].numel()
    odd = [a if a is None or a.dtype != torch.bool else
           torch.empty(n + 3, dtype=torch.bool, device=cuda)[3:].view(
               shape).copy_(a) for a in args]
    assert odd[3].data_ptr() % 8 != 0
    assert torch.equal(lorenzo_kernel.wavefront_quantize(
        *odd, *scal, use_mean=use_mean), t)
    dec = SMOKE.k2_inputs(args, t, use_mean)
    D = lorenzo_kernel.wavefront_decode(*dec)
    assert torch.equal(D.view(torch.int64), R.view(torch.int64))


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(64, 64, 64), (25, 14, 20), (150, 130),
                                   (3, 7, 12, 13)])
def test_f64_and_tensor_input_on_card_match_oracle(cuda, shape):
    """A float64 field through sz_tpu_torch on the card, from a host array
    and from a CUDA tensor (also a non-contiguous one), byte-equal to
    sz_tpu's numpy oracle; the decode bit-equal, also as a tensor."""
    rng = np.random.default_rng(12)
    n = int(np.prod(shape))
    data = (np.sin(np.linspace(0, 12, n)) + 0.02 * rng.standard_normal(n)
            ).reshape(shape)
    ref = sz_tpu.compress(data, JConfig(engine="numpy").with_bound(
        JMode.ABS, 1e-3))
    cfg = sz_tpu_torch.SZConfig().with_bound(sz_tpu_torch.ErrorBoundMode.ABS,
                                             1e-3)
    assert sz_tpu_torch.compress(data, cfg, device=cuda) == ref
    xt = torch.from_numpy(data).to(cuda)
    assert sz_tpu_torch.compress(xt, cfg, device=cuda) == ref
    swapped = xt.transpose(0, 1)
    assert not swapped.is_contiguous()
    assert sz_tpu_torch.compress(swapped, cfg, device=cuda) == \
        sz_tpu.compress(np.ascontiguousarray(data.swapaxes(0, 1)), JConfig(
            engine="numpy").with_bound(JMode.ABS, 1e-3))
    want = sz_tpu.decompress(ref, shape, np.float64, engine="numpy")
    out = sz_tpu_torch.decompress(ref, shape, np.float64, device=cuda)
    np.testing.assert_array_equal(out.view(np.uint64), want.view(np.uint64))
    t = sz_tpu_torch.decompress(ref, shape, np.float64, device=cuda,
                                as_tensor=True)
    assert t.is_cuda and t.dtype == torch.float64
    np.testing.assert_array_equal(t.cpu().numpy().view(np.uint64),
                                  want.view(np.uint64))
    x32 = xt.float()
    assert sz_tpu_torch.compress(x32, cfg, device=cuda) == sz_tpu.compress(
        data.astype(np.float32), JConfig(engine="numpy").with_bound(
            JMode.ABS, 1e-3))


@pytest.mark.gpu
@pytest.mark.parametrize("T", [np.float32, np.float64])
@pytest.mark.parametrize("mode,value", [("ABS", 1e-3), ("REL", 1e-4),
                                        ("PSNR", 80.0), ("NORM", 0.5),
                                        ("ABS_AND_REL", 1e-4)])
def test_tensor_input_bounds_on_card_match_oracle(cuda, T, mode, value):
    """A CUDA tensor under every bound that resolves to an absolute one,
    byte-equal to sz_tpu's numpy oracle of the same field."""
    rng = np.random.default_rng(13)
    shape = (30, 34, 38)
    n = int(np.prod(shape))
    data = (np.sin(np.linspace(0, 12, n)) + 0.02 * rng.standard_normal(n)
            ).astype(T).reshape(shape)
    ref = sz_tpu.compress(data, JConfig(engine="numpy").with_bound(
        JMode[mode], value))
    cfg = sz_tpu_torch.SZConfig().with_bound(
        sz_tpu_torch.ErrorBoundMode[mode], value)
    assert sz_tpu_torch.compress(torch.from_numpy(data).to(cuda), cfg,
                                 device=cuda) == ref


@pytest.mark.gpu
@pytest.mark.parametrize("shape,dtype,rp,noise", [
    ((1, 5, 7), np.float32, 1e-3, 0.3), ((5, 7, 1), np.float32, 1e-3, 0.3),
    ((2, 65), np.float32, 1e-3, 0.3), ((6, 2, 2), np.float32, 1e-3, 0.3),
    ((777, 1031), np.float32, 1e-4, 0.1), ((33, 17, 300), np.float32, 1e-3,
                                            0.1),
    ((3, 5, 4100), np.float32, 1e-3, 0.1),
    ((5, 9, 12, 10), np.float32, 1e-4, 0.1),
    ((3, 2, 2, 2), np.float64, 1e-4, 0.1),
    ((40, 70, 130), np.float64, 1e-6, 0.1), ((700, 300), np.float64, 1e-6,
                                             0.1),
    ((64, 64, 64), np.float32, 1e-7, None)])
def test_classic_kernels_match_plain(cuda, shape, dtype, rp, noise):
    """K10/K11 against their plain versions: the three numeric forms, the
    degenerate shapes, ragged tiles, the first row's k-2 hand-off, 4-D
    volumes and random data that escapes nearly everywhere; K11 rebuilds
    K10's reconstruction."""
    from sz_tpu_torch.gpu import classic_kernel as ck
    x, p = SMOKE.classic_field(shape, dtype, rp, 3, noise)
    args = (p.rp, p.recip, p.intervals, p.radius, p.median, p.req_length)
    xt = torch.from_numpy(x)
    t_p, R_p = ck.classic_quantize(xt, *args)
    t_k, R_k = ck.classic_quantize(xt.to(cuda), *args)
    assert torch.equal(t_k.cpu(), t_p) and _bits_equal(R_k.cpu(), R_p)
    esc = R_k.reshape(-1)[t_k.reshape(-1) == 0]
    o_k = ck.classic_decode(t_k, esc, p.rp, p.radius)
    o_p = ck.classic_decode(t_p, esc.cpu(), p.rp, p.radius)
    assert _bits_equal(o_k.cpu(), o_p) and _bits_equal(o_k, R_k)
    t_n, R_n = ck.classic_quantize(xt.to(cuda), *args, want_R=False)
    assert R_n is None and torch.equal(t_n, t_k)


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["classic_cesm_atm_1800x3600",
                                  "classic_4d_4x64x64x64",
                                  "random_access_4d_4x64x64x64",
                                  "pwrel_1e-6_cesm_atm_1800x3600"])
def test_classic_on_card_matches_oracle(cuda, name):
    """The classic codec (K10/K11), the 4-D random-access route and
    PW_REL 1e-6 (pre-log) through sz_tpu_torch on the card: the stream
    and the decode hash to chip_smoke's oracle constants."""
    maker, shape, seed, bnd, over, want_stream, want_recon = \
        SMOKE.ORACLE_CLASSIC[name]
    x = SMOKE.classic_input(maker, shape, seed)
    blob = sz_tpu_torch.compress(x, SMOKE.classic_config(bnd, over),
                                 device=cuda)
    assert SMOKE.sha256(blob) == want_stream
    out = sz_tpu_torch.decompress(blob, x.shape, x.dtype, device=cuda)
    assert SMOKE.sha256(out.tobytes()) == want_recon


@pytest.mark.gpu
@pytest.mark.parametrize("shape,kind,seed,ratio", [
    ((9, 11, 13), "abs", 5, 1e-3), ((14, 10, 12), "signed", 7, 1e-3),
    ((3, 5, 7), "signed", 17, 1e-3), ((2, 3, 4097), "abs", 18, 1e-3),
    ((26, 31), "abs", 11, 1e-3), ((70, 130), "signed", 21, 1e-4),
    ((1, 5000), "abs", 19, 1e-3), ((5000, 1), "abs", 20, 1e-3),
    ((64, 64, 64), "abs", 22, 1e-5)])
def test_msst19_f64_kernels_match_plain(cuda, shape, kind, seed, ratio):
    """K8d (rank 3) / K9d (rank 2) both ways against their plain
    versions, each called twice, the decode rebuilding the encode
    (chip_smoke.msst19_vs_plain raises on any difference)."""
    x = SMOKE.pwrel_field64(kind, shape, seed)
    kid = "K8d" if len(shape) == 3 else "K9d"
    row, _ = SMOKE.msst19_vs_plain("card", kid, shape, x, ratio, cuda,
                                   timed=False)
    assert row["dtype"] == "float64" and row["encode_bit_equal"]


@pytest.mark.gpu
@pytest.mark.parametrize("shape,ratio", [((40, 48, 56), 1e-3),
                                         ((200, 150), 1e-3),
                                         ((30, 26, 34), 1e-5)])
def test_pwrel64_on_card_matches_oracle(cuda, shape, ratio):
    x = SMOKE.pwrel_field64("signed", shape, 3)
    cfg = sz_tpu_torch.SZConfig().with_bound(
        sz_tpu_torch.ErrorBoundMode.PW_REL, ratio)
    blob = sz_tpu.compress(x, JConfig(engine="numpy").with_bound(
        JMode.PW_REL, ratio))
    launches = msst19_kernel.wavefront3d_encode_f64.launches + \
        msst19_kernel.lines2d_encode_f64.launches
    assert sz_tpu_torch.compress(x, cfg, device=cuda) == blob
    assert msst19_kernel.wavefront3d_encode_f64.launches + \
        msst19_kernel.lines2d_encode_f64.launches == launches + 1
    got = sz_tpu_torch.decompress(blob, shape, np.float64, device=cuda)
    want = sz_tpu.decompress(blob, shape, np.float64, engine="numpy")
    np.testing.assert_array_equal(got.view(np.uint64), want.view(np.uint64))


@pytest.mark.gpu
@pytest.mark.parametrize("name,shape,rp,intervals,maker", [
    ("padded_3d", (13, 14, 20), 1e-3, 0, "field"),
    ("padded_2d", (40, 50), 1e-3, 0, "field"),
    ("padded_1d", (3000, 7), 1e-3, 0, "flat"),
    ("one_block_3d", (5, 6, 4), 1e-3, 1024, "field"),
    ("mean_3d", (30, 31, 32), 1e-3, 0, "mean"),
    ("mean_2d", (100, 90), 1e-3, 0, "mean"),
    ("random_1e-6", (36, 36, 36), 1e-6, 0, "random")])
def test_ra_kernels_match_plain(cuda, name, shape, rp, intervals, maker):
    """K12/K13 against their plain versions, each called twice; the
    decode holds the bound, and decodes of regions whose faces cut
    blocks (and of one block) equal their plain versions and the whole
    decode's crop (chip_smoke.ra_vs_plain raises on any difference)."""
    regions = {"padded_3d": [((1, 5, 7), (11, 13, 19)),
                             ((7, 8, 9), (10, 11, 12))],
               "padded_2d": [((15, 17), (33, 49)), ((17, 3), (30, 9))],
               "padded_1d": [((255,), (2049,)), ((300,), (400,))],
               "random_1e-6": [((3, 4, 5), (30, 31, 33))]}.get(name, [])
    if maker == "random":
        x = np.random.default_rng(1).standard_normal(shape).astype(
            np.float32)
    elif maker == "mean":
        x = SMOKE.ra_mean_field(shape, 9)
    else:
        x = SMOKE.field(shape, 3)
        x = x.reshape(-1) if maker == "flat" else x
    row, _ = SMOKE.ra_vs_plain(name, x, rp, cuda, timed=False,
                               intervals=intervals, regions=regions)
    assert len(row["regions"]) == len(regions)
    assert row["use_mean"] or maker != "mean"
    assert maker != "random" or row["escapes"] > x.size // 2


@pytest.mark.gpu
@pytest.mark.parametrize("kind", SMOKE.RA_ESCAPE_KINDS)
@pytest.mark.parametrize("shape", [(13, 14, 20), (40, 50), (3000, 7)],
                         ids=["3d", "2d", "1d"])
def test_ra_escape_ranks_on_card(cuda, shape, kind):
    """K13 reads the compact escapes: no escape at all (an empty escape
    stream), a block whose every cell escapes, escapes straddling the
    32-cell chunks, escapes only in cells 88 and on (a rank-3 warp's last
    staged words), one in a block's last cell (chip_smoke.
    ra_escape_layout), on the whole field and a region; equal to the
    plain version on the same inputs."""
    from sz_tpu_torch.core import rablock
    from sz_tpu_torch.gpu import ra_kernel as rk
    x = SMOKE.field(shape, 5)
    x = x.reshape(-1) if shape == (3000, 7) else x
    p = rablock.prepare(x, 1e-3, sz_tpu_torch.SZConfig(random_access=True))
    rank, bs, nb = x.ndim, p.bs, p.blocks.shape[0]
    radius = p.intervals // 2
    b = torch.from_numpy(p.blocks.reshape(nb, -1))
    lor = torch.from_numpy(p.indicator.astype(np.uint8))
    qc = torch.from_numpy(p.qc_full)
    t = rk.ra_encode(b, lor, qc, rank, bs, 1e-3, p.intervals, radius,
                     p.use_mean, p.mean)
    SMOKE.ra_escape_layout(t, kind, radius)
    vals = torch.from_numpy(np.random.default_rng(3).standard_normal(
        t.shape).astype(np.float32))
    unpred, base = SMOKE.ra_escapes(t, vals)
    assert (unpred.numel() == 0) == (kind == "none")
    dec = (rank, bs, 1e-3, radius, p.use_mean, p.mean)
    start = tuple(min(bs + 1, r - 1) for r in x.shape)
    for a, e in (((0,) * rank, x.shape), (start, x.shape)):
        sel, *geo = rablock.region_blocks(x.shape, bs, a, e)
        sel = torch.from_numpy(sel)
        args = (t[sel], unpred, base[sel], lor[sel], qc[sel], *dec, *geo)
        want, bad_p = rk.ra_decode(*args)
        got, bad = rk.ra_decode(*(a.to(cuda) if torch.is_tensor(a) else a
                                  for a in args))
        assert _bits_equal(got.cpu(), want)
        assert int(bad) == int(bad_p) == 0


@pytest.mark.gpu
def test_ra_escape_cases_on_card(cuda):
    """chip_smoke.ra_escape_cases on the card: K13 on the "tail" and
    "last" escape layouts and with one escape too many, against its plain
    version (it raises on any difference)."""
    rows = SMOKE.ra_escape_cases(cuda)
    assert any(r["past_the_end"] == [1, 1] for r in rows)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(13, 14, 20), (40, 50), (3000, 7)],
                         ids=["3d", "2d", "1d"])
def test_ra_escape_past_the_end_raises_on_card(cuda, shape):
    """One escape too many: the engine raises on the card as on the
    CPU."""
    from sz_tpu_torch.core import rablock
    from sz_tpu_torch.gpu import ra_engine
    x = SMOKE.field(shape, 5)
    x = x.reshape(-1) if shape == (3000, 7) else x
    p = rablock.prepare(x, 1e-3, sz_tpu_torch.SZConfig(random_access=True))
    rank, bs, nb = x.ndim, p.bs, p.blocks.shape[0]
    radius = p.intervals // 2
    types = np.full((nb, bs ** rank), radius, np.int32)
    SMOKE.ra_escape_layout(types, "last", radius)
    _, grid, lo, ext = rablock.region_blocks(x.shape, bs, (0,) * rank,
                                             x.shape)
    for dev in (torch.device("cpu"), cuda):
        with pytest.raises(ValueError, match="1 escapes past the 0"):
            ra_engine.decode_blocks(
                types, rank, bs, p.indicator, p.qc_full, 1e-3, radius,
                p.use_mean, p.mean, np.zeros(0, np.float32),
                np.zeros(nb, np.int64), grid, lo, ext, device=dev)


@pytest.mark.gpu
@pytest.mark.parametrize("shape,region", [
    ((40, 48, 56), ((5, 7, 11), (29, 40, 56))),
    ((200, 150), ((17, 0), (150, 33))),
    ((70000,), ((300,), (40000,)))])
def test_ra_on_card_matches_oracle(cuda, shape, region):
    x = _field(shape, 4)
    cfg = sz_tpu_torch.SZConfig(random_access=True).with_bound(
        sz_tpu_torch.ErrorBoundMode.ABS, 1e-3)
    blob = sz_tpu.compress(x, JConfig(random_access=True,
                                      engine="numpy").with_bound(
        JMode.ABS, 1e-3))
    assert sz_tpu_torch.compress(x, cfg, device=cuda) == blob
    got = sz_tpu_torch.decompress(blob, shape, np.float32, device=cuda)
    want = sz_tpu.decompress(blob, shape, np.float32)
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    reg = sz_tpu_torch.decompress_region(blob, shape, *region, device=cuda)
    ref = sz_tpu.decompress_region(blob, shape, *region)
    np.testing.assert_array_equal(reg.view(np.uint32), ref.view(np.uint32))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("name", SMOKE.TS_CASE_NAMES)
def test_ts_kernels_match_plain(cuda, name, dtype):
    """K14/K15 against their plain versions on chip_smoke's edge cases
    (ts_vs_plain raises on any difference), K15 rebuilding K14's
    reconstruction."""
    cur, prev, rp, kw = SMOKE.ts_case(name, dtype)
    row, _ = SMOKE.ts_vs_plain(name, torch.from_numpy(cur).to(cuda),
                               torch.from_numpy(prev).to(cuda), rp, kw,
                               False)
    assert row["quantize_bit_equal"] and row["decode_rebuilds_recon"]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("offset", SMOKE.TS_OFFSETS, ids="+".join)
def test_ts_kernels_at_storage_offsets(cuda, offset, dtype):
    """K14/K15 on inputs that are views at storage offset 1 (not 16-byte
    aligned: the kernels peel a head and read such an array a point at a
    time) against their plain versions."""
    cur, prev, rp, kw = SMOKE.ts_case(SMOKE.TS_OFFSET_CASE, dtype)
    row, _ = SMOKE.ts_vs_plain("offset", torch.from_numpy(cur).to(cuda),
                               torch.from_numpy(prev).to(cuda), rp, kw,
                               False, offset)
    assert row["quantize_bit_equal"] and row["decode_rebuilds_recon"]


@pytest.mark.gpu
@pytest.mark.parametrize("tensors", [False, True], ids=["numpy", "tensor"])
def test_temporal_on_card_matches_sz_tpu(cuda, tensors):
    """Five steps of a float32 3-D and a float64 2-D variable (snapshots
    at 0 and 3): the frames equal sz_tpu.temporal's (its numpy path), and
    the decode on the card equals sz_tpu's history (its own decode)."""
    from sz_tpu.temporal import TemporalCompressor as JTC
    from sz_tpu_torch.temporal import TemporalCompressor
    shapes = {0: ((30, 40, 50), np.float32), 1: ((60, 70), np.float64)}
    jc = JConfig(engine="numpy").with_bound(JMode.ABS, 1e-3)
    tc = sz_tpu_torch.SZConfig().with_bound(
        sz_tpu_torch.ErrorBoundMode.ABS, 1e-3)
    j = JTC(3)
    enc, dec = (TemporalCompressor(3, device=cuda) for _ in range(2))
    for vid, (shape, dt) in shapes.items():
        j.register(vid, f"v{vid}", shape, dt, jc)
        for c in (enc, dec):
            c.register(vid, f"v{vid}", shape, dt, tc)
    rng = np.random.default_rng(3)
    base = {v: rng.standard_normal(sh).astype(dt)
            for v, (sh, dt) in shapes.items()}
    for s in range(5):
        step = {}
        for v, x in base.items():
            y = (x + 0.01 * s + 0.002 * rng.standard_normal(x.shape)).astype(
                x.dtype)
            y.reshape(-1)[s::97] += 1.5
            step[v] = y
        frame = j.compress_step(step)
        given = ({v: torch.from_numpy(y).to(cuda) for v, y in step.items()}
                 if tensors else step)
        assert enc.compress_step(given) == frame, f"step {s}"
        out = dec.decompress_step(frame, as_tensor=True)
        for v in shapes:
            assert out[v].device.type == "cuda"
            want = np.asarray(j.vars[v].hist)
            got = out[v].cpu().numpy().reshape(-1)
            assert got.tobytes() == want.tobytes(), f"step {s} var {v}"
            assert enc.vars[v].hist.cpu().numpy().tobytes() == \
                want.tobytes()
