"""Card-only tests of the PyTorch port: each CUDA kernel bit-equal to its
plain torch version (K5-K7 also on the decoded symbols), and the main
path byte-equal to the numpy oracle, on the GPU.  They skip where
torch.cuda.is_available() is false.

This file imports no jax, so it also runs on a machine without it; there
run it without the JAX-side conftest:
    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_gpu.py
Tolerance: exact (equal bits, equal bytes).
"""

import numpy as np
import pytest
import torch

from sz_tpu.core import regnd
from sz_tpu.format import huffman

from sz_tpu_torch.gpu import (engine, fsm_kernel, hist_kernel,
                              lorenzo_kernel, pack_kernel)

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
@pytest.mark.parametrize("shape", [(20, 33, 47), (1, 40, 300), (150, 130)])
@pytest.mark.parametrize("use_mean", [False, True])
def test_lorenzo_kernels_match_plain(cuda, shape, use_mean):
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
    dec = [args[3], args[2], (args[1].to(torch.float32) - RADIUS) * 2 * RP]
    assert _bits_equal(lorenzo_kernel.wavefront_decode(*dec),
                       lorenzo_kernel.decode_plain(*dec))


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
    if name == "fixed_9_bits":      # 9 phases that never meet: 8 slots
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
    k = fsm_kernel.fsm_sweep(c.bits, c.trans, c.total_bits, c.depth)
    p = fsm_kernel.fsm_sweep_plain(c.bits, c.trans, c.total_bits, c.depth)
    assert torch.equal(k[0], p[0]) and torch.equal(k[1], p[1])
    for stride in (1, 2, 64):
        a = fsm_kernel.fsm_sync(*k, stride)
        b = fsm_kernel.fsm_sync_plain(*k, stride)
        assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    got, steps = fsm_kernel.decode_coded(c, len(types), cuda)
    want, steps_cpu = fsm_kernel.decode(tree, enc, len(types), "cpu")
    assert steps == steps_cpu
    np.testing.assert_array_equal(got.cpu().numpy(), types)
    np.testing.assert_array_equal(want.numpy(), types)


@pytest.mark.gpu
@pytest.mark.parametrize("depth", [130, 1100])
def test_fsm_deep_codes_match_plain(cuda, depth):
    """Codes past the boundary-bitmap path (F + D >= 1120) and past one
    1024-bit chunk (F = 2048): random bits through a caterpillar tree
    whose code k is k ones and a zero."""
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
    k = fsm_kernel.fsm_sweep(c.bits, c.trans, c.total_bits, c.depth)
    p = fsm_kernel.fsm_sweep_plain(c.bits, c.trans, c.total_bits, c.depth)
    assert torch.equal(k[0], p[0]) and torch.equal(k[1], p[1])
    entry, off, total, _ = fsm_kernel.compose(*k)
    got = fsm_kernel.fsm_emit(c.bits, c.trans, c.total_bits, c.depth,
                              entry, off, total)
    want = fsm_kernel.fsm_emit_plain(c.bits, c.trans, c.total_bits,
                                     c.depth, entry, off, total)
    assert torch.equal(got, want)


@pytest.mark.gpu
def test_fsm_corrupt_stream_raises_on_card(cuda):
    types, nstate = _fsm_case("skewed")
    t = huffman.build_tables(types, nstate)
    enc = huffman.encode(t, types)[:-400]
    with pytest.raises(ValueError, match="corrupt"):
        fsm_kernel.decode((t.L, t.R, t.C, t.T, t.node_count), enc,
                          len(types), cuda)
