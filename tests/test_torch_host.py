"""The port's own copies of the host stages (sz_tpu_torch.config, core,
format, framing, native) against their sz_tpu counterparts on seeded
inputs.  Tolerance: exact -- equal bytes, equal bits, equal values.
"""

import dataclasses
import filecmp
import pathlib

import numpy as np
import pytest

from sz_tpu import api as japi
from sz_tpu import config as jcfg
from sz_tpu import native as jnative
from sz_tpu.core import blocks as jblocks
from sz_tpu.core import optimizer as jopt
from sz_tpu.core import regnd as jregnd
from sz_tpu.format import bytes_util as jbu
from sz_tpu.format import huffman as jhuff
from sz_tpu.format import lossless as jll
from sz_tpu.format import metadata as jmd

from sz_tpu_torch import config as tcfg
from sz_tpu_torch import framing
from sz_tpu_torch import native as tnative
from sz_tpu_torch.core import blocks as tblocks
from sz_tpu_torch.core import optimizer as topt
from sz_tpu_torch.core import regnd as tregnd
from sz_tpu_torch.format import bytes_util as tbu
from sz_tpu_torch.format import huffman as thuff
from sz_tpu_torch.format import lossless as tll
from sz_tpu_torch.format import metadata as tmd
from sz_tpu_torch.gpu import fsm_kernel

REPO = pathlib.Path(__file__).resolve().parent.parent
KW = dict(max_range_radius=32768, sample_distance=100,
          pred_threshold=np.float32(0.99))


def _fib_freq():
    fib = [1, 1]
    while len(fib) < 90:
        fib.append(fib[-1] + fib[-2])
    freq = np.zeros(256, np.int64)
    freq[:90] = fib
    return freq


def _freq_cases():
    rng = np.random.default_rng(5)
    zipf = np.zeros(2 * 4096, np.int64)
    zipf[:3000] = (1e7 / np.arange(1, 3001) ** 1.3).astype(np.int64) + 1
    one = np.zeros(64, np.int64)
    one[17] = 9
    rand = rng.integers(0, 50, 2 * 700).astype(np.int64)
    return [("fib_past_64_bits", _fib_freq(), 128),
            ("zipf_3000", zipf, 4096), ("one_symbol", one, 32),
            ("random_700", rand, 700)]


@pytest.mark.parametrize("name,freq,state_num", _freq_cases(),
                         ids=[c[0] for c in _freq_cases()])
def test_build_tables_match(name, freq, state_num):
    a = thuff.build_tables(None, state_num, freq=freq)
    b = jhuff.build_tables(None, state_num, freq=freq)
    assert a.tree_bytes == b.tree_bytes and a.node_count == b.node_count
    for f in ("code_hi", "code_lo", "code_len", "L", "R", "C", "T"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
    if name == "fib_past_64_bits":
        assert int(a.code_len.max()) > 64
    for got, want in zip(thuff.deserialize_tree(a.tree_bytes, a.node_count),
                         jhuff.deserialize_tree(b.tree_bytes, b.node_count)):
        np.testing.assert_array_equal(got, want)
    assert thuff.tree_bytes_size(a.node_count) == len(a.tree_bytes) == \
        jhuff.tree_bytes_size(b.node_count)


@pytest.mark.parametrize("node_count", [1, 255, 256, 257, 65536, 65537])
def test_tree_bytes_size_matches(node_count):
    assert thuff.tree_bytes_size(node_count) == \
        jhuff.tree_bytes_size(node_count)


def test_encode_and_build_from_symbols_match():
    rng = np.random.default_rng(7)
    types = rng.choice(90, 20000, p=_fib_freq()[:90] / _fib_freq().sum())
    a = thuff.build_tables(types, 128)
    b = jhuff.build_tables(types.astype(np.int32), 128)
    assert a.tree_bytes == b.tree_bytes
    assert thuff.encode(a, types) == jhuff.encode(b, types.astype(np.int32))


def test_blocks_and_bytes_util_match():
    for bs in (6, 16):
        for r in range(1, 120):
            assert dataclasses.astuple(tblocks.dim_blocks(r, bs)) == \
                dataclasses.astuple(jblocks.dim_blocks(r, bs))
    rng = np.random.default_rng(9)
    flags = rng.random(1001) < 0.4
    assert tbu.pack_bits_1(flags) == jbu.pack_bits_1(flags)
    np.testing.assert_array_equal(
        tbu.unpack_bits_1(tbu.pack_bits_1(flags), 1001), flags)
    vals = rng.integers(0, 4, 999)
    assert tbu.pack_bits_2(vals) == jbu.pack_bits_2(vals)
    assert tbu.f32_be(1.1) == jbu.f32_be(1.1)
    assert tbu.size_be(123456789, 4) == jbu.size_be(123456789, 4)


def _dbs(shape, bs):
    return [tblocks.dim_blocks(r, bs) for r in shape]


@pytest.mark.parametrize("rank,use_mean", [(3, False), (3, True),
                                           (2, False)])
def test_coeff_chain_and_its_decode_match(rank, use_mean):
    rng = np.random.default_rng(11 + rank)
    shape = (40, 37, 29) if rank == 3 else (130, 150)
    bs = 6 if rank == 3 else 16
    nblk = int(np.prod([d.num for d in _dbs(shape, bs)]))
    ncoeff = rank + 1
    coeffs = (rng.standard_normal((nblk, ncoeff))
              * rng.choice([1e-4, 1.0, 1e3], (nblk, ncoeff))
              ).astype(np.float32)
    use_reg = rng.random(nblk) < 0.6
    rp = np.float32(1e-3)
    ts, js = tregnd._spec(rank, np.float32), jregnd._spec(rank, np.float32)
    a = tregnd.quantize_coeff_chain(coeffs, use_reg, rp, _dbs(shape, bs),
                                    ts, use_mean)
    b = jregnd.quantize_coeff_chain(
        coeffs, use_reg, rp, [jblocks.dim_blocks(r, bs) for r in shape],
        js, use_mean)
    np.testing.assert_array_equal(a[0], b[0])
    assert [np.asarray(u, np.float32).tobytes() for u in a[1]] == \
        [np.asarray(u, np.float32).tobytes() for u in b[1]]
    np.testing.assert_array_equal(a[2].view(np.uint32), b[2].view(np.uint32))
    np.testing.assert_array_equal(a[3].view(np.uint32), b[3].view(np.uint32))
    assert (a[0] == 0).any() and (a[0] != 0).any()
    cradius = np.full(ncoeff, tregnd.COEFF_RADIUS, np.int32)
    dec_t = tnative.coeff_chain_decode(a[0], a[3], cradius,
                                       [np.float32(u) for u in a[1]])
    dec_j = jnative.coeff_chain_decode(b[0], b[3], cradius,
                                       [np.float32(u) for u in b[1]],
                                       np.float32)
    np.testing.assert_array_equal(dec_t.view(np.uint32),
                                  dec_j.view(np.uint32))
    np.testing.assert_array_equal(dec_t.view(np.uint32),
                                  a[2].view(np.uint32))


def test_seq_sum_and_fold_mean_match():
    rng = np.random.default_rng(13)
    v = (rng.standard_normal(100003) * 1e3).astype(np.float32)
    assert tnative.seq_sum_f32(v) == jnative.seq_sum(v)
    assert topt.fold_mean(v) == jopt.fold_mean(v)
    assert topt.fold_mean(v[:0]) == jopt.fold_mean(v[:0])


@pytest.mark.parametrize("shape", [(30, 41, 53), (7, 9, 200), (300, 310)])
def test_optimizer_matches(shape):
    rng = np.random.default_rng(17)
    n = int(np.prod(shape))
    flat = (np.sin(np.linspace(0, 20, n)) + 0.01 * rng.standard_normal(n)
            ).astype(np.float32)
    flat[rng.random(n) < 0.2] = 0.5
    if len(shape) == 3:
        a = topt.optimize_intervals_3d_freq_dense(flat, *shape, 1e-3,
                                                  32768, 100, 0.99)
        b = jopt.optimize_intervals_3d_freq_dense(flat, *shape, 1e-3,
                                                  32768, 100, 0.99)
    else:
        a = topt.optimize_intervals_2d_freq_dense(flat, *shape, 1e-3,
                                                  32768, 100, 0.99)
        b = jopt.optimize_intervals_2d_freq_dense(flat, *shape, 1e-3,
                                                  32768, 100, 0.99)
    assert a == b
    for rank in (2, 3):
        assert topt.decide_use_mean(a[3], a[2], rank) == \
            jopt.decide_use_mean(b[3], b[2], rank)


_MODES = [(m, v) for m, v in [
    ("ABS", 1e-3), ("REL", 1e-4), ("ABS_AND_REL", 2e-3), ("ABS_OR_REL", 1e-3),
    ("PSNR", 80.0), ("NORM", 0.5), ("PW_REL", 1e-2), ("ABS_AND_PW_REL", 1e-3),
    ("ABS_OR_PW_REL", 1e-3), ("REL_AND_PW_REL", 1e-4),
    ("REL_OR_PW_REL", 1e-4)]]


def _configs(mode, value, **kw):
    t = tcfg.SZConfig(**kw).with_bound(tcfg.ErrorBoundMode[mode], value)
    j = jcfg.SZConfig(**kw).with_bound(jcfg.ErrorBoundMode[mode], value)
    return t, j


@pytest.mark.parametrize("mode,value", _MODES, ids=[m for m, _ in _MODES])
def test_header_matches_for_every_bound_mode(mode, value):
    for kw in ({}, dict(protect_value_range=True, size_type=4,
                        quantization_intervals=256, sample_distance=50),
               dict(lossless=tcfg.Lossless.GZIP, lossless_level=9,
                    sz_mode=tcfg.SZMode.BEST_SPEED)):
        t, j = _configs(mode, value, **kw)
        for dt, flags in ((tcfg.DataType.FLOAT, dict(regression=True)),
                          (tcfg.DataType.DOUBLE, dict(same=True)),
                          (tcfg.DataType.FLOAT, dict(lossless=True,
                                                     random_access=True))):
            a = tmd.make_header(t, dt, -1.25, 3.5, **flags)
            b = jmd.make_header(j, jcfg.DataType(int(dt)), -1.25, 3.5,
                                **flags)
            assert a == b
            pa = tmd.parse_header(a, dt)
            pb = jmd.parse_header(b, jcfg.DataType(int(dt)))
            assert dataclasses.asdict(pa) == dataclasses.asdict(pb)
            assert tmd.meta_length(dt) == jmd.meta_length(
                jcfg.DataType(int(dt)))


@pytest.mark.parametrize("backend,level", [("ZSTD", 3), ("ZSTD", 19),
                                           ("GZIP", 1), ("GZIP", 9)])
def test_lossless_matches(backend, level):
    rng = np.random.default_rng(19)
    data = (np.cumsum(rng.integers(-3, 4, 300000)).astype(np.int16)
            .tobytes())
    a = tll.compress(data, tcfg.Lossless[backend], level)
    assert a == jll.compress(data, jcfg.Lossless[backend], level)
    assert tll.decompress(a, len(data)) == data
    assert tll.sniff(a) == tcfg.Lossless[backend]
    assert tll.decompress(b"\x01\x02raw", 5) == b"\x01\x02raw"


def test_vendored_zstd_is_identical():
    theirs = REPO / "sz_tpu" / "native" / "vendor" / "zstd"
    ours = REPO / "sz_tpu_torch" / "native" / "vendor" / "zstd"
    files = sorted(p.relative_to(theirs) for p in theirs.rglob("*")
                   if p.is_file())
    assert files == sorted(p.relative_to(ours) for p in ours.rglob("*")
                           if p.is_file())
    assert len(files) == 42
    match, mismatch, errors = filecmp.cmpfiles(
        theirs, ours, [str(f) for f in files], shallow=False)
    assert not mismatch and not errors


@pytest.mark.parametrize("mode,value", _MODES[:6], ids=[m for m, _ in
                                                        _MODES[:6]])
def test_fp_stream_params_match(mode, value):
    rng = np.random.default_rng(23)
    data = (rng.standard_normal((20, 21, 22)) * 3 + 1).astype(np.float32)
    t, j = _configs(mode, value)
    a = framing._fp_stream_params(data, t, tcfg.DataType.FLOAT)
    b = japi._fp_stream_params(data, j, jcfg.DataType.FLOAT)
    assert a[:5] == b[:5] and a[6] is None and b[6] is None
    assert int(a[4]) == int(b[4])
    ta, jb = dataclasses.asdict(a[5]), dataclasses.asdict(b[5])
    jb.pop("engine")
    for k in ("accelerate_pw_rel", "plus_bits", "snapshot_cmpr_step",
              "segment_size", "pwr_type"):
        jb.pop(k)
    assert ta == jb
    assert framing._resolve_precision(t, 2.5, 1000) == \
        japi._resolve_precision(j, 2.5, 1000)


def _body_parts(shape, eb, seed):
    """A real body's intermediates, from sz_tpu's numpy codec pieces."""
    rng = np.random.default_rng(seed)
    n = int(np.prod(shape))
    data = (np.sin(np.linspace(0, 9, n, dtype=np.float32))
            + 0.05 * rng.standard_normal(n)).astype(np.float32).reshape(shape)
    return data, jregnd.compress(data, eb, **KW)


@pytest.mark.parametrize("shape", [(24, 25, 26), (90, 80)])
def test_parse_body_matches(shape):
    data, res = _body_parts(shape, 1e-3, 29)
    want = jregnd.parse_body(res.body, shape, np.float32, 8, raw_types=True)

    def dec(tree, enc, count):
        return fsm_kernel.decode(tree, enc, count, "cpu")[0].numpy()

    got = tregnd.parse_body(res.body, shape, np.float32, 8, dec)
    assert got.encoded == want.encoded
    for a, b in zip(got.tree, want.tree):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(got.indicator, want.indicator)
    np.testing.assert_array_equal(got.qcoeffs.view(np.uint32),
                                  want.qcoeffs.view(np.uint32))
    np.testing.assert_array_equal(got.unpred.view(np.uint32),
                                  want.unpred.view(np.uint32))
    assert (got.rp, got.intervals, got.use_mean, got.mean) == \
        (want.rp, want.intervals, want.use_mean, want.mean)
    assert [dataclasses.astuple(d) for d in got.dbs] == \
        [dataclasses.astuple(d) for d in want.dbs]
    assert got.spec.block_size == want.spec.block_size
    assert len(got.qcoeffs) > 0


@pytest.mark.parametrize("rank,use_mean", [(3, True), (2, False)])
def test_assemble_body_matches(rank, use_mean):
    rng = np.random.default_rng(31 + rank)
    shape = (30, 31, 32) if rank == 3 else (100, 120)
    bs = 6 if rank == 3 else 16
    tdbs = _dbs(shape, bs)
    nblk = int(np.prod([d.num for d in tdbs]))
    coeffs = rng.standard_normal((nblk, rank + 1)).astype(np.float32)
    use_reg = rng.random(nblk) < 0.5
    rp, intervals = np.float32(1e-3), 1024
    ts, js = tregnd._spec(rank, np.float32), jregnd._spec(rank, np.float32)
    ct, cun, _, cprec = tregnd.quantize_coeff_chain(
        coeffs, use_reg, rp, tdbs, ts, use_mean)
    types = rng.integers(0, intervals, int(np.prod(shape))).astype(np.int32)
    types[rng.random(types.size) < 0.01] = 0
    unpred = rng.standard_normal(int((types == 0).sum())).astype(np.float32)
    freq = np.bincount(types, minlength=2 * intervals)
    tt = thuff.build_tables(None, 2 * intervals, freq=freq)
    jt = jhuff.build_tables(None, 2 * intervals, freq=freq)
    enc = thuff.encode(tt, types)
    mean = np.float32(0.375)
    a = tregnd.assemble_body(ts, rp, intervals, use_mean, mean, use_reg, ct,
                             cun, cprec, unpred, 8, freq=freq, tables=tt,
                             encoded=enc, encode_coeff_types=thuff.encode)
    b = jregnd.assemble_body(js, rp, intervals, use_mean, mean, use_reg, ct,
                             cun, cprec, types, unpred, 8, freq=freq,
                             tables=jt, encoded=enc)
    assert a.body == b.body
    assert (a.reg_count, a.total_unpred, a.use_mean) == \
        (b.reg_count, b.total_unpred, b.use_mean)
