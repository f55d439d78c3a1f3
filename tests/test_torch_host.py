"""The port's own copies of the host stages (sz_tpu_torch.config, core,
format, framing, native) against their sz_tpu counterparts on seeded
inputs, the MSST19 PW_REL stages and tables included.  Tolerance: exact
-- equal bytes, equal bits, equal values.
"""

import dataclasses
import filecmp
import json
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch
torch.set_num_threads(1)  # xdist workers share the cores: one thread each

from sz_tpu import api as japi
from sz_tpu import config as jcfg
from sz_tpu import native as jnative
from sz_tpu.core import blocks as jblocks
from sz_tpu.core import classic as jclassic
from sz_tpu.core import optimizer as jopt
from sz_tpu.core import pwr as jpwr
from sz_tpu.core import regnd as jregnd
from sz_tpu.format import bytes_util as jbu
from sz_tpu.format import huffman as jhuff
from sz_tpu.format import lossless as jll
from sz_tpu.format import metadata as jmd
from sz_tpu.format import tdps as jtdps

from sz_tpu_torch import config as tcfg
from sz_tpu_torch import framing
from sz_tpu_torch import native as tnative
from sz_tpu_torch.core import blocks as tblocks
from sz_tpu_torch.core import classic as tclassic
from sz_tpu_torch.core import optimizer as topt
from sz_tpu_torch.core import pwr as tpwr
from sz_tpu_torch.core import regnd as tregnd
from sz_tpu_torch.format import bytes_util as tbu
from sz_tpu_torch.format import huffman as thuff
from sz_tpu_torch.format import lossless as tll
from sz_tpu_torch.format import metadata as tmd
from sz_tpu_torch.format import tdps as ttdps
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
    assert tnative.seq_sum(v) == jnative.seq_sum(v)
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
    jb.pop("engine")   # the port has device= instead
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


# --- the MSST19 PW_REL host stages ----------------------------------------

def _pw_field(shape, seed, zeros=0.0):
    rng = np.random.default_rng(seed)
    n = int(np.prod(shape))
    x = (np.exp(np.sin(np.linspace(0, 17, n))) * (1 + 0.05 * rng.standard_normal(
        n)) - 1.2).astype(np.float32).reshape(shape)
    x[rng.random(shape) < zeros] = 0
    return x


@pytest.mark.parametrize("shape,seed", [((30, 31, 32), 41), ((200, 150), 43)])
def test_pwrel_fp_stream_params_match(shape, seed):
    data = _pw_field(shape, seed, zeros=0.01)
    t, j = _configs("PW_REL", 1e-3)
    a = framing._fp_stream_params(data, t, tcfg.DataType.FLOAT)
    b = japi._fp_stream_params(data, j, jcfg.DataType.FLOAT)
    assert a[:5] == b[:5] and int(a[4]) == int(b[4])
    for x, y in zip(a[6], b[6]):
        np.testing.assert_array_equal(x, y)
    assert not a[6][4] and (a[6][3] == 1).any()     # signed: a sign bitmap
    assert tpwr.range_size_msst19(data)[5] == jpwr.range_size_msst19(data)[5]


def test_range_size_msst19_keeps_the_reference_quirks():
    """signs[0] is never set and nearZero starts at data[0]."""
    x = _pw_field((40, 50), 47)
    x[0, 0] = -0.0
    x[0, 1] = -3.0
    for data in (x, np.abs(x)):
        a, b = tpwr.range_size_msst19(data), jpwr.range_size_msst19(data)
        for u, v in zip(a, b):
            np.testing.assert_array_equal(u, v)
        assert a[3][0] == 0


@pytest.mark.parametrize("intervals,ratio", [(256, 1e-3), (4096, 1e-3),
                                             (65536, 1e-4), (65536, 1e-5),
                                             (512, 1e-2)])
def test_msst19_tables_match(intervals, ratio):
    a = tpwr._precision_table(intervals, ratio, 3)
    b = jpwr._precision_table(intervals, ratio, 3)
    np.testing.assert_array_equal(a.view(np.uint64), b.view(np.uint64))
    ta = tpwr._cache_table(intervals, ratio, 3)
    tb = jpwr._cache_table(intervals, ratio, 3)
    assert (ta.bits, ta.base_index, ta.top_index) == \
        (tb.bits, tb.base_index, tb.top_index)
    np.testing.assert_array_equal(ta.table, tb.table)
    assert ta.table.dtype == np.uint16 and int(ta.table.max()) == \
        intervals - 1


@pytest.mark.parametrize("shape,zeros", [((30, 31, 32), 0.0),
                                         ((300, 310), 0.0),
                                         ((20, 25, 30), 0.02),
                                         ((120, 90), 0.02)])
@pytest.mark.parametrize("ratio", [1e-2, 1e-3, 1e-5])
def test_msst19_optimizer_matches(shape, zeros, ratio):
    """Without zeros the vectorized walk; with sampled zeros the serial
    one."""
    data = _pw_field(shape, 53, zeros)
    a = tpwr._optimize_intervals_msst19(data, ratio, 32768, 100,
                                        np.float32(0.99))
    b = jpwr._optimize_intervals_msst19(data, ratio, 32768, 100,
                                        np.float32(0.99))
    assert a == b
    fast = tpwr._optimize_intervals_msst19_fast(data, ratio, 32768, 100,
                                                np.float32(0.99))
    assert (fast is None) == (zeros > 0)


@pytest.mark.parametrize("req_length", [19, 22, 26, 29, 32])
def test_exact_stream_and_its_decode_match(req_length):
    rng = np.random.default_rng(req_length)
    vals = (rng.standard_normal(5000) * np.exp(rng.uniform(-20, 20, 5000))
            ).astype(np.float32)
    vals[::7] = vals[::7] * np.float32(1.0001)   # shared leading bytes
    a, b = tclassic.ExactEncoder(req_length), jclassic.ExactEncoder(
        req_length, np.float32(0), np.float32, raw=True)
    ra = np.concatenate([a.add_batch(vals[:1234]), a.add_batch(vals[1234:])])
    rb = np.concatenate([b.add_batch(vals[:1234]), b.add_batch(vals[1234:])])
    np.testing.assert_array_equal(ra.view(np.uint32), rb.view(np.uint32))
    assert a.exact_count() == b.exact_count() == vals.size
    assert (a.lead_packed(), bytes(a.mid_bytes), a.resi_packed()) == \
        (b.lead_packed(), bytes(b.mid_bytes), b.resi_packed())
    t = ttdps.TDPS(data_type=tcfg.DataType.FLOAT, ds_length=0, intervals=0,
                   median_value=0.0, req_length=req_length,
                   real_precision=0.0, type_array=b"",
                   lead_num=a.lead_packed(), exact_mid_bytes=bytes(a.mid_bytes),
                   residual_mid_bits=a.resi_packed(),
                   exact_data_num=a.exact_count())
    got = tclassic.ExactDecoder(t).next_batch(vals.size)
    want = jclassic.ExactDecoder(t, np.float32, raw=True).next_batch(vals.size)
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    np.testing.assert_array_equal(got.view(np.uint32), ra.view(np.uint32))
    with pytest.raises(ValueError, match="corrupt"):
        tclassic.ExactDecoder(t).next_batch(vals.size - 1)


def test_get_exponent_matches():
    for v in (1e-2, 1e-3, 1e-4, 1e-5, 0.5, 3.0, 1e-30):
        for T in (np.float32, np.float64):
            assert tclassic.get_exponent(v, T) == jclassic.get_exponent(v, T)


@pytest.mark.parametrize("msst19,size_type", [(True, 8), (True, 4),
                                              (False, 8)])
def test_tdps_round_trip_matches(msst19, size_type):
    kw = dict(ds_length=0, intervals=4096, median_value=1.25, req_length=19,
              real_precision=1e-3, type_array=b"\x01\x02\x03" * 50,
              lead_num=b"\x1b" * 7, exact_mid_bytes=b"\xaa" * 30,
              residual_mid_bits=b"\x55" * 5, exact_data_num=25,
              max_quant_intervals=65536, rad_expo=3, segment_size=36,
              pwr_err_bound_bytes=b"\x28\xb5" * 9, min_log_value=2.5e-4,
              is_pwr=True, msst19=msst19, plus_bits=3 if msst19 else 0,
              max_bits=17 if msst19 else 0)
    a = ttdps.TDPS(data_type=tcfg.DataType.FLOAT, **kw)
    b = jtdps.TDPS(data_type=jcfg.DataType.FLOAT, **kw)
    raw = ttdps.to_bytes(a, size_type)
    assert raw == jtdps.to_bytes(b, size_type)
    back = ttdps.from_bytes(raw, tcfg.DataType.FLOAT, is_pwr=True,
                            msst19=msst19, size_type=size_type)
    want = jtdps.from_bytes(raw, jcfg.DataType.FLOAT, is_pwr=True,
                            msst19=msst19, size_type=size_type)
    ta, tb = dataclasses.asdict(back), dataclasses.asdict(want)
    assert {k: v for k, v in ta.items() if k != "data_type"} == \
        {k: v for k, v in tb.items() if k != "data_type"}
    assert int(back.data_type) == int(want.data_type)
    assert ttdps.to_bytes(back, size_type) == raw


def test_tune_malloc_keeps_freed_buffers_mapped():
    """After tune_malloc, a large host buffer freed and allocated again
    comes back from the heap already mapped: the refill takes almost no
    page faults (without the trim threshold it faults every page again).
    Run in a fresh process, whose heap nothing else touches."""
    code = (
        "import json, resource, numpy as np\n"
        "from sz_tpu_torch import native\n"
        "native.tune_malloc()\n"
        "faults = []\n"
        "for _ in range(3):\n"
        "    f0 = resource.getrusage(resource.RUSAGE_SELF).ru_minflt\n"
        "    a = np.empty(16 * 2**20, np.float32); a[:] = 1\n"
        "    faults.append(resource.getrusage(resource.RUSAGE_SELF)"
        ".ru_minflt - f0)\n"
        "    del a\n"
        "print(json.dumps(faults))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True,
                         cwd=pathlib.Path(__file__).resolve().parents[1])
    first, *again = json.loads(out.stdout)
    assert first > 0 and max(again) <= first // 20, (first, again)


@pytest.mark.parametrize("dtype,req_length", [(np.float32, 13),
                                              (np.float32, 32),
                                              (np.float64, 21),
                                              (np.float64, 44),
                                              (np.float64, 64)])
def test_exact_stream_with_median_matches(dtype, req_length):
    """The classic form of the escape stream (offset by the median), in
    float32 and float64, batched twice, and its decode."""
    rng = np.random.default_rng(req_length)
    vals = (rng.standard_normal(4000) * 3).astype(dtype)
    vals[::5] = vals[::5] * dtype(1.000001)
    med = dtype(0.75)
    a = tclassic.ExactEncoder(req_length, med, dtype)
    b = jclassic.ExactEncoder(req_length, med, dtype)
    ra = np.concatenate([a.add_batch(vals[:999]), a.add_batch(vals[999:])])
    rb = np.concatenate([b.add_batch(vals[:999]), b.add_batch(vals[999:])])
    u = np.uint32 if dtype is np.float32 else np.uint64
    np.testing.assert_array_equal(ra.view(u), rb.view(u))
    assert (a.lead_packed(), bytes(a.mid_bytes), a.resi_packed()) == \
        (b.lead_packed(), bytes(b.mid_bytes), b.resi_packed())
    t = ttdps.TDPS(data_type=tcfg.data_type(dtype), ds_length=0,
                   intervals=0, median_value=float(med),
                   req_length=req_length, real_precision=0.0,
                   type_array=b"", lead_num=a.lead_packed(),
                   exact_mid_bytes=bytes(a.mid_bytes),
                   residual_mid_bits=a.resi_packed(),
                   exact_data_num=a.exact_count())
    got = tclassic.ExactDecoder(t, dtype, raw=False).next_batch(vals.size)
    want = jclassic.ExactDecoder(t, dtype).next_batch(vals.size)
    np.testing.assert_array_equal(got.view(u), want.view(u))


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("rp", [1e-2, 1e-5])
def test_classic1d_encode_and_decode_match(dtype, rp):
    """host.c's 1-D recurrences against sz_tpu.native's, types and escape
    stream, then the decode of those types."""
    rng = np.random.default_rng(int(rp * 1e5))
    x = np.cumsum(rng.standard_normal(30000) * 0.01).astype(dtype)
    T = dtype
    rpT = T(rp)
    intervals, radius, rl = 1024, 512, 20 if dtype is np.float32 else 40
    med = T(x.min() + (x.max() - x.min()) / 2)
    got = tnative.classic1d_encode(x, rpT, intervals, radius, rl, med)
    want = jnative.classic1d_encode(x, rpT, float(rpT), intervals, radius,
                                    rl, med, False)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert got[2] == want[2] and got[4] == want[4]
    np.testing.assert_array_equal(got[3], want[3])
    resi = tnative.pack_w_bits(got[3], rl % 8) if rl % 8 else b""
    i2 = T(rpT * T(2))
    dec_t = tnative.classic1d_decode(got[0], i2, radius, rl, med, False,
                                     got[1], got[2], resi, T)
    dec_j = jnative.classic1d_decode(want[0], i2, radius, rl, med, False,
                                     want[1], want[2], resi, T)
    np.testing.assert_array_equal(dec_t, dec_j)


def test_msst19_1d_encode_and_decode_match():
    """host.c's 1-D MSST19 recurrences against sz_tpu.native's rank-1
    forms, on signed data with replaced zeros."""
    rng = np.random.default_rng(9)
    x = (np.sin(np.linspace(0, 30, 20000)) * 5
         + 0.01 * rng.standard_normal(20000)).astype(np.float32)
    x[x == 0] = np.float32(1e-6)
    ratio = 1e-3
    iv = jpwr._optimize_intervals_msst19(x, ratio, 32768, 100,
                                         np.float32(0.99))
    assert tpwr._optimize_intervals_msst19(x, ratio, 32768, 100,
                                           np.float32(0.99)) == iv
    cache = tpwr._cache_table(iv, ratio, 3)
    pt = tpwr._precision_table(iv, ratio, 3)
    rl = 19
    got = tnative.msst19_encode1d(x, cache.table, cache.base_index,
                                  cache.top_index, cache.bits, pt, rl)
    want = jnative.msst19_encode(x, cache.table, cache.base_index,
                                 cache.top_index, cache.bits, pt, rl)
    for g, w in zip(got, want):
        if isinstance(g, np.ndarray):
            np.testing.assert_array_equal(g, w)
        else:
            assert g == w
    resi = tnative.pack_w_bits(got[3], rl % 8)
    dec_t = tnative.msst19_decode1d(got[0], pt, rl, got[1], got[2], resi)
    dec_j = jnative.msst19_decode(want[0], (x.size,), pt, rl, want[1],
                                  want[2], resi, np.float32)
    np.testing.assert_array_equal(dec_t.view(np.uint32),
                                  dec_j.view(np.uint32))


def test_range_scan_f64_matches():
    """host.c's double range/sign scan against sz_tpu.native's, with the
    reference's quirks (signs[0] never set, nearZero from data[0])."""
    x = _pw_field((40, 50), 61).astype(np.float64) * np.pi
    x[0, 0] = -0.0
    x[3, 4] = 0.0
    got = tnative.range_scan(x.reshape(-1))
    want = jnative.range_scan(x.reshape(-1))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert isinstance(got[0], np.float64) and got[3][0] == 0
    a, b = tpwr.range_size_msst19(x), jpwr.range_size_msst19(x)
    for u, v in zip(a, b):
        np.testing.assert_array_equal(u, v)


@pytest.mark.parametrize("ratio", [1e-3, 1e-5])
def test_msst19_1d_f64_encode_and_decode_match(ratio):
    """host.c's double 1-D MSST19 recurrences against sz_tpu.native's
    rank-1 double forms (12 - expo kept bits)."""
    rng = np.random.default_rng(10)
    x = (np.sin(np.linspace(0, 30, 20000)) * 5
         + 0.01 * rng.standard_normal(20000))
    x[::97] = -x[::97]
    iv = jpwr._optimize_intervals_msst19(x, ratio, 32768, 100,
                                         np.float32(0.99))
    assert tpwr._optimize_intervals_msst19(x, ratio, 32768, 100,
                                           np.float32(0.99)) == iv
    cache = tpwr._cache_table(iv, ratio, 3)
    pt = tpwr._precision_table(iv, ratio, 3)
    rl = 12 - tclassic.get_exponent(np.float64(ratio), np.float64)
    got = tnative.msst19_encode1d(x, cache.table, cache.base_index,
                                  cache.top_index, cache.bits, pt, rl)
    want = jnative.msst19_encode(x, cache.table, cache.base_index,
                                 cache.top_index, cache.bits, pt, rl)
    for g, w in zip(got, want):
        if isinstance(g, np.ndarray):
            np.testing.assert_array_equal(g, w)
        else:
            assert g == w
    assert got[4] > 2
    resi = tnative.pack_w_bits(got[3], rl % 8)
    dec_t = tnative.msst19_decode1d(got[0], pt, rl, got[1], got[2], resi,
                                    np.float64)
    dec_j = jnative.msst19_decode(want[0], (x.size,), pt, rl, want[1],
                                  want[2], resi, np.float64)
    np.testing.assert_array_equal(dec_t.view(np.uint64),
                                  dec_j.view(np.uint64))


@pytest.mark.parametrize("nc", [2, 3, 4])
def test_ra_coeff_chain_and_its_decode_match(nc):
    """The random-access coefficient chain (double division, float last
    values) and its decode against sz_tpu.native's, escapes included."""
    rng = np.random.default_rng(nc)
    coeffs = (np.cumsum(rng.standard_normal((300, nc)), axis=0)
              * 1e-3).astype(np.float32)
    coeffs[::17] *= 1e4          # jumps past the cap: escapes
    prec = [1e-6] * (nc - 1) + [5e-5]
    got = tnative.ra_coeff_chain(coeffs, prec, 65536, 32768)
    want = jnative.ra_coeff_chain(coeffs, prec, 65536, 32768)
    np.testing.assert_array_equal(got[0], want[0])
    for a, b in zip(got[1], want[1]):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(got[2].view(np.uint32),
                                  want[2].view(np.uint32))
    assert sum(len(u) for u in got[1]) > 0
    rad = np.full(nc, 32768)
    dec = tnative.ra_coeff_chain_decode(got[0], prec, rad, got[1], 300)
    ref = jnative.ra_coeff_chain_decode(want[0], prec, rad, want[1], 300)
    np.testing.assert_array_equal(dec.view(np.uint32), ref.view(np.uint32))
    np.testing.assert_array_equal(dec.view(np.uint32),
                                  got[2].view(np.uint32))


def test_huff_block_streams_match():
    """Per-block streams under one table (byte-aligned, concatenated) and
    their decode against sz_tpu.native's, past 64-bit codes too."""
    rng = np.random.default_rng(3)
    syms = rng.zipf(1.3, (500, 216)).clip(0, 250).astype(np.int32)
    freq = np.bincount(syms.ravel(), minlength=512)
    freq[40:60] = _fib_freq()[50:70]      # deep codes
    t = thuff.build_tables(None, 256, freq=freq)
    got = tnative.huff_encode_blocks(syms, t.code_hi, t.code_lo, t.code_len)
    want = jnative.huff_encode_blocks(syms, t.code_hi, t.code_lo, t.code_len)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1] == want[1]
    off = np.concatenate([[0], np.cumsum(got[0].astype(np.int64))[:-1]])
    sel = np.arange(500)[::3]
    dec = tnative.huff_tree_decode_blocks(t.L, t.R, t.C, t.T, got[1],
                                          off[sel], got[0][sel], 216)
    ref = jnative.huff_tree_decode_blocks(t.L, t.R, t.C, t.T, want[1],
                                          off[sel], want[0][sel], 216)
    np.testing.assert_array_equal(dec, ref)
    np.testing.assert_array_equal(dec, syms[sel])


@pytest.mark.parametrize("dtype", [np.int32, np.uint16, np.int8, np.int64])
def test_int1d_encode_and_decode_match(dtype):
    """The 1-D integer recurrence (the A1 wrap width of each type) and
    its decode against sz_tpu.native's, at ABS 0.5 and a coarser bound."""
    rng = np.random.default_rng(5)
    info = np.iinfo(dtype)
    x = np.clip(np.cumsum(rng.integers(-9, 10, 3000)), max(info.min, -2000),
                min(info.max, 2000)).astype(dtype)
    a1 = {np.int32: np.int32, np.uint16: np.int64, np.int8: np.int64,
          np.int64: np.int64}[dtype]
    mn = int(x.min())
    esize = np.dtype(dtype).itemsize
    for rp, intervals in ((0.5, 64), (3.0, 32)):
        got = tnative.int1d_encode(x, rp, intervals, intervals // 2, a1, mn,
                                   2, esize)
        want = jnative.int1d_encode(x, rp, intervals, intervals // 2, a1,
                                    mn, 2, esize)
        np.testing.assert_array_equal(got[0], want[0])
        assert got[1:] == want[1:] and got[2] >= 2
        dec = tnative.int1d_decode(got[0], 2 * rp, intervals // 2, dtype, mn,
                                   2, esize, got[1])
        ref = jnative.int1d_decode(want[0], 2 * rp, intervals // 2, dtype,
                                   mn, 2, esize, want[1])
        assert dec.dtype == ref.dtype
        np.testing.assert_array_equal(dec, ref)
