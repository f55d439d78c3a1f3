"""The port's MSST19 PW_REL path on float64 data (K8d/K9d and the 1-D
recurrence) on the CPU against sz_tpu.

- the plain K8d/K9d (``gpu.msst19_kernel``'s ``_f64`` wrappers on CPU
  tensors) against ``sz_tpu.core.pwr``'s ``_encode_msst19_fast`` /
  ``_decode_msst19_fast`` with T = float64;
- the port's MSST19 engine against the JAX engine
  (``sz_tpu.tpu.msst19_engine``, its XLA scans on the CPU backend) and
  the host codec (``compress_msst19`` / ``decompress_pwrel``);
- ``sz_tpu_torch.compress`` / ``decompress`` against ``sz_tpu``'s
  (engine "numpy") at ranks 1-4, 1e-3 and 1e-5, signed and with zeros.

Inputs from numpy seeds (``tests.test_msst19_engine.synth``).  Tolerance:
exact -- equal bytes, equal bits.
"""

import dataclasses

import numpy as np
import pytest
import torch
torch.set_num_threads(1)  # xdist workers share the cores: one thread each

import sz_tpu
from sz_tpu import config as jcfg
from sz_tpu.core import pwr as jpwr
from sz_tpu.format import tdps as jtdps

import sz_tpu_torch
from sz_tpu_torch.config import DataType, ErrorBoundMode, SZConfig
from sz_tpu_torch.core import pwr
from sz_tpu_torch.format import tdps as ttdps
from sz_tpu_torch.gpu import msst19_engine, msst19_kernel

from tests.test_msst19_engine import KW, synth

F64 = np.float64

# the K8/K9 parity shapes, a single row and column, and a first row long
# enough for the k-2 neighbour across the 2-D tile's k-extent (64)
KERNEL_CASES = [((9, 11, 13), 5, False), ((14, 10, 12), 7, True),
                ((4, 3, 3), 9, False), ((26, 31), 11, False),
                ((18, 23), 13, True), ((1, 150), 3, False),
                ((70, 1), 4, True), ((2, 3, 70), 6, True)]


def _inputs(shape, seed, signed, ratio):
    data = synth(shape, F64, seed=seed, signed=signed)
    data[data == 0] = 0.5
    iv = pwr._optimize_intervals_msst19(data, ratio, 32768, 100,
                                        np.float32(0.99))
    cache = pwr._cache_table(iv, ratio, 3)
    ptable = pwr._precision_table(iv, ratio, 3)
    rl = msst19_engine.req_length(ratio, len(shape), F64)
    tables = (torch.from_numpy(cache.table.reshape(-1).view(np.int16)),
              torch.from_numpy(ptable), cache.base_index, cache.top_index,
              cache.bits, max(64 - rl, 0))
    return data, iv, rl, tables


def _wrappers(shape):
    if len(shape) == 3:
        return (msst19_kernel.wavefront3d_encode_f64,
                msst19_kernel.wavefront3d_decode_f64)
    return msst19_kernel.lines2d_encode_f64, msst19_kernel.lines2d_decode_f64


class _Escapes:
    """The decoder's escape source: the stored values, in raster order."""

    def __init__(self, vals):
        self.vals = vals

    def next_batch(self, k):
        assert k == len(self.vals)
        return self.vals


@pytest.mark.parametrize("ratio", [1e-3, 1e-5])
@pytest.mark.parametrize("shape,seed,signed", KERNEL_CASES)
def test_plain_f64_matches_host_chain(shape, seed, signed, ratio):
    """Encode: the types equal the host's vectorised chain in double;
    decode of those types with the escapes' stored values (the signed
    data truncated to req_length bits) equals the host's decode and
    rebuilds the encode's magnitudes."""
    from sz_tpu.core import classic as jclassic
    data, iv, rl, tables = _inputs(shape, seed, signed, ratio)
    enc = jclassic.ExactEncoder(rl, F64(0), F64, raw=True)
    want = jpwr._encode_msst19_fast(data, jpwr._cache_table(iv, ratio, 3),
                                    jpwr._precision_table(iv, ratio, 3), iv,
                                    enc, F64)
    encode, decode = _wrappers(shape)
    x = torch.from_numpy(data)
    types, rec = encode(x, *tables)
    np.testing.assert_array_equal(types.numpy().reshape(-1), want)
    assert (types == 0).any() and (types != 0).any()
    esc = msst19_kernel._trunc_plain(x, tables[-1])
    known = torch.where(types == 0, esc, torch.zeros_like(x))
    out = decode(types, known, tables[1])
    host = jpwr._decode_msst19_fast(
        want, shape, F64, jpwr._precision_table(iv, ratio, 3),
        _Escapes(esc.numpy().reshape(-1)[want == 0]))
    np.testing.assert_array_equal(out.numpy().reshape(-1).view(np.uint64),
                                  host.view(np.uint64))
    np.testing.assert_array_equal(out.abs().numpy().view(np.uint64),
                                  rec.numpy().view(np.uint64))


ENGINE_SHAPES = [(24, 19, 23), (7, 5), (1, 40), (33, 1, 17), (300,)]


@pytest.mark.parametrize("ratio", [1e-3, 1e-5])
@pytest.mark.parametrize("shape", ENGINE_SHAPES)
def test_engine_matches_host_codec(shape, ratio):
    data = synth(shape, F64, seed=len(shape))
    fmax = data.max()
    nz = np.abs(data[data != 0]).min()
    host = jpwr.compress_msst19(data, ratio, fmax, nz, **KW)
    got = msst19_engine.compress(data, ratio, fmax, nz, device="cpu", **KW)
    assert got.data_type == DataType.DOUBLE
    assert ttdps.to_bytes(got) == jtdps.to_bytes(host)
    out = msst19_engine.decompress(got, shape, F64, device="cpu")
    want = jpwr.decompress_pwrel(host, shape, F64)
    np.testing.assert_array_equal(out.view(np.uint64), want.view(np.uint64))


@pytest.mark.parametrize("shape", [(6, 5, 7), (7, 5)])
def test_engine_matches_jax_engine(shape):
    """The JAX engine's XLA scans (float64 runs there on the CPU
    backend only)."""
    from sz_tpu.tpu import msst19_engine as me
    data = synth(shape, F64, seed=len(shape), signed=True)
    data[data == 0] = 0.5
    fmax = data.max()
    nz = np.abs(data).min()
    want = me.compress(data, 1e-3, fmax, nz, **KW)
    got = msst19_engine.compress(data, 1e-3, fmax, nz, device="cpu", **KW)
    assert ttdps.to_bytes(got) == jtdps.to_bytes(want)
    np.testing.assert_array_equal(
        msst19_engine.decompress(got, shape, F64, device="cpu").view(
            np.uint64),
        np.asarray(me.decompress(want, shape, F64)).view(np.uint64))


def test_restore_sets_bit_63():
    """The zero flush and the sign bitmap on float64: the threshold in
    double, the sign as bit 63 of the int64 pattern."""
    out = torch.tensor([0.5, 1e-300, 2.0, 3.0, -1e-300], dtype=torch.float64)
    signs = torch.tensor([1, 1, 0, 1, 0], dtype=torch.uint8)
    got = msst19_engine.restore(out, 1e-200, signs)
    np.testing.assert_array_equal(got.numpy(),
                                  [-0.5, 0.0, 2.0, -3.0, -1e-300])
    got = msst19_engine.restore(out, 1e-200, None)
    np.testing.assert_array_equal(got.numpy(), [0.5, 0, 2.0, 3.0, 0])


def test_req_length_takes_the_dtype():
    """Float data: 9 - expo except the 2-D kernel's 12 - expo; double
    data: 12 - expo at every rank (sz_tpu/core/pwr.py:486-494)."""
    for rank in (1, 2, 3):
        assert msst19_engine.req_length(1e-3, rank, F64) == 12 + 10
    assert msst19_engine.req_length(1e-3, 3, np.float32) == 9 + 10
    assert msst19_engine.req_length(1e-3, 2, np.float32) == 12 + 10


def _jconfig(cfg):
    jc = jcfg.SZConfig(**{f.name: getattr(cfg, f.name)
                          for f in dataclasses.fields(cfg)
                          if hasattr(jcfg.SZConfig, f.name)})
    return dataclasses.replace(jc, engine="numpy")


@pytest.mark.parametrize("ratio", [1e-3, 1e-5])
@pytest.mark.parametrize("shape,signed", [
    ((500,), True), ((30, 41), False), ((12, 20, 24), True),
    ((3, 4, 10, 12), False)])
def test_api_matches_sz_tpu(shape, signed, ratio):
    data = synth(shape, F64, seed=11, signed=signed)
    data.reshape(-1)[::37] = 0.0
    cfg = SZConfig().with_bound(ErrorBoundMode.PW_REL, ratio)
    blob = sz_tpu.compress(data, _jconfig(cfg))
    assert sz_tpu_torch.compress(data, cfg, device="cpu") == blob
    got = sz_tpu_torch.decompress(blob, shape, F64, device="cpu")
    want = sz_tpu.decompress(blob, shape, F64, engine="numpy")
    assert got.dtype == F64
    np.testing.assert_array_equal(got.view(np.uint64), want.view(np.uint64))


def test_as_tensor_float64():
    data = synth((14, 15, 16), F64, seed=2, signed=True)
    cfg = SZConfig().with_bound(ErrorBoundMode.PW_REL, 1e-3)
    blob = sz_tpu_torch.compress(data, cfg, device="cpu")
    t = sz_tpu_torch.decompress(blob, data.shape, F64, device="cpu",
                                as_tensor=True)
    assert t.dtype == torch.float64
    np.testing.assert_array_equal(
        t.numpy(), sz_tpu_torch.decompress(blob, data.shape, F64,
                                           device="cpu"))
