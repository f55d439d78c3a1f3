"""The integer codecs of the PyTorch port (ROADMAP 1.10) against sz_tpu on
the CPU: for every one of the eight integer dtypes at ranks 1 to 4, under
ABS (0.5, 4 and a bound near the range), REL and PSNR,
``sz_tpu_torch.compress(x, cfg, device="cpu")`` equals ``sz_tpu.compress``
byte for byte and the port's decode of that stream equals
``sz_tpu.decompress`` bit for bit; so do the constant and StoreOriData
streams, a tensor's compress and an ``as_tensor`` decode.  Ranks 2-4 run
K16/K17's plain versions here (the wrappers' CPU route).  Tolerance:
exact.
"""

import dataclasses

import numpy as np
import pytest
import torch
torch.set_num_threads(1)  # xdist workers share the cores: one thread each

import sz_tpu
from sz_tpu import config as jcfg

import sz_tpu_torch
from sz_tpu_torch.config import ErrorBoundMode, SZConfig
from sz_tpu_torch.format import lossless
from sz_tpu_torch.gpu import int_kernel

DTYPES = (np.int8, np.uint8, np.int16, np.uint16, np.int32, np.uint32,
          np.int64, np.uint64)
SHAPES = {1: (300,), 2: (20, 33), 3: (6, 9, 13), 4: (3, 4, 5, 6)}
BOUNDS = (("ABS", 0.5), ("ABS", 4.0), ("ABS", "near_range"), ("REL", 0.01),
          ("PSNR", 60.0))


def _field(dtype, shape, seed: int) -> np.ndarray:
    """A bounded random walk about the middle of an unsigned type (about
    0 for a signed one), values of a few hundred: no wrap in any width."""
    rng = np.random.default_rng(seed)
    walk = np.cumsum(rng.integers(-4, 5, int(np.prod(shape))))
    walk = np.clip(walk, -100, 100).reshape(shape)
    dt = np.dtype(dtype)
    off = 1 << (8 * dt.itemsize - 1) if dt.kind == "u" else 0
    return (walk.astype(np.int64).view(np.uint64) + np.uint64(off)).astype(
        f"u{dt.itemsize}").view(dt)


def _configs(mode: str, value, x: np.ndarray):
    """(the port's config, sz_tpu's) of one bound; "near_range" is 0.45
    of the field's range."""
    if value == "near_range":
        v = x.astype(np.int64)
        value = 0.45 * (int(v.max()) - int(v.min()))
    cfg = SZConfig().with_bound(getattr(ErrorBoundMode, mode), value)
    jc = jcfg.SZConfig(**{f.name: getattr(cfg, f.name)
                          for f in dataclasses.fields(cfg)
                          if hasattr(jcfg.SZConfig, f.name)})
    return cfg, dataclasses.replace(jc, engine="numpy")


def _parity(x: np.ndarray, cfg, jc, decode: bool = True) -> bytes:
    """sz_tpu's stream of ``x``, held equal to the port's, and (where
    ``decode``) the port's decode of it to sz_tpu's."""
    blob = sz_tpu.compress(x, jc)
    assert sz_tpu_torch.compress(x, cfg, device="cpu") == blob
    if not decode:
        return blob
    want = sz_tpu.decompress(blob, x.shape, x.dtype)
    got = sz_tpu_torch.decompress(blob, x.shape, x.dtype, device="cpu")
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    return blob


@pytest.mark.parametrize("rank", sorted(SHAPES))
@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: np.dtype(d).name)
def test_streams_and_decodes_equal_sz_tpu(dtype, rank):
    """Every bound's stream; the decodes of ABS 0.5 and of ABS near the
    range (the Huffman decode's plain version takes a third of a second a
    stream here)."""
    x = _field(dtype, SHAPES[rank], 10 * rank + DTYPES.index(dtype))
    for mode, value in BOUNDS:
        _parity(x, *_configs(mode, value, x),
                decode=value in (0.5, "near_range"))


@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: np.dtype(d).name)
def test_constant_and_verbatim_streams(dtype):
    """A constant field (the allSameData stream) and whole-range random
    data under ABS 0.5 (the StoreOriData fallback), at ranks 1 and 3."""
    dt = np.dtype(dtype)
    rng = np.random.default_rng(dt.itemsize)
    for shape in ((50,), (4, 5, 6)):
        const = np.full(shape, 7, dt)
        assert sz_tpu_torch.decompress(
            _parity(const, *_configs("ABS", 1.0, const)), shape, dt,
            device="cpu").tobytes() == const.tobytes()
        # values of bits - 2 bits: no difference reaches the width that
        # wraps a 1-D kernel's |difference| negative (refused alike)
        top = 1 << (8 * dt.itemsize - 2)
        noise = rng.integers(-top if dt.kind == "i" else 0, top,
                             shape).astype(dt)
        blob = _parity(noise, *_configs("ABS", 0.5, noise))
        inner = lossless.decompress(
            blob, expected_size=noise.nbytes * 2 + 128)
        assert inner[3] & 0x10   # the verbatim flag


def test_four_d_quirk_and_its_escape():
    """The 4-D encoder's cell (l, 0, 0, 1) codes a zero difference (and
    misses the bound there, as sz_tpu does); under ABS 0 every point
    escapes and that cell's escape stores the field's first element."""
    x = _field(np.int32, (3, 8, 10, 12), 5) * np.int32(3)
    cfg, jc = _configs("ABS", 4.0, x)
    blob = _parity(x, cfg, jc)
    assert not lossless.decompress(blob, expected_size=2 * x.nbytes)[3] \
        & 0x10   # coded, not verbatim
    out = sz_tpu_torch.decompress(blob, x.shape, x.dtype, device="cpu")
    cells = out.reshape(3, -1)[:, 1]
    assert np.array_equal(cells, out.reshape(3, -1)[:, 0])
    assert np.abs(out.astype(np.int64) - x).max() > 4
    cfg, jc = _configs("ABS", 0.0, x)
    out = sz_tpu_torch.decompress(_parity(x, cfg, jc), x.shape, x.dtype,
                                  device="cpu")
    assert np.all(out.reshape(3, -1)[:, 1] == x.reshape(-1)[0])


def test_wrapping_and_x86_conversions():
    """Fields that reach the recurrence's traps give sz_tpu's streams:
    int64 next to 2^63 (the reconstruction's double rounds to 2^63 and
    converts to INT64_MIN, as x86 does), uint64 above 2^63, and int32
    differences that wrap in 32 bits."""
    rng = np.random.default_rng(3)
    near = (np.int64(2 ** 63 - 1) - rng.integers(0, 50, (6, 7, 8)))
    cfg, jc = _configs("ABS", 1000.0, near)
    out = sz_tpu_torch.decompress(_parity(near, cfg, jc), near.shape,
                                  near.dtype, device="cpu")
    assert (out < 0).any()      # reconstructions that left the int64 range
    high = (np.arange(60, dtype=np.uint64).reshape(6, 10) * np.uint64(3)
            + np.uint64(2 ** 63 + 5))
    high[2, 3] += np.uint64(2 ** 62)
    for value in (4.0, 2.0 ** 60):
        _parity(high, *_configs("ABS", value, high))
    wide = rng.integers(-2 ** 31, 2 ** 31, (9, 10)).astype(np.int32)
    _parity(wide, *_configs("ABS", 0.5, wide))
    _parity(wide.view(np.uint32), *_configs("ABS", 4.0, wide.view(np.uint32)))


def test_negative_types_refused_alike():
    """A difference of 2^63 (int64 rows of +-2^62) quantizes to a type
    below zero: sz_tpu's type histogram refuses it, and so does the
    port."""
    x = np.zeros((4, 8), np.int64)
    x[0, ::2], x[0, 1::2] = -(2 ** 62), 2 ** 62
    cfg, jc = _configs("ABS", 4.0, x)
    with pytest.raises(ValueError):
        sz_tpu.compress(x, jc)
    with pytest.raises(ValueError, match="negative type"):
        sz_tpu_torch.compress(x, cfg, device="cpu")


@pytest.mark.parametrize("dtype", (np.uint16, np.int32, np.uint64),
                         ids=lambda d: np.dtype(d).name)
def test_tensor_input_and_as_tensor(dtype):
    """A tensor of an integer dtype (a view of an unsigned type's carrier
    included, and a non-contiguous one) compresses to the host array's
    bytes; ``as_tensor`` gives a tensor of the dtype holding sz_tpu's
    decode, at ranks 1 and 3."""
    for shape in ((300,), (6, 9, 13)):
        x = _field(dtype, shape, 4)
        cfg, jc = _configs("ABS", 4.0, x)
        blob = _parity(x, cfg, jc)
        t = int_kernel.to_carrier(x, "cpu").view(int_kernel.torch_dtype(
            dtype))
        assert sz_tpu_torch.compress(t, cfg, device="cpu") == blob
        out = sz_tpu_torch.decompress(blob, shape, dtype, device="cpu",
                                      as_tensor=True)
        assert out.dtype == int_kernel.torch_dtype(dtype)
        assert out.shape == shape
        assert out.numpy().tobytes() == sz_tpu.decompress(
            blob, shape, dtype).tobytes()
    x = _field(dtype, (13, 9, 6), 5)
    t = int_kernel.to_carrier(x, "cpu").view(
        int_kernel.torch_dtype(dtype)).permute(2, 1, 0)
    assert not t.is_contiguous()
    cfg, jc = _configs("ABS", 4.0, x)
    assert sz_tpu_torch.compress(t, cfg, device="cpu") == sz_tpu.compress(
        np.ascontiguousarray(x.transpose(2, 1, 0)), jc)
