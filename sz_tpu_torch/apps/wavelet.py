"""Wavelet pre-transform compression (example/sz_gsl.c analog; the
port's copy of ``sz_tpu.apps.wavelet``, its codec calls on ``device``).

The reference's `sz_gsl` example (911 LoC) pre-processes 1D data with
a GSL Daubechies-4 forward wavelet transform (`gsl_wavelet_alloc
(gsl_wavelet_daubechies, 4)`, `gsl_wavelet_transform_forward`,
sz_gsl.c:334-344), compresses the transformed coefficients with SZ,
and inverts the transform after decompression.  GSL is not available
here, so the D4 pyramid transform (standard, periodic boundary — the
same algorithm GSL implements) is implemented directly; the
compression stage is the port's codec.  Requires a
power-of-two length like the GSL example.
"""

from __future__ import annotations

import numpy as np

from sz_tpu_torch import api
from sz_tpu_torch.config import SZConfig

_SQ3 = np.sqrt(3.0)
_DEN = 4.0 * np.sqrt(2.0)
# Daubechies-4 analysis filters (GSL daubechies coefficients, nc=4)
_H = np.array([(1 + _SQ3) / _DEN, (3 + _SQ3) / _DEN,
               (3 - _SQ3) / _DEN, (1 - _SQ3) / _DEN])
_G = np.array([_H[3], -_H[2], _H[1], -_H[0]])


def _dwt_step(a: np.ndarray) -> np.ndarray:
    """One standard pyramid step on the first len(a) coefficients
    (periodic boundary): [smooth | detail]."""
    n = len(a)
    idx = (np.arange(0, n, 2)[:, None] + np.arange(4)[None, :]) % n
    win = a[idx]
    return np.concatenate([win @ _H, win @ _G])


def _idwt_step(a: np.ndarray) -> np.ndarray:
    n = len(a)
    half = n // 2
    out = np.zeros(n)
    sm, de = a[:half], a[half:]
    for k in range(4):
        pos = (np.arange(0, n, 2) + k) % n
        np.add.at(out, pos, sm * _H[k] + de * _G[k])
    return out


def dwt_forward(data: np.ndarray) -> np.ndarray:
    """gsl_wavelet_transform_forward (full pyramid, n power of two)."""
    a = np.asarray(data, np.float64).copy()
    n = len(a)
    if n & (n - 1):
        raise ValueError("wavelet transform requires a power-of-two "
                         "length (as the GSL example does)")
    m = n
    while m >= 4:
        a[:m] = _dwt_step(a[:m])
        m //= 2
    return a


def dwt_inverse(coeffs: np.ndarray) -> np.ndarray:
    a = np.asarray(coeffs, np.float64).copy()
    n = len(a)
    m = 4
    while m <= n:
        a[:m] = _idwt_step(a[:m])
        m *= 2
    return a


def compress_wavelet(data: np.ndarray, cfg: SZConfig, *,
                     device="cuda") -> bytes:
    """sz_gsl -W: forward D4 transform, then SZ compression of the
    coefficient array (double, like the example's dwtdata)."""
    return api.compress(dwt_forward(data), cfg, device=device)


def decompress_wavelet(blob: bytes, n: int, *, device="cuda") -> np.ndarray:
    coeffs = api.decompress(blob, (n,), np.float64, device=device)
    return dwt_inverse(np.asarray(coeffs).reshape(-1))
