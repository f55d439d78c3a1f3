"""K3 ``histogram``: exact 65536-bin counts of the quantization types.

CUDA kernel in ``csrc/hist.cu`` (replaces
``sz_tpu/tpu/hist_kernel.py::histogram``, bf16 one-hot matmuls on the
TPU).  One pass over the symbols in 16-byte loads, bound on the H100 by
the bytes read.  Each block privatises a window of ``WINDOW`` bins in
shared memory, placed around the quantizer radius the caller passes as a
hint (:func:`window`); the radius bin and symbol 0 (the escapes) are
counted in registers, symbols outside the window by warp-aggregated
global atomics.  The hint only places the window: the counts are exact
for any hint.  The plain version is ``torch.bincount`` on the symbols in
range, and ignores the hint.
"""

from __future__ import annotations

import ctypes

import torch

from sz_tpu_torch.gpu import _build

NBINS = 65536
WINDOW = 4096  # csrc/hist.cu kWindow


def window(radius: int) -> tuple[int, int]:
    """(register bin, first bin of the shared-memory window) for a
    quantizer radius: the radius, clamped to [1, NBINS), and a
    WINDOW-bin window around it inside [1, NBINS)."""
    center = min(max(int(radius), 1), NBINS - 1)
    return center, min(max(center - WINDOW // 2, 1), NBINS - WINDOW)


def histogram_plain(sym: torch.Tensor) -> torch.Tensor:
    """Counts of the symbols in [0, 65536) as int32; others ignored."""
    s = sym.reshape(-1)
    s = s[(s >= 0) & (s < NBINS)]
    return torch.bincount(s, minlength=NBINS).to(torch.int32)


def histogram(sym: torch.Tensor, radius: int = NBINS // 2) -> torch.Tensor:
    """K3: 65536-bin int32 histogram of an int32 symbol tensor; negative
    symbols (holes) and symbols >= 65536 are ignored.  ``radius`` (the
    quantizer's, ``intervals // 2``) places the kernel's shared-memory
    window and never changes a count."""
    if sym.device.type == "cpu":
        return histogram_plain(sym)
    if sym.device.type != "cuda":
        raise ValueError(f"histogram: unsupported device {sym.device}")
    if sym.dtype != torch.int32 or not sym.is_contiguous():
        raise TypeError("histogram: contiguous int32 symbols required")
    center, lo = window(radius)
    hist = torch.empty(NBINS, dtype=torch.int32, device=sym.device)
    rc = _build.lib().sz_histogram(
        ctypes.c_void_p(sym.data_ptr()), sym.numel(), center, lo,
        ctypes.c_void_p(hist.data_ptr()),
        torch.cuda.current_stream(sym.device).cuda_stream)
    _build.check(rc, "histogram")
    _build.launched(histogram)
    return hist


histogram.launches = 0
