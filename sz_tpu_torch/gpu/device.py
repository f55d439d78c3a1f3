"""Explicit device handling for the port.

Counterpart of ``sz_tpu.tpu.engine._default_backend`` / ``_strict_jit``:
every entry point takes a ``device`` argument (the public ``compress`` and
``decompress`` default to ``"cuda"``); there is no global default.  A CUDA
request without a usable card raises instead of falling back to the CPU.  Strict per-op rounding needs nothing here: PyTorch runs
eagerly, one rounding per op, and the port never uses ``torch.compile``.
"""

from __future__ import annotations

import torch


def require_cuda() -> None:
    """Raise unless PyTorch sees a CUDA device."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "device='cuda' requested but torch.cuda.is_available() is "
            "False (no card, or a CPU-only PyTorch build)")


def resolve(device) -> torch.device:
    """``device`` (str or torch.device) -> torch.device; only 'cpu' and
    'cuda[:i]' are accepted."""
    dev = torch.device(device)
    if dev.type == "cuda":
        require_cuda()
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev


def sync(dev: torch.device) -> None:
    """Wait for the device's queued work (spans then time the device)."""
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
