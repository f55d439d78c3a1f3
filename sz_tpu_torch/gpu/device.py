"""Explicit device handling for the port.

Counterpart of ``sz_tpu.tpu.engine._default_backend`` / ``_strict_jit``:
every entry point takes a ``device`` argument (the public ``compress`` and
``decompress`` default to ``"cuda"``); there is no global default.  A CUDA
request without a usable card raises instead of falling back to the CPU.  Strict per-op rounding needs nothing here: PyTorch runs
eagerly, one rounding per op, and the port never uses ``torch.compile``.
"""

from __future__ import annotations

import contextlib

import numpy as np
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
    """Wait for the work this thread queued on the device: its current
    stream, not the whole card, so a span times its own thread's work
    while other threads' slabs run on their own streams (on the one
    stream of a single-threaded caller this is all its work)."""
    if dev.type == "cuda":
        torch.cuda.current_stream(dev).synchronize()


@contextlib.contextmanager
def current(dev: torch.device):
    """Make ``dev`` the thread's current CUDA device, on which the C
    entry points launch (nothing to do for the CPU)."""
    if dev.type != "cuda":
        yield
        return
    with torch.cuda.device(dev):
        yield


def cache_tensor(a: np.ndarray, dev: torch.device) -> torch.Tensor:
    """``a`` copied to ``dev`` for a device cache, the copy finished
    before the tensor is published: threads on other streams read it at
    once."""
    t = torch.from_numpy(a).to(dev)
    sync(dev)
    return t


def cached(t: torch.Tensor) -> torch.Tensor:
    """A device cache's tensor, marked as in use by this thread's stream:
    if the cache drops it, its memory is reused only once the work queued
    here is done."""
    if t.is_cuda:
        t.record_stream(torch.cuda.current_stream(t.device))
    return t
