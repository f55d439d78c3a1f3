"""sz_tpu_torch -- the PyTorch + CUDA (NVIDIA Hopper) port of sz_tpu.

The JAX package ``sz_tpu`` stays the reference; this package imports
nothing of it.  It keeps its own copy of the host stages (``config``,
``core``, ``format``, ``framing``, ``utils``, and the C host runtime with
the vendored zstd 1.3.5 in ``native``, built with ``cc`` at first use)
and runs the device stages in torch, with the TPU's Pallas kernels
replaced by CUDA C++ kernels for ``sm_90a`` (``csrc``, built with
``nvcc`` at first use).  It never imports ``jax``.

Public API (the ported slice: float32 and float64 of rank 2-4 through the
regression codec, float32 through MSST19 PW_REL; ``data`` a numpy array
or a torch tensor, which stays on the card when it lies there); both run
on the card unless the caller passes ``device="cpu"``:
    compress(data, cfg, device="cuda") -> bytes
    decompress(blob, shape, dtype, device="cuda", as_tensor=False)
"""

from sz_tpu_torch.api import compress, decompress
from sz_tpu_torch.config import ErrorBoundMode, SZConfig

__all__ = ["compress", "decompress", "SZConfig", "ErrorBoundMode"]
