"""sz_tpu_torch -- the PyTorch + CUDA (NVIDIA Hopper) port of sz_tpu.

The JAX package ``sz_tpu`` stays the reference; this package imports
nothing of it.  It keeps its own copy of the host stages (``config``,
``core``, ``format``, ``framing``, ``utils``, and the C host runtime with
the vendored zstd 1.3.5 in ``native``, built with ``cc`` at first use)
and runs the device stages in torch, with the TPU's Pallas kernels
replaced by CUDA C++ kernels for ``sm_90a`` (``csrc``, built with
``nvcc`` at first use).  It never imports ``jax``.

Public API, as sz_tpu exports it (float32 and float64 fields of rank 1-4
through the regression, classic, random-access, MSST19 and pre-log
codecs, and the eight integer dtypes through the integer codecs;
``data`` a numpy array or a torch tensor, which stays on the card when
it lies there on the regression and integer codecs' routes); each runs
on the card unless the caller passes ``device="cpu"``:
    compress(data, cfg, device="cuda") -> bytes
    decompress(blob, shape, dtype, device="cuda", as_tensor=False)
    decompress_region(blob, shape, start, end, dtype, device="cuda",
                      as_tensor=False)
    compress_region(data, start, end, cfg, mode=None, abs_bound=None,
                    rel_bound=None, device="cuda") -> bytes
    get_metadata(blob) -> dict
    SZConfig (SZConfig.from_file reads an sz.config INI), ErrorBoundMode,
    SZMode, Lossless, DataType

Submodules, reached as in sz_tpu (not exported here):
    sz_tpu_torch.ra -- the SZRA slab container: compress(data, cfg,
        slab_points, n_slabs, device="cuda"), build_container(shape,
        dtype, starts, payloads), Reader(blob), decompress(blob, device)
    sz_tpu_torch.parallel.slab -- the slabs at once over several devices
        (or streams of one card): compress_sharded(data, cfg, n_devices,
        devices=None) -> bytes, from a numpy array, a tensor or a list
        of slab tensors; decompress_sharded(blob, n_devices,
        devices=None, as_tensor=False)
    sz_tpu_torch.temporal -- TemporalCompressor
    sz_tpu_torch.cli -- the sz-tpu-torch command (python -m
        sz_tpu_torch.cli), the reference sz CLI's flags
    sz_tpu_torch.io, .pysz, .format.arith, .parallel.ompsz (the sz_omp
        byte format, on host threads), .integrations.{hdf5,readers},
        .apps.{exafel,pastri,wavelet}
"""

from sz_tpu_torch.api import (compress, compress_region, decompress,
                              decompress_region, get_metadata)
from sz_tpu_torch.config import (DataType, ErrorBoundMode, Lossless,
                                 SZConfig, SZMode)

__version__ = "0.1.0"

__all__ = ["SZConfig", "ErrorBoundMode", "SZMode", "Lossless", "DataType",
           "compress", "compress_region", "decompress", "decompress_region",
           "get_metadata", "__version__"]
