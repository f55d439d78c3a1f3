"""Slab-parallel compression over several devices and streams: the port
of ``sz_tpu.parallel.slab``.

The field is cut along its slowest axis into slabs, as ``ra._slab_bounds``
cuts it; each slab is an ordinary call of the port's codec
(``api.compress`` / ``api.decompress``) on its own device, and the slabs
run at once, each in a thread of ``_pmap_host``'s pool under a CUDA
stream of its own.  On one card the slabs share its SMs: what overlaps
is one slab's host stages (the coefficient chain, the Huffman tree,
assembly, zstd) with the others' kernels.  The container is
``ra.build_container``, so every payload is byte-equal to
``api.compress`` of its slab and the whole container to
``sz_tpu.parallel.slab.compress_sharded`` (whose one-dispatch-per-stage
SPMD program has no counterpart here: a slab needs no collective).

Several processes (the MPI/HDF5 pattern: each rank compresses its slab,
rank 0 writes the container) need nothing more than ``api.compress`` and
``ra.build_container``; ``tests/_torch_mh_worker.py`` is that worker
over ``torch.distributed``.

Both entry points run on the visible cards unless ``devices`` names
others (the tests pass ``"cpu"``); without a card they raise.
"""

from __future__ import annotations

import functools
import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from sz_tpu_torch import api, native, ra
from sz_tpu_torch.config import DEFAULT_CONFIG, SZConfig, np_dtype
from sz_tpu_torch.gpu import _build
from sz_tpu_torch.gpu import device as devmod
from sz_tpu_torch.utils import trace as _tr


def _pmap_host(fn, n: int):
    """fn(i) for i in range(n) on a thread pool, results in order.

    The slabs' host stages are numpy and ctypes calls, which release the
    GIL, and their device stages wait on their own streams, so threads
    overlap them up to the core count.  SZ_TPU_HOST_THREADS=1 restores
    the serial loop."""
    k = int(os.environ.get("SZ_TPU_HOST_THREADS", os.cpu_count() or 1))
    if n <= 1 or k <= 1:
        return [fn(i) for i in range(n)]
    with ThreadPoolExecutor(max_workers=min(k, n)) as ex:
        return list(ex.map(fn, range(n)))


def slab_shapes(global_shape, n_devices: int):
    """Split the slowest axis into n_devices equal slabs (must divide)."""
    r0 = global_shape[0]
    if r0 % n_devices:
        raise ValueError(f"axis 0 ({r0}) must divide by mesh size "
                         f"{n_devices}")
    return (r0 // n_devices, *global_shape[1:])


def _devices(n_devices, devices, n_default=None) -> list:
    """The slabs' devices: ``devices`` as given; else ``n_devices`` (or
    ``n_default``, or one a card) spread over the visible cards round
    robin.  Raises without a card unless ``devices`` names others."""
    if devices is not None:
        devs = [devmod.resolve(d) for d in devices]
        if not devs or n_devices not in (None, len(devs)):
            raise ValueError(f"{len(devs)} devices given with "
                             f"n_devices={n_devices}")
    else:
        devmod.require_cuda()
        k = torch.cuda.device_count()
        n = n_devices or n_default or k
        devs = [torch.device("cuda", i % k) for i in range(n)]
    return devs


def _slab_list(parts) -> tuple:
    """(shape, dtype) of the field whose axis-0 slabs ``parts`` are; they
    must be split as ``ra._slab_bounds`` splits it, one row at least
    each."""
    if not parts or not all(torch.is_tensor(p) for p in parts):
        raise TypeError("a list of slabs must hold torch tensors")
    first = parts[0]
    if any(p.dim() < 1 or p.shape[1:] != first.shape[1:]
           or p.dtype != first.dtype for p in parts):
        raise ValueError("slabs of one dtype and one shape past axis 0 "
                         "expected")
    rows = [int(p.shape[0]) for p in parts]
    r0 = sum(rows)
    want = np.diff(ra._slab_bounds(r0, len(parts)).astype(np.int64))
    if min(rows) < 1 or rows != want.tolist():
        raise ValueError(f"slab rows {rows} are not the split "
                         f"{want.tolist()} of {r0} rows")
    return (r0, *(int(r) for r in first.shape[1:])), np_dtype(first.dtype)


@functools.lru_cache(maxsize=None)
def _stream(dev: torch.device, j: int):
    """The j-th slab stream of ``dev``, made once: the caching allocator
    keeps its blocks by stream, so a stream made anew each call would
    allocate (and free) its memory anew each call."""
    return torch.cuda.Stream(dev)


def _pool(devs: list, n: int, fn):
    """fn(i, device) for the n slabs at once, slab i on devs[i % len],
    each in its own thread (``_pmap_host``) with its device current and a
    CUDA stream of its own there.  A slab's stream first waits for the
    caller's queued work (the tensors handed in) and is drained before
    its thread returns; a tensor it returns is marked as in use by the
    caller's stream."""
    native.lib()   # load the libraries once, before any thread would
    if any(d.type == "cuda" for d in devs):
        _build.lib()
    callers = {d: torch.cuda.current_stream(d)
               for d in set(devs) if d.type == "cuda"}
    streams = [_stream(devs[i % len(devs)], i // len(devs))
               if devs[i % len(devs)].type == "cuda" else None
               for i in range(n)]

    def one(i):
        dev = devs[i % len(devs)]
        if dev.type != "cuda":
            return fn(i, dev)
        with torch.cuda.device(dev):
            s = streams[i]
            s.wait_stream(callers[dev])
            with torch.cuda.stream(s):
                out = fn(i, dev)
            s.synchronize()
        if torch.is_tensor(out):
            out.record_stream(callers[dev])
        return out

    return _pmap_host(one, n)


def compress_sharded(data, cfg: SZConfig = DEFAULT_CONFIG,
                     n_devices: int = None, *, devices=None) -> bytes:
    """Compress a field into an SZRA container, its slabs at once on
    several devices (or streams of one card); byte-equal to
    ``sz_tpu.parallel.slab.compress_sharded(data, cfg, n_devices=n)`` and
    to ``ra.compress(data, cfg, n_slabs=min(n, rows))``.

    ``data`` is a numpy array; a torch tensor, whose axis-0 slabs are
    compressed where they lie when they lie on their slab's device; or a
    list of tensors, one slab a device, split as ``ra._slab_bounds``
    splits the field (the torch form of a sharded array).  ``devices``
    lists the slabs' devices; else ``n_devices`` slabs (one a visible
    card by default) go round robin over the cards."""
    sliced = isinstance(data, (list, tuple))
    if sliced:
        shape, dtype = _slab_list(data)
        devs = _devices(n_devices, devices, len(data))
        n = len(data)
        if len(devs) != n:
            raise ValueError(f"{n} slabs for {len(devs)} devices")
    else:
        if not torch.is_tensor(data):
            data = np.asarray(data)
        shape = tuple(int(r) for r in data.shape)
        dtype = np_dtype(data.dtype)
        devs = _devices(n_devices, devices)
        n = min(len(devs), shape[0])
    if dtype not in ra._DT_CODE:
        raise TypeError(f"random-access container: {dtype}")
    starts = ra._slab_bounds(shape[0], n)
    slabs = data if sliced else [data[int(a):int(b)]
                                 for a, b in zip(starts[:-1], starts[1:])]
    with _tr.trace("slabs"):
        payloads = _pool(devs, n, lambda i, dev: api.compress(
            slabs[i], cfg, device=dev))
    with _tr.trace("container"):
        return ra.build_container(shape, dtype, starts, payloads)


def decompress_sharded(blob: bytes, n_devices: int = None, *, devices=None,
                       as_tensor: bool = False):
    """Decode an SZRA container, slab i on device i % n, the slabs at
    once; bit-equal to ``sz_tpu.parallel.slab.decompress_sharded`` and to
    ``ra.decompress``.  Returns the field as numpy, or with ``as_tensor``
    the list of slab tensors, each on the device that decoded it (the
    torch form of a field left sharded over the mesh)."""
    r = ra.Reader(blob)
    devs = _devices(n_devices, devices)
    with _tr.trace("slabs"):
        parts = _pool(devs, r.n_slabs, lambda i, dev: r.decode_slab(
            i, dev, as_tensor))
    if as_tensor:
        return parts
    with _tr.trace("concatenate"):
        return np.concatenate(parts, axis=0)
