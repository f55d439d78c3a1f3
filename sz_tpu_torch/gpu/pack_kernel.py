"""K4 ``pack_bits``: MSB-first Huffman bit-pack of the stream-ordered
type codes, byte-equal to ``sz_tpu.format.huffman.encode``.

CUDA kernel in ``csrc/pack.cu`` (replaces
``sz_tpu/tpu/pack_kernel.py::pack2_bits`` and ``::pack_bits``): one
launch that reads each symbol once.  A block packs a tile of ``TILE``
symbols (``THREADS`` runs of ``RUN``) into shared memory, finds the
tile's int64 bit offset by a single-pass chained scan with decoupled
look-back, and stores each output word once, big-endian.  Bound on the
H100 by bytes at best, in practice by a tile's latency; see the note in
``pack.cu``.  Unlike the TPU
kernels it needs no symbol window and no code-length cap below the
table's 128 bits, so one route serves every Huffman table.

Tables: ``code_hi``/``code_lo`` are ``HuffmanTables``' uint64 halves of
the MSB-aligned code, carried as int64 bit patterns (torch's unsigned
support is thin); ``code_len`` is int32.  The plain version is the same
scan + placement in int64 torch ops: the codes occupy disjoint bit
ranges, so ``scatter_add_`` on the words equals the OR.
"""

from __future__ import annotations

import ctypes

import torch

from sz_tpu_torch.gpu import _build

# the tile of csrc/pack.cu (kThreads, kRun)
THREADS = 256
RUN = 8
TILE = THREADS * RUN
_M32 = 0xFFFFFFFF


def _nbytes_words(total_bits: int):
    return (total_bits + 7) // 8, (total_bits + 31) // 32


def pack_bits_plain(sym, code_hi, code_lo, code_len,
                    total_bits: int) -> torch.Tensor:
    """Plain torch K4 (int64 arithmetic).  Returns uint8 bytes."""
    nbytes, nwords = _nbytes_words(total_bits)
    sym = sym.reshape(-1).to(torch.int64)
    valid = (sym >= 0) & (sym < code_len.numel())
    s = torch.where(valid, sym, 0)
    lens = torch.where(valid, code_len.to(torch.int64)[s], 0)
    offs = torch.cumsum(lens, 0) - lens
    hi, lo = code_hi[s], code_lo[s]
    c = [(hi >> 32) & _M32, hi & _M32, (lo >> 32) & _M32, lo & _M32,
         torch.zeros_like(hi)]
    for q in range(4):
        keep = (lens - 32 * q).clamp(0, 32)
        c[q] = c[q] & ((_M32 << (32 - keep)) & _M32)
    w0 = offs >> 5
    sh = offs & 31
    words = torch.zeros(nwords + 5, dtype=torch.int64, device=sym.device)
    for q in range(5):
        v = c[q] >> sh
        if q:
            v = v | torch.where(sh > 0, (c[q - 1] << (32 - sh)) & _M32, 0)
        words.scatter_add_(0, w0 + q, v)
    words = words[:nwords]
    out = torch.stack([(words >> 24) & 255, (words >> 16) & 255,
                       (words >> 8) & 255, words & 255], dim=1)
    return out.reshape(-1)[:nbytes].to(torch.uint8)


def pack_bits(sym, code_hi, code_lo, code_len,
              total_bits: int) -> torch.Tensor:
    """K4: pack int32 symbols (negative = hole, emits nothing) with the
    given 128-bit code table into ``ceil(total_bits / 8)`` big-endian
    bytes (uint8).  ``total_bits`` = sum of the symbols' code lengths,
    known on the host from the histogram.  Code lengths must lie in
    [0, 128], as a ``HuffmanTables``' do: the kernel's output for any
    other length is undefined and is not the plain version's."""
    if not code_hi.numel() == code_lo.numel() == code_len.numel():
        raise ValueError("pack_bits: code_hi, code_lo and code_len must "
                         "cover the same symbols")
    if total_bits < 0:
        raise ValueError("pack_bits: total_bits must be >= 0")
    if sym.device.type == "cpu":
        return pack_bits_plain(sym, code_hi, code_lo, code_len, total_bits)
    if sym.device.type != "cuda":
        raise ValueError(f"pack_bits: unsupported device {sym.device}")
    for t in (sym, code_hi, code_lo, code_len):
        if t.device != sym.device or not t.is_contiguous():
            raise ValueError("pack_bits: contiguous tensors on one device")
    if (sym.dtype != torch.int32 or code_len.dtype != torch.int32
            or code_hi.dtype != torch.int64 or code_lo.dtype != torch.int64):
        raise TypeError("pack_bits: dtypes i32 sym/len, i64 code halves")
    nbytes, nwords = _nbytes_words(total_bits)
    n = sym.numel()
    dev = sym.device
    words = torch.empty(nwords * 4, dtype=torch.uint8, device=dev)
    if n == 0 or nwords == 0:
        return words
    # a 16-byte descriptor a tile, then the tile counter (zeroed by C)
    desc = torch.empty((-(-n // TILE) + 1, 2), dtype=torch.int64,
                       device=dev)
    p = ctypes.c_void_p
    rc = _build.lib().sz_pack_bits(
        p(sym.data_ptr()), n, p(code_hi.data_ptr()), p(code_lo.data_ptr()),
        p(code_len.data_ptr()), code_len.numel(), p(desc.data_ptr()),
        p(words.data_ptr()), nwords,
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(rc, "pack_bits")
    _build.launched(pack_bits)
    return words[:nbytes]


pack_bits.launches = 0
