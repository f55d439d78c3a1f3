"""K5 ``fsm_sweep``, K6 ``fsm_sync`` and K7 ``fsm_emit``: the Huffman
decode of the type stream on the card.

CUDA kernels in ``csrc/fsm.cu``; they replace the three Pallas kernels of
``sz_tpu/tpu/fsm_kernel.py`` (``_fsm_call`` kernel A, ``_fsm_call_b``
kernel B, ``_compact_call`` kernel C) behind ``decode_bits_core``.

The coded stream splits into chunks of F bits (``chunk_bits``: 1024, or
the next multiple of 1024 at or above the longest code D), one thread
per chunk.  A walk from the root at a codeword boundary leaves its chunk
at the first boundary at or past F, which lies in [F, F + D); so each
chunk's true first boundary is one of D offsets, and the decode is a
composition of small maps:

- K5 walks every chunk from the root at each offset j < D: ``g[c, j]``
  is where the walk's last codeword ends inside chunk c + 1 and
  ``n[c, j]`` the symbols it emitted.  The kernel advances a chunk's
  walks together; walks from different offsets meet at a common
  boundary (Huffman codes self-synchronize) and go on as one;
- K6 is one doubling step of the prefix composition of the maps; after
  ceil(log2 L) steps ``g[c, 0]`` is chunk c + 1's first boundary and
  ``n[c, 0]`` the symbols of chunks 0..c.  The step count depends only
  on the chunk count, so every stream, also one that never
  self-synchronizes, decodes exactly in the same launches with no host
  sync between them;
- K7 walks each chunk from its true first boundary once more and writes
  its symbols as int32 at its int64 offset, dropping those past
  ``n_sym`` (the byte padding's junk).

What the TPU needed and Hopper does not: the TPU form kept 4 bytes of
records per coded bit, a 2048-bit sync window with a host fallback, a
merge-tree compaction, an 8192-node table window and a segment pipeline
past 2^30 bits.  Here there are no records (K7 re-walks instead), no
window (the composition is exact for every stream), no node cap (the
table sits in shared memory when it fits in 227 KB, else it is read
through L2), and bit offsets are int64.

The transition table is ``trans[2*s + b]`` (int32): the child of
internal node ``s`` on bit ``b``; a leaf child is stored as
``0x80000000 | symbol`` and resets the walk to the root.  Bits at or
past ``total_bits`` emit nothing.

Beside each kernel sits its plain torch version, vectorized over chunks
(and offsets) and looping over bit positions.  The wrappers take it only
for CPU tensors; for CUDA tensors they launch the kernel or raise.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from sz_tpu_torch.gpu import _build

F_BITS = 1024                  # bits per chunk = one 128-byte line
LEAF = 0x80000000
_I32, _I64 = torch.int32, torch.int64


def build_trans(L, R, C, T) -> np.ndarray:
    """The (2 * node_count,) int32 transition table of a serialized tree
    (the same values as ``sz_tpu.tpu.fsm_kernel.build_trans``, without
    its padding).  Raises ValueError on a tree no stream could decode
    through: a child index outside the tree or a symbol of 2^31 or
    more."""
    L, R, C = (np.asarray(a, np.int64) for a in (L, R, C))
    leaf = np.asarray(T) != 0
    nc = len(L)
    internal = ~leaf
    if nc >= 1 << 30:
        raise ValueError(f"Huffman tree of {nc} nodes is too large")
    if ((L[internal] >= nc).any() or (R[internal] >= nc).any()
            or (C[leaf] >= LEAF).any()):
        raise ValueError("corrupt Huffman tree: child index or symbol "
                         "out of range")
    out = np.empty(2 * nc, np.int64)
    for b, kid in ((0, L), (1, R)):
        kid = np.where(internal, kid, 0)     # a leaf's row is never read
        out[b::2] = np.where(leaf[kid], LEAF | C[kid], kid)
    return out.astype(np.uint32).view(np.int32)


def code_depth(L, R, T) -> int:
    """The longest code (deepest leaf) of a tree whose child indices
    ``build_trans`` accepted.  Raises ValueError when a walk from the
    root can loop without reaching a leaf."""
    L, R = np.asarray(L, np.int64), np.asarray(R, np.int64)
    leaf = np.asarray(T) != 0
    frontier, depth = np.zeros(1, np.int64), 0
    while frontier.size:
        depth += 1
        if depth > len(L):
            raise ValueError("corrupt Huffman tree: a cycle")
        kids = np.concatenate([L[frontier], R[frontier]])
        frontier = np.unique(kids[~leaf[kids]])
    return depth


def chunk_bits(depth: int) -> int:
    """Chunk length for codes of at most ``depth`` bits (F >= depth)."""
    return F_BITS * max(-(-depth // F_BITS), 1)


def nchunks_of(total_bits: int, f_bits: int = F_BITS) -> int:
    return max(-(-total_bits // f_bits), 1)


def pad_stream(encoded, device, f_bits: int = F_BITS) -> torch.Tensor:
    """The coded bytes on ``device``, zero-padded to whole chunks."""
    n = len(encoded)
    buf = np.empty(nchunks_of(8 * n, f_bits) * (f_bits // 8), np.uint8)
    buf[:n] = np.frombuffer(encoded, np.uint8)
    buf[n:] = 0
    return torch.from_numpy(buf).to(device)


# --- plain versions -------------------------------------------------------

def _walk_plain(bits, trans, total_bits: int, depth: int, start,
                out=None, offsets=None):
    """Walk every chunk from the root at offsets ``start`` ((L, K) int64)
    to its first boundary at or past F (or the stream's end).  Returns
    (next chunk's first boundary offset (L, K) int32, symbols (L, K)
    int64).  With ``out``, also writes each emitted symbol at
    offsets[c] + k."""
    F, D = chunk_bits(depth), depth
    L = bits.numel() * 8 // F
    dev = bits.device
    t = trans.to(_I64)
    base = torch.arange(L, dtype=_I64, device=dev)[:, None] * F
    lim = (total_bits - base).clamp(0, F + D)
    s = torch.zeros(start.shape, dtype=_I64, device=dev)
    cnt = torch.zeros_like(s)
    g = torch.zeros_like(s)
    done = start >= lim
    for q in range(F + D + 1):
        act = (start <= q) & ~done
        if not bool(act.any()):
            break
        fin = act & (((s == 0) & (q >= F)) | (lim == q))
        g = torch.where(fin, max(q - F, 0), g)
        done = done | fin
        act = act & ~fin
        pos = (base + q).clamp(max=8 * bits.numel() - 1)
        bit = (bits[pos >> 3].to(_I64) >> (7 - (pos & 7))) & 1
        v = t[2 * s + bit]
        emit = (v < 0) & act
        if out is not None:
            o = offsets[:, None] + cnt
            w = emit & (o < out.numel())
            out[o[w]] = (v[w] & 0x7FFFFFFF).to(_I32)
        cnt = cnt + emit.to(_I64)
        s = torch.where(act, torch.where(v < 0, 0, v), s)
    return g.to(_I32), cnt


def fsm_sweep_plain(bits, trans, total_bits: int, depth: int):
    L = bits.numel() * 8 // chunk_bits(depth)
    start = torch.arange(depth, dtype=_I64, device=bits.device).expand(
        L, depth)
    return _walk_plain(bits, trans, total_bits, depth, start)


def fsm_sync_plain(g, n, stride: int):
    if stride >= g.shape[0]:
        return g.clone(), n.clone()
    prev = g[:-stride].to(_I64)
    g2 = torch.gather(g[stride:], 1, prev)
    n2 = n[:-stride] + torch.gather(n[stride:], 1, prev)
    return torch.cat([g[:stride], g2]), torch.cat([n[:stride], n2])


def fsm_emit_plain(bits, trans, total_bits: int, depth: int, entry,
                   offsets, n_sym: int):
    out = torch.zeros(n_sym, dtype=_I32, device=bits.device)
    _walk_plain(bits, trans, total_bits, depth, entry.to(_I64)[:, None],
                out, offsets)
    return out


# --- wrappers -------------------------------------------------------------

def _check(name: str, bits, trans, total_bits: int, depth: int,
           *per_chunk):
    """Validate the common inputs; returns the chunk count."""
    if not 1 <= depth <= 1 << 17:
        raise ValueError(f"{name}: depth (longest code) outside 1..2^17")
    f_bytes = chunk_bits(depth) // 8
    if bits.dtype != torch.uint8 or bits.dim() != 1 or \
            bits.numel() % f_bytes or bits.numel() == 0:
        raise ValueError(f"{name}: bits must be a 1-D uint8 tensor of "
                         f"whole {f_bytes}-byte chunks")
    if trans.dtype != _I32 or trans.dim() != 1 or trans.numel() % 2:
        raise ValueError(f"{name}: trans must be a 1-D int32 table of "
                         f"2 * node_count entries")
    if not 0 <= total_bits <= 8 * bits.numel():
        raise ValueError(f"{name}: total_bits outside the stream")
    L = bits.numel() // f_bytes
    for t, dt in per_chunk:
        if t.dtype != dt or t.shape != (L,):
            raise ValueError(f"{name}: per-chunk inputs must have shape "
                             f"({L},) and dtype {dt}")
    _same_device(name, bits, trans, *(t for t, _ in per_chunk))
    return L


def _same_device(name: str, first, *rest) -> None:
    for t in rest:
        if t.device != first.device:
            raise ValueError(f"{name}: tensors on one device")
    if first.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {first.device}")


def _ptrs(*ts):
    return [ctypes.c_void_p(t.data_ptr()) for t in ts]


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def fsm_sweep(bits, trans, total_bits: int, depth: int):
    """K5: each chunk's map from the D = ``depth`` offsets of its first
    boundary.  Returns (g int32 (L, D), n int64 (L, D))."""
    L = _check("fsm_sweep", bits, trans, total_bits, depth)
    if bits.device.type == "cpu":
        return fsm_sweep_plain(bits, trans, total_bits, depth)
    bits, trans = bits.contiguous(), trans.contiguous()
    g = torch.empty((L, depth), dtype=_I32, device=bits.device)
    n = torch.empty((L, depth), dtype=_I64, device=bits.device)
    rc = _build.lib().sz_fsm_sweep(
        *_ptrs(bits, trans), trans.numel(), total_bits, L,
        chunk_bits(depth), depth, *_ptrs(g, n), _stream(bits))
    _build.check(rc, "fsm_sweep")
    fsm_sweep.launches += 1
    return g, n


def fsm_sync(g, n, stride: int):
    """K6: one doubling step of the prefix composition of the chunk maps:
    g'[c] = g[c] o g[c - stride], n'[c] = n[c - stride] + n[c][g[c -
    stride]] for c >= stride (else unchanged)."""
    if g.dtype != _I32 or n.dtype != _I64 or g.dim() != 2 or \
            g.shape != n.shape:
        raise ValueError("fsm_sync: g (int32) and n (int64) must be maps "
                         "of one (chunks, depth) shape")
    if stride < 1:
        raise ValueError("fsm_sync: stride must be >= 1")
    _same_device("fsm_sync", g, n)
    if g.device.type == "cpu":
        return fsm_sync_plain(g, n, stride)
    g, n = g.contiguous(), n.contiguous()
    g2, n2 = torch.empty_like(g), torch.empty_like(n)
    rc = _build.lib().sz_fsm_sync(
        *_ptrs(g, n), g.shape[0], g.shape[1], stride, *_ptrs(g2, n2),
        _stream(g))
    _build.check(rc, "fsm_sync")
    fsm_sync.launches += 1
    return g2, n2


def fsm_emit(bits, trans, total_bits: int, depth: int, entry, offsets,
             n_sym: int):
    """K7: each chunk's symbols from its first boundary ``entry``,
    written as int32 at its int64 ``offsets``; symbols at or past
    ``n_sym`` are dropped."""
    L = _check("fsm_emit", bits, trans, total_bits, depth, (entry, _I32),
               (offsets, _I64))
    if n_sym < 0:
        raise ValueError("fsm_emit: n_sym must be >= 0")
    if bits.device.type == "cpu":
        return fsm_emit_plain(bits, trans, total_bits, depth, entry,
                              offsets, n_sym)
    args = [t.contiguous() for t in (bits, trans, entry, offsets)]
    out = torch.empty(n_sym, dtype=_I32, device=bits.device)
    rc = _build.lib().sz_fsm_emit(
        *_ptrs(args[0], args[1]), trans.numel(), total_bits, L,
        chunk_bits(depth), depth, *_ptrs(args[2], args[3]), n_sym,
        *_ptrs(out), _stream(bits))
    _build.check(rc, "fsm_emit")
    fsm_emit.launches += 1
    return out


fsm_sweep.launches = fsm_sync.launches = fsm_emit.launches = 0


def compose(g, n):
    """K6 steps until every chunk's map starts at chunk 0.  Returns
    (chunk c's first boundary offset int32 (L,), its output offset
    int64 (L,), total symbols, steps)."""
    L, steps, stride = g.shape[0], 0, 1
    while stride < L:
        g, n = fsm_sync(g, n, stride)
        stride, steps = 2 * stride, steps + 1
    zero = torch.zeros(1, dtype=_I64, device=g.device)
    entry = torch.cat([zero.to(_I32), g[:-1, 0]])
    offsets = torch.cat([zero, n[:-1, 0]])
    return entry, offsets, int(n[-1, 0]), steps


def decode_bits(bits, trans, total_bits: int, depth: int, n_sym: int):
    """Decode ``n_sym`` symbols from a padded coded stream on its device
    (K5, K6 steps, K7) with codes of at most ``depth`` bits.  Returns
    (int32 symbols, K6 steps).  Raises ValueError when the stream emits
    a count outside [n_sym, n_sym + 7] (each junk symbol of the byte
    padding takes at least one of its at most 7 bits): the stream is
    corrupt."""
    g, n = fsm_sweep(bits, trans, total_bits, depth)
    entry, offsets, total, steps = compose(g, n)
    del g, n
    if not n_sym <= total <= n_sym + 7:
        raise ValueError(f"corrupt Huffman stream: {total} symbols coded, "
                         f"{n_sym} expected")
    return (fsm_emit(bits, trans, total_bits, depth, entry, offsets, n_sym),
            steps)


class Coded(NamedTuple):
    """A coded stream on its device, ready for ``decode_coded``: the
    table, the padded bytes and the longest code, or, for a tree whose
    root is a leaf, that leaf's symbol alone."""
    trans: torch.Tensor | None
    bits: torch.Tensor | None
    total_bits: int
    depth: int
    leaf_symbol: int


def upload(tree, encoded, device) -> Coded:
    """Validate the serialized ``tree`` = (L, R, C, T, node_count) and
    move it and the coded bytes to ``device``."""
    L, R, C, T, _ = tree
    if T[0]:
        return Coded(None, None, 0, 0, int(C[0]))
    trans = build_trans(L, R, C, T)
    depth = code_depth(L, R, T)
    return Coded(torch.from_numpy(trans).to(device),
                 pad_stream(encoded, device, chunk_bits(depth)),
                 8 * len(encoded), depth, 0)


def decode_coded(coded: Coded, n_sym: int, device):
    """``n_sym`` int32 symbols of an uploaded stream.  Returns (symbols,
    K6 steps).  A tree whose root is a leaf codes a constant stream with
    no bits (Huffman.c:310)."""
    if n_sym == 0:
        return torch.zeros(0, dtype=_I32, device=device), 0
    if coded.trans is None:
        return torch.full((n_sym,), coded.leaf_symbol, dtype=_I32,
                          device=device), 0
    return decode_bits(coded.bits, coded.trans, coded.total_bits,
                       coded.depth, n_sym)


def decode(tree, encoded, n_sym: int, device):
    """Huffman-decode ``n_sym`` symbols of ``encoded`` (bytes) with the
    serialized ``tree`` on ``device``.  Returns (int32 tensor, K6
    steps)."""
    return decode_coded(upload(tree, encoded, device), n_sym, device)
