"""K5 ``fsm_sweep``, K6 ``fsm_scan`` and K7 ``fsm_emit``: the Huffman
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
  ``n[c, j]`` the symbols it emitted.  Walks from different offsets meet
  at a common boundary (Huffman codes self-synchronize) and go on as
  one, so the kernel decodes each distinct boundary of a chunk once;
- K6 scans the maps from chunk 0, entered at 0: each chunk's first
  boundary ``entry[c + 1] = g[c, entry[c]]``, its output offset
  ``offsets[c + 1] = offsets[c] + n[c, entry[c]]`` and the stream's
  symbol count, in one launch (a scan with decoupled look-back over
  tiles of chunks).  It relies on no self-synchronization, so every
  stream, also one that never self-synchronizes, decodes exactly in the
  same three launches with no host sync between them;
- K7 walks each chunk from its true first boundary once more and writes
  its symbols as int32 at its int64 offset, dropping those past
  ``n_sym`` (the byte padding's junk).

K5 and K7 step a codeword at a time through ``build_lut``'s table of the
next k = min(12, D) bits from the root (a code of at most k bits
resolves in one lookup; a longer one goes on bit by bit through the
transition table from the node the entry names).  ``upload`` builds the
table on the host once per stream, beside the transition table, and the
kernels take both from the ``Coded`` stream it returns.

What the TPU needed and Hopper does not: the TPU form kept 4 bytes of
records per coded bit, a 2048-bit sync window with a host fallback, a
merge-tree compaction, an 8192-node table window and a segment pipeline
past 2^30 bits.  Here there are no records (K7 re-walks instead), no
window (the composition is exact for every stream), no node cap (the
codeword table sits in shared memory, the transition table is read
through L1/L2), and bit offsets are int64.

The transition table is ``trans[2*s + b]`` (int32): the child of
internal node ``s`` on bit ``b``; a leaf child is stored as
``0x80000000 | symbol`` and resets the walk to the root.  Bits at or
past ``total_bits`` emit nothing.

Beside each kernel sits its plain torch version, vectorized over chunks
(and offsets) and looping over bit positions: the bit-by-bit semantics
the codeword steps are held to.  The wrappers take it only for CPU
tensors; for CUDA tensors they launch the kernel or raise.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from sz_tpu_torch.gpu import _build

F_BITS = 1024                  # bits per chunk = one 128-byte line
LEAF = 0x80000000
LUT_BITS = 12                  # bits a codeword-table lookup reads
LUT_PAYLOAD = 1 << 26          # symbols and nodes an entry can name
WINDOW_DEPTH = 63              # K5's windowed sweep takes codes this long
SCAN_WARPS = 8                 # K6: warps that compose a tile
SCAN_WINDOW = 32               # K6: predecessors a look-back step reads
# K6: shared memory a block such that two share an SM (fsm.cu kSmemPerSm
# / 2, less the 1 KB the card reserves a block)
SCAN_SMEM = 233472 // 2 - 1024
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


def build_lut(trans: np.ndarray, depth: int) -> np.ndarray:
    """The (2^k,) int32 codeword table of a transition table, k =
    min(``LUT_BITS``, ``depth``): entry x belongs to the k bits x (first
    bit highest) read from the root.  A code of at most k bits is
    ``LEAF | length << 26 | symbol``; else the entry is ``k << 26 |
    node``, the internal node reached after the k bits, from which a walk
    goes on bit by bit.  A symbol or node of 2^26 or more gets entry 0
    (node 0 after 0 bits: the whole code is walked bit by bit)."""
    k = min(LUT_BITS, depth)
    t = np.asarray(trans, np.int32).astype(np.int64)
    x = np.arange(1 << k, dtype=np.int64)
    s = np.zeros_like(x)
    out = np.zeros_like(x)
    done = np.zeros(x.shape, bool)
    for i in range(k):
        v = t[2 * s + ((x >> (k - 1 - i)) & 1)]
        leaf = (v < 0) & ~done
        sym = v & 0x7FFFFFFF
        out[leaf] = np.where(sym < LUT_PAYLOAD,
                             LEAF | (i + 1) << 26 | sym, 0)[leaf]
        done |= leaf
        s = np.where(done, 0, v)
    node = ~done
    out[node] = np.where(s < LUT_PAYLOAD, k << 26 | s, 0)[node]
    return out.astype(np.uint32).view(np.int32)


def chunk_bits(depth: int) -> int:
    """Chunk length for codes of at most ``depth`` bits (F >= depth)."""
    return F_BITS * max(-(-depth // F_BITS), 1)


def nchunks_of(total_bits: int, f_bits: int = F_BITS) -> int:
    return max(-(-total_bits // f_bits), 1)


def pad_stream(encoded, device, f_bits: int = F_BITS) -> torch.Tensor:
    """The coded bytes (``bytes``, or a 1-D uint8 tensor on ``device``)
    on ``device``, zero-padded to whole chunks."""
    n = len(encoded)
    if torch.is_tensor(encoded):
        buf = torch.zeros(nchunks_of(8 * n, f_bits) * (f_bits // 8),
                          dtype=torch.uint8, device=device)
        buf[:n] = encoded
        return buf
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


def fsm_scan_plain(g, n):
    """K6's plain version: the prefix composition of the maps by
    doubling (ceil(log2 L) steps, g[c] o g[c - stride] and n[c - stride]
    + n[c][g[c - stride]]), after which g[c, 0] is chunk c + 1's first
    boundary and n[c, 0] the symbols of chunks 0..c."""
    stride = 1
    while stride < g.shape[0]:
        prev = g[:-stride].to(_I64)
        g = torch.cat([g[:stride], torch.gather(g[stride:], 1, prev)])
        n = torch.cat([n[:stride],
                       n[:-stride] + torch.gather(n[stride:], 1, prev)])
        stride *= 2
    zero = torch.zeros(1, dtype=_I64, device=g.device)
    return (torch.cat([zero.to(_I32), g[:-1, 0]]),
            torch.cat([zero, n[:-1, 0]]), n[-1:, 0].clone())


def fsm_emit_plain(bits, trans, total_bits: int, depth: int, entry,
                   offsets, n_sym: int):
    out = torch.zeros(n_sym, dtype=_I32, device=bits.device)
    _walk_plain(bits, trans, total_bits, depth, entry.to(_I64)[:, None],
                out, offsets)
    return out


# --- wrappers -------------------------------------------------------------

class Coded(NamedTuple):
    """A coded stream on its device, as ``upload`` makes it and the
    kernels take it: the transition and codeword tables, the padded
    bytes and the longest code, or, for a tree whose root is a leaf, that
    leaf's symbol alone."""
    trans: torch.Tensor | None
    lut: torch.Tensor | None
    bits: torch.Tensor | None
    total_bits: int
    depth: int
    leaf_symbol: int


def upload(tree, encoded, device) -> Coded:
    """Validate the serialized ``tree`` = (L, R, C, T, node_count), build
    its tables and move them and the coded bytes (``bytes``, or a uint8
    tensor on ``device``) to ``device``."""
    L, R, C, T, _ = tree
    if T[0]:
        return Coded(None, None, None, 0, 0, int(C[0]))
    trans = build_trans(L, R, C, T)
    depth = code_depth(L, R, T)
    return Coded(torch.from_numpy(trans).to(device),
                 torch.from_numpy(build_lut(trans, depth)).to(device),
                 pad_stream(encoded, device, chunk_bits(depth)),
                 8 * len(encoded), depth, 0)


def _check(name: str, coded: Coded, *per_chunk):
    """Validate a coded stream and the per-chunk inputs; returns the
    chunk count."""
    bits, trans, lut = coded.bits, coded.trans, coded.lut
    total_bits, depth = coded.total_bits, coded.depth
    if trans is None:
        raise ValueError(f"{name}: a tree whose root is a leaf codes no "
                         f"bits")
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
    k = min(LUT_BITS, depth)
    if lut is None or lut.dtype != _I32 or lut.shape != (1 << k,):
        raise ValueError(f"{name}: the codeword table must be build_lut's: "
                         f"1-D int32 of 2^{k} entries")
    if not 0 <= total_bits <= 8 * bits.numel():
        raise ValueError(f"{name}: total_bits outside the stream")
    L = bits.numel() // f_bytes
    for t, dt in per_chunk:
        if t.dtype != dt or t.shape != (L,):
            raise ValueError(f"{name}: per-chunk inputs must have shape "
                             f"({L},) and dtype {dt}")
    _same_device(name, bits, trans, lut, *(t for t, _ in per_chunk))
    return L


def _same_device(name: str, first, *rest) -> None:
    for t in rest:
        if t.device != first.device:
            raise ValueError(f"{name}: tensors on one device")
    if first.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {first.device}")


def _ptrs(*ts):
    return [ctypes.c_void_p(None if t is None else t.data_ptr())
            for t in ts]


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def fsm_sweep(coded: Coded):
    """K5: each chunk's map from the D = ``coded.depth`` offsets of its
    first boundary.  Returns (g int32 (L, D), n int64 (L, D))."""
    L = _check("fsm_sweep", coded)
    bits, trans, lut = (t.contiguous() for t in
                        (coded.bits, coded.trans, coded.lut))
    depth, total_bits = coded.depth, coded.total_bits
    if bits.device.type == "cpu":
        return fsm_sweep_plain(bits, trans, total_bits, depth)
    g = torch.empty((L, depth), dtype=_I32, device=bits.device)
    n = torch.empty((L, depth), dtype=_I64, device=bits.device)
    F = chunk_bits(depth)
    # codes past the window: a boundary bitmap and its prefix counts a
    # chunk, F + D + 1 bits each
    scratch = None if depth <= WINDOW_DEPTH else torch.empty(
        L * 2 * ((F + depth) // 32 + 1), dtype=_I32, device=bits.device)
    rc = _build.lib().sz_fsm_sweep(
        *_ptrs(bits, trans, lut), min(LUT_BITS, depth), total_bits, L, F,
        depth, *_ptrs(g, n, scratch), _stream(bits))
    _build.check(rc, "fsm_sweep")
    _build.launched(fsm_sweep)
    return g, n


def scan_smem(tile: int, depth: int) -> int:
    """Shared memory of a K6 block on the windowed path: the staged rows,
    the runs' composites, the tile's outputs and the look-back's buffer
    of ``SCAN_WINDOW`` aggregates (rows of ``depth`` rounded up to 4), 12
    B each."""
    padded = -(-depth // 4) * 4
    return 12 * (tile * depth + SCAN_WARPS * depth + tile
                 + SCAN_WINDOW * padded)


def scan_tile(depth: int) -> int:
    """Chunks a K6 tile for maps of ``depth`` offsets: 32 past the
    windowed depth (no rows staged); else the largest of 32..512 whose
    block fits ``SCAN_SMEM``, so that two blocks share an SM."""
    if depth > WINDOW_DEPTH:
        return 32
    return next(t for t in (512, 256, 128, 64, 32)
                if scan_smem(t, depth) <= SCAN_SMEM)


def fsm_scan(g, n):
    """K6: each chunk's first boundary (int32 (L,)) and output offset
    (int64 (L,)), and the stream's symbol count (int64 (1,), on the
    device), from K5's maps g (int32 (L, D)) and n (int64 (L, D)), chunk
    0 entered at offset 0.  g's entries lie in [0, D), as K5 writes them
    (for others the result is unspecified; the kernel reads inside its
    inputs)."""
    if g.dtype != _I32 or n.dtype != _I64 or g.dim() != 2 or \
            g.shape != n.shape:
        raise ValueError("fsm_scan: g (int32) and n (int64) must be maps "
                         "of one (chunks, depth) shape")
    if g.shape[0] < 1 or not 1 <= g.shape[1] <= 1 << 17:
        raise ValueError("fsm_scan: the maps need a chunk and a depth in "
                         "1..2^17")
    _same_device("fsm_scan", g, n)
    if g.device.type == "cpu":
        return fsm_scan_plain(g, n)
    return _scan(g.contiguous(), n.contiguous(), scan_tile(g.shape[1]))


def _scan(g, n, tile: int):
    """K6's launch on contiguous CUDA maps, ``tile`` chunks a tile."""
    L, D = g.shape
    ntiles, padded = -(-L // tile), -(-D // 4) * 4
    scratch = torch.empty(16 * (ntiles + 1) + 12 * ntiles * padded,
                          dtype=torch.uint8, device=g.device)
    entry = torch.empty(L, dtype=_I32, device=g.device)
    offsets = torch.empty(L, dtype=_I64, device=g.device)
    total = torch.empty(1, dtype=_I64, device=g.device)
    rc = _build.lib().sz_fsm_scan(*_ptrs(g, n), L, D, tile,
                                  *_ptrs(scratch, entry, offsets, total),
                                  _stream(g))
    _build.check(rc, "fsm_scan")
    _build.launched(fsm_scan)
    return entry, offsets, total


def fsm_emit(coded: Coded, entry, offsets, n_sym: int):
    """K7: each chunk's symbols from its first boundary ``entry``,
    written as int32 at its int64 ``offsets``; symbols at or past
    ``n_sym`` are dropped."""
    L = _check("fsm_emit", coded, (entry, _I32), (offsets, _I64))
    if n_sym < 0:
        raise ValueError("fsm_emit: n_sym must be >= 0")
    bits, trans, lut = (t.contiguous() for t in
                        (coded.bits, coded.trans, coded.lut))
    depth, total_bits = coded.depth, coded.total_bits
    if bits.device.type == "cpu":
        return fsm_emit_plain(bits, trans, total_bits, depth, entry,
                              offsets, n_sym)
    entry, offsets = entry.contiguous(), offsets.contiguous()
    out = torch.empty(n_sym, dtype=_I32, device=bits.device)
    rc = _build.lib().sz_fsm_emit(
        *_ptrs(bits, trans, lut), min(LUT_BITS, depth), total_bits, L,
        chunk_bits(depth), depth, *_ptrs(entry, offsets), n_sym,
        *_ptrs(out), _stream(bits))
    _build.check(rc, "fsm_emit")
    _build.launched(fsm_emit)
    return out


fsm_sweep.launches = fsm_scan.launches = fsm_emit.launches = 0


def decode_coded(coded: Coded, n_sym: int, device):
    """``n_sym`` int32 symbols of an uploaded stream (K5, K6, K7).
    Returns (symbols, K6 scans: 1, or 0 where no bits are decoded).  A
    tree whose root is a leaf codes a constant stream with no bits
    (Huffman.c:310).  Raises ValueError when
    the stream emits a count outside [n_sym, n_sym + 7] (each junk symbol
    of the byte padding takes at least one of its at most 7 bits): the
    stream is corrupt."""
    if n_sym == 0:
        return torch.zeros(0, dtype=_I32, device=device), 0
    if coded.trans is None:
        return torch.full((n_sym,), coded.leaf_symbol, dtype=_I32,
                          device=device), 0
    g, n = fsm_sweep(coded)
    entry, offsets, total = fsm_scan(g, n)
    del g, n
    total = int(total)
    if not n_sym <= total <= n_sym + 7:
        raise ValueError(f"corrupt Huffman stream: {total} symbols coded, "
                         f"{n_sym} expected")
    return fsm_emit(coded, entry, offsets, n_sym), 1


def decode(tree, encoded, n_sym: int, device):
    """Huffman-decode ``n_sym`` symbols of ``encoded`` (bytes) with the
    serialized ``tree`` on ``device``.  Returns (int32 tensor, K6
    scans)."""
    return decode_coded(upload(tree, encoded, device), n_sym, device)
