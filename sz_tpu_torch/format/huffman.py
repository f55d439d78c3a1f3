"""SZ2-compatible Huffman tables (the port's copy of the encode side of
``sz_tpu.format.huffman``).

The reference serializes its Huffman tree *structure* into every stream
(Huffman.c:503-585), and the tree's shape depends on the tie-breaking of
its binary-heap priority queue (Huffman.c:76-114), so the tree is built
by the reference's algorithm in the host runtime (``native/host.c``).
The bit-pack runs on the card (K4, ``gpu/pack_kernel.py``) and so does
the decode (K5-K7, ``gpu/fsm_kernel.py``); :func:`encode` here is the
plain numpy pack that tests hold K4 against.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from sz_tpu_torch import native


@dataclasses.dataclass
class HuffmanTables:
    """Everything needed to encode/decode one stream."""

    state_num: int
    node_count: int  # 2*distinct-1
    # per-symbol code as two uint64 halves (MSB-aligned like the reference)
    code_hi: np.ndarray  # uint64[state_num]
    code_lo: np.ndarray  # uint64[state_num]
    code_len: np.ndarray  # uint8[state_num]
    tree_bytes: bytes  # serialized tree (Huffman.c:503)
    # the tree in preorder layout: children, symbol, leaf flag per node
    L: np.ndarray
    R: np.ndarray
    C: np.ndarray
    T: np.ndarray


def _lr_dtype(node_count: int):
    if node_count <= 256:
        return np.uint8
    if node_count <= 65536:
        return np.uint16
    return np.uint32


def build_tables(type_codes, state_num: int, freq=None) -> HuffmanTables:
    """Histogram (unless ``freq`` is given) + tree + codes + serialized
    tree for one stream."""
    if freq is None:
        freq = np.bincount(np.asarray(type_codes).ravel(),
                           minlength=2 * state_num)
    freq = np.asarray(freq)
    if len(freq) < 2 * state_num:
        freq = np.concatenate(
            [freq, np.zeros(2 * state_num - len(freq), freq.dtype)])
    node_count = int(np.count_nonzero(freq)) * 2 - 1
    if node_count < 1:
        raise ValueError("a Huffman table needs at least one symbol")
    code_hi, code_lo, code_len, L, R, C, T = native.huff_build_tree(
        freq, state_num, node_count)
    lr = _lr_dtype(node_count)
    # convert_HuffTree_to_bytes_anyStates: sysEndianType byte, L, R in the
    # narrowest width, C as native little-endian u32, T as u8
    tree_bytes = (b"\x00" + L.astype(lr).tobytes() + R.astype(lr).tobytes()
                  + C.tobytes() + T.tobytes())
    return HuffmanTables(state_num=state_num, node_count=node_count,
                         code_hi=code_hi, code_lo=code_lo, code_len=code_len,
                         tree_bytes=tree_bytes, L=L, R=R, C=C, T=T)


def deserialize_tree(tree_bytes: bytes, node_count: int):
    """reconstruct_HuffTree_from_bytes_anyStates (Huffman.c:656)."""
    dt = _lr_dtype(node_count)
    w = np.dtype(dt).itemsize
    off = 1
    L = np.frombuffer(tree_bytes, dtype=dt, count=node_count, offset=off
                      ).astype(np.uint32)
    off += node_count * w
    R = np.frombuffer(tree_bytes, dtype=dt, count=node_count, offset=off
                      ).astype(np.uint32)
    off += node_count * w
    C = np.frombuffer(tree_bytes, dtype=np.uint32, count=node_count,
                      offset=off)
    off += node_count * 4
    T = np.frombuffer(tree_bytes, dtype=np.uint8, count=node_count,
                      offset=off)
    return L, R, C, T


def tree_bytes_size(node_count: int) -> int:
    return 1 + 2 * np.dtype(_lr_dtype(node_count)).itemsize * node_count \
        + 5 * node_count


def encode(tables: HuffmanTables, type_codes: np.ndarray) -> bytes:
    """Pack the per-symbol codes MSB-first, zero-padded to a byte
    boundary: the reference's encode() (Huffman.c:205), in numpy."""
    syms = np.asarray(type_codes, dtype=np.int64).ravel()
    lens = tables.code_len[syms].astype(np.int64)
    total_bits = int(lens.sum())
    if total_bits == 0:
        return b""
    offsets = np.concatenate([[0], np.cumsum(lens)[:-1]])
    bits = np.zeros((total_bits + 7) // 8 * 8, dtype=np.uint8)
    hi = tables.code_hi[syms]
    lo = tables.code_lo[syms]
    for j in range(int(tables.code_len.max())):
        active = lens > j
        if j < 64:
            bit = (hi[active] >> np.uint64(63 - j)) & np.uint64(1)
        else:
            bit = (lo[active] >> np.uint64(127 - j)) & np.uint64(1)
        bits[offsets[active] + j] = bit.astype(np.uint8)
    return np.packbits(bits).tobytes()
