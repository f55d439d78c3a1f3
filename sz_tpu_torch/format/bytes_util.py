"""Endian-safe scalar <-> byte helpers for the SZ2 stream format.

Mirrors the byte layouts produced by the reference toolkit
(ByteToolkit.c): multi-byte integers are big-endian on the wire; floats
and doubles written through floatToBytes/doubleToBytes are byte-swapped
to big-endian on little-endian systems (ByteToolkit.c:442,461), while
values written via raw memcpy stay in native (little-endian) order.

All helpers operate on Python ints/floats and bytes; the bulk encoders
live in huffman.py / tdps.py and use numpy.
"""

from __future__ import annotations

import struct

import numpy as np


def u16_be(v: int) -> bytes:
    return struct.pack(">H", v & 0xFFFF)


def i16_be(v: int) -> bytes:
    return struct.pack(">h", v)


def u32_be(v: int) -> bytes:
    return struct.pack(">I", v & 0xFFFFFFFF)


def i32_be(v: int) -> bytes:
    return struct.pack(">i", v)


def u64_be(v: int) -> bytes:
    return struct.pack(">Q", v & 0xFFFFFFFFFFFFFFFF)


def f32_be(v) -> bytes:
    """floatToBytes: big-endian IEEE-754 float32."""
    return struct.pack(">f", float(np.float32(v)))


def f64_be(v) -> bytes:
    """doubleToBytes: big-endian IEEE-754 float64."""
    return struct.pack(">d", float(v))


def f32_le(v) -> bytes:
    """Raw memcpy of a float on a little-endian system."""
    return struct.pack("<f", float(np.float32(v)))


def f64_le(v) -> bytes:
    return struct.pack("<d", float(v))


def size_be(v: int, size_type: int) -> bytes:
    """sizeToBytes (ByteToolkit.c:827): 4- or 8-byte big-endian."""
    return u32_be(v) if size_type == 4 else u64_be(v)


def read_u16_be(b, off: int) -> int:
    return struct.unpack_from(">H", b, off)[0]


def read_i32_be(b, off: int) -> int:
    return struct.unpack_from(">i", b, off)[0]


def read_u32_be(b, off: int) -> int:
    return struct.unpack_from(">I", b, off)[0]


def read_u64_be(b, off: int) -> int:
    return struct.unpack_from(">Q", b, off)[0]


def read_f32_be(b, off: int) -> np.float32:
    return np.float32(struct.unpack_from(">f", b, off)[0])


def read_f64_be(b, off: int) -> np.float64:
    return np.float64(struct.unpack_from(">d", b, off)[0])


def read_f32_le(b, off: int) -> np.float32:
    return np.float32(struct.unpack_from("<f", b, off)[0])


def read_f64_le(b, off: int) -> np.float64:
    return np.float64(struct.unpack_from("<d", b, off)[0])


def read_size_be(b, off: int, size_type: int) -> int:
    return read_u32_be(b, off) if size_type == 4 else read_u64_be(b, off)


def pack_bits_1(flags: np.ndarray) -> bytes:
    """1-bit packing, MSB first (TypeManager.c convertIntArray2ByteArray_fast_1b).

    Matches the reference: the bit for element i lands in byte i//8 at
    bit position (7 - i%8); the trailing partial byte is zero-padded.
    """
    arr = np.asarray(flags, dtype=np.uint8) & 1
    return np.packbits(arr).tobytes()


def unpack_bits_1(data: bytes, count: int) -> np.ndarray:
    """Inverse of pack_bits_1."""
    arr = np.unpackbits(np.frombuffer(data, dtype=np.uint8), count=count)
    return arr


def pack_bits_2(vals: np.ndarray) -> bytes:
    """2-bit packing, 4 values per byte, first value in the top bits
    (TypeManager.c:134 convertIntArray2ByteArray_fast_2b)."""
    arr = np.asarray(vals, dtype=np.uint8) & 3
    pad = (-len(arr)) % 4
    if pad:
        arr = np.concatenate([arr, np.zeros(pad, dtype=np.uint8)])
    arr = arr.reshape(-1, 4)
    packed = (arr[:, 0] << 6) | (arr[:, 1] << 4) | (arr[:, 2] << 2) | arr[:, 3]
    return packed.astype(np.uint8).tobytes()


def unpack_bits_2(data: bytes, count: int) -> np.ndarray:
    b = np.frombuffer(data, dtype=np.uint8)
    out = np.empty(len(b) * 4, dtype=np.uint8)
    out[0::4] = (b >> 6) & 3
    out[1::4] = (b >> 4) & 3
    out[2::4] = (b >> 2) & 3
    out[3::4] = b & 3
    return out[:count]
