"""Arithmetic (range) coder — ArithmeticCoding.c replica (the port's
copy of ``sz_tpu.format.arith``, a host coder in numpy).

The reference ships a complete 44-bit range coder as an alternative
entropy stage (createAriCoder/ari_encode/ari_decode, unit-tested in
test/cunit-test/testArithmeticCoding.c) that is not wired into the main
float path; it is part of the component inventory, so it is provided
here with the same bitstream and the same serialized table layout
(pad_ariCoder/unpad_ariCoder, ArithmeticCoding.c:136/341).
"""

from __future__ import annotations

import dataclasses

import numpy as np

ONE_FOURTH = 0x40000000000
ONE_HALF = 0x80000000000
THREE_FOURTHS = 0xC0000000000
MAX_CODE = 0xFFFFFFFFFFF
MAX_INTERVALS = 1 << 20


@dataclasses.dataclass
class AriCoder:
    num_real_states: int
    num_valid_states: int
    total_frequency: int
    # per real state: (low, high, state); zero cells have high == 0
    low: np.ndarray
    high: np.ndarray
    state: np.ndarray


def create(num_states: int, s: np.ndarray) -> AriCoder:
    """createAriCoder + ari_init: cumulative frequency table, scaled so
    total <= MAX_INTERVALS (ArithmeticCoding.c:69-134)."""
    s = np.asarray(s, dtype=np.int64).ravel()
    freq = np.bincount(s, minlength=num_states)[:num_states]
    n = len(s)
    low = np.zeros(num_states, dtype=np.uint64)
    high = np.zeros(num_states, dtype=np.uint64)
    state = np.zeros(num_states, dtype=np.int64)
    if n > MAX_INTERVALS:
        intv = n // MAX_INTERVALS if n % MAX_INTERVALS == 0 \
            else n // MAX_INTERVALS + 1
        eff = freq // intv
        eff[(freq > 0) & (eff == 0)] = 1
    else:
        eff = freq
    csum = 0
    valid = 0
    for i in range(num_states):
        if freq[i]:
            low[i] = csum
            csum += int(eff[i])
            high[i] = csum
            state[i] = i
            valid += 1
    return AriCoder(num_states, valid, csum, low, high, state)


class _BitWriter:
    __slots__ = ("acc", "nbits")

    def __init__(self):
        self.acc = 0
        self.nbits = 0

    def put(self, bits: int, width: int):
        self.acc = (self.acc << width) | (bits & ((1 << width) - 1))
        self.nbits += width

    def bytes(self) -> bytes:
        pad = (-self.nbits) % 8
        total = self.acc << pad
        return total.to_bytes((self.nbits + pad) // 8 or 1, "big") \
            if self.nbits else b""


def encode(coder: AriCoder, s: np.ndarray) -> bytes:
    """ari_encode (ArithmeticCoding.c:534): 44-bit range coder with
    pending-bit output, MSB-first."""
    lo_t = coder.low
    hi_t = coder.high
    count = coder.total_frequency
    low = 0
    high = MAX_CODE
    pending = 0
    w = _BitWriter()
    for c in np.asarray(s, dtype=np.int64).ravel():
        p_lo = int(lo_t[c])
        p_hi = int(hi_t[c])
        rng = high - low + 1
        high = low + (rng * p_hi // count) - 1
        low = low + (rng * p_lo // count)
        while True:
            if high < ONE_HALF:
                w.put(0, 1)
                w.put((1 << pending) - 1, pending) if pending else None
                pending = 0
            elif low >= ONE_HALF:
                w.put(1, 1)
                w.put(0, pending) if pending else None
                pending = 0
            elif low >= ONE_FOURTH and high < THREE_FOURTHS:
                pending += 1
                low -= ONE_FOURTH
                high -= ONE_FOURTH
            else:
                break
            high = ((high << 1) + 1) & MAX_CODE
            low = (low << 1) & MAX_CODE
    pending += 1
    if low < ONE_FOURTH:
        w.put(0, 1)
        w.put((1 << pending) - 1, pending)
    else:
        w.put(1, 1)
        w.put(0, pending)
    return w.bytes()


def decode(coder: AriCoder, blob: bytes, target_length: int) -> np.ndarray:
    """ari_decode (ArithmeticCoding.c:639)."""
    out = np.zeros(target_length, dtype=np.int32)
    count = coder.total_frequency
    data = blob + b"\x00" * 16  # the reference reads past the buffer too
    value = int.from_bytes(data[:8], "big") >> 20
    bitpos = 44
    low = 0
    high = MAX_CODE
    lo_t = coder.low
    hi_t = coder.high
    # valid-state lookup: first cell with scaled < high (nulls have high 0)
    nz = np.flatnonzero(coder.high)
    nz_high = coder.high[nz].astype(np.int64)
    nz_low = coder.low[nz].astype(np.int64)
    nz_state = coder.state[nz]
    for i in range(target_length):
        rng = high - low + 1
        scaled = ((value - low + 1) * count - 1) // rng
        j = int(np.searchsorted(nz_high, scaled, side="right"))
        out[i] = nz_state[j]
        p_hi = int(nz_high[j])
        p_lo = int(nz_low[j])
        high = low + (rng * p_hi) // count - 1
        low = low + (rng * p_lo) // count
        while True:
            if high < ONE_HALF:
                pass
            elif low >= ONE_HALF:
                value -= ONE_HALF
                low -= ONE_HALF
                high -= ONE_HALF
            elif low >= ONE_FOURTH and high < THREE_FOURTHS:
                value -= ONE_FOURTH
                low -= ONE_FOURTH
                high -= ONE_FOURTH
            else:
                break
            low <<= 1
            high = (high << 1) + 1
            byte = data[bitpos >> 3]
            bit = (byte >> (7 - (bitpos & 7))) & 1
            value = (value << 1) + bit
            bitpos += 1
    return out


def pad(coder: AriCoder) -> bytes:
    """pad_ariCoder (ArithmeticCoding.c:136): big-endian header + packed
    (low, high, state) triples for the valid cells; field widths chosen
    by total_frequency (u16/u32) and numOfRealStates (u8/u16/u32)."""
    out = bytearray()
    out += int(coder.num_real_states).to_bytes(4, "big")
    out += int(coder.num_valid_states).to_bytes(4, "big")
    out += int(coder.total_frequency).to_bytes(8, "big")
    fw = 2 if coder.total_frequency <= 65536 else 4
    if coder.num_real_states <= 256:
        sw = 1
    elif coder.num_real_states <= 65536:
        sw = 2
    else:
        sw = 4
    for i in range(coder.num_real_states):
        if coder.high[i]:
            out += int(coder.low[i]).to_bytes(fw, "big")
            out += int(coder.high[i]).to_bytes(fw, "big")
            out += int(coder.state[i]).to_bytes(sw, "big")
    return bytes(out)


def unpad(blob: bytes) -> tuple:
    """unpad_ariCoder: returns (AriCoder, bytes_consumed)."""
    nreal = int.from_bytes(blob[0:4], "big")
    nvalid = int.from_bytes(blob[4:8], "big")
    total = int.from_bytes(blob[8:16], "big")
    fw = 2 if total <= 65536 else 4
    if nreal <= 256:
        sw = 1
    elif nreal <= 65536:
        sw = 2
    else:
        sw = 4
    low = np.zeros(nreal, dtype=np.uint64)
    high = np.zeros(nreal, dtype=np.uint64)
    state = np.zeros(nreal, dtype=np.int64)
    pos = 16
    for _ in range(nvalid):
        lo = int.from_bytes(blob[pos:pos + fw], "big")
        hi = int.from_bytes(blob[pos + fw:pos + 2 * fw], "big")
        st = int.from_bytes(blob[pos + 2 * fw:pos + 2 * fw + sw], "big")
        pos += 2 * fw + sw
        low[st] = lo
        high[st] = hi
        state[st] = st
    return AriCoder(nreal, nvalid, total, low, high, state), pos
