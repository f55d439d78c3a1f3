"""Compression statistics (the port's copy of ``sz_tpu.utils.stats``:
sz_stats.h:20-46 / printSZStats sz_stats.c:48).

The reference collects into a mutable global under HAVE_WRITESTATS;
here stats are collected per call into a thread-local slot the caller
can read back:

    from sz_tpu_torch.utils import stats
    with stats.collect() as s:
        blob = sz_tpu_torch.compress(data, cfg)
    print(s.report())

The codecs record where ``sz_tpu`` records, the same fields with the same
values: the sizes of a regression, classic, 1-D or random-access stream
(``framing``), and the regression body's blocks, escapes and Huffman
stream (``core/regnd.assemble_body``).  PW_REL, constant, verbatim-only
and integer streams record nothing, as in ``sz_tpu``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading

_tls = threading.local()


@dataclasses.dataclass
class SZStats:
    original_size: int = 0
    compressed_size: int = 0
    use_mean: bool = False
    block_size: int = 0
    lorenzo_blocks: int = 0
    regression_blocks: int = 0
    lorenzo_percent: float = 0.0
    regression_percent: float = 0.0
    quantization_intervals: int = 0
    unpredict_count: int = 0
    unpredict_percent: float = 0.0
    huffman_tree_size: int = 0
    huffman_coding_size: int = 0
    huffman_node_count: int = 0
    huffman_avg_bits: float = 0.0

    @property
    def compression_ratio(self) -> float:
        return (self.original_size / self.compressed_size
                if self.compressed_size else 0.0)

    def report(self) -> str:
        lines = [
            f"original size: {self.original_size}",
            f"compressed size: {self.compressed_size}",
            f"compression ratio: {self.compression_ratio:.3f}",
            f"use mean: {int(self.use_mean)}",
            f"block size: {self.block_size}",
            f"lorenzo blocks: {self.lorenzo_blocks} "
            f"({self.lorenzo_percent:.3%})",
            f"regression blocks: {self.regression_blocks} "
            f"({self.regression_percent:.3%})",
            f"quantization intervals: {self.quantization_intervals}",
            f"unpredictable count: {self.unpredict_count} "
            f"({self.unpredict_percent:.3%})",
            f"huffman tree size: {self.huffman_tree_size}",
            f"huffman coding size: {self.huffman_coding_size}",
            f"huffman node count: {self.huffman_node_count}",
            f"huffman avg bits: {self.huffman_avg_bits:.3f}",
        ]
        return "\n".join(lines)


def current() -> "SZStats | None":
    return getattr(_tls, "slot", None)


@contextlib.contextmanager
def collect():
    """Collect stats from compressions inside the block."""
    s = SZStats()
    prev = getattr(_tls, "slot", None)
    _tls.slot = s
    try:
        yield s
    finally:
        _tls.slot = prev


def record(**kw) -> None:
    """Called from the codecs; no-op unless a collect() is active."""
    s = current()
    if s is None:
        return
    for k, v in kw.items():
        setattr(s, k, v)
