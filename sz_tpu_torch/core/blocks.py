"""Block decomposition geometry (sz.h:93-123 macros).

A dimension of length ``r`` is cut into ``num = max(r // 6, 1)`` blocks;
the first ``r % num`` blocks get one extra element ("early" blocks).
"""

from __future__ import annotations

import dataclasses

import numpy as np

BLOCK_SIZE = 6


@dataclasses.dataclass(frozen=True)
class DimBlocks:
    r: int
    num: int
    split: int  # blocks [0, split) are "early"
    early: int  # early block length
    late: int  # late block length

    def start(self, i: int) -> int:
        if i < self.split:
            return i * self.early
        return i * self.late + self.split

    def count(self, i: int) -> int:
        return self.early if i < self.split else self.late

    def starts(self) -> np.ndarray:
        idx = np.arange(self.num)
        return np.where(idx < self.split, idx * self.early,
                        idx * self.late + self.split)

    def counts(self) -> np.ndarray:
        idx = np.arange(self.num)
        return np.where(idx < self.split, self.early, self.late)


def dim_blocks(r: int, block_size: int = BLOCK_SIZE) -> DimBlocks:
    num = 1 if r <= block_size else r // block_size
    early = late = r // num
    split = r % num
    if split:
        early += 1
    return DimBlocks(r=r, num=num, split=split, early=early, late=late)
