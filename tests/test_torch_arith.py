"""The arithmetic coder (``sz_tpu_torch.format.arith``) against
``sz_tpu.format.arith``: the frequency table, the encoded bytes, the
padded table and the decode, on tests/test_arith.py's distributions and
past MAX_INTERVALS (the table of 2^20 + 17 symbols, scaled down; its
coder on their first 20000, as both coders walk a symbol at a time in
Python).  Equal bytes and symbols.
"""

import dataclasses

import numpy as np
import pytest
import torch
torch.set_num_threads(1)  # xdist workers share the cores: one thread each

from sz_tpu.format import arith as jarith

from sz_tpu_torch.format import arith as tarith


def _same_coder(a, b):
    da, db = dataclasses.asdict(a), dataclasses.asdict(b)
    assert da.keys() == db.keys()
    for k in da:
        np.testing.assert_array_equal(np.asarray(da[k]), np.asarray(db[k]))


@pytest.mark.parametrize("nstates,dist,size", [
    (256, [3, 7, 7, 7, 12, 12, 100, 255], 20000),
    (65536, [1, 2, 3, 40000, 65535], 20000),
    (32, list(range(32)), 20000),
    (8, [0, 1, 1, 2], (1 << 20) + 17),
    (16, [1, 2, 2, 3, 3, 3, 1, 2, 3, 1], 200),
])
def test_arith_matches(nstates, dist, size):
    s = np.random.default_rng(5).choice(np.array(dist), size=size).astype(
        np.int32)
    jc, tc = jarith.create(nstates, s), tarith.create(nstates, s)
    _same_coder(tc, jc)
    s = s[:20000]
    enc = tarith.encode(tc, s)
    assert enc == jarith.encode(jc, s)
    assert tarith.pad(tc) == jarith.pad(jc)
    c2, used = tarith.unpad(tarith.pad(tc))
    assert used == jarith.unpad(jarith.pad(jc))[1]
    np.testing.assert_array_equal(tarith.decode(c2, enc, len(s)), s)
    np.testing.assert_array_equal(tarith.decode(tc, enc, len(s)),
                                  jarith.decode(jc, enc, len(s)))
