"""K16/K17's plain versions and the integer optimizer's samples against
sz_tpu's host C on the CPU: ``int_quantize_plain``'s types, with the
escapes' bytes built from them, equal ``sz_tpu.native.intnd_encode``'s,
and ``int_decode_plain`` equals ``sz_tpu.native.intnd_decode``, on the
strips' edges (``chip_smoke.INT_EDGE_SHAPES``) in every dtype and on the
fields that reach the traps (``chip_smoke.int_trap_field``); the samples
gathered by index vectors give sz_tpu's intervals at ranks 1-4; the
wrappers take the plain versions for CPU tensors only; intc.cu's
constants and entry points are the ones the wrappers use.  Tolerance:
exact.
"""

import pathlib
import re

import numpy as np
import pytest
import torch
torch.set_num_threads(1)  # xdist workers share the cores: one thread each

from sz_tpu.core import intc as jintc
from sz_tpu.native import intnd_decode, intnd_encode

from sz_tpu_torch.core import intc
from sz_tpu_torch.gpu import _build, int_kernel as ik, strips

from _chip_smoke import SMOKE

ALL = (np.int8, np.uint8, np.int16, np.uint16, np.int32, np.uint32,
       np.int64, np.uint64)


def _host_encode(x: np.ndarray, rp: float, intervals: int):
    """sz_tpu's host C encode: (types, exact bytes)."""
    spec = jintc.SPECS[x.dtype]
    mn, vr = jintc.range_size_int(x.reshape(-1))
    types, exact, _ = intnd_encode(
        x, rp, intervals, intervals // 2, spec.arith_nd, spec.diff_nd, mn,
        jintc.byte_size_per_value(vr), spec.esize, x.ndim == 4)
    return types.reshape(x.shape), exact, mn, jintc.byte_size_per_value(vr)


def _check(x: np.ndarray, rp: float, intervals: int):
    """The plain encode and decode against the host C on one field."""
    dt = x.dtype
    t = ik.to_carrier(x, "cpu")
    types = ik.int_quantize(t, dt, rp, intervals, intervals // 2,
                            quirk4d=x.ndim == 4)
    want, exact, mn, bs = _host_encode(x, rp, intervals)
    np.testing.assert_array_equal(types.numpy(), want)
    # the escapes as the engine gathers them (the quirk cells escaped
    # store the first element), and their bytes
    esc = SMOKE.int_escapes(t, types, dt).numpy()
    assert intc.exact_bytes(esc, mn, bs, dt.itemsize) == exact
    vals = intc.exact_values(exact, len(esc), mn, bs, dt)
    out = ik.int_decode(types, torch.from_numpy(vals), dt, 2 * rp,
                        intervals // 2)
    got = out.numpy().view(dt)
    ref = intnd_decode(want, x.shape, 2 * rp, intervals // 2, dt, mn, bs,
                       dt.itemsize, exact)
    np.testing.assert_array_equal(got, ref.reshape(x.shape))
    return want


def _edge_cases():
    """Each edge shape in two dtypes, in turn by rank (as chip_smoke's
    phase 2), and the 3-D one of 31 rows in all eight."""
    turn, cases = {2: 0, 3: 0, 4: 0}, []
    for n, shape in enumerate(SMOKE.INT_EDGE_SHAPES):
        for m in range(2):
            dt = SMOKE.INT_EDGE_DTYPES[turn[len(shape)] % 6]
            turn[len(shape)] += 1
            cases.append((shape, np.dtype(dt), 300 + 7 * n + m))
    cases += [((7, 31, 40), np.dtype(dt), 5) for dt in ALL]
    return cases


@pytest.mark.parametrize("shape,dtype,seed", _edge_cases(),
                         ids=lambda v: "x".join(map(str, v))
                         if isinstance(v, tuple) else str(v))
def test_plain_versions_equal_host_c_on_the_edges(shape, dtype, seed):
    x = SMOKE.int_field(shape, seed, dtype)
    _check(x, 4.0, 128)


@pytest.mark.parametrize("kind,shape,rp,intervals", [
    ("wrap_int64", (40, 70), 4.0, 65536),
    ("wrap_int64", (6, 33, 40), 4.0, 64),
    ("near_max", (9, 40, 35), 1000.0, 32),
    ("near_max", (2, 5, 33, 17), 4.0, 2048),
    ("random_int8", (33, 70), 0.5, 1024),
    ("random_uint16", (5, 40, 33), 4.0, 65536),
    ("random_int32", (70, 33), 0.5, 65536),
    ("random_uint32", (5, 33, 20), 4.0, 65536),
    ("random_int64", (3, 4, 33, 17), 0.5, 65536),
    ("random_uint64", (40, 33), 2.0 ** 40, 65536),
], ids=lambda v: "x".join(map(str, v)) if isinstance(v, tuple) else str(v))
def test_plain_versions_equal_host_c_on_the_traps(kind, shape, rp,
                                                  intervals):
    """A difference of 2^63 gives a type below zero (INT32_MIN + radius,
    x86's (int) of a double out of range), reconstructions next to 2^63
    convert to INT64_MIN, random data wraps in DN bits: all as the host
    C."""
    types = _check(SMOKE.int_trap_field(kind, shape, 17), rp, intervals)
    if kind == "wrap_int64":
        assert (types == -2 ** 31 + intervals // 2).any()


@pytest.mark.parametrize("shape", [(500,), (40, 70), (33, 17), (6, 40, 35),
                                   (3, 7, 33, 17), (2, 2)],
                         ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("sd", [1, 5, 100])
def test_optimizer_samples_give_sz_tpus_intervals(shape, sd):
    """The sample gather (index vectors of the samples alone) and the
    histogram's finish give sz_tpu's intervals, whose gather builds
    meshgrids of the whole field; also on a field whose samples are
    none."""
    for dt, rp in ((np.int16, 4.0), (np.uint32, 0.5), (np.uint64, 8.0)):
        x = SMOKE.int_field(shape if len(shape) > 1 else (25, 20), 9, dt) \
            .reshape(shape)
        want = jintc._optimize_intervals(x, rp, 32768, sd,
                                         np.float32(0.99))
        perr = ik.optimizer_samples_int(ik.to_carrier(x, "cpu"), dt, sd)
        total = x.size // sd if x.ndim == 1 else perr.size
        assert intc.optimize_intervals(perr, total, rp, 32768,
                                       np.float32(0.99)) == want


def test_forms_and_widths_are_sz_tpus():
    """The encoder's AN and DN bits, the carriers and the widening."""
    for dt in ALL:
        spec = jintc.SPECS[np.dtype(dt)]
        an, dn = ik.FORMS[np.dtype(dt)]
        assert (an, dn) == (8 * np.dtype(spec.arith_nd).itemsize,
                            8 * np.dtype(spec.diff_nd).itemsize)
        assert np.dtype(intc.SPECS[np.dtype(dt)].arith_nd) == \
            np.dtype(spec.arith_nd)
        x = SMOKE.int_field((5, 6), 3, dt)
        c = ik.to_carrier(x, "cpu")
        assert c.dtype == ik.carrier(dt) and c.element_size() == x.itemsize
        assert np.array_equal(ik.widen(c, dt).numpy(), x.astype(np.int64))
        assert intc.range_size_int(c.reshape(-1), dt) == \
            jintc.range_size_int(x.reshape(-1))


def test_x86_conversions():
    """(int64_t)trunc and (int) of a double as x86 gives them: the type's
    minimum out of range and for NaN, truncation inside."""
    v = torch.tensor([3.7, -3.7, 2.0 ** 63, -2.0 ** 63, -2.0 ** 63 - 4096,
                      float("nan"), float("inf"), 2.0 ** 31, -2.0 ** 31 - 1,
                      -2.0 ** 31 - 0.5], dtype=torch.float64)
    assert ik._x86_ll(v).tolist() == [
        3, -3, -2 ** 63, -2 ** 63, -2 ** 63, -2 ** 63, -2 ** 63, 2 ** 31,
        -2 ** 31 - 1, -2 ** 31]
    assert ik._x86_int(v).tolist() == [
        3, -3] + [-2 ** 31] * 7 + [-2 ** 31]


def test_wrappers_route_cpu_to_plain_and_refuse_other_devices():
    x = SMOKE.int_field((9, 10), 2, np.int16)
    t = ik.to_carrier(x, "cpu")
    n = ik.int_quantize.launches
    assert torch.equal(ik.int_quantize(t, np.int16, 4.0, 64, 32),
                       ik.int_quantize_plain(t, np.int16, 4.0, 64, 32))
    assert ik.int_quantize.launches == n
    m = torch.empty((4, 5), dtype=torch.int16, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        ik.int_quantize(m, np.int16, 4.0, 64, 32)
    with pytest.raises(ValueError, match="cpu or cuda"):
        ik.int_decode(m.int(), torch.empty(3, dtype=torch.int64,
                                           device="meta"), np.int16, 8.0, 32)
    with pytest.raises(ValueError, match="travels as"):
        ik.int_quantize(t.int(), np.int16, 4.0, 64, 32)
    with pytest.raises(ValueError, match="rank-2, 3 or 4"):
        ik.int_quantize(t.reshape(-1), np.int16, 4.0, 64, 32)


def test_intc_cu_matches_its_wrappers():
    """intc.cu's warps a block, ring length by rank, forms and blocks an
    SM are int_kernel's, its entry points are bound with as many
    arguments as the wrappers pass, its __global__ names are chip_smoke's
    and int_kernel's, and each kernel's shared bytes are strips.cuh's of
    its rule's ring value and staged slot."""
    src = (pathlib.Path(ik.__file__).parent.parent / "csrc" /
           "intc.cu").read_text()
    assert '#include "strips.cuh"' in src
    assert int(re.search(r"constexpr int kWarps = (\d+);", src)[1]) == \
        ik.WARPS
    rings = re.findall(
        r"static constexpr int kRing = kRank == 3 \? (\d+) : (\d+);", src)
    assert set(rings) == {(str(ik.RING[3]), str(ik.RING[2]))}
    assert len(rings) == 2
    assert not re.search(r"static constexpr int kRing = \d+;", src)
    for name in ("sz_int_quantize", "sz_int_decode", "sz_int_kernel_info"):
        sig = re.search(r'extern "C" int ' + name + r"\(([^)]*)\)", src)[1]
        assert len(sig.split(",")) == len(_build.SIGNATURES[name])
    assert re.search(r"enum Arith \{ kExact = (\d), kRecip = (\d), "
                     r"kInteger = (\d) \};", src).groups() == tuple(
        str(ik.ARITH[k]) for k in ("exact", "recip", "integer"))
    # every kernel: its rule, its blocks an SM, in kernels()'s order
    mins = dict(re.findall(r"(kMin\w+) = (\d+)", src))
    rules = dict(re.findall(r"using (Q\w+) = (IntQuant<[^>]*>);", src))
    found = re.findall(r"__launch_bounds__\(kWarps \* 32, (kMin\w+)\)\s+"
                       r"(int_\w+_kernel)\(Geo<(\w+)> g, \w+ a\) \{\s+"
                       r"run_strips<([^;]*)>\(g, a\);", src)
    assert [f[1] for f in found] == list(ik.kernels())
    table = re.findall(r"\{\(const void\*\)\((int_\w+_kernel)\),\s+"
                       r"strips::shared_bytes<(\w+(?:<[^>]*>)?)>\(\)\}",
                       src)
    assert [k for k, _ in table] == list(ik.kernels())
    size = {"int": 4, "unsigned": 4, "i64": 8}
    for (mn, name, geo, rule), (_, rule2) in zip(found, table):
        item, slot, rank, asks = ik.kernels()[name]
        assert int(mins[mn]) == asks
        assert rules.get(rule, rule) == rules.get(rule2, rule2)
        args = re.search(r"<(\d), (.*)>", rules.get(rule, rule)).groups()
        rank_src, rest = int(args[0]), [a.strip() for a in
                                        args[1].split(",")]
        assert rank_src == rank and size[geo] == item
        if name.startswith("int_quantize"):
            form = name.split("_")[2]
            v, s, dn, *only = rest
            assert (size[v], size[s]) == (item, slot) == \
                ik.QUANT_FORMS[form.removesuffix("i")]
            assert int(dn) == (32 if form in ("r32i", "r32", "small")
                               else 64)
            assert only == (["true"] if form == "r32i" else [])
        else:
            nbytes = int(rest[0])
            assert item == (8 if nbytes == 8 else 4) and slot == 4
            assert name.split("_")[2] == str(8 * nbytes)
        ring = ik.RING[rank]
        assert ik.shared_bytes(item, slot, rank) == strips.shared_bytes(
            4, item, strips.LANES * (ring + 1) * slot, ring)
    # the sizes the note states for 3-D blocks
    assert ik.shared_bytes(4, 4, 3) == 38696
    assert ik.shared_bytes(8, 4, 3) == 60476
    assert ik.shared_bytes(8, 8, 3) == 77372
