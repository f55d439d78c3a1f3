"""K16/K17's arithmetic forms (csrc/intc.cu's note) held to the plain
versions' double arithmetic on the CPU: the wrapper's choice of ring form
and arithmetic form for each dtype and rp; Python models of the kernels'
integer form (uint32 arithmetic, a multiply-high by the host's magic
number), K16's reciprocal form (float64 steps in the kernel's order, the
exact chain on the lanes near a boundary) and K17's integer form, each
held equal to ``int_kernel._quantize_plain`` or the decode step on every
boundary the note names and on a seeded sweep; the 32-bit ring of 8-
and 16-bit data (AN = DN = 32) equal to their own forms where the wrapper
picks it; and each kernel's shared bytes allowing the blocks an
SM its __launch_bounds__ asks.  Tolerance: exact.
"""

import math

import numpy as np
import pytest
import torch
torch.set_num_threads(1)  # xdist workers share the cores: one thread each

from sz_tpu_torch.gpu import int_kernel as ik

from _chip_smoke import SMOKE

M32, M64 = (1 << 32) - 1, (1 << 64) - 1
SWEEP = 300   # draws of each seeded sweep
# an H100 SM's shared memory for blocks and what each block reserves, and
# its resident blocks at 4 warps (2048 threads an SM)
SM_SHARED, BLOCK_RESERVED, MAX_BLOCKS = 233472, 1024, 16


def _signed(v: int, bits: int) -> int:
    v &= (1 << bits) - 1
    return v - (1 << bits) if v >> (bits - 1) else v


def _x86_ll(v: float) -> int:
    return int(v) if -2.0 ** 63 <= v < 2.0 ** 63 else -2 ** 63


def _x86_i(v: float) -> int:
    return int(v) if -2147483649.0 < v < 2147483648.0 else -2 ** 31


def _plain(cur, pred, rp, intervals, radius, an, dn):
    """``_quantize_plain`` on lists of ints: (types, values, in range)."""
    t, rec, within = ik._quantize_plain(
        torch.tensor(cur, dtype=torch.int64),
        torch.tensor(pred, dtype=torch.int64), float(rp), intervals,
        radius, an, dn)
    return t.tolist(), rec.tolist(), within.tolist()


def model_integer(cur: int, pred: int, consts, radius: int):
    """intc.cu iquant_int: (type, value, in range) in uint32."""
    magic, p, thr = consts[6:9]
    diff = (cur - pred) & M32
    neg = diff >> 31
    ad = (-diff) & M32 if neg else diff
    assert ad + p <= M32
    q = ((ad + p) * magic) >> 64
    m = (q * 2 * p) & M32
    rec = _signed((pred - m) if neg else (pred + m), 32)
    t = _signed((radius - q) if neg else (radius + q), 32)
    return t, rec, ad < thr


def model_recip(cur: int, pred: int, consts, intervals: int, radius: int,
                an: int, dn: int):
    """intc.cu iquant_dbl<kRecip>: (type, value, in range, exact chain
    taken), each double step in the kernel's order."""
    rp, rcp_h, rp2, lo, hi, tol = consts[:6]
    diff = _signed(cur - pred, dn)
    ad = _signed(-diff, 64) if diff < 0 else diff   # |INT64_MIN| < 0
    add, pd = float(ad), float(pred)
    z = add * rcp_h + 0.5
    qd = float(math.trunc(z)) if math.isfinite(z) else z
    sq = -qd if diff < 0 else qd
    inr = z < lo
    v = pd + sq * rp2
    exact = not (z > hi or (inr and z - qd > tol and (qd + 1.0) - z > tol))
    if exact:
        itv = add / rp + 1.0
        inr = itv < intervals
        if diff < 0:
            itv = -itv
        t = _signed(_x86_i(itv * 0.5) + radius, 32)
        v = pd + (2.0 * float(_signed(t - radius, 32))) * rp
    else:
        t = int(sq) + radius
    return t, _signed(_x86_ll(v), an), inr, exact


def _check_steps(model, cur, pred, rp, intervals, radius, an, dn, *extra):
    """The model against the plain step on lists; returns its results."""
    t_p, rec_p, in_p = _plain(cur, pred, rp, intervals, radius, an, dn)
    got = [model(c, p, *extra) for c, p in zip(cur, pred)]
    for n, g in enumerate(got):
        assert g[2] == in_p[n], (cur[n], pred[n], g, in_p[n])
        if in_p[n]:
            assert g[:2] == (t_p[n], rec_p[n]), (cur[n], pred[n], g,
                                                 t_p[n], rec_p[n])
    return got


# --- the wrapper's choice ------------------------------------------------

@pytest.mark.parametrize("dtype,rp,intervals,want", [
    (np.int32, 4.0, 65536, ("r32", "integer")),
    (np.int32, 1.0, 2 ** 31 - 1, ("r32", "integer")),
    (np.int32, 2.0 ** 21, 2 ** 31 - 1, ("r32", "exact")),  # P I > 2^51
    (np.int32, 2.0 ** 19, 2 ** 31 - 1, ("r32", "integer")),
    (np.int32, 2.0 ** 31 - 1, 1024, ("r32", "integer")),
    (np.int32, 2.0 ** 31, 1024, ("r32", "exact")),
    (np.int32, 2.5, 65536, ("r32", "recip")),
    (np.int32, 0.5, 1, ("r32", "exact")),              # intervals < 2
    (np.int32, 2.0 ** -1001, 64, ("r32", "exact")),
    (np.int32, float("nan"), 64, ("r32", "exact")),
    (np.int32, float("inf"), 64, ("r32", "exact")),
    (np.int32, 0.0, 64, ("r32", "exact")),
    (np.int8, 4.0, 64, ("r32", "integer")),
    (np.uint8, 0.3, 64, ("r32", "recip")),
    (np.int16, 2.0 ** 28, 64, ("r32", "integer")),
    (np.uint16, 2.0 ** 29, 64, ("small", "exact")),
    (np.int16, 2.0 ** 29 + 0.5, 64, ("small", "recip")),
    (np.int8, 2.0 ** 28, 64, ("r32", "integer")),
    (np.int16, 0.0, 64, ("small", "exact")),
    (np.uint32, 4.0, 512, ("u32", "exact")),
    (np.uint32, 2.5, 512, ("u32", "recip")),
    (np.uint32, 1.0, 2 ** 31 - 1, ("u32", "exact")),
    (np.uint8, 2.0 ** 28 + 0.5, 64, ("r32", "recip")),
    (np.int64, 4.0, 512, ("i64", "exact")),
    (np.int64, 0.3, 512, ("i64", "recip")),
    (np.uint64, 2.0 ** 40, 512, ("i64", "exact")),
])
def test_quantize_form_by_dtype_and_rp(dtype, rp, intervals, want):
    f = ik.quantize_form(dtype, rp, intervals)
    assert (f.ring, f.arith) == want
    assert len(f.consts) == 9
    if f.arith == "integer":
        p = int(rp)
        assert f.consts[6:9] == ((1 << 64) // (2 * p) + 1, p,
                                 min((intervals - 1) * p, M32))
    if f.arith == "recip":
        assert f.consts[1] == (1.0 / rp) / 2 and f.consts[2] == 2 * rp
        assert f.consts[5] == intervals * 2.0 ** -49
        assert f.consts[3] < intervals / 2 < f.consts[4]


def test_ring_form_at_the_range_limit():
    """8 M0 + 7 rp + 28 < 2^31 takes the 32-bit ring, one more does not
    (M0 the type's largest |value|); uint32 never takes it."""
    for dt, m0 in ((np.uint16, 65535), (np.int16, 32768), (np.int8, 128)):
        assert ik.value_bound(dt) == m0
        rp = (2 ** 31 - 28 - 8 * m0) / 7
        assert ik.ring_form(dt, math.nextafter(rp, 0)) == "r32"
        assert ik.ring_form(dt, rp) == "small"
    for rp in (2.0 ** -20, 1.0, 4.0, 2.5):
        assert ik.ring_form(np.uint32, rp) == "u32"


@pytest.mark.parametrize("dtype,i2,want", [
    (np.int32, 8.0, ("integer", 8)), (np.uint32, 5.0, ("integer", 5)),
    (np.int8, 2.0 ** 20, ("integer", 2 ** 20)),
    (np.int16, -(2.0 ** 20), ("integer", -2 ** 20)),
    (np.uint16, 2.0 ** 20 + 1, ("exact", 0)), (np.int32, 0.6, ("exact", 0)),
    (np.int32, 0.0, ("integer", 0)), (np.int64, 8.0, ("exact", 0)),
    (np.uint64, 8.0, ("exact", 0)), (np.int32, float("nan"), ("exact", 0)),
])
def test_decode_form_by_dtype_and_interval2(dtype, i2, want):
    assert ik.decode_form(dtype, i2) == want


# --- K16's integer form ---------------------------------------------------

def _integer_boundaries(p: int, intervals: int) -> list:
    """|diff| on and next to every boundary the note names: (2m - 1) P
    for the first and the last m in range, (intervals - 1) P, 2^31, 0."""
    ads = {0, 1, 2 ** 31, 2 ** 31 - 1}
    top = (intervals - 1) * p
    for m in list(range(1, 6)) + list(range(max(1, intervals // 2 - 4),
                                            intervals // 2 + 2)):
        ads |= {(2 * m - 1) * p + d for d in (-1, 0, 1)}
    ads |= {top + d for d in (-2, -1, 0, 1)}
    return sorted(a for a in ads if 0 <= a <= 2 ** 31)


@pytest.mark.parametrize("p,intervals", [
    (1, 65536), (1, 2), (4, 65536), (3, 1024), (4, 2 ** 31 - 1 >> 13),
    (2 ** 19, 2 ** 31 - 1), (2 ** 31 - 1, 1024), (1000, 32), (7, 5)])
def test_integer_form_equals_plain_on_its_boundaries(p, intervals):
    consts = ik.quantize_form(np.int32, float(p), intervals).consts
    assert ik.quantize_form(np.int32, float(p), intervals).arith == \
        "integer"
    radius = intervals // 2
    cur, pred = [], []
    for ad in _integer_boundaries(p, intervals):
        for base in (0, 123456789, -2 ** 31, 2 ** 31 - 1, -5):
            for sign in (1, -1):
                c = _signed(base + sign * ad, 32)
                cur.append(c)
                pred.append(base)
    _check_steps(model_integer, cur, pred, float(p), intervals, radius, 32,
                 32, consts, radius)


def test_integer_form_equals_plain_on_a_sweep():
    """Seeded draws of (cur, pred, P, intervals), P small or anywhere
    below 2^31, each with |diff| moved next to its nearest q boundary."""
    rng = np.random.default_rng(19)
    reached = 0
    for n in range(SWEEP):
        cur, pred = (int(v) for v in rng.integers(-2 ** 31, 2 ** 31, 2))
        p = int(rng.integers(1, 17 if n % 2 else 2 ** 31))
        intervals = int(rng.integers(2, 2 ** 31))
        f = ik.quantize_form(np.int32, float(p), intervals)
        if f.arith != "integer":
            assert p * intervals >= 2 ** 51
            continue
        reached += 1
        radius = intervals // 2
        ad = abs(cur - pred) % (2 * p)
        near = _signed(pred + (cur - pred) - ad + p, 32)
        _check_steps(model_integer, [cur, near], [pred, pred], float(p),
                     intervals, radius, 32, 32, f.consts, radius)
    assert reached > SWEEP // 3


# --- K16's reciprocal form ------------------------------------------------

def _recip_boundaries(rp: float, intervals: int, top: int) -> list:
    """|diff| around (2m - 1) rp (a q boundary of itv) and (intervals -
    1) rp (the range's end), the floors and ceilings +- 1, and 0, 1."""
    ads = {0, 1, 2, 3}
    ms = list(range(1, 40)) + list(range(max(1, intervals // 2 - 3),
                                         intervals // 2 + 2))
    for x in [(2 * m - 1) * rp for m in ms] + [(intervals - 1) * rp]:
        for base in (math.floor(x), math.ceil(x)):
            ads |= {base + d for d in (-1, 0, 1)}
    return sorted(a for a in ads if 0 <= a <= top)


@pytest.mark.parametrize("rp", [2.5, 0.3, 0.1, 1.5, 3.7, 1e-3, 123.456,
                                1.0 + 2.0 ** -45, 0.75, 2.0 ** 20 + 0.5])
@pytest.mark.parametrize("form", ["r32", "small", "u32", "i64"])
def test_recip_form_equals_plain_on_its_boundaries(rp, form):
    """Every form's reciprocal form, |diff| at and next to each boundary,
    int32 values for r32 and small, larger ones for u32 and i64 (a
    difference of 2^63 too); rp = 1 + 2^-45 sends the small odd |diff| to
    the exact chain, the others almost none."""
    an, dn = {"r32": (32, 32), "small": (64, 32), "u32": (64, 64),
              "i64": (64, 64)}[form]
    intervals = 65536
    consts = ik.quantize_form(np.int64, rp, intervals).consts
    top = 2 ** 31 if dn == 32 else 2 ** 62
    cur, pred = [], []
    bases = (0, 777, -2 ** 31) if dn == 32 else (0, -2 ** 40, 2 ** 62)
    for ad in _recip_boundaries(rp, intervals, top):
        for base in bases:
            for sign in (1, -1):
                cur.append(_signed(base + sign * ad, an))
                pred.append(base)
    if dn == 64:
        cur += [2 ** 62, -2 ** 62, 2 ** 63 - 1]
        pred += [-2 ** 62, 2 ** 62, -1]
    got = _check_steps(model_recip, cur, pred, rp, intervals, intervals // 2,
                       an, dn, consts, intervals, intervals // 2, an, dn)
    exact = sum(g[3] for g in got)
    if rp == 1.0 + 2.0 ** -45:
        assert exact > 50
    elif dn == 32:
        assert exact <= 0.05 * len(got)


def test_recip_form_equals_plain_on_a_sweep():
    """Seeded draws of (cur, pred, rp, intervals), rp log-uniform over
    [1e-6, 1e6] and not an integer, each with |diff| also at the floor
    and ceiling of the nearest (2m - 1) rp."""
    rng = np.random.default_rng(23)
    for _ in range(SWEEP):
        cur, pred = (int(v) for v in rng.integers(-2 ** 31, 2 ** 31, 2))
        rp = float(10.0 ** rng.uniform(-6, 6))
        if rp.is_integer():
            continue
        intervals = int(rng.integers(2, 2 ** 20 + 1))
        f = ik.quantize_form(np.int32, rp, intervals)
        assert f.arith == "recip"
        radius = intervals // 2
        x = (2 * round(abs(cur - pred) / rp / 2) + 1) * rp
        near = [_signed(pred + int(math.floor(x)), 32),
                _signed(pred + int(math.ceil(x)), 32)]
        _check_steps(model_recip, [cur] + near, [pred] * 3, rp, intervals,
                     radius, 32, 32, f.consts, intervals, radius, 32, 32)


# --- K17's integer form ---------------------------------------------------

def model_decode_integer(pred: int, t: int, radius: int, i2: int,
                         bits: int, signed: bool) -> int:
    """intc.cu IntDecode's integer form: wrap(pred + (t - radius) I2) in
    uint32, then to the output type."""
    v = ((pred & M32) + ((t - radius) & M32) * (i2 & M32)) & M32
    v &= (1 << bits) - 1
    return _signed(v, bits) if signed else v


def _decode_plain(pred, t, radius, i2, bits, signed):
    val = torch.tensor(pred, dtype=torch.int64).to(torch.float64) + (
        torch.tensor(t, dtype=torch.int64) - radius).to(torch.float64) * \
        float(i2)
    return ik._wrap(ik._x86_ll(val), bits, signed).tolist()


@pytest.mark.parametrize("dtype", [np.int8, np.uint8, np.int16, np.uint16,
                                   np.int32, np.uint32])
def test_decode_integer_form_equals_plain_step(dtype):
    """pred: the int64 stencil of output values (|pred| < 7 * 2^32); t
    over int32 with the radius and I2 at their extremes."""
    dt = np.dtype(dtype)
    bits, signed = 8 * dt.itemsize, dt.kind == "i"
    rng = np.random.default_rng(7)
    lim = 7 * 2 ** 32
    pred = [int(v) for v in rng.integers(-lim, lim, 400)] + [
        lim - 1, -lim, 0, 2 ** 31, -2 ** 31 - 1, 2 ** 32 - 1]
    for radius, i2 in ((32768, 8), (2 ** 30, 2 ** 20), (0, -2 ** 20),
                       (5, 1), (1 << 15, 5), (7, 0)):
        assert ik.decode_form(dt, float(i2)) == ("integer", i2)
        t = [int(v) for v in rng.integers(-2 ** 31, 2 ** 31, len(pred))]
        t[:6] = [-2 ** 31, 2 ** 31 - 1, 0, 1, radius, radius - 1]
        want = _decode_plain(pred, t, radius, i2, bits, signed)
        got = [model_decode_integer(p, tt, radius, i2, bits, signed)
               for p, tt in zip(pred, t)]
        assert got == want


def test_decode_integer_form_on_a_sweep():
    """Seeded draws of (pred, t, radius, I2) for each output type of 32
    bits or less."""
    rng = np.random.default_rng(29)
    lim = 7 * 2 ** 32
    for n in range(SWEEP):
        dt = np.dtype([np.int8, np.uint8, np.int16, np.uint16, np.int32,
                       np.uint32][n % 6])
        bits, signed = 8 * dt.itemsize, dt.kind == "i"
        pred = int(rng.integers(-lim, lim))
        t = int(rng.integers(-2 ** 31, 2 ** 31))
        radius = int(rng.integers(0, 2 ** 30 + 1))
        i2 = int(rng.integers(-2 ** 20, 2 ** 20 + 1))
        assert [model_decode_integer(pred, t, radius, i2, bits, signed)] \
            == _decode_plain([pred], [t], radius, i2, bits, signed)


# --- the 32-bit ring of narrower and unsigned data -------------------------

@pytest.mark.parametrize("kind,shape,rp", [
    ("random_uint16", (9, 33, 20), 3.0e8),
    ("random_int16", (40, 33), 1.0e8 + 0.5),
    ("random_int8", (7, 33, 17), 2.0 ** 28),
    ("random_uint8", (2, 3, 33, 9), 0.3),
    ("random_uint16", (40, 33), 4.0),
    ("random_int8", (9, 33, 20), 0.3),
    ("random_int16", (6, 33, 20), 2.0 ** 20),
])
def test_r32_ring_equals_the_types_own_forms(kind, shape, rp, monkeypatch):
    """Where ring_form picks the 32-bit ring for 8- or 16-bit data (AN 64
    in the reference), the recurrence in AN = DN = 32 gives the same
    types and, through the escapes, the same decode."""
    x = SMOKE.int_trap_field(kind, shape, 3)
    dt = x.dtype
    intervals = 65536
    assert ik.quantize_form(dt, rp, intervals).ring == "r32"
    t = ik.to_carrier(x, "cpu")
    quirk = x.ndim == 4
    want = ik.int_quantize_plain(t, dt, rp, intervals, intervals // 2, quirk)
    monkeypatch.setitem(ik.FORMS, dt, (32, 32))
    got = ik.int_quantize_plain(t, dt, rp, intervals, intervals // 2, quirk)
    assert torch.equal(got, want)
    assert (want != 0).any() and (want == 0).any()


# --- blocks an SM ----------------------------------------------------------

def test_shared_bytes_allow_the_blocks_asked():
    """Each kernel's shared bytes leave room for the blocks an SM its
    __launch_bounds__ asks; the 32-bit forms for at least 3 (5 in 3-D),
    the int64 rings of 3-D for 2 or 3."""
    for name, (item, slot, rank, asks) in ik.kernels().items():
        b = ik.shared_bytes(item, slot, rank)
        fits = min(MAX_BLOCKS, SM_SHARED // (b + BLOCK_RESERVED))
        assert fits >= asks, (name, b, fits, asks)
        if item == 4:
            assert fits >= (5 if rank == 3 else 3), (name, b)
        elif rank == 3:
            assert fits >= 2, (name, b)
