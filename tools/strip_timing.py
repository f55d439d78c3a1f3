#!/usr/bin/env python3
"""The strip and temporal kernels timed on one card, for comparing two
trees in one machine: K10/K11 (the classic codec's recurrence) at the
main path's five shapes, K1d/K2d (the float64 Lorenzo recurrence) at
256^3, 1800x3600 and 512^3, K14/K15 (the temporal step and restore)
at 100x500x500 and 2^24 float32 and 2^24 and 1800x3600 float64, and
K16/K17 (the integer codecs' recurrence) at 512^3 int32 under ABS 4 and
ABS 2.5, 1800x3600 int16 and 8x64x64x64 int32 under ABS 4.

Usage, from the repo root, alternating the trees in one call:

    python tools/strip_timing.py --root build/parent [--kernels temporal]
    python tools/strip_timing.py --root . [--kernels temporal]

(``chip_smoke.py --parent build/parent`` runs it so, parent, this, this,
parent.)  ``--root`` is a checkout holding ``sz_tpu_torch`` and
``chip_smoke.py`` (a ``git archive`` of another commit, unpacked under
``build/``); the fields and the timing are that checkout's own
(chip_smoke.classic_field, k1_inputs, k2_inputs, ts_step, ts_params,
cuda_ms), so both trees time the same inputs the same way.
``--kernels`` picks among classic, lorenzo64, temporal and int (default:
all).
Each kernel is called as that tree's main path calls it: K10 with no
reconstruction where the wrapper has ``want_R`` (also timed with it),
K11 on the compact escapes and the row bases where it takes them, else
on a full-size ``known``; K1d without R (also timed with it), K2d on the
inputs a decoder derives from K1d's types; K14 on step 1 of
chip_smoke.ts_step against step 0, K15 on K14's types and escapes, each
timed through its wrapper and as bare launches (the C entry point on
outputs and scratch allocated once); K16 and K17 as the integer main
path calls them (chip_smoke.int_field, its intervals at sample distance
100, K17 on the compact escapes and row bases), through the wrappers
and as bare launches (outputs and scratch allocated once, the claim
flags zeroed before each launch).  Prints one JSON line with the
card's name and power limit; exits 1 without a card.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys

import numpy as np

# (case, shape, dtype, rp, seed, noise): chip_smoke's timed K10/K11 cases
CLASSIC_CASES = [
    ("main_path_256", (256, 256, 256), np.float32, 1e-3, 42, 0.1),
    ("main_path_cesm_atm", (1800, 3600), np.float32, 1e-3, 6, 0.1),
    ("main_path_f64_256", (256, 256, 256), np.float64, 1e-3, 42, 0.1),
    ("full_size_4d", (8, 128, 256, 256), np.float32, 1e-3, 20, 0.1),
    ("full_size_512", (512, 512, 512), np.float32, 1e-3, 42, 0.1),
]
# K1d/K2d: chip_smoke.LORENZO_TIMED_F64, its inputs with the mean flush
LORENZO64_SHAPES = [(256, 256, 256), (1800, 3600), (512, 512, 512)]
# K14/K15: (case, chip_smoke field maker, shape, seed), the chain's two
# variables (chip_smoke.TS_VARS) and phase 2's 2^24 in both dtypes
TEMPORAL_CASES = [("ts_hurricane_100x500x500", "field", (100, 500, 500), 5),
                  ("ts_2^24", "field", (256, 256, 256), 42),
                  ("ts_2^24_f64", "field64", (256, 256, 256), 42),
                  ("ts_cesm_atm64_1800x3600", "field64", (1800, 3600), 6)]
# K16/K17: (case, shape, dtype, seed, rp), the integer main path's fields
INT_CASES = [("int_512_abs4", (512, 512, 512), np.int32, 42, 4.0),
             ("int_512_abs2.5", (512, 512, 512), np.int32, 42, 2.5),
             ("int16_1800x3600_abs4", (1800, 3600), np.int16, 6, 4.0),
             ("int_4d_8x64x64x64_abs4", (8, 64, 64, 64), np.int32, 20, 4.0)]
KINDS = ("classic", "lorenzo64", "temporal", "int")


def lorenzo64_rows(cs, dev, reps: int) -> list:
    """K1d and K2d of the tree chip_smoke ``cs`` belongs to, as its main
    path calls them."""
    import torch
    from sz_tpu_torch.gpu import lorenzo_kernel as lk
    rows = []
    for shape in LORENZO64_SHAPES:
        args = cs.k1_inputs(shape, 1, dev, "mixed", np.float64)
        scal = cs.k1_scalars(np.float64)
        t = lk.wavefront_quantize_f64(*args, *scal, use_mean=True)
        dec = cs.k2_inputs(args, t, True)
        rows.append(dict(
            case=f"lorenzo64_{'x'.join(map(str, shape))}", shape=list(shape),
            wavefront_quantize_f64_ms=cs.cuda_ms(
                lambda: lk.wavefront_quantize_f64(*args, *scal,
                                                  use_mean=True), reps),
            wavefront_quantize_f64_with_R_ms=cs.cuda_ms(
                lambda: lk.wavefront_quantize_f64(*args, *scal,
                                                  use_mean=True,
                                                  want_R=True), reps),
            wavefront_decode_f64_ms=cs.cuda_ms(
                lambda: lk.wavefront_decode_f64(*dec), reps)))
        del args, dec, t
        torch.cuda.empty_cache()
    return rows


def bare_temporal(tk, cur, prev, qa, types, dvals) -> tuple:
    """K14's and K15's C entry points with their outputs and scratch
    allocated once: (quantize, decode) callables.  A tree whose wrappers
    have no _quantize_launch has the one-launch form, whose C entry
    points take a look-back scratch (its _desc) and zero it."""
    import torch
    from sz_tpu_torch.gpu import _build
    rp, intervals, radius, req, med = qa
    if hasattr(tk, "_quantize_launch"):
        q_outs = tk._quantize_outputs(cur, prev)
        d_outs = tk._decode_outputs(types, prev)
        return (lambda: tk._quantize_launch(cur, prev, *qa, q_outs),
                lambda: tk._decode_launch(types, prev, dvals, radius, 2 * rp,
                                          d_outs))
    n, dev, T = cur.numel(), cur.device, cur.dtype
    f64 = T == torch.float64
    lib = _build.lib()
    t = torch.empty(n, dtype=torch.int32, device=dev)
    rec, vals, out = (torch.empty_like(cur) for _ in range(3))
    count = torch.empty((), dtype=torch.int64, device=dev)
    desc = tk._desc(n, dev)
    p = tk._p
    q_args = (p(cur), p(prev), n, rp, (int(intervals) - 1) * rp, 2 * rp,
              int(radius), tk.esc_mask(T, req),
              float(np.float64(med) if f64 else np.float32(med)), p(t),
              p(rec), p(vals), p(count), p(desc), tk._stream(cur))
    d_args = (p(types), p(prev), n, p(dvals), dvals.numel(), int(radius),
              2 * rp, p(out), p(count), p(desc), tk._stream(cur))
    qf = lib.sz_ts_quantize_f64 if f64 else lib.sz_ts_quantize
    df = lib.sz_ts_decode_f64 if f64 else lib.sz_ts_decode
    return (lambda: _build.check(qf(*q_args), "ts_quantize"),
            lambda: _build.check(df(*d_args), "ts_decode"))


def temporal_rows(cs, dev) -> list:
    """K14 and K15 of the tree chip_smoke ``cs`` belongs to, through their
    wrappers and as bare launches, cs.TS_REPS launches each."""
    import torch
    from sz_tpu_torch.gpu import temporal_kernel as tk
    rows = []
    for case, maker, shape, seed in TEMPORAL_CASES:
        x0 = getattr(cs, maker)(shape, seed)
        cur, prev = (torch.from_numpy(cs.ts_step(x0, s, seed).reshape(-1))
                     .to(dev) for s in (1, 0))
        del x0
        qa = (cs.ABS, *cs.ts_params(cur, prev, cs.ABS, {}))
        types, recon, _, count = tk.ts_quantize(cur, prev, *qa)
        dvals = recon[types == 0]
        q_bare, d_bare = bare_temporal(tk, cur, prev, qa, types, dvals)
        n, es, e = cur.numel(), cur.element_size(), int(count)
        reps = cs.TS_REPS
        rows.append(dict(
            case=case, shape=list(shape),
            dtype=str(cur.dtype).removeprefix("torch."), escapes=e,
            ts_quantize_ms=cs.cuda_ms(lambda: tk.ts_quantize(cur, prev, *qa),
                                      reps),
            ts_quantize_bare_ms=cs.cuda_ms(q_bare, reps),
            ts_decode_ms=cs.cuda_ms(
                lambda: tk.ts_decode(types, prev, dvals, qa[2], 2 * cs.ABS),
                reps),
            ts_decode_bare_ms=cs.cuda_ms(d_bare, reps),
            ts_quantize_bound_ms=cs.bound(n * (3 * es + 4) + e * es)[0],
            ts_decode_bound_ms=cs.bound(n * (2 * es + 4) + e * es)[0]))
        del cur, prev, types, recon, dvals, q_bare, d_bare
        torch.cuda.empty_cache()
    return rows


def bare_int(ik, xt, dt, rp: float, iv: int, quirk: bool, t, esc, rb,
             o) -> tuple:
    """K16's and K17's C entry points on outputs and scratch allocated
    once, the flags zeroed before each launch: (quantize, decode)
    callables, checked once against the wrappers' types ``t`` and decode
    ``o``.  A tree whose int_kernel has no quantize_form has the
    first form (int64 rings; an and dn bits in place of the forms)."""
    import ctypes
    import torch
    from sz_tpu_torch.gpu import _build, strips
    lib, dev = _build.lib(), xt.device
    lat = strips.lattice(xt.shape)
    types = torch.empty_like(t)
    out = torch.empty_like(xt)
    esize, sgn, radius = dt.itemsize, int(dt.kind == "i"), iv // 2
    stream = torch.cuda.current_stream(dev).cuda_stream

    def p(a):
        return ctypes.c_void_p(a.data_ptr())

    if hasattr(ik, "quantize_form"):
        f = ik.quantize_form(dt, rp, iv)
        arith, i2 = ik.decode_form(dt, 2 * rp)
        q_ring = torch.int32 if ik.QUANT_FORMS[f.ring][0] == 4 else \
            torch.int64
        d_ring = torch.int64 if esize == 8 else torch.int32
        q_sa, q_keep = strips.strip_args(lat, ik.WARPS, q_ring, dev)
        d_sa, d_keep = strips.strip_args(lat, ik.WARPS, d_ring, dev)
        q_args = (p(xt), p(types), *lat, esize, sgn,
                  list(ik.QUANT_FORMS).index(f.ring), ik.ARITH[f.arith],
                  *f.consts, iv, radius, int(quirk), *q_sa, stream)
        d_args = (p(t), p(esc), esc.numel(), p(rb), p(out), *lat, esize,
                  sgn, 2 * rp, ik.ARITH[arith], i2, radius, *d_sa, stream)
    else:
        an, dn = ik.FORMS[dt]
        q_sa, q_keep = strips.strip_args(lat, ik.WARPS, torch.int64, dev)
        d_sa, d_keep = strips.strip_args(lat, ik.WARPS, torch.int64, dev)
        q_args = (p(xt), p(types), *lat, esize, sgn, an, dn, rp, iv, radius,
                  int(quirk), *q_sa, stream)
        d_args = (p(t), p(esc), esc.numel(), p(rb), p(out), *lat, esize,
                  sgn, 2 * rp, radius, *d_sa, stream)

    def quantize():
        q_keep[1].zero_()
        _build.check(lib.sz_int_quantize(*q_args), "int_quantize")

    def decode():
        d_keep[1].zero_()
        _build.check(lib.sz_int_decode(*d_args), "int_decode")

    quantize()
    decode()
    if not (torch.equal(types, t) and torch.equal(out, o)):
        raise AssertionError("bare K16/K17 launches differ from the "
                             "wrappers'")
    return quantize, decode, (q_keep, d_keep, types, out)


def int_rows(cs, dev, reps: int) -> list:
    """K16 and K17 of the tree chip_smoke ``cs`` belongs to, through their
    wrappers and as bare launches, ``reps`` launches each."""
    import torch
    from sz_tpu_torch.gpu import int_kernel as ik
    rows = []
    for case, shape, dtype, seed, rp in INT_CASES:
        dt = np.dtype(dtype)
        x = cs.int_field(shape, seed, dt)
        xt = ik.to_carrier(x, dev)
        del x
        iv = cs.int_params(xt, dt, rp, 100)
        quirk = len(shape) == 4
        t = ik.int_quantize(xt, dt, rp, iv, iv // 2, quirk)
        esc = cs.int_escapes(xt, t, dt)
        rb = ik.escape_row_base(t)[0]
        o = ik.int_decode(t, esc, dt, 2 * rp, iv // 2, row_base=rb)
        q_bare, d_bare, keep = bare_int(ik, xt, dt, rp, iv, quirk, t, esc,
                                        rb, o)
        form = {}
        if hasattr(ik, "quantize_form"):
            f = ik.quantize_form(dt, rp, iv)
            form = dict(quantize_form=f"{f.ring}/{f.arith}",
                        decode_form=ik.decode_form(dt, 2 * rp)[0])
        rows.append(dict(
            case=case, shape=list(shape), dtype=dt.name, rp=rp,
            intervals=iv, escapes=int(esc.numel()), **form,
            int_quantize_ms=cs.cuda_ms(
                lambda: ik.int_quantize(xt, dt, rp, iv, iv // 2, quirk),
                reps),
            int_quantize_bare_ms=cs.cuda_ms(q_bare, reps),
            int_decode_ms=cs.cuda_ms(
                lambda: ik.int_decode(t, esc, dt, 2 * rp, iv // 2,
                                      row_base=rb), reps),
            int_decode_bare_ms=cs.cuda_ms(d_bare, reps),
            int_quantize_bound_ms=cs.bound(cs.nbytes(xt, t))[0],
            int_decode_bound_ms=cs.bound(cs.nbytes(t, esc, rb, xt))[0]))
        del xt, t, esc, rb, o, q_bare, d_bare, keep
        torch.cuda.empty_cache()
    return rows


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=".")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--kernels", default=",".join(KINDS),
                    help="a comma list of " + ", ".join(KINDS))
    args = ap.parse_args()
    kinds = args.kernels.split(",")
    if not set(kinds) <= set(KINDS):
        ap.error(f"--kernels: pick among {KINDS}")
    root = pathlib.Path(args.root).resolve()
    sys.path.insert(0, str(root))
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    import sz_tpu_torch
    from sz_tpu_torch.gpu import classic_kernel as ck
    if not pathlib.Path(sz_tpu_torch.__file__).resolve().is_relative_to(root):
        raise RuntimeError(f"sz_tpu_torch not imported from {root}")
    dev = torch.device("cuda", 0)
    rows = []
    for case, shape, dtype, rp, seed, noise in (
            CLASSIC_CASES if "classic" in kinds else []):
        x, p = cs.classic_field(shape, dtype, rp, seed, noise)
        xt = torch.from_numpy(x).to(dev)
        del x
        q = (p.rp, p.recip, p.intervals, p.radius, p.median, p.req_length)
        types, R = ck.classic_quantize(xt, *q)
        esc = R.reshape(-1)[types.reshape(-1) == 0]
        rb = ck.escape_row_base(types)[0]
        rows.append(dict(
            case=case, shape=list(shape),
            classic_quantize_ms=cs.cuda_ms(
                lambda: ck.classic_quantize(xt, *q, want_R=False), args.reps),
            classic_quantize_with_R_ms=cs.cuda_ms(
                lambda: ck.classic_quantize(xt, *q), args.reps),
            classic_decode_ms=cs.cuda_ms(
                lambda: ck.classic_decode(types, esc, p.rp, p.radius,
                                          row_base=rb), args.reps)))
        del xt, types, R, esc, rb
        torch.cuda.empty_cache()
    if "lorenzo64" in kinds:
        rows += lorenzo64_rows(cs, dev, args.reps)
    if "temporal" in kinds:
        rows += temporal_rows(cs, dev)
    if "int" in kinds:
        rows += int_rows(cs, dev, args.reps)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(json.dumps(dict(root=str(root), nvidia_smi=smi,
                          device=torch.cuda.get_device_name(0), rows=rows)),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
