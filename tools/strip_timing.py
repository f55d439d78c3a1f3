#!/usr/bin/env python3
"""The strip and temporal kernels timed on one card, for comparing two
trees in one machine: K10/K11 (the classic codec's recurrence) at the
main path's five shapes, K1d/K2d (the float64 Lorenzo recurrence) at
256^3, 1800x3600 and 512^3, and K14/K15 (the temporal step and restore)
at 100x500x500 and 2^24 float32 and 2^24 and 1800x3600 float64.

Usage, from the repo root, alternating the trees in one call:

    python tools/strip_timing.py --root build/parent [--kernels temporal]
    python tools/strip_timing.py --root . [--kernels temporal]

(``chip_smoke.py --parent build/parent`` runs it so, parent, this, this,
parent.)  ``--root`` is a checkout holding ``sz_tpu_torch`` and
``chip_smoke.py`` (a ``git archive`` of another commit, unpacked under
``build/``); the fields and the timing are that checkout's own
(chip_smoke.classic_field, k1_inputs, k2_inputs, ts_step, ts_params,
cuda_ms), so both trees time the same inputs the same way.
``--kernels`` picks among classic, lorenzo64 and temporal (default: all).
Each kernel is called as that tree's main path calls it: K10 with no
reconstruction where the wrapper has ``want_R`` (also timed with it),
K11 on the compact escapes and the row bases where it takes them, else
on a full-size ``known``; K1d without R (also timed with it), K2d on the
inputs a decoder derives from K1d's types; K14 on step 1 of
chip_smoke.ts_step against step 0, K15 on K14's types and escapes, each
timed through its wrapper and as bare launches (the C entry point on
outputs and scratch allocated once).  Prints one JSON line with the
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
KINDS = ("classic", "lorenzo64", "temporal")


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
