#!/usr/bin/env python3
"""The strip kernels timed on one card, for comparing two trees in one
machine: K10/K11 (the classic codec's recurrence) at the main path's
five shapes, and K1d/K2d (the float64 Lorenzo recurrence) at 256^3,
1800x3600 and 512^3.

Usage, from the repo root, alternating the trees in one call:

    python tools/strip_timing.py --root build/parent
    python tools/strip_timing.py --root .

(``chip_smoke.py --parent build/parent`` runs it so, parent, this, this,
parent.)  ``--root`` is a checkout holding ``sz_tpu_torch`` and
``chip_smoke.py`` (a ``git archive`` of another commit, unpacked under
``build/``); the fields and the timing are that checkout's own
(chip_smoke.classic_field, k1_inputs, k2_inputs, cuda_ms), so both trees
time the same inputs the same way.  Each kernel is called as that tree's
main path calls it: K10 with no reconstruction where the wrapper has
``want_R`` (also timed with it), K11 on the compact escapes and the row
bases where it takes them, else on a full-size ``known``; K1d without R
(also timed with it), K2d on the inputs a decoder derives from K1d's
types.  Prints one JSON line with the card's name and power limit; exits
1 without a card.
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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=".")
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args()
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
    for case, shape, dtype, rp, seed, noise in CLASSIC_CASES:
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
    rows += lorenzo64_rows(cs, dev, args.reps)
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
