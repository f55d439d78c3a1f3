#!/usr/bin/env python3
"""K10/K11 (the classic codec's recurrence) timed at the main path's five
shapes on one card, for comparing two trees in one machine.

Usage, from the repo root, alternating the trees in one call:

    python tools/classic_timing.py --root build/parent
    python tools/classic_timing.py --root .

(``chip_smoke.py --parent build/parent`` runs it so, parent, this, this,
parent.)  ``--root`` is a checkout holding ``sz_tpu_torch`` and
``chip_smoke.py`` (a ``git archive`` of another commit, unpacked under
``build/``); the fields and the timing are that checkout's own
(chip_smoke.classic_field, cuda_ms), so both trees time the same inputs
the same way.  Each kernel is called as that tree's main path calls it:
K10 with no reconstruction where the wrapper has ``want_R`` (also timed
with it), K11 on the compact escapes and the row bases where it takes
them, else on a full-size ``known``.  Prints one JSON line with the
card's name and power limit; exits 1 without a card.
"""

from __future__ import annotations

import argparse
import inspect
import json
import pathlib
import subprocess
import sys

import numpy as np

# (case, shape, dtype, rp, seed, noise): chip_smoke's timed K10/K11 cases
CASES = [
    ("main_path_256", (256, 256, 256), np.float32, 1e-3, 42, 0.1),
    ("main_path_cesm_atm", (1800, 3600), np.float32, 1e-3, 6, 0.1),
    ("main_path_f64_256", (256, 256, 256), np.float64, 1e-3, 42, 0.1),
    ("full_size_4d", (8, 128, 256, 256), np.float32, 1e-3, 20, 0.1),
    ("full_size_512", (512, 512, 512), np.float32, 1e-3, 42, 0.1),
]


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
    strips = "want_R" in inspect.signature(ck.classic_quantize).parameters
    rows = []
    for case, shape, dtype, rp, seed, noise in CASES:
        x, p = cs.classic_field(shape, dtype, rp, seed, noise)
        xt = torch.from_numpy(x).to(dev)
        del x
        q = (p.rp, p.recip, p.intervals, p.radius, p.median, p.req_length)
        types, R = ck.classic_quantize(xt, *q)
        row = dict(case=case, shape=list(shape))
        if strips:
            esc = R.reshape(-1)[types.reshape(-1) == 0]
            rb = ck.escape_row_base(types)[0]
            row["classic_quantize_ms"] = cs.cuda_ms(
                lambda: ck.classic_quantize(xt, *q, want_R=False), args.reps)
            row["classic_quantize_with_R_ms"] = cs.cuda_ms(
                lambda: ck.classic_quantize(xt, *q), args.reps)
            row["classic_decode_ms"] = cs.cuda_ms(
                lambda: ck.classic_decode(types, esc, p.rp, p.radius,
                                          row_base=rb), args.reps)
        else:
            known = torch.where(types == 0, R, torch.zeros_like(R))
            row["classic_quantize_ms"] = cs.cuda_ms(
                lambda: ck.classic_quantize(xt, *q), args.reps)
            row["classic_decode_ms"] = cs.cuda_ms(
                lambda: ck.classic_decode(types, known, p.rp, p.radius),
                args.reps)
            del known
        rows.append(row)
        del xt, types, R
        torch.cuda.empty_cache()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(json.dumps(dict(root=str(root), strips=strips, nvidia_smi=smi,
                          device=torch.cuda.get_device_name(0), rows=rows)),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
