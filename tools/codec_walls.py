#!/usr/bin/env python3
"""Compress and decompress walls of sz_tpu_torch's float and integer
codecs on one card, for comparing two trees in one machine.

Usage, from the repo root, alternating the trees in one call:

    python tools/codec_walls.py --root build/parent --tag parent1
    python tools/codec_walls.py --root . --tag change1

``--root`` is a checkout holding ``sz_tpu_torch`` and ``chip_smoke.py``
(a ``git archive`` of another commit, unpacked under ``build/``); the
fields, configurations and the best-of timing are that checkout's own
(chip_smoke.field, field64, pwrel_field, classic_config and _best_of), so
both trees time the same inputs the same way.  Each run is a fresh
process that times, in a fixed order, chip_smoke's phase-4 rows: 512^3
float32 ABS 1e-3, 512^3 PW_REL 1e-3 (|field|), 512^3 float64 ABS 1e-3,
the classic codec on 512^3 float32, the 1-D codec on its 2^27 values,
the integer codec on 512^3 int32 and 1800x3600 int16 under ABS 4
(chip_smoke.int_field; ``--rows`` picks some of them): each compressed
and decompressed warm, the best of ``--reps`` with the
sz_tpu_torch.utils.trace spans of the best run (summed by name; some
nest).  Prints one JSON line with the
card's name and power limit; exits 1 without a card.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys

import numpy as np

ROWS = ("abs_512", "pwrel_512", "abs64_512", "classic_512", "classic_1d_2^27",
        "int32_512", "int16_1800x3600")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=".")
    ap.add_argument("--tag", default="")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--rows", nargs="+", choices=ROWS, default=ROWS)
    ap.add_argument("--out", help="also append the JSON line to this file")
    args = ap.parse_args()
    root = pathlib.Path(args.root).resolve()
    sys.path.insert(0, str(root))
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1

    import chip_smoke as cs
    import sz_tpu_torch
    if not pathlib.Path(sz_tpu_torch.__file__).resolve().is_relative_to(root):
        raise RuntimeError(f"sz_tpu_torch not imported from {root}")

    dev = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    n = (512, 512, 512)
    cases = {
        "abs_512": (lambda: cs.field(n, 42), ("ABS", 1e-3), {}),
        "pwrel_512": (lambda: np.abs(cs.field(n, 42)), ("PW_REL", 1e-3),
                      {}),
        "abs64_512": (lambda: cs.field64(n, 42), ("ABS", 1e-3), {}),
        "classic_512": (lambda: cs.field(n, 42), ("ABS", 1e-3),
                        dict(with_regression=False)),
        "classic_1d_2^27": (lambda: cs.field(n, 42).reshape(-1),
                            ("ABS", 1e-3), {}),
        "int32_512": (lambda: cs.int_field(n, 42, np.int32), ("ABS", 4),
                      {}),
        "int16_1800x3600": (lambda: cs.int_field((1800, 3600), 6,
                                                 np.int16), ("ABS", 4), {}),
    }
    rows = {}
    for name in ROWS:
        if name not in args.rows:
            continue
        make, bnd, over = cases[name]
        x = make()
        cfg = cs.classic_config(bnd, over)
        blob = sz_tpu_torch.compress(x, cfg, device=dev)
        tc, spans_c, _ = cs._best_of(
            lambda: sz_tpu_torch.compress(x, cfg, device=dev), args.reps,
            warm=False)
        td, spans_d, _ = cs._best_of(
            lambda: sz_tpu_torch.decompress(blob, x.shape, x.dtype,
                                            device=dev), args.reps)
        rows[name] = dict(compress_s=tc, decompress_s=td,
                          stream_bytes=len(blob), compress_spans_s=spans_c,
                          decompress_spans_s=spans_d)
        del x, blob
        torch.cuda.empty_cache()
    line = json.dumps(dict(tag=args.tag, root=str(root), card=card,
                           reps=args.reps, rows=rows))
    print(line)
    if args.out:
        with open(args.out, "a") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
