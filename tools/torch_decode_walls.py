#!/usr/bin/env python3
"""Decompress walls of sz_tpu_torch at 512^3 on one card, for comparing
two trees in one machine.

Usage, from the repo root, alternating the trees in one call:

    python tools/torch_decode_walls.py --root build/parent --tag parent1
    python tools/torch_decode_walls.py --root . --tag change1

``--root`` is a checkout holding ``sz_tpu_torch`` and ``chip_smoke.py``
(a ``git archive`` of another commit, unpacked under ``build/``); the
fields and the best-of timing are that checkout's own (chip_smoke.field,
synth and _best_of), so both trees time the same inputs the same way.
Each run is a fresh process that times only decompression, in a fixed
order: the 512^3 float32 ABS 1e-3 ``field``, bench.py's synth 512^3 at
ABS 1e-3, and the 512^3 PW_REL 1e-3 ``|field|`` (each compressed once,
then decompressed warm, best of ``--reps``, with the
sz_tpu_torch.utils.trace spans of the best run).  Prints one JSON line
with the card's name and power limit; exits 1 without a card.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys

import numpy as np


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=".")
    ap.add_argument("--tag", default="")
    ap.add_argument("--reps", type=int, default=5)
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
    from sz_tpu_torch import ErrorBoundMode, SZConfig
    if not pathlib.Path(sz_tpu_torch.__file__).resolve().is_relative_to(root):
        raise RuntimeError(f"sz_tpu_torch not imported from {root}")

    dev = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    n = 512
    absc = SZConfig().with_bound(ErrorBoundMode.ABS, 1e-3)
    pwc = SZConfig().with_bound(ErrorBoundMode.PW_REL, 1e-3)
    rows = {}
    for name, make, cfg in (
            ("field_512_abs", lambda: cs.field((n, n, n), 42), absc),
            ("synth_512_abs", lambda: cs.synth(n), absc),
            ("pwrel_512", lambda: np.abs(cs.field((n, n, n), 42)), pwc)):
        x = make()
        blob = sz_tpu_torch.compress(x, cfg, device=dev)
        shape = x.shape
        del x
        td, spans, _ = cs._best_of(
            lambda: sz_tpu_torch.decompress(blob, shape, np.float32,
                                            device=dev), args.reps)
        rows[name] = dict(decompress_s=td, stream_bytes=len(blob),
                          spans_s=spans)
    line = json.dumps(dict(tag=args.tag, root=str(root), card=card,
                           reps=args.reps, rows=rows))
    print(line)
    if args.out:
        with open(args.out, "a") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
