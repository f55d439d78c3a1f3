#!/usr/bin/env python3
"""Decompress walls and device work of sz_tpu_torch at 512^3 on one card,
for comparing two trees in one machine.

Usage, from the repo root, alternating the trees in one call:

    python tools/torch_decode_walls.py --root build/parent --tag parent1
    python tools/torch_decode_walls.py --root . --tag change1

``--root`` is a checkout holding ``sz_tpu_torch`` and ``chip_smoke.py``
(a ``git archive`` of another commit, unpacked under ``build/``); the
fields and the best-of timing are that checkout's own (chip_smoke.field,
synth and _best_of), so both trees time the same inputs the same way.
Each run is a fresh process that times only decompression, in a fixed
order: the 512^3 float32 ABS 1e-3 ``field``, bench.py's synth 512^3 at
ABS 1e-3, the 512^3 PW_REL 1e-3 ``|field|`` and the ABS 1e-3 ``field``
with ``random_access`` (``--rows`` picks some of them).  Each is
compressed once, then decompressed warm: the best of ``--reps`` with the
sz_tpu_torch.utils.trace spans of the best run (summed by name; some
nest), the peak device memory of one decompress above what was allocated
before it (``torch.cuda.max_memory_allocated``), and one decompress
under torch.profiler: device milliseconds and launches by kernel name.
Prints one JSON line with the card's name and power limit; exits 1
without a card.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys

import numpy as np

ROWS = ("field_512_abs", "synth_512_abs", "pwrel_512", "ra_512")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=".")
    ap.add_argument("--tag", default="")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--rows", nargs="+", choices=ROWS, default=ROWS)
    ap.add_argument("--out", help="also append the JSON line to this file")
    args = ap.parse_args()
    root = pathlib.Path(args.root).resolve()
    sys.path.insert(0, str(root))
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    from torch.profiler import ProfilerActivity, profile

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
    rac = SZConfig(random_access=True).with_bound(ErrorBoundMode.ABS, 1e-3)
    cases = {
        "field_512_abs": (lambda: cs.field((n, n, n), 42), absc),
        "synth_512_abs": (lambda: cs.synth(n), absc),
        "pwrel_512": (lambda: np.abs(cs.field((n, n, n), 42)), pwc),
        "ra_512": (lambda: cs.field((n, n, n), 42), rac)}
    rows = {}
    for name in ROWS:
        if name not in args.rows:
            continue
        make, cfg = cases[name]
        x = make()
        blob = sz_tpu_torch.compress(x, cfg, device=dev)
        shape = x.shape
        del x

        def decode():
            return sz_tpu_torch.decompress(blob, shape, np.float32,
                                           device=dev)

        td, spans, _ = cs._best_of(decode, args.reps)
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        decode()
        peak = torch.cuda.max_memory_allocated(dev) - held
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            decode()
            torch.cuda.synchronize()
        kernels = {}
        for e in prof.events():
            if str(e.device_type).endswith("CUDA"):
                ms, k = kernels.get(e.name[:80], (0.0, 0))
                kernels[e.name[:80]] = (
                    ms + (e.time_range.end - e.time_range.start) / 1e3, k + 1)
        rows[name] = dict(
            decompress_s=td, stream_bytes=len(blob), spans_s=spans,
            peak_device_bytes=peak,
            device_ms={k: v[0] for k, v in sorted(
                kernels.items(), key=lambda kv: -kv[1][0])},
            device_launches={k: v[1] for k, v in kernels.items()})
    line = json.dumps(dict(tag=args.tag, root=str(root), card=card,
                           reps=args.reps, rows=rows))
    print(line)
    if args.out:
        with open(args.out, "a") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
