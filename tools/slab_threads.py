#!/usr/bin/env python3
"""What several slab threads on one card cost: the launch rate of tiny
torch ops issued from 1, 2, 4 and 8 threads (each on a stream of its
own), and sz_tpu_torch.parallel.slab.compress_sharded of chip_smoke's
Hurricane field (100x500x500 float32, ABS 1e-3, 4 slabs) with 1, 2 and 4
pool threads, with the plain-torch launch storms (stages.coeff_sums,
stages.select) issued one thread at a time, as the port does, and
without that lock.  Every container must hash to ORACLE_SLAB.

    python3 tools/slab_threads.py [--out FILE.json]

Run from the root of a checkout on a machine with a CUDA card; prints
one JSON line a measurement, the card's name and power limit first.
Imports neither jax nor sz_tpu.
"""

import argparse
import contextlib
import json
import os
import pathlib
import subprocess
import sys
import threading
import time

REPO = pathlib.Path(__file__).resolve().parent.parent


def launch_rate(dev, threads: int, ops: int) -> float:
    """Seconds for ``ops`` tiny adds split over ``threads`` threads."""
    import torch

    def work(n, stream):
        with torch.cuda.stream(stream):
            a = torch.zeros(1000, device=dev)
            b = torch.ones(1000, device=dev)
            for _ in range(n):
                a = a + b
            stream.synchronize()

    streams = [torch.cuda.Stream(dev) for _ in range(threads)]
    work(100, streams[0])
    t0 = time.perf_counter()
    pool = [threading.Thread(target=work, args=(ops // threads, s))
            for s in streams]
    for t in pool:
        t.start()
    for t in pool:
        t.join()
    return time.perf_counter() - t0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", help="also write the rows as JSON")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("slab_threads: no CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    import chip_smoke as smoke
    from sz_tpu_torch import ErrorBoundMode, SZConfig
    from sz_tpu_torch.gpu import stages
    from sz_tpu_torch.parallel import slab

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip(), flush=True)
    dev = torch.device("cuda", 0)
    rows = []

    def log(**row):
        print(json.dumps(row), flush=True)
        rows.append(row)

    for k in (1, 2, 4, 8, 1):
        s = launch_rate(dev, k, 40000)
        log(probe="tiny adds", threads=k, ops=40000, s=s,
            us_per_op=s / 40000 * 1e6)

    maker, shape, seed, n, want, _ = smoke.ORACLE_SLAB["field"]
    x = smoke.classic_input(maker, shape, seed)
    cfg = SZConfig().with_bound(ErrorBoundMode.ABS, smoke.ABS)
    lock = stages._launch_storm
    for storm_lock in (True, False):
        stages._launch_storm = lock if storm_lock else \
            contextlib.nullcontext()
        for k in (1, 2, 4):
            os.environ["SZ_TPU_HOST_THREADS"] = str(k)
            walls = []
            for _ in range(4):   # a warm run, then 3
                t0 = time.perf_counter()
                blob = slab.compress_sharded(x, cfg, n_devices=n)
                walls.append(time.perf_counter() - t0)
                if smoke.sha256(blob) != want:
                    raise AssertionError("the container differs from "
                                         "ORACLE_SLAB")
            log(probe="compress_sharded 100x500x500, 4 slabs",
                storm_lock=storm_lock, threads=k, best_s=min(walls[1:]),
                walls_s=walls)
    stages._launch_storm = lock
    if args.out:
        out = pathlib.Path(args.out)
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps(rows, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
