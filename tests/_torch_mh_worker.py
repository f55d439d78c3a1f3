"""One rank of the port's multi-process slab codec (the MPI/HDF5 pattern
of the reference's test_mpio.c:34-59): every rank compresses its slab of
one field with ``sz_tpu_torch.compress``, the sizes and then the padded
streams ride ``torch.distributed.all_gather`` (gloo over 127.0.0.1), and
rank 0 assembles the SZRA container with ``ra.build_container`` and
writes it to OUT.  The container equals the serial
``ra.compress(field, cfg, n_slabs=NPROCS)``.

    python tests/_torch_mh_worker.py RANK NPROCS PORT OUT
        [--device cpu|cuda] [--field test|hurricane]

``test`` is tests/test_multihost.py's 32x48x40 field (seed 99);
``hurricane`` chip_smoke.py's 100x500x500 ``field`` (seed 5).  Both
under ABS 1e-3.  Prints the rank's compress seconds as JSON.  Imports
neither jax nor sz_tpu, and checks so before it exits.
"""

import argparse
import json
import pathlib
import sys
import time

REPO = pathlib.Path(__file__).resolve().parent.parent


def make_field(kind: str):
    import numpy as np
    if kind == "hurricane":
        import importlib.util
        spec = importlib.util.spec_from_file_location(
            "chip_smoke", REPO / "chip_smoke.py")
        smoke = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(smoke)
        return smoke.field((100, 500, 500), 5)
    shape = (32, 48, 40)
    rng = np.random.default_rng(99)   # the same field on every rank
    n = int(np.prod(shape))
    return (np.sin(np.linspace(0, 11, n, dtype=np.float32))
            + 0.05 * rng.standard_normal(n)).astype(np.float32).reshape(shape)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("rank", type=int)
    ap.add_argument("nprocs", type=int)
    ap.add_argument("port", type=int)
    ap.add_argument("out")
    ap.add_argument("--device", default="cpu")
    ap.add_argument("--field", default="test", choices=("test", "hurricane"))
    args = ap.parse_args(argv)

    import numpy as np
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)   # ranks share the host's cores
    sys.path.insert(0, str(REPO))
    import sz_tpu_torch
    from sz_tpu_torch import ra
    from sz_tpu_torch.config import ErrorBoundMode, SZConfig

    dist.init_process_group("gloo",
                            init_method=f"tcp://127.0.0.1:{args.port}",
                            world_size=args.nprocs, rank=args.rank)
    try:
        data = make_field(args.field)
        starts = ra._slab_bounds(data.shape[0], args.nprocs)
        a, b = int(starts[args.rank]), int(starts[args.rank + 1])
        cfg = SZConfig().with_bound(ErrorBoundMode.ABS, 1e-3)
        t0 = time.perf_counter()
        blob = sz_tpu_torch.compress(data[a:b], cfg, device=args.device)
        seconds = time.perf_counter() - t0

        size = torch.tensor([len(blob)], dtype=torch.int64)
        sizes = [torch.zeros(1, dtype=torch.int64)
                 for _ in range(args.nprocs)]
        dist.all_gather(sizes, size)
        cap = max(int(s) for s in sizes)
        pad = torch.zeros(cap, dtype=torch.uint8)
        pad[:len(blob)] = torch.from_numpy(np.frombuffer(blob, np.uint8)
                                           .copy())
        streams = [torch.zeros(cap, dtype=torch.uint8)
                   for _ in range(args.nprocs)]
        dist.all_gather(streams, pad)
        payloads = [streams[i][:int(sizes[i])].numpy().tobytes()
                    for i in range(args.nprocs)]
        if args.rank == 0:
            pathlib.Path(args.out).write_bytes(ra.build_container(
                data.shape, data.dtype, starts, payloads))
        dist.barrier()
    finally:
        dist.destroy_process_group()
    bad = sorted(m for m in sys.modules if m == "jax" or m.startswith("jax.")
                 or m == "sz_tpu" or m.startswith("sz_tpu."))
    if bad:
        raise RuntimeError(f"modules of jax or sz_tpu were imported: {bad}")
    print(json.dumps({"rank": args.rank, "compress_s": seconds,
                      "bytes": len(blob)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
