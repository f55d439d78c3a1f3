"""The port's multi-process slab codec, in-suite: N processes join a
torch.distributed group (gloo over 127.0.0.1, on the CPU), each
compresses its slab with sz_tpu_torch, the sizes and the padded streams
ride ordered all_gathers, and rank 0's SZRA container
(tests/_torch_mh_worker.py) must equal the serial
``sz_tpu.ra.compress(..., n_slabs=N)`` of the same field byte for byte
and decode bit-equal (the port of tests/test_multihost.py).  Each worker
checks that it loaded neither jax nor sz_tpu."""

import os
import pathlib
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch
torch.set_num_threads(1)  # xdist workers share the cores: one thread each

WORKER = pathlib.Path(__file__).parent / "_torch_mh_worker.py"
REPO = pathlib.Path(__file__).resolve().parent.parent


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.mark.parametrize("nprocs", [2, 4])
def test_distributed_container_matches_serial(tmp_path, nprocs):
    if nprocs == 4 and (os.cpu_count() or 1) < 4:
        pytest.skip("needs >= 4 CPUs")
    from sz_tpu import ra
    from sz_tpu.config import ErrorBoundMode, SZConfig

    from _torch_mh_worker import make_field

    out = tmp_path / "mh.szra"
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=str(REPO))
    procs = [subprocess.Popen(
        [sys.executable, str(WORKER), str(i), str(nprocs), str(port),
         str(out), "--device", "cpu"], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE) for i in range(nprocs)]
    try:
        for p in procs:
            _, err = p.communicate(timeout=300)
            assert p.returncode == 0, err.decode()[-2000:]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()

    data = make_field("test")
    cfg = SZConfig(engine="numpy").with_bound(ErrorBoundMode.ABS, 1e-3)
    serial = ra.compress(data, cfg, n_slabs=nprocs)
    got = out.read_bytes()
    assert got == serial
    back = ra.decompress(got, engine="numpy")
    from sz_tpu_torch import ra as tra
    np.testing.assert_array_equal(tra.decompress(got, device="cpu").view(
        np.uint32), back.view(np.uint32))
