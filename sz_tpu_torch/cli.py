"""The sz-tpu-torch command (``python -m sz_tpu_torch.cli``), the port's
copy of ``sz_tpu.cli``, mirroring the reference `sz` CLI (example/sz.c):
-z/-x compression/decompression, -p metadata print, -M/-A/-R/-P/-S/-N
bound control, -1..-4 dimensions, -a error analysis, -q the stats, -c an
sz.config INI.  ``--device`` (default cuda) takes the place of
``sz_tpu``'s ``--engine``: the codec runs on the card unless it says
cpu.  Files and printed lines are those of ``sz-tpu``.

Dim order follows the reference: `-3 nx ny nz` has nx fastest, so the
numpy array shape is (nz, ny, nx).
"""

from __future__ import annotations

import argparse
import dataclasses
import math
import os
import pathlib
import sys
import time

import numpy as np

from sz_tpu_torch import api
from sz_tpu_torch.config import ErrorBoundMode, SZConfig, SZMode
from sz_tpu_torch.utils import stats


_DTYPES = {
    "f": np.float32, "d": np.float64,
    "i8": np.int8, "ui8": np.uint8, "i16": np.int16, "ui16": np.uint16,
    "i32": np.int32, "ui32": np.uint32, "i64": np.int64, "ui64": np.uint64,
}


def _build_parser():
    p = argparse.ArgumentParser(
        prog="sz-tpu-torch",
        description="SZ2-compatible error-bounded lossy compressor "
                    "(PyTorch and CUDA)")
    p.add_argument("-z", nargs="?", const="", metavar="OUT",
                   help="compress (output file, default <input>.sz)")
    p.add_argument("-x", nargs="?", const="", metavar="OUT",
                   help="decompress (output file, default <input>.out)")
    p.add_argument("-p", action="store_true", help="print stream metadata")
    p.add_argument("-f", action="store_true", help="float32 data")
    p.add_argument("-d", action="store_true", help="float64 data")
    p.add_argument("--int", dest="int_type", choices=list(_DTYPES),
                   help="integer data type (i8..ui64)")
    p.add_argument("-c", metavar="CONF",
                   help="sz.config INI file (SZ_ReadConf)")
    p.add_argument("-M", default=None, metavar="MODE",
                   help="ABS|REL|ABS_AND_REL|ABS_OR_REL|PSNR|NORM|PW_REL"
                        "|ABS_AND_PW_REL|ABS_OR_PW_REL|REL_AND_PW_REL"
                        "|REL_OR_PW_REL")
    p.add_argument("-A", type=float, default=None, help="absolute bound")
    p.add_argument("-R", type=float, default=None, help="relative bound")
    p.add_argument("-P", type=float, default=None, help="pw-rel bound")
    p.add_argument("-S", type=float, default=None, help="PSNR")
    p.add_argument("-N", type=float, default=None, help="norm error")
    p.add_argument("-q", action="store_true",
                   help="print compressor stats (printSZStats analog)")
    p.add_argument("-T", action="store_true",
                   help="Tucker tensor decomposition pre-processing "
                        "(requires external TuckerMPI, like the "
                        "reference)")
    p.add_argument("-i", metavar="FILE", help="original data file")
    p.add_argument("-s", metavar="FILE", help="compressed data file")
    p.add_argument("-1", dest="d1", nargs=1, type=int, metavar="nx")
    p.add_argument("-2", dest="d2", nargs=2, type=int, metavar=("nx", "ny"))
    p.add_argument("-3", dest="d3", nargs=3, type=int,
                   metavar=("nx", "ny", "nz"))
    p.add_argument("-4", dest="d4", nargs=4, type=int,
                   metavar=("nx", "ny", "nz", "np"))
    p.add_argument("-a", action="store_true", help="print error analysis")
    p.add_argument("--device", default="cuda",
                   help="torch device of the codec (default cuda)")
    p.add_argument("--best-speed", action="store_true",
                   help="skip the final lossless stage (SZ_BEST_SPEED)")
    p.add_argument("--no-regression", action="store_true",
                   help="classic SZ1.4 kernels (withRegression=NO)")
    return p


def _shape(args):
    for dims in (args.d4, args.d3, args.d2, args.d1):
        if dims:
            return tuple(reversed(dims))  # nx fastest -> numpy slowest-first
    sys.exit("error: dimensions required (-1/-2/-3/-4)")


def _dtype(args):
    if args.d:
        return np.float64
    if args.int_type:
        return _DTYPES[args.int_type]
    return np.float32


def _cfg(args) -> SZConfig:
    """Config assembly mirroring the reference CLI: SZ_Init(confFile)
    first, then each explicitly-passed flag overrides its confparams
    field (example/sz.c:305-345).  Without -c or -M the bound mode
    defaults to ABS (the reference would stay at its PSNR default,
    which is almost never what a bare invocation wants)."""
    if args.c:
        cfg = SZConfig.from_file(args.c)
    else:
        cfg = SZConfig()
        if args.M is None:
            cfg = dataclasses.replace(
                cfg, error_bound_mode=ErrorBoundMode.ABS)
    kw = {}
    if args.M is not None:
        kw["error_bound_mode"] = getattr(ErrorBoundMode, args.M)
    if args.A is not None:
        kw["abs_err_bound"] = args.A
    if args.R is not None:
        kw["rel_bound_ratio"] = args.R
    if args.P is not None:
        kw["pw_rel_bound_ratio"] = args.P
    if args.S is not None:
        kw["psnr"] = args.S
    if args.N is not None:
        kw["norm_err"] = args.N
    if args.best_speed:
        kw["sz_mode"] = SZMode.BEST_SPEED
    if args.no_regression:
        kw["with_regression"] = False
    return dataclasses.replace(cfg, **kw)


def _analysis(ori: np.ndarray, dec: np.ndarray, byte_length: int):
    """The reference's -a report (example/sz.c:603-620)."""
    o = ori.astype(np.float64).ravel()
    r = dec.astype(np.float64).ravel()
    mn, mx = o.min(), o.max()
    rng = mx - mn
    diff = r - o
    diff_max = np.abs(diff).max()
    nz = o != 0
    maxpw = np.abs(diff[nz] / o[nz]).max() if nz.any() else 0.0
    mse = np.mean(diff * diff)
    psnr = 20 * math.log10(rng) - 10 * math.log10(mse) if mse > 0 \
        else math.inf
    nrmse = math.sqrt(mse) / rng if rng else 0.0
    cr = ori.nbytes / byte_length
    norm_err = math.sqrt(np.sum(diff * diff))
    sum22 = np.sum(o * o)
    o_c = o - o.mean()
    r_c = r - r.mean()
    denom = math.sqrt(np.sum(o_c * o_c)) * math.sqrt(np.sum(r_c * r_c))
    ac_eff = float(np.sum(o_c * r_c)) / denom if denom else 0.0
    print(f"Min={mn:.20G}, Max={mx:.20G}, range={rng:.20G}")
    print(f"Max absolute error = {diff_max:.10f}")
    print(f"Max relative error = {diff_max / rng:f}")
    print(f"Max pw relative error = {maxpw:f}")
    print(f"PSNR = {psnr:f}, NRMSE= {nrmse:.20G}")
    print(f"normError = {norm_err:f}, "
          f"normErr_norm = {norm_err / math.sqrt(sum22):f}")
    print(f"acEff={ac_eff:f}")
    print(f"compressionRatio={cr:f}")


def main(argv=None):
    args = _build_parser().parse_args(argv)
    if args.p:
        if not args.s:
            sys.exit("error: -p needs -s <compressed file>")
        meta = api.get_metadata(pathlib.Path(args.s).read_bytes())
        for k, v in meta.items():
            print(f"{k}: {v}")
        return

    dtype = _dtype(args)
    shape = _shape(args)

    if args.T:
        # the reference shells out to TuckerMPI (example/sz.c:386-420):
        # single precision is rejected outright, and double requires the
        # TUCKERMPI_PATH environment variable
        if dtype == np.float32:
            sys.exit("Error: Single-precision Tucker tensor "
                     "decomposition is not supported by TuckerMPI yet.")
        if os.environ.get("TUCKERMPI_PATH") is None:
            sys.exit("Error: the environment variable TUCKERMPI_PATH "
                     "== NULL.")

    if args.z is not None:
        if not args.i:
            sys.exit("error: -z needs -i <original data file>")
        data = np.fromfile(args.i, dtype=dtype).reshape(shape)
        cfg = _cfg(args)
        with stats.collect() as s:
            t0 = time.time()
            blob = api.compress(data, cfg, device=args.device)
            dt = time.time() - t0
        out = args.z or (args.i + ".sz")
        pathlib.Path(out).write_bytes(blob)
        print(f"compression time = {dt:f}")
        print(f"compressed data file: {out}")
        if args.q:
            print(s.report())
        if args.a:
            dec = api.decompress(blob, shape, dtype, device=args.device)
            _analysis(data, dec, len(blob))
        return

    if args.x is not None:
        if not args.s:
            sys.exit("error: -x needs -s <compressed file>")
        blob = pathlib.Path(args.s).read_bytes()
        t0 = time.time()
        dec = api.decompress(blob, shape, dtype, device=args.device)
        dt = time.time() - t0
        out = args.x or (args.s + ".out")
        np.asarray(dec, dtype=dtype).tofile(out)
        print(f"decompression time = {dt:f} seconds.")
        print(f"decompressed data file: {out}")
        if args.a and args.i:
            ori = np.fromfile(args.i, dtype=dtype).reshape(shape)
            _analysis(ori, dec, len(blob))
        return

    _build_parser().print_help()


if __name__ == "__main__":
    main()
