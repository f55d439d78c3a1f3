#!/usr/bin/env python3
"""Variants of K14/K15 (``csrc/temporal.cu``) timed beside the tree's own
kernels in one call on one card, to see what bounds the two-pass design.

Usage, from the repo root, on a machine with the card and nvcc:

    python tools/temporal_variants.py [--out FILE.json]

Each variant is a copy of ``temporal.cu`` with the edits below, built
alone with the package's nvcc flags under ``build/temporal_variants/``
(never kept in the repository), loaded in place of the package's library
for the K14/K15 wrappers, and timed by ``tools/strip_timing.py``'s
``temporal_rows`` (wrapper and bare launches at the chain's shapes and
2^24):

  k14_4096     K14 at 4 slots a thread (4096 points a tile)
  k15_2048     K15 at 2 slots a thread
  k15_8192     K15 at 8 slots a thread
  pass_a_only  pass B not launched: its cost by difference (the escapes
               and the count are then wrong)
  stub         the per-point arithmetic stubbed out (every type the
               radius, the reconstruction prev): what the double work
               costs once the stream is wide

The tree's own kernels are timed first and last.  The tiling variants
are first held bit-equal to the plain versions on three ``ts_case``
cases (chip_smoke.ts_vs_plain).  Prints one JSON line with the card's
name and power limit; exits 1 without a card.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import pathlib
import shutil
import subprocess
import sys

REPO = pathlib.Path(__file__).resolve().parents[1]
ENTRIES = ("sz_ts_quantize", "sz_ts_quantize_f64", "sz_ts_decode",
           "sz_ts_decode_f64")


def slots(q: int, d: int) -> list:
    return [("constexpr int kQuantizeSlots = 2;",
             f"constexpr int kQuantizeSlots = {q};"),
            ("constexpr int kDecodeSlots = 4;",
             f"constexpr int kDecodeSlots = {d};")]


def variants(src: str) -> dict:
    """name -> ((K14 slots, K15 slots), [(old, new) edits of src])."""
    point = src[src.index("  using N = Num<T>;\n  const T pae"):
                src.index("  return e;\n}\n")]
    restore = ("      o[q] = N::narrow(__dadd_rn(\n          (double)p[k][q], "
               "__dmul_rn((double)(ty[k][q] - radius), interval2)));")
    pass_b = "  pass_b<<<(unsigned)g.blocks, kThreads, 0, st>>>("
    return {
        "k14_4096": ((4, 4), slots(4, 4)),
        "k15_2048": ((2, 2), slots(2, 2)),
        "k15_8192": ((2, 8), slots(2, 8)),
        "pass_a_only": ((2, 4), [(pass_b, "  if (false) " + pass_b.lstrip())]),
        "stub": ((2, 4), [(point, "  const bool e = first_two || x != x;\n"
                           "  type = e ? 0 : a.radius;\n  rec = p;\n"),
                          (restore, "      o[q] = p[k][q];")]),
    }


def build(name: str, src: str, edits: list):
    """The variant's library (its four entry points typed) and ptxas's
    registers and spills of its kernels."""
    from sz_tpu_torch.gpu import _build
    import chip_smoke as cs
    d = REPO / "build" / "temporal_variants" / name
    shutil.rmtree(d, ignore_errors=True)
    d.mkdir(parents=True)
    for old, new in edits:
        if old not in src:
            raise AssertionError(f"{name}: edit not found: {old[:60]!r}")
        src = src.replace(old, new)
    (d / "temporal.cu").write_text(src)
    so = d / "libts.so"
    r = subprocess.run([_build.find_nvcc(), *_build.NVCC_FLAGS, "-shared",
                        "-o", str(so), str(d / "temporal.cu")],
                       capture_output=True, text=True)
    if r.returncode:
        raise RuntimeError(f"{name}: nvcc failed\n{r.stdout}{r.stderr}")
    lines = [ln for ln in (r.stdout + r.stderr).splitlines()
             if "registers" in ln or "Compiling entry" in ln or "spill" in ln]
    dll = ctypes.CDLL(str(so))
    for e in ENTRIES:
        getattr(dll, e).argtypes = _build.SIGNATURES[e]
        getattr(dll, e).restype = ctypes.c_int
    return dll, {k: cs.ptxas_of(lines, k) for k in cs.TS_KERNELS}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", help="also write the record as JSON")
    args = ap.parse_args()
    sys.path.insert(0, str(REPO))
    sys.path.insert(0, str(REPO / "tools"))
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    import strip_timing
    from sz_tpu_torch.gpu import _build
    from sz_tpu_torch.gpu import temporal_kernel as tk
    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    own = (_build.lib, tk.QUANTIZE_SLOTS, tk.QUANTIZE_TILE, tk.DECODE_SLOTS,
           tk.DECODE_TILE)
    src = (REPO / "sz_tpu_torch" / "csrc" / "temporal.cu").read_text()
    rec = dict(nvidia_smi=smi, device=torch.cuda.get_device_name(0),
               own_first=strip_timing.temporal_rows(cs, dev), variants={})
    for name, ((q, d), edits) in variants(src).items():
        dll, regs = build(name, src, edits)
        _build.lib = lambda dll=dll: dll
        tk.QUANTIZE_SLOTS, tk.QUANTIZE_TILE = q, tk.THREADS * q * tk.VEC
        tk.DECODE_SLOTS, tk.DECODE_TILE = d, tk.THREADS * d * tk.VEC
        try:
            if name.startswith("k1"):
                for case in ("drift", "tiles_plus_three", "all_escape"):
                    for T in (np.float32, np.float64):
                        cur, prev, rp, kw = cs.ts_case(case, T)
                        cs.ts_vs_plain(case, torch.from_numpy(cur).to(dev),
                                       torch.from_numpy(prev).to(dev), rp,
                                       kw, False)
            rows = strip_timing.temporal_rows(cs, dev)
        finally:
            (_build.lib, tk.QUANTIZE_SLOTS, tk.QUANTIZE_TILE,
             tk.DECODE_SLOTS, tk.DECODE_TILE) = own
        rec["variants"][name] = dict(rows=rows, ptxas=regs)
        torch.cuda.empty_cache()
    rec["own_last"] = strip_timing.temporal_rows(cs, dev)
    if args.out:
        pathlib.Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        pathlib.Path(args.out).write_text(json.dumps(rec, indent=1))
    print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
