#!/usr/bin/env python3
"""Bring-up check of the PyTorch/CUDA port (sz_tpu_torch) on one GPU.

Run from the root of a checkout, on a machine with an NVIDIA Hopper card,
nvcc (CUDA_HOME, PATH or /usr/local/cuda) and a C compiler (cc):

    python3 chip_smoke.py [--out FILE.json] [--parent DIR]
                          [--parent-kernels classic,lorenzo64,temporal,int]

Phases (one line of numbers each; any failure raises and exits non-zero):
  1. environment: versions, card name and power limit, the kernel build
     (one nvcc per source, in parallel) and the host runtime build (cc);
  2. each Hopper kernel bit-equal to its plain torch version on the
     card, with both times: K1/K2 (the tiled Lorenzo recurrence) and
     their float64 forms K1d/K2d (warp strips) on ragged, sub-tile,
     single-row, all- and no-regression lattices, K1d/K2d also on the
     strips' edges (LORENZO_F64_EDGES), each called twice, K1d's types
     the same with R and without, and timed at the main path's shapes
     (K1/K2: 256^3, 100x500x500, 1800x3600, 512^3; K1d/K2d: 256^3,
     1800x3600, 512^3, K1d without R as the main path calls it), with
     each tile's and strip kernel's shared memory and ptxas registers;
     past 2^20 points every plain version of a recurrence runs on a
     leading box of the lattice (plain_box: the first 65 rows and 300
     columns of its first planes, or 385 rows and 300 columns of a 2-D
     one), whose time the record keeps beside its shape;
     K3/K4 timed at their 2^24-symbol test
     shapes, and on their edge cases (pack_cases, hist_cases: tile and
     run sizes, codes of 1 to 128 bits, holes, symbols past the table or
     the bins, a wrong window hint, heavy symbol 0; each also from an
     unaligned start) and a 2^27-symbol single-bin stream; K5-K7 (the
     Huffman decode) on skewed streams, trees of 20,000 and 80,000 nodes
     (transition tables of 80 and 320 KB), a stream past 2^31 bits,
     codes of 1100 and 40 bits, and a stream of the 512^3 stream's size
     whose chunks never self-synchronize, each with K6's launches a
     decode and the decode time; K6 also on synthetic maps of up to
     10^6 chunks (never converging, counts past 2^31, D past 63); K8/K9
     (the tiled MSST19 PW_REL recurrence, both directions, each called
     twice, the decode also rebuilding the encode's reconstruction) at
     the CPU tests' shapes, on ragged, sub-tile and single-row lattices
     and one long on k, a 1e-5 table past 4096 states, a signed field
     with zeros, and timed at 256^3, 1800x3600 and 512^3 (the plain
     versions on the first planes there); K10/K11 (the classic codec's
     recurrence as warp strips, both directions, each called twice, K10's
     types the same with R asked for and without, the decode rebuilding
     the encode's reconstruction from the compact escapes, one launch a
     call, 4-D included) on the CPU tests' degenerate shapes, ragged,
     sub-tile and single-row lattices, one long on k, 4-D fields,
     float64, random data that nearly always escapes, and the strips'
     edges (CLASSIC_EDGE_SHAPES: strips of 31, 33 and 65 rows, plane
     counts no multiple of a block's warps, rows of 1, 2, 15 and 17
     columns, one row, one plane, 128 volumes of 8^3), a step's latency
     on a one-row lattice of each form, K11 on escape streams shorter
     than the type-0 points (the ranks clipped, as _decode_fn does), and
     timed at 256^3 (float32 and
     float64), 1800x3600, 8x128x256x256 and 512^3 with the byte bound
     (and the parent's 12 B a point) and the chain bound; each kernel's
     registers, spills and shared memory; with --parent DIR, the parent
     tree's K10/K11, K1d/K2d, K14/K15 and K16/K17 (wrappers and bare
     launches)
     timed beside this tree's (tools/strip_timing.py, parent, this,
     this, parent; --parent-kernels picks among them);
     K8d/K9d (MSST19 on float64 data) on K8/K9's shapes, the 1e-4 and
     1e-5 tables, timed at 256^3, 1800x3600 and 512^3; K12/K13 (the
     random-access codec's per-block scans; K13 on the compact escapes,
     writing the field's layout) on fields whose edge blocks are padded,
     fields of one block and less, fields with the mean flush on, random
     data under 1e-6, region decodes at ranks 1-3 whose faces cut
     blocks, K13 on escape layouts (only in a rank-3 block's last staged
     words, one in a block's last cell, one escape too many), timed at
     256^3, 1800x3600, 2^24 (1-D) and 512^3 (the plain versions on the
     leading 2^16 blocks), with K13's bound before and after it took
     over the escape placement and the de-blocking; K14/K15 (the
     temporal step and restore, two launches each, float32 and float64,
     each called twice) on a step equal to its history, a step that
     escapes everywhere (also at 2^24 points), 3 and 21 points, a tile
     less one, a tile, a tile plus one and three tiles plus three points,
     subnormals, NaN and +-inf, fixed intervals, inputs at storage offset
     1 (each of cur, prev, types, vals, and all four), and timed at 2^24
     points, with each kernel's registers and spills; K15 must rebuild
     K14's reconstruction, and count an escape past the end of its stream
     alike; K16/K17 (the integer codecs' recurrence as warp strips, both
     directions, each called twice, K17 on the escapes as a stream holds
     them, one launch a call) on the strips' edges (INT_EDGE_SHAPES:
     strips of 31, 33 and 65 rows, CHUNK +- 1 columns, one row, one
     plane, 4-D fields) in int8, uint16, int32, uint32, int64 and uint64,
     on fields that reach the traps (a difference of 2^63, int64 values
     next to 2^63, whole-range random data of five types), on cases
     that reach each ring form and arithmetic form (INT_FORM_CASES:
     K16's integer, reciprocal and exact forms on 32-bit and int64
     rings, K17's integer and double forms; each row names its forms,
     and a form left unreached fails), and timed at 512^3 int32 with the
     bound under ABS 4 (the integer forms) and ABS 2.5 (K16's
     reciprocal form), each kernel's registers, spills, shared bytes and
     the runtime's blocks an SM; K10's subblock form (compress_region's
     quantizer, classic_quantize_sub) on the classic edges, every other
     one at origin 0 and the rest at an odd origin, float32 and float64,
     and on escape-heavy
     fields, bit-equal to its plain version, called twice, the types the
     same without R, one launch a call, and timed at 256^3 and 1800x3600
     with the byte and chain bounds (a one-row step of each dtype);
  3. the main path, sz_tpu_torch.compress/decompress on the card: ABS
     1e-3 (float32 and float64) and PW_REL 1e-3 streams and
     reconstructions hash to the SHA-256 of the host oracle's (sz_tpu,
     engine="numpy"; recomputed on the CPU by
     tests/test_torch_smoke_oracle.py, tests/test_torch_smoke_oracle_f64.py
     and tests/test_torch_smoke_oracle_pwrel.py), the reference golden
     streams (float32 and float64) decode bit-equal, synth_f64_64.dat
     compresses to its golden's inner stream, and a compress from a CUDA
     tensor (float32, float64, non-contiguous, 4-D) gives the host
     array's bytes; the classic codec (2-D, 3-D, 4-D, float64, 4-D with
     random access), the 1-D codec and pre-log PW_REL (1e-3 with
     accelerate_pw_rel off, 1e-6) hash to the oracle's
     (tests/test_torch_smoke_oracle_classic.py) and hold their bound,
     the reference's classic, 1-D and pre-log goldens decode bit-equal
     and synth_signed.dat compresses to sz_tpu's stream; PW_REL 1e-3 on
     float64 data (signed 256^3 with zeros, 1800x3600) and the
     random-access codec (ABS 1e-3 at 256^3, 1800x3600 and 2^24 in 1-D,
     and decompress_region of a 64^3 corner) hash to the oracle's
     (tests/test_torch_smoke_oracle_pwrel64.py,
     tests/test_torch_smoke_oracle_ra.py) and hold their bounds; a
     TemporalCompressor chain (Hurricane ISABEL's 100x500x500 float32 and
     CESM-ATM's 1800x3600 float64, ABS 1e-3, snapshots at steps 0 and 5,
     temporal steps 1-4) hashes frame and decode to ORACLE_TEMPORAL
     (tests/test_torch_smoke_oracle_temporal.py) on every step and holds
     the bound, its histories on the card; the integer codecs
     (ORACLE_INT: int_field in all eight dtypes at ranks 1-4, 256^3
     int32, CESM-ATM's 1800x3600 as int16, 8x64x64x64 int32) hash stream
     and decode to the oracle's (tests/test_torch_smoke_oracle_int.py)
     and hold their bound, from a host array and (ranks 2-4) a CUDA
     tensor with an as_tensor decode, and the reference's integer
     goldens decode bit-equal and compress to their inner streams; the
     launch counters of K1-K17, K1d/K2d and K8d/K9d must all rise; run
     under torch.profiler: each kernel's device time summed
     over the phase, and the device's idle share; then, under its own
     profile, the host<->device copies of a compress from a 256^3 tensor
     (no copy of the field up; down, besides the packed stream, under
     5 % of the field), and of the temporal chain's temporal steps from
     CUDA tensors (the same frames, steps 1 and 3 from views at storage
     offset 1; no copy up of 5 % of a field);
  3b. multi-device (sz_tpu_torch.parallel.slab, the launch counters
     covering exactly this phase): Hurricane ISABEL's 100x500x500
     float32 and CESM-ATM's 1800x3600 float64 (K1d/K2d) under ABS 1e-3
     in 4 slabs on this card at once (compress_sharded(n_devices=4), a
     stream a slab) hash container and decode to ORACLE_SLAB
     (tests/test_torch_smoke_oracle_slab.py) from a host array, one CUDA
     tensor, a list of four slab tensors and the serial pool
     (SZ_TPU_HOST_THREADS=1), decompress_sharded and its as_tensor slabs;
     K1 (K1d) and K3 launch 4 times a compress, K2 (K2d) 4 times a
     decode, K4-K7 as often in every run; the random-access 256^3 stream
     with its blocks over ["cuda:0", "cuda:0"] (K12/K13 and the
     lattice's K3 once a device) hashes to ORACLE_RA, its 64^3 corner to
     ORACLE_RA_REGION; four torch.distributed ranks (gloo over
     127.0.0.1, tests/_torch_mh_worker.py, all on this card) each
     compress a slab of the Hurricane field and rank 0's container
     hashes to ORACLE_SLAB (the wall logged);
  3c. the surfaces beside the codec, each with the launch counters set
     to 0 just before it and read just after (SURFACE_KERNELS must
     rise): the sz-tpu-torch command on the Hurricane field written
     under build/smoke_cli/ (-z, -x and -p through cli.main in this
     process on its default device, the card, then -z again as `python
     -m sz_tpu_torch.cli`): each .sz file hashes to ORACLE's stream, the
     -x file to its decode, -p prints get_metadata's fields; its
     printed compression and decompression times; compress_region of
     ORACLE_REGION's regions (80x400x400 float32 of the Hurricane field,
     1600x3200 float64 of CESM-ATM, 2^24 values of the flattened
     Hurricane field; K10's subblock form on the first two) hashes
     stream and decode (decompress with the region's shape) to the
     oracle's (tests/test_torch_smoke_oracle_region.py), holds ABS 1e-3
     where the oracle's decode does, and its MB/s; the ExaFEL app
     codec's stream and decode hash to ORACLE_EXAFEL;
  4. 512^3 float32 (NYX scale): the ABS error bound holds, compress and
     decompress MB/s (warm, best of 3) with per-span times and counts,
     the same field in 4 slabs of 128x512x512 (each payload equal to
     the slab's own compress, decompress_sharded equal to
     Reader.decode; MB/s and peak device memory of the 4 slabs at once,
     of the serial pool and of the whole field),
     the compress from a CUDA tensor of the same field, the kernel
     launches of one decompress, the device-to-host copy of 537 MB, the
     decompress of bench.py's synth field (the earlier records' input);
     then PW_REL 1e-3 at 512^3 (the point-wise
     bound asserted) and at 1800x3600, MB/s with spans and launches;
     512^3 float64 (1.07 GB; K1d/K2d): the bound, MB/s, spans and
     launches; the classic codec on 512^3 float32 and float64,
     1800x3600 and 8x128x256x256 (without regression and with random
     access), the 1-D codec on 2^27 values, pre-log PW_REL 1e-3 on the
     signed 512^3 field and PW_REL 1e-6 on 1800x3600 float32 and 256^3
     float64: the bound, MB/s, spans and launches; PW_REL 1e-3 on 512^3
     float64 (|field64|, 1.07 GB) and the random-access codec on 512^3
     float32 (and a 64^3 region of it): the bound, MB/s, spans,
     launches and the decompress's peak device memory; the integer
     codecs on 512^3 int32 (also from a CUDA tensor, no copy of the field
     up, and decoded as_tensor) and 1800x3600 int16, ABS 4: the bound,
     MB/s, spans and launches; the temporal chain again, warm: each
     step's compress_step and decompress_step wall with spans and
     launches, and K14/K15 timed on each variable's step 1 against its
     history; then K5-K7 timed
     against their plain versions on the type streams
     of 512^3 ABS, 512^3 PW_REL and 1800x3600 PW_REL (node count,
     longest code and codeword-table bits of each; K6 also at each tile
     size, and its launches in one decode); K3 and K4 timed
     against their plain versions on the same fields' main-path inputs
     (the type lattice; the stream with its real tables), caught from
     the first compress of each field above.
The last two lines are the kernel record and {"ok": true, "device": ...}.
Without CUDA, or outside a checkout, it fails without a result.  It
imports neither jax nor any module of sz_tpu.
"""

from __future__ import annotations

import argparse
import contextlib
import hashlib
import json
import math
import os
import pathlib
import subprocess
import sys
import time

import numpy as np

REPO = pathlib.Path(__file__).resolve().parent
ABS = 1e-3
PW_REL = 1e-3
HBM_BYTES_PER_S = 3.35e12     # H100 SXM device memory (data sheet)
OPS_PER_S_32BIT = 67e12       # H100 SXM 32-bit rate outside tensor cores
OPS_PER_S_64BIT = 34e12       # H100 SXM f64 rate outside tensor cores


_T0 = time.perf_counter()


def _log(phase: str, **nums) -> None:
    """One line of numbers, with the seconds since the script started."""
    print(f"[{phase}] " + json.dumps(nums, default=float)
          + f" @{time.perf_counter() - _T0:.1f}s", flush=True)


# --- phase 3/4 inputs: exact float32 arithmetic, the same on any machine --

def field(shape, seed: int) -> np.ndarray:
    """A smooth saddle + parabola + ramp with uniform integer noise.
    Every term is an integer times a power of two and every partial sum
    fits float32's 24-bit significand, so no operation rounds and the
    field is bit-identical on every machine and numpy build."""
    f32 = np.float32
    rng = np.random.default_rng(seed)
    rank = len(shape)
    half = [r // 2 for r in shape]

    def pow2_at_least(m):
        return f32(2.0 ** -int(np.ceil(np.log2(max(m, 2)))))

    axes = []
    for k, r in enumerate(shape):
        sh = [1] * rank
        sh[k] = r
        axes.append((np.arange(r, dtype=f32) - f32(half[k])).reshape(sh))
    u, v, w = axes[0], axes[1], axes[-1]
    s = u * v * pow2_at_least(half[0] * half[1])
    s = s + u * u * pow2_at_least(half[0] ** 2)
    s = s + w * pow2_at_least(half[-1])
    noise = rng.integers(-100, 101, shape).astype(f32) * f32(2.0 ** -10)
    return (s + noise).astype(f32)


# name -> (shape, seed, SHA-256 of the oracle's stream, of its decode)
ORACLE = {
    "field_256": (
        (256, 256, 256), 42,
        "1be8a98323bdc1df439df6b166d2da863e3687b9368d288343031b5a0d4fb26d",
        "06d602dee1c360a975c3fc7676e85fd5abd84d000bf68d2eeb5115962ed8b89f"),
    "hurricane_100x500x500": (
        (100, 500, 500), 5,
        "74e515e2cb750fcba306414210711ce1847ca961691f96f5dfb2fd1a3fa1e40b",
        "13e09220e3ec7cba4facd18ebf21d0ac83b4b3118dcf25f72a1d4ada27d5f9d4"),
    "cesm_atm_1800x3600": (
        (1800, 3600), 6,
        "4f3d7430841f4949d87180b275066ac3767c7a8966e025623ec621c77740b4e4",
        "55922cef704e700aa34f730f9f96381dd018067bf03ee460893b223173bd32af"),
}


def field64(shape, seed: int) -> np.ndarray:
    """The float64 input: ``field`` plus noise at 2^-40 a step, below what
    float32 holds.  The sum of two multiples of 2^-40 under 2^3 in
    magnitude needs 43 bits of significand, so it is exact in float64:
    the same bits on every machine."""
    rng = np.random.default_rng(seed + 1000)
    fine = (rng.integers(-2 ** 20, 2 ** 20 + 1, shape).astype(np.float64)
            * 2.0 ** -40)
    return field(shape, seed).astype(np.float64) + fine


# name -> (shape, seed, SHA-256 of the oracle's stream, of its decode):
# field64 under ABS 1e-3
ORACLE_F64 = {
    "field64_256": (
        (256, 256, 256), 42,
        "f5f1015c95b81d67e33ed05d41550e7a9babcb1d8ae2853458689c43ae540666",
        "0a8ef9c10622feb32fda2184ae958c5679188edaea17e9de3b4fe3503092eeef"),
    "field64_cesm_atm_1800x3600": (
        (1800, 3600), 6,
        "0c5d86b89848633ed17770e28e0de5e040ff5cb54d62d7575cf15a558ceebd5b",
        "1a4185fc85c6b0d86c4be43e9941c0728901dea5379229328b19e67d4a467d0a"),
}


def pwrel_field(kind: str, shape, seed: int) -> np.ndarray:
    """The PW_REL inputs, still exact float32 arithmetic: ``field`` as
    it is (signed, with its exact zeros: the sign bitmap and the zero
    flush), or its magnitude plus 2^-6 (positive, no zeros)."""
    x = field(shape, seed)
    return x if kind == "signed" else np.abs(x) + np.float32(2.0 ** -6)


# name -> (kind, shape, seed, SHA-256 of the oracle's stream, of its
# decode), PW_REL 1e-3
ORACLE_PWREL = {
    "pwrel_signed_256": (
        "signed", (256, 256, 256), 42,
        "54dfd2598ef222221549078e1994c822de547110158d840cc6ab8c5e0b670813",
        "77735abf81917e979ae0172201215f7fb9f7c18a99a12ed8a03e53c272605eb9"),
    "pwrel_cesm_atm_1800x3600": (
        "abs", (1800, 3600), 6,
        "81f7c4fac7853065db71e776501ec0ebb1af9a996fd5450289bf6fd14b33bca2",
        "fc1270fe9591bad2c4cfb40e1f28efa1ee5684ee21c78d362a25dce38ba9b1bf"),
}


def pwrel_field64(kind: str, shape, seed: int) -> np.ndarray:
    """The float64 PW_REL inputs: ``field64`` signed, zero where ``field``
    is (the sign bitmap and the zero flush), or its magnitude plus 2^-6
    (positive, no zeros); exact in float64."""
    x = field64(shape, seed)
    if kind == "signed":
        x[field(shape, seed) == 0] = 0.0
        return x
    return np.abs(x) + 2.0 ** -6


# name -> (kind, shape, seed, SHA-256 of the oracle's stream, of its
# decode), PW_REL 1e-3 on float64 data (MSST19: K8d / K9d)
ORACLE_PWREL64 = {
    "pwrel64_signed_256": (
        "signed", (256, 256, 256), 42,
        "80e3132663cb2947c18d0b91b9499b86d31879045dcfcef605cc377d1302b34f",
        "2e53630ca59c8373bf3539de38d8a5ba27467b3c19b4fc2ca485158686291dc5"),
    "pwrel64_cesm_atm_1800x3600": (
        "abs", (1800, 3600), 6,
        "fc3434c9be4da2655210a603fb456f01419c0e86a78e81cd83bed091808c387a",
        "8603539a41bc870d051b38ef923e924950893cf4001e3cc40cbd47ea401f976f"),
}


# the random-access codec, ABS 1e-3 (K12 / K13): name -> (maker, shape,
# seed, SHA-256 of the oracle's stream, of its decode); maker "field" or
# "field_1d" (field over the shape, flattened)
ORACLE_RA = {
    "ra_256": (
        "field", (256, 256, 256), 42,
        "6147839aca2f7b68378d5c7d3a0f9824e81f784f8a0b16af4651922a879dc183",
        "68e457d1800488b62776ddba6ca7772c070d2277a70cc828b215ab5ee900681e"),
    "ra_cesm_atm_1800x3600": (
        "field", (1800, 3600), 6,
        "2cca1bd57e40c32e6e1ec1ec39232d3cb5503f026284be079345680bb9fadac0",
        "2acc85dac06d6960b71b44f6580b0308e8ecda393d3cf35bad0fe40d29aa0999"),
    "ra_1d_2^24": (
        "field_1d", (256, 256, 256), 42,
        "0fc98e2debafde0465af08b624476b0ffc068ba4defe16281719d133f815461b",
        "966932bb7e41a1c68be858beb45a6fb3ef04fcb5c695540ce8f9f1b11c267d38"),
}
# decompress_region of ra_256's stream: (start, end, SHA-256 of the
# region), the 64^3 corner (its far faces inside blocks)
ORACLE_RA_REGION = (
    (0, 0, 0), (64, 64, 64),
    "d484457307f5e07dbfc51ff9c315e5f3a0b2f673bc5b2ef7bbcefc9accc5424f")


# the multi-device slab codec, ABS 1e-3: name -> (maker, shape, seed,
# slabs, SHA-256 of the oracle's SZRA container (sz_tpu.ra.compress with
# n_slabs), of its decode); maker as in classic_input
ORACLE_SLAB = {
    "field": (
        "field", (100, 500, 500), 5, 4,
        "ef4656bebc258b7daea474ad74587b0ec80e62a708a43c40dd8055e42f3a740e",
        "8a24aa9e35ded02b1cb6121f37368f63f69fd5369863356d4c7f66d4b0f31755"),
    "field64": (
        "field64", (1800, 3600), 6, 4,
        "f3491615f32c5adb2fce20a9d6d6cd09340d16d056245e9a713687a74ef33264",
        "2813c51e6dfced89e9f918d23928f69b894850aba635e25eac0dab50591a3685"),
}


# the classic, 1-D and pre-log main path: name -> (maker, shape, seed,
# bound, config overrides, SHA-256 of the oracle's stream, of its decode).
# maker "field", "field64", "signed" (pwrel_field's signed field) or
# "field_1d" (field over the shape, flattened: field rejects rank 1)
ORACLE_CLASSIC = {
    "classic_256": (
        "field", (256, 256, 256), 42, ("ABS", ABS),
        dict(with_regression=False),
        "c13b615be281561fee1111a95fa4b6be68e89dbab1b1c730ae2473383a64e9a2",
        "3064ccbdc25cdfe83fa006c7fb85306653a245d9293d9d4bbe76059272ff5af5"),
    "classic_cesm_atm_1800x3600": (
        "field", (1800, 3600), 6, ("ABS", ABS), dict(with_regression=False),
        "a619fd4a839567b67c4bd05c1754ca1c463154da991b7be692c5a1777b207216",
        "eb87a9d8437d2e27f13ebc5dac58318bf7fb15b68323f20f6da20ddbb72e75d2"),
    "classic64_cesm_atm_1800x3600": (
        "field64", (1800, 3600), 6, ("ABS", ABS),
        dict(with_regression=False),
        "daef4825146dc4361622eb54ed431fd424c6c778f7980630a1b216e199402fe9",
        "98d5c6e5ac9f2cdea04822d75d51f74e1e28b2b5f1cae18fb845206e04c6dbf4"),
    "classic_4d_4x64x64x64": (
        "field", (4, 64, 64, 64), 9, ("ABS", ABS),
        dict(with_regression=False),
        "f9e7f4b9c6cc8eac4a319d667bcfbf3ed9f660f1912bb2f30818552696b5d4eb",
        "686a8f841cd42d2304b07b93b57af37e7e8c58fff8e178f515d2f4f2605154cf"),
    "random_access_4d_4x64x64x64": (
        "field", (4, 64, 64, 64), 9, ("ABS", ABS), dict(random_access=True),
        "6ec9dfccbd69f13de3f072923973870917f865abfefb24141ba33b41a66eeb1e",
        "23c98722926c51822da429193d6c6659053c68b6f871ae87b117ff97429898d8"),
    "classic_1d_2^24": (
        "field_1d", (256, 256, 256), 42, ("ABS", ABS), {},
        "1f757f38085927f97ec29db6e6a986a6e3af8beb2eef9f7bd379bd1819f1fe4b",
        "52d9b2322b14fa691ea5a9305ff9e8d7b0d3b99cec88adf4327059e131dbf67d"),
    "prelog_signed_256": (
        "signed", (256, 256, 256), 42, ("PW_REL", PW_REL),
        dict(accelerate_pw_rel=False),
        "159b62f65d9e4ae34a7d3c671f00b11d52fe176548e6a93a03b3685a93fa1ed8",
        "581a88cc4c73331dabda02ac19a47feac2a3664c89be291a83e2a8ad208ea041"),
    "pwrel_1e-6_cesm_atm_1800x3600": (
        "signed", (1800, 3600), 6, ("PW_REL", 1e-6), {},
        "81dc0254638a1432695df79336433b341e3b867bac13b443d17081e9439b4a06",
        "ff1e7c11e7f365dacf1bac71ec3525a34bae4afe01b4394b2bf3a1e824a47484"),
    "pwrel64_1e-6_256": (
        "field64", (256, 256, 256), 42, ("PW_REL", 1e-6), {},
        "0ab1c804691c0d2fcab09a5647a279f98b97f1cec8070ac66d4240cb903a227c",
        "86d95783b62bdc2cc40d278f04b1458c90c8f8d9f14dc50d790cda0ca6747523"),
}


def classic_input(maker: str, shape, seed: int) -> np.ndarray:
    """An ORACLE_CLASSIC field."""
    if maker == "field64":
        return field64(shape, seed)
    if maker == "signed":
        return pwrel_field("signed", shape, seed)
    x = field(shape, seed)
    return x.reshape(-1) if maker == "field_1d" else x


def classic_config(bound_: tuple, overrides: dict):
    """The sz_tpu_torch config of an ORACLE_CLASSIC case."""
    from sz_tpu_torch import ErrorBoundMode, SZConfig
    mode, value = bound_
    return SZConfig(**overrides).with_bound(getattr(ErrorBoundMode, mode),
                                           value)


def ts_step(x0: np.ndarray, s: int, seed: int) -> np.ndarray:
    """Step ``s`` of a temporal chain from ``x0`` (the chain's ``field`` or
    ``field64``): x0 plus a drift of s 2^-12, fresh noise of -16..16 times
    2^-12 (from the seed and the step), and jumps of 1.5 at a stride of
    997 from point s, which escape.  On the chain's shapes ``field`` is a
    sum of multiples of 2^-14 under 2.5 in magnitude and ``field64`` a
    sum of multiples of 2^-40 under 3; the drift, the noise and a jump
    add multiples of 2^-12 under 1.6.  So every partial sum is a multiple
    of 2^-14 under 8 (17 bits of float32's 24) or of 2^-40 under 8 (43 of
    float64's 53): no operation rounds, and the steps are the same bits
    on every machine."""
    T = x0.dtype.type
    rng = np.random.default_rng((seed, s))
    x = x0 + T(s * 2.0 ** -12)
    x += rng.integers(-16, 17, x0.shape).astype(T) * T(2.0 ** -12)
    x.reshape(-1)[s::997] += T(1.5)
    return x


# the temporal chain (phase 3; ABS 1e-3, snapshots every TS_SNAPSHOT_STEP
# steps): variable id -> (name, field maker, shape, seed): Hurricane
# ISABEL's grid in float32 and CESM-ATM's in float64
TS_VARS = {0: ("hurricane_100x500x500", field, (100, 500, 500), 5),
           1: ("cesm_atm64_1800x3600", field64, (1800, 3600), 6)}
TS_SNAPSHOT_STEP = 5
# per step (0 and 5 snapshots, 1-4 temporal): SHA-256 of the oracle's
# frame and of each variable's decode
ORACLE_TEMPORAL = (
    ("6e6f370bfdfc51d7bad883c33aeb4033f8084c202f418db3819a511b260a70e3",
     {0: "d624631903e5a3de4279a017cb510439f8d15d8bced587f589e7a922236ee894",
      1: "4f0ee7d74040363e8612ac9ffe64fdb4afb8cc0dc15e260c18292d5fde237532"}),
    ("8c50b25be73979990f9685c8712c4f633c2c4f5fe33a575bc7865f541c549d8f",
     {0: "d9da3b7981ba917153bf01de4b9b3dd056a946d99b709679aaaff4603cf8db4d",
      1: "a28ba7ff3458a5d224f447505fd562c98c5bc1a92e12eceb8f925ec834b04c1a"}),
    ("40fdc9d669d6ea68cc1cadda9229a833f7ebd5cc3716a4652c8f8e6f2721cc8f",
     {0: "203776455b630842f11453b1fa7eda749eb84538834860740b8c6763f5afb31e",
      1: "a11cdb92b5e38bf538c5fedf399d9d10b8e061247b2561edf5f476b0189e0f62"}),
    ("305a3cbd41341b78dd286dea6d2bb823a30e0804506c817ee95981538fdd1296",
     {0: "ea56d9565b18d1b7f0b1377003f1c1c1e1831f63b147343745ef43db35395831",
      1: "a7c16e3da3d4ac93b60061069ac8a8f5b2b04be0a00b6d1991624c977142873e"}),
    ("e50fd8127d100f177079d1a7fb3cee3a008ebd759d3e1e5e858176d62bc74036",
     {0: "ee71116ecde31eae4a58f607a72e5b410cbbfd8c30f45b160a90fdd9a2309c6e",
      1: "09b7ee2a71299a4786a596fc0111f13193c8e38a93f59d301e8ef9b40b8e7de5"}),
    ("c729124addc768e226dc703c52e2cec07af2141c72c60751657c74b0370611d4",
     {0: "85f09ce4b37197c06c11b84b1e8f0b9ac5e8ceb686321163d453895d09def0e7",
      1: "3442c0de7cdd0be80741bb758e19bebf0fd2b87e64c4f0bbe6936aa1c5ede3bf"}),
)


# compress_region (SZ_compress_args3, K10's subblock form) under ABS 1e-3:
# name -> (maker, field shape, seed, start, end, whether the decode holds
# the bound, SHA-256 of the oracle's stream (sz_tpu.compress_region), of
# its decode with the region's shape); "flat" is field() flattened (a 1-D
# region of 2^24 values).  The reference's quirks, which sz_tpu and the
# port keep, break the bound on two: a float32 region is encoded with the
# double precision and decoded with the float one (max error 1.2565e-3
# here), and the 1-D subblock encoder's 2a - b predictor is not the one
# the 1-D decoder replays (max error 3.43)
ORACLE_REGION = {
    "hurricane_region": (
        "field", (100, 500, 500), 5, (10, 50, 50), (90, 450, 450),
        False,
        "07063a20009cb71ef7aff7f5a87ec2ac9a31d5f879c68619063e9b3557b6b70a",
        "e8974af8f83db9bccc15cc0cfed86c277042328d89f9ae52b9626d703fc5bc47"),
    "cesm_atm64_region": (
        "field64", (1800, 3600), 6, (100, 200), (1700, 3400),
        True,
        "6801d6595c5dbfa36400eae864673c316ee4b551df9bfb73ee2e24d366b03a44",
        "ce65a038e46433c86c434d646e975e3e1794f52dcff41e9ceca6c8ec80be0736"),
    "hurricane_1d_region": (
        "flat", (100, 500, 500), 5, (12345,), (12345 + (1 << 24),),
        False,
        "36190bc52216952c4db148661ab13e6f03b5f4221766de3ae2c41862eef7c656",
        "45ad8ed651898b4ba10ff710806dad7b479a988c690098ec80f1810f82c52caf"),
}


def region_input(maker: str, shape, seed: int) -> np.ndarray:
    if maker == "field64":
        return field64(shape, seed)
    x = field(shape, seed)
    return x.reshape(-1) if maker == "flat" else x


# the ExaFEL case of tests/test_exafel.py's shape (3 events of 2 panels of
# 64 x 48, three bright peaks, a masked edge strip), its values from
# field(): SHA-256 of the oracle's stream (sz_tpu.apps.exafel), of its
# decode
EXAFEL_SHAPE = (3, 2, 64, 48)
ORACLE_EXAFEL = (
    "eebafa65221a73094deae32d926197930ef2cb7c290d09c3f911cb0fd63e4354",
    "ed270fed6dae667e6e3bd15d9991d1083a73990cfd2a2d9316987bc8c0fda0c1")


def exafel_inputs() -> tuple:
    """(data, ExaFELConfig keyword arguments) of the ExaFEL case; each
    package builds its own ExaFELConfig from them."""
    events, panels, rows, cols = EXAFEL_SHAPE
    data = (field((events * panels * rows, cols), 8).reshape(EXAFEL_SHAPE)
            * np.float32(8) + np.float32(100))
    calib = np.ones((panels, rows, cols), dtype=np.uint8)
    calib[:, :2, :] = 0
    kw = dict(calib_panel=calib,
              peaks_segs=np.array([0, 1, 1], dtype=np.uint16),
              peaks_rows=np.array([10, 30, 62], dtype=np.uint16),
              peaks_cols=np.array([12, 40, 2], dtype=np.uint16),
              bin_size=2, tolerance=0.5, sz_dim=3, peak_size=5)
    for p, r, c in zip(kw["peaks_segs"], kw["peaks_rows"], kw["peaks_cols"]):
        data[:, p, max(r - 2, 0):r + 3, max(c - 2, 0):c + 3] += np.float32(
            500)
    return data, kw


def ts_chain_inputs() -> dict:
    """{variable id: [its input at each step of ORACLE_TEMPORAL]}."""
    out = {}
    for vid, (_, make, shape, seed) in TS_VARS.items():
        x0 = make(shape, seed)
        out[vid] = [ts_step(x0, s, seed) for s in range(len(ORACLE_TEMPORAL))]
    return out


def ts_compressors(dev) -> tuple:
    """An encoder and a decoder of the temporal chain on ``dev``."""
    from sz_tpu_torch import ErrorBoundMode, SZConfig
    from sz_tpu_torch.temporal import TemporalCompressor
    cfg = SZConfig().with_bound(ErrorBoundMode.ABS, ABS)
    pair = (TemporalCompressor(TS_SNAPSHOT_STEP, device=dev),
            TemporalCompressor(TS_SNAPSHOT_STEP, device=dev))
    for c in pair:
        for vid, (name, make, shape, _) in TS_VARS.items():
            c.register(vid, name, shape,
                       np.float64 if make is field64 else np.float32, cfg)
    return pair


def sha256(b) -> str:
    return hashlib.sha256(b).hexdigest()


# --- timing and comparison helpers ----------------------------------------

def cuda_ms(fn, reps: int) -> float:
    """Mean device milliseconds of fn() over reps runs, after one warm-up."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def bit_equal(a, b) -> bool:
    import torch
    if a.dtype == torch.float32:
        return torch.equal(a.view(torch.int32), b.view(torch.int32))
    return torch.equal(a, b)


def max_abs_err(a, b) -> float:
    """0.0 for bit-equal tensors, else the largest |a - b| (NaN counts as
    infinitely far)."""
    if bit_equal(a, b):
        return 0.0
    return float((a.double() - b.double()).abs().nan_to_num(float("inf"))
                 .max())


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts if t is not None)


def bound(moved_bytes: int, ops: int = 0, ops64: int = 0) -> tuple:
    """(least ms, what bounds it): the bytes the function must move over
    the memory rate, or its 32-bit and 64-bit operations over their peak
    rates."""
    tb = moved_bytes / HBM_BYTES_PER_S
    to = ops / OPS_PER_S_32BIT + ops64 / OPS_PER_S_64BIT
    return 1e3 * max(tb, to), ("bytes" if tb >= to else "operations")


# --- phase 2: K1-K4 -------------------------------------------------------

RADIUS = 32


def k1_scalars(T=np.float32) -> tuple:
    """(rp, recip, cap_szf, radius, mean) of the K1/K1d cases, in T."""
    rp = T(1e-3)
    return rp, T(T(1) / rp), T(2 * RADIUS - 2), RADIUS, T(0.25)



def k1_inputs(shape, seed, dev, regression: str = "mixed", T=np.float32):
    """K1's (K1d's, T = float64) inputs: a field with 10 % of its points
    at the mean, and regression points on 30 % of the points ("mixed"),
    on all or on none."""
    import torch
    rp, _, _, _, mean = k1_scalars(T)
    rng = np.random.default_rng(seed)
    n = int(np.prod(shape))
    data = (np.sin(np.linspace(0, 12, n, dtype=T))
            + 0.02 * rng.standard_normal(n)).astype(T).reshape(shape)
    data[rng.random(shape) < 0.1] = mean
    reg = rng.random(shape) < 0.3
    if regression != "mixed":
        reg = np.full(shape, regression == "all")
    # regression points: codes >= 1 (an escaped one would carry rec = data)
    t_reg = rng.integers(1, 2 * RADIUS, shape).astype(np.int32)
    rec_reg = (data + rng.uniform(-1e-3, 1e-3, shape)).astype(T)
    mean_mask = (~reg) & (np.abs(data - mean) <= rp)
    return [torch.from_numpy(a).to(dev)
            for a in (data, t_reg, rec_reg, reg, mean_mask)]


def k2_inputs(k1_args, t, use_mean: bool):
    """K2's (K2d's) inputs as a decoder derives them from K1's type
    lattice t (stages.decode_inputs): then K2 must rebuild K1's R bit for
    bit."""
    import torch
    data, _, rec_reg, reg, _ = k1_args
    rp, _, _, _, mean = k1_scalars(
        np.float64 if data.dtype == torch.float64 else np.float32)
    esc = t == 0
    t_adj = t
    known_mask = esc | reg
    if use_mean:
        t_adj = torch.where((~reg) & (t < RADIUS), t + 1, t)
        known_mask = known_mask | ((~reg) & (t == RADIUS))
    q_lor = (2 * (t_adj - RADIUS)).to(data.dtype) * torch.tensor(
        rp, device=t.device)
    known = torch.where(esc, data, torch.where(reg, rec_reg, torch.tensor(
        mean, device=t.device)))
    return known_mask, known, q_lor


def fib_tables():
    """A Huffman table whose codes run past 32 and past 64 bits."""
    from sz_tpu_torch.format import huffman
    fib = [1, 1]
    while len(fib) < 90:
        fib.append(fib[-1] + fib[-2])
    freq = np.zeros(256, np.int64)
    freq[:90] = fib
    return huffman.build_tables(None, 128, freq=freq)


def u64_tensor(a, dev):
    import torch
    return torch.from_numpy(np.ascontiguousarray(
        a, np.uint64).view(np.int64)).to(dev)


def cuda_once(fn) -> tuple:
    """(fn(), device milliseconds of that one call)."""
    import torch
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end)


# (shape, use_mean, regression points): the earlier cases, then what a
# tiled kernel can get wrong -- shapes that are no multiple of a tile,
# shapes smaller than one tile, a single row along each axis, and
# lattices that are all regression or have none
LORENZO_EXACT = [
    ((64, 64, 64), False, "mixed"), ((64, 64, 64), True, "mixed"),
    ((25, 14, 20), True, "mixed"), ((150, 130), False, "mixed"),
    ((3, 5, 7), False, "mixed"), ((3, 5, 7), True, "mixed"),
    ((1, 1, 4097), True, "mixed"), ((4097, 1, 1), False, "mixed"),
    ((1, 4097, 1), True, "mixed"),
    ((33, 9, 65), False, "mixed"), ((33, 9, 65), True, "mixed"),
    ((2, 3, 2), True, "mixed"), ((7, 20), False, "mixed"),
    ((1, 4097), True, "mixed"), ((4097, 1), False, "mixed"),
    ((33, 9, 65), True, "all"), ((33, 9, 65), False, "none"),
    ((100, 300), False, "all"), ((100, 300), True, "none"),
]
# K1d/K2d's strips on their ragged edges (shared with
# tests/test_torch_f64_strips.py, the CPU model of the walk): strips of
# 31, 33 and 65 rows, plane counts no multiple of a block's warps, rows of
# 1, 2, CHUNK - 1 and CHUNK + 1 columns, one row, one plane, regression
# on all, none or some points, the mean flush on and off
LORENZO_F64_EDGES = [
    ((7, 31, 20), True, "mixed"), ((13, 33, 17), False, "mixed"),
    ((6, 65, 15), True, "none"), ((11, 9, 1), True, "mixed"),
    ((8, 40, 2), False, "all"), ((4, 1, 70), True, "mixed"),
    ((1, 70, 24), True, "mixed"), ((9, 33, 16), True, "none"),
    ((21, 97, 301), True, "mixed"), ((70, 33), False, "mixed"),
    ((65, 17), False, "none"), ((1, 100), False, "mixed"),
    ((200, 31), False, "all"), ((131, 3001), False, "mixed"),
]
# the shapes the ABS main path runs K1/K2 at (phases 3 and 4), timed
LORENZO_TIMED = [(256, 256, 256), (100, 500, 500), (1800, 3600),
                 (512, 512, 512)]
# and K1d/K2d, on the float64 main path's shapes
LORENZO_TIMED_F64 = [(256, 256, 256), (1800, 3600), (512, 512, 512)]
# above this many points the plain versions (a second and more from 2^20
# points on, minutes at 512^3) run only on a leading box of the lattice,
# :func:`plain_box`: no point depends on a later plane, row or column, so
# the kernel's box must equal the plain version's on the box alone.
# K1/K2: two layers of 3-D tiles and a plane of the third; K1d/K2d: two
# plane groups of the widest block and a plane of the third; so that two
# hand-offs along i are held against the plain version.  Their time on
# the box is what the kernel record's plain_ms holds (plain_shape).
PLAIN_MAX_POINTS = 1 << 20
# a 2-D box: two strip units of the widest rank-2 block (6 warps of 32
# rows) and a row, and columns across several chunks and tiles; a plane
# of a 3-D box: two strips and a row (four 3-D tiles and a row), and the
# same columns
PLAIN_BOX_2D = (385, 300)
PLAIN_BOX_3D = (65, 300)


def plain_box(shape, lead: int) -> tuple:
    """The index of the box the plain versions run on: the whole lattice
    up to PLAIN_MAX_POINTS, else PLAIN_BOX_2D's rows and columns (rank
    2), the first ``lead`` planes of PLAIN_BOX_3D's (rank 3), or those of
    its first two volumes (rank 4).  A plain version steps a diagonal at
    a time, so its time goes with the box's sum of sides."""
    if int(np.prod(shape)) <= PLAIN_MAX_POINTS:
        return (slice(None),)
    if len(shape) == 2:
        return tuple(slice(0, r) for r in PLAIN_BOX_2D)
    plane = tuple(slice(0, r) for r in PLAIN_BOX_3D)
    if len(shape) == 4:
        return (slice(0, 2), slice(0, lead)) + plane
    return (slice(0, lead),) + plane


# the long single rows and columns of the K8/K9 and K10/K11 cases: past
# 16 tiles of 96 columns (K8/K9) and 96 chunks of 16 (K10/K11), whose
# plain versions step one diagonal a point along them
LONG_ROW = 16 * 96 + 1


def plain_planes(wide: bool) -> int:
    """The first planes the plain versions run on above PLAIN_MAX_POINTS."""
    from sz_tpu_torch.gpu import lorenzo_kernel as lk
    if wide:
        return 2 * max(lk.WARPS_F64[k, 3] for k in ("quantize", "decode")) + 1
    return 2 * lk.TILE3[0] + 1


def lorenzo_case(dev, shape, use_mean, regression, timed,
                 T=np.float32) -> dict:
    """K1 and K2 (K1d and K2d where T is float64) against their plain
    versions on one lattice: K2 on the inputs a decoder derives from K1's
    output, so it must also rebuild K1's R; each kernel called twice,
    bit-equal, K1d's types also without R.  Timed: the kernels' mean time
    (K1d without R, as the main path calls it, and with it), the plain
    version's one call, the bound."""
    from sz_tpu_torch.gpu import lorenzo_kernel as lk
    wide = T is np.float64
    k1_name, k2_name = (("K1d", "K2d") if wide else ("K1", "K2"))
    scal = k1_scalars(T)
    args = k1_inputs(shape, 1, dev, regression, T)
    if not use_mean:
        args[4] = None
    n = int(np.prod(shape))
    whole = n <= PLAIN_MAX_POINTS
    sub = plain_box(shape, plain_planes(wide))

    def k1(want_R=True):
        return lk.wavefront_quantize(*args, *scal, use_mean=use_mean,
                                     want_R=want_R)

    t_k, R_k = k1()
    t_2, R_2 = k1()
    again = bit_equal(t_k, t_2) and bit_equal(R_k, R_2)
    del t_2, R_2
    t_n = k1(False)
    no_R_same = bit_equal(t_n, t_k) and bit_equal(k1(False), t_k)
    del t_n
    part = [a[sub].contiguous() if a is not None else None for a in args]
    (t_p, R_p), plain_ms = cuda_once(lambda: lk.quantize_plain(
        *part, *scal, use_mean=use_mean))
    err = max(max_abs_err(t_k[sub], t_p), max_abs_err(R_k[sub], R_p))
    row = dict(kernels=f"{k1_name}/{k2_name}", dtype=np.dtype(T).name,
               shape=list(shape), use_mean=use_mean, regression=regression,
               plain_on=list(t_p.shape), K1_bit_equal=err == 0.0,
               K1_repeat_bit_equal=again, K1_types_without_R_equal=no_R_same,
               K1_max_abs_err=err)
    entries = {}
    sfx = "_f64" if wide else ""
    if timed:
        if wide:   # the main path asks for no R
            ms = cuda_ms(lambda: k1(False), 5 if whole else 3)
            b_ms, b_by = bound(nbytes(*args, t_k))
            row["K1"] = dict(ms=ms, ms_with_R=cuda_ms(k1, 5 if whole else 3),
                             plain_ms=plain_ms, bound_ms=b_ms,
                             bound_with_R_ms=bound(nbytes(*args, t_k, R_k))[0])
        else:      # K1 reads its five inputs and writes t and R
            ms = cuda_ms(k1, 5 if whole else 3)
            b_ms, b_by = bound(nbytes(*args, t_k, R_k))
            row["K1"] = dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms)
        entries["wavefront_quantize" + sfx] = dict(
            max_abs_err=err, ms=ms, plain_ms=plain_ms,
            plain_shape=row["plain_on"], bound_ms=b_ms, bound_by=b_by,
            library_ms=None, shape=list(shape))
    del t_p, R_p, part
    dec = k2_inputs(args, t_k, use_mean)
    del args, t_k
    D_k = lk.wavefront_decode(*dec)
    again = bit_equal(D_k, lk.wavefront_decode(*dec))
    part = [a[sub].contiguous() for a in dec]
    D_p, plain_ms = cuda_once(lambda: lk.decode_plain(*part))
    err = max_abs_err(D_k[sub], D_p)
    row.update(K2_bit_equal=err == 0.0, K2_repeat_bit_equal=again,
               K2_rebuilds_K1_R=bit_equal(D_k, R_k), K2_max_abs_err=err)
    del D_p, part, R_k
    if timed:
        ms = cuda_ms(lambda: lk.wavefront_decode(*dec), 5 if whole else 3)
        b_ms, b_by = bound(nbytes(*dec, D_k))
        row["K2"] = dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms)
        entries["wavefront_decode" + sfx] = dict(
            max_abs_err=err, ms=ms, plain_ms=plain_ms,
            plain_shape=row["plain_on"], bound_ms=b_ms, bound_by=b_by,
            library_ms=None, shape=list(shape))
    _log(f"kernel {k1_name}/{k2_name} vs plain", **row)
    if not all(row[k] for k in ("K1_bit_equal", "K1_repeat_bit_equal",
                                "K1_types_without_R_equal", "K2_bit_equal",
                                "K2_repeat_bit_equal", "K2_rebuilds_K1_R")):
        raise AssertionError(f"{k1_name}/{k2_name} differ from their plain "
                             f"versions or from each other: {row}")
    return row, entries


def lorenzo_tiles(ptxas: list) -> list:
    """K1/K2 on each tile shape: ptxas's registers and spills of the
    instantiation (its mangled name holds LorenzoTileILi<rank>E)."""
    from sz_tpu_torch.gpu import lorenzo_kernel as lk
    rows = []
    for name in ("wavefront_quantize_kernel", "wavefront_decode_kernel"):
        for rank, tile in ((3, lk.TILE3), (2, lk.TILE2)):
            tag = f"{len(name)}{name}I"
            key = f"LorenzoTileILi{rank}E"
            regs = spill = None
            for i, ln in enumerate(ptxas):
                if tag in ln and key in ln:
                    for nxt in ptxas[i + 1:i + 3]:
                        if "registers" in nxt:
                            regs = int(nxt.split("Used ")[1].split()[0])
                        if "spill" in nxt:
                            spill = nxt.strip()
            rows.append(dict(kernel=name, rank=rank, tile=list(tile),
                             threads=tile[0] * tile[1],
                             registers=regs, spill=spill))
    for row in rows:
        _log("K1/K2 tiles", **row)
    return rows


def ptxas_of(ptxas: list, name: str) -> tuple:
    """(registers, spill line) ptxas reports for the kernel ``name``."""
    regs = spill = None
    for i, ln in enumerate(ptxas):
        if "Compiling entry" in ln and f"{len(name)}{name}" in ln:
            for nxt in ptxas[i + 1:i + 4]:
                if "registers" in nxt and regs is None:
                    regs = int(nxt.split("Used ")[1].split()[0])
                if "spill" in nxt and spill is None:
                    spill = nxt.strip()
    return regs, spill


def lorenzo_strip_report(ptxas: list) -> list:
    """K1d/K2d's four kernels: ptxas's registers and spills, the block's
    warps, ring slots and dynamic shared memory (lorenzo_kernel's mirror
    of strips.cuh shared_bytes)."""
    from sz_tpu_torch.gpu import lorenzo_kernel as lk
    rows = []
    for kind in ("quantize", "decode"):
        for rank in (2, 3):
            name = f"wavefront_{kind}{rank}d_f64_kernel"
            regs, spill = ptxas_of(ptxas, name)
            rows.append(dict(kernel=name, warps=lk.WARPS_F64[kind, rank],
                             ring=lk.RING_F64[rank],
                             shared_bytes=lk.shared_bytes_f64(kind, rank),
                             registers=regs, spill=spill))
    for row in rows:
        _log("K1d/K2d strips", **row)
    return rows


def phase_lorenzo(dev) -> tuple:
    """Phase 2, K1/K2 and K1d/K2d.  Returns (rows, record entries at
    256^3)."""
    import torch
    rows, entries = [], {}
    for T, timed_shapes, edges in ((np.float32, LORENZO_TIMED, []),
                                   (np.float64, LORENZO_TIMED_F64,
                                    LORENZO_F64_EDGES)):
        for shape, use_mean, regression in LORENZO_EXACT + edges:
            rows.append(lorenzo_case(dev, shape, use_mean, regression, False,
                                     T)[0])
        for shape in timed_shapes:
            row, ent = lorenzo_case(dev, shape, True, "mixed", True, T)
            rows.append(row)
            if shape == (256, 256, 256):
                entries.update(ent)
            torch.cuda.empty_cache()
    return rows, entries


# K3/K4 edge cases, shared with tests/test_torch_pack_tiles.py (the CPU
# model of the kernels' decomposition) and tests/test_torch_gpu.py

def edge_code_table():
    """(code_hi, code_lo, code_len) of 10 symbols with codes of 1, 31, 32,
    33, 64, 65, 128, 7, 3 and 12 bits, random bits MSB-aligned (a pack
    needs no prefix code)."""
    rng = np.random.default_rng(17)
    lens = np.array([1, 31, 32, 33, 64, 65, 128, 7, 3, 12], np.int32)
    hi, lo = (rng.integers(0, 2 ** 64, len(lens), dtype=np.uint64,
                           endpoint=False) for _ in range(2))

    def keep(v, k):   # the top k of 64 bits
        k = np.clip(k, 0, 64).astype(np.uint64)
        mask = np.where(k == 0, np.uint64(0), ~np.uint64(0) << (
            np.uint64(64) - np.maximum(k, np.uint64(1))))
        return v & mask

    return keep(hi, lens), keep(lo, lens - 64), lens


# the names of pack_cases() and hist_cases(), in order: the tests
# parametrize on them without building the cases at import
PACK_CASE_NAMES = (
    "empty", "one_symbol_128_bits", "all_holes", "hot_word_1_bit",
    "every_code_length", "past_the_table", "zipf_41_tiles", "mixed_7",
    "mixed_9", "mixed_2047", "mixed_2048", "mixed_2049")
HIST_CASE_NAMES = (
    "clustered", "cluster_wrong_hint", "hint_below_the_bins", "heavy_zero",
    "single_bin", "outermost_bins_low_hint", "outermost_bins_high_hint",
    "hint_past_the_bins", "empty", "one", "seven")


def code_bits(sym: np.ndarray, code_len: np.ndarray) -> int:
    """The bits a table codes symbols into (holes and symbols past the
    table take none): K4's total_bits."""
    valid = (sym >= 0) & (sym < len(code_len))
    return int(np.where(valid, code_len[np.where(valid, sym, 0)], 0)
               .astype(np.int64).sum())


def at_offset(sym: np.ndarray, shift: int, dev):
    """sym on the card, starting `shift` int32s into its buffer (shift
    1-3: unaligned for 16-byte loads)."""
    import torch
    buf = torch.from_numpy(np.concatenate([np.zeros(shift, np.int32), sym]))
    return buf.to(dev)[shift:]


def pack_cases() -> list:
    """(name, int32 symbols, (code_hi, code_lo, code_len)) of K4's edge
    cases: the tile and run sizes of csrc/pack.cu, every code length the
    table width allows, holes and symbols past the table, the hottest
    word, and a real Huffman table over 41 tiles and a partial one."""
    from sz_tpu_torch.format import huffman
    from sz_tpu_torch.gpu import pack_kernel as pk
    rng = np.random.default_rng(19)
    edge = edge_code_table()
    nst = len(edge[2])

    def mixed(n):   # holes, every code, symbols past the table
        return rng.integers(-1, nst + 3, n).astype(np.int32)

    zipf = _zipf(rng, 41 * pk.TILE + 3, 300, 1.3)
    t = huffman.build_tables(zipf, 300)
    zipf[rng.random(len(zipf)) < 0.05] = -1
    real = (t.code_hi, t.code_lo, t.code_len.astype(np.int32))
    cases = [
        ("empty", np.zeros(0, np.int32), edge),
        ("one_symbol_128_bits", np.array([6], np.int32), edge),
        ("all_holes", np.full(3000, -1, np.int32), edge),
        ("hot_word_1_bit", np.zeros(5 * pk.TILE + 17, np.int32), edge),
        ("every_code_length", np.tile(np.arange(nst, dtype=np.int32),
                                      3 * pk.TILE // nst + 1), edge),
        ("past_the_table", np.where(rng.random(5000) < 0.01, 3, nst + 7)
         .astype(np.int32), edge),
        ("zipf_41_tiles", zipf, real),
    ]
    for n in (pk.RUN - 1, pk.RUN + 1, pk.TILE - 1, pk.TILE, pk.TILE + 1):
        cases.append((f"mixed_{n}", mixed(n), edge))
    return cases


def hist_cases() -> list:
    """(name, int32 symbols, quantizer radius) of K3's edge cases: a
    clustered stream with outliers and the right hint, or one below the
    bins, and without them and a hint whose window holds no symbol, heavy
    symbol 0,
    one bin, holes and symbols past the bins, the outermost bins, and
    lengths that are no multiple of the 16-byte vector."""
    rng = np.random.default_rng(23)
    n = 100_003
    cluster = np.clip(rng.normal(32768, 30, n), -1, 70000).astype(np.int32)
    clustered = cluster.copy()
    clustered[rng.integers(0, n, n // 64)] = rng.integers(0, 65536, n // 64)
    heavy_zero = clustered.copy()
    heavy_zero[rng.random(n) < 0.6] = 0
    ends = rng.choice(np.array([0, 1, 2, 65534, 65535, 65536, -5],
                               np.int32), 9999)
    return [
        ("clustered", clustered, 32768),
        ("cluster_wrong_hint", cluster, 5),
        ("hint_below_the_bins", clustered, -3),
        ("heavy_zero", heavy_zero, 32768),
        ("single_bin", np.full(n, 512, np.int32), 512),
        ("outermost_bins_low_hint", ends, 1),
        ("outermost_bins_high_hint", ends, 65535),
        ("hint_past_the_bins", ends, 1 << 20),
        ("empty", np.zeros(0, np.int32), 32768),
        ("one", np.array([7], np.int32), 7),
        ("seven", np.arange(7, dtype=np.int32), 3),
    ]


def phase_pack_hist_cases(dev) -> list:
    """Phase 2, K3/K4 edge cases on the card, each also from the second,
    third and fourth int32 of its buffer (unaligned 16-byte loads), and
    K3 on a 2^27-symbol single-bin stream: bit-equal to the plain
    versions."""
    import torch
    from sz_tpu_torch.gpu import hist_kernel as hk
    from sz_tpu_torch.gpu import pack_kernel as pk
    rows = []
    for name, sym, radius in hist_cases():
        ok = True
        for shift in range(4):
            s = at_offset(sym, shift, dev)
            ok &= torch.equal(hk.histogram(s, radius),
                              hk.histogram_plain(s))
        rows.append(dict(kernel="K3", case=name, n=len(sym), radius=radius,
                         bit_equal=ok))
    s = torch.full((1 << 27,), 32768, dtype=torch.int32, device=dev)
    h, ms = cuda_once(lambda: hk.histogram(s, 32768))
    rows.append(dict(kernel="K3", case="single_bin_2^27", n=s.numel(),
                     bit_equal=torch.equal(h, hk.histogram_plain(s)),
                     ms=ms))
    del s, h
    for name, sym, (hi, lo, ln) in pack_cases():
        total = code_bits(sym, ln)
        tab = (u64_tensor(hi, dev), u64_tensor(lo, dev),
               torch.from_numpy(ln).to(dev))
        ok = True
        for shift in range(4):
            s = at_offset(sym, shift, dev)
            ok &= torch.equal(pk.pack_bits(s, *tab, total),
                              pk.pack_bits_plain(s, *tab, total))
        rows.append(dict(kernel="K4", case=name, n=len(sym),
                         total_bits=total, bit_equal=ok))
    for row in rows:
        _log("kernel K3/K4 edge case", **row)
    bad = [r["case"] for r in rows if not r["bit_equal"]]
    if bad:
        raise AssertionError(f"K3/K4 differ from their plain versions: "
                             f"{bad}")
    torch.cuda.empty_cache()
    return rows


def phase_kernels(dev) -> dict:
    """Phase 2, K3 and K4 at their 2^24-symbol test shapes: kernel vs
    plain version on the card.  Returns the per-kernel record entries."""
    import torch
    from sz_tpu_torch.gpu import hist_kernel as hk
    from sz_tpu_torch.gpu import pack_kernel as pk

    entries = {}
    rng = np.random.default_rng(3)
    n = 1 << 24
    sym = np.clip(rng.normal(32768, 20, n), 0, 65535).astype(np.int32)
    sym[rng.integers(0, n, n // 64)] = rng.integers(0, 65536, n // 64)
    sym[rng.random(n) < 0.02] = -1
    sym_d = torch.from_numpy(sym).to(dev)
    entries["histogram"] = hist_timing("2^24", sym_d, 32768)

    tables = fib_tables()
    assert int(tables.code_len.max()) > 64
    s = rng.integers(-1, 90, n).astype(np.int32)
    total_bits = int(np.where(s >= 0, tables.code_len[np.maximum(s, 0)],
                              0).astype(np.int64).sum())
    s_d = torch.from_numpy(s).to(dev)
    hi, lo = u64_tensor(tables.code_hi, dev), u64_tensor(tables.code_lo, dev)
    ln = torch.from_numpy(tables.code_len.astype(np.int32)).to(dev)
    entries["pack_bits"] = pack_timing("2^24 Fibonacci table",
                                       (s_d, hi, lo, ln, total_bits), 10)
    return entries


def hist_timing(name: str, sym, radius: int) -> dict:
    """K3 on one symbol stream with the quantizer radius as its window
    hint, against its plain version and torch.bincount; raises unless all
    three agree."""
    import torch
    from sz_tpu_torch.gpu import hist_kernel as hk
    h_k = hk.histogram(sym, radius)
    h_p = hk.histogram_plain(sym)
    err, ok = max_abs_err(h_k, h_p), torch.equal(h_k, h_p)
    ms = cuda_ms(lambda: hk.histogram(sym, radius), 10)
    plain_ms = cuda_ms(lambda: hk.histogram_plain(sym), 3)
    # the library yardstick: torch.bincount on the in-range symbols
    # (bincount refuses the negative holes, so they are dropped first)
    valid = sym[(sym >= 0) & (sym < hk.NBINS)]
    if not torch.equal(torch.bincount(valid, minlength=hk.NBINS).to(
            torch.int32), h_k):
        raise AssertionError(f"torch.bincount disagrees with K3 ({name})")
    library_ms = cuda_ms(lambda: torch.bincount(valid, minlength=hk.NBINS),
                         3)
    del valid
    b_ms, b_by = bound(nbytes(sym, h_k))
    # where the symbols fell: the most frequent bin, symbol 0, the rest
    h = h_p.double()
    top = int(h.argmax())
    _log(f"kernel K3 histogram, {name}", n=sym.numel(), bit_equal=ok,
         max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=library_ms,
         bound_ms=b_ms, hint=radius, top_bin=top,
         top_bin_share=float(h[top] / max(h.sum(), 1)),
         zero_share=float(h[0] / max(h.sum(), 1)))
    if not ok:
        raise AssertionError(f"K3 differs from its plain version ({name})")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by, library_ms=library_ms,
                shape=[sym.numel()])


def pack_timing(name: str, args: tuple, plain_reps: int = 1) -> dict:
    """K4 on (symbols, code_hi, code_lo, code_len, total_bits) against
    its plain version; raises unless they agree."""
    import torch
    from sz_tpu_torch.gpu import pack_kernel as pk
    sym, hi, lo, ln, total_bits = args
    b_k = pk.pack_bits(*args)
    b_p = pk.pack_bits_plain(*args)
    err, ok = max_abs_err(b_k, b_p), torch.equal(b_k, b_p)
    ms = cuda_ms(lambda: pk.pack_bits(*args), 10)
    plain_ms = cuda_ms(lambda: pk.pack_bits_plain(*args), plain_reps)
    del b_p
    b_ms, b_by = bound(nbytes(sym, hi, lo, ln, b_k))
    _log(f"kernel K4 pack_bits, {name}", n=sym.numel(),
         total_bits=total_bits, bits_per_symbol=total_bits / max(
             sym.numel(), 1), max_code_bits=int(ln.max()), bit_equal=ok,
         max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms)
    if not ok:
        raise AssertionError(f"K4 differs from its plain version ({name})")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by, library_ms=None, shape=[sym.numel()])


def largest_calls(fn):
    """(fn(), {"histogram": args, "pack_bits": args}): run fn() (one
    compress) and keep the arguments of K3's and K4's call on the most
    symbols, as the main path passed them.  A profile hook sees the
    wrappers' calls, so nothing is replaced."""
    from sz_tpu_torch.gpu import hist_kernel as hk
    from sz_tpu_torch.gpu import pack_kernel as pk
    codes = {hk.histogram.__code__: "histogram",
             pk.pack_bits.__code__: "pack_bits"}
    got = {}

    def hook(frame, event, arg):
        name = codes.get(frame.f_code) if event == "call" else None
        if name:
            c = frame.f_code
            args = tuple(frame.f_locals[v]
                         for v in c.co_varnames[:c.co_argcount])
            if name not in got or args[0].numel() > got[name][0].numel():
                got[name] = args

    old = sys.getprofile()
    sys.setprofile(hook)
    try:
        out = fn()
    finally:
        sys.setprofile(old)
    return out, got


def pack_hist_timing(calls: dict) -> dict:
    """Phase 4, K3 and K4 timed on the main path's own inputs: {stream:
    largest_calls' arguments of its compress}, emptied as it goes.
    Returns the first stream's entries (512^3 ABS)."""
    import torch
    first = None
    for name in list(calls):
        got = calls.pop(name)
        entries = {"histogram": hist_timing(name, *got["histogram"]),
                   "pack_bits": pack_timing(name, got["pack_bits"])}
        first = first or entries
        del got
        torch.cuda.empty_cache()
    return first


# --- phase 2: K5-K7 -------------------------------------------------------

def _zipf(rng, n, nstate, a):
    p = 1.0 / np.arange(1, nstate + 1) ** a
    return rng.choice(nstate, size=n, p=p / p.sum()).astype(np.int32)


def _on_card(t, enc, dev):
    """The coded stream (``fsm_kernel.upload``) on the card for the tree
    of tables ``t`` (or an (L, R, C, T) tuple) and the coded bytes
    ``enc`` (a uint8 tensor on the card)."""
    from sz_tpu_torch.gpu import fsm_kernel as fk
    L, R, C, T = (t.L, t.R, t.C, t.T) if hasattr(t, "L") else t
    return fk.upload((L, R, C, T, len(L)), enc, dev)


def _packed_on_card(types, nstate, dev):
    """(tables, on-card stream as _on_card gives it): the types
    Huffman-coded by K4 (checked against the plain K4 in phase 2)."""
    import torch
    from sz_tpu_torch.format import huffman
    from sz_tpu_torch.gpu import pack_kernel as pk
    t = huffman.build_tables(types, nstate)
    total = int(t.code_len[types].astype(np.int64).sum())
    enc = pk.pack_bits(torch.from_numpy(types).to(dev),
                       u64_tensor(t.code_hi, dev), u64_tensor(t.code_lo, dev),
                       torch.from_numpy(t.code_len.astype(np.int32)).to(dev),
                       total)
    return t, _on_card(t, enc, dev)


def fsm_vs_plain(name, stream, n_sym, want=None, node_count=None) -> dict:
    """K5, K6 and K7 against their plain versions on one stream (n_sym
    None: decode every symbol the stream codes), and the whole decode
    timed, with K6's launches in one decode."""
    import torch
    from sz_tpu_torch.gpu import fsm_kernel as fk
    trans, bits, total_bits, depth = (stream.trans, stream.bits,
                                      stream.total_bits, stream.depth)
    gk, nk = fk.fsm_sweep(stream)
    gp, np_ = fk.fsm_sweep_plain(bits, trans, total_bits, depth)
    ok = {"K5": torch.equal(gk, gp) and torch.equal(nk, np_)}
    del gp, np_
    entry, off, total = fk.fsm_scan(gk, nk)
    ok["K6"] = all(torch.equal(a, b) for a, b in zip(
        (entry, off, total), fk.fsm_scan_plain(gk, nk)))
    total = int(total)
    chunks = gk.shape[0]
    del gk, nk
    n = total if n_sym is None else n_sym
    sk = fk.fsm_emit(stream, entry, off, n)
    sp = fk.fsm_emit_plain(bits, trans, total_bits, depth, entry, off, n)
    ok["K7"] = torch.equal(sk, sp)
    ok["count"] = n <= total <= n + 7
    if want is not None:
        ok["decodes_input"] = torch.equal(
            sk, want if torch.is_tensor(want) else
            torch.from_numpy(want).to(sk.device))
    del sp
    k6 = fk.fsm_scan.launches
    fk.decode_coded(stream, n, bits.device)
    k6 = fk.fsm_scan.launches - k6
    ok["one_K6_launch"] = k6 == 1
    decode_ms = cuda_ms(lambda: fk.decode_coded(stream, n, bits.device), 3)
    row = dict(case=name, node_count=node_count or trans.numel() // 2,
               longest_code=depth, chunk_bits=fk.chunk_bits(depth),
               lut_bits=stream.lut.numel().bit_length() - 1,
               total_bits=total_bits, chunks=chunks,
               scan_tile=fk.scan_tile(depth), symbols=n,
               k6_launches_a_decode=k6, decode_ms=decode_ms, **ok)
    _log("kernel K5-K7 vs plain", **row)
    if not all(ok.values()):
        raise AssertionError(f"K5-K7 differ from their plain versions on "
                             f"{name}: {ok}")
    return row


def scan_maps(kind: str, L: int, D: int, seed: int, dev):
    """Synthetic K5-shaped maps on ``dev``: random entries, a permutation
    a chunk (composites never converge), one entry a chunk, or random
    entries with counts of 2^31 and more."""
    import torch
    gen = torch.Generator(device=dev).manual_seed(seed)
    if kind == "permutation":
        g = torch.rand((L, D), generator=gen, device=dev).argsort(dim=1)
    elif kind == "constant":
        g = torch.randint(0, D, (L, 1), generator=gen,
                          device=dev).expand(L, D).contiguous()
    else:
        g = torch.randint(0, D, (L, D), generator=gen, device=dev)
    lo, hi = (1 << 31, 1 << 33) if kind == "big_counts" else (0, 1000)
    n = torch.randint(lo, hi, (L, D), generator=gen, device=dev)
    return g.to(torch.int32), n


def phase_scan_cases(dev) -> list:
    """K6 against its plain version on synthetic maps: thousands of tiles
    (the look-back meets aggregates and steps back window by window),
    maps that never converge, counts past 2^31 in every chunk, the
    largest windowed depth and the wide path (D > 63)."""
    import torch
    from sz_tpu_torch.gpu import fsm_kernel as fk
    rows = []
    for kind, L, D in (("random", 1_000_003, 28),
                       ("permutation", 1_000_003, 28),
                       ("big_counts", 400_001, 63),
                       ("permutation", 20_001, 1),
                       ("random", 30_001, 64),
                       ("permutation", 5_001, 1100)):
        g, n = scan_maps(kind, L, D, L + D, dev)
        want = fk.fsm_scan_plain(g, n)
        ok = all(all(torch.equal(a, b) for a, b in zip(fk.fsm_scan(g, n),
                                                        want))
                 for _ in range(2))
        row = dict(case=f"{kind}_{L}x{D}", tile=fk.scan_tile(D),
                   tiles=-(-L // fk.scan_tile(D)),
                   ms=cuda_ms(lambda: fk.fsm_scan(g, n), 3),
                   total=int(want[2]), equal=ok)
        _log("kernel K6 vs plain, synthetic maps", **row)
        if not ok:
            raise AssertionError(f"K6 differs from its plain version on "
                                 f"{row['case']}")
        rows.append(row)
        del g, n, want
    torch.cuda.empty_cache()
    return rows


def _caterpillar(depth):
    """A complete prefix code whose code k is k ones and a zero (the last
    one ``depth`` ones): (L, R, C, T)."""
    nc = 2 * depth + 1
    L, R = np.zeros(nc, np.uint32), np.zeros(nc, np.uint32)
    C, T = np.zeros(nc, np.uint32), np.zeros(nc, np.uint8)
    for k in range(depth):
        node = 0 if k == 0 else depth + k
        L[node], C[k + 1], T[k + 1] = k + 1, k, 1
        R[node] = depth + k + 1 if k + 1 < depth else 2 * depth
    C[2 * depth], T[2 * depth] = depth, 1
    return L, R, C, T


def _random_bytes(nb, seed, dev):
    import torch
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    return torch.randint(0, 256, (nb,), dtype=torch.uint8, device=dev,
                         generator=gen)


def _fixed3_symbols(enc, code_of):
    """The symbols a fixed-length 3-bit code carries in the bytes enc."""
    import torch
    shifts = torch.arange(7, -1, -1, device=enc.device, dtype=torch.uint8)
    b = ((enc[:, None] >> shifts) & 1).reshape(-1)
    b = b[:b.numel() // 3 * 3].reshape(-1, 3).to(torch.int64)
    sym_of = torch.empty(8, dtype=torch.int32, device=enc.device)
    sym_of[torch.from_numpy(code_of).to(enc.device)] = torch.arange(
        8, dtype=torch.int32, device=enc.device)
    return sym_of[4 * b[:, 0] + 2 * b[:, 1] + b[:, 2]]


# bits of the 512^3 main-path stream (PERF.md): the never-syncing case is
# given that size, so its time is the decode's worst case at full size
NEVER_SYNC_BITS = 908_210_056


def phase_fsm_cases(dev) -> list:
    import torch
    from sz_tpu_torch.format import huffman
    rng = np.random.default_rng(61)
    rows = []
    for name, n, nstate, a in (("skewed_40k", 40000, 600, 1.5),
                               ("skewed_700k", 700_000, 300, 1.4),
                               ("tree_18k_nodes_smem", 400_000, 10000, 0.8),
                               ("tree_80k_nodes_l2", 3_000_000, 40000, 0.6)):
        types = _zipf(rng, n, nstate, a)
        t, stream = _packed_on_card(types, nstate, dev)
        rows.append(fsm_vs_plain(name, stream, n, types, t.node_count))
    # a fixed-length 3-bit code never self-synchronizes, and 1024 % 3 != 0:
    # random bits through it at the size of the 512^3 stream; the symbols
    # are the bits read three at a time
    t = huffman.build_tables(np.arange(8, dtype=np.int32), 8)
    assert set(t.code_len[:8].tolist()) == {3}
    enc = _random_bytes(NEVER_SYNC_BITS // 8 + 1, 5, dev)
    want = _fixed3_symbols(enc, (t.code_hi[:8] >> np.uint64(61)).astype(
        np.int64))
    rows.append(fsm_vs_plain("never_syncs_512^3_size",
                             _on_card(t, enc, dev), None, want,
                             t.node_count))
    del enc, want
    # past 2^31 bits: random bytes through a skewed tree (a complete
    # prefix code decodes any bit string)
    t = huffman.build_tables(_zipf(rng, 40000, 600, 1.5), 600)
    enc = _random_bytes((1 << 28) + (1 << 20), 7, dev)
    rows.append(fsm_vs_plain("above_2^31_bits",
                             _on_card(t, enc, dev), None,
                             node_count=t.node_count))
    del enc
    # a code of 1100 bits: past the boundary bitmaps (F + D >= 1120) and
    # past one 1024-bit chunk (F = 2048); a run of ones reaches it
    enc = _random_bytes(1 << 20, 9, dev)
    enc[5000:5000 + 140] = 255
    rows.append(fsm_vs_plain("code_of_1100_bits",
                             _on_card(_caterpillar(1100), enc, dev),
                             None))
    # a code of 40 bits: K5's 64-slot ring (codes of 32 to 63 bits)
    enc = _random_bytes(1 << 22, 11, dev)
    enc[5000:5000 + 6] = 255
    rows.append(fsm_vs_plain("code_of_40_bits",
                             _on_card(_caterpillar(40), enc, dev),
                             None))
    del enc
    torch.cuda.empty_cache()
    return rows


# --- phase 2: K8/K9 -------------------------------------------------------

def msst19_inputs(x: np.ndarray, ratio: float, dev):
    """A field's K8/K9 (float32) or K8d/K9d (float64) inputs as the
    PW_REL path makes them: zeros replaced by nearZero *
    (1 + ratio)^-3.0001, the optimizer's interval count, the two tables.
    Returns (intervals, (work, table, pt, base, top, bits, ign))."""
    import torch
    from sz_tpu_torch.core import pwr
    from sz_tpu_torch.gpu import msst19_engine
    T = x.dtype.type
    near = pwr.range_size_msst19(x)[5]
    work = x.copy()
    work[work == 0] = T(near * T(np.power(1.0 + ratio, -3.0001)))
    iv = pwr._optimize_intervals_msst19(work, ratio, 32768, 100,
                                        np.float32(0.99))
    cache = pwr._cache_table(iv, ratio, 3)
    rl = msst19_engine.req_length(ratio, x.ndim, T)
    return iv, (torch.from_numpy(work).to(dev),
                torch.from_numpy(cache.table.reshape(-1).view(np.int16)).to(
                    dev),
                torch.from_numpy(pwr._precision_table(iv, ratio, 3)).to(dev),
                cache.base_index, cache.top_index, cache.bits,
                max(8 * x.itemsize - rl, 0))


def msst19_ops(shape, escapes: int, decode: bool, f64: bool = False) -> tuple:
    """(32-bit, 64-bit) operations of one K8/K9 call on this shape: the
    predictor's products and quotient by position (the C's shorter forms
    on the first plane, row and column; counted at every point, escapes
    too), the encode's ratio division, and one f64 product per point
    that is not an escape.  For float64 data (K8d/K9d) all of them are
    64-bit."""
    n = int(np.prod(shape))
    ratio = 0 if decode else n - 1
    recon = n - escapes
    if len(shape) == 2:
        r2, r3 = shape
        pred = 2 * (r2 - 1) * (r3 - 1) + 2 * max(r3 - 2, 0)
        return (0, pred + ratio + recon) if f64 else (pred + ratio, recon)
    if f64:
        return (0, sum(msst19_ops(shape, escapes, decode)))
    r1, r2, r3 = shape
    pred = (6 * (r1 - 1) * (r2 - 1) * (r3 - 1)
            + 2 * ((r1 - 1) * (r3 - 1) + (r1 - 1) * (r2 - 1)
                   + (r2 - 1) * (r3 - 1) + max(r3 - 2, 0)))
    return ratio, pred + recon


def msst19_vs_plain(name, kid, shape, x, ratio, dev, timed: bool) -> dict:
    """K8 (rank 3) or K9 (rank 2), both directions, against the plain
    versions on one field; each kernel called twice, bit-equal; the
    decode gets the escapes' stored values and must also rebuild the
    encode's reconstruction.  Above PLAIN_MAX_POINTS the plain versions
    run on a leading box (plain_box).
    Timed: the kernels' mean time, the plain version's one call, the
    bound."""
    import torch
    from sz_tpu_torch.gpu import msst19_kernel as mk
    iv, args = msst19_inputs(x, ratio, dev)
    f64 = x.dtype == np.float64
    sfx = "_f64" if f64 else ""
    pre = "wavefront3d" if len(shape) == 3 else "lines2d"
    enc = getattr(mk, pre + "_encode" + sfx)
    dec = getattr(mk, pre + "_decode" + sfx)
    # the plain versions take either dtype
    enc_p = getattr(mk, pre + "_encode_plain")
    dec_p = getattr(mk, pre + "_decode_plain")
    sub = plain_box(shape, 2 * mk.TILE3[0] + 1)
    t_k, R_k = enc(*args)
    t_2, R_2 = enc(*args)
    e_again = bit_equal(t_k, t_2) and bit_equal(R_k, R_2)
    del t_2, R_2
    (t_p, R_p), enc_plain_ms = cuda_once(
        lambda: enc_p(args[0][sub].contiguous(), *args[1:]))
    e_err = max(max_abs_err(t_k[sub], t_p), max_abs_err(R_k[sub], R_p))
    plain_on = list(t_p.shape)
    del t_p, R_p
    known = torch.where(t_k == 0, mk._trunc_plain(args[0], args[-1]),
                        torch.zeros_like(args[0]))
    pt = args[2]
    o_k = dec(t_k, known, pt)
    d_again = bit_equal(o_k, dec(t_k, known, pt))
    o_p, dec_plain_ms = cuda_once(lambda: dec_p(
        t_k[sub].contiguous(), known[sub].contiguous(), pt))
    d_err = max_abs_err(o_k[sub], o_p)
    del o_p
    escapes = int((t_k == 0).sum())
    row = dict(case=name, shape=list(shape), dtype=x.dtype.name,
               ratio=ratio, intervals=iv,
               table_states=args[1].numel(), escapes=escapes,
               plain_on=plain_on, encode_bit_equal=e_err == 0.0,
               encode_repeat_bit_equal=e_again,
               decode_bit_equal=d_err == 0.0, decode_repeat_bit_equal=d_again,
               decode_rebuilds_encode=bit_equal(o_k.abs(), R_k))
    entries = {}
    if timed:
        runs = {  # each input read once, each output written once
            pre + "_encode" + sfx: (
                e_err, lambda: enc(*args), enc_plain_ms,
                bound(nbytes(args[0], args[1], pt, t_k, R_k),
                      *msst19_ops(shape, escapes, False, f64))),
            pre + "_decode" + sfx: (
                d_err, lambda: dec(t_k, known, pt), dec_plain_ms,
                bound(nbytes(t_k, known, pt, o_k),
                      *msst19_ops(shape, escapes, True, f64))),
        }
        for key, (err, kern, plain_ms, (b_ms, b_by)) in runs.items():
            ms = cuda_ms(kern, 3)
            row[key] = dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms)
            entries["msst19_" + key] = dict(
                max_abs_err=err, ms=ms, plain_ms=plain_ms,
                plain_shape=plain_on, bound_ms=b_ms, bound_by=b_by,
                library_ms=None, shape=list(shape))
    _log(f"kernel {kid} msst19 vs plain", **row)
    if not all(row[k] for k in (
            "encode_bit_equal", "encode_repeat_bit_equal", "decode_bit_equal",
            "decode_repeat_bit_equal", "decode_rebuilds_encode")):
        raise AssertionError(f"{kid} differs from its plain version or "
                             f"from itself on {name}: {row}")
    return row, entries


def phase_msst19_cases(dev) -> tuple:
    """Phase 2, K8/K9.  Returns (rows, timed record entries at the main
    path's shapes, 256^3 and 1800x3600)."""
    import torch
    rows, entries = [], {}
    cases = [  # the CPU tests' test_kernel_forced_parity shapes
        ("forced_parity", (9, 11, 13), "abs", 5, 1e-3),
        ("forced_parity_signed", (14, 10, 12), "signed", 7, 1e-3),
        ("forced_parity", (4, 3, 3), "abs", 9, 1e-3),
        ("forced_parity", (26, 31), "abs", 11, 1e-3),
        ("forced_parity_signed", (18, 23), "signed", 13, 1e-3),
        ("signed_with_zeros", (64, 64, 64), "signed", 3, 1e-3),
        ("ragged_2d", (777, 1031), "abs", 4, 1e-4),
        ("past_4096_states", (128, 128, 128), "abs", 5, 1e-5),
        # what the tiles can get wrong: shapes no multiple of a tile, a
        # lattice smaller than one tile, one tile wide on i and j but 129
        # tiles long on k (the k-2 hand-off along the first row), a row
        # and a single column in 2-D
        ("ragged", (9, 17, 70), "signed", 15, 1e-3),
        ("ragged", (33, 9, 65), "abs", 16, 1e-3),
        ("sub_tile", (3, 5, 7), "signed", 17, 1e-3),
        ("long_first_row", (2, 3, LONG_ROW), "abs", 18, 1e-3),
        ("single_row_2d", (1, LONG_ROW), "abs", 19, 1e-3),
        ("single_column_2d", (LONG_ROW, 1), "abs", 20, 1e-3),
        ("ragged_2d_small", (70, 130), "signed", 21, 1e-3),
        ("main_path_256", (256, 256, 256), "signed", 42, PW_REL),
        ("main_path_cesm_atm", (1800, 3600), "abs", 6, PW_REL),
        # phase 4's shape (its field is |field| with zeros; the kernels
        # see the zeros replaced either way)
        ("full_size_512", (512, 512, 512), "abs", 42, PW_REL),
    ]
    for name, shape, kind, seed, ratio in cases:
        x = pwrel_field(kind, shape, seed)
        kid = "K8" if len(shape) == 3 else "K9"
        row, ent = msst19_vs_plain(
            name, kid, shape, x, ratio, dev,
            timed=name.startswith(("main_path", "full_size")))
        if name == "signed_with_zeros" and not (x == 0).any():
            raise AssertionError("the signed case has no zeros")
        if name == "past_4096_states" and row["intervals"] <= 4096:
            raise AssertionError(f"1e-5 gave {row['intervals']} states")
        rows.append(row)
        if name.startswith("main_path"):
            entries.update(ent)
        del x
        torch.cuda.empty_cache()
    return rows, entries


def phase_msst19_f64_cases(dev) -> tuple:
    """Phase 2, K8d/K9d (float64 data): the K8/K9 cases' degenerate,
    ragged, sub-tile and single-row shapes and the signed field with
    zeros, the 1e-4 and 1e-5 tables, and timed at the main path's shapes
    (256^3, 1800x3600) and phase 4's 512^3.  Returns (rows, timed record
    entries at the main path's shapes)."""
    import torch
    rows, entries = [], {}
    cases = [
        ("forced_parity", (9, 11, 13), "abs", 5, 1e-3),
        ("forced_parity_signed", (14, 10, 12), "signed", 7, 1e-3),
        ("degenerate", (4, 3, 3), "abs", 9, 1e-3),
        ("forced_parity", (26, 31), "abs", 11, 1e-3),
        ("forced_parity_signed", (18, 23), "signed", 13, 1e-3),
        ("signed_with_zeros", (64, 64, 64), "signed", 3, 1e-3),
        ("ragged", (9, 17, 70), "signed", 15, 1e-3),
        ("sub_tile", (3, 5, 7), "signed", 17, 1e-3),
        ("long_first_row", (2, 3, LONG_ROW), "abs", 18, 1e-3),
        ("single_row_2d", (1, LONG_ROW), "abs", 19, 1e-3),
        ("single_column_2d", (LONG_ROW, 1), "abs", 20, 1e-3),
        ("ragged_2d_small", (70, 130), "signed", 21, 1e-3),
        ("table_1e-4", (64, 64, 64), "abs", 22, 1e-4),
        ("ragged_2d_1e-4", (777, 1031), "abs", 4, 1e-4),
        ("past_4096_states", (128, 128, 128), "abs", 5, 1e-5),
        ("main_path_256", (256, 256, 256), "signed", 42, PW_REL),
        ("main_path_cesm_atm", (1800, 3600), "abs", 6, PW_REL),
        ("full_size_512", (512, 512, 512), "abs", 42, PW_REL),
    ]
    for name, shape, kind, seed, ratio in cases:
        x = pwrel_field64(kind, shape, seed)
        if name == "full_size_512":
            x = np.abs(field64(shape, seed))   # phase 4's field
        kid = "K8d" if len(shape) == 3 else "K9d"
        row, ent = msst19_vs_plain(
            name, kid, shape, x, ratio, dev,
            timed=name.startswith(("main_path", "full_size")))
        if name == "signed_with_zeros" and not (x == 0).any():
            raise AssertionError("the signed case has no zeros")
        if name == "past_4096_states" and row["intervals"] <= 4096:
            raise AssertionError(f"1e-5 gave {row['intervals']} states")
        rows.append(row)
        if name.startswith("main_path"):
            entries.update(ent)
        del x
        torch.cuda.empty_cache()
    return rows, entries


# --- phase 2: K12/K13 -----------------------------------------------------

def ra_mean_field(shape, seed: int) -> np.ndarray:
    """``field`` with 60 % of its points set to 0.25: the optimizer then
    turns the random-access codec's mean flush on."""
    x = field(shape, seed)
    x[np.random.default_rng(seed).random(shape) < 0.6] = np.float32(0.25)
    return x


# K12/K13's timed launches (sub-millisecond kernels: fewer read low)
RA_REPS = 10
# blocks the plain K12/K13 run on past RA_PLAIN_MAX_CELLS cells (their
# plain versions take a tenth of a second at 256^3): the leading
# block-planes holding at most this many (the blocks are independent, so
# those are a whole computation)
RA_PLAIN_MAX_CELLS = 1 << 26
RA_PLAIN_BLOCKS = 1 << 16


def ra_escapes(t, b) -> tuple:
    """The escapes in stream order (block by block, raster order in a
    block) and each block's first, from K12's types t and the blocks b."""
    import torch
    esc = t == 0
    counts = esc.sum(dim=1)
    return b[esc], torch.cumsum(counts, 0) - counts


# K13's escape layouts (ra_escape_layout)
RA_ESCAPE_KINDS = ("none", "all", "straddle", "tail", "last")


def ra_escape_layout(t, kind: str, radius: int):
    """K12's types t (nb, ncell; a tensor or an array) with their escapes
    replaced, in place, by ``kind``'s: none at all, every cell of one
    block, escapes straddling the 32-cell chunks, escapes only in cells
    88 and on (at rank 3 the last float4 words a warp stages: lanes
    22-31's first, lanes 0-21's second), one escape in a block's last
    cell.  Returns t."""
    nb, ncell = t.shape
    t[t == 0] = radius
    if kind == "all":
        t[nb // 2] = 0
    elif kind == "straddle":
        for c in (0, 15, 16, 31, 32, 33, 63, 64, 100, 215, 255):
            if c < ncell:
                t[c % 3::2, c] = 0
    elif kind == "tail":
        for c in range(88, ncell, 11):
            t[c % 3::3, c] = 0
        t[1::2, ncell - 1] = 0
    elif kind == "last":
        t[nb // 2, ncell - 1] = 0
    return t


def ra_escape_cases(dev) -> list:
    """K13 against its plain version on K12's types of a small field at
    each rank, with the escapes of ra_escape_layout's "tail" and "last",
    on the whole field and a strided region: bit-equal, no escape past
    the end; then the "last" layout with the stream's last escape cut
    (one escape too many): both count one past the end and agree, NaN
    for NaN."""
    import torch
    from sz_tpu_torch import SZConfig
    from sz_tpu_torch.core import rablock
    from sz_tpu_torch.gpu import ra_kernel as rk
    rows = []
    for shape in ((13, 14, 20), (40, 50), (3000 * 7,)):
        x = field((3000, 7), 5).reshape(-1) if len(shape) == 1 else \
            field(shape, 5)
        p = rablock.prepare(x, 1e-3, SZConfig(random_access=True))
        rank, bs, nb = x.ndim, p.bs, p.blocks.shape[0]
        radius = p.intervals // 2
        lor = torch.from_numpy(p.indicator.astype(np.uint8)).to(dev)
        qc = torch.from_numpy(p.qc_full).to(dev)
        t0 = rk.ra_encode(torch.from_numpy(p.blocks.reshape(nb, -1)).to(dev),
                          lor, qc, rank, bs, 1e-3, p.intervals, radius,
                          p.use_mean, p.mean)
        vals = torch.from_numpy(np.random.default_rng(3).standard_normal(
            t0.shape).astype(np.float32)).to(dev)
        dec = (rank, bs, 1e-3, radius, p.use_mean, p.mean)
        start = tuple(min(bs + 1, r - 1) for r in shape)
        for kind in ("tail", "last", "past_the_end"):
            t = ra_escape_layout(t0.clone(), "tail" if kind == "tail"
                                 else "last", radius)
            unpred, base = ra_escapes(t, vals)
            if kind == "past_the_end":
                unpred = unpred[:-1]
            for a in ((0,) * rank, start):
                sel, *geo = rablock.region_blocks(shape, bs, a, shape)
                sel = torch.from_numpy(sel).to(dev)
                args = (t[sel], unpred, base[sel], lor[sel], qc[sel], *dec,
                        *geo)
                (o_k, bad_k), (o_p, bad_p) = (rk.ra_decode(*args),
                                              rk.ra_decode_plain(*args))
                # cut, the one escape lies past the end where selected
                want = int((t[sel] == 0).sum()) if kind == "past_the_end" \
                    else 0
                nan = torch.isnan(o_k)
                row = dict(case=kind, shape=list(shape), start=list(a),
                           escapes=int(unpred.numel()),
                           past_the_end=[int(bad_k), int(bad_p)],
                           bit_equal=bit_equal(o_k, o_p),
                           nan_for_nan=bool(torch.equal(nan, torch.isnan(
                               o_p)) and torch.equal(o_k[~nan], o_p[~nan])))
                _log("kernel K13 escape layouts vs plain", **row)
                if (int(bad_k), int(bad_p)) != (want, want) or not (
                        row["bit_equal"] or want and row["nan_for_nan"]):
                    raise AssertionError(f"K13 differs from its plain "
                                         f"version on escapes: {row}")
                rows.append(row)
    return rows


def ra_vs_plain(name, x: np.ndarray, rp: float, dev, timed: bool,
                intervals: int = 0, regions=()) -> tuple:
    """K12 and K13 against their plain versions on one float32 field's
    blocks as the random-access path makes them (rablock.prepare; with
    ``intervals`` fixed where the optimizer samples no point), each
    called twice, bit-equal; K13 decodes the whole field (the escapes
    in stream order, the field's layout) and must hold the bound, then
    each region of ``regions`` (start, end) from its blocks alone, equal
    to its plain version and to the whole decode's crop.  Above
    RA_PLAIN_MAX_CELLS the plain versions run on the leading block-planes
    of at most RA_PLAIN_BLOCKS blocks.  Timed: the kernels' mean time,
    the plain version's one call, the bounds (K13's also as it was
    before it read the compact escapes and wrote the field's layout:
    12 bytes a padded cell, in the row only)."""
    import torch
    from sz_tpu_torch import SZConfig
    from sz_tpu_torch.core import rablock
    from sz_tpu_torch.gpu import ra_kernel as rk
    p = rablock.prepare(x, rp, SZConfig(random_access=True,
                                        quantization_intervals=intervals))
    nb, rank, bs = p.blocks.shape[0], x.ndim, p.bs
    b = torch.from_numpy(p.blocks.reshape(nb, -1)).to(dev)
    lor = torch.from_numpy(p.indicator.astype(np.uint8)).to(dev)
    qc = torch.from_numpy(p.qc_full).to(dev)
    radius = p.intervals // 2
    enc_args = (rank, bs, rp, p.intervals, radius, p.use_mean, p.mean)
    dec_args = (rank, bs, rp, radius, p.use_mean, p.mean)
    whole = b.numel() <= RA_PLAIN_MAX_CELLS
    if whole:
        sub_end = x.shape
    else:
        per_plane = nb // -(-x.shape[0] // bs)
        sub_end = (min(x.shape[0], RA_PLAIN_BLOCKS // per_plane * bs),
                   *x.shape[1:])
    sub, *sub_geo = rablock.region_blocks(x.shape, bs, (0,) * rank,
                                          sub_end)
    sub = torch.from_numpy(sub).to(dev)
    t_k = rk.ra_encode(b, lor, qc, *enc_args)
    e_again = bit_equal(t_k, rk.ra_encode(b, lor, qc, *enc_args))
    t_p, enc_plain_ms = cuda_once(lambda: rk.ra_encode_plain(
        b[sub], lor[sub], qc[sub], *enc_args))
    e_err = max_abs_err(t_k[sub], t_p)
    del t_p
    unpred, base = ra_escapes(t_k, b)
    _, *geo = rablock.region_blocks(x.shape, bs, (0,) * rank, x.shape)
    o_k, bad = rk.ra_decode(t_k, unpred, base, lor, qc, *dec_args, *geo)
    d_again = bit_equal(o_k, rk.ra_decode(t_k, unpred, base, lor, qc,
                                          *dec_args, *geo)[0])
    (o_p, bad_p), dec_plain_ms = cuda_once(lambda: rk.ra_decode_plain(
        t_k[sub], unpred, base[sub], lor[sub], qc[sub], *dec_args,
        *sub_geo))
    d_err = max_abs_err(o_k[tuple(slice(0, e) for e in sub_end)], o_p)
    past = int(bad) + int(bad_p)
    del o_p
    xt = torch.from_numpy(x).to(dev)
    err = float((o_k.double() - xt.double()).abs().max())
    escapes = int(unpred.numel())
    row = dict(case=name, shape=list(x.shape), bound=rp, blocks=nb,
               intervals=p.intervals, use_mean=p.use_mean,
               lorenzo_blocks=int(p.indicator.sum()), escapes=escapes,
               blocks_with_escapes=int((t_k == 0).any(dim=1).sum()),
               plain_on_blocks=int(sub.numel()),
               encode_bit_equal=e_err == 0.0, encode_repeat_bit_equal=e_again,
               decode_bit_equal=d_err == 0.0, decode_repeat_bit_equal=d_again,
               max_abs_err=err, decode_holds_bound=err <= rp,
               no_escape_past_the_end=past == 0, regions=[])
    for start, end in regions:
        sel, *g = rablock.region_blocks(x.shape, bs, start, end)
        sel = torch.from_numpy(sel).to(dev)
        args = (t_k[sel], unpred, base[sel], lor[sel], qc[sel], *dec_args,
                *g)
        r_k, bad = rk.ra_decode(*args)
        r_p, bad_p = rk.ra_decode_plain(*args)
        crop = o_k[tuple(slice(a, e) for a, e in zip(start, end))]
        row["regions"].append(dict(
            start=list(start), end=list(end), blocks=int(sel.numel()),
            bit_equal_plain=bit_equal(r_k, r_p),
            repeat_bit_equal=bit_equal(r_k, rk.ra_decode(*args)[0]),
            equals_whole_decode=bit_equal(r_k, crop),
            no_escape_past_the_end=int(bad) + int(bad_p) == 0))
    entries = {}
    if timed:
        cells = b.numel()
        side = nbytes(lor, qc)
        runs = {  # each input read once, each output written once
            "ra_encode": (e_err, lambda: rk.ra_encode(
                b, lor, qc, *enc_args), enc_plain_ms,
                bound(nbytes(b, t_k) + side, 8 * cells, 4 * cells)),
            "ra_decode": (d_err, lambda: rk.ra_decode(
                t_k, unpred, base, lor, qc, *dec_args, *geo),
                dec_plain_ms,
                bound(nbytes(t_k, unpred, base, o_k) + side,
                      6 * cells, 2 * cells)),
        }
        # K13 as it was: types, the placed escapes and the blocks' values
        old_ms, _ = bound(12 * cells + side, 6 * cells, 2 * cells)
        for key, (e, kern, plain_ms, (b_ms, b_by)) in runs.items():
            cuda_ms(kern, RA_REPS)          # the clocks up after the plain
            ms = cuda_ms(kern, RA_REPS)
            row[key] = dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms)
            entries[key] = dict(max_abs_err=e, ms=ms, plain_ms=plain_ms,
                                plain_shape=list(sub_end), bound_ms=b_ms,
                                bound_by=b_by, library_ms=None,
                                shape=list(x.shape))
        row["ra_decode"]["bound_old_ms"] = old_ms
    _log("kernel K12/K13 random access vs plain", **row)
    if not all(row[k] for k in (
            "encode_bit_equal", "encode_repeat_bit_equal", "decode_bit_equal",
            "decode_repeat_bit_equal", "decode_holds_bound",
            "no_escape_past_the_end")) or not all(
            all(r.values()) for r in row["regions"]):
        raise AssertionError(f"K12/K13 differ from their plain versions or "
                             f"from themselves on {name}: {row}")
    return row, entries


def ra_cases() -> list:
    """Phase 2's K12/K13 cases: (name, field maker, bound, fixed interval
    count or 0, regions (start, end) to decode from their blocks)."""
    rng = np.random.default_rng(7)
    return [
        ("padded_edges_3d", lambda: field((13, 14, 20), 3), 1e-3, 0,
         [((1, 5, 7), (11, 13, 19)), ((6, 6, 6), (12, 12, 12)),
          ((7, 8, 9), (10, 11, 12))]),
        ("padded_edges_2d", lambda: field((40, 50), 4), 1e-3, 0,
         [((15, 17), (33, 49)), ((16, 32), (32, 48)), ((17, 3), (30, 9))]),
        ("padded_edges_1d", lambda: field((3000, 7), 5).reshape(-1), 1e-3, 0,
         [((255,), (2049,)), ((512,), (768,)), ((300,), (400,)),
          ((20000,), (21000,))]),
        ("one_block_3d", lambda: field((5, 6, 4), 6), 1e-3, 1024, []),
        ("one_block_2d", lambda: field((3, 20), 7)[:, :16], 1e-3, 1024, []),
        ("under_one_block_1d", lambda: field((9, 11), 8).reshape(-1)[:70],
         1e-3, 1024, [((3,), (69,))]),
        ("use_mean_3d", lambda: ra_mean_field((30, 31, 32), 9), 1e-3, 0,
         [((5, 0, 13), (29, 31, 20))]),
        ("use_mean_2d", lambda: ra_mean_field((100, 90), 10), 1e-3, 0,
         [((1, 1), (99, 89))]),
        ("random_1e-6", lambda: rng.standard_normal((64, 64, 64)).astype(
            np.float32), 1e-6, 0, [((3, 4, 5), (50, 60, 61))]),
        ("main_path_256", lambda: field((256, 256, 256), 42), ABS, 0, []),
        ("main_path_cesm_atm", lambda: field((1800, 3600), 6), ABS, 0, []),
        ("main_path_1d_2^24", lambda: field((256, 256, 256), 42).reshape(-1),
         ABS, 0, []),
        ("full_size_512", lambda: field((512, 512, 512), 42), ABS, 0,
         [((224, 224, 224), (288, 288, 288))]),
    ]


def phase_ra_cases(dev) -> tuple:
    """Phase 2, K12/K13 (ra_cases): fields whose edge blocks are padded
    (every rank), fields of one block and less (with a fixed interval
    count: their optimizer samples no point), a field with the mean
    flush on, random data under 1e-6 (most points escape), and timed at
    the main path's shapes (256^3, 1800x3600, 2^24) and phase 4's 512^3;
    region decodes at ranks 1-3 whose faces cut blocks, of one block
    (aligned and not) and a 64^3 region of 512^3; K13 on the escape
    layouts of ra_escape_cases.  Returns (rows, the record entries at
    256^3)."""
    import torch
    rows, entries = ra_escape_cases(dev), {}
    for name, make, rp, intervals, regions in ra_cases():
        x = np.ascontiguousarray(make())
        row, ent = ra_vs_plain(name, x, rp, dev, timed=name.startswith(
            ("main_path", "full_size")), intervals=intervals,
            regions=regions)
        if name.startswith("use_mean") and not row["use_mean"]:
            raise AssertionError(f"{name}: the mean flush is off")
        if name == "random_1e-6" and row["escapes"] < x.size // 2:
            raise AssertionError(f"{name}: {row['escapes']} escapes")
        rows.append(row)
        if name == "main_path_256":
            entries.update(ent)
        del x
        torch.cuda.empty_cache()
    return rows, entries


# --- phase 2: K10/K11 -----------------------------------------------------

def classic_field(shape, dtype, rp: float, seed: int, noise: float = 0.1):
    """A K10/K11 case: a smooth product of sines and cosines with seeded
    normal noise (random data alone where noise is None), and its
    quantizer parameters as the classic path sets them.  Returns (field,
    core.classic_nd.Params)."""
    from sz_tpu_torch.core import classic_nd
    rng = np.random.default_rng(seed)
    if noise is None:
        x = rng.standard_normal(shape).astype(dtype)
    else:
        g = np.meshgrid(*[np.linspace(0, 6, r) for r in shape],
                        indexing="ij")
        x = np.sin(2 * g[0])
        for a in g[1:]:
            x = x * np.cos(a)
        x = (x + noise * rng.standard_normal(shape)).astype(dtype)
    vr = dtype(x.max() - x.min())
    p = classic_nd.params(x, rp, vr, dtype(x.min() + vr / 2),
                          max_range_radius=32768, sample_distance=100,
                          pred_threshold=np.float32(0.99))
    return x, p


def classic_ops(shape, escapes: int, decode: bool, f64: bool,
                dbl: bool) -> tuple:
    """(32-bit, 64-bit) operations of one K10/K11 call: the predictor's
    adds by position (6 in the 3-D interior, 2 on its faces, 2 in the
    layer-0 interior and on its first row), counted per volume; the
    encode's quantizer at every point but the first (the difference and
    the recheck's in the data's type, itvNum's multiply-add and the
    recheck's compare in double, the halving and the reconstruction's
    two in RT), the decode's reconstruction (two in RT) at each point
    that is not an escape."""
    n = int(np.prod(shape))
    vol = shape[-3:] if len(shape) >= 3 else (1,) + tuple(shape)
    nvol = n // int(np.prod(vol))
    r1, r2, r3 = vol
    pred = 2 * ((r2 - 1) * (r3 - 1) + max(r3 - 2, 0)) + (
        6 * (r1 - 1) * (r2 - 1) * (r3 - 1)
        + 2 * (r1 - 1) * ((r2 - 1) + (r3 - 1)))
    pred *= nvol
    if decode:
        t_ops, rt_ops, d_ops = pred, 2 * (n - escapes), 0
    else:
        q = n - nvol
        t_ops, rt_ops, d_ops = pred + 2 * q, 3 * q, 3 * q
    if f64:
        return 0, t_ops + rt_ops + d_ops
    if dbl:
        return t_ops, rt_ops + d_ops
    return t_ops + rt_ops, d_ops


def classic_bytes(shape, dtype, escapes: int, decode: bool) -> tuple:
    """(bytes the call needs, bytes the parent's call moved) of one
    K10/K11 call: K10 reads the data and writes the types; K11 reads the
    types, the escapes and each row's escape base (int64) and writes the
    values.  The parent's: 12 B a float32 point (K10: data in, types
    and R out; K11: types and a full-size `known` in, values out)."""
    n = int(np.prod(shape))
    item = np.dtype(dtype).itemsize
    if decode:
        now = 4 * n + item * escapes + 8 * (n // shape[-1]) + item * n
    else:
        now = item * n + 4 * n
    return now, (2 * item + 4) * n


def classic_chain_steps(shape) -> int:
    """Point steps on the critical path of one call: r1 + r2 + r3 - 2
    of a volume (the volumes of a 4-D field run side by side)."""
    vol = tuple(shape[-3:]) if len(shape) >= 3 else (1,) + tuple(shape)
    return sum(vol) - 2


def classic_form_key(x: np.ndarray) -> str:
    """The numeric form (and kernel) of a field: float, double (float32
    data of rank 4) or f64."""
    if x.dtype == np.float64:
        return "f64"
    return "double" if x.ndim == 4 else "float"


# one-row lattices of each form: a step's latency is the time over r3
CLASSIC_STEP_SHAPES = {"float": (1, 1 << 16), "double": (1, 1, 1, 1 << 16),
                       "f64": (1, 1 << 16)}


def classic_step_ns(dev) -> dict:
    """One point step's latency (ns) of K10 and K11 in each form, from a
    one-row lattice, where the walk is a single chain of r3 steps."""
    import torch
    from sz_tpu_torch.gpu import classic_kernel as ck
    out = {}
    for form, shape in CLASSIC_STEP_SHAPES.items():
        dtype = np.float64 if form == "f64" else np.float32
        x, p = classic_field(shape, dtype, ABS, 3, 0.1)
        xt = torch.from_numpy(x).to(dev)
        args = (p.rp, p.recip, p.intervals, p.radius, p.median,
                p.req_length)
        t, R = ck.classic_quantize(xt, *args)
        esc = R.reshape(-1)[t.reshape(-1) == 0]
        rb = ck.escape_row_base(t)[0]
        enc = cuda_ms(lambda: ck.classic_quantize(xt, *args, want_R=False),
                      3)
        dec = cuda_ms(lambda: ck.classic_decode(t, esc, p.rp, p.radius,
                                                row_base=rb), 3)
        out[form] = dict(shape=list(shape), classic_quantize_ns=enc * 1e6
                         / shape[-1], classic_decode_ns=dec * 1e6 / shape[-1])
        _log("K10/K11 step latency", form=form, **out[form])
    return out


def classic_vs_plain(name, x, p, dev, timed: bool, step_ns=None) -> tuple:
    """K10 and K11 against their plain versions on one field: each kernel
    called twice, bit-equal; K10's types the same with R asked for and
    without it; K11 on the escapes' reconstructions (compact, in raster
    order) must rebuild K10's; one launch a call, 4-D included.  Above
    PLAIN_MAX_POINTS the plain versions run on a leading box (plain_box;
    K11's on the box's escapes).
    Timed: the kernels' mean time (K10 without R, as the main path asks;
    K11 with the row bases the main path computes beside the escape
    count), the plain version's one call, the byte bound (and the
    parent's 12 B a point) and the chain bound, (r1 + r2 + r3 - 2)
    steps of step_ns."""
    import torch
    from sz_tpu_torch.gpu import classic_kernel as ck
    xt = torch.from_numpy(x).to(dev)
    args = (p.rp, p.recip, p.intervals, p.radius, p.median, p.req_length)
    sub = plain_box(x.shape, 2 * ck.WARPS[xt.dtype] + 1)
    launches = ck.classic_quantize.launches
    t_k, R_k = ck.classic_quantize(xt, *args)
    launches = ck.classic_quantize.launches - launches
    t_2, R_2 = ck.classic_quantize(xt, *args)
    e_again = bit_equal(t_k, t_2) and bit_equal(R_k, R_2)
    del t_2, R_2
    t_n, R_n = ck.classic_quantize(xt, *args, want_R=False)
    no_R_same = R_n is None and bit_equal(t_n, t_k)
    del t_n
    (t_p, R_p), enc_plain_ms = cuda_once(
        lambda: ck.classic_quantize_plain(xt[sub].contiguous(), *args))
    e_err = max(max_abs_err(t_k[sub], t_p), max_abs_err(R_k[sub], R_p))
    plain_on = list(t_p.shape)
    del t_p, R_p
    esc = R_k.reshape(-1)[t_k.reshape(-1) == 0]
    rb = ck.escape_row_base(t_k)[0]
    dec = (t_k, esc, p.rp, p.radius)
    d_launches = ck.classic_decode.launches
    o_k = ck.classic_decode(*dec)
    d_launches = ck.classic_decode.launches - d_launches
    d_again = bit_equal(o_k, ck.classic_decode(*dec, row_base=rb))
    t_sub = t_k[sub].contiguous()
    esc_sub = R_k[sub].reshape(-1)[t_sub.reshape(-1) == 0]
    o_p, dec_plain_ms = cuda_once(lambda: ck.classic_decode_plain(
        t_sub, esc_sub, p.rp, p.radius))
    d_err = max_abs_err(o_k[sub], o_p)
    del o_p, t_sub, esc_sub
    escapes = int(esc.numel())
    dbl, f64 = p.form.dbl, x.dtype == np.float64
    row = dict(case=name, shape=list(x.shape), dtype=x.dtype.name,
               form="double" if dbl else "float", intervals=p.intervals,
               escapes=escapes, plain_on=plain_on,
               launches_a_call=launches, decode_launches_a_call=d_launches,
               encode_bit_equal=e_err == 0.0,
               encode_repeat_bit_equal=e_again,
               encode_types_without_R_equal=no_R_same,
               decode_bit_equal=d_err == 0.0,
               decode_repeat_bit_equal=d_again,
               decode_rebuilds_encode=bit_equal(o_k, R_k))
    entries = {}
    if timed:
        steps = classic_chain_steps(x.shape)
        step = step_ns[classic_form_key(x)] if step_ns else None
        runs = {  # each input read once, each output written once
            "classic_quantize": (
                e_err, lambda: ck.classic_quantize(xt, *args, want_R=False),
                enc_plain_ms, classic_bytes(x.shape, x.dtype, escapes, False),
                classic_ops(x.shape, escapes, False, f64, dbl)),
            "classic_decode": (
                d_err, lambda: ck.classic_decode(*dec, row_base=rb),
                dec_plain_ms, classic_bytes(x.shape, x.dtype, escapes, True),
                classic_ops(x.shape, escapes, True, f64, dbl)),
        }
        for key, (err, kern, plain_ms, (nb, nb_old), ops) in runs.items():
            ms = cuda_ms(kern, 3)
            b_ms, b_by = bound(nb, *ops)
            row[key] = dict(
                ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                bound_12B_ms=bound(nb_old, *ops)[0], chain_steps=steps,
                chain_ms=(steps * step[key + "_ns"] * 1e-6 if step
                          else None))
            entries[key] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                                plain_shape=plain_on, bound_ms=b_ms,
                                bound_by=b_by, library_ms=None,
                                shape=list(x.shape))
        row["classic_quantize"]["ms_with_R"] = cuda_ms(
            lambda: ck.classic_quantize(xt, *args), 3)
    _log("kernel K10/K11 classic vs plain", **row)
    if not all(row[k] for k in (
            "encode_bit_equal", "encode_repeat_bit_equal",
            "encode_types_without_R_equal", "decode_bit_equal",
            "decode_repeat_bit_equal", "decode_rebuilds_encode")):
        raise AssertionError(f"K10/K11 differ from their plain versions or "
                             f"from themselves on {name}: {row}")
    if launches != 1 or d_launches != 1:
        raise AssertionError(f"K10/K11 took {launches} / {d_launches} "
                             f"launches on {name}, not one a call")
    return row, entries


# K10/K11's strip decomposition on its ragged edges (shared with
# tests/test_torch_classic_strips.py): strips of 31, 33 and 65 rows,
# plane counts no multiple of a block's warps, rows of 1, 2, CHUNK - 1 and
# CHUNK + 1 columns, one row, one plane, 128 volumes of 8^3
CLASSIC_EDGE_SHAPES = [
    (7, 31, 40), (13, 33, 20), (5, 65, 17), (9, 40, 1), (9, 40, 2),
    (11, 37, 15), (11, 37, 17), (4, 1, 300), (1, 70, 90), (65, 3),
    (33, 17), (31, 300), (1, 700), (128, 8, 8, 8), (6, 7, 33, 17),
    (40, 5, 70),
]


def classic_edge_cases() -> list:
    """(name, shape, dtype, rp, seed, noise) of the edge cases: each shape
    in float32, and float64 on every third and the 4-D ones."""
    out = []
    for n, shape in enumerate(CLASSIC_EDGE_SHAPES):
        name = "edge_" + "x".join(map(str, shape))
        out.append((name, shape, np.float32, 1e-4, 100 + n, 0.1))
        if n % 3 == 0 or len(shape) == 4:
            out.append((name + "_f64", shape, np.float64, 1e-6, 200 + n,
                        0.1))
    return out


def classic_short_escapes(dev) -> list:
    """K11 on streams with fewer escape values than type-0 points (none,
    one, half of them): bit-equal to the plain version, which takes the
    last value for every rank past the end, as _decode_fn clips."""
    import torch
    from sz_tpu_torch.gpu import classic_kernel as ck
    rows = []
    for shape, dtype in (((9, 33, 20), np.float32), ((40, 35), np.float64)):
        x, p = classic_field(shape, dtype, 1e-7, 30, None)
        t, R = ck.classic_quantize(torch.from_numpy(x).to(dev), p.rp, p.recip,
                                   p.intervals, p.radius, p.median,
                                   p.req_length)
        esc = R.reshape(-1)[t.reshape(-1) == 0]
        for keep in (0, 1, esc.numel() // 2):
            part = esc[:keep].contiguous()
            o_k = ck.classic_decode(t, part, p.rp, p.radius)
            o_p = ck.classic_decode_plain(t, part, p.rp, p.radius)
            row = dict(shape=list(shape), dtype=np.dtype(dtype).name,
                       escapes=int(esc.numel()), kept=keep,
                       bit_equal=bit_equal(o_k, o_p))
            _log("K11 short escape stream", **row)
            if not row["bit_equal"]:
                raise AssertionError(f"K11 differs from its plain version "
                                     f"on a short escape stream: {row}")
            rows.append(row)
    return rows


def phase_classic_cases(dev) -> tuple:
    """Phase 2, K10/K11.  Returns (rows, timed record entries at the main
    path's 256^3, the step latencies)."""
    import torch
    f32, f64 = np.float32, np.float64
    rows, entries = [], {}
    cases = [  # (name, shape, dtype, rp, seed, noise, timed)
        # the CPU tests' degenerate shapes
        ("degenerate", (1, 5, 7), f32, 1e-3, 1, 0.3, False),
        ("degenerate", (5, 1, 7), f32, 1e-3, 2, 0.3, False),
        ("degenerate", (5, 7, 1), f32, 1e-3, 3, 0.3, False),
        ("degenerate", (2, 65), f32, 1e-3, 4, 0.3, False),
        ("degenerate", (6, 2, 2), f32, 1e-3, 5, 0.3, False),
        # 2-D, 3-D, 4-D and float64; shapes no multiple of a strip or a
        # block, one long on k (the first row's 2A - A2), a row and a
        # column in 2-D
        ("ragged_2d", (777, 1031), f32, 1e-4, 6, 0.1, False),
        ("ragged_3d", (33, 17, 300), f32, 1e-3, 7, 0.1, False),
        ("sub_tile", (3, 5, 7), f32, 1e-3, 8, 0.1, False),
        ("long_first_row", (3, 5, LONG_ROW), f32, 1e-3, 9, 0.1, False),
        ("single_row_2d", (2, LONG_ROW), f32, 1e-3, 10, 0.1, False),
        ("single_column_2d", (LONG_ROW, 2), f32, 1e-3, 11, 0.1, False),
        ("4d", (5, 9, 12, 10), f32, 1e-4, 12, 0.1, False),
        ("4d", (3, 20, 33, 70), f32, 1e-4, 13, 0.1, False),
        ("4d_f64", (3, 2, 2, 2), f64, 1e-4, 14, 0.1, False),
        ("4d_f64", (2, 10, 20, 33), f64, 1e-4, 15, 0.1, False),
        ("f64_3d", (40, 70, 130), f64, 1e-6, 16, 0.1, False),
        ("f64_2d", (700, 300), f64, 1e-6, 17, 0.1, False),
        # random data at 1e-7: nearly every point escapes
        ("escape_heavy", (64, 64, 64), f32, 1e-7, 18, None, False),
        ("escape_heavy_f64", (40, 50, 60), f64, 1e-9, 19, None, False),
    ] + [c + (False,) for c in classic_edge_cases()]
    for name, shape, dtype, rp, seed, noise, timed in cases:
        x, p = classic_field(shape, dtype, rp, seed, noise)
        rows.append(classic_vs_plain(name, x, p, dev, timed)[0])
    rows += classic_short_escapes(dev)
    step_ns = classic_step_ns(dev)
    for name, shape, dtype, rp, seed, noise in CLASSIC_TIMED:
        x, p = classic_field(shape, dtype, rp, seed, noise)
        row, ent = classic_vs_plain(name, x, p, dev, True, step_ns)
        rows.append(row)
        if name == "main_path_256":
            entries.update(ent)
        del x
        torch.cuda.empty_cache()
    return rows, entries, step_ns


# the main path's shapes, timed (name, shape, dtype, rp, seed, noise)
CLASSIC_TIMED = [
    ("main_path_256", (256, 256, 256), np.float32, ABS, 42, 0.1),
    ("main_path_cesm_atm", (1800, 3600), np.float32, ABS, 6, 0.1),
    ("main_path_f64_256", (256, 256, 256), np.float64, ABS, 42, 0.1),
    ("full_size_4d", (8, 128, 256, 256), np.float32, ABS, 20, 0.1),
    ("full_size_512", (512, 512, 512), np.float32, ABS, 42, 0.1),
]


# K10's subblock form (compress_region): the classic edge shapes at
# origins 0 and odd, both dtypes; timed at the main path's shapes
SUBBLOCK_TIMED = [
    ("main_path_256", (256, 256, 256), np.float32, ABS, 42, 0.1),
    ("main_path_cesm_atm", (1800, 3600), np.float32, ABS, 6, 0.1),
]


def subblock_params(x: np.ndarray, rp: float, origin):
    """compress_region's quantizer parameters of a field cut at
    ``origin`` (classic_nd.params with the subblock origin)."""
    from sz_tpu_torch.core import classic_nd
    dtype = x.dtype.type
    vr = dtype(x.max() - x.min())
    return classic_nd.params(x, rp, vr, dtype(x.min() + vr / 2),
                             max_range_radius=32768, sample_distance=100,
                             pred_threshold=np.float32(0.99),
                             subblock_origin=origin)


def subblock_step_ns(dev) -> dict:
    """One point step's latency (ns) of the subblock form, float32 and
    float64, on a one-row lattice."""
    import torch
    from sz_tpu_torch.gpu import classic_kernel as ck
    out = {}
    for form, dtype in (("float", np.float32), ("f64", np.float64)):
        x, _ = classic_field((1, 1 << 16), dtype, ABS, 3, 0.1)
        p = subblock_params(x, ABS, (0, 0))
        xt = torch.from_numpy(x).to(dev)
        ms = cuda_ms(lambda: ck.classic_quantize_sub(
            xt, p.rp, p.intervals, p.radius, p.median, p.req_length,
            want_R=False), 3)
        out[form] = ms * 1e6 / x.shape[-1]
    _log("K10 subblock step latency", **out)
    return out


def subblock_vs_plain(name, x, p, dev, timed: bool, step_ns=None) -> tuple:
    """K10's subblock form against its plain version on one field: called
    twice, bit-equal types and reconstructions, the types the same
    without R, one launch a call (the plain version on plain_box past
    PLAIN_MAX_POINTS).  Timed: the mean time without R (as
    compress_region asks), the plain version's one call, the byte bound
    and the chain bound, as K10's row reckons them."""
    import torch
    from sz_tpu_torch.gpu import classic_kernel as ck
    xt = torch.from_numpy(x).to(dev)
    args = (p.rp, p.intervals, p.radius, p.median, p.req_length)
    box = plain_box(x.shape, 2 * ck.WARPS[xt.dtype] + 1)
    launches = ck.classic_quantize_sub.launches
    t_k, R_k = ck.classic_quantize_sub(xt, *args)
    launches = ck.classic_quantize_sub.launches - launches
    t_2, R_2 = ck.classic_quantize_sub(xt, *args)
    again = bit_equal(t_k, t_2) and bit_equal(R_k, R_2)
    del t_2, R_2
    t_n, R_n = ck.classic_quantize_sub(xt, *args, want_R=False)
    no_R_same = R_n is None and bit_equal(t_n, t_k)
    del t_n
    (t_p, R_p), plain_ms = cuda_once(lambda: ck.classic_quantize_plain(
        xt[box].contiguous(), p.rp, None, p.intervals, p.radius, p.median,
        p.req_length, sub=True))
    err = max(max_abs_err(t_k[box], t_p), max_abs_err(R_k[box], R_p))
    plain_on = list(t_p.shape)
    escapes = int((t_k == 0).sum())
    del t_p, R_p, t_k, R_k
    row = dict(case=name, shape=list(x.shape), dtype=x.dtype.name,
               intervals=p.intervals, escapes=escapes, plain_on=plain_on,
               launches_a_call=launches, bit_equal=err == 0.0,
               repeat_bit_equal=again, types_without_R_equal=no_R_same)
    entries = {}
    if timed:
        f64 = x.dtype == np.float64
        steps = classic_chain_steps(x.shape)
        ms = cuda_ms(lambda: ck.classic_quantize_sub(xt, *args,
                                                     want_R=False), 3)
        nb, nb_old = classic_bytes(x.shape, x.dtype, escapes, False)
        ops = classic_ops(x.shape, escapes, False, f64, True)
        b_ms, b_by = bound(nb, *ops)
        step = step_ns["f64" if f64 else "float"] if step_ns else None
        row["classic_quantize_sub"] = dict(
            ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
            chain_steps=steps,
            chain_ms=steps * step * 1e-6 if step else None)
        entries["classic_quantize_sub"] = dict(
            max_abs_err=err, ms=ms, plain_ms=plain_ms, plain_shape=plain_on,
            bound_ms=b_ms, bound_by=b_by, library_ms=None,
            shape=list(x.shape))
    _log("kernel K10 subblock form vs plain", **row)
    if not (row["bit_equal"] and row["repeat_bit_equal"]
            and row["types_without_R_equal"]):
        raise AssertionError(f"K10's subblock form differs from its plain "
                             f"version or from itself on {name}: {row}")
    if launches != 1:
        raise AssertionError(f"K10's subblock form took {launches} "
                             f"launches on {name}, not one a call")
    return row, entries


def phase_subblock_cases(dev) -> tuple:
    """Phase 2, K10's subblock form: the classic edge shapes (2-D, 3-D,
    4-D; float32, and float64 on every third and the 4-D ones), every
    other case at origin 0 and the rest at an odd origin (the
    optimizer's sample walk, hence the intervals, follows it),
    escape-heavy fields, and the main path's shapes timed.  Returns
    (rows, the 256^3 entry)."""
    import torch
    rows, entries = [], {}
    cases = classic_edge_cases() + [
        ("escape_heavy", (64, 64, 64), np.float32, 1e-7, 18, None),
        ("escape_heavy_f64", (40, 50, 60), np.float64, 1e-9, 19, None)]
    for n, (name, shape, dtype, rp, seed, noise) in enumerate(cases):
        x, _ = classic_field(shape, dtype, rp, seed, noise)
        origin = tuple(0 if n % 2 == 0 else 2 * k + 1 + n % 3
                       for k in range(len(shape)))
        p = subblock_params(x, rp, origin)
        rows.append(subblock_vs_plain(
            f"{name}@{'_'.join(map(str, origin))}", x, p, dev, False)[0])
    step_ns = subblock_step_ns(dev)
    for name, shape, dtype, rp, seed, noise in SUBBLOCK_TIMED:
        x, _ = classic_field(shape, dtype, rp, seed, noise)
        p = subblock_params(x, rp, (3,) * len(shape))
        row, ent = subblock_vs_plain(name, x, p, dev, True, step_ns)
        rows.append(row)
        if name == "main_path_256":
            entries.update(ent)
        del x
        torch.cuda.empty_cache()
    return rows, entries


def classic_strip_report(ptxas: list) -> list:
    """K10/K11's ten kernels: ptxas's registers, stack and spills, and
    the block's warps and dynamic shared memory (classic_kernel's mirror
    of strips.cuh shared_bytes)."""
    import torch
    from sz_tpu_torch.gpu import classic_kernel as ck
    rows = []
    for kernel in ("classic_quantize", "classic_decode"):
        for form in ("2d", "3d", "4d", "2d_f64", "3d_f64"):
            name = f"{kernel}{form}_kernel"
            dtype = torch.float64 if form.endswith("f64") else torch.float32
            regs, spill = ptxas_of(ptxas, name)
            rows.append(dict(kernel=name, warps=ck.WARPS[dtype],
                             shared_bytes=ck.shared_bytes(
                                 dtype, kernel == "classic_decode"),
                             registers=regs, spill=spill))
    for row in rows:
        _log("K10/K11 strips", **row)
    return rows


TS_KERNELS = ("ts_quantize_kernel", "ts_quantize_f64_kernel",
              "ts_quantize_escapes_kernel", "ts_quantize_escapes_f64_kernel",
              "ts_decode_kernel", "ts_decode_f64_kernel",
              "ts_decode_escapes_kernel", "ts_decode_escapes_f64_kernel")


def temporal_report(ptxas: list) -> list:
    """K14/K15's kernels (pass A and pass B of each, both dtypes):
    ptxas's registers and spills."""
    rows = []
    for name in TS_KERNELS:
        regs, spill = ptxas_of(ptxas, name)
        rows.append(dict(kernel=name, registers=regs, spill=spill))
        _log("K14/K15 kernels", **rows[-1])
    return rows


def strip_parent_timing(parent: str, kernels: str) -> list:
    """The kernels of tools/strip_timing.py's ``--kernels`` list (classic:
    K10/K11, lorenzo64: K1d/K2d, temporal: K14/K15, int: K16/K17) of the
    parent tree at ``parent`` and of this tree, timed in fresh processes,
    in turns: parent, this, this, parent."""
    keys = (("classic_quantize_ms", "classic_decode_ms"),
            ("wavefront_quantize_f64_ms", "wavefront_decode_f64_ms"),
            ("ts_quantize_ms", "ts_quantize_bare_ms", "ts_decode_ms",
             "ts_decode_bare_ms"),
            ("int_quantize_ms", "int_quantize_bare_ms", "int_decode_ms",
             "int_decode_bare_ms"))
    runs = []
    for root in (parent, str(REPO), str(REPO), parent):
        res = subprocess.run(
            [sys.executable, str(REPO / "tools" / "strip_timing.py"),
             "--root", root, "--kernels", kernels], capture_output=True,
            text=True)
        if res.returncode:
            raise AssertionError(f"strip_timing.py --root {root} failed:"
                                 f"\n{res.stdout[-3000:]}\n"
                                 f"{res.stderr[-3000:]}")
        rec = json.loads(res.stdout.strip().splitlines()[-1])
        _log("strip and temporal kernels timing", root=root, **{
            r["case"]: next([r[k] for k in ks] for ks in keys if ks[0] in r)
            for r in rec["rows"]})
        runs.append(rec)
    return runs


# --- phase 2: K16/K17 -----------------------------------------------------

# int_field's scale (a power of two) and offset by dtype: values of about
# -5500 to 12600 times 2^(scale - 12) about the offset (the middle of an
# unsigned type)
INT_FIELD = {np.dtype(t): v for t, v in (
    (np.int8, (3, 0)), (np.uint8, (3, 1 << 7)), (np.int16, (10, 0)),
    (np.uint16, (10, 1 << 15)), (np.int32, (12, 0)),
    (np.uint32, (12, 1 << 31)), (np.int64, (12, 0)),
    (np.uint64, (12, 1 << 63)))}


def int_field(shape, seed: int, dtype) -> np.ndarray:
    """An integer field of ``dtype``: ``field`` times 2^scale, rounded,
    plus the dtype's offset (INT_FIELD), modulo the dtype's width.
    ``field`` is exact and so is every step here, so the values are the
    same on every machine; uint64's straddle 2^63 (they read as int64
    values near both its ends, where the reconstruction's double
    conversion leaves the int64 range)."""
    dt = np.dtype(dtype)
    scale, off = INT_FIELD[dt]
    v = np.rint(field(shape, seed).astype(np.float64) * 2.0 ** scale)
    return (v.astype(np.int64).view(np.uint64) + np.uint64(off)).astype(
        f"u{dt.itemsize}").view(dt)


def int_trap_field(kind: str, shape, seed: int) -> np.ndarray:
    """Fields that reach the recurrence's traps: "wrap_int64", rows of
    +-2^62 (a difference of 2^63 wraps to INT64_MIN: its |diff| stays
    negative, "in range", and its type is INT32_MIN + radius); "near_max",
    int64 just below 2^63 (the reconstruction's double rounds to 2^63 and
    converts to INT64_MIN, as x86 does); "random_<dtype>", the whole
    range of a type (escapes, and differences that wrap in DN bits)."""
    rng = np.random.default_rng(seed)
    if kind == "wrap_int64":
        x = rng.integers(-4, 5, shape).astype(np.int64) << 61
        x[..., ::2] = 1 << 62
        return x
    if kind == "near_max":
        return (np.int64(2 ** 63 - 1) - rng.integers(0, 3000, shape)) \
            .astype(np.int64)
    dt = np.dtype(kind.removeprefix("random_"))
    bits = rng.integers(0, 256, int(np.prod(shape)) * dt.itemsize,
                        dtype=np.uint8)
    return bits.view(dt).reshape(shape)


def int_params(xt, dt, rp: float, sample_distance: int) -> int:
    """The intervals the integer codec's optimizer picks (threshold 0.99,
    radius 32768)."""
    from sz_tpu_torch.core import intc
    from sz_tpu_torch.gpu import int_kernel as ik
    perr = ik.optimizer_samples_int(xt, dt, sample_distance)
    return intc.optimize_intervals(perr, perr.size, rp, 32768,
                                   np.float32(0.99))


def int_escapes(xt, t, dt):
    """The escapes' values in raster order as a stream holds them (int64;
    the escaped 4-D quirk cells, (l, 0, 0, 1), hold the first element)."""
    import torch
    from sz_tpu_torch.gpu import int_kernel as ik
    w = ik.widen(xt, dt)
    if xt.dim() == 4 and xt.shape[-1] > 1:
        v = w.reshape(xt.shape[0], -1)
        v[:, 1] = torch.where(t.reshape(xt.shape[0], -1)[:, 1] == 0,
                              w.reshape(-1)[0], v[:, 1])
    return w.reshape(-1)[t.reshape(-1) == 0].contiguous()


def int_ops(shape, escapes: int, decode: bool, wide: bool = True,
            arith: str = "exact") -> tuple:
    """(32-bit, 64-bit) operations of one K16/K17 call in its forms: the
    stencil's adds by position (counted as classic_ops counts them; two
    32-bit operations each on an int64 ring, ``wide``); the encoder's
    quantizer at every point but a volume's first: the difference and
    its wrap (two integer operations a width), then in the exact form
    the divide, add, two multiplies and add in double, in the reciprocal
    form a multiply, two adds, a truncation and a multiply, in the
    integer form the absolute value, a multiply-high (two 64-bit
    operations), a multiply and an add in 32 bits; the decoder's
    reconstruction at every point that is not an escape: a multiply and
    an add in double, or (integer form) two 32-bit operations."""
    pred32 = classic_ops(shape, escapes, True, False, True)[0]  # stencil
    pred32 *= 2 if wide else 1
    n = int(np.prod(shape))
    vol = shape[-3:] if len(shape) >= 3 else (1,) + tuple(shape)
    q = n - n // int(np.prod(vol))
    if decode:
        if arith == "integer":
            return pred32 + 2 * (n - escapes), 0
        return pred32, 2 * (n - escapes)
    w = 4 if wide else 2
    if arith == "integer":
        return pred32 + (w + 3) * q, 2 * q
    return pred32 + w * q, 5 * q


def int_vs_plain(name, x: np.ndarray, rp: float, dev, timed: bool,
                 bound_ok: bool, step_ns=None) -> tuple:
    """K16 and K17 against their plain versions on one field: each kernel
    called twice, bit-equal; K17 on the escapes as the stream holds
    them; one launch a call, 4-D included; where ``bound_ok`` (no wrap, values below 2^53), K17's values within
    ceil(rp) of the data but at the 4-D quirk cells.  Above
    PLAIN_MAX_POINTS the plain versions run on a leading box
    (plain_box).  The row names the forms each kernel took.  Timed: the
    kernels' mean time, the plain versions' one call on the box, the byte
    bound and, with ``step_ns`` (K16's and K17's one-row step latency,
    int_step_ns), the chain bound: r1 + r2 + r3 - 2 such steps."""
    from sz_tpu_torch.gpu import int_kernel as ik
    dt = x.dtype
    xt = ik.to_carrier(x, dev)
    quirk = x.ndim == 4
    # the main path's sample distance at full size; every 5th point on
    # the small fields, where 100 would leave the histogram empty
    iv = int_params(xt, dt, rp, 100 if timed else 5)
    radius = iv // 2
    form = ik.quantize_form(dt, rp, iv)
    sub = plain_box(x.shape, 2 * ik.WARPS + 1)
    launches = ik.int_quantize.launches
    t_k = ik.int_quantize(xt, dt, rp, iv, radius, quirk)
    launches = ik.int_quantize.launches - launches
    e_again = bit_equal(t_k, ik.int_quantize(xt, dt, rp, iv, radius,
                                             quirk))
    t_p, enc_plain_ms = cuda_once(lambda: ik.int_quantize_plain(
        xt[sub].contiguous(), dt, rp, iv, radius, quirk))
    e_err = max_abs_err(t_k[sub], t_p)
    plain_on = list(t_p.shape)
    del t_p
    esc = int_escapes(xt, t_k, dt)
    d_launches = ik.int_decode.launches
    o_k = ik.int_decode(t_k, esc, dt, 2 * rp, radius)
    d_launches = ik.int_decode.launches - d_launches
    rb = ik.escape_row_base(t_k)[0]
    d_again = bit_equal(o_k, ik.int_decode(t_k, esc, dt, 2 * rp, radius,
                                           row_base=rb))
    t_sub = t_k[sub].contiguous()
    esc_sub = int_escapes(xt[sub].contiguous(), t_sub, dt)
    o_p, dec_plain_ms = cuda_once(lambda: ik.int_decode_plain(
        t_sub, esc_sub, dt, 2 * rp, radius))
    d_err = max_abs_err(o_k[sub], o_p)
    del o_p, t_sub, esc_sub
    escapes = int(esc.numel())
    row = dict(case=name, shape=list(x.shape), dtype=dt.name, rp=rp,
               intervals=iv, escapes=escapes,
               quantize_form=f"{form.ring}/{form.arith}",
               decode_form=ik.decode_form(dt, 2 * rp)[0],
               negative_types=int((t_k < 0).sum()), plain_on=plain_on,
               launches_a_call=launches, decode_launches_a_call=d_launches,
               encode_bit_equal=e_err == 0.0,
               encode_repeat_bit_equal=e_again,
               decode_bit_equal=d_err == 0.0, decode_repeat_bit_equal=d_again)
    if bound_ok:
        err = (ik.widen(o_k, dt) - ik.widen(xt, dt)).abs()
        if quirk:
            err.reshape(x.shape[0], -1)[:, 1] = 0
        row["decode_max_abs_err"] = int(err.max())
        # the reference's truncated reconstruction stays within ceil(rp)
        row["decode_within_bound"] = \
            row["decode_max_abs_err"] <= math.ceil(rp)
    entries = {}
    if timed:
        runs = {  # each input read once, each output written once
            "int_quantize": (
                e_err, lambda: ik.int_quantize(xt, dt, rp, iv, radius,
                                               quirk),
                enc_plain_ms, nbytes(xt, t_k), int_ops(
                    x.shape, escapes, False, ik.QUANT_FORMS[form.ring][0]
                    == 8, form.arith)),
            "int_decode": (
                d_err, lambda: ik.int_decode(t_k, esc, dt, 2 * rp, radius,
                                             row_base=rb),
                dec_plain_ms, nbytes(t_k, esc, rb, o_k),
                int_ops(x.shape, escapes, True, dt.itemsize == 8,
                        row["decode_form"])),
        }
        for key, (err, kern, plain_ms, nb, ops) in runs.items():
            ms = cuda_ms(kern, 3)
            b_ms, b_by = bound(nb, *ops)
            row[key] = dict(ms=ms, plain_ms=plain_ms, plain_on=plain_on,
                            bound_ms=b_ms, bound_by=b_by)
            if step_ns:
                row[key]["chain_ms"] = classic_chain_steps(x.shape) * \
                    step_ns[f"{key}_ns"] * 1e-6
            entries[key] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                                plain_shape=plain_on, bound_ms=b_ms,
                                bound_by=b_by, library_ms=None,
                                shape=list(x.shape))
    _log("kernel K16/K17 int vs plain", **row)
    if not all(row[k] for k in (
            "encode_bit_equal", "encode_repeat_bit_equal", "decode_bit_equal",
            "decode_repeat_bit_equal")) or not row.get(
                "decode_within_bound", True):
        raise AssertionError(f"K16/K17 differ from their plain versions or "
                             f"from themselves on {name}: {row}")
    if launches != 1 or d_launches != 1:
        raise AssertionError(f"K16/K17 took {launches} / {d_launches} "
                             f"launches on {name}, not one a call")
    return row, entries


# K16/K17's strip edges (as CLASSIC_EDGE_SHAPES): strips of 31, 33 and 65
# rows, rank-2 fields of several strip groups, plane counts no multiple of
# a block's warps, rows of 2, CHUNK - 1 and CHUNK + 1 columns, one row,
# one plane, 4-D fields (their quirk cell in every volume)
INT_EDGE_SHAPES = [
    (31, 40), (33, 17), (65, 15), (300, 70), (1, 700), (7, 31, 40),
    (13, 33, 17), (5, 65, 15), (9, 40, 2), (1, 70, 90), (4, 1, 300),
    (3, 7, 33, 17), (5, 2, 65, 15), (16, 8, 8, 8),
]
INT_EDGE_DTYPES = (np.int8, np.uint16, np.int32, np.uint32, np.int64,
                   np.uint64)
# the main path's 512^3 int32 field, timed: ABS 4 (the kernels' integer
# forms; its entries are the kernels' line) and ABS 2.5 (K16's
# reciprocal form)
INT_TIMED = ("full_size_512", (512, 512, 512), np.int32, 42, 4.0)
INT_TIMED_RECIP = ("full_size_512_abs2.5", (512, 512, 512), np.int32, 42,
                   2.5)
# (maker, shape, rp): each ring form and arithmetic form of K16 and K17
# (int_kernel.quantize_form / decode_form), uint32 values on both sides
# of 2^31 through K17's 32-bit ring and its double form; rp = 1 + 2^-45 puts every small odd |diff| within the reciprocal's tolerance
# of a boundary (the exact chain on those lanes)
INT_FORM_CASES = (
    ("int32", (13, 33, 40), 1.0), ("int32", (65, 70), 1.0 + 2.0 ** -45),
    ("int32", (9, 40, 35), 2.0 ** 40), ("uint32", (13, 33, 40), 0.3),
    ("uint32", (65, 70), 4.0), ("uint16", (9, 40, 35), 4.0),
    ("int8", (9, 40, 35), 2.5), ("uint16", (65, 70), 0.3),
    ("int8", (65, 70), 2.0 ** 21), ("int16", (9, 40, 35), 2.0 ** 29),
    ("int16", (65, 70), 0.3), ("uint8", (3, 7, 33, 17), 0.3),
    ("int64", (9, 40, 35), 0.3), ("uint64", (65, 70), 1.5),
)
# what phase 2 must reach: K16's ring forms and arithmetic forms, K17's
INT_FORMS_REACHED = ({"r32", "small", "u32", "i64"},
                     {"integer", "recip", "exact"}, {"integer", "exact"})


# one-row lattices (a single chain of r3 steps) of the timed kernels'
# forms: (shape, dtype, rp)
INT_STEP_CASES = {"3d_abs4": ((1, 1, 1 << 16), np.int32, 4.0),
                  "3d_abs2.5": ((1, 1, 1 << 16), np.int32, 2.5),
                  "2d_int16_abs4": ((1, 1 << 16), np.int16, 4.0)}


def int_step_ns(dev) -> dict:
    """One point step's latency (ns) of K16 and K17 in the timed forms,
    from one-row lattices (intervals fixed at 65536: a row has no
    optimizer samples)."""
    from sz_tpu_torch.gpu import int_kernel as ik
    out = {}
    for key, (shape, dt, rp) in INT_STEP_CASES.items():
        dt = np.dtype(dt)
        xt = ik.to_carrier(int_field(shape, 3, dt), dev)
        t = ik.int_quantize(xt, dt, rp, 65536, 32768)
        esc = int_escapes(xt, t, dt)
        rb = ik.escape_row_base(t)[0]
        f = ik.quantize_form(dt, rp, 65536)
        enc = cuda_ms(lambda: ik.int_quantize(xt, dt, rp, 65536, 32768), 3)
        dec = cuda_ms(lambda: ik.int_decode(t, esc, dt, 2 * rp, 32768,
                                            row_base=rb), 3)
        out[key] = dict(shape=list(shape), dtype=dt.name, rp=rp,
                        quantize_form=f"{f.ring}/{f.arith}",
                        decode_form=ik.decode_form(dt, 2 * rp)[0],
                        int_quantize_ns=enc * 1e6 / shape[-1],
                        int_decode_ns=dec * 1e6 / shape[-1])
        _log("K16/K17 step latency", case=key, **out[key])
    return out


def phase_int_cases(dev) -> tuple:
    """Phase 2, K16/K17: the strip edges in six dtypes, the traps, the
    forms, and the main path's 512^3 int32 timed under ABS 4 and 2.5.
    Returns (rows, timed record entries: ABS 4's)."""
    import torch
    rows, turn = [], {2: 0, 3: 0, 4: 0}
    for n, shape in enumerate(INT_EDGE_SHAPES):
        # two dtypes a shape, in turn by rank: each dtype meets each rank
        for m in range(2):
            dt = np.dtype(INT_EDGE_DTYPES[turn[len(shape)] % 6])
            turn[len(shape)] += 1
            x = int_field(shape, 300 + 7 * n + m, dt)
            rows.append(int_vs_plain(
                f"edge_{'x'.join(map(str, shape))}_{dt.name}", x, 4.0, dev,
                False, dt != np.uint64)[0])
    for kind, shape, rp in (
            ("wrap_int64", (40, 70), 4.0), ("wrap_int64", (6, 33, 40), 4.0),
            ("near_max", (9, 40, 35), 1000.0),
            ("near_max", (2, 5, 33, 17), 4.0),
            ("random_int8", (33, 70), 0.5),
            ("random_uint16", (5, 40, 33), 4.0),
            ("random_int32", (70, 33), 0.5),
            ("random_uint32", (5, 33, 20), 4.0),
            ("random_int64", (3, 4, 33, 17), 0.5),
            ("random_uint64", (40, 33), 2.0 ** 40)):
        x = int_trap_field(kind, shape, 17)
        rows.append(int_vs_plain(f"trap_{kind}_{'x'.join(map(str, shape))}",
                                 x, rp, dev, False, False)[0])
    if not any(r["negative_types"] for r in rows):
        raise AssertionError("no K16 case reached a negative type")
    for n, (maker, shape, rp) in enumerate(INT_FORM_CASES):
        x = int_field(shape, 500 + n, maker)
        rows.append(int_vs_plain(
            f"form_{maker}_{'x'.join(map(str, shape))}_rp{rp!r}", x, rp,
            dev, False, rp < 2 ** 20 and x.dtype != np.uint64)[0])
    steps = int_step_ns(dev)
    for (name, shape, dt, seed, rp), step in (
            (INT_TIMED_RECIP, steps["3d_abs2.5"]),
            (INT_TIMED, steps["3d_abs4"])):
        row, entries = int_vs_plain(name, int_field(shape, seed, dt), rp,
                                    dev, True, True, step)
        rows.append(row)
        torch.cuda.empty_cache()
    reached = ({r["quantize_form"].split("/")[0] for r in rows},
               {r["quantize_form"].split("/")[1] for r in rows},
               {r["decode_form"] for r in rows})
    _log("K16/K17 forms reached", ring=sorted(reached[0]),
         k16=sorted(reached[1]), k17=sorted(reached[2]))
    for want, got in zip(INT_FORMS_REACHED, reached):
        if not want <= got:
            raise AssertionError(f"K16/K17 forms {sorted(want - got)} "
                                 f"unreached in phase 2")
    rows.append(dict(case="step_latency", **steps))
    return rows, entries


def int_strip_report(ptxas: list) -> list:
    """K16/K17's eighteen kernels: ptxas's registers, stack and spills,
    the block's dynamic shared memory (int_kernel's mirror of strips.cuh
    shared_bytes), the blocks an SM its __launch_bounds__ asks, and the
    runtime's registers, local bytes and resident blocks an SM at those
    shared bytes; fails where a kernel runs fewer blocks an SM than it
    asks."""
    from sz_tpu_torch.gpu import int_kernel as ik
    rows = []
    for name, (item, slot, rank, asks) in ik.kernels().items():
        regs, spill = ptxas_of(ptxas, name)
        info = ik.kernel_info(name)
        rows.append(dict(kernel=name, warps=ik.WARPS, ring=ik.RING[rank],
                         shared_bytes=ik.shared_bytes(item, slot, rank),
                         min_blocks=asks, ptxas_registers=regs,
                         spill=spill, **info))
        _log("K16/K17 strips", **rows[-1])
        if info["blocks_an_sm"] < asks:
            raise AssertionError(f"{name}: {rows[-1]}")
    return rows


# --- phase 2: K14/K15 -----------------------------------------------------

TS_CASE_NAMES = ("equal", "all_escape", "n3", "n21", "tile_plus_one",
                 "subnormal", "nan_inf", "fixed_intervals", "drift",
                 "tile_minus_one", "tile", "tiles_plus_three")
# the inputs K14/K15 read that phase 2 also hands them as views at storage
# offset 1 (not 16-byte aligned), one at a time and all together, on
# TS_OFFSET_CASE
TS_OFFSETS = (("cur",), ("prev",), ("types",), ("vals",),
              ("cur", "prev", "types", "vals"))
TS_OFFSET_CASE = "tiles_plus_three"
TS_REPS = 20


def ts_points(name: str) -> int:
    """The points of ts_case ``name``: the edges of temporal.cu's larger
    tile, a multiple of the smaller, so edges of both (a tile less one, a
    tile, a tile plus one, three tiles plus three: a ragged tail of a
    slot), 3, 21, else 5000."""
    from sz_tpu_torch.gpu import temporal_kernel as tk
    tile = max(tk.QUANTIZE_TILE, tk.DECODE_TILE)
    return {"n3": 3, "n21": 21, "tile_minus_one": tile - 1, "tile": tile,
            "tile_plus_one": tile + 1,
            "tiles_plus_three": 3 * tile + 3}.get(name, 5000)


def ts_case(name: str, dtype) -> tuple:
    """(cur, prev, rp, compress_1d_ts keywords) of a K14/K15 edge case: a
    step equal to its history (every type radius but the first two), a
    step in which every point escapes, 3, 21 points and the tile edges
    of ts_points, subnormal values under a subnormal bound, NaN and +-inf
    in the step and the history, fixed intervals, and a drift with
    jumps."""
    rng = np.random.default_rng(TS_CASE_NAMES.index(name))
    n = ts_points(name)
    prev = np.sin(np.linspace(0, 30, n)).astype(dtype)
    cur = (prev + 0.002 * rng.standard_normal(n)).astype(dtype)
    cur[::97] += dtype(1.5)
    kw, rp = {}, 1e-3
    if name == "equal":
        cur = prev.copy()
    elif name == "all_escape":
        cur = (prev + 10 + rng.random(n)).astype(dtype)
        kw = dict(opt_quant_mode=0, fixed_intervals=64)
    elif name == "subnormal":
        tiny = np.finfo(dtype).tiny
        prev = (rng.integers(-8, 9, n) * tiny / 4).astype(dtype)
        cur = (prev + rng.integers(-3, 4, n) * tiny / 8).astype(dtype)
        rp = float(tiny)
    elif name == "nan_inf":
        cur[5:40:3] = np.nan
        cur[7:40:5] = np.inf
        cur[8:40:7] = -np.inf
        prev[50:60] = np.nan
        prev[60:70] = np.inf
        cur[60:65] = np.inf
    elif name == "fixed_intervals":
        kw = dict(opt_quant_mode=0, fixed_intervals=256)
    return cur, prev, rp, kw


def same_bits(a, b) -> bool:
    """Equal shapes and bits (NaN payloads and signed zeros included)."""
    import torch
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if a.dtype.is_floating_point:
        view = torch.int32 if a.element_size() == 4 else torch.int64
        a, b = a.view(view), b.view(view)
    return torch.equal(a, b)


def ts_params(cur, prev, rp: float, kw: dict) -> tuple:
    """(intervals, radius, req_length, median) of a temporal step on the
    card, derived as compress_1d_ts derives them."""
    import torch
    from sz_tpu_torch.config import float_type
    from sz_tpu_torch.core import classic
    from sz_tpu_torch.temporal import optimize_intervals_1d_ts
    T = float_type(cur.dtype)
    lo, hi = (T(v) for v in torch.stack(torch.aminmax(cur)).tolist())
    vr = T(hi - lo)
    med = T(lo + vr / T(2))
    intervals = kw.get("fixed_intervals", 0)
    if kw.get("opt_quant_mode", 1) == 1:
        intervals = optimize_intervals_1d_ts(cur, prev, rp, 32768, 100,
                                             np.float32(0.99))
    req, med = classic.req_length_median(rp, vr, med, T)
    return intervals, intervals // 2, req, med


def offset_view(t, shift: int = 1):
    """``t``'s values from ``shift`` elements into a buffer of its own on
    its device: a contiguous view whose data_ptr is not 16-byte
    aligned."""
    buf = t.new_empty(t.numel() + shift)
    buf[shift:].copy_(t.reshape(-1))
    return buf[shift:].view(t.shape)


def ts_vs_plain(name, cur, prev, rp: float, kw: dict, timed: bool,
                offset=()) -> tuple:
    """K14 and K15 against their plain versions on one step (tensors on
    the card), each called twice, bit-equal: K14's types, reconstruction,
    compact escapes and count; K15 on K14's types with the escapes'
    reconstructions (what a decoder reads from the stream), which must
    rebuild K14's reconstruction, and with one escape too few (the last
    escape NaN, the count unchanged).  The inputs named in ``offset``
    (cur, prev, types, vals) reach the kernels as offset_view()s.  Timed:
    the kernels' mean time, the plain versions' one call, the bounds
    (each input read once, each output written once: 16 bytes a float32
    point and 28 a float64 one for K14, 12 and 20 for K15, and each
    escape's value once)."""
    from sz_tpu_torch.gpu import temporal_kernel as tk
    intervals, radius, req, med = ts_params(cur, prev, rp, kw)
    qa = (rp, intervals, radius, req, med)
    if "cur" in offset:
        cur = offset_view(cur)
    if "prev" in offset:
        prev = offset_view(prev)
    k = tk.ts_quantize(cur, prev, *qa)
    again = tk.ts_quantize(cur, prev, *qa)
    p, q_plain_ms = cuda_once(lambda: tk.ts_quantize_plain(cur, prev, *qa))
    count = int(k[3])

    def q_equal(a, b):
        return (same_bits(a[0], b[0]) and same_bits(a[1], b[1])
                and int(a[3]) == int(b[3]) == count
                and same_bits(a[2][:count], b[2][:count]))
    types, recon = k[0], k[1]
    dvals = recon[types == 0]
    if "types" in offset:
        types = offset_view(types)
    if "vals" in offset:
        dvals = offset_view(dvals)
    da = (radius, 2 * rp)
    d = tk.ts_decode(types, prev, dvals, *da)
    d_again = tk.ts_decode(types, prev, dvals, *da)
    dp, d_plain_ms = cuda_once(lambda: tk.ts_decode_plain(types, prev, dvals,
                                                          *da))
    short = tk.ts_decode(types, prev, dvals[:-1], *da)
    short_p = tk.ts_decode_plain(types, prev, dvals[:-1], *da)
    row = dict(
        case=name, dtype=str(cur.dtype).removeprefix("torch."),
        points=cur.numel(), offset=list(offset), intervals=intervals,
        escapes=count,
        quantize_bit_equal=q_equal(k, p), quantize_repeat=q_equal(k, again),
        decode_bit_equal=same_bits(d[0], dp[0]) and int(d[1]) == int(dp[1])
        == count, decode_repeat=same_bits(d[0], d_again[0]),
        decode_rebuilds_recon=same_bits(d[0], recon),
        short_escapes_alike=same_bits(short[0], short_p[0])
        and int(short[1]) == int(short_p[1]) == count)
    if name == "equal" and not (count == 2 and bool(
            (types[2:] == radius).all())):
        raise AssertionError(f"{name}: {count} escapes")
    if name.startswith("all_escape") and count != cur.numel():
        raise AssertionError(f"{name}: {count} escapes")
    entries = {}
    if timed:
        n, es = cur.numel(), cur.element_size()
        runs = {
            "ts_quantize": (lambda: tk.ts_quantize(cur, prev, *qa),
                            q_plain_ms, n * (3 * es + 4) + count * es,
                            5 * n),
            "ts_decode": (lambda: tk.ts_decode(types, prev, dvals, *da),
                          d_plain_ms, n * (2 * es + 4) + count * es, 2 * n),
        }
        for key, (kern, plain_ms, moved, ops64) in runs.items():
            ms = cuda_ms(kern, TS_REPS)
            b_ms, b_by = bound(moved, ops64=ops64)
            row[key] = dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                            bound_by=b_by)
            entries[key] = dict(max_abs_err=0.0, ms=ms, plain_ms=plain_ms,
                                bound_ms=b_ms, bound_by=b_by,
                                library_ms=None, shape=list(cur.shape))
    _log("kernel K14/K15 temporal vs plain", **row)
    if not all(v for v in row.values() if isinstance(v, bool)):
        raise AssertionError(f"K14/K15 differ from their plain versions or "
                             f"from themselves on {name}: {row}")
    return row, entries


def phase_ts_cases(dev) -> tuple:
    """Phase 2, K14/K15: the edge cases of ts_case in float32 and float64,
    TS_OFFSET_CASE with the inputs of TS_OFFSETS at storage offset 1, an
    all-escape step of 2^24 points (the staging full), then 2^24 points
    (256^3's field and field64, step 1 against step 0 of ts_step), timed.
    Returns (rows, the float32 2^24 entries)."""
    import torch
    rows, entries = [], {}
    for T in (np.float32, np.float64):
        for name in TS_CASE_NAMES:
            cur, prev, rp, kw = ts_case(name, T)
            rows.append(ts_vs_plain(
                name, torch.from_numpy(cur).to(dev),
                torch.from_numpy(prev).to(dev), rp, kw, False)[0])
        cur, prev, rp, kw = ts_case(TS_OFFSET_CASE, T)
        for offset in TS_OFFSETS:
            rows.append(ts_vs_plain(
                TS_OFFSET_CASE, torch.from_numpy(cur).to(dev),
                torch.from_numpy(prev).to(dev), rp, kw, False, offset)[0])
        g = torch.Generator(device=dev).manual_seed(16)
        prev = torch.rand(1 << 24, generator=g, device=dev,
                          dtype=torch.float64).to(getattr(torch, T.__name__))
        cur = prev + 10 + torch.rand(1 << 24, generator=g, device=dev,
                                     dtype=prev.dtype)
        rows.append(ts_vs_plain("all_escape_2^24", cur, prev, ABS,
                                dict(opt_quant_mode=0, fixed_intervals=64),
                                False)[0])
        x0 = (field if T is np.float32 else field64)((256, 256, 256), 42)
        cur, prev = (torch.from_numpy(ts_step(x0, s, 42).reshape(-1)).to(dev)
                     for s in (1, 0))
        row, ent = ts_vs_plain("2^24", cur, prev, ABS, {}, True)
        rows.append(row)
        if T is np.float32:
            entries = ent
        del cur, prev
        torch.cuda.empty_cache()
    return rows, entries


# --- phase 3: the main path -----------------------------------------------

def phase_main_path(dev, record: dict, ts_steps: dict) -> None:
    import sz_tpu_torch
    from sz_tpu_torch import ErrorBoundMode, SZConfig

    cfg = SZConfig().with_bound(ErrorBoundMode.ABS, ABS)
    rows = []
    for name, (shape, seed, want_stream, want_recon) in ORACLE.items():
        x = field(shape, seed)
        t0 = time.perf_counter()
        blob = sz_tpu_torch.compress(x, cfg, device=dev)
        t1 = time.perf_counter()
        out = sz_tpu_torch.decompress(blob, x.shape, np.float32, device=dev)
        t2 = time.perf_counter()
        if sha256(blob) != want_stream:
            raise AssertionError(f"{name}: stream differs from the oracle")
        if sha256(out.tobytes()) != want_recon:
            raise AssertionError(f"{name}: decode differs from the oracle")
        err = float(np.abs(out.astype(np.float64) - x).max())
        if err > ABS:
            raise AssertionError(f"{name}: error {err} above the bound")
        row = dict(case=name, shape=list(shape), stream_sha256_equal=True,
                   decode_sha256_equal=True, ratio=x.nbytes / len(blob),
                   max_abs_err=err, port_compress_s=t1 - t0,
                   port_decompress_s=t2 - t1)
        _log("main path", **row)
        rows.append(row)
    golden = REPO / "tests" / "golden"
    want = np.fromfile(golden / "f32_3d64_abs1e-3.out", dtype="<f4")
    got = sz_tpu_torch.decompress(
        (golden / "f32_3d64_abs1e-3.sz").read_bytes(), (64, 64, 64),
        np.float32, device=dev)
    if not np.array_equal(got.reshape(-1).view(np.uint32),
                          want.view(np.uint32)):
        raise AssertionError("golden f32_3d64_abs1e-3 decodes differently")
    _log("main path", case="golden_f32_3d64_abs1e-3", decode_bit_equal=True)
    cfg = SZConfig().with_bound(ErrorBoundMode.PW_REL, PW_REL)
    for name, (kind, shape, seed, want_stream, want_recon) in \
            ORACLE_PWREL.items():
        x = pwrel_field(kind, shape, seed)
        t0 = time.perf_counter()
        blob = sz_tpu_torch.compress(x, cfg, device=dev)
        t1 = time.perf_counter()
        out = sz_tpu_torch.decompress(blob, x.shape, np.float32, device=dev)
        t2 = time.perf_counter()
        if sha256(blob) != want_stream:
            raise AssertionError(f"{name}: stream differs from the oracle")
        if sha256(out.tobytes()) != want_recon:
            raise AssertionError(f"{name}: decode differs from the oracle")
        row = dict(case=name, shape=list(shape), bound="PW_REL 1e-3",
                   stream_sha256_equal=True, decode_sha256_equal=True,
                   ratio=x.nbytes / len(blob), zeros=int((x == 0).sum()),
                   negatives=int((x < 0).sum()),
                   max_rel_err=pointwise_err(x, out),
                   port_compress_s=t1 - t0, port_decompress_s=t2 - t1)
        _log("main path", **row)
        rows.append(row)
    for name, shape in (("f32_2d_pwrel1e-3", (128, 64)),
                        ("f32_3d_pwrel1e-3", (128, 8, 8))):
        want = np.fromfile(golden / f"{name}.out", dtype="<f4")
        got = sz_tpu_torch.decompress((golden / f"{name}.sz").read_bytes(),
                                      shape, np.float32, device=dev)
        if not np.array_equal(got.reshape(-1).view(np.uint32),
                              want.view(np.uint32)):
            raise AssertionError(f"golden {name} decodes differently")
        _log("main path", case=f"golden_{name}", decode_bit_equal=True)
    main_path_f64(dev, rows)
    main_path_tensor_input(dev, rows)
    main_path_classic(dev, rows)
    main_path_pwrel64(dev, rows)
    main_path_ra(dev, rows)
    main_path_temporal(dev, rows, ts_steps)
    main_path_int(dev, rows)
    record["main_path"] = rows


def main_path_pwrel64(dev, rows: list) -> None:
    """Phase 3, MSST19 PW_REL 1e-3 on float64 data (K8d, K9d): the
    ORACLE_PWREL64 fields' streams and decodes hash to the oracle's and
    hold the point-wise bound."""
    import sz_tpu_torch
    from sz_tpu_torch import ErrorBoundMode, SZConfig

    cfg = SZConfig().with_bound(ErrorBoundMode.PW_REL, PW_REL)
    for name, (kind, shape, seed, want_stream, want_recon) in \
            ORACLE_PWREL64.items():
        x = pwrel_field64(kind, shape, seed)
        t0 = time.perf_counter()
        blob = sz_tpu_torch.compress(x, cfg, device=dev)
        t1 = time.perf_counter()
        out = sz_tpu_torch.decompress(blob, x.shape, np.float64, device=dev)
        t2 = time.perf_counter()
        if sha256(blob) != want_stream:
            raise AssertionError(f"{name}: stream differs from the oracle")
        if out.dtype != np.float64 or sha256(out.tobytes()) != want_recon:
            raise AssertionError(f"{name}: decode differs from the oracle")
        row = dict(case=name, dtype="float64", shape=list(shape),
                   bound="PW_REL 1e-3", stream_sha256_equal=True,
                   decode_sha256_equal=True, ratio=x.nbytes / len(blob),
                   zeros=int((x == 0).sum()), negatives=int((x < 0).sum()),
                   max_rel_err=pointwise_err(x, out),
                   port_compress_s=t1 - t0, port_decompress_s=t2 - t1)
        _log("main path", **row)
        rows.append(row)


def main_path_ra(dev, rows: list) -> None:
    """Phase 3, the random-access codec, ABS 1e-3 (K12, K13): the
    ORACLE_RA fields' streams and decodes hash to the oracle's and hold
    the bound; then decompress_region of ra_256's 64^3 corner hashes to
    ORACLE_RA_REGION and equals the whole decode's corner."""
    import sz_tpu_torch
    from sz_tpu_torch import ErrorBoundMode, SZConfig

    cfg = SZConfig(random_access=True).with_bound(ErrorBoundMode.ABS, ABS)
    streams = {}
    for name, (maker, shape, seed, want_stream, want_recon) in \
            ORACLE_RA.items():
        x = classic_input(maker, shape, seed)
        t0 = time.perf_counter()
        blob = sz_tpu_torch.compress(x, cfg, device=dev)
        t1 = time.perf_counter()
        out = sz_tpu_torch.decompress(blob, x.shape, np.float32, device=dev)
        t2 = time.perf_counter()
        if sha256(blob) != want_stream:
            raise AssertionError(f"{name}: stream differs from the oracle")
        if sha256(out.tobytes()) != want_recon:
            raise AssertionError(f"{name}: decode differs from the oracle")
        err = float(np.abs(out.astype(np.float64) - x).max())
        if err > ABS:
            raise AssertionError(f"{name}: error {err} above the bound")
        row = dict(case=name, shape=list(x.shape), bound="ABS 1e-3",
                   random_access=True, stream_sha256_equal=True,
                   decode_sha256_equal=True, ratio=x.nbytes / len(blob),
                   max_abs_err=err, port_compress_s=t1 - t0,
                   port_decompress_s=t2 - t1)
        _log("main path", **row)
        rows.append(row)
        streams[name] = (blob, out)
    start, end, want = ORACLE_RA_REGION
    blob, whole = streams["ra_256"]
    t0 = time.perf_counter()
    reg = sz_tpu_torch.decompress_region(blob, whole.shape, start, end,
                                         np.float32, device=dev)
    dt = time.perf_counter() - t0
    corner = whole[tuple(slice(a, b) for a, b in zip(start, end))]
    if sha256(reg.tobytes()) != want or not np.array_equal(
            reg.view(np.uint32), corner.view(np.uint32)):
        raise AssertionError("ra_256's region decode differs")
    row = dict(case="ra_256_region", start=list(start), end=list(end),
               region_sha256_equal=True, equals_whole_decode=True,
               port_decompress_region_s=dt)
    _log("main path", **row)
    rows.append(row)


def main_path_temporal(dev, rows: list, steps: dict) -> None:
    """Phase 3, temporal compression (K14, K15; K10/K11 on the snapshots,
    K3-K7 on every type stream): the chain of TS_VARS from host arrays,
    each frame and each variable's decode hashing to ORACLE_TEMPORAL and
    holding the bound, the histories on the card."""
    enc, dec = ts_compressors(dev)
    for s, (want_frame, want_dec) in enumerate(ORACLE_TEMPORAL):
        step = {vid: xs[s] for vid, xs in steps.items()}
        t0 = time.perf_counter()
        frame = enc.compress_step(step)
        t1 = time.perf_counter()
        out = dec.decompress_step(frame)
        t2 = time.perf_counter()
        if sha256(frame) != want_frame:
            raise AssertionError(f"temporal step {s}: frame differs from the "
                                 f"oracle")
        errs = {}
        for vid, x in step.items():
            name = TS_VARS[vid][0]
            if out[vid].dtype != x.dtype or \
                    sha256(out[vid].tobytes()) != want_dec[vid]:
                raise AssertionError(f"temporal step {s}: {name}'s decode "
                                     f"differs from the oracle")
            errs[name] = float(np.abs(out[vid].astype(np.float64) - x).max())
            if errs[name] > ABS:
                raise AssertionError(f"temporal step {s}: {name}'s error "
                                     f"{errs[name]} above the bound")
        hist_on = {str(c.vars[vid].hist.device) for c in (enc, dec)
                   for vid in steps}
        if hist_on != {str(dev)}:
            raise AssertionError(f"temporal histories on {hist_on}")
        row = dict(case=f"temporal_step{s}",
                   kinds={TS_VARS[v][0]: ("temporal" if enc.vars[v]
                                          .compress_type else "snapshot")
                          for v in steps},
                   frame_sha256_equal=True, decode_sha256_equal=True,
                   frame_bytes=len(frame),
                   ratio=sum(x.nbytes for x in step.values()) / len(frame),
                   max_abs_err=errs, histories_on=str(dev),
                   port_compress_s=t1 - t0, port_decompress_s=t2 - t1)
        _log("main path", **row)
        rows.append(row)


def phase_temporal_tensor_input(dev, record: dict, steps: dict) -> None:
    """The temporal chain from CUDA tensors (every variable on the card;
    on the temporal steps 1 and 3 views at storage offset 1, which K14
    reads unaligned): the same frames as from host arrays (the
    oracle's), and the copies of each temporal step's compress (a
    torch.profiler trace): no copy up of 5 % of the smaller field or
    more."""
    import torch
    enc, _ = ts_compressors(dev)
    small = min(xs[0].nbytes for xs in steps.values())
    rows = []
    for s, (want_frame, _) in enumerate(ORACLE_TEMPORAL):
        step = {vid: torch.from_numpy(xs[s]).to(dev)
                for vid, xs in steps.items()}
        offset = s in (1, 3)
        if offset:
            step = {vid: offset_view(x) for vid, x in step.items()}
        torch.cuda.synchronize()
        temporal = 0 < s % TS_SNAPSHOT_STEP
        if temporal:
            frame, copies = copies_of(lambda: enc.compress_step(step))
        else:
            frame, copies = enc.compress_step(step), None
        if sha256(frame) != want_frame:
            raise AssertionError(f"temporal step {s} from tensors: the frame "
                                 f"differs from the host arrays'")
        row = dict(case=f"temporal_step{s}_tensor_input",
                   storage_offset_1=offset, frame_sha256_equal=True)
        if copies is not None:
            up, down = sorted(copies["HtoD"]), sorted(copies["DtoH"])
            row.update(h2d_copies=len(up), h2d_bytes=sum(up),
                       h2d_largest=up[-1] if up else 0,
                       d2h_copies=len(down), d2h_bytes=sum(down),
                       d2h_largest=down[-1] if down else 0,
                       frame_bytes=len(frame),
                       fields_bytes=sum(xs[s].nbytes
                                        for xs in steps.values()))
            if min(up + down, default=0) < 0 or \
                    row["h2d_largest"] >= 0.05 * small:
                raise AssertionError(f"temporal step {s}: a field crossed "
                                     f"the link up: {row}")
        _log("temporal tensor input", **row)
        rows.append(row)
        del step
    record["temporal_tensor_input"] = rows


def _rises(wrappers: dict, before: dict) -> dict:
    """Each wrapper's launches since ``before`` (names with none left
    out)."""
    return {k: w.launches - before[k] for k, w in wrappers.items()
            if w.launches - before[k]}


def _counted(wrappers: dict, fn):
    """(fn()'s result, its seconds, the launches it made)."""
    before = {k: w.launches for k, w in wrappers.items()}
    t0 = time.perf_counter()
    out = fn()
    dt = time.perf_counter() - t0
    return out, dt, _rises(wrappers, before)


SURFACE_DIR = REPO / "build" / "smoke_cli"


def _cli(args: list) -> tuple:
    """sz_tpu_torch.cli.main(args) in this process: (its stdout lines,
    the seconds it took)."""
    import io
    from sz_tpu_torch import cli
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        cli.main(args)
    return buf.getvalue().splitlines(), time.perf_counter() - t0


def _printed(lines: list, key: str) -> float:
    """The number a CLI line "<key> = <number>..." prints."""
    line = next(ln for ln in lines if ln.startswith(key))
    return float(line.split("=")[1].split()[0])


def surfaces_cli(dev, rows: list) -> None:
    """The sz-tpu-torch command at full width: the Hurricane field written
    to a file, compressed by cli.main (-z, its default device, the card)
    and decompressed (-x), then compressed again by `python -m
    sz_tpu_torch.cli` in a process of its own; each .sz file hashes to
    ORACLE's stream, the -x file to its decode (the CLI's config is the
    oracle's, ABS 1e-3), and -p prints get_metadata's fields."""
    import sz_tpu_torch
    shape, seed, want_stream, want_recon = ORACLE["hurricane_100x500x500"]
    SURFACE_DIR.mkdir(parents=True, exist_ok=True)
    src = SURFACE_DIR / "hurricane_100x500x500.f32"
    field(shape, seed).tofile(src)
    dims = ["-3", *(str(r) for r in reversed(shape))]
    sz, out = SURFACE_DIR / "inproc.sz", SURFACE_DIR / "inproc.out"
    z_lines, z_s = _cli(["-z", str(sz), "-f", "-i", str(src), "-M", "ABS",
                         "-A", str(ABS), *dims])
    x_lines, x_s = _cli(["-x", str(out), "-f", "-s", str(sz), *dims])
    p_lines, _ = _cli(["-p", "-s", str(sz)])
    meta = sz_tpu_torch.get_metadata(sz.read_bytes())
    printed = [f"{k}: {v}" for k, v in meta.items()]
    sub_sz = SURFACE_DIR / "subprocess.sz"
    t0 = time.perf_counter()
    r = subprocess.run(
        [sys.executable, "-m", "sz_tpu_torch.cli", "-z", str(sub_sz), "-f",
         "-i", str(src), "-M", "ABS", "-A", str(ABS), *dims],
        capture_output=True, text=True, cwd=REPO, timeout=300,
        env=dict(os.environ, PYTHONPATH=str(REPO)))
    sub_s = time.perf_counter() - t0
    if r.returncode:
        raise AssertionError(f"python -m sz_tpu_torch.cli failed: "
                             f"{r.stderr[-2000:]}")
    row = dict(case="cli_hurricane_100x500x500", shape=list(shape),
               stream_sha256_equal=sha256(sz.read_bytes()) == want_stream,
               decode_sha256_equal=sha256(out.read_bytes()) == want_recon,
               subprocess_stream_sha256_equal=(
                   sha256(sub_sz.read_bytes()) == want_stream),
               metadata_printed=p_lines == printed,
               num_elements=meta["num_elements"],
               compression_time_s=_printed(z_lines, "compression time"),
               decompression_time_s=_printed(x_lines, "decompression time"),
               cli_z_wall_s=z_s, cli_x_wall_s=x_s, subprocess_z_wall_s=sub_s)
    _log("surfaces", **row)
    if not all(row[k] for k in (
            "stream_sha256_equal", "decode_sha256_equal",
            "subprocess_stream_sha256_equal", "metadata_printed")):
        raise AssertionError(f"the CLI differs from the oracle: {row}")
    for f in (src, sz, out, sub_sz):
        f.unlink()
    rows.append(row)


def surfaces_region(dev, rows: list) -> None:
    """compress_region at full width (K10's subblock form on ranks 2-3,
    the host recurrence on rank 1): ORACLE_REGION's streams and region
    decodes hash to the oracle's; the decode holds ABS 1e-3 where the
    oracle's does (the reference's quirks, kept, break it on the
    others); compress MB/s of the region."""
    import sz_tpu_torch
    from sz_tpu_torch import ErrorBoundMode, SZConfig
    cfg = SZConfig().with_bound(ErrorBoundMode.ABS, ABS)
    for name, (maker, shape, seed, start, end, holds, want_stream,
               want_recon) in ORACLE_REGION.items():
        x = region_input(maker, shape, seed)
        rshape = tuple(e - s_ for s_, e in zip(start, end))
        sz_tpu_torch.compress_region(x, start, end, cfg, device=dev)  # warm
        t0 = time.perf_counter()
        blob = sz_tpu_torch.compress_region(x, start, end, cfg, device=dev)
        t1 = time.perf_counter()
        out = sz_tpu_torch.decompress(blob, rshape, x.dtype, device=dev)
        t2 = time.perf_counter()
        region = x[tuple(slice(s_, e) for s_, e in zip(start, end))]
        err = float(np.abs(out.astype(np.float64) - region).max())
        mb = region.nbytes / 1e6
        row = dict(case=name, dtype=x.dtype.name, region=list(rshape),
                   start=list(start),
                   stream_sha256_equal=sha256(blob) == want_stream,
                   decode_sha256_equal=sha256(out.tobytes()) == want_recon,
                   max_abs_err=err, bound_held=err <= ABS,
                   bound_held_by_oracle=holds, ratio=region.nbytes / len(blob),
                   compress_s=t1 - t0, compress_MBps=mb / (t1 - t0),
                   decompress_s=t2 - t1, decompress_MBps=mb / (t2 - t1))
        _log("surfaces", **row)
        if not (row["stream_sha256_equal"] and row["decode_sha256_equal"]
                and row["bound_held"] == holds):
            raise AssertionError(f"{name}: compress_region differs from "
                                 f"the oracle: {row}")
        rows.append(row)
        del x, out, region


def surfaces_exafel(dev, rows: list) -> None:
    """The ExaFEL app codec (its SZ stream through the port on the card):
    stream and decode hash to ORACLE_EXAFEL; its peaks decode exactly."""
    from sz_tpu_torch.apps import exafel
    data, kw = exafel_inputs()
    pr = exafel.ExaFELConfig(**kw)
    blob = exafel.compress(pr, data, device=dev)
    out = exafel.decompress(pr, blob, *data.shape, device=dev)
    mask = exafel._roi_mask(pr, *data.shape)
    row = dict(case="exafel_3x2x64x48", shape=list(data.shape),
               stream_sha256_equal=sha256(blob) == ORACLE_EXAFEL[0],
               decode_sha256_equal=sha256(out.tobytes()) == ORACLE_EXAFEL[1],
               roi_exact=bool(np.array_equal(out[mask == 0],
                                             data[mask == 0])),
               ratio=data.nbytes / len(blob))
    _log("surfaces", **row)
    if not all(row[k] for k in ("stream_sha256_equal",
                                "decode_sha256_equal", "roi_exact")):
        raise AssertionError(f"ExaFEL differs from the oracle: {row}")
    rows.append(row)


# the kernels each surface must launch (the counts set to 0 before it)
SURFACE_KERNELS = {
    "cli": ("wavefront_quantize", "wavefront_decode", "histogram",
            "pack_bits", "fsm_sweep", "fsm_scan", "fsm_emit"),
    "region": ("classic_quantize_sub", "histogram", "pack_bits",
               "classic_decode", "fsm_sweep", "fsm_scan", "fsm_emit"),
    "exafel": ("wavefront_quantize", "wavefront_decode", "histogram",
               "pack_bits", "fsm_sweep", "fsm_scan", "fsm_emit"),
}


def phase_surfaces(dev, record: dict, wrappers: dict) -> dict:
    """Phase 3c, the surfaces beside the codec (ROADMAP 1.12): the CLI,
    compress_region and ExaFEL, each driven with every launch count set
    to 0 just before it and read just after; each must launch the
    kernels of SURFACE_KERNELS.  Returns the launches of
    classic_quantize_sub in compress_region's run."""
    rows, launches = [], {}
    for name, run in (("cli", surfaces_cli), ("region", surfaces_region),
                      ("exafel", surfaces_exafel)):
        for w in wrappers.values():
            w.launches = 0
        run(dev, rows)
        launches[name] = {k: w.launches for k, w in wrappers.items()
                          if w.launches}
        _log("surfaces launches", surface=name, **launches[name])
        idle = [k for k in SURFACE_KERNELS[name] if not wrappers[k].launches]
        if idle:
            raise AssertionError(f"{name} never launched {idle}")
    record["surfaces"] = dict(rows=rows, launches=launches)
    return launches["region"]["classic_quantize_sub"]


@contextlib.contextmanager
def host_threads(k: int):
    """SZ_TPU_HOST_THREADS set to ``k`` inside the ``with``."""
    import os
    old = os.environ.get("SZ_TPU_HOST_THREADS")
    os.environ["SZ_TPU_HOST_THREADS"] = str(k)
    try:
        yield
    finally:
        if old is None:
            del os.environ["SZ_TPU_HOST_THREADS"]
        else:
            os.environ["SZ_TPU_HOST_THREADS"] = old


def phase_multi_device(dev, record: dict, wrappers: dict) -> None:
    """Phase 3b, the multi-device slab codec (sz_tpu_torch.parallel.slab)
    with its slabs in flight at once on streams of this card, and the
    random-access blocks split over two devices; the launch counters
    cover exactly this phase, and every kernel of its path must rise."""
    import torch

    from sz_tpu_torch import ErrorBoundMode, SZConfig
    from sz_tpu_torch.parallel import slab

    for w in wrappers.values():
        w.launches = 0
    cfg = SZConfig().with_bound(ErrorBoundMode.ABS, ABS)
    rows = []
    for name, (maker, shape, seed, n, want_blob, want_out) in \
            ORACLE_SLAB.items():
        x = classic_input(maker, shape, seed)
        f64 = "_f64" if x.dtype == np.float64 else ""
        xt = torch.from_numpy(x).to(dev)
        starts = [x.shape[0] * i // n for i in range(n)] + [x.shape[0]]
        slabs = [xt[a:b] for a, b in zip(starts[:-1], starts[1:])]
        runs = {
            "host_array": lambda: slab.compress_sharded(x, cfg, n_devices=n),
            "cuda_tensor": lambda: slab.compress_sharded(xt, cfg,
                                                         n_devices=n),
            "slab_tensors": lambda: slab.compress_sharded(slabs, cfg),
        }
        row = dict(case=name, shape=list(shape), dtype=x.dtype.name,
                   slabs=n, devices=[str(dev)] * n)
        launches = {}
        for run, fn in list(runs.items()) + [("serial_pool", None)]:
            if fn is None:
                with host_threads(1):
                    blob, dt, rise = _counted(wrappers, runs["host_array"])
            else:
                blob, dt, rise = _counted(wrappers, fn)
            if sha256(blob) != want_blob:
                raise AssertionError(f"{name} ({run}): the container "
                                     f"differs from the oracle")
            for k in (f"wavefront_quantize{f64}", "histogram"):
                if rise.get(k) != n:
                    raise AssertionError(f"{name} ({run}): {k} launched "
                                         f"{rise.get(k)} times, not {n}")
            if rise.get("pack_bits", 0) < n:
                raise AssertionError(f"{name} ({run}): pack_bits {rise}")
            launches[run] = rise
            row[f"compress_{run}_s"] = dt
        if any(v != launches["host_array"] for v in launches.values()):
            raise AssertionError(f"{name}: launches differ between the "
                                 f"runs: {launches}")
        out, dt, rise = _counted(
            wrappers, lambda: slab.decompress_sharded(blob, n_devices=n))
        parts, dt_t, rise_t = _counted(
            wrappers, lambda: slab.decompress_sharded(blob, n_devices=n,
                                                      as_tensor=True))
        if sha256(out.tobytes()) != want_out:
            raise AssertionError(f"{name}: the decode differs from the "
                                 f"oracle")
        if len(parts) != n or any(p.device != dev for p in parts) or \
                sha256(torch.cat(parts).cpu().numpy().tobytes()) != want_out:
            raise AssertionError(f"{name}: the as_tensor slabs differ")
        for r in (rise, rise_t):
            if r.get(f"wavefront_decode{f64}") != n or any(
                    r.get(k, 0) < n for k in ("fsm_sweep", "fsm_scan",
                                              "fsm_emit")) or r != rise:
                raise AssertionError(f"{name}: decode launches {r}")
        err = float(np.abs(out.astype(np.float64) - x).max())
        if err > ABS:
            raise AssertionError(f"{name}: error {err} above the bound")
        row.update(container_sha256_equal=True, decode_sha256_equal=True,
                   ratio=x.nbytes / len(blob), max_abs_err=err,
                   decompress_s=dt, decompress_as_tensor_s=dt_t,
                   compress_launches=launches["host_array"],
                   decompress_launches=rise)
        _log("multi-device", **row)
        rows.append(row)
        del x, xt, slabs, out, parts
    rows.append(ra_over_devices(dev, wrappers, [dev, dev]))
    rows.append(four_ranks(dev))
    launches = {k: w.launches for k, w in wrappers.items()}
    _log("multi-device launches", **launches)
    want = ["wavefront_quantize", "wavefront_decode", "wavefront_quantize_f64",
            "wavefront_decode_f64", "histogram", "pack_bits", "fsm_sweep",
            "fsm_scan", "fsm_emit", "ra_encode", "ra_decode"]
    idle = [k for k in want if not launches[k]]
    if idle:
        raise AssertionError(f"the multi-device path never launched {idle}")
    record["multi_device"] = rows
    record["multi_device_launches"] = launches


def ra_over_devices(dev, wrappers: dict, devices: list) -> dict:
    """The random-access codec with its block batch split over
    ``devices`` (core.rablock's devices=): ORACLE_RA's 256^3 stream, its
    decode and ORACLE_RA_REGION's corner, each hashed to the oracle's;
    K12 and K13 launched once a device."""
    from sz_tpu_torch import ErrorBoundMode, SZConfig, framing
    from sz_tpu_torch.config import data_type
    from sz_tpu_torch.core import rablock

    maker, shape, seed, want_blob, want_out = ORACLE_RA["ra_256"]
    x = classic_input(maker, shape, seed)
    cfg = SZConfig(random_access=True).with_bound(ErrorBoundMode.ABS, ABS)
    dt = data_type(x.dtype)
    fmin, fmax, _, rp, _, hdr_cfg, _ = framing._fp_stream_params(x, cfg, dt)
    _, _, rise_one = _counted(wrappers, lambda: rablock.compress_ra(
        x, rp, cfg, device=dev))
    res, tc, rise_c = _counted(wrappers, lambda: rablock.compress_ra(
        x, rp, cfg, device=dev, devices=devices))
    blob = framing._frame_ra_stream(cfg, hdr_cfg, dt, fmin, fmax, x.size,
                                    res.body)
    if sha256(blob) != want_blob:
        raise AssertionError("ra_256 over devices: the stream differs")
    out, td, rise_d = _counted(wrappers, lambda: rablock.decompress_ra(
        res.body, shape, size_type=cfg.size_type, device=dev,
        devices=devices))
    if sha256(out.tobytes()) != want_out:
        raise AssertionError("ra_256 over devices: the decode differs")
    start, end, want_reg = ORACLE_RA_REGION
    reg, tr, rise_r = _counted(wrappers, lambda: rablock.decompress_ra(
        res.body, shape, start, end, cfg.size_type, device=dev,
        devices=devices))
    if sha256(reg.tobytes()) != want_reg:
        raise AssertionError("ra_256 over devices: the region differs")
    k = len(devices)   # K12, K13 and the type lattice's K3 once a device
    if (rise_c.get("ra_encode"), rise_d.get("ra_decode"),
            rise_r.get("ra_decode"), rise_c.get("histogram", 0)
            - rise_one.get("histogram", 0)) != (k, k, k, k - 1):
        raise AssertionError(f"ra_256 over devices: launches {rise_c} "
                             f"{rise_d} {rise_r}")
    row = dict(case="ra_256_over_devices", devices=[str(d) for d in devices],
               stream_sha256_equal=True, decode_sha256_equal=True,
               region_sha256_equal=True, compress_s=tc, decompress_s=td,
               region_s=tr, compress_launches=rise_c,
               decompress_launches=rise_d, region_launches=rise_r)
    _log("multi-device", **row)
    return row


def four_ranks(dev, nprocs: int = 4) -> dict:
    """Four torch.distributed processes (gloo over 127.0.0.1; NCCL takes
    one rank a card) on this card, each compressing its slab of
    ORACLE_SLAB's Hurricane field (tests/_torch_mh_worker.py); rank 0's
    container must hash to the oracle's.  The wall runs from the spawn
    to the last exit."""
    import os
    import socket

    _, shape, _, n, want_blob, _ = ORACLE_SLAB["field"]
    if n != nprocs:
        raise AssertionError("ORACLE_SLAB['field'] holds 4 slabs")
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    out = REPO / "build" / "four_ranks.szra"
    out.parent.mkdir(parents=True, exist_ok=True)
    env = dict(os.environ, PYTHONPATH=str(REPO))
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, str(REPO / "tests" / "_torch_mh_worker.py"),
         str(i), str(nprocs), str(port), str(out), "--device",
         str(dev), "--field", "hurricane"], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for i in range(nprocs)]
    try:
        results = [p.communicate(timeout=300) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    wall = time.perf_counter() - t0
    for p, (_, err) in zip(procs, results):
        if p.returncode:
            raise AssertionError(f"a rank failed ({p.returncode}): "
                                 f"{err[-2000:]}")
    blob = out.read_bytes()
    out.unlink()
    if sha256(blob) != want_blob:
        raise AssertionError("four ranks: the container differs from the "
                             "oracle")
    ranks = [json.loads(o.strip().splitlines()[-1]) for o, _ in results]
    row = dict(case="four_ranks_gloo", shape=list(shape), ranks=nprocs,
               device=str(dev), container_sha256_equal=True, wall_s=wall,
               rank_compress_s=[r["compress_s"] for r in ranks])
    _log("multi-device", **row)
    return row


def phase_full_size_slabs(dev, record: dict) -> None:
    """512^3 float32 (NYX scale) in 4 slabs of 128x512x512 on this card:
    the bound, each payload equal to sz_tpu_torch.compress of its slab,
    decompress_sharded bit-equal to Reader.decode; compress and
    decompress MB/s (warm, best of 3) and the peak device memory of the
    4 slabs at once, of the same 4 slabs one after another
    (SZ_TPU_HOST_THREADS=1), and of the whole field through
    compress / decompress (its MB/s from phase 4's full-size row)."""
    import torch

    import sz_tpu_torch
    from sz_tpu_torch import ErrorBoundMode, SZConfig, ra
    from sz_tpu_torch.parallel import slab

    cfg = SZConfig().with_bound(ErrorBoundMode.ABS, ABS)
    x = field((512, 512, 512), 42)
    mb = x.nbytes / 1e6
    n = 4
    blob = slab.compress_sharded(x, cfg, n_devices=n)
    r = ra.Reader(blob)
    for i in range(n):
        a, b = int(r.starts[i]), int(r.starts[i + 1])
        if r.slab_bytes(i) != sz_tpu_torch.compress(x[a:b], cfg, device=dev):
            raise AssertionError(f"512^3 slab {i} differs from its own "
                                 f"compress")
    out = slab.decompress_sharded(blob, n_devices=n)
    if not np.array_equal(out.view(np.uint32), r.decode(dev).view(np.uint32)):
        raise AssertionError("512^3: decompress_sharded differs from "
                             "Reader.decode")
    err = float(np.abs(out.astype(np.float64) - x).max())
    if err > ABS:
        raise AssertionError(f"512^3 slabs: error {err} above the bound")
    del out

    def peak(fn) -> int:
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        fn()
        return torch.cuda.max_memory_allocated(dev) - held

    whole = sz_tpu_torch.compress(x, cfg, device=dev)
    full = record["full_512"]
    rows = {"whole_field": dict(
        compress_MBps=full["compress_MBps"],
        decompress_MBps=full["decompress_MBps"],
        compress_peak_device_bytes=peak(
            lambda: sz_tpu_torch.compress(x, cfg, device=dev)),
        decompress_peak_device_bytes=peak(
            lambda: sz_tpu_torch.decompress(whole, x.shape, np.float32,
                                            device=dev)))}
    del whole
    def comp():
        return slab.compress_sharded(x, cfg, n_devices=n)

    def dec():
        return slab.decompress_sharded(blob, n_devices=n)

    for mode, k in (("four_slabs_at_once", None), ("four_slabs_serial", 1)):
        with host_threads(k) if k else contextlib.nullcontext():
            pc, pd = peak(comp), peak(dec)   # the warm runs
            tc, spans_c, _ = _best_of(comp, 3, warm=False)
            td, spans_d, _ = _best_of(dec, 3, warm=False)
        rows[mode] = dict(compress_MBps=mb / tc, decompress_MBps=mb / td,
                          compress_s=tc, decompress_s=td,
                          compress_spans_s=spans_c,
                          decompress_spans_s=spans_d,
                          compress_peak_device_bytes=pc,
                          decompress_peak_device_bytes=pd)
    row = dict(shape=[512, 512, 512], slabs=n, devices=[str(dev)] * n,
               ratio=x.nbytes / len(blob), max_abs_err=err,
               payloads_equal_compress=True, decode_equal_reader=True,
               **rows)
    _log("full size 512^3 slabs", **row)
    record["full_512_slabs"] = row


def classic_err(name: str, x: np.ndarray, out: np.ndarray, bound_: tuple,
                blob: bytes, dev) -> dict:
    """The error of a classic, 1-D or pre-log case against its bound
    (raises past it).  A 4-D field under random access was compressed on
    its folded 3-D lattice (sz_tpu/api.py:350-392): its bound is held on
    the decode with that shape, and the 4-D shape's decode (the 4-D
    scheme, as sz_tpu's) is reported beside it."""
    import sz_tpu_torch
    mode, value = bound_
    if mode == "PW_REL":
        return dict(max_rel_err=pointwise_err(x, out, value))
    row = {}
    if name.startswith("random_access_4d"):
        d = x.shape
        row["decode_4d_max_abs_err"] = float(
            np.abs(out.astype(np.float64) - x).max())
        out = sz_tpu_torch.decompress(blob, (d[0] * d[1], d[2], d[3]),
                                      x.dtype, device=dev).reshape(d)
    err = float(np.abs(out.astype(np.float64) - x).max())
    if err > value:
        raise AssertionError(f"{name}: error {err} above the bound")
    row["max_abs_err"] = err
    return row


# the reference binary's classic, 1-D and pre-log streams whose .out is
# its decode (the float 4-D one's is not: its own decoder is broken,
# tests/test_golden_classic_nd.py), and their shapes
GOLDEN_CLASSIC = (
    ("cl_f32_2d_abs1e-4", (128, 64), "<f4"),
    ("cl_f32_3d_abs1e-4", (128, 8, 8), "<f4"),
    ("cl_f64_3d_abs1e-4", (128, 8, 8), "<f8"),
    ("cl_f64_4d_rel1e-3", (128, 8, 8, 8), "<f8"),
    ("f32_1d_abs1e-4", (8192,), "<f4"), ("f64_1d_abs1e-4", (8192,), "<f8"),
    ("f32_1d_pwrel1e-3", (8192,), "<f4"),
    ("pl_f32_1d_pwrel1e-3", (8192,), "<f4"),
    ("sg_f32_1d_pwrel1e-3", (4096,), "<f4"))
# SHA-256 of sz_tpu's stream of synth_signed.dat under PW_REL 1e-3
SYNTH_SIGNED_SHA256 = (
    "a2b1a9cf0ed78312d444dbaab07f768d57b468945dcb5fd2e72231e2069842b6")


def main_path_classic(dev, rows: list) -> None:
    """Phase 3, the classic codec (K10/K11, and K3-K7 on its type
    stream), the 1-D codec and pre-log PW_REL: the ORACLE_CLASSIC fields'
    streams and decodes hash to the oracle's and hold their bound, the
    reference's classic, 1-D and pre-log goldens decode bit-equal, and
    synth_signed.dat compresses to sz_tpu's stream."""
    import sz_tpu_torch
    for name, (maker, shape, seed, bnd, over, want_stream,
               want_recon) in ORACLE_CLASSIC.items():
        x = classic_input(maker, shape, seed)
        cfg = classic_config(bnd, over)
        t0 = time.perf_counter()
        blob = sz_tpu_torch.compress(x, cfg, device=dev)
        t1 = time.perf_counter()
        out = sz_tpu_torch.decompress(blob, x.shape, x.dtype, device=dev)
        t2 = time.perf_counter()
        if sha256(blob) != want_stream:
            raise AssertionError(f"{name}: stream differs from the oracle")
        if out.dtype != x.dtype or sha256(out.tobytes()) != want_recon:
            raise AssertionError(f"{name}: decode differs from the oracle")
        row = dict(case=name, dtype=x.dtype.name, shape=list(x.shape),
                   bound=f"{bnd[0]} {bnd[1]}", config=over,
                   stream_sha256_equal=True, decode_sha256_equal=True,
                   ratio=x.nbytes / len(blob),
                   **classic_err(name, x, out, bnd, blob, dev),
                   port_compress_s=t1 - t0, port_decompress_s=t2 - t1)
        _log("main path", **row)
        rows.append(row)
    golden = REPO / "tests" / "golden"
    for name, shape, dt in GOLDEN_CLASSIC:
        want = np.fromfile(golden / f"{name}.out", dtype=dt)
        got = sz_tpu_torch.decompress((golden / f"{name}.sz").read_bytes(),
                                      shape, np.dtype(dt).type, device=dev)
        if got.tobytes() != want.tobytes():
            raise AssertionError(f"golden {name} decodes differently")
        _log("main path", case=f"golden_{name}", decode_bit_equal=True)
    x = np.fromfile(golden / "synth_signed.dat", dtype="<f4")
    blob = sz_tpu_torch.compress(x, classic_config(("PW_REL", PW_REL), {}),
                                 device=dev)
    if sha256(blob) != SYNTH_SIGNED_SHA256:
        raise AssertionError("synth_signed differs from sz_tpu's stream")
    _log("main path", case="synth_signed_pwrel1e-3_compress",
         stream_sha256_equal=True)


# the integer codecs' main path: name -> (shape, seed, dtype, bound, SHA-256
# of the oracle's stream, of its decode); int_field's values (a 1-D field:
# int_field over (1024, 1024), flattened)
ORACLE_INT = {
    "int32_256": (
        (256, 256, 256), 42, "int32", ("ABS", 4),
        "5b31357f3387f6e24b0b660ddeba6975ebeb4737a6a7a41c8a8db5f9ed39a764",
        "8e6b1175323ed76753633d63a71ae80fc1ac3d7aabd1d91d97cee06629cdbf9f"),
    "int16_cesm_atm_1800x3600": (
        (1800, 3600), 6, "int16", ("ABS", 4),
        "36a7e98fd4e24713715cb201eee03b316ca91ad2ead8d28a96f482ab79efe1d0",
        "385aacd97c947959c08023df072ac410e5f2a7ddbc4dedbec14e6ddf6ab8ee70"),
    "int32_4d_8x64x64x64": (
        (8, 64, 64, 64), 9, "int32", ("ABS", 4),
        "526ca7ad359b0881d826a5e7a0fd1e774ee8026e31a8e7a5c4d9076e72c13c90",
        "8298ab5e349bfb3065791d141ed91b6d2ded3bbdae4986874e3f59a56db66e3d"),
    "int8_300x400": (
        (300, 400), 11, "int8", ("ABS", 0.5),
        "3f675e4854ecad342183290709c358add6a84d4ae96ab94d663e4cce39c33c68",
        "6da0b1b0f6d57e1497b8b5f96bea879de15027958974773774279deb1c334bb8"),
    "uint8_40x50x60": (
        (40, 50, 60), 12, "uint8", ("REL", 0.01),
        "f8da92422801cbdf3060d8881d03a0f2f308c8e6a2cd647eb801aa724e9f84a8",
        "a8f68b9a327109b9d51e17943479a9da9e268b9200e5c245bc99fd3319b7134d"),
    "uint16_64^3": (
        (64, 64, 64), 13, "uint16", ("PSNR", 80),
        "6dce7644e575fd05120a93acca40a2bca54476c50225bb5bd22240d90623fa36",
        "94896c8d2d48a8448a7efb7b978ee757d6efaffa47b18992950222a5e8f4ff9c"),
    "uint32_4d_3x20x33x70": (
        (3, 20, 33, 70), 14, "uint32", ("ABS", 16),
        "13572b43dffed87007adf47239425baa0e8c39b69f94ef39f82d4751ad16a2cb",
        "19086e8065282057a918669189f87ce814571371374ac00b520a91aec3356857"),
    "int64_64^3": (
        (64, 64, 64), 15, "int64", ("ABS", 4),
        "a62910c1cc32be51309168fbb38761591b2b78a4e148ba1fd2edc226f963f9d3",
        "48b6498f865d79bc14c4a18bb0ae763a95e456ddd90877496c62bc3d4b6cb959"),
    "uint64_300x400": (
        (300, 400), 16, "uint64", ("ABS", 4),
        "9fa44d502997a81cce14c348647855bb1bbbfdffb8a820ae4137ddc142fdf4dd",
        "6f6384a8744cdeab21532895446b99300e232576d49c00049499c22fef180533"),
    "uint16_1d_2^20": (
        (1 << 20,), 17, "uint16", ("ABS", 4),
        "67e04a57ecdda4f4494e9489124eb2a3e55d021409c57103b959bac86fbae87b",
        "1e59e1c7dd7a2fb2c0f2bfd92fd10c718a497d287bd56bb7b7c3faaeeca4db6d"),
}


def int_input(shape, seed: int, dtype) -> np.ndarray:
    """An ORACLE_INT field."""
    if len(shape) == 1:
        return int_field((1024, shape[0] // 1024), seed, dtype).reshape(-1)
    return int_field(shape, seed, dtype)


def int_err(name: str, x: np.ndarray, out: np.ndarray, bnd: tuple) -> dict:
    """The largest |decode - data| of an integer case, raising past the
    absolute bound where the reference's codec holds it: values below
    2^53 (the reconstruction is a double) and not at the 4-D quirk cells
    (l, 0, 0, 1), which miss it by design.  REL and PSNR resolve to an
    absolute bound from the range (framing._compress_int); the truncated
    reconstruction stays within its ceiling."""
    w = x.astype(np.int64) if x.dtype != np.uint64 else None
    if w is None or np.abs(w).max() >= 2 ** 53:
        return dict(max_abs_err=None, bound_checked=False)
    err = np.abs(out.astype(np.int64) - w)
    if x.ndim == 4:
        err.reshape(x.shape[0], -1)[:, 1] = 0
    mode, value = bnd
    vr = float(w.max() - w.min())
    pt = float(np.float32(0.99))
    rp = {"ABS": value, "REL": value * vr,
          "PSNR": vr * 10.0 ** ((value + 10 * math.log10(1 - 2.0 / 3.0 * pt))
                                / -20.0)}[mode]
    limit = math.ceil(rp)
    if err.max() > limit:
        raise AssertionError(f"{name}: error {err.max()} above {limit}")
    return dict(max_abs_err=int(err.max()), bound_checked=True)


# the reference binary's integer streams (testint_compress, ABS 4) and
# their shapes (tests/test_golden_int.py)
GOLDEN_INT = (("int_i32_4d", np.int32, (8, 16, 8, 8)),
              ("int_i32_3d", np.int32, (32, 32, 8)),
              ("int_i8_3d", np.int8, (32, 32, 8)),
              ("int_i64_3d", np.int64, (32, 32, 8)),
              ("int_ui16_1d", np.uint16, (8192,)))


def main_path_int(dev, rows: list) -> None:
    """Phase 3, the integer codecs (K16/K17, and K3-K7 on their type
    streams): the ORACLE_INT fields of all eight dtypes at ranks 1-4
    hash stream and decode to the oracle's and hold their bound; the
    reference's integer goldens decode bit-equal and their data compress
    to the golden's inner stream (the params' unset fmin/fmax aside); a
    CUDA tensor of rank 2-4 compresses to the host array's bytes and
    decodes as_tensor to a tensor of its dtype on the card."""
    import torch
    import sz_tpu_torch
    from sz_tpu_torch.format import lossless as ll
    from sz_tpu_torch.gpu import int_kernel as ik
    for name, (shape, seed, dt, bnd, want_stream, want_recon) in \
            ORACLE_INT.items():
        x = int_input(shape, seed, dt)
        cfg = classic_config(bnd, {})
        t0 = time.perf_counter()
        blob = sz_tpu_torch.compress(x, cfg, device=dev)
        t1 = time.perf_counter()
        out = sz_tpu_torch.decompress(blob, x.shape, x.dtype, device=dev)
        t2 = time.perf_counter()
        if sha256(blob) != want_stream:
            raise AssertionError(f"{name}: stream differs from the oracle")
        if out.dtype != x.dtype or sha256(out.tobytes()) != want_recon:
            raise AssertionError(f"{name}: decode differs from the oracle")
        row = dict(case=name, dtype=x.dtype.name, shape=list(x.shape),
                   bound=f"{bnd[0]} {bnd[1]}", stream_sha256_equal=True,
                   decode_sha256_equal=True, ratio=x.nbytes / len(blob),
                   **int_err(name, x, out, bnd), port_compress_s=t1 - t0,
                   port_decompress_s=t2 - t1)
        if x.ndim >= 2:
            xt = ik.to_carrier(x, dev).view(ik.torch_dtype(x.dtype))
            if sz_tpu_torch.compress(xt, cfg, device=dev) != blob:
                raise AssertionError(f"{name}: a tensor's stream differs "
                                     f"from the host array's")
            ot = sz_tpu_torch.decompress(blob, x.shape, x.dtype, device=dev,
                                         as_tensor=True)
            if (ot.device != xt.device or ot.dtype != xt.dtype
                    or sha256(ot.cpu().numpy().tobytes()) != want_recon):
                raise AssertionError(f"{name}: as_tensor decode differs")
            row.update(tensor_input_stream_equal=True,
                       as_tensor=f"{ot.dtype} on {ot.device}")
            del xt, ot
        _log("main path", **row)
        rows.append(row)
    golden = REPO / "tests" / "golden"
    cfg = classic_config(("ABS", 4), {})
    for name, dt, shape in GOLDEN_INT:
        stem = name.rsplit("_", 1)[0]
        x = np.fromfile(golden / f"{stem}.dat", dtype=dt).reshape(shape)
        sz = (golden / f"{name}.sz").read_bytes()
        want = np.fromfile(golden / f"{name}.out", dtype=dt)
        got = sz_tpu_torch.decompress(sz, shape, dt, device=dev)
        if got.tobytes() != want.tobytes():
            raise AssertionError(f"golden {name} decodes differently")
        cap = x.nbytes * 4 + 128
        ours = bytearray(ll.decompress(sz_tpu_torch.compress(
            x, cfg, device=dev), expected_size=cap))
        theirs = bytearray(ll.decompress(sz, expected_size=cap))
        ours[24:32] = theirs[24:32] = bytes(8)
        if ours != theirs:
            raise AssertionError(f"golden {name}: the inner stream differs")
        _log("main path", case=f"golden_{name}", decode_bit_equal=True,
             inner_stream_equal=True)
    torch.cuda.empty_cache()


def phase_full_size_int(dev, record: dict, wrappers: dict) -> None:
    """The integer codecs at full size: 512^3 int32 (537 MB, a field of
    counts or labels at NYX scale) and CESM-ATM's 1800x3600 as int16,
    ABS 4: the bound, compress and decompress MB/s (warm, best of 3) with
    spans and the kernel launches of one compress and one decompress; the
    512^3 field also from a CUDA tensor, with the bytes of each copy (no
    copy of the field up)."""
    import torch
    import sz_tpu_torch
    from sz_tpu_torch.gpu import int_kernel as ik
    cfg = classic_config(("ABS", 4), {})
    rows = {}
    for name, shape, dt, seed in (
            ("int32_512", (512, 512, 512), np.int32, 42),
            ("int16_cesm_atm_1800x3600", (1800, 3600), np.int16, 6)):
        x = int_field(shape, seed, dt)
        mb = x.nbytes / 1e6
        blob = sz_tpu_torch.compress(x, cfg, device=dev)
        out = sz_tpu_torch.decompress(blob, x.shape, x.dtype, device=dev)
        err = int_err(name, x, out, ("ABS", 4))
        tc, spans_c, _ = _best_of(
            lambda: sz_tpu_torch.compress(x, cfg, device=dev), 3)
        td, spans_d, counts_d = _best_of(
            lambda: sz_tpu_torch.decompress(blob, x.shape, x.dtype,
                                            device=dev), 3)
        launches = {}
        for what, fn in (("compress", lambda: sz_tpu_torch.compress(
                x, cfg, device=dev)), ("decompress", lambda: (
                    sz_tpu_torch.decompress(blob, x.shape, x.dtype,
                                            device=dev)))):
            for w in wrappers.values():
                w.launches = 0
            fn()
            launches[what] = {k: w.launches for k, w in wrappers.items()
                              if w.launches}
        row = dict(shape=list(shape), dtype=x.dtype.name, bound="ABS 4",
                   ratio=x.nbytes / len(blob), **err, compress_MBps=mb / tc,
                   decompress_MBps=mb / td, compress_s=tc, decompress_s=td,
                   compress_spans_s=spans_c, decompress_spans_s=spans_d,
                   decompress_counts=counts_d, launches=launches)
        if name == "int32_512":
            xt = torch.from_numpy(x).to(dev)
            if sz_tpu_torch.compress(xt, cfg, device=dev) != blob:
                raise AssertionError("int32_512: a tensor's stream differs "
                                     "from the host array's")
            tt, spans_t, _ = _best_of(
                lambda: sz_tpu_torch.compress(xt, cfg, device=dev), 3)
            _, copies = copies_of(
                lambda: sz_tpu_torch.compress(xt, cfg, device=dev))
            if any(b >= x.nbytes for b in copies["HtoD"]):
                raise AssertionError("int32_512: a tensor's compress copied "
                                     "the field up")
            ot = sz_tpu_torch.decompress(blob, x.shape, x.dtype, device=dev,
                                         as_tensor=True)
            td_t, _, _ = _best_of(lambda: sz_tpu_torch.decompress(
                blob, x.shape, x.dtype, device=dev, as_tensor=True), 3)
            row.update(tensor_compress_MBps=mb / tt, tensor_compress_s=tt,
                       tensor_compress_spans_s=spans_t,
                       tensor_copies_bytes={k: sum(v) for k, v in
                                            copies.items()},
                       as_tensor_decompress_s=td_t,
                       as_tensor_decompress_MBps=mb / td_t,
                       as_tensor_equal=bool(torch.equal(
                           ot, ik.to_carrier(out, dev))))
            if not row["as_tensor_equal"]:
                raise AssertionError("int32_512: as_tensor decode differs")
            del xt, ot
        _log(f"full size {name}", **row)
        rows[name] = row
        del x, out
        torch.cuda.empty_cache()
    record["full_int"] = rows


# the float64 goldens (the reference binary's streams) and their shapes
GOLDEN_F64 = (("f64_3d64_abs1e-3", (64, 64, 64)), ("f64_3d_abs1e-4", (128, 8, 8)),
              ("f64_2d_abs1e-4", (128, 64)), ("f64_4d_rel1e-3", (128, 8, 8, 8)))


def main_path_f64(dev, rows: list) -> None:
    """Phase 3, float64 (K1d/K2d): the ORACLE_F64 fields' streams and
    decodes hash to the oracle's, the float64 goldens decode bit-equal,
    and synth_f64_64.dat compresses to its golden's inner stream."""
    import sz_tpu_torch
    from sz_tpu_torch import ErrorBoundMode, SZConfig
    from sz_tpu_torch.format import lossless as ll

    cfg = SZConfig().with_bound(ErrorBoundMode.ABS, ABS)
    for name, (shape, seed, want_stream, want_recon) in ORACLE_F64.items():
        x = field64(shape, seed)
        t0 = time.perf_counter()
        blob = sz_tpu_torch.compress(x, cfg, device=dev)
        t1 = time.perf_counter()
        out = sz_tpu_torch.decompress(blob, x.shape, np.float64, device=dev)
        t2 = time.perf_counter()
        if sha256(blob) != want_stream:
            raise AssertionError(f"{name}: stream differs from the oracle")
        if out.dtype != np.float64 or sha256(out.tobytes()) != want_recon:
            raise AssertionError(f"{name}: decode differs from the oracle")
        err = float(np.abs(out - x).max())
        if err > ABS:
            raise AssertionError(f"{name}: error {err} above the bound")
        row = dict(case=name, dtype="float64", shape=list(shape),
                   stream_sha256_equal=True, decode_sha256_equal=True,
                   ratio=x.nbytes / len(blob), max_abs_err=err,
                   port_compress_s=t1 - t0, port_decompress_s=t2 - t1)
        _log("main path", **row)
        rows.append(row)
    golden = REPO / "tests" / "golden"
    for name, shape in GOLDEN_F64:
        want = np.fromfile(golden / f"{name}.out", dtype="<f8")
        got = sz_tpu_torch.decompress((golden / f"{name}.sz").read_bytes(),
                                      shape, np.float64, device=dev)
        if not np.array_equal(got.reshape(-1).view(np.uint64),
                              want.view(np.uint64)):
            raise AssertionError(f"golden {name} decodes differently")
        _log("main path", case=f"golden_{name}", decode_bit_equal=True)
    x = np.fromfile(golden / "synth_f64_64.dat", dtype="<f8").reshape(
        64, 64, 64)
    cap = 2 * x.nbytes + 64
    want = ll.decompress((golden / "f64_3d64_abs1e-3.sz").read_bytes(), cap)
    if ll.decompress(sz_tpu_torch.compress(x, cfg, device=dev), cap) != want:
        raise AssertionError("synth_f64_64 differs from the golden's inner "
                             "stream")
    _log("main path", case="golden_f64_3d64_abs1e-3_compress",
         inner_stream_equal=True)


def main_path_tensor_input(dev, rows: list) -> None:
    """Phase 3, CUDA-tensor input: compress of a tensor on the card gives
    the bytes of the host array's (the oracle's) for the 256^3 float32
    and float64 fields, and for a non-contiguous and a 4-D view;
    decompress(..., as_tensor=True) of float64 stays on the card."""
    import torch
    import sz_tpu_torch
    from sz_tpu_torch import ErrorBoundMode, SZConfig

    cfg = SZConfig().with_bound(ErrorBoundMode.ABS, ABS)
    for name, x, want_stream, want_recon in (
            ("field_256", field((256, 256, 256), 42), ORACLE["field_256"][2],
             ORACLE["field_256"][3]),
            ("field64_256", field64((256, 256, 256), 42),
             ORACLE_F64["field64_256"][2], ORACLE_F64["field64_256"][3])):
        xt = torch.from_numpy(x).to(dev)
        blob = sz_tpu_torch.compress(xt, cfg, device=dev)
        if sha256(blob) != want_stream:
            raise AssertionError(f"{name}: a tensor's stream differs from the "
                                 f"host array's")
        out = sz_tpu_torch.decompress(blob, x.shape, x.dtype, device=dev,
                                      as_tensor=True)
        if out.device != xt.device or out.dtype != xt.dtype or \
                sha256(out.cpu().numpy().tobytes()) != want_recon:
            raise AssertionError(f"{name}: as_tensor decode differs")
        row = dict(case=f"{name}_tensor_input", dtype=x.dtype.name,
                   stream_sha256_equal=True, decode_sha256_equal=True,
                   as_tensor_on=str(out.device))
        _log("main path", **row)
        rows.append(row)
        del xt, out
    golden = REPO / "tests" / "golden"
    x = np.fromfile(golden / "synth_f64_64.dat", dtype="<f8").reshape(
        64, 64, 64)
    for name, view, host in (
            ("transposed", lambda t: t.permute(2, 0, 1),
             np.ascontiguousarray(x.transpose(2, 0, 1))),
            ("4d", lambda t: t.reshape(4, 16, 64, 64), x.reshape(4, 16, 64, 64))):
        xt = view(torch.from_numpy(x).to(dev))
        if sz_tpu_torch.compress(xt, cfg, device=dev) != \
                sz_tpu_torch.compress(host, cfg, device=dev):
            raise AssertionError(f"synth_f64_64 {name}: a tensor's stream "
                                 f"differs from the host array's")
        _log("main path", case=f"synth_f64_64_{name}_tensor_input",
             contiguous=xt.is_contiguous(), stream_equal=True)


def pointwise_err(x: np.ndarray, out: np.ndarray,
                  ratio: float = PW_REL) -> float:
    """The largest |x^ - x| / |x| over x != 0; raises unless it is within
    ratio * (1 + ratio) and x^ is 0 wherever x is 0 (a field without
    negative values: a signed field's replaced zeros may decode to a
    tiny negative escape, as in the reference)."""
    nz = x != 0
    rel = (np.abs(out.astype(np.float64) - x)[nz]
           / np.abs(x[nz].astype(np.float64)))
    err = float(rel.max())
    if not err <= ratio * (1 + ratio):
        raise AssertionError(f"point-wise error {err} above the bound")
    if not (x < 0).any() and (out[~nz] != 0).any():
        raise AssertionError("a zero decoded to a non-zero value")
    return err


def copies_of(fn) -> tuple:
    """(fn(), {"DtoH": [bytes], "HtoD": [bytes]}): fn() under
    torch.profiler, and the bytes of each host<->device copy its trace
    holds (the trace's gpu_memcpy events)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    path = REPO / "build" / "copies_trace.json"
    path.parent.mkdir(exist_ok=True)
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text()).get("traceEvents", [])
    path.unlink()
    copies = {"DtoH": [], "HtoD": []}
    for ev in events:
        if ev.get("cat") != "gpu_memcpy":
            continue
        for way, sizes in copies.items():
            if way in ev.get("name", ""):
                sizes.append(int(ev.get("args", {}).get("bytes", -1)))
    return out, copies


def stream_parts(blob: bytes, shape, T) -> tuple:
    """(bytes of the packed type stream, bytes of its escape values, bytes
    of the rest of the body) of a regression stream: what the compress
    downloads of each, as K4 and the escape gather leave it."""
    from sz_tpu_torch.config import MIN_NUM_OF_ELEMENTS, data_type
    from sz_tpu_torch.core import regnd
    from sz_tpu_torch.format import lossless, metadata
    dt, esize = data_type(T), np.dtype(T).itemsize
    n = int(np.prod(shape))
    assert n > MIN_NUM_OF_ELEMENTS
    inner = lossless.decompress(blob, expected_size=n * esize + 4
                                + metadata.meta_length(dt) + 8)
    hdr = metadata.parse_header(inner, dt)
    body = inner[hdr.body_offset + hdr.size_type:]
    parsed = regnd.parse_body(body, shape, T, hdr.size_type,
                              lambda tree, coded, count: np.zeros(count,
                                                                  np.int32))
    packed, escapes = len(parsed.encoded), parsed.unpred.size * esize
    return packed, escapes, len(body) - packed - escapes


def phase_device_input_copies(dev, record: dict) -> None:
    """The copies of a compress from a tensor on the card, 256^3 float32
    and float64 (warm).  No host-to-device copy of the field (the largest
    is under 5 % of its bytes).  The largest copy down is the packed type
    stream (the stream's own count, K4's words rounding it up by at most
    3 bytes); the rest down is under 5 % of the field and within the
    vectors the path must download: the coefficient sums, the optimizer's
    samples, the block selection, the histogram, the escapes, and the
    coefficient streams and scalars (the body less its type stream and
    escapes, plus 4 KiB)."""
    import torch
    import sz_tpu_torch
    from sz_tpu_torch import ErrorBoundMode, SZConfig
    from sz_tpu_torch.gpu import geometry, hist_kernel, stages

    cfg = SZConfig().with_bound(ErrorBoundMode.ABS, ABS)
    rows = []
    for name, x in (("field_256", field((256, 256, 256), 42)),
                    ("field64_256", field64((256, 256, 256), 42))):
        xt = torch.from_numpy(x).to(dev)
        blob = sz_tpu_torch.compress(xt, cfg, device=dev)
        again, copies = copies_of(
            lambda: sz_tpu_torch.compress(xt, cfg, device=dev))
        down, up = sorted(copies["DtoH"]), sorted(copies["HtoD"])
        if again != blob or not down or min(down + up) < 0:
            raise AssertionError(f"{name}: no byte counts in the trace, or "
                                 f"the second compress differs")
        packed, escapes, rest_of_body = stream_parts(blob, x.shape,
                                                     x.dtype.type)
        sums = stages.coeff_sums(xt, 6)
        samples = stages.optimizer_samples(xt, cfg.sample_distance)[0]
        vectors = dict(
            coeff_sums=sums.numel() * sums.element_size(),
            samples=samples.numel() * samples.element_size(),
            selection=geometry.geom_small(x.shape, 6)["nblocks"],
            histogram=hist_kernel.NBINS * 4, escapes=escapes,
            coefficient_streams_and_scalars=rest_of_body + 4096)
        del sums, samples
        row = dict(case=name, field_bytes=x.nbytes, stream_bytes=len(blob),
                   packed_type_stream=packed,
                   d2h_copies=len(down), d2h_bytes=sum(down),
                   d2h_largest=down[-1],
                   d2h_besides_largest=sum(down[:-1]),
                   d2h_besides_largest_share=sum(down[:-1]) / x.nbytes,
                   d2h_known_vectors=sum(vectors.values()), **vectors,
                   h2d_copies=len(up), h2d_bytes=sum(up),
                   h2d_largest=up[-1] if up else 0)
        _log("device input copies", **row)
        if not packed <= down[-1] <= packed + 3:
            raise AssertionError(f"{name}: the largest copy down is not the "
                                 f"packed type stream: {row}")
        if row["d2h_besides_largest"] > row["d2h_known_vectors"] or \
                row["d2h_besides_largest_share"] >= 0.05 or \
                row["h2d_largest"] >= 0.05 * x.nbytes:
            raise AssertionError(f"{name}: the field crossed the link: "
                                 f"{row}")
        rows.append(row)
        del xt
    record["device_input_copies"] = rows


# --- phase 4: full size ---------------------------------------------------

def _best_of(fn, reps: int, warm: bool = True):
    """(best seconds, spans, counts of the best run) over reps runs after
    a warm one (the caller's, if ``warm`` is false); spans and counts
    from sz_tpu_torch.utils.trace, spans summed by name."""
    from sz_tpu_torch.utils import trace as tr
    if warm:
        fn()
    best = None
    for _ in range(reps):
        tr.reset()
        t0 = time.perf_counter()
        fn()
        dt = time.perf_counter() - t0
        if best is None or dt < best[0]:
            spans = {}
            for k, v in tr.last_spans():
                spans[k] = spans.get(k, 0.0) + v
            best = (dt, spans, tr.last_counts())
    return best


def synth(n: int) -> np.ndarray:
    """bench.py's headline field (sin*cos*sin + 0.1 noise + ramp, seed
    42): the 512^3 input of the earlier decompress records in PERF.md.
    Timing only (numpy's sin may differ across builds)."""
    rng = np.random.default_rng(42)
    ax = np.linspace(0, 8 * np.pi, n)
    x, y, z = np.meshgrid(ax, ax, ax, indexing="ij")
    return (np.sin(x) * np.cos(y) * np.sin(z)
            + 0.1 * rng.standard_normal((n, n, n))
            + 0.05 * x * y / 64.0).astype(np.float32)


def phase_full_size(dev, record: dict, wrappers: dict,
                    shape=(512, 512, 512)) -> tuple:
    """512^3 float32 (NYX scale, 537 MB).  Returns its stream and the
    arguments of the largest K3 and K4 calls of its compress."""
    import torch
    import sz_tpu_torch
    from sz_tpu_torch import ErrorBoundMode, SZConfig

    cfg = SZConfig().with_bound(ErrorBoundMode.ABS, ABS)
    x = field(shape, 42)
    mb = x.nbytes / 1e6
    blob, calls = largest_calls(
        lambda: sz_tpu_torch.compress(x, cfg, device=dev))
    out = sz_tpu_torch.decompress(blob, x.shape, np.float32, device=dev)
    err = float(np.abs(out.astype(np.float64) - x).max())
    if err > ABS:
        raise AssertionError(f"512^3: error {err} above the bound")
    tc, spans_c, _ = _best_of(
        lambda: sz_tpu_torch.compress(x, cfg, device=dev), 3)
    td, spans_d, counts_d = _best_of(
        lambda: sz_tpu_torch.decompress(blob, x.shape, np.float32,
                                        device=dev), 3)
    for w in wrappers.values():
        w.launches = 0
    sz_tpu_torch.decompress(blob, x.shape, np.float32, device=dev)
    launches = {k: w.launches for k, w in wrappers.items()}
    # the device-to-host copy of a 537 MB reconstruction, alone
    t = torch.from_numpy(x).to(dev)
    d2h = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        t.cpu()
        d2h.append(time.perf_counter() - t0)
    del t
    row = dict(shape=list(shape), ratio=x.nbytes / len(blob),
               max_abs_err=err, compress_MBps=mb / tc,
               decompress_MBps=mb / td, compress_s=tc, decompress_s=td,
               compress_spans_s=spans_c, decompress_spans_s=spans_d,
               decompress_counts=counts_d, launches_per_decompress=launches,
               d2h_537MB_s=d2h)
    # the same field compressed from a tensor on the card
    xt = torch.from_numpy(x).to(dev)
    if sz_tpu_torch.compress(xt, cfg, device=dev) != blob:
        raise AssertionError("512^3: a tensor's stream differs from the host "
                             "array's")
    tt, spans_t, _ = _best_of(
        lambda: sz_tpu_torch.compress(xt, cfg, device=dev), 3)
    del xt
    row.update(device_input_compress_MBps=mb / tt,
               device_input_compress_s=tt,
               device_input_compress_spans_s=spans_t)
    _log("full size 512^3", **row)
    record["full_512"] = row
    # bench.py's synth field: the same decompress on the earlier input
    xs = synth(shape[0])
    blob_s = sz_tpu_torch.compress(xs, cfg, device=dev)
    ts, spans_s, _ = _best_of(
        lambda: sz_tpu_torch.decompress(blob_s, xs.shape, np.float32,
                                        device=dev), 3)
    err = float(np.abs(sz_tpu_torch.decompress(
        blob_s, xs.shape, np.float32, device=dev).astype(np.float64)
        - xs).max())
    if err > ABS:
        raise AssertionError(f"synth 512^3: error {err} above the bound")
    row = dict(shape=list(shape), ratio=xs.nbytes / len(blob_s),
               max_abs_err=err, decompress_MBps=mb / ts, decompress_s=ts,
               decompress_spans_s=spans_s)
    _log("full size 512^3 synth", **row)
    record["synth_512"] = row
    return blob, calls


def phase_full_size_f64(dev, record: dict, wrappers: dict,
                        shape=(512, 512, 512)) -> None:
    """512^3 float64 (1.07 GB), ABS 1e-3, through K1d/K2d: the bound,
    compress and decompress MB/s (warm, best of 3) with spans, and the
    kernel launches of one compress and one decompress."""
    import sz_tpu_torch
    from sz_tpu_torch import ErrorBoundMode, SZConfig

    cfg = SZConfig().with_bound(ErrorBoundMode.ABS, ABS)
    x = field64(shape, 42)
    mb = x.nbytes / 1e6
    blob = sz_tpu_torch.compress(x, cfg, device=dev)
    out = sz_tpu_torch.decompress(blob, x.shape, np.float64, device=dev)
    err = float(np.abs(out - x).max())
    del out
    if err > ABS:
        raise AssertionError(f"512^3 float64: error {err} above the bound")
    tc, spans_c, _ = _best_of(
        lambda: sz_tpu_torch.compress(x, cfg, device=dev), 3)
    td, spans_d, counts_d = _best_of(
        lambda: sz_tpu_torch.decompress(blob, x.shape, np.float64,
                                        device=dev), 3)
    launches = {}
    for what, fn in (("compress", lambda: sz_tpu_torch.compress(
            x, cfg, device=dev)), ("decompress", lambda: (
                sz_tpu_torch.decompress(blob, x.shape, np.float64,
                                        device=dev)))):
        for w in wrappers.values():
            w.launches = 0
        fn()
        launches[what] = {k: w.launches for k, w in wrappers.items()
                          if w.launches}
    row = dict(shape=list(shape), dtype="float64", ratio=x.nbytes / len(blob),
               max_abs_err=err, compress_MBps=mb / tc,
               decompress_MBps=mb / td, compress_s=tc, decompress_s=td,
               compress_spans_s=spans_c, decompress_spans_s=spans_d,
               decompress_counts=counts_d, launches=launches)
    _log("full size 512^3 float64", **row)
    record["full_512_f64"] = row


def phase_full_size_pwrel(dev, record: dict, wrappers: dict) -> dict:
    """PW_REL 1e-3 at 512^3 (|field|: NYX-like, positive with exact
    zeros; nothing cut) and at 1800x3600 (the CESM-ATM shape, K9): the
    point-wise bound, MB/s warm best of 3, spans and launch counts.
    Returns {name: (stream, shape)} and {name: the arguments of the
    largest K3 and K4 calls of its compress}."""
    import sz_tpu_torch
    from sz_tpu_torch import ErrorBoundMode, SZConfig

    cfg = SZConfig().with_bound(ErrorBoundMode.PW_REL, PW_REL)
    rows, blobs, calls = {}, {}, {}
    for name, x in (("pwrel_512", np.abs(field((512, 512, 512), 42))),
                    ("pwrel_cesm_atm_1800x3600",
                     pwrel_field("abs", (1800, 3600), 6))):
        mb = x.nbytes / 1e6
        blob, calls[name] = largest_calls(
            lambda: sz_tpu_torch.compress(x, cfg, device=dev))
        out = sz_tpu_torch.decompress(blob, x.shape, np.float32, device=dev)
        err = pointwise_err(x, out)
        del out
        tc, spans_c, _ = _best_of(
            lambda: sz_tpu_torch.compress(x, cfg, device=dev), 3)
        td, spans_d, counts_d = _best_of(
            lambda: sz_tpu_torch.decompress(blob, x.shape, np.float32,
                                            device=dev), 3)
        launches = {}
        for what, fn in (("compress", lambda: sz_tpu_torch.compress(
                x, cfg, device=dev)), ("decompress", lambda: (
                    sz_tpu_torch.decompress(blob, x.shape, np.float32,
                                            device=dev)))):
            for w in wrappers.values():
                w.launches = 0
            fn()
            launches[what] = {k: w.launches for k, w in wrappers.items()
                              if w.launches}
        row = dict(shape=list(x.shape), bound="PW_REL 1e-3",
                   zeros=int((x == 0).sum()), ratio=x.nbytes / len(blob),
                   max_rel_err=err, compress_MBps=mb / tc,
                   decompress_MBps=mb / td, compress_s=tc, decompress_s=td,
                   compress_spans_s=spans_c, decompress_spans_s=spans_d,
                   decompress_counts=counts_d, launches=launches)
        _log(f"full size {name}", **row)
        rows[name] = row
        blobs[name] = (blob, x.shape)
    record["full_pwrel"] = rows
    return blobs, calls


def phase_full_size_pwrel64_ra(dev, record: dict, wrappers: dict) -> None:
    """MSST19 PW_REL 1e-3 on float64 data at 512^3 (|field64|, 1.07 GB;
    K8d) and the random-access codec, ABS 1e-3, on 512^3 float32 (K12,
    K13), then a decompress_region of a 64^3 block in its middle: the
    bound, compress and decompress MB/s (warm, best of 3) with spans,
    the ratio, the decompress's peak device memory and the kernel
    launches of one compress and one decompress."""
    import torch

    import sz_tpu_torch
    from sz_tpu_torch import ErrorBoundMode, SZConfig

    cases = [
        ("pwrel64_512", lambda: np.abs(field64((512, 512, 512), 42)),
         SZConfig().with_bound(ErrorBoundMode.PW_REL, PW_REL)),
        ("ra_512", lambda: field((512, 512, 512), 42),
         SZConfig(random_access=True).with_bound(ErrorBoundMode.ABS, ABS)),
    ]
    rows = {}
    for name, make, cfg in cases:
        x = make()
        mb = x.nbytes / 1e6
        blob = sz_tpu_torch.compress(x, cfg, device=dev)
        out = sz_tpu_torch.decompress(blob, x.shape, x.dtype, device=dev)
        if cfg.random_access:
            err = dict(max_abs_err=float(np.abs(out.astype(np.float64)
                                                - x).max()))
            if err["max_abs_err"] > ABS:
                raise AssertionError(f"{name}: error above the bound")
        else:
            err = dict(max_rel_err=pointwise_err(x, out))
        del out
        tc, spans_c, _ = _best_of(
            lambda: sz_tpu_torch.compress(x, cfg, device=dev), 3)
        td, spans_d, counts_d = _best_of(
            lambda: sz_tpu_torch.decompress(blob, x.shape, x.dtype,
                                            device=dev), 3)
        # the decode's peak device memory above what was held before it
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        sz_tpu_torch.decompress(blob, x.shape, x.dtype, device=dev)
        peak = torch.cuda.max_memory_allocated(dev) - held
        launches = {}
        for what, fn in (("compress", lambda: sz_tpu_torch.compress(
                x, cfg, device=dev)), ("decompress", lambda: (
                    sz_tpu_torch.decompress(blob, x.shape, x.dtype,
                                            device=dev)))):
            for w in wrappers.values():
                w.launches = 0
            fn()
            launches[what] = {k: w.launches for k, w in wrappers.items()
                              if w.launches}
        row = dict(shape=list(x.shape), dtype=x.dtype.name,
                   config=dict(random_access=cfg.random_access,
                               bound=cfg.error_bound_mode.name),
                   ratio=x.nbytes / len(blob), **err, compress_MBps=mb / tc,
                   decompress_MBps=mb / td, compress_s=tc, decompress_s=td,
                   compress_spans_s=spans_c, decompress_spans_s=spans_d,
                   decompress_counts=counts_d,
                   decompress_peak_device_bytes=peak, launches=launches)
        if cfg.random_access:
            start, end = (224, 224, 224), (288, 288, 288)
            tr, spans_r, _ = _best_of(
                lambda: sz_tpu_torch.decompress_region(
                    blob, x.shape, start, end, np.float32, device=dev), 3)
            row.update(region=[list(start), list(end)], region_s=tr,
                       region_spans_s=spans_r)
        _log(f"full size {name}", **row)
        rows[name] = row
        del x, blob
    record["full_pwrel64_ra"] = rows


def phase_full_size_classic(dev, record: dict, wrappers: dict) -> None:
    """The classic codec (K10/K11), the 1-D codec and pre-log PW_REL at
    full size: the bound, compress and decompress MB/s (warm, best of 3)
    with spans, the ratio and the kernel launches of one compress and one
    decompress.  Classic ABS 1e-3 on 512^3 float32 (537 MB) and float64
    (1.07 GB), on 1800x3600 and on a 4-D 8x128x256x256 float32 field (268
    MB) without regression and with random access; 1-D on 512^3's 2^27
    values; pre-log PW_REL 1e-3 on the signed 512^3 field with zeros;
    PW_REL 1e-6 (pre-log in the reference) on 1800x3600 float32 and 256^3
    float64."""
    import sz_tpu_torch
    x512 = field((512, 512, 512), 42)
    x4d = field((8, 128, 256, 256), 20)
    cases = [
        ("classic_512", lambda: x512, ("ABS", ABS),
         dict(with_regression=False)),
        ("classic64_512", lambda: field64((512, 512, 512), 42),
         ("ABS", ABS), dict(with_regression=False)),
        ("classic_cesm_atm_1800x3600", lambda: field((1800, 3600), 6),
         ("ABS", ABS), dict(with_regression=False)),
        ("classic_4d_8x128x256x256", lambda: x4d, ("ABS", ABS),
         dict(with_regression=False)),
        ("random_access_4d_8x128x256x256", lambda: x4d, ("ABS", ABS),
         dict(random_access=True)),
        ("classic_1d_2^27", lambda: x512.reshape(-1), ("ABS", ABS), {}),
        ("prelog_signed_512",
         lambda: pwrel_field("signed", (512, 512, 512), 42),
         ("PW_REL", PW_REL), dict(accelerate_pw_rel=False)),
        ("pwrel_1e-6_cesm_atm_1800x3600",
         lambda: pwrel_field("signed", (1800, 3600), 6), ("PW_REL", 1e-6),
         {}),
        ("pwrel64_1e-6_256", lambda: field64((256, 256, 256), 42),
         ("PW_REL", 1e-6), {}),
    ]
    rows = {}
    for name, make, bnd, over in cases:
        x = make()
        cfg = classic_config(bnd, over)
        mb = x.nbytes / 1e6
        blob = sz_tpu_torch.compress(x, cfg, device=dev)
        out = sz_tpu_torch.decompress(blob, x.shape, x.dtype, device=dev)
        err = classic_err(name, x, out, bnd, blob, dev)
        del out
        tc, spans_c, _ = _best_of(
            lambda: sz_tpu_torch.compress(x, cfg, device=dev), 3)
        td, spans_d, counts_d = _best_of(
            lambda: sz_tpu_torch.decompress(blob, x.shape, x.dtype,
                                            device=dev), 3)
        launches = {}
        for what, fn in (("compress", lambda: sz_tpu_torch.compress(
                x, cfg, device=dev)), ("decompress", lambda: (
                    sz_tpu_torch.decompress(blob, x.shape, x.dtype,
                                            device=dev)))):
            for w in wrappers.values():
                w.launches = 0
            fn()
            launches[what] = {k: w.launches for k, w in wrappers.items()
                              if w.launches}
        row = dict(shape=list(x.shape), dtype=x.dtype.name,
                   bound=f"{bnd[0]} {bnd[1]}", config=over,
                   ratio=x.nbytes / len(blob), **err, compress_MBps=mb / tc,
                   decompress_MBps=mb / td, compress_s=tc, decompress_s=td,
                   compress_spans_s=spans_c, decompress_spans_s=spans_d,
                   decompress_counts=counts_d, launches=launches)
        _log(f"full size {name}", **row)
        rows[name] = row
        del x
    record["full_classic"] = rows


def phase_full_size_temporal(dev, record: dict, wrappers: dict,
                             steps: dict) -> dict:
    """The temporal chain again, warm (its kernels built and its shapes
    seen in phase 3): each step's compress_step and decompress_step wall
    (host clock; the port's spans end in a synchronize) with their spans
    and kernel launches; then K14 and K15 against their plain versions on
    each variable's step 1 and step 0 history, timed beside their bounds.
    Returns the float32 (Hurricane) entries."""
    import torch
    from sz_tpu_torch.utils import trace as tr
    enc, dec = ts_compressors(dev)

    def timed(fn) -> tuple:
        """(fn(), wall s, spans s, launches) of one warm call."""
        for w in wrappers.values():
            w.launches = 0
        tr.reset()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        spans = {}
        for k, v in tr.last_spans():
            spans[k] = spans.get(k, 0.0) + v
        return out, wall, spans, {k: w.launches for k, w in wrappers.items()
                                  if w.launches}

    rows, first_hist = [], None
    for s in range(len(ORACLE_TEMPORAL)):
        step = {vid: xs[s] for vid, xs in steps.items()}
        mb = sum(x.nbytes for x in step.values()) / 1e6
        frame, tc, spans_c, launch_c = timed(lambda: enc.compress_step(step))
        _, td, spans_d, launch_d = timed(lambda: dec.decompress_step(frame))
        if sha256(frame) != ORACLE_TEMPORAL[s][0]:
            raise AssertionError(f"warm temporal step {s} differs")
        row = dict(step=s, kinds=[("temporal" if enc.vars[v].compress_type
                                   else "snapshot") for v in steps],
                   mb=mb, compress_s=tc, decompress_s=td,
                   compress_MBps=mb / tc, decompress_MBps=mb / td,
                   compress_spans_s=spans_c, decompress_spans_s=spans_d,
                   compress_launches=launch_c, decompress_launches=launch_d)
        _log("full size temporal step", **row)
        rows.append(row)
        if s == 0:
            first_hist = {v: enc.vars[v].hist.clone() for v in steps}
    record["full_temporal"] = rows
    entries = {}
    for vid, (name, _, shape, _) in TS_VARS.items():
        cur = torch.from_numpy(steps[vid][1].reshape(-1)).to(dev)
        row, ent = ts_vs_plain(name, cur, first_hist.pop(vid), ABS, {}, True)
        record.setdefault("ts_full_size", []).append(row)
        if vid == 0:
            entries = {k: dict(e, shape=list(shape)) for k, e in ent.items()}
        del cur
        torch.cuda.empty_cache()
    return entries


def type_stream(blob: bytes, shape, dev):
    """(uploaded type stream, its tree's node count) of a compressed
    float32 field: the regression codec's (ABS) or MSST19's (PW_REL)."""
    from sz_tpu_torch.config import DataType
    from sz_tpu_torch.core import regnd
    from sz_tpu_torch.format import bytes_util as bu
    from sz_tpu_torch.format import huffman
    from sz_tpu_torch.format import lossless as ll
    from sz_tpu_torch.format import metadata as md
    from sz_tpu_torch.format import tdps as tdps_mod
    from sz_tpu_torch.gpu import fsm_kernel as fk

    n = int(np.prod(shape))
    inner = ll.decompress(blob, n * 4 + 64)
    hdr = md.parse_header(inner, DataType.FLOAT)
    body = memoryview(inner)[hdr.body_offset + hdr.size_type:]
    if hdr.pw_rel:
        ta = tdps_mod.from_bytes(body, DataType.FLOAT, is_pwr=True,
                                 msst19=True,
                                 size_type=hdr.size_type).type_array
        nc = bu.read_u32_be(ta, 0)
        tsize = huffman.tree_bytes_size(nc)
        tree = (*huffman.deserialize_tree(ta[8:8 + tsize], nc), nc)
        enc = ta[8 + tsize:]
    else:
        p = regnd.parse_body(
            bytes(body), shape, np.float32, hdr.size_type,
            lambda tree, enc, cnt: fk.decode(tree, enc, cnt,
                                             dev)[0].cpu().numpy())
        tree, enc = p.tree, p.encoded
    return fk.upload(tree, enc, dev), int(tree[4])


def fsm_timing(name: str, coded, n: int, nodes: int) -> dict:
    """K5-K7 on one full-size type stream, each against its plain
    version, K6 also at each tile size it can take, and the decode timed
    with K6's launches in it.  Returns the kernel entries."""
    from sz_tpu_torch.gpu import fsm_kernel as fk

    bits, trans, lut = coded.bits, coded.trans, coded.lut
    tb, depth = coded.total_bits, coded.depth
    g, m = fk.fsm_sweep(coded)
    entry, off, total = fk.fsm_scan(g, m)
    syms = fk.fsm_emit(coded, entry, off, n)
    # each plain version once, timed on that run (K5's plain version takes
    # seconds on a 512^3 stream)
    (gp, mp), sweep_ms = cuda_once(lambda: fk.fsm_sweep_plain(
        bits, trans, tb, depth))
    scan_p, scan_ms = cuda_once(lambda: fk.fsm_scan_plain(g, m))
    emit_p, emit_ms = cuda_once(lambda: fk.fsm_emit_plain(
        bits, trans, tb, depth, entry, off, n))
    errs = {
        "fsm_sweep": max(max_abs_err(a, b) for a, b in zip((g, m),
                                                            (gp, mp))),
        "fsm_scan": max(max_abs_err(a, b) for a, b in zip(
            (entry, off, total), scan_p)),
        "fsm_emit": max_abs_err(syms, emit_p),
    }
    del gp, mp, scan_p, emit_p
    plain_ms = {"fsm_sweep": sweep_ms, "fsm_scan": scan_ms,
                "fsm_emit": emit_ms}
    if any(errs.values()):
        raise AssertionError(f"K5-K7 differ from their plain versions on "
                             f"the {name} stream: {errs}")
    runs = {
        "fsm_sweep": (lambda: fk.fsm_sweep(coded),
                      # reads the stream and the tables, writes the maps;
                      # walks every coded bit at least once
                      bound(nbytes(bits, trans, lut, g, m), tb)),
        "fsm_scan": (lambda: fk.fsm_scan(g, m),
                     # reads the maps once, writes entry and offsets once
                     bound(nbytes(g, m, entry, off, total))),
        "fsm_emit": (lambda: fk.fsm_emit(coded, entry, off, n),
                     bound(nbytes(bits, trans, lut, entry, off, syms), tb)),
    }
    entries = {}
    for kname, (kern, (b_ms, b_by)) in runs.items():
        ms = cuda_ms(kern, 5)
        entries[kname] = dict(max_abs_err=errs[kname], ms=ms,
                              plain_ms=plain_ms[kname], bound_ms=b_ms,
                              bound_by=b_by, library_ms=None,
                              shape=list(g.shape) + [tb])
    # K6 at every tile size of its windowed path that fits a block
    gc, mc = g.contiguous(), m.contiguous()
    tiles_ms = {T: cuda_ms(lambda: fk._scan(gc, mc, T), 5)
                for T in (32, 64, 128, 256, 512)
                if depth > fk.WINDOW_DEPTH
                or fk.scan_smem(T, depth) <= 232448}
    k6 = fk.fsm_scan.launches
    fk.decode_coded(coded, n, bits.device)
    k6 = fk.fsm_scan.launches - k6
    decode_ms = cuda_ms(lambda: fk.decode_coded(coded, n, bits.device), 3)
    _log(f"kernel K5-K7 on the {name} stream", node_count=nodes,
         total_bits=tb, chunks=int(g.shape[0]), longest_code=depth,
         lut_bits=lut.numel().bit_length() - 1,
         scan_tile=fk.scan_tile(depth), k6_ms_by_tile=tiles_ms,
         k6_launches_a_decode=k6, decode_ms=decode_ms,
         **{k: {kk: v[kk] for kk in ("ms", "plain_ms", "bound_ms")}
            for k, v in entries.items()})
    if k6 != 1:
        raise AssertionError(f"a decode of the {name} stream launched K6 "
                             f"{k6} times")
    return entries


def phase_fsm_timing(dev, streams: dict) -> dict:
    """K5-K7 timed on each {name: (stream, shape)}; returns the first
    stream's kernel entries (the main path's 512^3 ABS stream)."""
    import torch
    first = None
    for name, (blob, shape) in streams.items():
        coded, nodes = type_stream(blob, shape, dev)
        entries = fsm_timing(name, coded, int(np.prod(shape)), nodes)
        first = first or entries
        del coded
        torch.cuda.empty_cache()
    return first


# device kernel name (a part of it) -> the wrapper that launches it
DEVICE_NAMES = (
    ("wavefront_quantize_kernel", "wavefront_quantize"),
    ("wavefront_decode_kernel", "wavefront_decode"),
    ("wavefront_quantize2d_f64_kernel", "wavefront_quantize_f64"),
    ("wavefront_quantize3d_f64_kernel", "wavefront_quantize_f64"),
    ("wavefront_decode2d_f64_kernel", "wavefront_decode_f64"),
    ("wavefront_decode3d_f64_kernel", "wavefront_decode_f64"),
    ("histogram_window_kernel", "histogram"),
    ("pack_lookback_kernel", "pack_bits"),
    ("fsm_sweep_kernel", "fsm_sweep"), ("fsm_sweep_wide_kernel", "fsm_sweep"),
    ("fsm_scan_kernel", "fsm_scan"), ("fsm_scan_wide_kernel", "fsm_scan"),
    ("fsm_emit_kernel", "fsm_emit"),
    ("wavefront3d_encode_kernel", "msst19_wavefront3d_encode"),
    ("wavefront3d_decode_kernel", "msst19_wavefront3d_decode"),
    ("lines2d_encode_kernel", "msst19_lines2d_encode"),
    ("lines2d_decode_kernel", "msst19_lines2d_decode"),
    ("classic_quantize2d_kernel", "classic_quantize"),
    ("classic_quantize3d_kernel", "classic_quantize"),
    ("classic_quantize4d_kernel", "classic_quantize"),
    ("classic_quantize2d_f64_kernel", "classic_quantize"),
    ("classic_quantize3d_f64_kernel", "classic_quantize"),
    ("classic_quantize2d_sub_kernel", "classic_quantize_sub"),
    ("classic_quantize3d_sub_kernel", "classic_quantize_sub"),
    ("classic_quantize2d_sub_f64_kernel", "classic_quantize_sub"),
    ("classic_quantize3d_sub_f64_kernel", "classic_quantize_sub"),
    ("classic_decode2d_kernel", "classic_decode"),
    ("classic_decode3d_kernel", "classic_decode"),
    ("classic_decode4d_kernel", "classic_decode"),
    ("classic_decode2d_f64_kernel", "classic_decode"),
    ("classic_decode3d_f64_kernel", "classic_decode"),
    ("wavefront3d_encode_f64_kernel", "msst19_wavefront3d_encode_f64"),
    ("wavefront3d_decode_f64_kernel", "msst19_wavefront3d_decode_f64"),
    ("lines2d_encode_f64_kernel", "msst19_lines2d_encode_f64"),
    ("lines2d_decode_f64_kernel", "msst19_lines2d_decode_f64"),
    ("ra_encode1d_kernel", "ra_encode"), ("ra_encode2d_kernel", "ra_encode"),
    ("ra_encode3d_kernel", "ra_encode"), ("ra_decode1d_kernel", "ra_decode"),
    ("ra_decode2d_kernel", "ra_decode"), ("ra_decode3d_kernel", "ra_decode"),
    ("ts_quantize_kernel", "ts_quantize"),
    ("ts_quantize_f64_kernel", "ts_quantize"),
    ("ts_quantize_escapes_kernel", "ts_quantize"),
    ("ts_quantize_escapes_f64_kernel", "ts_quantize"),
    ("ts_decode_kernel", "ts_decode"), ("ts_decode_f64_kernel", "ts_decode"),
    ("ts_decode_escapes_kernel", "ts_decode"),
    ("ts_decode_escapes_f64_kernel", "ts_decode"),
    ("int_quantize", "int_quantize"), ("int_decode", "int_decode"),
    ("Memcpy", "memcpy"), ("Memset", "memset"),
)


def profiled(fn) -> dict:
    """Run fn() under torch.profiler (CPU and CUDA activities): device
    time summed by kernel (torch's own kernels as "torch"), the device's
    busy time (union of its events) and idle share of the host wall
    around fn()."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    per, spans = {}, []
    for e in prof.events():
        if not str(e.device_type).endswith("CUDA"):
            continue
        a, b = e.time_range.start, e.time_range.end
        spans.append((a, b))
        key = next((k for part, k in DEVICE_NAMES if part in e.name),
                   "torch")
        ms, count = per.get(key, (0.0, 0))
        per[key] = (ms + (b - a) / 1e3, count + 1)
    busy_us, end = 0.0, float("-inf")
    for a, b in sorted(spans):
        if b > end:
            busy_us += b - max(a, end)
            end = b
    busy = busy_us / 1e6
    return dict(wall_s=wall, device_events=len(spans), device_busy_s=busy,
                device_idle_share=(1 - busy / wall) if spans else None,
                device_ms={k: v[0] for k, v in sorted(per.items())},
                device_events_by_kernel={k: v[1]
                                         for k, v in sorted(per.items())})


KERNELS = {   # name -> (K id, CUDA source, the TPU kernel it replaces)
    "wavefront_quantize": ("K1", "sz_tpu_torch/csrc/lorenzo.cu",
                           "sz_tpu/tpu/pallas_kernels.py:404"),
    "wavefront_decode": ("K2", "sz_tpu_torch/csrc/lorenzo.cu",
                         "sz_tpu/tpu/wf_quantize.py:351"),
    # float64 has no Pallas form: K1d/K2d replace the XLA fixpoints
    "wavefront_quantize_f64": ("K1d", "sz_tpu_torch/csrc/lorenzo.cu",
                               "sz_tpu/tpu/engine.py:796"),
    "wavefront_decode_f64": ("K2d", "sz_tpu_torch/csrc/lorenzo.cu",
                             "sz_tpu/tpu/engine.py:1568"),
    "histogram": ("K3", "sz_tpu_torch/csrc/hist.cu",
                  "sz_tpu/tpu/hist_kernel.py:74"),
    "pack_bits": ("K4", "sz_tpu_torch/csrc/pack.cu",
                  "sz_tpu/tpu/pack_kernel.py:515"),
    "fsm_sweep": ("K5", "sz_tpu_torch/csrc/fsm.cu",
                  "sz_tpu/tpu/fsm_kernel.py:137"),
    "fsm_scan": ("K6", "sz_tpu_torch/csrc/fsm.cu",
                 "sz_tpu/tpu/fsm_kernel.py:172"),
    "fsm_emit": ("K7", "sz_tpu_torch/csrc/fsm.cu",
                 "sz_tpu/tpu/fsm_kernel.py:298"),
    "msst19_wavefront3d_encode": ("K8", "sz_tpu_torch/csrc/msst19.cu",
                                  "sz_tpu/tpu/msst19_kernel.py:463"),
    "msst19_wavefront3d_decode": ("K8", "sz_tpu_torch/csrc/msst19.cu",
                                  "sz_tpu/tpu/msst19_kernel.py:498"),
    "msst19_lines2d_encode": ("K9", "sz_tpu_torch/csrc/msst19.cu",
                              "sz_tpu/tpu/msst19_kernel.py:723"),
    "msst19_lines2d_decode": ("K9", "sz_tpu_torch/csrc/msst19.cu",
                              "sz_tpu/tpu/msst19_kernel.py:760"),
    # the classic codec's recurrence has no Pallas form: K10/K11 replace
    # the XLA fixpoints
    "classic_quantize": ("K10", "sz_tpu_torch/csrc/classic.cu",
                         "sz_tpu/tpu/classic_engine.py:95"),
    "classic_decode": ("K11", "sz_tpu_torch/csrc/classic.cu",
                       "sz_tpu/tpu/classic_engine.py:236"),
    # K10's subblock form (compress_region) replaces sz_tpu's host C
    # subblock quantizer; its launches are phase 3c's
    "classic_quantize_sub": ("K10", "sz_tpu_torch/csrc/classic.cu",
                             "sz_tpu/native/core.c:3547"),
    # MSST19 on float64 data has no Pallas form: K8d/K9d replace the XLA
    # scans of the JAX engine
    "msst19_wavefront3d_encode_f64": ("K8d", "sz_tpu_torch/csrc/msst19.cu",
                                      "sz_tpu/tpu/msst19_engine.py:553"),
    "msst19_wavefront3d_decode_f64": ("K8d", "sz_tpu_torch/csrc/msst19.cu",
                                      "sz_tpu/tpu/msst19_engine.py:675"),
    "msst19_lines2d_encode_f64": ("K9d", "sz_tpu_torch/csrc/msst19.cu",
                                  "sz_tpu/tpu/msst19_engine.py:489"),
    "msst19_lines2d_decode_f64": ("K9d", "sz_tpu_torch/csrc/msst19.cu",
                                  "sz_tpu/tpu/msst19_engine.py:630"),
    # the random-access codec's per-block scans (XLA in the JAX package)
    "ra_encode": ("K12", "sz_tpu_torch/csrc/ra.cu",
                  "sz_tpu/tpu/ra_engine.py:86"),
    "ra_decode": ("K13", "sz_tpu_torch/csrc/ra.cu",
                  "sz_tpu/tpu/ra_engine.py:218"),
    # the temporal step and restore (XLA in the JAX package)
    "ts_quantize": ("K14", "sz_tpu_torch/csrc/temporal.cu",
                    "sz_tpu/temporal.py:237"),
    "ts_decode": ("K15", "sz_tpu_torch/csrc/temporal.cu",
                  "sz_tpu/temporal.py:399"),
    # the integer codecs' recurrence runs in host C in the JAX package:
    # K16/K17 replace its encoder and decoder
    "int_quantize": ("K16", "sz_tpu_torch/csrc/intc.cu",
                     "sz_tpu/native/core.c:2247"),
    "int_decode": ("K17", "sz_tpu_torch/csrc/intc.cu",
                   "sz_tpu/native/core.c:2354"),
}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", help="also write the full record as JSON")
    ap.add_argument("--parent", help="a checkout of the parent commit: "
                    "time its kernels of --parent-kernels beside this "
                    "tree's (phase 2)")
    ap.add_argument("--parent-kernels", default="classic,lorenzo64,temporal",
                    help="tools/strip_timing.py's --kernels for --parent")
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 2
    if not (REPO / "sz_tpu_torch" / "csrc").is_dir():
        print("chip_smoke: run it from a checkout of the repository",
              file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    sys.path.insert(0, str(REPO))
    record = {}
    walls = [("start", time.perf_counter())]   # each phase's end

    # phase 1: environment
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    from sz_tpu_torch import native
    from sz_tpu_torch.gpu import (_build, classic_kernel, fsm_kernel,
                                  hist_kernel, int_kernel, lorenzo_kernel,
                                  msst19_kernel, pack_kernel, ra_kernel,
                                  temporal_kernel)
    nvcc = subprocess.run([_build.find_nvcc(), "--version"],
                          capture_output=True, text=True, check=True)
    t0 = time.perf_counter()
    _build.lib()
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    native.lib()
    native_s = time.perf_counter() - t0
    env = dict(python=sys.version.split()[0], torch=torch.__version__,
               cuda=torch.version.cuda,
               nvcc=nvcc.stdout.strip().splitlines()[-1],
               device=torch.cuda.get_device_name(0),
               device_count=torch.cuda.device_count(), nvidia_smi=smi,
               kernel_build_s=build_s,
               kernels_compiled=_build.build_seconds > 0,
               host_runtime=native.library_path().name,
               host_runtime_build_s=native_s)
    _log("environment", **env)
    record["environment"] = env
    log = _build.library_path().with_suffix(".log")
    if log.exists():
        record["ptxas"] = [ln for ln in log.read_text().splitlines()
                           if "registers" in ln or "Compiling entry" in ln
                           or "spill" in ln]
        record["lorenzo_tiles"] = lorenzo_tiles(record["ptxas"])
        record["lorenzo_strips"] = lorenzo_strip_report(record["ptxas"])
        record["classic_strips"] = classic_strip_report(record["ptxas"])
        record["temporal_kernels"] = temporal_report(record["ptxas"])
        record["int_strips"] = int_strip_report(record["ptxas"])

    walls.append(("1 environment", time.perf_counter()))
    # phase 2: each kernel against its plain version
    record["lorenzo_cases"], entries = phase_lorenzo(dev)
    entries.update(phase_kernels(dev))
    record["pack_hist_cases"] = phase_pack_hist_cases(dev)
    record["fsm_cases"] = phase_fsm_cases(dev)
    record["scan_cases"] = phase_scan_cases(dev)
    record["msst19_cases"], msst19_entries = phase_msst19_cases(dev)
    entries.update(msst19_entries)
    record["classic_cases"], classic_entries, record["classic_step_ns"] = \
        phase_classic_cases(dev)
    entries.update(classic_entries)
    record["subblock_cases"], subblock_entries = phase_subblock_cases(dev)
    entries.update(subblock_entries)
    if args.parent:
        record["strip_parent_timing"] = strip_parent_timing(
            args.parent, args.parent_kernels)
    record["msst19_f64_cases"], msst19_f64_entries = \
        phase_msst19_f64_cases(dev)
    entries.update(msst19_f64_entries)
    record["ra_cases"], ra_entries = phase_ra_cases(dev)
    entries.update(ra_entries)
    record["ts_cases"], ts_entries = phase_ts_cases(dev)
    entries.update(ts_entries)
    record["int_cases"], int_entries = phase_int_cases(dev)
    entries.update(int_entries)

    walls.append(("2 kernels", time.perf_counter()))
    # phase 3: the main path; the launch counters cover exactly this run
    wrappers = {"wavefront_quantize": lorenzo_kernel.wavefront_quantize,
                "wavefront_decode": lorenzo_kernel.wavefront_decode,
                "wavefront_quantize_f64":
                    lorenzo_kernel.wavefront_quantize_f64,
                "wavefront_decode_f64": lorenzo_kernel.wavefront_decode_f64,
                "histogram": hist_kernel.histogram,
                "pack_bits": pack_kernel.pack_bits,
                "fsm_sweep": fsm_kernel.fsm_sweep,
                "fsm_scan": fsm_kernel.fsm_scan,
                "fsm_emit": fsm_kernel.fsm_emit,
                "msst19_wavefront3d_encode": msst19_kernel.wavefront3d_encode,
                "msst19_wavefront3d_decode": msst19_kernel.wavefront3d_decode,
                "msst19_lines2d_encode": msst19_kernel.lines2d_encode,
                "msst19_lines2d_decode": msst19_kernel.lines2d_decode,
                "classic_quantize": classic_kernel.classic_quantize,
                "classic_decode": classic_kernel.classic_decode,
                "msst19_wavefront3d_encode_f64":
                    msst19_kernel.wavefront3d_encode_f64,
                "msst19_wavefront3d_decode_f64":
                    msst19_kernel.wavefront3d_decode_f64,
                "msst19_lines2d_encode_f64": msst19_kernel.lines2d_encode_f64,
                "msst19_lines2d_decode_f64": msst19_kernel.lines2d_decode_f64,
                "ra_encode": ra_kernel.ra_encode,
                "ra_decode": ra_kernel.ra_decode,
                "ts_quantize": temporal_kernel.ts_quantize,
                "ts_decode": temporal_kernel.ts_decode,
                "int_quantize": int_kernel.int_quantize,
                "int_decode": int_kernel.int_decode}
    ts_steps = ts_chain_inputs()
    for w in wrappers.values():
        w.launches = 0
    prof = profiled(lambda: phase_main_path(dev, record, ts_steps))
    launches = {k: w.launches for k, w in wrappers.items()}
    _log("main path launches", **launches)
    _log("main path device time (torch.profiler)", **prof)
    record["main_path_profile"] = prof
    idle = [k for k, v in launches.items() if v == 0]
    if idle:
        raise AssertionError(f"main path never launched {idle}")
    phase_device_input_copies(dev, record)
    phase_temporal_tensor_input(dev, record, ts_steps)
    walls.append(("3 main path", time.perf_counter()))
    phase_multi_device(dev, record, wrappers)
    walls.append(("3b multi-device", time.perf_counter()))
    surface_wrappers = dict(wrappers,
                            classic_quantize_sub=classic_kernel.
                            classic_quantize_sub)
    launches["classic_quantize_sub"] = phase_surfaces(dev, record,
                                                      surface_wrappers)
    walls.append(("3c surfaces", time.perf_counter()))

    # phase 4: full size (float32 from a host array and from a tensor),
    # PW_REL, then float64 (after the float32 phases, which so run as
    # before it), then K5-K7 timed on their streams
    blob, calls = phase_full_size(dev, record, wrappers)
    phase_full_size_slabs(dev, record)
    streams, pw_calls = phase_full_size_pwrel(dev, record, wrappers)
    phase_full_size_f64(dev, record, wrappers)
    phase_full_size_classic(dev, record, wrappers)
    phase_full_size_pwrel64_ra(dev, record, wrappers)
    phase_full_size_int(dev, record, wrappers)
    # K14/K15 at the chain's full size replace phase 2's 2^24 entries
    entries.update(phase_full_size_temporal(dev, record, wrappers, ts_steps))
    del ts_steps
    streams = {"512^3 ABS": (blob, (512, 512, 512)), **streams}
    calls = {"512^3 ABS": calls, **pw_calls}
    del blob, pw_calls
    entries.update(phase_fsm_timing(dev, streams))
    del streams
    # K3/K4 on the main path's own inputs replace phase 2's 2^24 entries
    entries.update(pack_hist_timing(calls))

    walls.append(("4 full size", time.perf_counter()))
    record["phase_s"] = {name: t - walls[i][1]
                         for i, (name, t) in enumerate(walls[1:])}
    _log("phase walls", **record["phase_s"])
    bad = sorted(m for m in sys.modules
                 if m == "jax" or m.startswith("jax.") or m == "sz_tpu"
                 or m.startswith("sz_tpu."))
    if bad:
        raise AssertionError(f"modules of jax or sz_tpu were imported: "
                             f"{bad}")

    kernels = []
    for name, (kid, src, rep) in KERNELS.items():
        e = entries[name]
        kernels.append(dict(
            name=name, route="cuda", source=src, replaces=rep,
            launches=launches[name], max_abs_err=e["max_abs_err"],
            ms=e["ms"], plain_ms=e["plain_ms"], bound_ms=e["bound_ms"],
            bound_by=e["bound_by"], library_ms=e["library_ms"], id=kid,
            shape=e["shape"], plain_shape=e.get("plain_shape", e["shape"])))
    record["kernels"] = kernels
    if args.out:
        out = pathlib.Path(args.out)
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps(record, indent=1, default=float))
    print(json.dumps({"kernels": kernels}, default=float), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
