"""The port's command (``sz_tpu_torch.cli``, ``--device cpu``) against
``sz_tpu.cli`` (``--engine numpy``) on the same files: float32, float64
and integer data of ranks 1-4 under ABS, REL and PW_REL, an sz.config INI
(``-c``), the metadata print (``-p``), the error analysis (``-a``) and
the stats (``-q``).  The .sz files and the decoded files must be equal
bytes, and every printed line that is not a time or a file name equal
text.  ``SZConfig.from_file`` of both packages on the INI files of
``tests/test_ini_config.py``'s kind: equal fields (the port has no
``engine``; it takes ``device=``).  Tolerance: exact.
"""

import dataclasses
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch
torch.set_num_threads(1)  # xdist workers share the cores: one thread each

from sz_tpu import cli as jcli
from sz_tpu.config import ErrorBoundMode as JMode
from sz_tpu.config import SZConfig as JConfig

from sz_tpu_torch import cli as tcli
from sz_tpu_torch.config import SZConfig as TConfig

REPO = pathlib.Path(__file__).resolve().parents[1]

# the reference's example/sz.config, its values as shipped (errorBoundMode
# set per case)
EXAMPLE_INI = """\
#============================================================
[ENV]
#endianType: either LITTLE_ENDIAN_DATA or BIG_ENDIAN_DATA
dataEndianType = LITTLE_ENDIAN_DATA

#solution: SZ, .....
sol_name = SZ

#============================================================
[PARAMETER]
quantization_intervals = 0
max_quant_intervals = 65536
predThreshold = 0.99
sampleDistance = 100
szMode = SZ_BEST_COMPRESSION
gzipMode = Gzip_BEST_SPEED
zstdMode = Zstd_HIGH_SPEED
losslessCompressor = ZSTD_COMPRESSOR
withLinearRegression = YES
randomAccess = 0
protectValueRange = 0
errorBoundMode = {mode}
absErrBound = 1E-3
relBoundRatio = 1E-4
psnr = 80
normErr = 0.05
pw_relBoundRatio = 1E-2
segment_size = 32
pwr_type = MIN
snapshotCmprStep = 5
accelerate_pw_rel_compression = 1
"""

INI_CASES = {
    "example_abs": EXAMPLE_INI.format(mode="ABS"),
    "example_rel": EXAMPLE_INI.format(mode="REL"),
    "example_pw_rel": EXAMPLE_INI.format(mode="PW_REL"),
    "vr_rel_gzip": EXAMPLE_INI.format(mode="vr_rel").replace(
        "ZSTD_COMPRESSOR", "GZIP_COMPRESSOR").replace(
        "Gzip_BEST_SPEED", "Gzip_BEST_COMPRESSION"),
    "fixed_intervals_no_regression": EXAMPLE_INI.format(
        mode="ABS_AND_REL").replace("quantization_intervals = 0",
                                    "quantization_intervals = 100").replace(
        "withLinearRegression = YES", "withLinearRegression = NO"),
    # the config-file path's own defaults where keys are absent
    "sparse": "[PARAMETER]\nerrorBoundMode = ABS ; inline comment\n"
              "absErrBound = 1E-3\nsampleDistance = 50\n"
              "predThreshold = 0.97\n",
    "env_section_big_endian": "[ENV]\ndataEndianType = BIG_ENDIAN_DATA\n"
                              "sol_name = PASTRI\n[PARAMETER]\n"
                              "errorBoundMode = PSNR\npsnr = 60\n"
                              "szMode = SZ_BEST_SPEED\npwr_type = AVG\n"
                              "sampleDistance = 10\npredThreshold = 0.9\n",
}


def _jasdict(cfg) -> dict:
    d = dataclasses.asdict(cfg)
    d.pop("engine")
    return d


@pytest.mark.parametrize("name", sorted(INI_CASES))
def test_from_file_matches_sz_tpu(tmp_path, name):
    p = tmp_path / "sz.config"
    p.write_text(INI_CASES[name])
    got = dataclasses.asdict(TConfig.from_file(p))
    assert got == _jasdict(JConfig.from_file(p))


def test_from_file_missing_bound_mode(tmp_path):
    p = tmp_path / "bad.config"
    p.write_text("[PARAMETER]\nabsErrBound = 1E-3\n")
    with pytest.raises(ValueError, match="errorBoundMode"):
        TConfig.from_file(p)


def _field(shape, dtype, seed):
    rng = np.random.default_rng(seed)
    axes = [np.linspace(0, 3 * np.pi, n) for n in shape]
    grids = np.meshgrid(*axes, indexing="ij")
    f = np.sin(grids[0]) + 1.5
    for g in grids[1:]:
        f = f * np.cos(g)
    f = f + 0.05 * rng.standard_normal(shape)
    if np.dtype(dtype).kind in "iu":
        scale = min(1000, np.iinfo(dtype).max // 4)
        return np.round(f * scale).astype(dtype)
    return f.astype(dtype)


def _dims(shape) -> list:
    """The CLI's -1..-4 arguments: nx (fastest) first."""
    return [f"-{len(shape)}", *(str(s) for s in reversed(shape))]


def _kept(out: str) -> list:
    """Printed lines that are neither a time nor a file name."""
    return [ln for ln in out.splitlines()
            if "time =" not in ln and "data file:" not in ln]


def _run_both(capsys, j_args, t_args):
    jcli.main(j_args + ["--engine", "numpy"])
    j_out = capsys.readouterr().out
    tcli.main(t_args + ["--device", "cpu"])
    t_out = capsys.readouterr().out
    assert _kept(t_out) == _kept(j_out)
    return j_out, t_out


CASES = [
    # (id, shape, type flag(s), numpy dtype, bound flags)
    ("f_1d_abs", (3000,), ["-f"], np.float32, ["-M", "ABS", "-A", "1e-3"]),
    ("f_2d_rel", (40, 50), ["-f"], np.float32, ["-M", "REL", "-R", "1e-3"]),
    ("f_3d_abs", (12, 20, 24), ["-f"], np.float32,
     ["-M", "ABS", "-A", "1e-3"]),
    ("f_3d_pwrel", (12, 20, 24), ["-f"], np.float32,
     ["-M", "PW_REL", "-P", "1e-2"]),
    ("f_4d_abs", (3, 6, 10, 12), ["-f"], np.float32,
     ["-M", "ABS", "-A", "1e-3"]),
    ("f_3d_classic", (12, 20, 24), ["-f", "--no-regression"], np.float32,
     ["-A", "1e-3"]),
    ("f_2d_best_speed", (40, 50), ["-f", "--best-speed"], np.float32,
     ["-A", "1e-2"]),
    ("d_1d_rel", (3000,), ["-d"], np.float64, ["-M", "REL", "-R", "1e-4"]),
    ("d_2d_pwrel", (40, 50), ["-d"], np.float64,
     ["-M", "PW_REL", "-P", "1e-3"]),
    ("d_3d_abs", (12, 20, 24), ["-d"], np.float64,
     ["-M", "ABS", "-A", "1e-4"]),
    ("d_4d_rel", (3, 6, 10, 12), ["-d"], np.float64,
     ["-M", "REL", "-R", "1e-3"]),
    ("i16_2d_abs", (40, 50), ["--int", "i16"], np.int16,
     ["-M", "ABS", "-A", "4"]),
    ("ui32_3d_rel", (12, 20, 24), ["--int", "ui32"], np.uint32,
     ["-M", "REL", "-R", "1e-3"]),
    ("i8_1d_abs", (3000,), ["--int", "i8"], np.int8,
     ["-M", "ABS", "-A", "2"]),
    ("i64_4d_abs", (3, 6, 10, 12), ["--int", "i64"], np.int64,
     ["-M", "ABS", "-A", "3"]),
]


@pytest.mark.parametrize("cid,shape,tflags,dtype,bound", CASES,
                         ids=[c[0] for c in CASES])
def test_compress_decompress_files_match(tmp_path, capsys, cid, shape,
                                         tflags, dtype, bound):
    data = _field(shape, dtype, 5)
    src = tmp_path / "in.dat"
    data.tofile(src)
    jz, tz = tmp_path / "j.sz", tmp_path / "t.sz"
    head = ["-z"]
    tail = tflags + ["-i", str(src), *bound, *_dims(shape), "-a", "-q"]
    _run_both(capsys, head + [str(jz)] + tail, head + [str(tz)] + tail)
    assert tz.read_bytes() == jz.read_bytes()
    jx, tx = tmp_path / "j.out", tmp_path / "t.out"
    xtail = tflags + ["-s", str(jz), "-i", str(src), *_dims(shape), "-a"]
    _run_both(capsys, ["-x", str(jx)] + xtail, ["-x", str(tx)] + xtail)
    assert tx.read_bytes() == jx.read_bytes()
    if dtype in (np.float32, np.float64):
        j_out, t_out = _run_both(capsys, ["-p", "-s", str(jz)],
                                 ["-p", "-s", str(tz)])
        assert "num_elements: " + str(data.size) in t_out


@pytest.mark.parametrize("mode", ["ABS", "PW_REL", "vr_rel"])
def test_config_file_flag(tmp_path, capsys, mode):
    """-c: the INI's bound (and the flags that override it)."""
    shape = (12, 20, 24)
    data = _field(shape, np.float32, 6)
    src = tmp_path / "in.dat"
    data.tofile(src)
    ini = tmp_path / "sz.config"
    ini.write_text(EXAMPLE_INI.format(mode=mode))
    tail = ["-f", "-c", str(ini), "-i", str(src), *_dims(shape), "-q"]
    if mode == "ABS":
        tail += ["-A", "2e-3"]
    jz, tz = tmp_path / "j.sz", tmp_path / "t.sz"
    _run_both(capsys, ["-z", str(jz)] + tail, ["-z", str(tz)] + tail)
    assert tz.read_bytes() == jz.read_bytes()


def test_tucker_gate_exits_as_sz_tpu(tmp_path):
    src = tmp_path / "in.dat"
    _field((8, 8, 8), np.float32, 1).tofile(src)
    args = ["-z", "-f", "-T", "-i", str(src), "-3", "8", "8", "8"]
    with pytest.raises(SystemExit) as t_exit:
        tcli.main(args + ["--device", "cpu"])
    with pytest.raises(SystemExit) as j_exit:
        jcli.main(args + ["--engine", "numpy"])
    assert str(t_exit.value) == str(j_exit.value)
    assert "Tucker" in str(t_exit.value)


def test_device_defaults_to_the_card():
    assert tcli._build_parser().parse_args(["-p"]).device == "cuda"


def test_module_runs_as_a_command(tmp_path):
    """python -m sz_tpu_torch.cli, as the sz-tpu-torch script runs it."""
    shape = (10, 12, 14)
    src = tmp_path / "in.dat"
    _field(shape, np.float32, 2).tofile(src)
    out = tmp_path / "t.sz"
    r = subprocess.run(
        [sys.executable, "-m", "sz_tpu_torch.cli", "-z", str(out), "-f",
         "-i", str(src), "-M", "ABS", "-A", "1e-3", *_dims(shape),
         "--device", "cpu"], capture_output=True, text=True, cwd=REPO)
    assert r.returncode == 0, r.stderr
    assert "compressed data file" in r.stdout
    import sz_tpu
    want = sz_tpu.compress(np.fromfile(src, np.float32).reshape(shape),
                           JConfig(engine="numpy").with_bound(
                               JMode.ABS, 1e-3))
    assert out.read_bytes() == want
