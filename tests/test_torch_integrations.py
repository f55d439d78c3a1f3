"""The port's integrations against ``sz_tpu``'s: the HDF5 filter's
cd_values and its chunk files (h5py direct chunk I/O; skipped where h5py
is absent), the classic netCDF parser on a synthetic CDF-1 file (the
writer of tests/test_readers.py), NetCDF-4 through h5py, and the ADIOS BP3
parser on the vendored BP3 fixtures.  Equal bytes and arrays.
"""

import pathlib
import struct

import numpy as np
import pytest
import torch
torch.set_num_threads(1)  # xdist workers share the cores: one thread each

from sz_tpu.config import ErrorBoundMode as JMode
from sz_tpu.config import SZConfig as JConfig
from sz_tpu.integrations import hdf5 as jh5
from sz_tpu.integrations import readers as jreaders

from sz_tpu_torch.config import ErrorBoundMode, SZConfig
from sz_tpu_torch.integrations import hdf5 as th5
from sz_tpu_torch.integrations import readers as treaders

GOLDEN = pathlib.Path(__file__).parent / "golden"
BP_1D = GOLDEN / "ADIOS2ADIOS1WriteADIOS1Read1D8.bp"
BP_2D = GOLDEN / "ADIOS2ADIOS1WriteADIOS1Read2D2x4Test.bp"


def _synth(shape, seed=0):
    rng = np.random.default_rng(seed)
    axes = [np.linspace(0, 4 * np.pi, n) for n in shape]
    grids = np.meshgrid(*axes, indexing="ij")
    field = np.sin(grids[0])
    for g in grids[1:]:
        field = field * np.cos(g)
    return (field + 0.05 * rng.standard_normal(shape)).astype(np.float32)


def _write_classic_nc(path, name, arr):
    """tests/test_readers.py's CDF-1 writer (one non-record variable)."""
    out = bytearray()
    out += b"CDF\x01"
    out += struct.pack(">I", 0)
    out += struct.pack(">II", 0x0A, arr.ndim)
    for i, d in enumerate(arr.shape):
        nm = f"d{i}".encode()
        out += struct.pack(">I", len(nm)) + nm.ljust((len(nm) + 3) & ~3,
                                                     b"\x00")
        out += struct.pack(">I", d)
    out += struct.pack(">II", 0, 0)
    out += struct.pack(">II", 0x0B, 1)
    nm = name.encode()
    out += struct.pack(">I", len(nm)) + nm.ljust((len(nm) + 3) & ~3,
                                                 b"\x00")
    out += struct.pack(">I", arr.ndim)
    for i in range(arr.ndim):
        out += struct.pack(">I", i)
    out += struct.pack(">II", 0, 0)
    nc_type = {np.dtype(np.float32): 5, np.dtype(np.float64): 6}[arr.dtype]
    out += struct.pack(">I", nc_type)
    data = arr.astype(arr.dtype.newbyteorder(">")).tobytes()
    out += struct.pack(">I", len(data))
    out += struct.pack(">I", len(out) + 4)
    out += data
    path.write_bytes(bytes(out))


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_classic_netcdf_matches(tmp_path, dtype):
    arr = (np.arange(120, dtype=dtype).reshape(4, 5, 6) * 0.5)
    p = tmp_path / "c.nc"
    _write_classic_nc(p, "field", arr)
    got = treaders.read_netcdf(str(p), "field")
    np.testing.assert_array_equal(got, jreaders.read_netcdf(str(p), "field"))
    assert got.dtype == arr.dtype
    with pytest.raises(KeyError):
        treaders.read_netcdf(str(p), "missing")


def test_netcdf4_matches(tmp_path):
    h5py = pytest.importorskip("h5py")
    arr = np.arange(60, dtype=np.float64).reshape(3, 4, 5)
    p = tmp_path / "n4.nc"
    with h5py.File(p, "w") as f:
        f.create_dataset("field", data=arr)
    np.testing.assert_array_equal(treaders.read_netcdf(str(p), "field"),
                                  jreaders.read_netcdf(str(p), "field"))


BP_READS = [(BP_1D, n, kw) for n in ("i8", "i16", "i32", "i64", "u8", "u16",
                                     "u32", "u64", "r32", "r64")
            for kw in ({}, {"start": (0,), "count": (8,)},
                       {"step": 3, "start": (0,), "count": (8,)})] + [
    (BP_2D, "r32", {"start": (0, 0), "count": (2, 4)}),
    (BP_2D, "i64", {}), (BP_2D, "r64", {"step": 2})]


@pytest.mark.parametrize("path,name,kw", BP_READS,
                         ids=[f"{p.stem[-6:]}-{n}-{i}"
                              for i, (p, n, _) in enumerate(BP_READS)])
def test_adios_bp3_matches(path, name, kw):
    got = treaders.read_adios_bp(str(path), name, **kw)
    want = jreaders.read_adios_bp(str(path), name, **kw)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_adios_gated():
    with pytest.raises((ImportError, FileNotFoundError)):
        treaders.read_adios_bp("/nonexistent.bp", "x")


@pytest.mark.parametrize("shape,dtype", [
    ((100000,), np.float32), ((30, 20), np.float64), ((30, 20, 10), np.int16),
    ((4, 5, 6, 7), np.uint64)])
def test_hdf5_cd_values_match(shape, dtype):
    tc = SZConfig(error_bound_mode=ErrorBoundMode.ABS, abs_err_bound=1e-3)
    jc = JConfig(error_bound_mode=JMode.ABS, abs_err_bound=1e-3)
    cd = th5.cd_values_for(shape, dtype, tc)
    assert cd == jh5.cd_values_for(shape, dtype, jc)
    assert th5.cd_values_for(shape, dtype) == jh5.cd_values_for(shape, dtype)
    shp, dt, pcfg = th5.parse_cd_values(cd)
    jshp, jdt, jcfg = jh5.parse_cd_values(cd)
    assert (shp, dt) == (jshp, jdt)
    assert (pcfg.error_bound_mode, pcfg.abs_err_bound) == \
        (jcfg.error_bound_mode, jcfg.abs_err_bound)


@pytest.mark.parametrize("shape,chunks", [((24, 20, 16), None),
                                          ((32, 24, 16), (16, 12, 16)),
                                          ((16, 16), (4, 4))])
def test_hdf5_chunks_match(tmp_path, shape, chunks):
    """The port's SZ-filtered file holds sz_tpu's chunk bytes, and each
    package reads the other's file to equal arrays (a tiny chunk goes
    raw, as the plugin passes it)."""
    h5py = pytest.importorskip("h5py")
    data = _synth(shape, 3)
    tc = SZConfig().with_bound(ErrorBoundMode.ABS, 1e-3)
    jc = JConfig(engine="numpy").with_bound(JMode.ABS, 1e-3)
    with h5py.File(tmp_path / "t.h5", "w") as f:
        th5.create_dataset(f, "field", data, tc, chunks=chunks,
                           device="cpu")
    with h5py.File(tmp_path / "j.h5", "w") as f:
        jh5.create_dataset(f, "field", data, jc, chunks=chunks)
    with h5py.File(tmp_path / "t.h5", "r") as ft, \
            h5py.File(tmp_path / "j.h5", "r") as fj:
        dt, dj = ft["field"], fj["field"]
        for offset in jh5._chunk_grid(shape, chunks or shape):
            assert dt.id.read_direct_chunk(offset)[1] == \
                dj.id.read_direct_chunk(offset)[1]
        assert dt.id.get_create_plist().get_filter(0)[2] == \
            dj.id.get_create_plist().get_filter(0)[2]
        out = th5.read_dataset(dj, device="cpu")
        np.testing.assert_array_equal(out, jh5.read_dataset(dt))
    got = th5.hdf5_to_raw(tmp_path / "j.h5", tmp_path / "o.raw",
                          dataset="field", device="cpu")
    np.testing.assert_array_equal(np.fromfile(tmp_path / "o.raw",
                                              np.float32).reshape(shape),
                                  got)
