"""HDF5 filter integration — H5Z-SZ equivalent without a C plugin (the
port's copy of ``sz_tpu.integrations.hdf5``; the chunks through the
port's codec on ``device``; h5py is imported only where a file is read or
written).

The reference registers HDF5 filter 32017 (H5Z_SZ.h:17) whose chunk
payloads are ordinary SZ streams, with dataset dims/type (and
optionally the error bounds) carried in cd_values (SZ_copymetaDataToCdArray
/ SZ_cdArrayToMetaDataErr, H5Z_SZ.c:137-232).  Python environments
without the C plugin can still produce and consume such files through
h5py's direct chunk I/O: datasets are created declaring filter 32017
(optional flag) with reference-layout cd_values, chunk payloads are
written pre-compressed with write_direct_chunk, and reads pull raw
chunks with read_direct_chunk and decode them with this codec — so the
files interoperate with the reference H5Z-SZ plugin in both directions.
"""

from __future__ import annotations

import struct

import numpy as np

from sz_tpu_torch import api
from sz_tpu_torch.config import DEFAULT_CONFIG, ErrorBoundMode, SZConfig

FILTER_ID = 32017  # H5Z_FILTER_SZ (H5Z_SZ.h:17)

_DT_CODE = {
    np.dtype(np.float32): 0, np.dtype(np.float64): 1,
    np.dtype(np.uint8): 2, np.dtype(np.int8): 3,
    np.dtype(np.uint16): 4, np.dtype(np.int16): 5,
    np.dtype(np.uint32): 6, np.dtype(np.int32): 7,
    np.dtype(np.uint64): 8, np.dtype(np.int64): 9,
}
_CODE_DT = {v: k for k, v in _DT_CODE.items()}


def cd_values_for(shape, dtype, cfg: SZConfig = None) -> tuple:
    """Reference cd_values layout (SZ_copymetaDataToCdArray,
    H5Z_SZ.c:186-232): [dim, dataType, dims...] with 1D sizes split
    into two big-endian u32 halves; when cfg is given, append
    [errorBoundMode, abs, rel, pwRel, psnr] with each double split into
    two big-endian u32 halves (SZ_cdArrayToMetaDataErr layout)."""
    dims = [int(d) for d in shape]
    ndim = len(dims)
    cd = [ndim, _DT_CODE[np.dtype(dtype)]]
    if ndim == 1:
        b = struct.pack(">Q", dims[0])
        cd += list(struct.unpack(">II", b))
    else:
        cd += dims  # slowest-first == (r_n ... r1) order in the file
    if cfg is not None:
        cd.append(int(cfg.error_bound_mode))
        for v in (cfg.abs_err_bound, cfg.rel_bound_ratio,
                  cfg.pw_rel_bound_ratio, cfg.psnr):
            cd += list(struct.unpack(">II", struct.pack(">d", v)))
    return tuple(cd)


def parse_cd_values(cd) -> tuple:
    """(shape, dtype, cfg-or-None) from reference cd_values."""
    ndim = int(cd[0])
    dtype = _CODE_DT[int(cd[1])]
    if ndim == 1:
        (r1,) = struct.unpack(">Q", struct.pack(">II", cd[2], cd[3]))
        shape = (int(r1),)
        k = 4
    else:
        shape = tuple(int(v) for v in cd[2:2 + ndim])
        k = 2 + ndim
    cfg = None
    if len(cd) >= k + 9:
        mode = ErrorBoundMode(int(cd[k]))
        vals = []
        for i in range(4):
            (v,) = struct.unpack(
                ">d", struct.pack(">II", cd[k + 1 + 2 * i],
                                  cd[k + 2 + 2 * i]))
            vals.append(v)
        cfg = SZConfig(error_bound_mode=mode, abs_err_bound=vals[0],
                       rel_bound_ratio=vals[1],
                       pw_rel_bound_ratio=vals[2], psnr=vals[3])
    return shape, dtype, cfg


def _chunk_grid(shape, chunks):
    for idx in np.ndindex(*[(s + c - 1) // c
                            for s, c in zip(shape, chunks)]):
        offset = tuple(i * c for i, c in zip(idx, chunks))
        yield offset


def create_dataset(parent, name: str, data: np.ndarray,
                   cfg: SZConfig = DEFAULT_CONFIG, chunks=None, *,
                   device="cuda"):
    """Write `data` as an SZ-filtered dataset (filter 32017), chunk
    payloads produced by this codec and written via direct chunk I/O.
    The result matches what the reference H5Z-SZ plugin would produce
    structurally (same filter id, cd_values and stream format), so
    plugin-enabled readers decode it."""
    import h5py

    data = np.ascontiguousarray(data)
    if chunks is None:
        chunks = data.shape
    if any(s % c for s, c in zip(data.shape, chunks)):
        raise ValueError("chunk sizes must divide the shape "
                         "(edge-chunk padding not supported)")
    space = h5py.h5s.create_simple(data.shape)
    dcpl = h5py.h5p.create(h5py.h5p.DATASET_CREATE)
    dcpl.set_chunk(chunks)
    cd = cd_values_for(chunks, data.dtype, cfg)
    dcpl.set_filter(FILTER_ID, h5py.h5z.FLAG_OPTIONAL, cd)
    tid = h5py.h5t.py_create(data.dtype, logical=True)
    dsid = h5py.h5d.create(parent.id, name.encode(), tid, space,
                           dcpl=dcpl)
    dset = h5py.Dataset(dsid)
    tiny = int(np.prod(chunks)) < 20  # plugin passthrough, H5Z_SZ.c:571
    for offset in _chunk_grid(data.shape, chunks):
        sl = tuple(slice(o, o + c) for o, c in zip(offset, chunks))
        sub = np.ascontiguousarray(data[sl])
        blob = sub.tobytes() if tiny else api.compress(sub, cfg,
                                                       device=device)
        dset.id.write_direct_chunk(offset, blob, filter_mask=0)
    return dset


def read_dataset(dset, *, device="cuda") -> np.ndarray:
    """Read an SZ-filtered dataset without the C plugin: raw chunks via
    read_direct_chunk, decoded with this codec using the cd_values
    metadata (the H5Z_filter_sz decode path, H5Z_SZ.c:542)."""
    dcpl = dset.id.get_create_plist()
    cd = None
    for i in range(dcpl.get_nfilters()):
        code, _flags, vals, _name = dcpl.get_filter(i)
        if code == FILTER_ID:
            cd = vals
            break
    if cd is None:
        raise ValueError("dataset does not use the SZ filter (32017)")
    chunk_shape, dtype, _cfg = parse_cd_values(cd)
    chunks = dset.chunks or dset.shape
    tiny = int(np.prod(chunks)) < 20  # plugin passthrough, H5Z_SZ.c:571
    # cd_values dims describe the chunk space (H5Z_sz_set_local)
    out = np.zeros(dset.shape, dtype)
    for offset in _chunk_grid(dset.shape, chunks):
        _mask, blob = dset.id.read_direct_chunk(offset)
        if tiny:
            sub = np.frombuffer(bytes(blob), dtype).reshape(chunks)
        else:
            sub = api.decompress(bytes(blob), chunks, dtype, device=device)
        sl = tuple(slice(o, o + c) for o, c in zip(offset, chunks))
        out[sl] = sub
    return out


def sz_to_hdf5(src, out_path, dataset: str = "testdata_compressed",
               dtype=None, shape=None, cfg: SZConfig = DEFAULT_CONFIG,
               chunks=None, *, device="cuda"):
    """szToHDF5-style converter (hdf5-filter/H5Z-SZ/test/szToHDF5.c):
    a raw binary array file (or an ndarray) becomes an SZ-filtered
    HDF5 file readable by any H5Z-SZ-enabled consumer."""
    import h5py

    if isinstance(src, np.ndarray):
        data = src
    else:
        data = np.fromfile(src, dtype=dtype).reshape(shape)
    with h5py.File(out_path, "w") as f:
        create_dataset(f, dataset, data, cfg, chunks=chunks, device=device)
    return out_path


def hdf5_to_raw(h5_path, out_path=None,
                dataset: str = "testdata_compressed", *,
                device="cuda") -> np.ndarray:
    """dszFromHDF5-style converter (hdf5-filter/H5Z-SZ/test/
    dszFromHDF5.c): reads an SZ-filtered HDF5 dataset (decoding the
    chunks with this codec) and optionally writes the raw array file."""
    import h5py

    with h5py.File(h5_path, "r") as f:
        out = read_dataset(f[dataset], device=device)
    if out_path is not None:
        out.tofile(out_path)
    return out
