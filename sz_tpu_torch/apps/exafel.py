"""ExaFEL (LCLS crystallography) application codec — exafelSZ.c replica
(the port's copy of ``sz_tpu.apps.exafel``; its SZ stream through the
port's codec on ``device``).

Peak windows (peakSize x peakSize around each detected Bragg peak) and
calibration-masked pixels are kept lossless ("ROI"); the background is
binned binSize x binSize (mean over valid pixels) and SZ-compressed at
an ABS tolerance in szDim dimensions.  Stream layout matches
exafelSZ.c:283-330 (little-endian, ROI floats raw, embedded SZ stream).

Reached through the customize entry (`SZ_compress_customize("ExaFEL")`,
sz.c:1386) — here via `apps.exafel.compress/decompress` or the pysz
facade's app("ExaFEL") with an ExaFELConfig.
"""

from __future__ import annotations

import dataclasses
import struct

import numpy as np

from sz_tpu_torch import api
from sz_tpu_torch.config import ErrorBoundMode, SZConfig


@dataclasses.dataclass
class ExaFELConfig:
    """exafelSZ_params analog (exafelSZ.h)."""

    calib_panel: np.ndarray  # uint8 [panels, rows, cols]; nonzero = masked
    peaks_segs: np.ndarray   # uint16 [numPeaks]
    peaks_rows: np.ndarray
    peaks_cols: np.ndarray
    bin_size: int = 2
    tolerance: float = 1e-2
    sz_dim: int = 3
    peak_size: int = 3

    @property
    def peak_radius(self) -> int:
        return (self.peak_size - 1) // 2


def _roi_mask(pr: ExaFELConfig, n_events, panels, rows, cols):
    """0 = ROI (kept lossless), else the calib value (exafelSZ.c:135)."""
    m = np.broadcast_to(pr.calib_panel.reshape(1, panels, rows, cols),
                        (n_events, panels, rows, cols)).copy()
    rad = pr.peak_radius
    for p_, r_, c_ in zip(pr.peaks_segs, pr.peaks_rows, pr.peaks_cols):
        r0, r1 = max(int(r_) - rad, 0), min(int(r_) + rad + 1, rows)
        c0, c1 = max(int(c_) - rad, 0), min(int(c_) + rad + 1, cols)
        m[:, int(p_), r0:r1, c0:c1] = 0
    return m


def _bin(data, bin_size, rows, cols):
    """Mean over binSize^2 windows, edges averaged over valid pixels."""
    n_events, panels = data.shape[:2]
    br = (rows + bin_size - 1) // bin_size
    bc = (cols + bin_size - 1) // bin_size
    acc = np.zeros((n_events, panels, br, bc), dtype=np.float32)
    cnt = np.zeros((br, bc), dtype=np.int32)
    for i in range(bin_size):
        for j in range(bin_size):
            sub = data[:, :, i::bin_size, j::bin_size]
            acc[:, :, :sub.shape[2], :sub.shape[3]] += sub
            cnt[:sub.shape[2], :sub.shape[3]] += 1
    # C: float sum / int count stays float (exafelSZ.c:243)
    return (acc / cnt.astype(np.float32)).astype(np.float32), br, bc


def _sz_dims(sz_dim, n_events, panels, br, bc):
    if sz_dim == 1:
        return (n_events * panels * br * bc,)
    if sz_dim == 2:
        return (n_events * panels * br, bc)
    if sz_dim == 3:
        return (n_events * panels, br, bc)
    if sz_dim == 4:
        return (n_events, br * panels, bc)
    raise ValueError(f"szDim {sz_dim}")


def compress(pr: ExaFELConfig, data: np.ndarray, *, device="cuda") -> bytes:
    data = np.asarray(data, dtype=np.float32)
    if data.ndim == 3:
        data = data[None]
    n_events, panels, rows, cols = data.shape
    n_peaks = len(pr.peaks_segs)

    mask = _roi_mask(pr, n_events, panels, rows, cols)
    roi_vals = data[mask == 0]

    binned, br, bc = _bin(data, pr.bin_size, rows, cols)
    cfg = SZConfig().with_bound(ErrorBoundMode.ABS, pr.tolerance)
    sz_blob = api.compress(
        binned.reshape(_sz_dims(pr.sz_dim, n_events, panels, br, bc)), cfg,
        device=device)

    out = bytearray()
    out += struct.pack("<Q", n_peaks * n_events)
    for _ in range(n_events):
        out += struct.pack("<Q", n_peaks)
        for p_, r_, c_ in zip(pr.peaks_segs, pr.peaks_rows, pr.peaks_cols):
            out += struct.pack("<HHH", int(p_), int(r_), int(c_))
    out += struct.pack("<Q", len(roi_vals))
    out += roi_vals.astype("<f4").tobytes()
    out += struct.pack("<Q", len(sz_blob))
    out += sz_blob
    return bytes(out)


def decompress(pr: ExaFELConfig, blob: bytes, n_events, panels, rows,
               cols, *, device="cuda") -> np.ndarray:
    pos = 0
    (n_peaks_total,) = struct.unpack_from("<Q", blob, pos)
    pos += 8
    segs, prow, pcol = [], [], []
    for _ in range(n_events):
        (np_e,) = struct.unpack_from("<Q", blob, pos)
        pos += 8
        for _ in range(np_e):
            p_, r_, c_ = struct.unpack_from("<HHH", blob, pos)
            pos += 6
            segs.append(p_)
            prow.append(r_)
            pcol.append(c_)
    (n_roi,) = struct.unpack_from("<Q", blob, pos)
    pos += 8
    roi_vals = np.frombuffer(blob, dtype="<f4", count=n_roi, offset=pos)
    pos += 4 * n_roi
    (sz_size,) = struct.unpack_from("<Q", blob, pos)
    pos += 8
    sz_blob = blob[pos:pos + sz_size]

    # peaks are identical per event in the stream; use the first event's
    dec_pr = dataclasses.replace(
        pr, peaks_segs=np.array(segs[:len(segs) // max(n_events, 1)]),
        peaks_rows=np.array(prow[:len(prow) // max(n_events, 1)]),
        peaks_cols=np.array(pcol[:len(pcol) // max(n_events, 1)]))
    mask = _roi_mask(dec_pr, n_events, panels, rows, cols)

    br = (rows + pr.bin_size - 1) // pr.bin_size
    bc = (cols + pr.bin_size - 1) // pr.bin_size
    binned = api.decompress(
        sz_blob, _sz_dims(pr.sz_dim, n_events, panels, br, bc),
        np.float32, device=device).reshape(n_events, panels, br, bc)

    out = np.repeat(np.repeat(binned, pr.bin_size, axis=2),
                    pr.bin_size, axis=3)[:, :, :rows, :cols].copy()
    out[mask == 0] = roi_vals
    return out
