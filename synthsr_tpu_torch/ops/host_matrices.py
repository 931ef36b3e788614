"""Host-built (numpy) per-axis operator matrices for the predict paths: the
port's own copy of ``synthsr_tpu/ops/host_matrices.py``.

The reference predict CLI resamples each input to 1 mm on the host with scipy
(``edit_volumes.resample_volume`` at predict_command_line.py:117: gaussian
blur sigma 0.25/factor with scipy defaults — truncate 4.0, 'reflect' boundary —
then centre-aligned linear interpolation).  For output-fidelity parity the
same math is built here as per-axis matrices on the host (shapes are
per-image anyway) and applied on the device as einsums
(``ops/linops.apply_axis_ops``).
"""

from __future__ import annotations

import numpy as np


def _reflect_index(t: np.ndarray, n: int) -> np.ndarray:
    """scipy 'reflect' (half-sample symmetric) boundary: (d c b a | a b c d | d c b a)."""
    if n == 1:
        return np.zeros_like(t)
    period = 2 * n
    t = np.mod(t, period)
    t = np.where(t < 0, t + period, t)
    return np.where(t < n, t, period - 1 - t)


def scipy_gaussian_matrix(n: int, sigma: float, truncate: float = 4.0) -> np.ndarray:
    """(n, n) matrix equal to scipy.ndimage.gaussian_filter1d(mode='reflect')."""
    if sigma <= 0:
        return np.eye(n, dtype=np.float32)
    r = int(truncate * float(sigma) + 0.5)
    x = np.arange(-r, r + 1, dtype=np.float64)
    k = np.exp(-(x ** 2) / (2.0 * sigma ** 2))
    k /= k.sum()
    m = np.zeros((n, n), dtype=np.float64)
    rows = np.arange(n)[:, None]
    taps = rows + np.arange(-r, r + 1)[None, :]
    cols = _reflect_index(taps, n)
    np.add.at(m, (np.broadcast_to(rows, cols.shape), cols),
              np.broadcast_to(k[None, :], cols.shape))
    return m.astype(np.float32)


def linear_sample_matrix(coords: np.ndarray, in_size: int) -> np.ndarray:
    """(len(coords), in_size) linear-interpolation matrix at given (clipped)
    float coordinates — RegularGridInterpolator(method='linear') semantics."""
    coords = np.clip(np.asarray(coords, np.float64), 0, in_size - 1)
    lo = np.clip(np.floor(coords).astype(int), 0, in_size - 1)
    hi = np.minimum(lo + 1, in_size - 1)
    w_hi = coords - lo
    m = np.zeros((len(coords), in_size), dtype=np.float64)
    np.add.at(m, (np.arange(len(coords)), lo), 1.0 - w_hi)
    np.add.at(m, (np.arange(len(coords)), hi), w_hi)
    return m.astype(np.float32)


def nearest_sample_matrix(coords: np.ndarray, in_size: int) -> np.ndarray:
    coords = np.clip(np.asarray(coords, np.float64), 0, in_size - 1)
    j = np.clip(np.round(coords).astype(int), 0, in_size - 1)
    m = np.zeros((len(coords), in_size), dtype=np.float32)
    m[np.arange(len(coords)), j] = 1.0
    return m


def resample_axis_coords(in_size: int, factor: float) -> np.ndarray:
    """The reference's centre-aligned resampling grid
    (edit_volumes.py:531-543): start=-(f-1)/(2f), step=1/f,
    stop=start+step*ceil(size*f), then clipped to [0, size-1]."""
    factor = float(factor)
    start = -(factor - 1) / (2 * factor)
    step = 1.0 / factor
    stop = start + step * np.ceil(in_size * factor)
    c = np.arange(start, stop, step)
    return np.clip(c, 0, in_size - 1)


def resample_volume_matrices(shape, aff: np.ndarray, new_vox_size,
                             interpolation: str = "linear", blur: bool = True):
    """Per-axis matrices + updated affine realizing the reference
    ``resample_volume`` (edit_volumes.py:504-552) on device.

    Returns (mats, new_shape, new_aff)."""
    pixdim = np.sqrt(np.sum(aff * aff, axis=0))[:-1]
    new_vox_size = np.asarray(new_vox_size, np.float64)
    factor = pixdim / new_vox_size
    sigmas = 0.25 / factor
    sigmas[factor > 1] = 0

    mats = []
    new_shape = []
    for d in range(3):
        coords = resample_axis_coords(shape[d], factor[d])
        if interpolation == "linear":
            s = linear_sample_matrix(coords, shape[d])
        else:
            s = nearest_sample_matrix(coords, shape[d])
        if blur and sigmas[d] > 0:
            s = (s.astype(np.float64) @ scipy_gaussian_matrix(shape[d], sigmas[d]).astype(np.float64)).astype(np.float32)
        mats.append(s)
        new_shape.append(len(coords))

    new_aff = aff.copy()
    for c in range(3):
        new_aff[:-1, c] = new_aff[:-1, c] / factor[c]
    new_aff[:-1, -1] = new_aff[:-1, -1] - new_aff[:-1, :-1] @ (0.5 * (factor - 1))
    return mats, tuple(new_shape), new_aff


def reslice_like_matrices(ref_shape, ref_aff, flo_shape, flo_aff,
                          interpolation: str = "linear"):
    """Separable case of resample_volume_like (edit_volumes.py:555-588):
    valid when inv(aff_flo)@aff_ref is axis-aligned (diagonal linear part up to
    permutation is NOT handled here — caller must check). Returns per-axis
    matrices or None if the transform is not separable."""
    t = np.linalg.inv(flo_aff) @ ref_aff
    lin = t[:3, :3]
    if np.abs(lin - np.diag(np.diag(lin))).max() > 1e-6:
        return None
    mats = []
    for d in range(3):
        coords = np.arange(ref_shape[d]) * lin[d, d] + t[d, 3]
        if interpolation == "linear":
            m = linear_sample_matrix(coords, flo_shape[d])
        else:
            m = nearest_sample_matrix(coords, flo_shape[d])
        # out-of-FOV rows are zero (bounds_error=False, fill_value=0.0 in the
        # reference's RegularGridInterpolator call)
        oob = (coords < 0) | (coords > flo_shape[d] - 1)
        m[oob] = 0.0
        mats.append(m)
    return mats
