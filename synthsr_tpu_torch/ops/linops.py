"""Separable per-axis linear operators: the port of
``synthsr_tpu/ops/linops.py``.

Every per-axis linear step of the synthesis pipeline (gaussian blur with a
sigma drawn at run time, nearest-neighbour downsampling to a random grid,
linear resampling, their compositions) is an (out, in) matrix whose values
depend on the draws and whose shape does not; one float32 matrix product per
axis applies it (reference ``ext/lab2im/edit_tensors.py`` gaussian_kernel :86,
resample_tensor :257; ``ext/lab2im/layers.py`` GaussianBlur :655,
DynamicGaussianBlur :770, MimicAcquisition :835).  The predict path's 1 mm
resample uses :func:`apply_axis_ops` with matrices built on the host
(``ops/host_matrices.py``).
"""

from __future__ import annotations

import math

import numpy as np
import torch


def _f32(v, device=None):
    return torch.as_tensor(v, dtype=torch.float32, device=device)


def gaussian_window_size(max_sigma: float) -> int:
    """Static kernel window for a maximum sigma: int(ceil(2.5σ)/2)*2+1
    (reference edit_tensors.py:124)."""
    return int(np.int32(math.ceil(2.5 * float(max_sigma)) / 2)) * 2 + 1


def gaussian_kernel_1d(sigma, window_size: int, device=None):
    """Normalised 1-D gaussian taps of length ``window_size``; sigma == 0
    gives a delta (edit_tensors.py:86-181)."""
    sigma = _f32(sigma, device)
    x = torch.arange(window_size, dtype=torch.float32, device=sigma.device) \
        - (window_size - 1) / 2.0
    safe = torch.where(sigma > 0, sigma, torch.ones_like(sigma))
    g = torch.exp(-(x ** 2) / (2.0 * safe ** 2))
    g = g / g.sum()
    return torch.where(sigma > 0, g, (x == 0).to(torch.float32))


def blur_matrix(size: int, sigma, max_sigma: float | None = None, device=None):
    """(size, size) banded gaussian-blur matrix with zero (SAME-conv) padding:
    rows near the edge lose taps (lab2im/layers.py:745-757)."""
    if max_sigma is None:
        max_sigma = float(sigma)
    sigma = _f32(sigma, device)
    win = gaussian_window_size(max_sigma)
    if win <= 1:
        return torch.eye(size, dtype=torch.float32, device=sigma.device)
    k = gaussian_kernel_1d(sigma, win)
    i = torch.arange(size, device=sigma.device)
    off = i[None, :] - i[:, None] + (win - 1) // 2  # tap index of entry (i, j)
    valid = (off >= 0) & (off < win)
    return torch.where(valid, k[off.clamp(0, win - 1)], torch.zeros((), device=sigma.device))


def _interp_rows(coord: torch.Tensor, in_size: int, method: str):
    j = torch.arange(in_size, dtype=torch.float32, device=coord.device)[None, :]
    c = coord[:, None]
    if method == "linear":
        # coordinates clipped onto 0 / in-1 already give one weight-1 tap
        return torch.clamp(1.0 - torch.abs(c - j), min=0.0)
    if method == "nearest":
        return (j == torch.clamp(torch.round(c), 0, in_size - 1)).to(torch.float32)
    raise ValueError(f"method must be 'linear' or 'nearest', got {method}")


def resize_matrix(out_size: int, in_size: int, zoom=None, method: str = "linear", device=None):
    """(out_size, in_size): output index g samples input coordinate g / zoom,
    clipped to the bounds (neuron/utils.py:127-156)."""
    zoom = _f32(out_size / in_size if zoom is None else zoom, device)
    g = torch.arange(out_size, dtype=torch.float32, device=zoom.device)
    return _interp_rows(torch.clamp(g / zoom, 0.0, in_size - 1.0), in_size, method)


def sample_matrix(coords, in_size: int, method: str = "linear", device=None):
    """(len(coords), in_size) interpolation matrix at arbitrary coordinates,
    clipped to the bounds."""
    return _interp_rows(torch.clamp(_f32(coords, device), 0.0, in_size - 1.0), in_size, method)


def nn_downsample_matrix(out_size: int, in_size: int, zoom, lr_count=None, device=None):
    """(out_size, in_size) one-hot nearest matrix for LR node g at g / zoom,
    rows >= lr_count zeroed (the static-shape MimicAcquisition downsample,
    lab2im/layers.py:946-951)."""
    zoom = _f32(zoom, device)
    g = torch.arange(out_size, dtype=torch.float32, device=zoom.device)
    m = _interp_rows(torch.clamp(g / zoom, 0.0, in_size - 1.0), in_size, "nearest")
    if lr_count is not None:
        m = m * (torch.arange(out_size, device=zoom.device)[:, None]
                 < _f32(lr_count, zoom.device))
    return m


def apply_axis_ops(vol: torch.Tensor, mats) -> torch.Tensor:
    """Apply one (out_d, in_d) matrix per leading spatial axis of ``vol``.

    ``vol``: (X, Y, Z, ...), trailing axes pass through.  ``mats``: three
    matrices (or None for identity) on ``vol``'s device.  Float32 throughout
    (a float32 matmul on the card stays full float32 unless the caller turns
    TF32 on)."""
    mx, my, mz = mats
    out = vol.to(torch.float32)
    if mx is not None:
        out = torch.einsum("ax,xyz...->ayz...", mx.to(torch.float32), out)
    if my is not None:
        out = torch.einsum("by,xyz...->xbz...", my.to(torch.float32), out)
    if mz is not None:
        out = torch.einsum("cz,xyz...->xyc...", mz.to(torch.float32), out)
    return out


def blur3d(vol: torch.Tensor, sigmas, max_sigmas=None) -> torch.Tensor:
    """Separable 3-D gaussian blur of (X, Y, Z[, C]) with per-axis sigma
    (GaussianBlur / DynamicGaussianBlur, lab2im/layers.py:655-832)."""
    if max_sigmas is None:
        max_sigmas = [float(s) for s in sigmas]
    mats = [blur_matrix(vol.shape[d], sigmas[d], max_sigmas[d], device=vol.device)
            for d in range(3)]
    return apply_axis_ops(vol, mats)
