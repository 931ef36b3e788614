"""The plain predict pipeline of SynthSR (BBillot/SynthSR
``scripts/predict_command_line.py``), the reference of the predict cells.
It imports nothing of the program.

From the raw volume and its affine: resample to 1 mm (per axis, the
original's ``edit_volumes.resample_volume``: a gaussian blur of sigma
0.25 / factor on axes that shrink, then linear interpolation on the
centre-aligned grid ``arange(-(f - 1) / (2 f), start + ceil(n f) / f, 1 / f)``
clipped to the volume), alignment to RAS (``align_volume_to_ref``: axes
permuted to R, A, S and flipped where they point the other way), min-max
normalisation, a centred zero pad to a multiple of 32, the network and its
flip along the first axis averaged, ``clip(255 y, 0, 128)``, the pad cropped.
The resample and normalisation run in float64, the network in float32 with
TF32 off.
"""

from __future__ import annotations

import numpy as np
import torch

from .unet import forward


def axis_coords(n: int, factor: float) -> np.ndarray:
    start = -(factor - 1) / (2 * factor)
    step = 1.0 / factor
    stop = start + step * np.ceil(n * factor)
    return np.clip(np.arange(start, stop, step), 0, n - 1)


def _blur_axis(t: torch.Tensor, axis: int, sigma: float) -> torch.Tensor:
    """scipy's gaussian_filter1d (truncate 4, 'reflect' boundary) along ``axis``."""
    r = int(4.0 * sigma + 0.5)
    x = torch.arange(-r, r + 1, dtype=torch.float64, device=t.device)
    k = torch.exp(-x * x / (2 * sigma * sigma))
    k = k / k.sum()
    n = t.shape[axis]
    idx = torch.arange(-r, n + r, device=t.device) % (2 * n)
    idx = torch.where(idx < n, idx, 2 * n - 1 - idx)
    padded = t.index_select(axis, idx)
    out = torch.zeros_like(t)
    for j in range(2 * r + 1):
        out += k[j] * padded.narrow(axis, j, n)
    return out


def _interp_axis(t: torch.Tensor, axis: int, coords: np.ndarray) -> torch.Tensor:
    c = torch.as_tensor(coords, dtype=torch.float64, device=t.device)
    lo = torch.floor(c).long().clamp(0, t.shape[axis] - 1)
    hi = (lo + 1).clamp(max=t.shape[axis] - 1)
    w = (c - lo).reshape([-1 if d == axis else 1 for d in range(t.dim())])
    return t.index_select(axis, lo) * (1 - w) + t.index_select(axis, hi) * w


def resample_1mm(vol: torch.Tensor, aff: np.ndarray):
    pixdim = np.sqrt((aff[:3, :3] ** 2).sum(0))
    factor = pixdim / 1.0
    for axis in range(3):
        if factor[axis] < 1:
            vol = _blur_axis(vol, axis, 0.25 / factor[axis])
        vol = _interp_axis(vol, axis, axis_coords(vol.shape[axis], factor[axis]))
    new = aff.copy()
    new[:3, :3] = aff[:3, :3] / factor
    new[:3, 3] = aff[:3, 3] - aff[:3, :3] @ (0.5 * (factor - 1))
    return vol, new


def align_ras(vol: torch.Tensor, aff: np.ndarray):
    """Permute the axes to R, A, S and flip those that point the other way."""
    axes = np.argmax(np.abs(np.linalg.inv(aff)[:3, :3]), axis=0)  # volume axis of each RAS axis
    if sorted(axes) != [0, 1, 2]:
        raise ValueError(f"an affine whose axes are not a permutation of RAS: {aff}")
    vol = vol.permute(*[int(a) for a in axes])
    aff = aff.copy()
    aff[:, :3] = aff[:, list(axes)]
    for i in range(3):
        if aff[i, i] < 0:
            vol = vol.flip(i)
            aff[:3, 3] = aff[:3, 3] + aff[:3, i] * (vol.shape[i] - 1)
            aff[:, i] = -aff[:, i]
    return vol, aff


def prepare(vol: np.ndarray, aff: np.ndarray, device, ct: bool = False):
    """(x (1, 1, D, H, W) float32, crop slices) of one raw volume."""
    t = torch.as_tensor(np.asarray(vol), dtype=torch.float64, device=device)
    if ct:
        t = t.clamp(0.0, 80.0)
    t, aff = resample_1mm(t, np.asarray(aff, np.float64))
    t, _ = align_ras(t, aff)
    t = t - t.min()
    if t.max() > 0:
        t = t / t.max()
    shape = np.array(t.shape)
    padded = (np.ceil(shape / 32.0) * 32).astype(int)
    lo = np.floor((padded - shape) / 2).astype(int)
    crop = tuple(slice(int(a), int(a + s)) for a, s in zip(lo, shape))
    x = torch.zeros((1, 1, *padded), dtype=torch.float32, device=device)
    x[(0, 0) + crop] = t.to(torch.float32)
    return x, crop


@torch.no_grad()
def predict(sd: dict, cfg: dict, vol: np.ndarray, aff: np.ndarray, device, quant=None,
            tta: bool = True, ct: bool = False) -> np.ndarray:
    """The 1 mm synthetic MP-RAGE of one raw volume, float32 numpy."""
    x, crop = prepare(vol, aff, device, ct)
    y = forward(sd, cfg, x, quant=quant)
    if tta:
        y = 0.5 * y + 0.5 * forward(sd, cfg, x.flip(2), quant=quant).flip(2)
    out = torch.clamp(255.0 * y, 0.0, 128.0)[0, 0][crop]
    return out.cpu().numpy()


def compare(pred: np.ndarray, ref: np.ndarray):
    """(root-mean-square gap, largest gap) of an output against the
    reference's, in the output's intensity units; inf where the shapes
    differ.  Not relative: with seeded weights the output's level varies
    from seed to seed while the gap that rounding leaves does not."""
    if pred.shape != ref.shape:
        return float("inf"), float("inf")
    d = np.asarray(pred, np.float64) - np.asarray(ref, np.float64)
    return float(np.sqrt(np.mean(d * d))), float(np.abs(d).max())
