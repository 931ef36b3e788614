"""Blurring sigma rules and the masked blur: the port of
``synthsr_tpu/ops/blur.py`` (reference ``ext/lab2im/edit_tensors.py:41-83``
and the mask-renormalised path of GaussianBlur, ``lab2im/layers.py:747-757``).
"""

from __future__ import annotations

import numpy as np
import torch

from .linops import blur3d


def blurring_sigma_for_downsampling(current_res, downsample_res, mult_coef=None,
                                    thickness=None, device=None):
    """Per-axis PSF sigma for acquiring at ``downsample_res`` from
    ``current_res``: 0.75·down/current, exactly 0.5 where equal, 0 where the
    target resolution is 0; ``mult_coef`` replaces the 0.75 (and the
    0.5-at-equality rule).  Tensors (drawn values) or array-likes."""
    down = torch.as_tensor(downsample_res, dtype=torch.float32, device=device)
    current = torch.as_tensor(current_res, dtype=torch.float32, device=down.device)
    if thickness is not None:
        down = torch.minimum(down, torch.as_tensor(thickness, dtype=torch.float32,
                                                   device=down.device))
    if mult_coef is None:
        sigma = torch.where(down == current, torch.full_like(down, 0.5), 0.75 * down / current)
    else:
        sigma = mult_coef * down / current
    return torch.where(down == 0.0, torch.zeros_like(sigma), sigma)


def blurring_sigma_np(current_res, downsample_res, mult_coef=None, thickness=None):
    """Numpy twin, for the host-side shape planning."""
    current = np.asarray(current_res, np.float32)
    down = np.asarray(downsample_res, np.float32)
    if thickness is not None:
        down = np.minimum(down, np.asarray(thickness, np.float32))
    if mult_coef is None:
        sigma = np.where(down == current, 0.5, 0.75 * down / current)
    else:
        sigma = mult_coef * down / current
    return np.where(down == 0.0, 0.0, sigma).astype(np.float32)


def blur_with_mask(vol: torch.Tensor, sigmas, mask: torch.Tensor, max_sigmas=None):
    """Blur inside a mask only, renormalised by the blurred mask."""
    mask = (mask > 0).to(vol.dtype)
    blurred = blur3d(vol * mask, sigmas, max_sigmas)
    weights = blur3d(mask, sigmas, max_sigmas)
    return torch.where(mask > 0, blurred / torch.clamp(weights, min=1e-9),
                       torch.zeros((), device=vol.device))
