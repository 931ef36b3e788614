"""Utility tensor ops: label remapping, value resets, edge masking, image
gradients and random morphology, as torch ops: the port of
``synthsr_tpu/synth/label_ops.py`` (the reference's utility layers of
``ext/lab2im/layers.py``: ResetValuesToZero :1619, ConvertLabels :1659,
MaskEdges :1758, ImageGradients :1852, RandomDilationErosion :1953, and the
sobel / unit-ball kernel builders of ``ext/lab2im/edit_tensors.py:184-256``).
One sample at a time, channels-last (X, Y, Z, C), as the JAX functions.

The random ops are split as in ``synth/augment.py``: ``sample_*`` draws the
random values from a ``torch.Generator`` and the op applies given values,
so the tests can replay JAX's draws.  The ball convolution of the morphology
is ``F.conv3d`` (an XLA conv in JAX).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..utils.misc import get_mapping_lut, reformat_to_list, reformat_to_n_channels_array
from .sampling import bernoulli, randint, uniform


def reset_values_to_zero(x, values):
    """Set every listed value to 0 (reference ResetValuesToZero:1619-1656)."""
    for v in reformat_to_list(values):
        x = torch.where(x == v, torch.zeros_like(x), x)
    return x


def convert_labels(labels, source_values, dest_values=None):
    """LUT remap of label values (reference ConvertLabels:1659-1689)."""
    lut = torch.as_tensor(get_mapping_lut(source_values, dest=dest_values), device=labels.device)
    return lut[labels.to(torch.int64)]


def sample_mask_edges(gen, shape, axes, boundaries, prob_mask=1.0):
    """The draws of :func:`mask_edges` for a tensor of ``shape``: per axis
    the band start ``idx1`` ~ round(U(b0·size, b1·size)) and length
    ``idx2`` ~ round(U(b2·size, b3·size - 1) - idx1), and the coin."""
    axes = reformat_to_list(axes, dtype="int")
    bounds = reformat_to_n_channels_array(boundaries, n_dims=4, n_channels=len(axes))
    idx1, idx2 = [], []
    for i, axis in enumerate(axes):
        size, b = shape[axis], bounds[i]
        i1 = torch.round(uniform(gen, (), float(b[0] * size), float(b[1] * size)))
        i2 = torch.round(uniform(gen, (), float(b[2] * size), float(b[3] * size - 1)) - i1)
        idx1.append(i1)
        idx2.append(i2)
    return {"idx1": torch.stack(idx1), "idx2": torch.stack(idx2),
            "apply": bernoulli(gen, prob_mask)}


def mask_edges(x, axes, draws):
    """Zero everything outside a band [idx1, idx1 + idx2) along each axis
    where the coin says so (reference MaskEdges:1758-1849).  Returns
    (masked tensor, float32 mask)."""
    axes = reformat_to_list(axes, dtype="int")
    mask = torch.ones(x.shape, dtype=torch.float32, device=x.device)
    for i, axis in enumerate(axes):
        size = x.shape[axis]
        pos = torch.arange(size, dtype=torch.float32, device=x.device)
        i1, i2 = draws["idx1"][i].to(x.device), draws["idx2"][i].to(x.device)
        band = ((pos >= i1) & (pos < i1 + i2)).to(torch.float32)
        shape = [1] * x.dim()
        shape[axis] = size
        mask = mask * band.reshape(shape)
    gated = torch.where(draws["apply"].to(x.device), x * mask.to(x.dtype), x)
    return gated, mask


def sobel_kernels_np(n_dims=3):
    """Separable sobel kernel factors per derivative direction
    (reference edit_tensors.sobel_kernels:184-204)."""
    in_dir = np.array([1.0, 0.0, -1.0], np.float32)
    ortho = np.array([1.0, 2.0, 1.0], np.float32)
    return [[in_dir if axis == dim else ortho for axis in range(n_dims)]
            for dim in range(n_dims)]


def _conv1d_same(x, taps, axis):
    """SAME zero-padded 1-D correlation of (X, Y, Z, C) along a spatial axis."""
    n = len(taps)
    half = (n - 1) // 2
    pad = [0, 0] * x.dim()
    # F.pad takes (last axis lo, hi, second-to-last lo, hi, ...)
    pad[2 * (x.dim() - 1 - axis)], pad[2 * (x.dim() - 1 - axis) + 1] = half, n - 1 - half
    xp = F.pad(x, pad)
    out = 0.0
    for t in range(n):
        out = out + float(taps[t]) * xp.narrow(axis, t, x.shape[axis])
    return out


def image_gradients(x, gradient_type="sobel", return_magnitude=False):
    """Spatial gradients of (X, Y, Z, C) (reference ImageGradients:1852-1950).

    sobel: separable [1,0,-1]/[1,2,1] convs per direction (SAME, zero pad);
    1-step_diff: forward differences, zero-padded at the far end."""
    ndims = 3
    grads = []
    if gradient_type == "sobel":
        kernels = sobel_kernels_np(ndims)
        for dim in range(ndims):
            g = x.to(torch.float32)
            for axis in range(ndims):
                g = _conv1d_same(g, kernels[dim][axis], axis)
            grads.append(g)
    elif gradient_type == "1-step_diff":
        for axis in range(ndims):
            d = torch.diff(x, dim=axis)
            pad = [0, 0] * x.dim()
            pad[2 * (x.dim() - 1 - axis) + 1] = 1
            grads.append(F.pad(d, pad))
    else:
        raise ValueError("gradient_type should be 'sobel' or '1-step_diff'")
    if return_magnitude:
        return torch.sqrt(torch.sum(torch.square(torch.stack(grads, -1)), -1))
    return grads


def unit_kernel_np(dist_threshold: int, n_dims: int = 3):
    """Binary ball kernel of radius dist_threshold
    (reference edit_tensors.unit_kernel:207-256)."""
    w = int(dist_threshold) * 2 + 1
    mesh = np.stack(np.meshgrid(*[np.arange(w)] * n_dims, indexing="ij"), -1)
    dist = np.sqrt(np.sum((mesh - (w - 1) / 2) ** 2, axis=-1))
    return (dist <= dist_threshold).astype(np.float32)


def _ball_conv(mask, radius_sq, max_factor):
    """Binary dilation of (X, Y, Z) with a ball of squared radius
    ``radius_sq`` in a static window 2·max_factor + 1, by a convolution."""
    w = 2 * int(max_factor) + 1
    mesh = np.stack(np.meshgrid(*[np.arange(w)] * 3, indexing="ij"), -1)
    dist_sq = torch.as_tensor(np.sum((mesh - (w - 1) / 2) ** 2, axis=-1), dtype=torch.float32,
                              device=mask.device)
    kernel = (dist_sq <= radius_sq).to(torch.float32)[None, None]
    out = F.conv3d(mask[None, None], kernel, padding=w // 2)[0, 0]
    return (out > 0.01).to(torch.float32)


def sample_dilation_erosion(gen, min_factor, max_factor, max_factor_dilate=None,
                            operation="random"):
    """The draws of :func:`random_dilation_erosion`: the operation variable
    ``p`` (U(0, 1) dilation, U(-1, 0) erosion, U(-1, 1) either) and the
    ball radius (an integer in [min, max) of the drawn operation's range)."""
    if max_factor_dilate is None:
        max_factor_dilate = max_factor
    bounds = {"dilation": (0.0, 1.0), "erosion": (-1.0, 0.0), "random": (-1.0, 1.0)}
    if operation not in bounds:
        raise ValueError("operation should be 'dilation', 'erosion' or 'random'")
    p = uniform(gen, (), *bounds[operation])
    if min_factor == max_factor:
        return p, torch.tensor(float(min_factor), device=gen.device)
    f_erode = randint(gen, min_factor, max_factor).to(torch.float32)
    f_dilate = randint(gen, min_factor, max_factor_dilate).to(torch.float32)
    return p, torch.where(p < 0, f_erode, f_dilate)


def random_dilation_erosion(x, p, factor, max_factor, max_factor_dilate=None, prob=1.0,
                            return_mask=False):
    """Binary dilation or erosion of the non-zero mask of (X, Y, Z, C) ``x``
    with a ball of radius ``factor`` (reference RandomDilationErosion:
    1953-2060): dilation where p > 1 - prob + 0.001, erosion where
    p < -(1 - prob + 0.001).  Dilation: conv(mask, ball) > 0; erosion:
    1 - (conv(1 - mask, ball) > 0), so outside the volume counts as
    foreground.  The window is static at the maximum factor."""
    if max_factor_dilate is None:
        max_factor_dilate = max_factor
    static_max = max(int(max_factor), int(max_factor_dilate))
    mask = (x != 0).to(torch.float32)
    radius_sq = factor.to(x.device, torch.float32) ** 2
    m = mask[..., 0]
    dilated = _ball_conv(m, radius_sq, static_max)[..., None]
    eroded = 1.0 - _ball_conv(1.0 - m, radius_sq, static_max)[..., None]
    thr = 1.0 - prob + 0.001
    p = p.to(x.device)
    new_mask = torch.where(p > thr, dilated, mask)
    new_mask = torch.where(p < -thr, eroded, new_mask)
    if return_mask:
        return new_mask.to(torch.bool)
    return x * new_mask.to(x.dtype)
