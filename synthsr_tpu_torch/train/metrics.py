"""Prediction assembly + regression loss: the port of
``synthsr_tpu/train/metrics.py`` (reference ``SynthSR/metrics_model.py:29-132``).

Tensors keep the JAX package's channels-last layout (B, X, Y, Z, C).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from synthsr_tpu.utils.misc import reformat_to_list

from ..ops.losses import l1_loss, l2_loss, laplace_nll, ssim3d_loss


def center_crop(x: torch.Tensor, crop: Optional[Sequence[int]]):
    """Centre-crop (B, X, Y, Z, C) spatially to ``crop`` (metrics_model.py:72-91)."""
    if crop is None:
        return x
    spatial = x.shape[1:-1]
    crop = reformat_to_list(crop, length=len(spatial))
    begin = [int((spatial[i] - crop[i]) / 2) for i in range(len(spatial))]
    return x[(slice(None),) + tuple(slice(b, b + c) for b, c in zip(begin, crop))]


def assemble_prediction(net_out, image_out, metrics="l1", work_with_residual_channel=None):
    """Split laplace channels and add residual input channels
    (metrics_model.py:31-65).  Returns (intensities, spreads_or_None)."""
    spreads = None
    if metrics == "laplace":
        nc = net_out.shape[-1] // 2
        intensities, spreads = net_out[..., :nc], net_out[..., nc:]
    else:
        intensities = net_out
    if work_with_residual_channel is not None:
        intensities = intensities + image_out[..., list(work_with_residual_channel)]
    return intensities, spreads


def regression_loss(net_out, image_out, target, metrics="l1", loss_cropping=16,
                    work_with_residual_channel=None):
    """The metrics model as a function: assemble -> crop -> metric scalar."""
    intensities, spreads = assemble_prediction(net_out, image_out, metrics,
                                               work_with_residual_channel)
    intensities = center_crop(intensities, loss_cropping)
    target = center_crop(target, loss_cropping)
    if metrics == "laplace":
        return laplace_nll(intensities, center_crop(spreads, loss_cropping), target)
    if metrics == "l2":
        return l2_loss(intensities, target)
    if metrics == "l1":
        return l1_loss(intensities, target)
    if metrics == "ssim":
        if target.shape[-1] > 1:
            raise ValueError("SSIM metric does not currently support multiple channels")
        return ssim3d_loss(intensities, target)
    raise ValueError(f"metrics should be l1/l2/ssim/laplace, got {metrics}")


def doubled_residual_indices(work_with_residual_channel, build_reliability_maps,
                             input_channels=None):
    """Map synthetic-channel indices to image_out positions: rank among the
    input channels, doubled when reliability maps interleave.  The JAX
    package's function as it is (synthsr_tpu/train/metrics.py:77-100), pure
    Python, copied because its module imports jax."""
    if work_with_residual_channel is None:
        return None
    idx = reformat_to_list(work_with_residual_channel)
    if input_channels is not None:
        rank = {}
        r = 0
        for i, c in enumerate(input_channels):
            if c:
                rank[i] = r
                r += 1
        for i in idx:
            if i not in rank:
                raise ValueError(f"residual channel {i} is not an input channel")
        idx = [rank[i] for i in idx]
    return [2 * i for i in idx] if build_reliability_maps else idx
