"""Prediction assembly, regression loss and the frozen-segmenter Dice term:
the port of ``synthsr_tpu/train/metrics.py`` (reference
``SynthSR/metrics_model.py:29-215``) and of ``build_seg_loss_fn``
(``synthsr_tpu/train/training.py:82-121``).

Tensors keep the JAX package's channels-last layout (B, X, Y, Z, C).
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from ..ops.losses import dice_loss, l1_loss, l2_loss, laplace_nll, ssim3d_loss
from ..utils.misc import reformat_to_list


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


def build_seg_loss_fn(seg_model, generation_labels, segmentation_label_equivalency,
                      loss_cropping, m=None, M=None, fs_header=False,
                      compute_dtype=torch.float32):
    """``seg_dice(prediction, labels_target)`` through a FROZEN segmenter
    (reference metrics_model.add_seg_loss_to_model:136-215).

    ``seg_model``: a ``UNet3D`` with a softmax head, put in eval mode (its
    running BatchNorm statistics) with ``requires_grad`` off on its
    parameters, so the gradient flows to the prediction only; it runs the
    plain ``forward`` in ``compute_dtype``.  The prediction (B, X, Y, Z, 1)
    is clipped to [m, M] and scaled to [0, 1] when ``m`` is given, swapped
    and flipped into the FreeSurfer header orientation with ``fs_header``
    (and the segmentation back), both centre-cropped to ``loss_cropping``;
    each generation label with segmenter outputs of equal value in
    ``segmentation_label_equivalency`` (up to 3, summed) is one Dice class,
    its ground truth the one-hot of the label VALUE in the target (the
    reference compares with the index, metrics_model.py:196: the JAX
    package's documented fix)."""
    seg_model.eval()
    for p in seg_model.parameters():
        p.requires_grad_(False)
    generation_labels = np.asarray(generation_labels)
    eq = np.asarray(segmentation_label_equivalency)
    pairs = []  # (generation label value, segmenter output indices)
    for i in range(len(generation_labels)):
        idx = np.where(eq == generation_labels[i])[0]
        if len(idx) > 0:
            if len(idx) > 3:
                raise ValueError("merging more than 3 labels is not supported")
            pairs.append((int(generation_labels[i]), [int(j) for j in idx]))

    def seg_dice(prediction, segm_target):
        x = prediction
        if m is not None:
            x = (torch.clamp(x, m, M) - m) / (M - m)
        if fs_header:
            x = torch.flip(x.transpose(2, 3), [2])
        pred_seg = seg_model(x.permute(0, 4, 1, 2, 3), compute_dtype).permute(0, 2, 3, 4, 1)
        if fs_header:
            pred_seg = torch.flip(pred_seg, [2]).transpose(2, 3)
        segm_target_c = center_crop(segm_target, loss_cropping)
        pred_seg = center_crop(pred_seg, loss_cropping)
        gt = torch.stack([(segm_target_c[..., -1] == value).to(torch.float32)
                          for value, _ in pairs], -1)
        pr = torch.stack([sum(pred_seg[..., j] for j in idx) for _, idx in pairs], -1)
        return dice_loss(gt, pr, enable_checks=False)

    return seg_dice
