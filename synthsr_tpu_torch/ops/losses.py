"""Loss functions: the port of ``synthsr_tpu/ops/losses.py``.

Image-regression metrics (l1 / l2 / 3-plane SSIM / Laplace NLL, reference
``SynthSR/metrics_model.py:93-128``) and the segmentation losses of
``ext/lab2im/layers.py`` (Dice :1264, weighted L2 :1382, cross entropy :1418,
moment :1532) as plain torch functions.  Tensors keep the JAX package's
channels-last layout (B, *spatial, C).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

_EPS = 1e-7  # tf.keras.backend.epsilon()


def l1_loss(pred, target):
    return torch.mean(torch.abs(pred - target))


def l2_loss(pred, target):
    return torch.mean(torch.square(pred - target))


def laplace_nll(pred_intensities, pred_spreads, target):
    """b = 1e-5 + 0.02·exp(spread); mean(log(2b) + |err|/b)
    (metrics_model.py:95-99)."""
    b = 1e-5 + 0.02 * torch.exp(pred_spreads)
    return torch.mean(torch.log(2.0 * b) + torch.abs(pred_intensities - target) / b)


def ssim_plane_map(x, y, max_val=1.0, filter_size=11, filter_sigma=1.5, k1=0.01, k2=0.03):
    """Per-window SSIM map of (..., H, W) planes with tf.image.ssim semantics:
    11-tap gaussian window (σ=1.5), VALID padding, biased (co)variances.
    Returns the (..., H-10, W-10) lum·cs map."""
    off = np.arange(filter_size, dtype=np.float64) - (filter_size - 1) / 2
    w = np.exp(-(off ** 2) / (2 * filter_sigma ** 2))
    w = torch.as_tensor(w / w.sum(), dtype=torch.float32, device=x.device)

    def filt2(v):
        v = torch.einsum("...ok,k->...o", v.unfold(-1, filter_size, 1), w)
        return torch.einsum("...ok,k->...o", v.transpose(-1, -2).unfold(-1, filter_size, 1),
                            w).transpose(-1, -2)

    c1 = (k1 * max_val) ** 2
    c2 = (k2 * max_val) ** 2
    mu_x, mu_y = filt2(x), filt2(y)
    mu_xx = filt2(x * x) - mu_x * mu_x
    mu_yy = filt2(y * y) - mu_y * mu_y
    mu_xy = filt2(x * y) - mu_x * mu_y
    lum = (2 * mu_x * mu_y + c1) / (mu_x ** 2 + mu_y ** 2 + c1)
    cs = (2 * mu_xy + c2) / (mu_xx + mu_yy + c2)
    return lum * cs


def ssim3d_loss(pred, target, max_val=1.0):
    """-mean of 2-D SSIM over the three plane orientations
    (metrics_model.py:108-128).  pred/target: (B, X, Y, Z, 1)."""
    p, t = pred[..., 0], target[..., 0]
    s1 = ssim_plane_map(p, t, max_val).mean()
    s2 = ssim_plane_map(p.transpose(2, 3), t.transpose(2, 3), max_val).mean()
    s3 = ssim_plane_map(p.permute(0, 2, 3, 1), t.permute(0, 2, 3, 1), max_val).mean()
    return -(s1 + s2 + s3) / 3.0


def dice_loss(gt, pred, class_weights=None, boundary_weights=0, boundary_dist=3,
              skip_background=True, enable_checks=True):
    """Soft Dice loss over one-hot maps (B, *spatial, n_labels)
    (lab2im/layers.py:1264-1379)."""
    n_labels = gt.shape[-1]
    ndims = gt.dim() - 2
    spatial = tuple(range(1, ndims + 1))
    if n_labels == 1:
        skip_background = False
    if enable_checks:
        gt = torch.clamp(gt / (gt.sum(-1, keepdim=True) + _EPS), 0, 1)
        pred = torch.clamp(pred / (pred.sum(-1, keepdim=True) + _EPS), 0, 1)
    top = 2.0 * gt * pred
    bottom = torch.square(gt) + torch.square(pred)
    bw = None
    if boundary_weights:
        if ndims != 3:
            raise NotImplementedError("boundary weights are ported for 3-D maps only")
        k = 2 * boundary_dist + 1
        # SAME window sum / k³ (zero padding): a box mean counting the pad
        avg = F.avg_pool3d(gt.permute(0, 4, 1, 2, 3), k, stride=1, padding=k // 2,
                           count_include_pad=True).permute(0, 2, 3, 4, 1)
        boundaries = ((avg > 0.0) & (avg < (1.0 / ndims - 1e-4))).to(torch.float32)
        if skip_background:
            boundaries[..., 0] = 0.0
        bw = 1.0 + boundary_weights * boundaries
        top, bottom = top * bw, bottom * bw
    top = top.sum(spatial)
    bottom = bottom.sum(spatial)
    loss = 1.0 - (top + _EPS) / (bottom + _EPS)  # (B, n_labels)
    if class_weights is not None:
        if np.isscalar(class_weights) and class_weights == -1:
            cw = 1.0 / (gt * bw if bw is not None else gt).sum(spatial)
        else:
            cw = torch.as_tensor(class_weights, dtype=torch.float32,
                                 device=loss.device)[None].expand_as(loss)
        cw = cw / cw.sum(-1, keepdim=True)
        loss = (loss * cw).sum(-1)
    return loss.mean()


def weighted_l2_loss(gt, pred, target_value=5.0):
    """Pre-softmax weighted L2 (lab2im/layers.py:1382-1415)."""
    n_labels = gt.shape[-1]
    weights = (1.0 - gt[..., 0] + 1e-8)[..., None]
    return (weights * torch.square(pred - target_value * (2 * gt - 1))).sum() / \
        (weights.sum() * n_labels)


def cross_entropy_loss(gt, pred, class_weights=None, enable_checks=True):
    """Per-voxel CE summed over labels, averaged over voxels
    (lab2im/layers.py:1418-1529)."""
    if enable_checks:
        gt = torch.clamp(gt / (gt.sum(-1, keepdim=True) + _EPS), 0, 1)
        pred = pred / (pred.sum(-1, keepdim=True) + _EPS)
        pred = torch.clamp(pred, _EPS, 1 - _EPS)
    ce = -gt * torch.log(pred)
    if class_weights is not None:
        cw = torch.as_tensor(class_weights, dtype=torch.float32, device=ce.device)
        ce = ce * (cw / cw.sum())
    return ce.sum(-1).mean()


def moment_loss(gt, pred, enable_checks=True):
    """Distance between centres of gravity per channel
    (lab2im/layers.py:1532-1616)."""
    ndims = gt.dim() - 2
    spatial_axes = tuple(range(1, ndims + 1))
    if enable_checks:
        gt = gt / (gt.sum(-1, keepdim=True) + _EPS)
        pred = pred / (pred.sum(-1, keepdim=True) + _EPS)
    coords = torch.stack(torch.meshgrid(
        *[torch.arange(s, dtype=torch.float32, device=gt.device) for s in gt.shape[1:-1]],
        indexing="ij"), -1)[None, ..., None, :]  # (1, *spatial, 1, ndims)

    def centre(x):
        return (x[..., None] * coords).sum(spatial_axes) / (x.sum(spatial_axes)[..., None] + _EPS)

    return torch.sqrt(torch.square(centre(pred) - centre(gt)).sum(-1)).mean()
