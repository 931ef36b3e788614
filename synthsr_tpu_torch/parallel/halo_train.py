"""Spatially sharded training with halo-exchange convolutions: the port of
``synthsr_tpu/parallel/halo_train.py``.

One training example is split along D over the ranks of a
``torch.distributed`` group; the net is ``UNet3D.forward_train(x_local,
halo=group)``, whose convolutions exchange planes with the neighbours
(``parallel/halo.py``), and autograd runs the reversed exchange in the
backward pass (``halo._HaloPad.backward``, which JAX derives by itself).
Parameters are replicated.  One sharded step equals the unsharded step on
the whole volume up to float32 summation order:

- BatchNorm in train mode takes global statistics: the slices are equal, so
  the rank mean of the per-slice means of x and x² (``unet.bn_batch_stats``
  over the group, a differentiable all-reduce) is the volume's, with flax's
  fast variance ``max(E[x²] - E[x]², 0)`` and momentum 0.99;
- the loss is cropped by global D indices, and SSIM exchanges a 5-plane halo
  for its windows along D;
- each rank differentiates its own shard's share of the loss (its local sum
  over the global count), never the summed total: the transpose of a sum
  over ranks is again a sum, so a replicated objective would hand every rank
  an n-times cotangent (JAX's note, halo_train.py:106-115);
- the gradients and the loss are SUMMED over the ranks (JAX's psum,
  ``mesh.all_reduce_sum_list``), not averaged as ``all_reduce_mean_list``
  does for data parallelism; the loss only for display, outside autograd.

Generation is not sharded: the step takes (image, target) pairs.
"""

from __future__ import annotations

import torch

from ..ops.losses import ssim_plane_map
from ..utils.misc import reformat_to_list
from .halo import check_divisible, halo_pad, local_d_slice
from .mesh import all_reduce_sum_list, rank_and_size

METRICS = ("l1", "l2", "ssim", "laplace")


def _crop_begin(spatial, crop):
    crop = reformat_to_list(crop, length=3)
    return [int((spatial[i] - crop[i]) / 2) for i in range(3)], crop


def _global_planes(group, local_d, device):
    rank, _ = rank_and_size(group)
    return rank * local_d + torch.arange(local_d, device=device)


def global_masked_loss(err, crop, group, global_d):
    """This rank's share of the mean of a pointwise error map ``err`` (B, C,
    D/n, H, W) over the centre ``crop`` of the global volume: the masked local
    sum over the global count.  The shares sum to ``regression_loss``'s
    centre crop + mean on the unsharded volume."""
    _, n = rank_and_size(group)
    if crop is None:
        return err.sum() / float(err.numel() * n)
    (b0, b1, b2), crop = _crop_begin((global_d,) + tuple(err.shape[3:]), crop)
    gd = _global_planes(group, err.shape[2], err.device)
    mask = ((gd >= b0) & (gd < b0 + crop[0])).to(err.dtype).reshape(1, 1, -1, 1, 1)
    local = err[:, :, :, b1:b1 + crop[1], b2:b2 + crop[2]]
    planes = len(range(global_d)[b0:b0 + crop[0]])
    count = planes * local.shape[0] * local.shape[1] * local.shape[3] * local.shape[4]
    return (local * mask).sum() / float(count)


def global_ssim3d_loss(pred, target, crop, group, global_d, max_val=1.0, filter_size=11):
    """This rank's share of the 3-plane SSIM loss (``ops/losses.ssim3d_loss``)
    over the centre ``crop`` of the global D-sharded volume.  The window
    convolutions are VALID, so the cropped volume's windows are the whole
    volume's windows inside the crop: the D crop masks window centres by
    global index.  The (H, W) and (W, H) windows are local; the (W, D)
    windows exchange a ``filter_size // 2`` halo along D."""
    hw = filter_size // 2
    local_d = pred.shape[2]
    if local_d < hw:
        raise AssertionError(f"ssim needs a {hw}-plane halo: the local D slice {local_d} is "
                             "too thin (use fewer ranks or a larger volume)")
    p, t = pred[:, 0].to(torch.float32), target[:, 0].to(torch.float32)
    b, h, w = p.shape[0], p.shape[2], p.shape[3]
    if crop is None:
        bx0, cx, by0, cy, bz0, cz = 0, global_d, 0, h, 0, w
    else:
        (bx0, by0, bz0), (cx, cy, cz) = _crop_begin((global_d, h, w), crop)
    p, t = p[:, :, by0:by0 + cy, bz0:bz0 + cz], t[:, :, by0:by0 + cy, bz0:bz0 + cz]
    gd = _global_planes(group, local_d, p.device)
    in_x = ((gd >= bx0) & (gd < bx0 + cx)).to(torch.float32).reshape(1, -1, 1, 1)
    m1 = ssim_plane_map(p, t, max_val)
    m2 = ssim_plane_map(p.transpose(2, 3), t.transpose(2, 3), max_val)
    s12 = ((m1 * in_x).sum() + (m2 * in_x).sum()) / float(b * cx * (cy - 2 * hw)
                                                           * (cz - 2 * hw))
    p3 = halo_pad(p.permute(0, 2, 3, 1), group, hw, dim=3)
    t3 = halo_pad(t.permute(0, 2, 3, 1), group, hw, dim=3)
    m3 = ssim_plane_map(p3, t3, max_val)  # (b, cy, cz - 2hw, local_d)
    vx = ((gd >= bx0 + hw) & (gd <= bx0 + cx - 1 - hw)).to(torch.float32)
    s3 = (m3 * vx).sum() / float(b * cy * (cz - 2 * hw) * (cx - 2 * hw))
    return -(s12 + s3) / 3.0


def local_loss(out, image, target, metrics, loss_cropping, residual_indices, group, global_d):
    """This rank's share of the regression loss from its output slice
    (NCDHW), as ``train/metrics.regression_loss`` on the whole volume."""
    if metrics == "laplace":
        nc = out.shape[1] // 2
        intens, spreads = out[:, :nc], out[:, nc:]
    else:
        intens, spreads = out, None
    if residual_indices is not None:
        intens = intens + image[:, list(residual_indices)]
    if metrics == "ssim":
        return global_ssim3d_loss(intens, target, loss_cropping, group, global_d)
    if metrics == "laplace":
        bscale = 1e-5 + 0.02 * torch.exp(spreads)
        err = torch.log(2.0 * bscale) + torch.abs(intens - target) / bscale
    elif metrics == "l1":
        err = torch.abs(intens - target)
    else:
        err = torch.square(intens - target)
    return global_masked_loss(err, loss_cropping, group, global_d)


def make_halo_train_step(model, optimizer, group=None, metrics="l1", loss_cropping=None,
                         residual_indices=None, dtype=torch.float32):
    """``step(image, target, masks=None) -> (loss, new BatchNorm
    statistics)``: one D-sharded train step of ``model`` (a ``UNet3D``)
    with the torch ``optimizer`` over its parameters.  Every rank of
    ``group`` (None: one process) passes the whole (1, C, D, H, W) image and
    target, and with dropout the same keep ``masks``
    (``unet.draw_dropout_masks``); D must divide by world size ·
    2^(nb_levels - 1).  The step writes the summed
    gradients into ``.grad``, steps the optimizer (the replicas stay equal)
    and writes the new running statistics into the BatchNorm buffers; it
    returns the global loss (summed shares) and those statistics.
    ``metrics``: l1 | l2 | ssim | laplace."""
    if metrics not in METRICS:
        raise ValueError("halo-sharded training supports l1/l2/ssim/laplace metrics")
    params = [p for p in model.parameters() if p.requires_grad]
    _, n = rank_and_size(group)

    def step(image, target, masks=None):
        check_divisible(image.shape[2], n, model)
        img, tgt = local_d_slice(image, group), local_d_slice(target, group)
        out, stats = model.forward_train(img, dtype, masks, halo=group)
        loss = local_loss(out, img, tgt, metrics, loss_cropping, residual_indices, group,
                          image.shape[2])
        grads = torch.autograd.grad(loss, params)
        *grads, loss = all_reduce_sum_list([*grads, loss.detach()], group)
        for p, g in zip(params, grads):
            p.grad = g
        optimizer.step()
        optimizer.zero_grad(set_to_none=True)
        with torch.no_grad():
            for name, (mean, var) in stats.items():
                bn = getattr(model, name)
                bn.running_mean.copy_(mean)
                bn.running_var.copy_(var)
        return loss, stats

    return step
