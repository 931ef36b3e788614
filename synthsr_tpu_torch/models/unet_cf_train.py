"""Fast channels-first TRAINING forward of the SynthSR U-Net: the port of
``make_fast_train_apply`` in ``synthsr_tpu/models/unet_cf_train.py``.

Every 3³ conv, at every level, goes through the differentiable
:func:`~synthsr_tpu_torch.ops.conv_train.conv3d_cf_train`: on a card one
forward + backward of the shipped net is 18 H-fwd forward launches, 17 H-fwd
input-gradient launches (the first conv's input needs none) and 22 H-wgrad
launches (18 convs, plus one per second decoder source).  Convs run per
example (the kernels are batch-free); BatchNorm runs batch-synchronously over
the examples with flax's train-mode math (float32 fast-variance batch
statistics, momentum 0.99, eps 1e-3; :func:`~.unet.bn_batch_stats`).

- Max pooling is the reshape-max form with ``torch.amax``, whose gradient,
  like JAX's max, is split evenly among tied maxima (``F.max_pool3d`` gives it
  all to one element, and ties are common in bf16).
- The likelihood is an unfused float32 1×1×1 product, as in flax.
- Dropped from the JAX module: the channels-last switching at the levels the
  TPU kernels did not cover (unet_cf_train.py:100-119, :196-203) and the
  ``checkpoint_name`` tags (remat is not ported).
"""

from __future__ import annotations

import torch

from ..ops.conv_train import conv3d_cf_train
from .unet import UNet3D, bn_batch_stats, bn_running_update, check_poolable, upsample2


def _pool(x):
    c, d, h, w = x.shape
    return x.reshape(c, d // 2, 2, h // 2, 2, w // 2, 2).amax(dim=(2, 4, 6))


def _bn(bn, xs, dt, new_stats, name):
    mu, var = bn_batch_stats(xs, (1, 2, 3))
    new_stats[name] = bn_running_update(bn, mu, var)
    mul = (torch.rsqrt(var + bn.eps) * bn.weight).reshape(-1, 1, 1, 1)
    m4, a4 = mu.reshape(-1, 1, 1, 1), bn.bias.reshape(-1, 1, 1, 1)
    return [((x.to(torch.float32) - m4) * mul + a4).to(dt) for x in xs]


def fast_train_forward(model: UNet3D, x: torch.Tensor, dtype: torch.dtype = torch.bfloat16):
    """Train-mode forward (B, C, D, H, W) -> ((B, nb_labels, D, H, W) float32,
    {bn name: (new running_mean, new running_var)}), differentiable in the
    model's parameters; the model's buffers are not written."""
    if x.dim() != 5:
        raise ValueError(f"expected a (B, C, D, H, W) input, got {tuple(x.shape)}")
    nl, ncpl = model.nb_levels, model.nb_conv_per_level
    check_poolable(x.shape[2:], nl)
    act = model.config["activation"]
    new_stats = {}

    def conv(name, srcs_per_example):
        mod = getattr(model, name)
        w = mod.weight.permute(2, 3, 4, 1, 0)  # OIDHW -> DHWIO, a view
        return [conv3d_cf_train(srcs, w, mod.bias, act) for srcs in srcs_per_example]

    xs = [x[i].to(dtype).contiguous() for i in range(x.shape[0])]
    skips = []
    for level in range(nl):
        for c in range(ncpl):
            xs = conv(f"conv_downarm_{level}_{c}", [(xi,) for xi in xs])
        skips.append(xs)  # skips tap the conv output, before BatchNorm
        xs = _bn(getattr(model, f"bn_down_{level}"), xs, dtype, new_stats, f"bn_down_{level}")
        if level < nl - 1:
            xs = [_pool(xi) for xi in xs]
    for level in range(nl - 1):
        skip = skips[nl - 2 - level]
        srcs = [(s, upsample2(xi)) for s, xi in zip(skip, xs)]
        for c in range(ncpl):
            xs = conv(f"conv_uparm_{nl + level}_{c}", srcs if c == 0 else [(xi,) for xi in xs])
        xs = _bn(getattr(model, f"bn_up_{level}"), xs, dtype, new_stats, f"bn_up_{level}")
    lik = model.likelihood
    k = lik.weight.reshape(lik.weight.shape[0], -1)  # (nb_labels, C)
    outs = [(k @ xi.to(torch.float32).reshape(xi.shape[0], -1)).reshape(-1, *xi.shape[1:])
            + lik.bias.reshape(-1, 1, 1, 1) for xi in xs]
    out = torch.stack(outs)
    if model.config["final_pred_activation"] == "softmax":
        out = torch.softmax(out, dim=1)
    return out, new_stats
