"""Fast channels-first TRAINING forward of the SynthSR U-Net: the port of
``make_fast_train_apply`` in ``synthsr_tpu/models/unet_cf_train.py``.

Every 3³ conv, at every level, goes through the differentiable
:func:`~synthsr_tpu_torch.ops.conv_train.conv3d_cf_train`: on a card one
forward + backward of the shipped net in bf16 is 18 H-fwd-mma forward
launches, 17 H-fwd-mma input-gradient launches (the first conv's input needs
none) and 22 H-wgrad-mma launches (18 convs, plus one per second decoder
source); in float32 the same counts on H-fwd-x3 and H-wgrad-x3.  Convs run per
example (the kernels are batch-free); BatchNorm runs batch-synchronously over
the examples with flax's train-mode math (float32 fast-variance batch
statistics, momentum 0.99, eps 1e-3; :func:`~.unet.bn_batch_stats`), and
under a data-parallel ``group`` over the ranks' examples too (JAX's
``bn_axis`` pmean).

- :func:`can_fast_train` is the JAX gate: a model outside it trains on the
  plain ``UNet3D.forward_train`` (cuDNN on a card), as JAX trains on
  ``model.apply``.
- ``remat`` recomputes the forward in the backward pass through
  ``torch.utils.checkpoint``: ``True`` the whole net, ``"levels"`` one level
  at a time, keeping only the level boundaries JAX tags (``unet_skip_{l}``,
  the skip taps, and ``unet_dec_{l}``, the decoder levels' outputs).  The
  recomputation launches the forward kernels again.
- Max pooling is the reshape-max form with ``torch.amax``, whose gradient,
  like JAX's max, is split evenly among tied maxima (``F.max_pool3d`` gives it
  all to one element, and ties are common in bf16).
- The likelihood is an unfused float32 1×1×1 product, as in flax.
- Dropped from the JAX module: the channels-last switching at the levels the
  TPU kernels did not cover (unet_cf_train.py:100-119, :196-203).
"""

from __future__ import annotations

import torch

from ..ops.conv_train import conv3d_cf_train
from .unet import (UNet3D, bn_batch_stats, bn_running_update, check_poolable, check_remat,
                   checkpoint_stage, run_stage, upsample2)


def can_fast_train(model: UNet3D) -> bool:
    """True when the model's options are covered by the fast train forward
    (every shipped SynthSR config is); ``unet_cf_train.py:42-49``."""
    cfg = model.config
    return (cfg["conv_dropout"] == 0.0 and not cfg["use_residuals"]
            and cfg["dilation_rate_mult"] == 1 and cfg["pool_size"] == 2
            and cfg["layer_nb_feats"] is None and cfg["use_batch_norm"]
            and cfg["conv_size"] == 3
            and cfg["activation"] in ("elu", "relu"))


def _pool(x):
    c, d, h, w = x.shape
    return x.reshape(c, d // 2, 2, h // 2, 2, w // 2, 2).amax(dim=(2, 4, 6))


def _bn(bn, xs, dt, stats, name, group):
    mu, var = bn_batch_stats(xs, (1, 2, 3), group)
    stats[name] = bn_running_update(bn, mu, var)
    mul = (torch.rsqrt(var + bn.eps) * bn.weight).reshape(-1, 1, 1, 1)
    m4, a4 = mu.reshape(-1, 1, 1, 1), bn.bias.reshape(-1, 1, 1, 1)
    return [((x.to(torch.float32) - m4) * mul + a4).to(dt) for x in xs]


def fast_train_forward(model: UNet3D, x: torch.Tensor, dtype: torch.dtype = torch.bfloat16,
                       group=None, remat=False):
    """Train-mode forward (B, C, D, H, W) -> ((B, nb_labels, D, H, W) float32,
    {bn name: (new running_mean, new running_var)}), differentiable in the
    model's parameters; the model's buffers are not written.  ``group``: the
    data-parallel process group whose ranks' examples BatchNorm's statistics
    cover.  ``remat``: False, True or "levels" (module docstring)."""
    if x.dim() != 5:
        raise ValueError(f"expected a (B, C, D, H, W) input, got {tuple(x.shape)}")
    if not can_fast_train(model):
        raise ValueError("model options outside the fast train path (can_fast_train)")
    nl, ncpl = model.nb_levels, model.nb_conv_per_level
    check_poolable(x.shape[2:], nl)
    remat = check_remat(remat)
    act = model.config["activation"]
    b = x.shape[0]

    def conv(name, srcs_per_example):
        mod = getattr(model, name)
        w = mod.weight.permute(2, 3, 4, 1, 0)  # OIDHW -> DHWIO, a view
        return [conv3d_cf_train(srcs, w, mod.bias, act) for srcs in srcs_per_example]

    def encoder(level):
        # unet_skip_{level}: the input is the previous level's skip tap
        def stage(*xs):
            stats = {}
            if level > 0:
                name = f"bn_down_{level - 1}"
                xs = [_pool(xi) for xi in _bn(getattr(model, name), xs, dtype, stats, name,
                                              group)]
            for c in range(ncpl):
                xs = conv(f"conv_downarm_{level}_{c}", [(xi,) for xi in xs])
            return tuple(xs), stats  # skips tap the conv output, before BatchNorm

        return stage

    def decoder(level):
        # unet_dec_{level}: the input is the previous decoder level's output
        # (the last skip tap for level 0) and this level's skip tap
        def stage(*ts):
            xs, skip, stats = list(ts[:b]), ts[b:], {}
            if level == 0:
                name = f"bn_down_{nl - 1}"
                xs = _bn(getattr(model, name), xs, dtype, stats, name, group)
            ups = [upsample2(xi) for xi in xs]
            srcs = [(s, u) for s, u in zip(skip, ups)] if skip else [(u,) for u in ups]
            for c in range(ncpl):
                xs = conv(f"conv_uparm_{nl + level}_{c}", srcs if c == 0 else [(xi,) for xi in xs])
            name = f"bn_up_{level}"
            return tuple(_bn(getattr(model, name), xs, dtype, stats, name, group)), stats

        return stage

    def body(xs, call):
        stats, taps = {}, []
        for level in range(nl):
            xs, st = call(encoder(level), *xs)
            taps.append(xs)
            stats.update(st)
        if nl == 1:
            xs = _bn(model.bn_down_0, list(xs), dtype, stats, "bn_down_0", group)
        for level in range(nl - 1):
            concat = level < nl - model.config["skip_n_concatenations"] - 1
            skip = taps[nl - 2 - level] if concat else ()
            xs, st = call(decoder(level), *xs, *skip)
            stats.update(st)
        lik = model.likelihood
        k = lik.weight.reshape(lik.weight.shape[0], -1)  # (nb_labels, C)
        outs = [(k @ xi.to(torch.float32).reshape(xi.shape[0], -1)).reshape(-1, *xi.shape[1:])
                + lik.bias.reshape(-1, 1, 1, 1) for xi in xs]
        out = torch.stack(outs)
        if model.config["final_pred_activation"] == "softmax":
            out = torch.softmax(out, dim=1)
        return out, stats

    xs = [x[i].to(dtype).contiguous() for i in range(b)]
    if remat is True:
        def whole(*t):
            out, stats = body(list(t), run_stage)
            return (out,), stats

        (out,), stats = checkpoint_stage(whole, *xs)
        return out, stats
    return body(xs, checkpoint_stage if remat == "levels" else run_stage)
