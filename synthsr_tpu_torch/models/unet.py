"""Parametric 3-D U-Net in PyTorch: the counterpart of
``synthsr_tpu/models/unet.py``, with every field of the flax module.

Same layer surface and parameter names as the flax module (``conv_downarm_{l}_{c}``,
``conv_uparm_{nl+l}_{c}``, ``expand_{down,up}_merge_{l}``, ``bn_down_{l}``,
``bn_up_{l}``, ``likelihood``), in NCDHW layout, so weights move between the
packages through ``models/weights.py``.  The wiring is the JAX module's,
with its documented deviations from the reference
(``synthsr_tpu/models/unet.py:92-189``): SAME convolutions of ``conv_size``
(odd or even, flax's low/high split of the padding) dilated by
``dilation_rate_mult ** level``; skips tap the last conv's output before
dropout, and in residual mode before the activation; the last conv of a
residual level has no activation before the add, and the level input joins
through an ``expand_*_merge`` conv only when both feature counts exceed 1
and differ (with dropout the conv arm is kept); BatchNorm eps 1e-3 and
momentum 0.99; max-pool and nearest upsampling by ``pool_size``; decoder
input ``[skip, up]`` unless ``skip_n_concatenations`` drops the skip; a
float32 1x1x1 likelihood with a linear or softmax head.

``forward`` is the plain inference composition and ``forward_train`` the
plain train-mode one (flax's ``apply(train=True, mutable=["batch_stats"])``),
both in a compute dtype (``dtype``): convs, activations and skips in it,
BatchNorm computed in float32 and rounded to it, the likelihood in the
parameters' float32, as flax with ``dtype=compute_dtype`` and float32
parameters (a float64 model computes all of it in float64).  Dropout is
feature-space (one keep mask per example and channel, scaling 1/(1 - rate))
and takes masks drawn before the forward (:func:`draw_dropout_masks`), so a
rematerialised forward applies the same ones.  ``forward`` is the reference
of the fast forward (``models/unet_cf.py``) and ``forward_train`` of the
fast train forward (``models/unet_cf_train.py``); models outside the fast
paths' gate train and run on these.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..parallel.mesh import all_reduce_mean

# predict_command_line.py:65-77 of the original, as synthsr_tpu.models.unet.synthsr_unet
SYNTHSR_CONFIG = dict(nb_features=24, nb_levels=5, conv_size=3, nb_labels=1,
                      feat_mult=2, nb_conv_per_level=2, activation="elu",
                      final_pred_activation="linear")
# every other field of the flax module, at its default
OPTION_DEFAULTS = dict(pool_size=2, skip_n_concatenations=0, layer_nb_feats=None,
                       use_batch_norm=True, conv_dropout=0.0, use_residuals=False,
                       dilation_rate_mult=1)

BN_EPS = 1e-3  # Keras BatchNormalization defaults
BN_MOMENTUM = 0.99
REMAT = (False, True, "levels")


def unet_layers(cfg: dict, in_channels: int):
    """[(name, kind, cin, cout)] in forward order, kind in {"conv", "bn",
    "likelihood"}; the single source of the architecture's shapes, the
    ``expand_*_merge`` convs of residual levels and ``layer_nb_feats``
    included.  Keys missing from ``cfg`` take the flax module's defaults."""
    cfg = {**OPTION_DEFAULTS, **cfg}
    nl, nf, fm = cfg["nb_levels"], cfg["nb_features"], cfg["feat_mult"]
    ncpl, res, bn = cfg["nb_conv_per_level"], cfg["use_residuals"], cfg["use_batch_norm"]
    lnf = list(cfg["layer_nb_feats"]) if cfg["layer_nb_feats"] is not None else None
    lfidx, layers, cin, skip_c = 0, [], in_channels, {}

    def convs(prefix, feats):
        nonlocal lfidx, cin
        for conv in range(ncpl):
            if lnf is not None:
                feats = lnf[lfidx]
                lfidx += 1
            layers.append((f"{prefix}_{conv}", "conv", cin, feats))
            cin = feats
        return feats

    def residual(name, first, feats):
        # the channels after the residual add: an expand conv when both
        # counts exceed 1 and differ, else a broadcast add (1 channel spreads)
        if not res:
            return cin
        if first > 1 and cin > 1 and first != cin:
            layers.append((name, "conv", first, feats))
            return cin
        return max(first, cin)

    for level in range(nl):
        first = cin
        feats = convs(f"conv_downarm_{level}", int(round(nf * fm ** level)))
        skip_c[level] = cin
        cin = residual(f"expand_down_merge_{level}", first, feats)
        if bn:
            layers.append((f"bn_down_{level}", "bn", cin, cin))
    for level in range(nl - 1):
        src = nl - 2 - level
        up = cin
        if level < nl - cfg["skip_n_concatenations"] - 1:
            cin = skip_c[src] + cin  # [skip, up]
        feats = convs(f"conv_uparm_{nl + level}", int(round(nf * fm ** src)))
        cin = residual(f"expand_up_merge_{level}", up, feats)
        if bn:
            layers.append((f"bn_up_{level}", "bn", cin, cin))
    layers.append(("likelihood", "likelihood", cin, cfg["nb_labels"]))
    return layers


def conv_level(name: str, nb_levels: int) -> int:
    """The level whose dilation conv ``name`` takes: its encoder level, or for
    a decoder conv the encoder level it mirrors."""
    p = name.split("_")
    if p[0] == "conv":
        level = int(p[2])
        return level if p[1] == "downarm" else 2 * nb_levels - 2 - level
    level = int(p[3])  # expand_{down,up}_merge_{level}
    return level if p[1] == "down" else nb_levels - 2 - level


def upsample2(x: torch.Tensor, factor: int = 2) -> torch.Tensor:
    """Nearest-neighbour x``factor`` upsampling of the last three axes, as one
    broadcast + reshape (Keras UpSampling3D)."""
    *lead, d, h, w = x.shape
    f = factor
    return x[..., :, None, :, None, :, None].expand(*lead, d, f, h, f, w, f) \
        .reshape(*lead, f * d, f * h, f * w)


def same_conv3d(x, w, b, dilation: int = 1):
    """flax's SAME convolution, stride 1: the dilated kernel's padding
    ``dilation·(k - 1)`` split low ``total // 2``, high the rest (even
    kernels pad one more voxel at the high end)."""
    total = dilation * (w.shape[2] - 1)
    lo = total // 2
    if total - lo == lo:
        return F.conv3d(x, w, b, padding=lo, dilation=dilation)
    return F.conv3d(F.pad(x, (lo, total - lo) * 3), w, b, dilation=dilation)


def bn_batch_stats(xs, dims, group=None):
    """Float32 (or wider) batch statistics as flax's BatchNorm takes them in train mode:
    the mean over ``dims`` of each tensor in ``xs`` (the examples), averaged
    over ``xs`` and then over the ranks of ``group`` (the data-parallel
    group, JAX's ``bn_axis`` pmean), and the fast variance
    ``max(0, E[x²] - E[x]²)`` (unet_cf_train.py:121-141).  torch's own
    train-mode BatchNorm uses the two-pass variance and an unbiased running
    update, and would drift."""
    n = len(xs)
    acc = torch.promote_types(xs[0].dtype, torch.float32)
    mu = sum(x.to(acc).mean(dims) for x in xs) / n
    mu2 = sum(torch.square(x.to(acc)).mean(dims) for x in xs) / n
    if group is not None:
        mu, mu2 = all_reduce_mean(torch.stack([mu, mu2]), group).unbind(0)
    return mu, torch.clamp(mu2 - torch.square(mu), min=0.0)


def bn_running_update(bn, mu, var):
    """The new (running_mean, running_var), momentum 0.99, no gradient."""
    return (BN_MOMENTUM * bn.running_mean + (1.0 - BN_MOMENTUM) * mu.detach(),
            BN_MOMENTUM * bn.running_var + (1.0 - BN_MOMENTUM) * var.detach())


def check_poolable(shape, nb_levels: int, pool_size: int = 2):
    """Every spatial size must divide by ``pool_size`` nb_levels - 1 times
    (predict pads to a multiple of 32), which also makes the net exactly
    flip-equivariant."""
    m = pool_size ** (nb_levels - 1)
    if any(s % m for s in shape):
        raise ValueError(f"spatial shape {tuple(shape)} must be a multiple of {m}")


def run_stage(stage, *inputs):
    """``stage(*inputs) -> (outputs, stats)`` called as it is."""
    return stage(*inputs)


def checkpoint_stage(stage, *inputs):
    """``stage(*inputs) -> (outputs, stats)`` under
    ``torch.utils.checkpoint(use_reentrant=False)``: only ``inputs`` are kept
    for the backward pass, which runs the stage again.  ``outputs`` is a
    tuple of tensors and ``stats`` {BatchNorm name: (new running mean, new
    running var)}; both come from this first call, not the recomputation."""
    meta = {}

    def flat(*xs):
        outs, stats = stage(*xs)
        meta["n"], meta["names"] = len(outs), list(stats)
        return (*outs, *(t for name in stats for t in stats[name]))

    res = checkpoint(flat, *inputs, use_reentrant=False)
    n = meta["n"]
    rest = res[n:]
    return tuple(res[:n]), {name: (rest[2 * i], rest[2 * i + 1])
                            for i, name in enumerate(meta["names"])}


def check_remat(remat):
    if remat is None:
        return False
    if remat not in REMAT:
        raise ValueError(f"remat must be False, True or 'levels', got {remat!r}")
    return remat


class UNet3D(nn.Module):
    """3-D U-Net matching the reference parameter surface (models.py:26-47 of
    the original's neuron package) and the flax module's fields."""

    def __init__(self, in_channels: int = 1, nb_features: int = 24, nb_levels: int = 5,
                 conv_size: int = 3, nb_labels: int = 1, feat_mult: float = 2,
                 pool_size: int = 2, nb_conv_per_level: int = 2, activation: str = "elu",
                 final_pred_activation: str = "linear", skip_n_concatenations: int = 0,
                 layer_nb_feats=None, use_batch_norm: bool = True, conv_dropout: float = 0.0,
                 use_residuals: bool = False, dilation_rate_mult: int = 1):
        super().__init__()
        if activation not in ("elu", "relu"):
            raise ValueError(f"unsupported activation {activation!r}")
        if final_pred_activation not in ("linear", "softmax"):
            raise ValueError(f"unsupported final activation {final_pred_activation!r}")
        self.config = dict(nb_features=nb_features, nb_levels=nb_levels,
                           conv_size=conv_size, nb_labels=nb_labels,
                           feat_mult=feat_mult, nb_conv_per_level=nb_conv_per_level,
                           activation=activation,
                           final_pred_activation=final_pred_activation,
                           pool_size=pool_size, skip_n_concatenations=skip_n_concatenations,
                           layer_nb_feats=None if layer_nb_feats is None
                           else [int(f) for f in layer_nb_feats],
                           use_batch_norm=bool(use_batch_norm),
                           conv_dropout=float(conv_dropout), use_residuals=bool(use_residuals),
                           dilation_rate_mult=int(dilation_rate_mult))
        self.in_channels = in_channels
        for name, kind, cin, cout in unet_layers(self.config, in_channels):
            if kind == "conv":
                dil = dilation_rate_mult ** conv_level(name, nb_levels)
                self.add_module(name, nn.Conv3d(cin, cout, conv_size, padding="same",
                                                dilation=dil))
            elif kind == "bn":
                self.add_module(name, nn.BatchNorm3d(cout, eps=BN_EPS, momentum=0.01))
            else:
                self.add_module(name, nn.Conv3d(cin, cout, 1))

    @property
    def nb_levels(self) -> int:
        return self.config["nb_levels"]

    @property
    def nb_conv_per_level(self) -> int:
        return self.config["nb_conv_per_level"]

    def _act(self, x):
        return F.elu(x) if self.config["activation"] == "elu" else F.relu(x)

    def _conv(self, name, x):
        mod = getattr(self, name)
        return same_conv3d(x, mod.weight.to(x.dtype), mod.bias.to(x.dtype), mod.dilation[0])

    def _norm(self, name, x, train, group, stats):
        """BatchNorm ``name`` in float32, rounded to ``x.dtype``: batch
        statistics (over ``group`` too) with their running update into
        ``stats`` in train mode, the running ones otherwise."""
        if not self.config["use_batch_norm"]:
            return x
        bn = getattr(self, name)
        xf = x.to(torch.promote_types(x.dtype, torch.float32))
        if not train:
            return F.batch_norm(xf, bn.running_mean, bn.running_var, bn.weight, bn.bias,
                                training=False, eps=bn.eps).to(x.dtype)
        mu, var = bn_batch_stats([xf], (0, 2, 3, 4), group)
        stats[name] = bn_running_update(bn, mu, var)
        shape = (1, -1, 1, 1, 1)
        return ((xf - mu.reshape(shape)) * torch.rsqrt(var + bn.eps).reshape(shape)
                * bn.weight.reshape(shape) + bn.bias.reshape(shape)).to(x.dtype)

    def _dropout(self, name, x, masks):
        """Feature-space dropout after conv ``name``: flax's
        ``select(keep, x / keep_prob, 0)`` with ``masks[name]``, a (B, C) bool
        keep mask; the identity when ``masks`` is None (inference)."""
        if masks is None or not self.config["conv_dropout"]:
            return x
        keep = masks[name][:, :, None, None, None]
        return torch.where(keep, x / (1.0 - self.config["conv_dropout"]),
                           torch.zeros((), dtype=x.dtype, device=x.device))

    def _level_convs(self, prefix, x, masks):
        """One level's conv stack: (the skip tap, the output)."""
        res, ncpl = self.config["use_residuals"], self.nb_conv_per_level
        tap = None
        for conv in range(ncpl):
            last = conv == ncpl - 1
            x = self._conv(f"{prefix}_{conv}", x)
            if not (res and last):
                x = self._act(x)
            if last:
                tap = x
            x = self._dropout(f"{prefix}_{conv}", x, masks)
        return tap, x

    def _residual(self, name, x, first):
        """The residual add with ``first`` (through conv ``name`` when the
        model has it), then the activation."""
        if not self.config["use_residuals"]:
            return x
        add = self._act(self._conv(name, first)) if hasattr(self, name) else first
        return self._act(x + add)

    def _encoder_stage(self, level, train, masks, group):
        pool = self.config["pool_size"]

        def stage(x):
            stats = {}
            if level > 0:
                x = self._norm(f"bn_down_{level - 1}", x, train, group, stats)
                x = F.max_pool3d(x, pool)
            tap, out = self._level_convs(f"conv_downarm_{level}", x, masks)
            return (tap, self._residual(f"expand_down_merge_{level}", out, x)), stats

        return stage

    def _decoder_stage(self, level, train, masks, group):
        nl = self.nb_levels

        def stage(x, *skip):
            stats = {}
            if level == 0:
                x = self._norm(f"bn_down_{nl - 1}", x, train, group, stats)
            x = upsample2(x, self.config["pool_size"])
            up = x
            if skip:
                x = torch.cat([skip[0].to(x.dtype), x], 1)
            _, x = self._level_convs(f"conv_uparm_{nl + level}", x, masks)
            x = self._residual(f"expand_up_merge_{level}", x, up)
            return (self._norm(f"bn_up_{level}", x, train, group, stats),), stats

        return stage

    def _body(self, x, train, masks, group, levels_remat):
        """The net on (N, C, D, H, W) in ``x.dtype``: (float32 output, stats).
        With ``levels_remat`` each level runs as one checkpointed stage whose
        inputs are the level boundaries (the skip taps and the decoder
        levels' outputs, JAX's ``unet_skip_{l}`` and ``unet_dec_{l}``)."""
        nl = self.nb_levels
        call = checkpoint_stage if levels_remat else run_stage
        stats, taps = {}, []
        for level in range(nl):
            (tap, x), st = call(self._encoder_stage(level, train, masks, group), x)
            taps.append(tap)
            stats.update(st)
        if nl == 1:
            x = self._norm("bn_down_0", x, train, group, stats)
        for level in range(nl - 1):
            concat = level < nl - self.config["skip_n_concatenations"] - 1
            skip = (taps[nl - 2 - level],) if concat else ()
            (x,), st = call(self._decoder_stage(level, train, masks, group), x, *skip)
            stats.update(st)
        lik = self.likelihood
        x = F.conv3d(x.to(lik.weight.dtype), lik.weight, lik.bias)
        if self.config["final_pred_activation"] == "softmax":
            x = torch.softmax(x, dim=1)
        return x, stats

    def forward_train(self, x: torch.Tensor, dtype: torch.dtype = torch.float32, masks=None,
                      group=None, remat=False):
        """Train mode: (N, C, D, H, W) -> ((N, nb_labels, D, H, W) float32,
        {bn name: (new running_mean, new running_var)}).  BatchNorm normalises
        with the batch's statistics (averaged over the ranks of ``group``);
        the module's buffers are not written.  ``masks``: the dropout keep
        masks of :func:`draw_dropout_masks` (required when the model has
        dropout).  ``remat``: False, True (the whole net is recomputed in the
        backward pass) or "levels" (one level at a time)."""
        check_poolable(x.shape[2:], self.nb_levels, self.config["pool_size"])
        if self.config["conv_dropout"] and masks is None:
            raise ValueError("a model with dropout trains on pre-drawn masks "
                             "(draw_dropout_masks)")
        remat = check_remat(remat)
        x = x.to(dtype)
        if remat is True:
            def whole(t):
                out, stats = self._body(t, True, masks, group, False)
                return (out,), stats

            (out,), stats = checkpoint_stage(whole, x)
            return out, stats
        return self._body(x, True, masks, group, remat == "levels")

    def forward(self, x: torch.Tensor, dtype: torch.dtype = torch.float32) -> torch.Tensor:
        """(N, C, D, H, W) -> (N, nb_labels, D, H, W), float32, inference."""
        check_poolable(x.shape[2:], self.nb_levels, self.config["pool_size"])
        return self._body(x.to(dtype), False, None, None, False)[0]


def dropout_sites(model: UNet3D):
    """[(conv name, channels)] of the dropout layers in forward order (one
    after every conv of the encoder and decoder stacks); [] without dropout."""
    if not model.config["conv_dropout"]:
        return []
    return [(name, cout) for name, kind, _, cout in unet_layers(model.config, model.in_channels)
            if kind == "conv" and name.startswith(("conv_downarm", "conv_uparm"))]


def draw_dropout_masks(model: UNet3D, gens):
    """The keep masks of one train forward: {conv name: (B, C) bool}, example
    i's drawn from ``gens[i]`` (``uniform < 1 - rate``, as
    ``jax.random.bernoulli``), one per channel; None without dropout."""
    sites = dropout_sites(model)
    if not sites:
        return None
    keep = 1.0 - model.config["conv_dropout"]
    per_example = [{name: torch.rand((c,), generator=g, device=g.device) < keep
                    for name, c in sites} for g in gens]
    return {name: torch.stack([m[name] for m in per_example]) for name, _ in sites}


def synthsr_unet(nb_channels: int = 1, **overrides) -> UNet3D:
    """The shipped SynthSR all-purpose architecture; ``nb_channels`` is the
    input channel count (2 for Hyperfine)."""
    cfg = dict(SYNTHSR_CONFIG)
    cfg.update(overrides)
    return UNet3D(in_channels=nb_channels, **cfg)
