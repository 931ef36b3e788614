"""Parametric 3-D U-Net in PyTorch: the counterpart of
``synthsr_tpu/models/unet.py``.

Same layer surface and parameter names as the flax module (``conv_downarm_{l}_{c}``,
``conv_uparm_{nl+l}_{c}``, ``bn_down_{l}``, ``bn_up_{l}``, ``likelihood``), in
NCDHW layout, so weights move between the packages through
``models/weights.py``.  ``forward`` is the plain float32 inference composition
(tests/test_unet.py:147-166): skips tap the pre-BN conv output, BatchNorm uses
eps 1e-3, max-pool 2, nearest x2 upsampling, decoder input ``[skip, up]``,
linear or softmax head.  It is the reference for the fast forward
(``models/unet_cf.py``), which serves.

Only the options of the shipped configuration exist here; residual levels,
dilation, dropout and ``layer_nb_feats`` wait for the training port.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

# predict_command_line.py:65-77 of the original, as synthsr_tpu.models.unet.synthsr_unet
SYNTHSR_CONFIG = dict(nb_features=24, nb_levels=5, conv_size=3, nb_labels=1,
                      feat_mult=2, nb_conv_per_level=2, activation="elu",
                      final_pred_activation="linear")

BN_EPS = 1e-3  # Keras BatchNormalization default


def unet_layers(cfg: dict, in_channels: int):
    """[(name, kind, cin, cout)] in forward order, kind in {"conv", "bn",
    "likelihood"}; the single source of the architecture's shapes."""
    nl, nf, fm = cfg["nb_levels"], cfg["nb_features"], cfg["feat_mult"]
    ncpl = cfg["nb_conv_per_level"]
    feats = [int(round(nf * fm ** level)) for level in range(nl)]
    layers, cin = [], in_channels
    for level in range(nl):
        for conv in range(ncpl):
            layers.append((f"conv_downarm_{level}_{conv}", "conv", cin, feats[level]))
            cin = feats[level]
        layers.append((f"bn_down_{level}", "bn", cin, cin))
    for level in range(nl - 1):
        src = nl - 2 - level
        cin = feats[src] + cin  # [skip, up]
        for conv in range(ncpl):
            layers.append((f"conv_uparm_{nl + level}_{conv}", "conv", cin, feats[src]))
            cin = feats[src]
        layers.append((f"bn_up_{level}", "bn", cin, cin))
    layers.append(("likelihood", "likelihood", cin, cfg["nb_labels"]))
    return layers


def upsample2(x: torch.Tensor) -> torch.Tensor:
    """Nearest-neighbour x2 upsampling of the last three axes, as one
    broadcast + reshape (Keras UpSampling3D)."""
    *lead, d, h, w = x.shape
    return x[..., :, None, :, None, :, None].expand(*lead, d, 2, h, 2, w, 2) \
        .reshape(*lead, 2 * d, 2 * h, 2 * w)


def check_poolable(shape, nb_levels: int):
    """Every spatial size must halve evenly nb_levels - 1 times (predict pads
    to a multiple of 32), which also makes the net exactly flip-equivariant."""
    m = 2 ** (nb_levels - 1)
    if any(s % m for s in shape):
        raise ValueError(f"spatial shape {tuple(shape)} must be a multiple of {m}")


class UNet3D(nn.Module):
    """3-D U-Net matching the reference parameter surface (models.py:26-47 of
    the original's neuron package)."""

    def __init__(self, in_channels: int = 1, nb_features: int = 24, nb_levels: int = 5,
                 conv_size: int = 3, nb_labels: int = 1, feat_mult: float = 2,
                 nb_conv_per_level: int = 2, activation: str = "elu",
                 final_pred_activation: str = "linear", use_residuals: bool = False,
                 dilation_rate_mult: int = 1, conv_dropout: float = 0.0):
        super().__init__()
        if use_residuals or dilation_rate_mult != 1 or conv_dropout:
            raise NotImplementedError(
                "residual levels, dilation and dropout are not ported yet")
        if conv_size != 3:
            raise NotImplementedError("only 3x3x3 convolutions are ported")
        if activation not in ("elu", "relu"):
            raise ValueError(f"unsupported activation {activation!r}")
        if final_pred_activation not in ("linear", "softmax"):
            raise ValueError(f"unsupported final activation {final_pred_activation!r}")
        self.config = dict(nb_features=nb_features, nb_levels=nb_levels,
                           conv_size=conv_size, nb_labels=nb_labels,
                           feat_mult=feat_mult, nb_conv_per_level=nb_conv_per_level,
                           activation=activation,
                           final_pred_activation=final_pred_activation)
        self.in_channels = in_channels
        for name, kind, cin, cout in unet_layers(self.config, in_channels):
            if kind == "conv":
                self.add_module(name, nn.Conv3d(cin, cout, 3, padding=1))
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

    def _bn(self, name, x):
        bn = getattr(self, name)
        return F.batch_norm(x, bn.running_mean, bn.running_var, bn.weight, bn.bias,
                            training=False, eps=bn.eps)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(N, C, D, H, W) -> (N, nb_labels, D, H, W), float32, inference."""
        check_poolable(x.shape[2:], self.nb_levels)
        nl, ncpl = self.nb_levels, self.nb_conv_per_level
        x = x.to(torch.float32)
        skips = []
        for level in range(nl):
            for conv in range(ncpl):
                x = self._act(getattr(self, f"conv_downarm_{level}_{conv}")(x))
            skips.append(x)  # skips tap the conv output, before BatchNorm
            x = self._bn(f"bn_down_{level}", x)
            if level < nl - 1:
                x = F.max_pool3d(x, 2)
        for level in range(nl - 1):
            x = torch.cat([skips[nl - 2 - level], upsample2(x)], 1)
            for conv in range(ncpl):
                x = self._act(getattr(self, f"conv_uparm_{nl + level}_{conv}")(x))
            x = self._bn(f"bn_up_{level}", x)
        x = self.likelihood(x)
        if self.config["final_pred_activation"] == "softmax":
            x = torch.softmax(x, dim=1)
        return x


def synthsr_unet(nb_channels: int = 1, **overrides) -> UNet3D:
    """The shipped SynthSR all-purpose architecture; ``nb_channels`` is the
    input channel count (2 for Hyperfine)."""
    cfg = dict(SYNTHSR_CONFIG)
    cfg.update(overrides)
    return UNet3D(in_channels=nb_channels, **cfg)
