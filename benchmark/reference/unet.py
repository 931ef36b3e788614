"""The plain SynthSR U-Net in float32 PyTorch: the reference of the
benchmark's checks.  It imports nothing of the program.

The architecture is the published one (BBillot/SynthSR ``predict_command_line.py``
through ``ext/neuron/models.unet``): ``nb_levels`` levels of
``nb_conv_per_level`` 3x3x3 SAME convs with ELU, ``nb_features * feat_mult **
level`` features; a BatchNorm (eps 1e-3) after each level, the encoder's
before its 2x max pool; the decoder upsamples (nearest, x2), concatenates
[skip, upsampled] and ends each level with BatchNorm; a linear 1x1x1 head.
``sd`` is a state dict in the ``UNet3D`` naming (OIDHW kernels).

In train mode BatchNorm normalises by the batch's float32 statistics with
the variance E[x^2] - E[x]^2 (flax's), and the max pool shares its gradient
evenly among tied maxima (as JAX's max does), so the reference's gradient is
that of the published semantics and not of ``F.max_pool3d``'s choice.

``quant``: a function applied to every conv's input and kernel (the
lower-precision control), or None.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

BN_EPS = 1e-3


def _bn(sd, name, x, train):
    w, b = sd[f"{name}.weight"], sd[f"{name}.bias"]
    if train:
        mu = x.mean((0, 2, 3, 4))
        var = torch.clamp((x * x).mean((0, 2, 3, 4)) - mu * mu, min=0.0)
    else:
        mu, var = sd[f"{name}.running_mean"], sd[f"{name}.running_var"]
    shape = (1, -1, 1, 1, 1)
    return (x - mu.reshape(shape)) * torch.rsqrt(var + BN_EPS).reshape(shape) \
        * w.reshape(shape) + b.reshape(shape)


def _conv(sd, name, x, quant):
    w, b = sd[f"{name}.weight"], sd[f"{name}.bias"]
    if quant is not None:
        x, w = quant(x), quant(w)
    return F.conv3d(x, w, b, padding=w.shape[-1] // 2)


def _pool(x):
    n, c, d, h, w = x.shape
    return x.reshape(n, c, d // 2, 2, h // 2, 2, w // 2, 2).amax(dim=(3, 5, 7))


def _up(x):
    return x.repeat_interleave(2, 2).repeat_interleave(2, 3).repeat_interleave(2, 4)


def forward(sd: dict, cfg: dict, x: torch.Tensor, train: bool = False, quant=None):
    """(N, C, D, H, W) float32 -> (N, nb_labels, D, H, W) float32."""
    nl, ncpl = cfg["nb_levels"], cfg["nb_conv_per_level"]
    taps = []
    for level in range(nl):
        if level > 0:
            x = _pool(_bn(sd, f"bn_down_{level - 1}", x, train))
        for c in range(ncpl):
            x = F.elu(_conv(sd, f"conv_downarm_{level}_{c}", x, quant))
        taps.append(x)
    x = _bn(sd, f"bn_down_{nl - 1}", x, train)
    for level in range(nl - 1):
        x = torch.cat([taps[nl - 2 - level], _up(x)], 1)
        for c in range(ncpl):
            x = F.elu(_conv(sd, f"conv_uparm_{nl + level}_{c}", x, quant))
        x = _bn(sd, f"bn_up_{level}", x, train)
    return F.conv3d(x, sd["likelihood.weight"], sd["likelihood.bias"])
