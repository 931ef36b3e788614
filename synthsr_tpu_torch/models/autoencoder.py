"""The auto-encoder family and the per-voxel bias layer: the port of
``synthsr_tpu/models/autoencoder.py`` (the reference's ``ext/neuron``
extras: ``ae`` models.py:148, ``single_ae`` :558, ``_VAESample`` :760 and
``LocalBias`` layers.py:405-434), in NCDHW.

The parameter names are the flax module's (``conv_downarm_{l}_{c}``,
``single_ae.{mu_enc, logvar_enc, ae_mu_dec}`` or
``single_ae.{mu_enc_conv, logvar_enc_conv, ae_dec_conv}``,
``conv_uparm_{nl+l}_{c}``, ``likelihood``), so ``models/weights.py``
(``ae_variables_to_state_dict``) moves weights between the packages.  Flax
flattens the dense bottleneck's input channels-last; here it is flattened
NCDHW, and the bridge reorders the dense layers' rows to match.  The VAE's
noise is drawn from an explicit ``torch.Generator`` or passed in as ``eps``
(so the tests can feed JAX's draw).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from .unet import same_conv3d, upsample2


class LocalBias(nn.Module):
    """Per-voxel additive bias: out[v] = in[v] + b[v]·biasmult; ``shape`` is
    the input's shape without the batch axis, (C, D, H, W).  The bias starts
    as N(0, 0.05²), drawn from ``generator`` when given."""

    def __init__(self, shape, biasmult: float = 1.0, generator=None):
        super().__init__()
        self.biasmult = biasmult
        self.kernel = nn.Parameter(torch.randn(tuple(shape), generator=generator) * 0.05)

    def forward(self, x):
        return x + self.kernel * self.biasmult


def vae_sample(mu, logvar, generator=None, eps=None):
    """z = mu + exp(logvar / 2)·eps (reference _VAESample, models.py:760-768);
    ``eps`` ~ N(0, 1) is drawn from ``generator`` unless given."""
    if eps is None:
        eps = torch.randn(mu.shape, generator=generator, dtype=mu.dtype, device=mu.device)
    return mu + torch.exp(logvar / 2.0) * eps.to(mu.dtype)


class SingleAE(nn.Module):
    """Bottleneck stage: a dense or a conv encoding of the (C, D, H, W)
    feature map ``shape``, optionally variational (models.py:558-757).
    ``forward`` returns (out, mu, logvar or None)."""

    def __init__(self, shape, enc_size, ae_type: str = "conv", conv_size: int = 3,
                 do_vae: bool = False):
        super().__init__()
        if ae_type not in ("conv", "dense"):
            raise ValueError(f"ae_type should be 'conv' or 'dense', got {ae_type!r}")
        self.ae_type, self.do_vae = ae_type, do_vae
        nc = shape[0]
        if ae_type == "dense":
            flat, enc = math.prod(shape), math.prod(enc_size)
            self.mu_enc = nn.Linear(flat, enc)
            if do_vae:
                self.logvar_enc = nn.Linear(flat, enc)
            self.ae_mu_dec = nn.Linear(enc, flat)
        else:
            self.mu_enc_conv = nn.Conv3d(nc, enc_size[-1], conv_size)
            if do_vae:
                self.logvar_enc_conv = nn.Conv3d(nc, enc_size[-1], conv_size)
            self.ae_dec_conv = nn.Conv3d(enc_size[-1], nc, conv_size)

    @staticmethod
    def _conv(mod, x):
        return same_conv3d(x, mod.weight.to(x.dtype), mod.bias.to(x.dtype))

    @staticmethod
    def _dense(mod, x):
        return F.linear(x, mod.weight.to(x.dtype), mod.bias.to(x.dtype))

    def forward(self, x, generator=None, eps=None):
        logvar = None
        if self.ae_type == "dense":
            flat = x.reshape(x.shape[0], -1)
            mu = self._dense(self.mu_enc, flat)
            if self.do_vae:
                logvar = self._dense(self.logvar_enc, flat)
            z = vae_sample(mu, logvar, generator, eps) if self.do_vae else mu
            return self._dense(self.ae_mu_dec, z).reshape(x.shape), mu, logvar
        mu = self._conv(self.mu_enc_conv, x)
        if self.do_vae:
            logvar = self._conv(self.logvar_enc_conv, x)
        z = vae_sample(mu, logvar, generator, eps) if self.do_vae else mu
        return self._conv(self.ae_dec_conv, z), mu, logvar


class AutoEncoder3D(nn.Module):
    """Convolutional auto-encoder, optionally variational (models.py:148-253):
    the U-Net's encoder, a dense or conv bottleneck, a decoder WITHOUT skips
    and a float32 1x1x1 likelihood (softmax or linear).  ``input_shape``
    (D, H, W) sizes the dense bottleneck; it is needed only then."""

    def __init__(self, in_channels: int = 1, input_shape=None, nb_features: int = 16,
                 nb_levels: int = 3, conv_size: int = 3, nb_labels: int = 1, enc_size=(16,),
                 feat_mult: float = 2, pool_size: int = 2, nb_conv_per_level: int = 1,
                 activation: str = "elu", final_pred_activation: str = "softmax",
                 ae_type: str = "conv", do_vae: bool = False):
        super().__init__()
        if activation not in ("elu", "relu"):
            raise ValueError(f"unsupported activation {activation!r}")
        if ae_type == "dense" and input_shape is None:
            raise ValueError("a dense bottleneck needs input_shape")
        self.config = dict(nb_levels=nb_levels, pool_size=pool_size,
                           nb_conv_per_level=nb_conv_per_level, activation=activation,
                           final_pred_activation=final_pred_activation)
        cin = in_channels
        for level in range(nb_levels):
            feats = int(round(nb_features * feat_mult ** level))
            for conv in range(nb_conv_per_level):
                self.add_module(f"conv_downarm_{level}_{conv}",
                                nn.Conv3d(cin, feats, conv_size))
                cin = feats
        down = pool_size ** (nb_levels - 1)
        spatial = (1, 1, 1) if input_shape is None else tuple(s // down for s in input_shape)
        self.single_ae = SingleAE((cin, *spatial), tuple(enc_size), ae_type, conv_size, do_vae)
        for level in range(nb_levels - 1):
            feats = int(round(nb_features * feat_mult ** (nb_levels - 2 - level)))
            for conv in range(nb_conv_per_level):
                self.add_module(f"conv_uparm_{nb_levels + level}_{conv}",
                                nn.Conv3d(cin, feats, conv_size))
                cin = feats
        self.likelihood = nn.Conv3d(cin, nb_labels, 1)

    def _act(self, x):
        return F.elu(x) if self.config["activation"] == "elu" else F.relu(x)

    def _conv(self, name, x):
        mod = getattr(self, name)
        return same_conv3d(x, mod.weight.to(x.dtype), mod.bias.to(x.dtype))

    def forward(self, x, dtype=torch.float32, generator=None, eps=None):
        """(N, C, D, H, W) -> (N, nb_labels, D, H, W) float32; the convs run in
        ``dtype``.  A VAE draws its noise from ``generator`` unless ``eps`` (the
        bottleneck's shape) is given."""
        nl, ncpl, pool = (self.config[k] for k in ("nb_levels", "nb_conv_per_level",
                                                   "pool_size"))
        x = x.to(dtype)
        for level in range(nl):
            for conv in range(ncpl):
                x = self._act(self._conv(f"conv_downarm_{level}_{conv}", x))
            if level < nl - 1:
                x = F.max_pool3d(x, pool)
        x, _, _ = self.single_ae(x, generator, eps)
        for level in range(nl - 1):
            x = upsample2(x, pool)
            for conv in range(ncpl):
                x = self._act(self._conv(f"conv_uparm_{nl + level}_{conv}", x))
        lik = self.likelihood
        x = F.conv3d(x.to(torch.float32), lik.weight.to(torch.float32),
                     lik.bias.to(torch.float32))
        if self.config["final_pred_activation"] == "softmax":
            x = torch.softmax(x, dim=1)
        return x
