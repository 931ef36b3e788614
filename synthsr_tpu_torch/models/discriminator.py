"""WGAN-GP critic for adversarial fine-tuning: the port of
``synthsr_tpu/models/discriminator.py`` (reference
``SynthSR/fine_tuning_with_adversary.py:482-508``).

``n_levels`` blocks of [3³ conv stride 1 + LeakyReLU(0.2), 3³ conv stride 2 +
LeakyReLU(0.2)] with ``n_filters·2^level`` channels, then flatten, a dense
layer of ``n_filters·2^n_levels`` units + LeakyReLU(0.2) and a one-unit dense
head in float32.  An optional anatomy mask multiplies the input first.
Compute runs in ``compute_dtype`` with float32 parameters, as the flax module
does.

:func:`critic_forward` is the whole network as a function of a parameter
dict (the module's ``named_parameters`` naming), so the fast paths of
``models/discriminator_cf.py`` and the adversarial steps can run it on
detached or substituted parameters; :class:`Discriminator3D` is the module
that holds them.  Inputs are NCDHW.

Three details keep it equal to the flax module:

- TF "SAME" padding of a stride-2 conv pads (0, 1) on an even size (the
  extra zero at the high end), so the input is padded explicitly and the
  conv runs unpadded; ``padding=1`` would sample a shifted grid.
- flax flattens channels-last, so the trunk's output is permuted to NDHWC
  before the flatten and ``dense_0`` keeps its flax row order (the ``.h5``
  export stays valid).
- LeakyReLU is ``where(x >= 0, x, 0.2·x)``, as ``jax.nn.leaky_relu``: its
  slope at exactly 0 is 1, where ``F.leaky_relu``'s backward takes 0.2.  With
  zero biases a masked-out region has pre-activations of exactly 0, and the
  gradient penalty's gradients would differ there.

Dropped from the JAX module: the space-to-depth form of the stride-2 conv
(``_space_to_depth2``, ``_s2d_kernel``, ``_Conv3x3Stride2``), which works
around XLA's dilated lowering of a strided conv's input gradient; autograd
differentiates a strided ``F.conv3d`` twice as it is.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

LEAKY_SLOPE = 0.2


def leaky_relu(x: torch.Tensor) -> torch.Tensor:
    """LeakyReLU(0.2) with slope 1 at 0, as ``jax.nn.leaky_relu``."""
    return torch.where(x >= 0, x, LEAKY_SLOPE * x)


def same_pad_s2(n: int) -> tuple[int, int]:
    """TF "SAME" padding (low, high) of a 3-tap stride-2 conv over ``n``."""
    total = max((math.ceil(n / 2) - 1) * 2 + 3 - n, 0)
    return total // 2, total - total // 2


def conv_s2(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """SAME 3³ stride-2 conv of (B, C, D, H, W) with an OIDHW kernel, in
    ``x.dtype``."""
    pads = [p for n in reversed(x.shape[2:]) for p in same_pad_s2(n)]
    return F.conv3d(F.pad(x, pads), w.to(x.dtype), b.to(x.dtype), stride=2)


def trunk_shape(input_shape, n_filters: int, n_levels: int):
    """(channels, spatial) of the conv trunk's output."""
    spatial = list(input_shape)
    for _ in range(n_levels):
        spatial = [math.ceil(s / 2) for s in spatial]
    return n_filters * 2 ** (n_levels - 1), spatial


def critic_head(params: dict, feat: torch.Tensor, dtype) -> torch.Tensor:
    """Dense + LeakyReLU in ``dtype``, then the float32 one-unit head:
    (B, features) channels-last flattened -> (B, 1) float32."""
    h = leaky_relu(F.linear(feat, params["dense_0.weight"].to(dtype),
                            params["dense_0.bias"].to(dtype)))
    return F.linear(h.to(torch.float32), params["dense_out.weight"], params["dense_out.bias"])


def critic_forward(params: dict, x: torch.Tensor, mask: torch.Tensor | None, n_levels: int,
                   dtype=torch.float32) -> torch.Tensor:
    """The critic on (B, C, D, H, W) -> (B, 1) float32 scores, plain PyTorch."""
    x = x.to(dtype)
    if mask is not None:
        x = x * mask.to(dtype)
    for level in range(n_levels):
        w0, b0 = params[f"conv_{level}_0.weight"], params[f"conv_{level}_0.bias"]
        x = leaky_relu(F.conv3d(x, w0.to(dtype), b0.to(dtype), padding=1))
        x = leaky_relu(conv_s2(x, params[f"conv_{level}_1.weight"],
                               params[f"conv_{level}_1.bias"]))
    feat = x.permute(0, 2, 3, 4, 1).reshape(x.shape[0], -1)  # flax's channels-last order
    return critic_head(params, feat, dtype)


class Discriminator3D(nn.Module):
    """The critic for inputs of spatial shape ``input_shape`` (the dense
    layer's width depends on it; flax infers it at init)."""

    def __init__(self, input_shape, in_channels: int = 1, n_filters: int = 32,
                 n_levels: int = 4, compute_dtype=torch.float32):
        super().__init__()
        self.input_shape = tuple(int(s) for s in input_shape)
        self.in_channels = in_channels
        self.n_filters = n_filters
        self.n_levels = n_levels
        self.compute_dtype = compute_dtype
        cin = in_channels
        for level in range(n_levels):
            f = n_filters * 2 ** level
            self.add_module(f"conv_{level}_0", nn.Conv3d(cin, f, 3))
            self.add_module(f"conv_{level}_1", nn.Conv3d(f, f, 3))
            cin = f
        c, spatial = trunk_shape(self.input_shape, n_filters, n_levels)
        self.dense_0 = nn.Linear(c * math.prod(spatial), n_filters * 2 ** n_levels)
        self.dense_out = nn.Linear(n_filters * 2 ** n_levels, 1)

    def forward(self, x: torch.Tensor, mask: torch.Tensor | None = None) -> torch.Tensor:
        """(B, C, D, H, W) -> (B, 1) float32 critic scores."""
        return critic_forward(dict(self.named_parameters()), x, mask, self.n_levels,
                              self.compute_dtype)


def init_critic(model: Discriminator3D, seed: int = 1) -> Discriminator3D:
    """flax's default initialisation, in place: conv and dense kernels
    lecun-normal (truncated normal at ±2σ, std sqrt(1/fan_in) corrected for
    the truncation), zero biases."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for mod in model.children():
            fan_in = mod.weight[0].numel()
            std = (1.0 / fan_in) ** 0.5 / 0.87962566103423978
            torch.nn.init.trunc_normal_(mod.weight, 0.0, std, -2 * std, 2 * std, generator=gen)
            mod.bias.zero_()
    return model
