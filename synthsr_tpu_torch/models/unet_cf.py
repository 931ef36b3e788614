"""Fast channels-first inference forward of the SynthSR U-Net: the port of
``synthsr_tpu/models/unet_cf.py``.

Every 3³ conv goes through :func:`synthsr_tpu_torch.ops.conv_cf.conv3d_cf`, at
every level, so on a card one forward of the shipped net is exactly 1
H-first-mma + 17 H-fwd-mma launches (H-first-x3 + 17 H-fwd-x3 in float32).  The decoder's first conv reads
``[skip, up]`` as two sources (packed for that split); the last conv of
each decoder level folds its BatchNorm in as ``post``.  Where JAX folds the
1x1x1 likelihood too (unet_cf.py:310-317: one label, linear activation) the
final level's last conv takes it as ``head``; any other head (several
labels, softmax) is applied after that conv in float32, softmax where the
model asks for it.  Encoder BatchNorm (in the compute dtype, as ``_bn_cf``),
max-pool and upsampling are plain torch ops, as they are XLA ops in the JAX
package.  Activations and skips stay in the compute dtype; each conv sums in
float32.  The models it takes are those of the fast train gate
(:func:`~.unet_cf_train.can_fast_train`).

TPU workarounds of the JAX module that are dropped here:

- ``jax.lax.optimization_barrier`` around every kernel (kept XLA from fusing
  Pallas outputs into VMEM-resident fusions);
- ``PREFER_FLAT`` (conv_pallas.py:97-107), the plane-vs-flat kernel choice;
- the two-executable decoder split ``make_fast_predictor`` (unet_cf.py:374-413),
  against XLA's VMEM prefetch mis-sizing the whole 256³ graph;
- channel-group chaining through ``accum`` (conv_pallas.py:720-729), which
  exists only for the Mosaic compile cap: H-fwd-mma sums all 27·C_in taps
  in float32 in one launch;
- the channels-last XLA fallback at the deep levels and the layout switching
  it needs.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..ops.conv_cf import conv3d_cf, pack_conv
from .unet import UNet3D, check_poolable, upsample2
from .unet_cf_train import can_fast_train


def bn_affine(bn) -> torch.Tensor:
    """Inference BatchNorm as a per-channel (scale, shift) affine, (2, C) f32."""
    a = bn.weight.detach().float() * torch.rsqrt(bn.running_var.float() + bn.eps)
    b = bn.bias.detach().float() - bn.running_mean.float() * a
    return torch.stack([a, b])


def _bn_cf(bn, x):
    """Encoder BatchNorm in the activations' dtype, as ``_bn_cf`` (unet_cf.py:27)."""
    dt, shape = x.dtype, (-1, 1, 1, 1)
    inv = torch.rsqrt(bn.running_var.to(dt).reshape(shape) + bn.eps)
    return (x - bn.running_mean.to(dt).reshape(shape)) * inv \
        * bn.weight.detach().to(dt).reshape(shape) + bn.bias.detach().to(dt).reshape(shape)


def flip_d_state_dict(sd: dict) -> dict:
    """Weights for the flip-TTA pass: every 3³ kernel flipped along its D axis
    (dim 2 of OIDHW; 1x1x1 kernels unchanged).  The U-Net is exactly
    equivariant to the flip when every pooled size is even, so the forward
    with these weights IS flip_D(net(flip_D(x))): the TTA pass needs no input
    flip and no output flip (unet_cf.py:357-371)."""
    return {k: torch.flip(v, [2]) if v.dim() == 5 and v.shape[2] > 1 else v
            for k, v in sd.items()}


def folds_head(model: UNet3D) -> bool:
    """True when the likelihood folds into the last conv: one label, linear."""
    cfg = model.config
    return cfg["nb_labels"] == 1 and cfg["final_pred_activation"] == "linear"


def _concat(model: UNet3D, level: int) -> bool:
    """Whether decoder ``level`` reads the skip (``skip_n_concatenations``)."""
    return level < model.nb_levels - model.config["skip_n_concatenations"] - 1


def pack_unet(model: UNet3D, dtype: torch.dtype = torch.bfloat16) -> dict:
    """What the fast forward needs from the model, made once per weight set on
    the model's device: per conv its :class:`PackedConv` and bias, per decoder
    level its BatchNorm affine (``post_{level}``), and the ``head`` (the
    folded (weights, bias) when :func:`folds_head`, else the float32
    likelihood's (nb_labels, C) weights and (nb_labels,) bias)."""
    if not can_fast_train(model):
        raise ValueError("model options outside the fast forward (can_fast_train)")
    nl, ncpl = model.nb_levels, model.nb_conv_per_level
    splits = {}  # each decoder's first conv reads [skip, up]
    for level in range(nl - 1):
        if _concat(model, level):
            skip = getattr(model, f"conv_downarm_{nl - 2 - level}_{ncpl - 1}").out_channels
            up = getattr(model, f"conv_uparm_{nl + level}_0").in_channels - skip
            splits[f"conv_uparm_{nl + level}_0"] = (skip, up)
    packed = {}
    for name, mod in model.named_children():
        if name.startswith("conv_"):
            w = mod.weight.detach().permute(2, 3, 4, 1, 0)  # OIDHW -> DHWIO
            packed[name] = (pack_conv(w, dtype, splits.get(name)), mod.bias.detach().float())
    for level in range(model.nb_levels - 1):
        packed[f"post_{level}"] = bn_affine(getattr(model, f"bn_up_{level}"))
    lik = model.likelihood
    if folds_head(model):
        packed["head"] = (lik.weight.detach().reshape(-1).float(),
                          lik.bias.detach().reshape(()).float())
    else:
        packed["head"] = (lik.weight.detach().reshape(lik.out_channels, -1).float(),
                          lik.bias.detach().float())
    return packed


@torch.no_grad()
def fast_unet_forward(model: UNet3D, x: torch.Tensor, dtype: torch.dtype = torch.bfloat16,
                      packed: dict | None = None) -> torch.Tensor:
    """Inference forward (1, C, D, H, W) -> (1, nb_labels, D, H, W) float32.

    ``packed``: the output of :func:`pack_unet` for ``model`` and ``dtype``
    (made here when None)."""
    if x.dim() != 5 or x.shape[0] != 1:
        raise ValueError(f"expected a (1, C, D, H, W) input, got {tuple(x.shape)}")
    nl, ncpl = model.nb_levels, model.nb_conv_per_level
    check_poolable(x.shape[2:], nl)
    p = pack_unet(model, dtype) if packed is None else packed
    act = model.config["activation"]
    fold = folds_head(model)
    xx = x[0].to(dtype).contiguous()
    skips = []
    for level in range(nl):
        for conv in range(ncpl):
            w, b = p[f"conv_downarm_{level}_{conv}"]
            xx = conv3d_cf(xx, w, bias=b, activation=act)
        skips.append(xx)
        xx = _bn_cf(getattr(model, f"bn_down_{level}"), xx)
        if level < nl - 1:
            xx = F.max_pool3d(xx, 2)
    for level in range(nl - 1):
        up = upsample2(xx)
        srcs = [skips[nl - 2 - level], up] if _concat(model, level) else up
        for conv in range(ncpl):
            last = conv == ncpl - 1
            w, b = p[f"conv_uparm_{nl + level}_{conv}"]
            xx = conv3d_cf(srcs if conv == 0 else xx, w, bias=b, activation=act,
                           post=p[f"post_{level}"] if last else None,
                           head=p["head"] if fold and last and level == nl - 2 else None)
    if fold and nl > 1:
        return xx[None]
    k, b = p["head"] if not fold else (p["head"][0][None], p["head"][1].reshape(1))
    out = (k @ xx.to(torch.float32).reshape(xx.shape[0], -1)).reshape(-1, *xx.shape[1:]) \
        + b.reshape(-1, 1, 1, 1)
    if model.config["final_pred_activation"] == "softmax":
        out = torch.softmax(out, dim=0)
    return out[None]
