"""The critic's fast paths on the hand-written kernels: the port of
``synthsr_tpu/models/discriminator_cf.py``, as the adversarial loop runs it.

- :func:`fast_disc_apply` (JAX ``make_fast_disc_apply`` with
  ``pallas_levels=0.5``, :163-242): the critic's first conv (C_in = 1 ->
  ``n_filters``, LeakyReLU fused) runs per example through
  :func:`~synthsr_tpu_torch.ops.conv_train.conv3d_cf_train`, which is
  H-first-mma on a card in bf16 (H-first-x3 in float32); every layer after it is
  batched plain PyTorch (cuDNN), as it is batched XLA in JAX.  First-order
  differentiable: the WGAN terms of both updates.  Whether the first conv's
  backward runs its input-gradient conv follows ``ctx.needs_input_grad``
  (JAX's ``want_dx``), so a detached input (the critic update) skips it and
  the generator update, whose fake requires a gradient, gets it.

- :func:`fast_disc_input_grad` (JAX ``make_fast_disc_input_grad``, the full
  channels-first program ``input_grad_one`` :365-395):
  ``g(x) = d(Σ D(x))/dx`` written out as a first-order program, a forward
  trunk that keeps its post-activations and then the backward chain by hand.
  ``conv3d_cf_train`` launches kernels through ``ctypes`` and cannot be
  differentiated twice, so the gradient penalty's parameter gradient (a
  second derivative of D) cannot reach the kernels by double autograd.
  Unrolled, every op is differentiated once: each stride-1 conv of the
  forward trunk (LeakyReLU fused) and each transposed stride-1 conv of the
  backward chain runs ``conv3d_cf_train`` (H-first-mma / H-fwd-wg on a card
  in bf16, H-fwd-mma for the 32->1), and autograd's backward of those convs
  launches the kernels' input-gradient convs and H-wgrad-wg (the 32->1's
  as (1,32), mirrored).  The stride-2 convs and their
  transposes are plain PyTorch: ``F.conv_transpose3d(g, w, stride=2)``
  cropped by the SAME padding of each axis ((0, 1) on an even size, (1, 1)
  on an odd one), so every spatial size takes these paths.

Both take the critic's parameters as a dict (``dict(model.named_parameters())``
or detached copies) and NCDHW inputs.  Dropped from the JAX module: the
space-to-depth stride-2 form (``_s2d_cf``, ``_conv_s2_cf_transpose``),
``pallas_levels`` values other than the loop's (the apply's 0.5, the input
gradient's full program) and the channels-last input-gradient variant
(:316-363), which the loop does not use.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..ops.conv_train import conv3d_cf_train
from .discriminator import (LEAKY_SLOPE, Discriminator3D, conv_s2, critic_head, leaky_relu,
                            same_pad_s2)


def _dhwio(params, name):
    return params[f"{name}.weight"].permute(2, 3, 4, 1, 0)  # OIDHW -> DHWIO, a view


def _flip_t(w):
    """DHWIO weights of the transposed SAME stride-1 conv: flipped in space,
    in and out channels swapped."""
    return torch.flip(w, (0, 1, 2)).transpose(3, 4)


def _leaky_mul(g, y):
    """``g·leaky'(pre)`` from the post-activation ``y``: y >= 0 <=> pre >= 0
    (leaky is a sign-preserving bijection), slope 1 there, 0.2 below."""
    return torch.where(y >= 0, g, LEAKY_SLOPE * g)


def _conv_s2_transpose(g, w, spatial):
    """Input gradient of :func:`~.discriminator.conv_s2` over an input of
    ``spatial`` size: the strided transpose gives the padded input's 2m + 1
    planes per axis (m = ceil(n / 2), n + low + high of SAME), of which the
    input's n start at the low pad."""
    dx = F.conv_transpose3d(g[None], w.to(g.dtype), stride=2)[0]
    lo = [same_pad_s2(n)[0] for n in spatial]
    return dx[:, lo[0]:lo[0] + spatial[0], lo[1]:lo[1] + spatial[1], lo[2]:lo[2] + spatial[2]]


def fast_disc_apply(model: Discriminator3D, params: dict, x: torch.Tensor,
                    mask: torch.Tensor | None = None) -> torch.Tensor:
    """The critic on (B, 1, D, H, W) -> (B, 1) float32, the first conv on the
    kernels (module docstring)."""
    dt = model.compute_dtype
    x = x.to(dt)
    if mask is not None:
        x = x * mask.to(dt)
    w00, b00 = _dhwio(params, "conv_0_0"), params["conv_0_0.bias"]
    xb = torch.stack([conv3d_cf_train((x[i].contiguous(),), w00, b00, "leaky")
                      for i in range(x.shape[0])])
    xb = leaky_relu(conv_s2(xb, params["conv_0_1.weight"], params["conv_0_1.bias"]))
    for level in range(1, model.n_levels):
        w0, b0 = params[f"conv_{level}_0.weight"], params[f"conv_{level}_0.bias"]
        xb = leaky_relu(F.conv3d(xb, w0.to(dt), b0.to(dt), padding=1))
        xb = leaky_relu(conv_s2(xb, params[f"conv_{level}_1.weight"],
                                params[f"conv_{level}_1.bias"]))
    return critic_head(params, xb.permute(0, 2, 3, 4, 1).reshape(xb.shape[0], -1), dt)


def _input_grad_one(model, params, xi, mi):
    """``d D(xi) / d xi`` of one (C, D, H, W) example, as a first-order
    program (module docstring)."""
    dt = model.compute_dtype
    if mi is not None:
        xi = xi * mi
    saved = []
    for level in range(model.n_levels):
        s0 = conv3d_cf_train((xi.contiguous(),), _dhwio(params, f"conv_{level}_0"),
                             params[f"conv_{level}_0.bias"], "leaky")
        s1 = leaky_relu(conv_s2(s0[None], params[f"conv_{level}_1.weight"],
                                params[f"conv_{level}_1.bias"])[0])
        saved.append((s0, s1))
        xi = s1
    top = xi
    feat = top.permute(1, 2, 3, 0).reshape(-1)
    w0 = params["dense_0.weight"].to(dt)
    h = leaky_relu(w0 @ feat + params["dense_0.bias"].to(dt))

    # the backward chain: d(score)/d(xi)
    dh = _leaky_mul(params["dense_out.weight"][0].to(dt), h)
    g = (dh @ w0).reshape(*top.shape[1:], top.shape[0]).permute(3, 0, 1, 2)
    for level in reversed(range(model.n_levels)):
        s0, s1 = saved[level]
        g = _conv_s2_transpose(_leaky_mul(g, s1), params[f"conv_{level}_1.weight"],
                               s0.shape[1:])
        g = _leaky_mul(g, s0)
        g = conv3d_cf_train((g.contiguous(),), _flip_t(_dhwio(params, f"conv_{level}_0")),
                            None, None)
    if mi is not None:
        g = g * mi
    return g


def fast_disc_input_grad(model: Discriminator3D, params: dict, x: torch.Tensor,
                         mask: torch.Tensor | None = None) -> torch.Tensor:
    """``d(Σ_b D(x))/dx`` of (B, C, D, H, W) in the compute dtype,
    differentiable once in ``params`` (module docstring)."""
    dt = model.compute_dtype
    x = x.to(dt)
    mask = None if mask is None else mask.to(dt)
    return torch.stack([_input_grad_one(model, params, x[i], None if mask is None else mask[i])
                        for i in range(x.shape[0])])
