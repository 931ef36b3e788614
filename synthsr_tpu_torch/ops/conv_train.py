"""Differentiable channels-first 3³ conv for the training path: the port of
``synthsr_tpu/ops/conv_train.py``.

:func:`conv3d_cf_train` computes ``act(conv(concat(sources), w) + b)`` as a
``torch.autograd.Function`` around the kernels of ``ops/conv_cf.py``:

- **forward**: one :func:`~synthsr_tpu_torch.ops.conv_cf.conv3d_cf` call
  (on a card H-fwd-wg in bf16, H-fwd-mma for what its gate refuses, and the
  split-TF32 H-fwd-x3 in float32, or H-first-mma / H-first-x3 for a
  one-source conv with C_in <= 2 and C_out <= 32; bias and activation in its
  epilogue);
- **input gradient**: the vjp of a SAME stride-1 3³ conv is itself a SAME
  conv with the weights flipped in space and transposed in/out, so ``dx`` is
  one more forward-kernel launch on ``dpre``, split by channel offset per
  source;
- **weight gradient**: one H-wgrad-wg (bf16, W >= 8), H-wgrad-mma
  (the rest of bf16) or H-wgrad-x3 (float32) launch per source
  (:func:`~synthsr_tpu_torch.ops.conv_cf.conv3d_cf_wgrad`);
- **activation gradient**: from the SAVED OUTPUT (elu' = 1 where y > 0 else
  y + 1; relu' = [y > 0]; leaky' = 1 where y >= 0 else 0.2), so no
  pre-activation tensor is stored; ``dpre``
  stays in the activation dtype, ``db`` is a float32 sum.

Sources come as a tuple (the decoder's [skip, up] pair) and are never
concatenated, in either direction.  The input-gradient conv runs only for
sources that need a gradient (``ctx.needs_input_grad``: the first conv's input
is generator output).  Dropped from the JAX module: the opt-in im2col-dot form
(``_conv_dot``, a recorded negative) and the ``optimization_barrier``s.
"""

from __future__ import annotations

import torch

from .conv_cf import conv3d_cf, conv3d_cf_wgrad

_ACTIVATIONS = (None, "elu", "relu", "leaky")


def act_grad_from_output(activation, y: torch.Tensor, dy: torch.Tensor) -> torch.Tensor:
    """dL/d(pre-activation) from the saved post-activation output, in
    ``dy.dtype`` (conv_train.py:221-235)."""
    if activation == "elu":
        # elu is monotone through 0, so y > 0 <=> pre > 0; elu' = elu + 1 below
        return dy * torch.where(y > 0, torch.ones((), dtype=y.dtype, device=y.device),
                                y + 1).to(dy.dtype)
    if activation == "relu":
        return torch.where(y > 0, dy, torch.zeros((), dtype=dy.dtype, device=dy.device))
    if activation == "leaky":
        # leaky(0.2) is a monotone bijection: y >= 0 <=> pre >= 0, and the
        # slope at 0 is 1, as jax.nn.leaky_relu's where(x >= 0, ...)
        return torch.where(y >= 0, dy, 0.2 * dy)
    return dy


class _ConvTrain(torch.autograd.Function):

    @staticmethod
    def forward(ctx, activation, w, b, *sources):
        y = conv3d_cf(list(sources), w, bias=b, activation=activation)
        ctx.activation = activation
        ctx.save_for_backward(w, y, *sources)
        return y

    @staticmethod
    def backward(ctx, dy):
        w, y, *sources = ctx.saved_tensors
        dpre = act_grad_from_output(ctx.activation, y, dy.contiguous())
        db = dpre.to(torch.float32).sum(dim=(1, 2, 3)) if ctx.needs_input_grad[2] else None
        want = ctx.needs_input_grad[3:]
        dxs = [None] * len(sources)
        if any(want):
            # dx: SAME conv of dpre with flipped, in/out-transposed weights
            wt = torch.flip(w, (0, 1, 2)).transpose(3, 4)
            dx = conv3d_cf(dpre, wt)
            off = 0
            for i, s in enumerate(sources):
                if want[i]:
                    dxs[i] = dx[off:off + s.shape[0]].to(s.dtype)
                off += s.shape[0]
        dw = None
        if ctx.needs_input_grad[1]:
            # per-source weight gradients: the concatenated input never exists
            dws = [conv3d_cf_wgrad(s, dpre) for s in sources]
            dw = (torch.cat(dws, dim=3) if len(dws) > 1 else dws[0]).to(w.dtype)
        return (None, dw, db, *dxs)


def conv3d_cf_train(sources, w: torch.Tensor, b: torch.Tensor, activation=None) -> torch.Tensor:
    """Differentiable fused ``act(conv3d(concat(sources), w) + b)``.

    ``sources``: a tuple of (C_i, D, H, W) tensors of one dtype (bf16 or
    float32), concatenated on C only in concept; ``w``: (3, 3, 3, C_in, C_out)
    float32 (rounded to the sources' dtype by the kernel); ``b``: (C_out,).
    Returns (C_out, D, H, W) in the sources' dtype.  Gradients flow to every
    source that requires one, to ``w`` and to ``b``."""
    if activation not in _ACTIVATIONS:
        raise ValueError(f"unsupported activation {activation!r}")
    sources = tuple(sources) if isinstance(sources, (list, tuple)) else (sources,)
    return _ConvTrain.apply(activation, w, b, *sources)
