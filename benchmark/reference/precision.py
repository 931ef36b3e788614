"""The lower-precision controls: float8 with a scale per tensor, and bfloat16.

The configurations state bf16 compute for the network; the nearest
precision below it is float8.  ``fp8`` rounds a tensor to e4m3 after
scaling its largest magnitude to e4m3's largest finite value (448), and
rounds the gradient that flows back through it to e5m2 the same way
(57344), as float8 training does.  The train cells' generator runs in
float32, and ``bf16`` rounds its volumes.
"""

from __future__ import annotations

import torch

E4M3_MAX, E5M2_MAX = 448.0, 57344.0


def _round(x: torch.Tensor, dtype, top: float) -> torch.Tensor:
    amax = x.detach().abs().amax()
    scale = torch.where(amax > 0, amax / top, torch.ones_like(amax))
    return (x / scale).to(dtype).to(x.dtype) * scale


class _Fp8(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return _round(x, torch.float8_e4m3fn, E4M3_MAX)

    @staticmethod
    def backward(ctx, g):
        return _round(g, torch.float8_e5m2, E5M2_MAX)


def fp8(x: torch.Tensor) -> torch.Tensor:
    return _Fp8.apply(x)


def bf16(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to bfloat16, the precision below float32: the control
    of the stages that the configuration runs in float32 (the generator)."""
    return x.to(torch.bfloat16).to(x.dtype)
