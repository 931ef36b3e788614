"""Separable per-axis linear operators on the device: the counterpart of
``apply_axis_ops`` in ``synthsr_tpu/ops/linops.py`` (:124-145).

The predict path resamples each input to 1 mm as three (out, in) matrices
built on the host (``synthsr_tpu.ops.host_matrices``) and applied here as
plain float32 matrix products, which the JAX package also leaves to XLA.
"""

from __future__ import annotations

import torch


def apply_axis_ops(vol: torch.Tensor, mats) -> torch.Tensor:
    """Apply one (out_d, in_d) matrix per leading spatial axis of ``vol``.

    ``vol``: (X, Y, Z, ...), trailing axes pass through.  ``mats``: three
    matrices (or None for identity) on ``vol``'s device.  Float32 throughout."""
    mx, my, mz = mats
    out = vol.to(torch.float32)
    if mx is not None:
        out = torch.einsum("ax,xyz...->ayz...", mx.to(torch.float32), out)
    if my is not None:
        out = torch.einsum("by,xyz...->xbz...", my.to(torch.float32), out)
    if mz is not None:
        out = torch.einsum("cz,xyz...->xyc...", mz.to(torch.float32), out)
    return out
