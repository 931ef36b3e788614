"""Interpolation, warping and resizing: the port of ``synthsr_tpu/ops/interp.py``
(reference ``ext/neuron/utils.py``: interpn :25, resize :127,
affine_to_shift :160, combine_non_linear_and_aff_to_shift :222, transform
:289, integrate_vec :323).

Conventions, as in the reference: ``interpn`` clips sample locations to
``[0, dim-1]`` (edge replication, not ``grid_sample``'s zero or border
padding); ``resize`` maps output index g to input coordinate g / zoom;
``affine_to_shift`` applies the affine about the centre ``(shape-1)/2``;
``integrate_vec`` is scaling and squaring.  Volumes are channels-last
(X, Y, Z[, C]), as in the JAX package.

Every warp is a plain gather.  Dropped from the JAX module, both TPU gather
workarounds: ``interpn_packed`` (one wide gather of a packed corner table)
and ``stencil_warp`` with its runtime-bounded dispatch in ``integrate_vec``
(tests/test_ops_core.py:347-359 holds both equal to the gather).
"""

from __future__ import annotations

import itertools

import torch

from .linops import apply_axis_ops, sample_matrix


def ndgrid(shape, device=None):
    """len(shape) float32 index grids, 'ij' indexing."""
    return list(torch.meshgrid(*[torch.arange(s, dtype=torch.float32, device=device)
                                 for s in shape], indexing="ij"))


def interpn(vol: torch.Tensor, loc: torch.Tensor, method: str = "linear") -> torch.Tensor:
    """Sample ``vol`` ((*spatial,) or (*spatial, C)) at ``loc`` (..., ndims),
    in voxel units, clipped to the volume: (..., C), or (...) without C."""
    ndims = loc.shape[-1]
    squeeze = vol.dim() == ndims
    if squeeze:
        vol = vol[..., None]
    if vol.dim() != ndims + 1:
        raise ValueError(f"vol rank {vol.dim()} does not match loc dims {ndims}")
    spatial = vol.shape[:-1]
    flat = vol.reshape(-1, vol.shape[-1])
    strides = [1] * ndims
    for d in range(ndims - 2, -1, -1):
        strides[d] = strides[d + 1] * spatial[d + 1]
    loc = loc.to(torch.float32)
    if method == "nearest":
        idx = 0
        for d in range(ndims):
            idx = idx + torch.clamp(torch.round(loc[..., d]).long(), 0, spatial[d] - 1) * strides[d]
        out = flat[idx]
    elif method == "linear":
        clipped = [torch.clamp(loc[..., d], 0, spatial[d] - 1) for d in range(ndims)]
        idx0 = [torch.clamp(torch.floor(loc[..., d]), 0, spatial[d] - 1).long()
                for d in range(ndims)]
        idx1 = [torch.clamp(idx0[d] + 1, max=spatial[d] - 1) for d in range(ndims)]
        # weight of the low corner along d is idx1 - clipped
        w_lo = [idx1[d].to(torch.float32) - clipped[d] for d in range(ndims)]
        out = 0.0
        for corner in itertools.product((0, 1), repeat=ndims):
            idx, wt = 0, 1.0
            for d in range(ndims):
                idx = idx + (idx1[d] if corner[d] else idx0[d]) * strides[d]
                wt = wt * (1.0 - w_lo[d] if corner[d] else w_lo[d])
            out = out + wt[..., None] * flat[idx].to(torch.float32)
    else:
        raise ValueError(f"method must be 'linear' or 'nearest', got {method}")
    return out[..., 0] if squeeze else out


def transform(vol: torch.Tensor, loc_shift: torch.Tensor, method: str = "linear"):
    """Warp by a dense shift field: out[x] = vol[x + loc_shift[x]]."""
    mesh = ndgrid(loc_shift.shape[:-1], loc_shift.device)
    loc = torch.stack([mesh[d] + loc_shift[..., d] for d in range(loc_shift.shape[-1])], -1)
    return interpn(vol, loc, method)


def _affine_loc(affine: torch.Tensor, moved):
    ndims = len(moved)
    affine = affine.to(torch.float32)
    if affine.dim() == 1:
        affine = affine.reshape(ndims, ndims + 1)
    flat = torch.stack([m.reshape(-1) for m in moved]
                       + [torch.ones(moved[0].numel(), device=moved[0].device)], 0)
    return (affine[:ndims] @ flat).T.reshape(*moved[0].shape, ndims)


def affine_to_shift(affine: torch.Tensor, shape, shift_center: bool = True):
    """Dense shift field of an affine mapping output to input coordinates
    (neuron/utils.py:160-219)."""
    mesh = ndgrid(shape, affine.device)
    if shift_center:
        mesh = [m - (shape[d] - 1) / 2.0 for d, m in enumerate(mesh)]
    return _affine_loc(affine, mesh) - torch.stack(mesh, -1)


def combine_nonlinear_and_affine_shift(svf_shift: torch.Tensor, affine: torch.Tensor,
                                       shift_center: bool = True):
    """Shift field of affine∘nonlinear: the affine applied to the centred mesh
    plus the nonlinear shift (neuron/utils.py:222-286)."""
    shape = svf_shift.shape[:-1]
    mesh = ndgrid(shape, svf_shift.device)
    if shift_center:
        mesh = [m - (shape[d] - 1) / 2.0 for d, m in enumerate(mesh)]
    moved = [mesh[d] + svf_shift[..., d] for d in range(len(shape))]
    return _affine_loc(affine, moved) - torch.stack(mesh, -1)


def resize(vol: torch.Tensor, new_shape, zoom_factor=None, method: str = "linear"):
    """Zoom-style resize: output index g samples input at g / zoom.  3-D
    volumes ((X, Y, Z[, C])) run as one sampling matrix per axis."""
    ndims = len(new_shape)
    spatial = vol.shape[:ndims]
    if zoom_factor is None:
        zoom_factor = [new_shape[d] / spatial[d] for d in range(ndims)]
    elif not isinstance(zoom_factor, (list, tuple)):
        zoom_factor = [zoom_factor] * ndims
    if ndims == 3:
        mats = [sample_matrix(torch.arange(new_shape[d], dtype=torch.float32, device=vol.device)
                              / zoom_factor[d], spatial[d], method=method) for d in range(3)]
        out = apply_axis_ops(vol, mats)
        if not vol.dtype.is_floating_point:
            out = torch.round(out).to(vol.dtype)
        return out
    mesh = ndgrid(new_shape, vol.device)
    loc = torch.stack([mesh[d] / zoom_factor[d] for d in range(ndims)], -1)
    return interpn(vol, loc, method)


def integrate_vec(vec: torch.Tensor, nb_steps: int = 7):
    """Integrate a stationary velocity field (*spatial, ndims) by scaling and
    squaring (neuron/utils.py:323-386, method 'ss'): v /= 2^k, then k times
    v += warp(v, v)."""
    v = vec / (2 ** nb_steps)
    for _ in range(nb_steps):
        v = v + transform(v, v, method="linear")
    return v
