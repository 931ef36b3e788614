"""Spatially sharded U-Net inference with a halo exchange: the port of
``synthsr_tpu/parallel/halo.py``.

One volume is split along its first spatial axis over the ranks of a
``torch.distributed`` group (JAX shards X, axis 1 of NDHWC; here it is D,
axis 2 of NCDHW, the axis the weight bridge maps JAX's first kernel axis
to).  Before every convolution each rank sends its last planes to rank + 1
and its first planes to rank - 1 (:func:`halo_pad`, point-to-point ops over
gloo or NCCL); the global ends get zeros, and the convolution runs VALID
along D and SAME along H and W, which is exactly the unsharded SAME
convolution.  The net is ``UNet3D`` itself, run with ``halo=group``
(``models/unet.same_conv3d`` makes the exchange): pools, nearest
upsampling, inference BatchNorm and the skip concats are local.  The result
equals the unsharded forward up to float32 summation order.

Use: ``sharded_unet_apply(model, x, group)`` on every rank, with ``x`` the
whole (1, C, D, H, W) volume; D must divide by world size · 2^(nb_levels-1).
It returns this rank's D-slice of the output; :func:`gather_d` assembles the
whole output.  Processes and groups come from ``parallel/mesh.py``
(``spawn``, ``init_group``).
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from .mesh import rank_and_size


def _exchange(sends, recvs, group):
    """Point-to-point exchange over ``group``: ``sends`` [(tensor, peer
    rank)] and ``recvs`` [(buffer, peer rank)], peers in ``group``'s
    numbering; every op is posted in one ``batch_isend_irecv`` and waited
    for.  Empty tensors are skipped (on both sides alike)."""
    ops = [dist.P2POp(op, t.contiguous() if op is dist.isend else t,
                      dist.get_global_rank(group, peer), group)
           for op, pairs in ((dist.isend, sends), (dist.irecv, recvs))
           for t, peer in pairs if t.numel()]
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()


def _planes(x, dim, k):
    """The shape of ``k`` planes of ``x`` along ``dim``."""
    return x.shape[:dim] + (k,) + x.shape[dim + 1:]


class _HaloPad(torch.autograd.Function):
    """Pad ``dim`` with ``lo`` planes of rank - 1 and ``hi`` planes of rank +
    1 (zeros at the global ends); the backward is the reversed exchange: each
    rank adds the halo gradients it receives onto its own edge planes."""

    @staticmethod
    def forward(ctx, x, lo, hi, dim, group):
        ctx.lo, ctx.hi, ctx.dim, ctx.group = lo, hi, dim, group
        rank, n = rank_and_size(group)
        size = x.shape[dim]
        if n > 1 and size < max(lo, hi):
            raise AssertionError(f"a {max(lo, hi)}-plane halo needs local slices at least as "
                                 f"thick; this one has {size} planes (use fewer ranks or a "
                                 "larger volume)")
        from_left, from_right = x.new_zeros(_planes(x, dim, lo)), x.new_zeros(_planes(x, dim, hi))
        sends, recvs = [], []
        if rank > 0:  # rank - 1's right halo is my first hi planes
            sends.append((x.narrow(dim, 0, hi), rank - 1))
            recvs.append((from_left, rank - 1))
        if rank < n - 1:  # rank + 1's left halo is my last lo planes
            sends.append((x.narrow(dim, size - lo, lo), rank + 1))
            recvs.append((from_right, rank + 1))
        _exchange(sends, recvs, group)
        return torch.cat([from_left, x, from_right], dim)

    @staticmethod
    def backward(ctx, g):
        lo, hi, dim, group = ctx.lo, ctx.hi, ctx.dim, ctx.group
        rank, n = rank_and_size(group)
        size = g.shape[dim] - lo - hi
        gx = g.narrow(dim, lo, size).clone()
        sends, recvs = [], []
        if rank > 0:
            sends.append((g.narrow(dim, 0, lo), rank - 1))
            recvs.append((gx.new_empty(_planes(g, dim, hi)), rank - 1))
        if rank < n - 1:
            sends.append((g.narrow(dim, lo + size, hi), rank + 1))
            recvs.append((gx.new_empty(_planes(g, dim, lo)), rank + 1))
        _exchange(sends, recvs, group)
        for got, peer in recvs:
            start = 0 if peer < rank else size - got.shape[dim]
            gx.narrow(dim, start, got.shape[dim]).add_(got)
        return gx, None, None, None, None


def halo_pad(x: torch.Tensor, group, halo=1, dim: int = 2) -> torch.Tensor:
    """Pad the sharded axis ``dim`` (D of NCDHW by default) with the
    neighbouring ranks' planes of ``group``: ``halo`` planes each side, or
    ``(lo, hi)``; the global ends get zeros (SAME-conv semantics).  ``group``
    None is one rank: zeros both sides.  Differentiable."""
    lo, hi = (halo, halo) if isinstance(halo, int) else halo
    return _HaloPad.apply(x, int(lo), int(hi), dim, group)


def check_divisible(d: int, n: int, model):
    """D must divide by n · pool^(nb_levels - 1): raises ``AssertionError``,
    the JAX package's exception for this check."""
    m = n * model.config["pool_size"] ** (model.nb_levels - 1)
    if d % m:
        raise AssertionError(f"D={d} must be divisible by world size*2^(levels-1)={m}")


def local_d_slice(x: torch.Tensor, group) -> torch.Tensor:
    """This rank's contiguous D-slice (axis 2) of ``x``."""
    rank, n = rank_and_size(group)
    local = x.shape[2] // n
    return x[:, :, rank * local:(rank + 1) * local]


def sharded_unet_apply(model, x: torch.Tensor, group=None, dtype=torch.float32) -> torch.Tensor:
    """The exact D-sharded inference forward: every rank of ``group`` (None:
    one process) passes the whole (1, C, D, H, W) volume and gets back its
    (1, nb_labels, D/n, H, W) float32 slice of the output."""
    _, n = rank_and_size(group)
    check_divisible(x.shape[2], n, model)
    with torch.no_grad():
        return model(local_d_slice(x, group), dtype, halo=group)


def gather_d(local: torch.Tensor, group=None) -> torch.Tensor:
    """The whole output from each rank's D-slice (all-gather along axis 2)."""
    if group is None:
        return local
    _, n = rank_and_size(group)
    parts = [torch.empty_like(local) for _ in range(n)]
    dist.all_gather(parts, local.contiguous(), group=group)
    return torch.cat(parts, 2)
