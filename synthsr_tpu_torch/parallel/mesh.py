"""Data parallelism over ``torch.distributed``: the counterpart of
``synthsr_tpu/parallel/mesh.py``.

The JAX package lays a 1-D ``data`` mesh over its devices, shards the batch
over it and replicates the parameters.  Here each card is one process, a rank
of one process group of ``world_size`` ranks (NCCL on the cards, gloo on the
CPU).  Every rank holds a full copy of the parameters: all start from the same
seeded initialisation or checkpoint and apply the same averaged gradient, so
the copies stay equal without any sharding of parameters.  Each rank feeds
its contiguous slice of the global batch (:func:`local_slice`).

- :func:`spawn` starts one worker process per rank (spawn context), joins
  them and raises when one fails or the time limit passes;
- :func:`data_group` is the group a train step averages over;
- :func:`all_reduce_mean` is the differentiable mean over the ranks that
  BatchNorm's statistics take inside the net (JAX's ``pmean`` over the
  ``bn_axis``): its backward averages the cotangents as well, so each rank's
  gradient holds the other ranks' losses' paths through the statistics;
- :func:`all_reduce_mean_list` averages a list of tensors (the gradients and
  the loss) in one flat collective.
"""

from __future__ import annotations

import os
import shutil
import tempfile
import time

import torch
import torch.distributed as dist

LAUNCH_HINT = ("start one process per rank with synthsr_tpu_torch.parallel.mesh.spawn, or "
               "`python -m synthsr_tpu_torch.cli.train ... --n_devices N` (add --cpu for gloo "
               "on the CPU)")


def init_group(rank: int, world_size: int, init_method: str, device_type: str = "cuda"):
    """Join the default process group as ``rank`` of ``world_size``: NCCL on
    ``cuda:rank`` (made the current device), gloo on the CPU.
    ``init_method``: ``file://<path>`` or ``tcp://localhost:<port>``."""
    if device_type == "cuda":
        torch.cuda.set_device(rank)
    dist.init_process_group("nccl" if device_type == "cuda" else "gloo",
                            init_method=init_method, world_size=world_size, rank=rank)


def data_group(n_devices):
    """The group a train step averages over: the default group when
    ``torch.distributed`` is initialised (its size must be ``n_devices`` when
    that is given), else None for one process.  Raises when ``n_devices`` > 1
    and no group of that size exists."""
    if dist.is_available() and dist.is_initialized():
        size = dist.get_world_size()
        if n_devices is not None and int(n_devices) != size:
            raise RuntimeError(f"n_devices={n_devices} but the process group has {size} "
                               f"ranks; {LAUNCH_HINT}")
        return dist.group.WORLD
    if n_devices is not None and int(n_devices) > 1:
        raise RuntimeError(f"n_devices={n_devices} needs an initialised torch.distributed "
                           f"group of {n_devices} ranks; {LAUNCH_HINT}")
    return None


def rank_and_size(group) -> tuple[int, int]:
    """(rank, world size) in ``group``; (0, 1) for None."""
    if group is None:
        return 0, 1
    return dist.get_rank(group), dist.get_world_size(group)


def local_slice(group):
    """``build_model_inputs``'s ``local_slice``: (rank, world size), or None
    for one process."""
    return None if group is None else rank_and_size(group)


class _MeanAllReduce(torch.autograd.Function):

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        out = t.detach().clone()
        dist.all_reduce(out, group=group)
        return out / dist.get_world_size(group)

    @staticmethod
    def backward(ctx, g):
        g = g.detach().contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g / dist.get_world_size(ctx.group), None


def all_reduce_mean(t: torch.Tensor, group) -> torch.Tensor:
    """The mean of ``t`` over the ranks of ``group`` (``t`` itself for None),
    differentiable: the backward averages the cotangents over the ranks."""
    return t if group is None else _MeanAllReduce.apply(t, group)


def all_reduce_mean_list(ts, group) -> list:
    """The rank mean of each tensor in ``ts``, as one flat float32 collective
    (no gradient); ``ts`` itself for None."""
    if group is None:
        return list(ts)
    flat = torch.cat([t.detach().reshape(-1).to(torch.float32) for t in ts])
    dist.all_reduce(flat, group=group)
    flat /= dist.get_world_size(group)
    out, off = [], 0
    for t in ts:
        out.append(flat[off:off + t.numel()].reshape(t.shape).to(t.dtype))
        off += t.numel()
    return out


def _entry(fn, rank, world_size, init_method, device_type, args):
    init_group(rank, world_size, init_method, device_type)
    try:
        fn(rank, world_size, *args)
    finally:
        dist.destroy_process_group()


def spawn(fn, world_size: int, args=(), device_type: str = "cuda", timeout=None,
          rendezvous_dir=None):
    """Run ``fn(rank, world_size, *args)`` in ``world_size`` new processes
    (spawn context), each joined to one process group through a ``file://``
    rendezvous in ``rendezvous_dir`` (a fresh temporary directory when None,
    removed afterwards); ``fn`` must be importable by name.  Returns when all
    exit 0; raises when one fails (the others are killed) or when
    ``timeout`` seconds pass."""
    ctx = torch.multiprocessing.get_context("spawn")
    rdv = rendezvous_dir or tempfile.mkdtemp(prefix="synthsr_rdv_")
    os.makedirs(rdv, exist_ok=True)
    init_method = "file://" + os.path.join(os.path.abspath(rdv), "rendezvous")
    procs = [ctx.Process(target=_entry, args=(fn, r, world_size, init_method, device_type,
                                              tuple(args)))
             for r in range(world_size)]
    for p in procs:
        p.start()
    t0 = time.monotonic()
    failed = None
    try:
        while any(p.is_alive() for p in procs):
            failed = next((r for r, p in enumerate(procs)
                           if p.exitcode not in (None, 0)), None)
            if failed is not None:
                break
            if timeout is not None and time.monotonic() - t0 > timeout:
                failed = "timeout"
                break
            procs[0].join(0.2)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join()
        if rendezvous_dir is None:
            shutil.rmtree(rdv, ignore_errors=True)
    if failed is None:
        failed = next((r for r, p in enumerate(procs) if p.exitcode != 0), None)
    if failed == "timeout":
        raise TimeoutError(f"{world_size} ranks did not finish within {timeout} s")
    if failed is not None:
        raise RuntimeError(f"rank {failed} of {world_size} exited with code "
                           f"{procs[failed].exitcode}")
