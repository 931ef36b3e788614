"""The weight-gradient kernels and H-fwd-wg of several checkouts, in turns on
one card, with their outputs' digests.

Each checkout (a directory holding ``synthsr_tpu_torch/``) runs in a process
of its own, in the order given and then reversed (A B B A for two), on the
seeded inputs of ``chip_smoke.py``:

- H-fwd-wg's rows of ``chip_smoke.py``'s kernel checks (``SHAPES`` rows whose
  kernel is ``fwd_wg``, at most ``FWD_LIMIT`` voxels x channels): the
  output's SHA-256 and ``REPS`` calls timed with CUDA events;
- the train step's weight gradients (``TRAIN_WGRAD``) in bf16 and in
  float32, through the checkout's ``conv3d_cf_wgrad``: digest and time;
- the bf16 train step at ``chip_smoke.py``'s tutorial-7 configuration
  (128^3, 4 input channels, ``make_train_step`` on its seeded synthetic 160^3
  label maps): ``STEPS`` consecutive warm steps timed with CUDA events, then
  one warm step under ``torch.profiler`` for the device time of its conv
  kernels by name.

Each process builds its checkout's kernels first and warms the card with
bf16 matrix products.  The report gives, per row, each checkout's times and
whether the digests agree across checkouts (a kernel that only moved between
files, or whose plan did not change, must give the same bits).

    python3 tools/ab_wgrad.py PARENT_CHECKOUT .

Needs one CUDA GPU and nvcc.  Prints the card's name and power limit, one
JSON line per process, then the rows.
"""

from __future__ import annotations

import hashlib
import json
import os
import tempfile

import numpy as np
from ab_common import open_checkout, run_in_turns, turns_main, warm

REPS = 5
STEPS = 8
FWD_LIMIT = 24 * 256 ** 3 * 3  # skip H-fwd-wg rows larger than [24,48]->24 @256^3


def _digest(t) -> str:
    """16 hex digits of the SHA-256 of a tensor's bytes."""
    import torch

    return hashlib.sha256(t.contiguous().view(-1).view(torch.uint8).cpu().numpy().tobytes()
                          ).hexdigest()[:16]


def worker(checkout):
    smoke = open_checkout(checkout)
    import torch
    from synthsr_tpu_torch.models.unet import UNet3D
    from synthsr_tpu_torch.ops import conv_cf
    from synthsr_tpu_torch.train.training import make_train_step
    from synthsr_tpu_torch.utils.finite_guard import adam_init

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    conv_cf.build_kernels()
    dev = torch.device("cuda")
    warm(torch.bfloat16)
    result = {"checkout": str(checkout), "ms": {}, "digest": {}}
    gen = torch.Generator(device=dev).manual_seed(0)
    for name, kernel, cins, cout, spatial, fused, dtype in smoke.SHAPES:
        if kernel != "fwd_wg" or sum(cins) * int(np.prod(spatial)) > FWD_LIMIT:
            continue
        kw = smoke.kernel_inputs(conv_cf, gen, cins, cout, spatial, fused, dtype)
        result["digest"][name] = _digest(conv_cf.conv3d_cf(**kw))
        result["ms"][name] = smoke.cuda_ms(lambda: conv_cf.conv3d_cf(**kw), REPS)
        del kw
    for dtype, tag in ((torch.bfloat16, ""), (torch.float32, " f32")):
        for ci, co, n in smoke.TRAIN_WGRAD:
            name = f"({ci},{co}) @{n}^3{tag}"
            x = torch.randn(ci, n, n, n, device=dev, generator=gen).to(dtype)
            g = torch.randn(co, n, n, n, device=dev, generator=gen).to(dtype)
            result["digest"][name] = _digest(conv_cf.conv3d_cf_wgrad(x, g))
            result["ms"][name] = smoke.cuda_ms(lambda: conv_cf.conv3d_cf_wgrad(x, g), REPS)
            del x, g
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as root:
        smoke.make_train_data(root, np.random.default_rng(0))
        generator, sampler, batch = smoke.tutorial7_generator(root, dev, 1)
        torch.manual_seed(0)
        model = UNet3D(in_channels=4).to(dev)
        step = make_train_step(model, generator, sampler, 1e-4, metrics="l1", loss_cropping=96,
                               residual_indices=[2])
        opt = adam_init(list(model.parameters()))
        gen = torch.Generator().manual_seed(1)
        for _ in range(2):
            opt, loss = step(opt, gen, batch)
        events = [torch.cuda.Event(enable_timing=True) for _ in range(STEPS + 1)]
        torch.cuda.synchronize()
        events[0].record()
        for e in events[1:]:
            opt, loss = step(opt, gen, batch)
            e.record()
        torch.cuda.synchronize()
        if not bool(torch.isfinite(loss)):
            raise RuntimeError("non-finite loss")
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            opt, loss = step(opt, gen, batch)
            torch.cuda.synchronize()
        rows = [((getattr(ev, "self_device_time_total", 0) or 0) / 1e3, ev.key)
                for ev in prof.key_averages()]
        kinds = {}
        for ms, key in rows:
            for kind in ("conv3d_fwd_wg", "conv3d_wgrad_wg", "conv3d_wgrad_mma",
                         "conv3d_wgrad_reduce"):
                if kind + "_kernel" in key:
                    kinds[kind] = kinds.get(kind, 0.0) + ms
        result["train_step"] = dict(ms=[a.elapsed_time(b) for a, b in zip(events, events[1:])],
                                    device_ms=sum(ms for ms, _ in rows), kernel_ms=kinds)
    print(json.dumps(result), flush=True)


def main(checkouts):
    runs = run_in_turns(__file__, checkouts)
    names = list(dict.fromkeys(r["checkout"] for r in runs))
    for row in runs[0]["ms"]:
        ms = {c: [r["ms"][row] for r in runs if r["checkout"] == c] for c in names}
        same = len({r["digest"][row] for r in runs}) == 1
        print(f"  {row:30s} " + "  ".join(f"{os.path.basename(c) or c}: "
                                          f"{', '.join(f'{t:.4f}' for t in ms[c])} ms"
                                          for c in names)
              + f"  bits {'equal' if same else 'differ'}", flush=True)
    for checkout in names:
        mine = [r["train_step"] for r in runs if r["checkout"] == checkout]
        steps = [t for r in mine for t in r["ms"]]
        print(f"  {checkout}: bf16 train step median {np.median(steps):.3f} ms (range "
              f"{min(steps):.3f}-{max(steps):.3f}, {len(steps)} steps); profiled step: device "
              f"{', '.join(f'{r['device_ms']:.3f}' for r in mine)} ms, kernels "
              f"{[{k: round(v, 3) for k, v in r['kernel_ms'].items()} for r in mine]}",
              flush=True)


if __name__ == "__main__":
    turns_main(__doc__, worker, main)
