"""The port's float32 path from several checkouts, in turns on one card.

Each checkout (a directory holding ``synthsr_tpu_torch/``) runs in a process
of its own, in the order given and then reversed (A B B A for two), on the
same seeded random weights and synthetic inputs as ``chip_smoke.py``:

- each float32 row of ``chip_smoke.py``'s kernel checks (``SHAPES`` and
  ``WGRAD_SHAPES``; the inputs of ``kernel_inputs``), through the
  checkout's ``conv3d_cf`` / ``conv3d_cf_wgrad``, ``KERNEL_REPS`` calls
  timed with CUDA events; a row under ``HOST_BOUND_MS`` a call is bound by
  the call's host path, and ``HOST_REPS`` calls of it are timed again on the
  host's clock (wall time per call, the card synchronised once at the end);
- the float32 flip-TTA predict network (``Predictor(compute_dtype=
  "float32").network``) on the clinical scan that pads to 192x224x192,
  ``NET_REPS`` calls timed with CUDA events;
- the float32 train step at ``chip_smoke.py``'s tutorial-7 configuration
  (128^3, 4 input channels, ``make_train_step(compute_dtype=torch.float32)``
  on its seeded synthetic 160^3 label maps): ``STEPS`` consecutive warm
  steps, each timed with CUDA events, then one warm step under
  ``torch.profiler`` for the device time of its conv kernels (``conv3d_*``)
  and of everything.

Each process builds its checkout's kernels first, then runs float32 matrix
products for a few tenths of a second so that the first row is not timed on
a card still raising its clocks.

    python3 tools/ab_float32.py PARENT_CHECKOUT .

Needs one CUDA GPU and nvcc.  Prints the card's name and power limit, one
JSON line per process, then per checkout the medians and ranges.
"""

from __future__ import annotations

import json
import os
import tempfile
import time

import numpy as np
from ab_common import open_checkout, run_in_turns, turns_main, warm

NET_REPS = 3
STEPS = 8
KERNEL_REPS = 10
HOST_BOUND_MS = 0.1
HOST_REPS = 1000


def worker(checkout):
    smoke = open_checkout(checkout)
    import torch
    from synthsr_tpu_torch.cli import predict
    from synthsr_tpu_torch.models.unet import UNet3D
    from synthsr_tpu_torch.models.weights import random_variables, variables_to_state_dict
    from synthsr_tpu_torch.ops import conv_cf
    from synthsr_tpu_torch.train.training import make_train_step
    from synthsr_tpu_torch.utils.finite_guard import adam_init

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    conv_cf.build_kernels()
    dev = torch.device("cuda")
    warm(torch.float32)  # brings the clocks up before the first row
    rng = np.random.default_rng(0)
    result = {"checkout": str(checkout), "kernel_ms": {}, "host_us": {}}
    gen = torch.Generator(device=dev).manual_seed(0)
    for name, _, cins, cout, spatial, fused, dtype in smoke.SHAPES:
        if dtype == torch.float32:
            kw = smoke.kernel_inputs(conv_cf, gen, cins, cout, spatial, fused, dtype)
            result["kernel_ms"][name] = smoke.cuda_ms(lambda: conv_cf.conv3d_cf(**kw), KERNEL_REPS)
            if result["kernel_ms"][name] < HOST_BOUND_MS:
                t0 = time.perf_counter()
                for _ in range(HOST_REPS):
                    conv_cf.conv3d_cf(**kw)
                torch.cuda.synchronize()
                result["host_us"][name] = (time.perf_counter() - t0) / HOST_REPS * 1e6
            del kw
    for ci, co, n, dtype in smoke.WGRAD_SHAPES:
        if dtype == torch.float32:
            x = torch.randn(ci, n, n, n, device=dev, generator=gen)
            g = torch.randn(co, n, n, n, device=dev, generator=gen)
            result["kernel_ms"][f"({ci},{co}) @{n}^3 f32"] = smoke.cuda_ms(
                lambda: conv_cf.conv3d_cf_wgrad(x, g), KERNEL_REPS)
            del x, g
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        weights = os.path.join(tmp, "weights.pt")
        torch.save(variables_to_state_dict(random_variables(seed=0)), weights)
        name, shape, zooms, ct = smoke.VOLUMES[1]  # the clinical scan: 192x224x192
        vol = smoke.phantom(shape, zooms, ct, rng)
        pred = predict.Predictor(model_path=weights, compute_dtype="float32")
        x = pred.prepare(vol, np.diag(list(zooms) + [1.0]))[0]
        with torch.no_grad():
            result["predict_network"] = dict(
                padded=list(x.shape[2:]),
                ms=[smoke.cuda_ms(lambda: pred.network(x), 1) for _ in range(NET_REPS)])
        del x, pred
        torch.cuda.empty_cache()

        root = os.path.join(tmp, "train")
        os.makedirs(root)
        smoke.make_train_data(root, rng)
        generator, sampler, batch = smoke.tutorial7_generator(root, dev, 1)
        torch.manual_seed(0)
        model = UNet3D(in_channels=4).to(dev)
        step = make_train_step(model, generator, sampler, 1e-4, metrics="l1", loss_cropping=96,
                               residual_indices=[2], compute_dtype=torch.float32)
        opt = adam_init(list(model.parameters()))
        gen = torch.Generator().manual_seed(1)
        conv_cf.reset_launch_counts()
        for _ in range(2):
            opt, loss = step(opt, gen, batch)
        torch.cuda.synchronize()
        launches = {k: v // 2 for k, v in conv_cf.LAUNCHES.items() if v}
        events = [torch.cuda.Event(enable_timing=True) for _ in range(STEPS + 1)]
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
        result["train_step"] = dict(
            ms=[a.elapsed_time(b) for a, b in zip(events, events[1:])],
            launches_per_step=launches,
            profiled_device_ms=sum(ms for ms, _ in rows),
            profiled_conv_kernel_ms={k[:60]: ms for ms, k in rows if "conv3d_" in k and ms > 0})
    print(json.dumps(result), flush=True)


def main(checkouts):
    runs = run_in_turns(__file__, checkouts)
    names = list(dict.fromkeys(r["checkout"] for r in runs))
    for row in runs[0]["kernel_ms"]:
        ms = {c: [r["kernel_ms"][row] for r in runs if r["checkout"] == c] for c in names}
        print(f"  {row:30s} " + "  ".join(f"{c}: {', '.join(f'{t:.3f}' for t in ms[c])} ms"
                                          for c in names), flush=True)
    for row in dict.fromkeys(k for r in runs for k in r["host_us"]):
        us = {c: [r["host_us"][row] for r in runs if r["checkout"] == c and row in r["host_us"]]
              for c in names}
        print(f"  {row:30s} host " + "  ".join(
            f"{c}: {', '.join(f'{t:.1f}' for t in us[c])} us/call" for c in names), flush=True)
    for checkout in names:
        mine = [r for r in runs if r["checkout"] == checkout]
        net = [t for r in mine for t in r["predict_network"]["ms"]]
        steps = [t for r in mine for t in r["train_step"]["ms"]]
        conv = [sum(r["train_step"]["profiled_conv_kernel_ms"].values()) for r in mine]
        print(f"  {checkout}: float32 predict network (TTA pair, 192x224x192) median "
              f"{np.median(net):.3f} ms (range {min(net):.3f}-{max(net):.3f}); float32 train "
              f"step median {np.median(steps):.3f} ms (range {min(steps):.3f}-{max(steps):.3f}, "
              f"{len(steps)} steps); conv kernels of a profiled step "
              f"{', '.join(f'{t:.3f}' for t in conv)} ms of "
              f"{', '.join(f'{r['train_step']['profiled_device_ms']:.3f}' for r in mine)} ms "
              f"device time", flush=True)


if __name__ == "__main__":
    turns_main(__doc__, worker, main)
