"""GPU smoke run of the PyTorch port: builds the hand-written CUDA kernels,
holds each against its plain PyTorch version at the shapes of the port's two
main paths, then drives both at full width (24 features, 5 levels, seeded
random weights and data):

- predict: ``synthsr_tpu_torch.cli.predict.main`` with flip TTA over three
  synthetic volumes, and the fast network against the plain float32 forward;
- train: ``synthsr_tpu_torch.cli.train.main`` at the tutorial-7 configuration
  of ``bench_train.py`` (128³, 4 input channels, bf16) on seeded synthetic
  label maps, 2 epochs x 3 steps then a resume to epoch 3, one step's
  gradients against the plain float32 autograd of ``UNet3D.forward_train``,
  and the time of consecutive warm steps.

    python3 chip_smoke.py

Needs one CUDA GPU and ``nvcc``; imports nothing of JAX.  Exits non-zero on
any failure, and prints as its last line
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Every comparison with a plain version runs it in float32 with TF32 off.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

KERNEL_BOUND = 1e-2   # max|kernel - plain| / max|plain|, bf16 output (2^-8 rounding)
HEAD_BOUND = 1e-4     # the same for the f32 head output (sum order only)
WGRAD_BOUND = 1e-4    # the same for H-wgrad: f32 sums of bf16 products (order only)
NET_BOUND = 2e-2      # relative L2, bf16 fast TTA network output vs plain f32
GRAD_BOUND = 5e-2     # relative L2, one train step's bf16 kernel-path gradient vs plain f32
# the same for each 3³ conv's weight gradient on its own: the whole-gradient
# bound is dominated by the largest leaves, while a wrong dw or dx at any one
# conv puts an error of order 1 into that conv's leaf (and those before it)
LEAF_BOUND = 0.15
LOSS_BOUND = 1e-2     # relative difference of that step's loss
WARM_STEPS = 12       # consecutive warm train steps timed with CUDA events
SOURCE = "synthsr_tpu_torch/csrc/conv3d_cf.cu"
WGRAD_SOURCE = "synthsr_tpu_torch/csrc/conv3d_wgrad.cu"
PALLAS = "synthsr_tpu/ops/conv_pallas.py"
# kernel launches per train step of the shipped net (4 input channels, so no
# H-first): 18 forward convs + 17 input gradients (not the first conv's) on
# H-fwd; 18 weight gradients + 4 for the decoders' second sources on H-wgrad
TRAIN_LAUNCHES = {"first": 0, "fwd": 35, "wgrad": 22}

# (name, kernel, source channels, cout, spatial, fused epilogue)
SHAPES = [
    ("1->24 @256^3", "first", (1,), 24, (256, 256, 256), "bias+elu"),
    ("2->24 @256^3", "first", (2,), 24, (256, 256, 256), "bias+elu"),
    ("24->24 @256^3", "fwd", (24,), 24, (256, 256, 256), "bias+elu"),
    ("[24,48]->24 @256^3", "fwd", (24, 48), 24, (256, 256, 256), "bias+elu"),
    ("24->24 @256^3 +post+head", "fwd", (24,), 24, (256, 256, 256), "bias+elu+post+head"),
    ("48->48 @128^3", "fwd", (48,), 48, (128, 128, 128), "bias+elu"),
    ("96->96 @64^3", "fwd", (96,), 96, (64, 64, 64), "bias+elu"),
    ("[192,384]->192 @32^3 +post", "fwd", (192, 384), 192, (32, 32, 32), "bias+elu+post"),
    ("1->24 @192x224x192", "first", (1,), 24, (192, 224, 192), "bias+elu"),
    ("24->24 @192x224x192", "fwd", (24,), 24, (192, 224, 192), "bias+elu"),
    # the train step's input-gradient convs: flipped, transposed weights, no epilogue
    ("24->72 @128^3 (dx)", "fwd", (24,), 72, (128, 128, 128), "dx"),
    ("48->144 @64^3 (dx)", "fwd", (48,), 144, (64, 64, 64), "dx"),
]
TIMED = {"first": "1->24 @256^3", "fwd": "[24,48]->24 @256^3", "wgrad": "(24,24) @128^3"}

# H-wgrad at the train step's weight-gradient shapes: (ci, co, spatial)
WGRAD_SHAPES = [(4, 24, 128), (24, 24, 128), (48, 24, 128), (48, 48, 64), (96, 48, 64),
                (192, 96, 32), (384, 384, 8)]

# synthetic inputs: (file name, shape, voxel size mm, CT); the first resamples
# to 256^3, the second is a clinical anisotropic scan padding to 192x224x192
VOLUMES = [("t1_256.nii.gz", (256, 256, 128), (1.0, 1.0, 2.0), False),
           ("flair_clinical.nii.gz", (176, 208, 36), (1.0, 1.0, 5.0), False),
           ("head_ct.nii.gz", (192, 192, 64), (0.9, 0.9, 2.5), True)]


def require(ok, what):
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def phase(name):
    print(f"== {name}", flush=True)


def cuda_ms(fn, reps):
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    fn()
    torch.cuda.synchronize()
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def check_kernels(conv_cf, gen):
    """Each kernel against conv3d_cf_reference on the same bf16 inputs."""
    dev = torch.device("cuda")
    results = []

    def randn(*shape, scale=1.0):
        return torch.randn(*shape, device=dev, generator=gen) * scale

    for name, kernel, cins, cout, spatial, fused in SHAPES:
        cin = sum(cins)
        srcs = [randn(c, *spatial).to(torch.bfloat16) for c in cins]
        if fused == "dx":
            w = randn(3, 3, 3, cout, cin, scale=(2 / (27 * cin)) ** 0.5)
            kw = dict(x=srcs[0], w=torch.flip(w, (0, 1, 2)).transpose(3, 4))
        else:
            kw = dict(x=srcs if len(srcs) > 1 else srcs[0],
                      w=conv_cf.pack_conv(randn(3, 3, 3, cin, cout, scale=(2 / (27 * cin)) ** 0.5),
                                          torch.bfloat16),
                      bias=randn(cout, scale=0.1), activation="elu")
        if "post" in fused:
            kw["post"] = torch.stack([torch.rand(cout, device=dev, generator=gen) * 0.4 + 0.8,
                                      randn(cout, scale=0.1)])
        if "head" in fused:
            kw["head"] = (randn(cout, scale=cout ** -0.5), torch.tensor(0.25, device=dev))
        before = dict(conv_cf.LAUNCHES)
        got = conv_cf.conv3d_cf(**kw)
        torch.cuda.synchronize()
        launched = [k for k in before if conv_cf.LAUNCHES[k] != before[k]]
        require(launched == [kernel], (name, launched))
        want = conv_cf.conv3d_cf_reference(**kw)
        torch.cuda.synchronize()
        require(got.shape == want.shape and got.dtype == want.dtype, name)
        err = float((got.float() - want.float()).abs().max())
        rel = err / float(want.float().abs().max())
        bound = HEAD_BOUND if "head" in fused else KERNEL_BOUND
        reps = 3 if cin * np.prod(spatial) > 2 ** 28 else 10
        ms = cuda_ms(lambda: conv_cf.conv3d_cf(**kw), reps)
        plain_ms = cuda_ms(lambda: conv_cf.conv3d_cf_reference(**kw), reps)
        print(f"  {kernel:5s} {name:28s} {fused:20s} max_abs_err {err:.3e} rel {rel:.3e} "
              f"(bound {bound:.0e})  kernel {ms:.3f} ms  plain {plain_ms:.3f} ms", flush=True)
        require(np.isfinite(rel) and rel <= bound, (name, rel, bound))
        results.append(dict(kernel=kernel, shape=name, fused=fused, max_abs_err=err,
                            rel_err=rel, ms=ms, plain_ms=plain_ms))
        del srcs, kw, got, want
        torch.cuda.empty_cache()
    return results


def check_wgrad(conv_cf, gen):
    """H-wgrad against conv3d_cf_wgrad_reference (float32 conv3d_weight, TF32
    off) on the same bf16 inputs, and two calls bit-equal."""
    dev = torch.device("cuda")
    results = []
    for ci, co, n in WGRAD_SHAPES:
        name = f"({ci},{co}) @{n}^3"
        x = torch.randn(ci, n, n, n, device=dev, generator=gen).to(torch.bfloat16)
        g = torch.randn(co, n, n, n, device=dev, generator=gen).to(torch.bfloat16)
        before = conv_cf.LAUNCHES["wgrad"]
        got = conv_cf.conv3d_cf_wgrad(x, g)
        again = conv_cf.conv3d_cf_wgrad(x, g)
        torch.cuda.synchronize()
        require(conv_cf.LAUNCHES["wgrad"] == before + 2, name)
        want = conv_cf.conv3d_cf_wgrad_reference(x, g)
        torch.cuda.synchronize()
        require(got.shape == want.shape == (3, 3, 3, ci, co), name)
        err = float((got - want).abs().max())
        rel = err / float(want.abs().max())
        same = bool(torch.equal(got, again))
        ms = cuda_ms(lambda: conv_cf.conv3d_cf_wgrad(x, g), 5)
        plain_ms = cuda_ms(lambda: conv_cf.conv3d_cf_wgrad_reference(x, g), 5)
        tflops = 2 * 27 * ci * co * n ** 3 / ms / 1e9
        print(f"  wgrad {name:18s} max_abs_err {err:.3e} rel {rel:.3e} (bound "
              f"{WGRAD_BOUND:.0e})  bit-equal repeat {same}  kernel {ms:.3f} ms "
              f"({tflops:.1f} TFLOP/s)  plain {plain_ms:.3f} ms", flush=True)
        require(np.isfinite(rel) and rel <= WGRAD_BOUND, (name, rel))
        require(same, (name, "repeat differs"))
        results.append(dict(kernel="wgrad", shape=name, fused="", max_abs_err=err,
                            rel_err=rel, ms=ms, plain_ms=plain_ms))
        del x, g, got, again, want
    torch.cuda.empty_cache()
    return results


def make_train_data(root, rng):
    """Seeded synthetic training inputs: three 160³ label maps of nested
    ellipsoids split into left and right hemispheres (FreeSurfer label ids),
    the generation label list and 3-channel normal GMM priors."""
    from synthsr_tpu.io.volume import save_volume

    left, right = [2, 3, 4, 17], [41, 42, 43, 53]
    labels = np.array([0, 14, 24] + left + right, np.int32)
    lab_dir = os.path.join(root, "labels")
    os.makedirs(lab_dir)
    n = 160
    grid = np.meshgrid(*[np.arange(n) - n / 2] * 3, indexing="ij", sparse=True)
    for i in range(3):
        lab = np.zeros((n, n, n), np.int32)
        for k, r in enumerate((70, 55, 40, 25)):
            radii = r * rng.uniform(0.85, 1.1, 3)
            inside = sum((g / ri) ** 2 for g, ri in zip(grid, radii)) < 1
            side = np.broadcast_to(np.where(grid[0] < 0, left[k], right[k]), lab.shape)
            lab[inside] = side[inside]
        lab[(np.abs(grid[0]) < 2) & (lab > 0)] = 24
        lab[(np.abs(grid[1]) < 3) & (np.abs(grid[2]) < 3) & (lab > 0)] = 14
        save_volume(lab, np.eye(4), None, os.path.join(lab_dir, f"subject{i}.nii.gz"))
    np.save(os.path.join(root, "generation_labels.npy"), labels)
    n_lab = len(labels)
    means = np.concatenate([np.stack([rng.uniform(10, 240, n_lab), rng.uniform(5, 25, n_lab)])
                            for _ in range(3)])
    stds = np.concatenate([np.stack([rng.uniform(2, 12, n_lab), rng.uniform(1, 3, n_lab)])
                           for _ in range(3)])
    np.save(os.path.join(root, "prior_means.npy"), means.astype(np.float32))
    np.save(os.path.join(root, "prior_stds.npy"), stds.astype(np.float32))
    np.save(os.path.join(root, "data_res.npy"), np.array([[1.0, 1.0, 3.0], [1.0, 4.5, 1.0]]))
    np.save(os.path.join(root, "thickness.npy"), np.array([[1.0, 1.0, 3.0], [1.0, 3.0, 1.0]]))
    return lab_dir


def train_args(root, model_dir, epochs):
    """cli.train arguments of bench_train.py's tutorial-7 configuration."""
    return [os.path.join(root, "labels"), model_dir, os.path.join(root, "prior_means.npy"),
            os.path.join(root, "prior_stds.npy"), os.path.join(root, "generation_labels.npy"),
            "--input_channels", "False", "True", "True", "--output_channel", "0",
            "--output_shape", "128", "--data_res", os.path.join(root, "data_res.npy"),
            "--thickness", os.path.join(root, "thickness.npy"), "--nonlin_std", "2.0",
            "--bias_field_std", "0.2", "--work_with_residual_channel", "1",
            "--loss_cropping", "96", "--lr", "1e-4", "--batchsize", "1",
            "--scaling_bounds", "0.1", "--rotation_bounds", "8", "--shearing_bounds", "0.01",
            "--translation_bounds", "False", "--compute_dtype", "bfloat16",
            "--epochs", str(epochs), "--steps_per_epoch", "3", "--seed", "0"]


def train_phase(conv_cf, rng):
    """The train main path, then one step's gradients against the plain float32
    autograd, then where a warm step's time goes."""
    from synthsr_tpu_torch.cli import train as train_cli

    with tempfile.TemporaryDirectory() as root:
        phase("main path: train (tutorial-7 configuration, 128^3, bf16)")
        make_train_data(root, rng)
        model_dir = os.path.join(root, "model")
        logs = []
        log = (lambda line: (logs.append(line), print("  " + line, flush=True)))
        conv_cf.reset_launch_counts()
        t0 = time.perf_counter()
        first = train_cli.main(train_args(root, model_dir, 2), log_fn=log)
        resumed = train_cli.main(train_args(root, model_dir, 3), log_fn=log)
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
        launches = dict(conv_cf.LAUNCHES)
        steps = 9
        print(f"  main(): 2 epochs + resume to 3, {steps} steps in {train_s:.2f} s; "
              f"launches {launches} (expected {TRAIN_LAUNCHES} per step)")
        require(launches == {k: v * steps for k, v in TRAIN_LAUNCHES.items()}, launches)
        curve = first["loss_curve"] + resumed["loss_curve"]
        require(len(curve) == 3 and all(np.isfinite(curve)) and 0 < max(curve) < 10, curve)
        require(any("resuming from epoch 2" in line for line in logs), "no resume")
        require(sum("epoch 3/3" in line for line in logs) == 1, "epoch 3 ran more than once")
        files = sorted(os.listdir(model_dir))
        require(all(f"{e:03d}.pt" in files for e in (1, 2, 3)), files)
        h5 = all(f"{e:03d}.h5" in files for e in (1, 2, 3))
        require(h5 or any("h5py is not installed" in line for line in logs), files)
        with open(os.path.join(model_dir, "logs", "training_log.jsonl")) as f:
            epochs = [json.loads(line) for line in f]
        epoch_step_s = [e["seconds"] / 3 for e in epochs[1:]]
        print(f"  losses {curve}; checkpoints {files}; epoch-clock seconds per step "
              f"(epoch 2; epoch 3, whose first step also waits on the resumed run's "
              f"first label-map load) {epoch_step_s}")
        summary = dict(loss_curve=curve, launches=launches, seconds=train_s,
                       epoch_step_s=epoch_step_s, h5_exported=h5)
        summary.update(gradient_check(resumed["model"], root))
    return {"launches": launches, "summary": summary}


def gradient_check(trained, root):
    """One step's loss and parameter gradient, bf16 kernel path vs the plain
    float32 autograd of UNet3D.forward_train, on one generated batch and the
    trained weights; then a timed and profiled warm step, and WARM_STEPS
    consecutive whole steps of make_train_step."""
    from synthsr_tpu_torch.models.unet import UNet3D
    from synthsr_tpu_torch.synth.labels_to_image import GenerationConfig, build_generator
    from synthsr_tpu_torch.synth.sampling import make_gmm_sampler
    from synthsr_tpu_torch.train.training import forward_loss, generate_batch, make_train_step
    from synthsr_tpu_torch.utils.finite_guard import adam_init
    from synthsr_tpu.io.labels import get_list_labels
    from synthsr_tpu.io.volume import load_volume
    from synthsr_tpu.utils.misc import get_padding_margin

    phase("one train step: kernel path (bf16) vs plain float32 autograd")
    dev = torch.device("cuda")
    model = UNet3D(in_channels=4).to(dev)
    model.load_state_dict(trained.state_dict())
    labels, n_neutral = get_list_labels(
        label_list=os.path.join(root, "generation_labels.npy"), FS_sort=True)
    lab = load_volume(os.path.join(root, "labels", "subject0.nii.gz"), dtype="int")
    cfg = GenerationConfig(
        labels_shape=list(lab.shape), input_channels=[False, True, True], output_channel=[0],
        generation_labels=labels, n_neutral_labels=n_neutral, atlas_res=[1.0, 1.0, 1.0],
        output_shape=128, output_div_by_n=32, padding_margin=get_padding_margin(128, 96),
        flipping=True, aff=np.eye(4), scaling_bounds=0.1, rotation_bounds=8,
        shearing_bounds=0.01, translation_bounds=False, nonlin_std=2.0,
        nonlin_shape_factor=0.03125, data_res=np.load(os.path.join(root, "data_res.npy")),
        thickness=np.load(os.path.join(root, "thickness.npy")), downsample=True,
        build_reliability_maps=True, bias_field_std=0.2, bias_shape_factor=0.03125)
    generator = build_generator(cfg)
    sampler = make_gmm_sampler(len(labels), np.load(os.path.join(root, "prior_means.npy")),
                               np.load(os.path.join(root, "prior_stds.npy")), "normal",
                               n_channels=3)
    gen = torch.Generator(device=dev).manual_seed(1)
    batch = [torch.as_tensor(lab[None, ..., None], device=dev)]
    image, target = generate_batch(generator, sampler, gen, batch)
    require(image.shape == (1, 128, 128, 128, 4) and target.shape == (1, 128, 128, 128, 1),
            (image.shape, target.shape))
    require(bool(torch.isfinite(image).all() and torch.isfinite(target).all()), "non-finite pair")
    params = list(model.parameters())
    kw = dict(metrics="l1", loss_cropping=96, residual_indices=[2])
    loss_k, _ = forward_loss(model, image, target, fast=True, **kw)
    grads_k = torch.autograd.grad(loss_k, params)
    loss_p, _ = forward_loss(model, image, target, fast=False, **kw)
    grads_p = torch.autograd.grad(loss_p, params)
    flat = lambda gs: torch.cat([g.reshape(-1) for g in gs])  # noqa: E731
    rel_grad = float((flat(grads_k) - flat(grads_p)).norm() / flat(grads_p).norm())
    rel_loss = abs(float(loss_k.detach()) - float(loss_p.detach())) / abs(float(loss_p.detach()))
    leaf_rel = {n: float((a - b).norm() / b.norm())
                for (n, p), a, b in zip(model.named_parameters(), grads_k, grads_p)
                if p.dim() == 5 and p.shape[-1] == 3}
    worst = sorted(leaf_rel, key=leaf_rel.get, reverse=True)
    print(f"  loss kernel {float(loss_k.detach()):.6f} plain {float(loss_p.detach()):.6f}: relative "
          f"{rel_loss:.3e} (bound {LOSS_BOUND:.0e}); gradient relative L2 {rel_grad:.3e} "
          f"(bound {GRAD_BOUND:.0e}); worst 3³-conv weight gradient relative L2 "
          f"{leaf_rel[worst[0]]:.3e} (bound {LEAF_BOUND:g})")
    for n in worst:
        print(f"    {n:24s} {leaf_rel[n]:.3e}")
    del grads_p, loss_p
    torch.cuda.empty_cache()

    phase("where a warm train step's time goes (CUDA events, then torch.profiler)")
    spans = {}

    def timed(name, fn):
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        out = fn()
        e1.record()
        torch.cuda.synchronize()
        spans[name] = e0.elapsed_time(e1)
        return out

    def forward():
        im, tg = timed("generator", lambda: generate_batch(generator, sampler, gen, batch))
        return timed("forward+loss", lambda: forward_loss(model, im, tg, fast=True, **kw))[0]

    def backward(loss):
        timed("backward", lambda: torch.autograd.grad(loss, params))

    for _ in range(2):
        backward(forward())
    print(f"  ms: {spans}")
    kernel_ms = {}
    for part in ("forward", "backward"):
        loss = None if part == "forward" else forward()
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            if part == "forward":
                forward()
            else:
                backward(loss)
        rows = sorted(((getattr(ev, "self_device_time_total", 0) or 0) / 1e3, ev.key[:70])
                      for ev in prof.key_averages())
        total = sum(ms for ms, _ in rows)
        convs = {k: ms for ms, k in rows if "conv3d_" in k and ms > 0}
        kernel_ms[part] = dict(total=total, conv_kernels=convs,
                               top=[(k, ms) for ms, k in rows[::-1][:8]])
        print(f"  profiler, {part} of a warm step (generator included in forward): device "
              f"{total:.1f} ms; conv kernels {convs if convs else 'not measured'}")
        for ms, k in rows[::-1][:8]:
            print(f"    {ms:8.2f} ms  {k}")

    phase(f"{WARM_STEPS} consecutive warm train steps (generator, forward, backward, Adam, "
          f"gate), CUDA events")
    step = make_train_step(model, generator, sampler, 1e-4, **kw)
    opt = adam_init(params)
    for _ in range(2):
        opt, loss = step(opt, gen, batch)
    events = [torch.cuda.Event(enable_timing=True) for _ in range(WARM_STEPS + 1)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    events[0].record()
    for e in events[1:]:
        opt, loss = step(opt, gen, batch)
        e.record()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / WARM_STEPS
    step_ms = [a.elapsed_time(b) for a, b in zip(events, events[1:])]
    print(f"  ms per step: median {float(np.median(step_ms)):.3f}, min {min(step_ms):.3f}, "
          f"max {max(step_ms):.3f}; host wall {wall_ms:.3f} per step; all {step_ms}")
    require(bool(torch.isfinite(loss)), "non-finite loss in the warm steps")

    require(np.isfinite(rel_grad) and rel_grad <= GRAD_BOUND, rel_grad)
    require(np.isfinite(rel_loss) and rel_loss <= LOSS_BOUND, rel_loss)
    require(all(np.isfinite(v) and v <= LEAF_BOUND for v in leaf_rel.values()), leaf_rel)
    return dict(grad_rel_l2=rel_grad, loss_rel=rel_loss, leaf_grad_rel_l2=leaf_rel,
                span_ms=spans, profiler_ms=kernel_ms, warm_step_ms=step_ms,
                warm_step_wall_ms=wall_ms)


def phantom(shape, zooms, ct, rng):
    """Ellipsoids of random intensity plus noise, in HU for a CT."""
    grid = np.meshgrid(*[(np.arange(n) - n / 2) * z for n, z in zip(shape, zooms)],
                       indexing="ij", sparse=True)
    vol = np.zeros(shape, np.float32)
    for _ in range(6):
        c = rng.uniform(-30, 30, 3)
        r = rng.uniform(20, 80, 3)
        inside = sum(((g - ci) / ri) ** 2 for g, ci, ri in zip(grid, c, r)) < 1
        vol[inside] = rng.uniform(200, 800) if not ct else rng.uniform(-100, 1500)
    vol += rng.normal(0, 20, shape).astype(np.float32)
    return vol


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        sys.exit(1)
    from synthsr_tpu_torch.cli import predict
    from synthsr_tpu_torch.ops import conv_cf, cuda_build
    from synthsr_tpu_torch.models.weights import random_variables, variables_to_state_dict

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    phase("environment")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    kind = torch.cuda.get_device_name(0)
    print(f"  python {sys.version.split()[0]}  torch {torch.__version__}  cuda {torch.version.cuda}")
    print(f"  device {kind}  count {torch.cuda.device_count()}  nvidia-smi: {smi}")

    phase("build")
    seconds = conv_cf.build_kernels()
    log = (cuda_build.BUILD_DIR / cuda_build.source_hash() / "build.log").read_text()
    regs = sorted({line.split(":", 1)[1].strip() for line in log.splitlines()
                   if "registers" in line})
    print(f"  nvcc build {seconds:.1f} s (0 = reused); ptxas: {regs}")

    phase("kernels vs plain")
    gen = torch.Generator(device="cuda").manual_seed(0)
    checks = check_kernels(conv_cf, gen)

    phase("H-wgrad vs plain")
    checks += check_wgrad(conv_cf, gen)

    phase("main path: predict")
    rng = np.random.default_rng(0)
    with tempfile.TemporaryDirectory() as tmp:
        weights = os.path.join(tmp, "weights.pt")
        torch.save(variables_to_state_dict(random_variables(seed=0)), weights)
        mr_dir, out_dir = os.path.join(tmp, "mr"), os.path.join(tmp, "out")
        os.makedirs(mr_dir)
        inputs = {}
        for fname, shape, zooms, ct in VOLUMES:
            path = os.path.join(tmp if ct else mr_dir, fname)
            vol = phantom(shape, zooms, ct, rng)
            aff = np.diag(list(zooms) + [1.0])
            predict.save_volume(vol, aff, None, path)
            inputs[fname] = (path, vol, aff, shape, zooms)

        warm = predict.Predictor(model_path=weights)
        t256 = inputs["t1_256.nii.gz"]
        warm.predict_volume(t256[1], t256[2])  # unmeasured warm-up
        torch.cuda.synchronize()

        conv_cf.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        predict.main([mr_dir, out_dir, "--model", weights])
        ct_in = inputs["head_ct.nii.gz"][0]
        ct_out = os.path.join(out_dir, "head_ct_SynthSR.nii.gz")
        predict.main([ct_in, ct_out, "--ct", "--model", weights])
        torch.cuda.synchronize()
        main_s = time.perf_counter() - t0
        launches = dict(conv_cf.LAUNCHES)
        peak = torch.cuda.max_memory_allocated()
        n = len(VOLUMES)
        print(f"  main(): {n} volumes in {main_s:.2f} s (incl. NIfTI I/O, weight load); "
              f"launches {launches}; peak allocated {peak / 2 ** 30:.2f} GiB")
        require(launches == {"first": 2 * n, "fwd": 34 * n, "wgrad": 0}, launches)

        for fname, (_, _, _, shape, zooms) in inputs.items():
            out = os.path.join(out_dir, fname.replace(".nii.gz", "_SynthSR.nii.gz"))
            pred, aff, _ = predict.load_volume(out, im_only=False)
            want = tuple(int(np.ceil(s * z)) for s, z in zip(shape, zooms))
            require(pred.shape == want, (fname, pred.shape, want))
            require(np.allclose(np.diag(aff)[:3], 1.0, atol=1e-6), (fname, aff))
            require(np.all(np.isfinite(pred)) and pred.min() >= 0 and pred.max() <= 128, fname)
            require(0 < pred.mean() < 128, (fname, pred.mean()))
            print(f"  {fname}: out {pred.shape} 1 mm RAS, range [{pred.min():.2f}, "
                  f"{pred.max():.2f}], mean {pred.mean():.2f}")

        phase("warm seconds per volume; fast network vs plain float32 forward")
        timings = {}
        for fname in ("t1_256.nii.gz", "flair_clinical.nii.gz"):
            _, vol, aff, _, _ = inputs[fname]
            x, _, _ = warm.prepare(vol, aff)
            net_ms = cuda_ms(lambda: warm.network(x), 2)
            secs = []
            for _ in range(2):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                warm.predict_volume(vol, aff)
                torch.cuda.synchronize()
                secs.append(time.perf_counter() - t0)
            with torch.no_grad():
                fast = warm.network(x)
                plain = 0.5 * warm.model(x) + 0.5 * torch.flip(warm.model(torch.flip(x, [2])), [2])
            rel = float((fast - plain).norm() / plain.norm())
            max_out = float(255 * (fast - plain).abs().max())
            timings[fname] = dict(padded=list(x.shape[2:]), predict_volume_s=secs,
                                  network_tta_ms=net_ms, net_rel_l2=rel)
            print(f"  {fname}: padded {tuple(x.shape[2:])}  predict_volume {secs} s  "
                  f"network (2 forwards) {net_ms:.1f} ms  vs plain: relative L2 {rel:.3e} "
                  f"(bound {NET_BOUND:.0e}), max |diff| x255 = {max_out:.3f}")
            require(np.isfinite(rel) and rel <= NET_BOUND, (fname, rel))
            del x, fast, plain

    train = train_phase(conv_cf, rng)
    path_launches = {"predict": launches, "train": train["launches"]}

    kernels = []
    for kernel, source, replaces, also in (
            ("first", SOURCE, f"{PALLAS}:569", []),
            ("fwd", SOURCE, f"{PALLAS}:270", [f"{PALLAS}:920", f"{PALLAS}:1297"]),
            ("wgrad", WGRAD_SOURCE, f"{PALLAS}:1090", [f"{PALLAS}:1705"])):
        mine = [c for c in checks if c["kernel"] == kernel]
        timed = next(c for c in mine if c["shape"] == TIMED[kernel])
        kernels.append(dict(
            name=f"h_{kernel}", route="cuda", source=source, replaces=replaces,
            also_replaces=also, launches=sum(v[kernel] for v in path_launches.values()),
            launches_by_path={p: v[kernel] for p, v in path_launches.items()},
            max_abs_err=max(c["max_abs_err"] for c in mine), ms=timed["ms"],
            plain_ms=timed["plain_ms"], timed_shape=timed["shape"],
            checks=[{k: c[k] for k in ("shape", "fused", "rel_err", "ms", "plain_ms")}
                    for c in mine]))
    print(json.dumps({"timings": timings, "main_seconds": main_s,
                      "peak_allocated_bytes": peak, "train": train["summary"]}))
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
