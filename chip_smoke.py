"""GPU smoke run of the PyTorch port: builds the hand-written CUDA kernels,
holds each against its plain PyTorch version at the predict path's own
shapes, then drives ``synthsr_tpu_torch.cli.predict.main`` at full width
(24 features, 5 levels, flip TTA, seeded random weights) over three synthetic
volumes and checks what comes out.

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
NET_BOUND = 2e-2      # relative L2, bf16 fast TTA network output vs plain f32
SOURCE = "synthsr_tpu_torch/csrc/conv3d_cf.cu"
PALLAS = "synthsr_tpu/ops/conv_pallas.py"

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
]
TIMED = {"first": "1->24 @256^3", "fwd": "[24,48]->24 @256^3"}

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

    phase("main path")
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
        require(launches == {"first": 2 * n, "fwd": 34 * n}, launches)

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

    kernels = []
    for kernel, replaces, also in (("first", f"{PALLAS}:569", []),
                                   ("fwd", f"{PALLAS}:270", [f"{PALLAS}:920", f"{PALLAS}:1297"])):
        mine = [c for c in checks if c["kernel"] == kernel]
        timed = next(c for c in mine if c["shape"] == TIMED[kernel])
        kernels.append(dict(
            name=f"h_{kernel}", route="cuda", source=SOURCE, replaces=replaces,
            also_replaces=also, launches=launches[kernel],
            max_abs_err=max(c["max_abs_err"] for c in mine), ms=timed["ms"],
            plain_ms=timed["plain_ms"], timed_shape=timed["shape"],
            checks=[{k: c[k] for k in ("shape", "fused", "rel_err", "ms", "plain_ms")}
                    for c in mine]))
    print(json.dumps({"timings": timings, "main_seconds": main_s,
                      "peak_allocated_bytes": peak}))
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
