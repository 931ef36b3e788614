"""How far the float32 conv kernels and their plain float32 versions each sit
from float64, at the float32 rows of ``chip_smoke.py``'s kernel checks.

``chip_smoke.py`` holds each kernel against its plain version (float32
``F.conv3d`` / ``conv3d_weight``, TF32 off) within ``F32_BOUND``; this script
says which of the two carries the error.  For every float32 row of
``SHAPES`` (inputs from ``chip_smoke.kernel_inputs``) and of
``WGRAD_SHAPES`` (seeded normal x and g) it prints max |a - b| / max |b| of
kernel vs float64, plain vs float64 and kernel vs plain, with float64 the
same function on the same float32 inputs in double precision.

    python3 tools/f32_accuracy.py

Needs one CUDA GPU and nvcc.  Prints the card's name and power limit first.
"""

from __future__ import annotations

import subprocess
import sys
from pathlib import Path

import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as smoke  # noqa: E402
from synthsr_tpu_torch.ops import conv_cf  # noqa: E402


def conv_f64(kw):
    """``conv3d_cf_reference``'s function in float64 (no ``head``: the
    float32 rows have none)."""
    srcs = kw["x"] if isinstance(kw["x"], list) else [kw["x"]]
    w = kw["w"].w if isinstance(kw["w"], conv_cf.PackedConv) else kw["w"]
    y = F.conv3d(torch.cat(srcs).double()[None], w.double().permute(4, 3, 0, 1, 2),
                 padding=1)[0]
    if kw.get("bias") is not None:
        y = y + kw["bias"].double().reshape(-1, 1, 1, 1)
    if kw.get("activation") == "elu":
        y = torch.where(y > 0, y, torch.exp(y) - 1)
    elif kw.get("activation") == "leaky":
        y = torch.where(y >= 0, y, 0.2 * y)
    if kw.get("post") is not None:
        p = kw["post"].double()
        y = y * p[0].reshape(-1, 1, 1, 1) + p[1].reshape(-1, 1, 1, 1)
    return y


def rel(a, b):
    return float((a.double() - b.double()).abs().max() / b.double().abs().max())


def main():
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA GPU")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    conv_cf.build_kernels()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    print(f"  {'row':30s} {'kernel vs f64':>14s} {'plain vs f64':>14s} {'kernel vs plain':>16s}")
    for name, kernel, cins, cout, spatial, fused, dtype in smoke.SHAPES:
        if dtype != torch.float32:
            continue
        kw = smoke.kernel_inputs(conv_cf, gen, cins, cout, spatial, fused, dtype)
        got, plain, truth = conv_cf.conv3d_cf(**kw), conv_cf.conv3d_cf_reference(**kw), conv_f64(kw)
        print(f"  {kernel:8s} {name:30s} {rel(got, truth):14.3e} {rel(plain, truth):14.3e} "
              f"{rel(got, plain):16.3e}", flush=True)
        del kw, got, plain, truth
    for ci, co, n, dtype in smoke.WGRAD_SHAPES:
        if dtype != torch.float32:
            continue
        x = torch.randn(ci, n, n, n, device=dev, generator=gen)
        g = torch.randn(co, n, n, n, device=dev, generator=gen)
        got, plain = conv_cf.conv3d_cf_wgrad(x, g), conv_cf.conv3d_cf_wgrad_reference(x, g)
        truth = torch.nn.grad.conv3d_weight(x.double()[None], (co, ci, 3, 3, 3), g.double()[None],
                                            padding=1).permute(2, 3, 4, 1, 0)
        print(f"  wgrad_x3 {f'({ci},{co}) @{n}^3 f32':30s} {rel(got, truth):14.3e} "
              f"{rel(plain, truth):14.3e} {rel(got, plain):16.3e}", flush=True)
        del x, g, got, plain, truth
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
