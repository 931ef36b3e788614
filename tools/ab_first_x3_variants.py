"""H-first-x3's design choices, compared on the card.  A variant is the
kernel with a number of planes per block (the launcher's ``nz`` argument,
which the wrapper picks with ``conv_cf.first_x3_planes``) or a copy of
synthsr_tpu_torch/csrc/conv3d_first_x3.cu with one constant or line changed,
built by nvcc into a library of its own; all are launched on the same float32
input in turns (the list, then the list reversed), each turn timed with CUDA
events.  A variant that changes only the schedule must give an output
bit-equal to the wrapper's (``conv_cf.conv3d_cf``); an ablation, which takes
work out, is timed only.  A ``zero_`` of the output tensor is timed beside
them: the store path's fill rate.

    python3 tools/ab_first_x3_variants.py

Needs one CUDA GPU and nvcc.  Prints the card's name and power limit, each
library's registers and spills, then one line per (shape, variant) with its
mean ms over the turns.
"""

from __future__ import annotations

import sys
from pathlib import Path

import torch
from ab_common import build_variants, device_line

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

LB = "__launch_bounds__(X1_THREADS, CIN == 2 && NT == 4 ? 2 : 3)"
STAGED = "return CIN == 2 || !vec;"
SMALL = """#pragma unroll
          for (int jn = 0; jn < NT; ++jn) tc::mma_tf32(acc[jn], as, bb[jn][s][0], bb[jn][s][1]);
#pragma unroll
          for (int jn = 0; jn < NT; ++jn) tc::mma_tf32(acc[jn], ab, bs[jn][s][0], bs[jn][s][1]);
"""
BIG = """#pragma unroll
          for (int jn = 0; jn < NT; ++jn) tc::mma_tf32(acc[jn], ab, bb[jn][s][0], bb[jn][s][1]);
"""
# (name, source substitutions, planes per block or None for the wrapper's, bit-equal)
VARIANTS = [
    ("as built (the wrapper's planes)", [], None, True),
    ("1 plane per block", [], 1, True),
    ("2 planes per block", [], 2, True),
    ("4 planes per block", [], 4, True),
    ("8 planes per block", [], 8, True),
    ("2 blocks/SM", [(LB, "__launch_bounds__(X1_THREADS, 2)")], None, True),
    ("outputs always staged, 16-byte stores", [(STAGED, "return true;")], None, True),
    ("outputs from registers also at C_in 2", [(STAGED, "return !vec;")], None, True),
    ("4 blocks/SM", [(LB, "__launch_bounds__(X1_THREADS, 4)")], None, True),
    ("ELU by expf", [("__expf(v)", "expf(v)")], None, False),
    ("ablation: plain TF32 (big x big only)", [(SMALL + BIG, BIG)], None, False),
    ("ablation: no products (halo and stores)", [(SMALL + BIG, "")], None, False),
]
# (C_in, C_out, spatial, activation): the first-conv rows of chip_smoke.py
SHAPES = [(1, 24, (128, 128, 128), "elu"), (1, 24, (192, 224, 192), "elu"),
          (1, 32, (64, 64, 64), "leaky"), (2, 24, (192, 256, 160), "elu"),
          (1, 24, (192, 224, 190), "elu")]
REPS = 20
ACT = {"elu": 1, "leaky": 3}


def main():
    if not torch.cuda.is_available():
        sys.exit("ab_first_x3_variants: no CUDA device")
    from synthsr_tpu_torch.ops import conv_cf

    print(device_line(), flush=True)
    conv_cf.build_kernels()
    libs, regs = zip(*build_variants("conv3d_first_x3.cu", [v[1] for v in VARIANTS],
                                     ("conv3d_first_x3_launch",)))
    for (name, _, _, _), r in zip(VARIANTS, regs):
        print(f"  {name:40s} ptxas {r}", flush=True)
    dev = torch.device("cuda")
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    gen = torch.Generator(device=dev).manual_seed(0)
    order = list(range(len(VARIANTS))) + list(range(len(VARIANTS)))[::-1]
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)

    def timed(fn):
        e0.record()
        for _ in range(REPS):
            fn()
        e1.record()
        torch.cuda.synchronize()
        return e0.elapsed_time(e1) / REPS

    for cin, cout, spatial, act in SHAPES:
        d, h, wd = spatial
        x = torch.randn(cin, *spatial, device=dev, generator=gen)
        w = torch.randn(3, 3, 3, cin, cout, device=dev, generator=gen) * (2 / (27 * cin)) ** 0.5
        bias = torch.randn(cout, device=dev, generator=gen) * 0.1
        pc = conv_cf.pack_conv(w, torch.float32)
        want = conv_cf.conv3d_cf(x, pc, bias=bias, activation=act)
        out = torch.empty_like(want)
        stream = torch.cuda.current_stream().cuda_stream
        default_nz = conv_cf.first_x3_planes(cin, d, h, wd, n_sm)
        times = [[] for _ in VARIANTS]
        for i in order:
            name, _, nz, equal = VARIANTS[i]

            def launch():
                err = libs[i].conv3d_first_x3_launch(
                    x.data_ptr(), cin, d, h, wd, nz or default_nz, pc.first_frags.data_ptr(),
                    cout, bias.data_ptr(), None, ACT[act], int(wd % 4 == 0), out.data_ptr(),
                    stream)
                if err:
                    raise RuntimeError(f"{name}: launch failed, CUDA error {err}")

            launch()
            torch.cuda.synchronize()
            if equal and not torch.equal(out, want):
                raise RuntimeError(f"{name}: output differs from the wrapper's")
            times[i].append(timed(launch))
        zero_ms = timed(out.zero_)
        label = f"{cin}->{cout} @{'x'.join(map(str, spatial))} {act} ({default_nz} planes)"
        for (name, _, _, _), ms in zip(VARIANTS, times):
            print(f"  {label:44s} {name:40s} {sum(ms) / len(ms):.4f} ms  (turns {ms})",
                  flush=True)
        print(f"  {label:44s} {'out.zero_() (' + str(out.numel() * 4) + ' bytes)':40s} "
              f"{zero_ms:.4f} ms", flush=True)
        del x, out, want


if __name__ == "__main__":
    main()
