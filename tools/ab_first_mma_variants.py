"""H-first-mma's design choices, compared on the card.  Each variant is a copy
of synthsr_tpu_torch/csrc/conv3d_first_mma.cu with one constant or line
changed, built by nvcc into a library of its own (the kernel itself keeps no
run-time knob); all are launched on the same bf16 input in turns (the list,
then the list reversed), each turn timed with CUDA events.  A variant that
changes only the schedule must give an output bit-equal to the wrapper's
(``conv_cf.conv3d_cf``); an ablation, which takes work out, is timed only.
A ``zero_`` of the output tensor is timed beside them: the store path's fill
rate.

    python3 tools/ab_first_mma_variants.py

Needs one CUDA GPU and nvcc.  Prints the card's name and power limit, each
variant's registers and spills, then one line per (shape, variant) with its
mean ms over the turns.
"""

from __future__ import annotations

import sys
from pathlib import Path

import torch
from ab_common import build_variants, device_line

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

NZ = "constexpr int FF_NZ = 8;"
LB = "__launch_bounds__(FF_THREADS, 5)"
MMA = """          tc::mma_bf16(acc[0], af[0][s], b0, b1);
          tc::mma_bf16(acc[1], af[1][s], b0, b1);
"""
# (name, substitutions, activation, bit-equal to the wrapper)
VARIANTS = [
    ("as built: 8 planes, 5 blocks/SM", [], "elu", True),
    ("1 plane per block", [(NZ, "constexpr int FF_NZ = 1;")], "elu", True),
    ("2 planes per block", [(NZ, "constexpr int FF_NZ = 2;")], "elu", True),
    ("4 planes per block", [(NZ, "constexpr int FF_NZ = 4;")], "elu", True),
    ("4 blocks/SM", [(LB, "__launch_bounds__(FF_THREADS, 4)")], "elu", True),
    ("6 blocks/SM", [(LB, "__launch_bounds__(FF_THREADS, 6)")], "elu", True),
    ("no activation", [], None, True),
    ("ablation: no gathers or mma (halo and stores)", [(MMA, "")], "elu", False),
]
SHAPES = [(1, (256, 256, 256)), (2, (256, 256, 256)), (2, (192, 256, 160))]
REPS = 20
ACT = {None: 0, "elu": 1}


def main():
    if not torch.cuda.is_available():
        sys.exit("ab_first_mma_variants: no CUDA device")
    from synthsr_tpu_torch.ops import conv_cf

    print(device_line(), flush=True)
    conv_cf.build_kernels()
    libs, regs = zip(*build_variants("conv3d_first_mma.cu", [v[1] for v in VARIANTS],
                                     ("conv3d_first_mma_launch",)))
    for (name, _, _, _), r in zip(VARIANTS, regs):
        print(f"  {name:46s} ptxas {r}", flush=True)
    dev = torch.device("cuda")
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

    for cin, spatial in SHAPES:
        x = torch.randn(cin, *spatial, device=dev, generator=gen).to(torch.bfloat16)
        w = torch.randn(3, 3, 3, cin, 24, device=dev, generator=gen) * (2 / (27 * cin)) ** 0.5
        bias = (torch.randn(24, device=dev, generator=gen) * 0.1).to(torch.bfloat16).float()
        pc = conv_cf.pack_conv(w, torch.bfloat16)
        want = {a: conv_cf.conv3d_cf(x, pc, bias=bias, activation=a) for a in ACT}
        out = torch.empty_like(want["elu"])
        stream = torch.cuda.current_stream().cuda_stream
        d, h, wd = spatial
        times = [[] for _ in VARIANTS]
        for i in order:
            name, _, act, equal = VARIANTS[i]

            def launch():
                err = libs[i].conv3d_first_mma_launch(
                    x.data_ptr(), cin, d, h, wd, pc.first_frags.data_ptr(), 24,
                    bias.data_ptr(), None, ACT[act], 1, out.data_ptr(), stream)
                if err:
                    raise RuntimeError(f"{name}: launch failed, CUDA error {err}")

            launch()
            torch.cuda.synchronize()
            if equal and not torch.equal(out, want[act]):
                raise RuntimeError(f"{name}: output differs from the wrapper's")
            times[i].append(timed(launch))
        zero_ms = timed(out.zero_)
        label = f"{cin}->24 @{'x'.join(map(str, spatial))}"
        for (name, _, _, _), ms in zip(VARIANTS, times):
            print(f"  {label:20s} {name:46s} {sum(ms) / len(ms):.4f} ms  (turns {ms})",
                  flush=True)
        print(f"  {label:20s} {'out.zero_() (' + str(out.numel() * 2) + ' bytes)':46s} "
              f"{zero_ms:.4f} ms", flush=True)
        del x, out, want


if __name__ == "__main__":
    main()
