"""H-fwd-wg's design choices, compared on the card.  A variant is a copy of
synthsr_tpu_torch/csrc/conv3d_fwd_wg.cu with constants or lines changed,
built by nvcc into a library of its own (only the instances the rows use);
all are launched on the same bf16 inputs in turns (the list, then the list
reversed), each turn timed with CUDA events.  A variant that changes only
the schedule or the layout must give an output bit-equal to the wrapper's
(``conv_cf.conv3d_cf``); an ablation, which takes work out, is timed only.

    python3 tools/ab_fwd_wg_variants.py

Needs one CUDA GPU and nvcc.  Prints the card's name and power limit, each
library's registers and spills, then one line per (row, variant) with its
mean ms over the turns and its share of the row's bound.
"""

from __future__ import annotations

import sys
from pathlib import Path

import numpy as np
import torch
from ab_common import build_variants, device_line

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

CONFIGS = ("X(8, 4, 2) X(16, 4, 2) X(24, 4, 2) X(32, 4, 1) X(48, 2, 2) X(64, 2, 1) X(72, 2, 1) "
           "X(96, 2, 1) \\\n      X(128, 1, 1) X(144, 1, 1) X(192, 1, 1)")
USED = "X(24, 4, 2) X(48, 2, 2) X(96, 2, 1) X(192, 1, 1)"
WGMMA = "Wgmma<N>::mma(acc[zo][m], gmma_desc(cl + a_off[m] + o0, lbo, sbo), bd);"
TRANSPOSE = ("transpose_x4(src + 2u * ((rr * (TY + 3) + yy) * rowx + xx),\n"
             "                     dsts + 16u * (yy * rowc + xx + rr));")
STAGE_OUT = ("              so[((n * NZ + zo) * TY + y) * TX + x] =\n                  "
             "__float2bfloat16_rn(ch.apply(acc[zo][m][4 * j + 2 * hh + e], a.act));")
CLS = "constexpr int CLS = 5;"
WS6 = ("constexpr int WS = 4;", "constexpr int WS = 6;")
N24 = ("X(24, 4, 2)", "X(24, 2, 4)")
# (name, source substitutions, bit-equal to the wrapper's output)
VARIANTS = [
    ("as built", [], True),
    ("raw rows unpadded (4-way conflicts)", [("return tx + 16 + ((tx + 16) / 8 % 2 == 0 ? 8 : 0);",
                                              "return tx + 16;"),
                                             ("(TY + 3)", "(TY + 2)"),
                                             ("ty + 3, 1, 8)", "ty + 2, 1, 8)"),
                                             ("16ull * (ty + 3)", "16ull * (ty + 2)")], True),
    ("channels-last ring of 3", [(CLS, "constexpr int CLS = 3;")], True),
    ("weight ring of 6", [WS6], True),
    ("N 24: 2 M tiles a warpgroup, 4 planes", [N24], True),
    ("N 24: 2 M tiles, 4 planes, weight ring of 6", [N24, WS6], True),
    ("ELU by expf", [("__expf(v) - 1.f", "expf(v) - 1.f")], False),
    ("ablation: no transposes", [(TRANSPOSE, ";")], False),
    ("ablation: no wgmma", [(WGMMA, ";")], False),
    ("ablation: no wgmma, no transposes", [(WGMMA, ";"), (TRANSPOSE, ";")], False),
    ("ablation: no epilogue", [(STAGE_OUT, ";")], False),
]
# (source channels, C_out, spatial, epilogue): rows of chip_smoke.py, one per N instance
ROWS = [((24,), 24, (256, 256, 256), "bias+elu"), ((24, 48), 24, (256, 256, 256), "bias+elu"),
        ((48,), 48, (128, 128, 128), "bias+elu"),
        ((96,), 96, (64, 64, 64), "bias+elu"), ((192,), 192, (32, 32, 32), "bias+elu"),
        ((128,), 64, (32, 32, 32), "dx")]
REPS = 5


def build():
    """One library per variant (only the instances the rows use); returns
    {name: CDLL}."""
    built = build_variants("conv3d_fwd_wg.cu",
                           [[(CONFIGS, USED + " X(64, 2, 1)"), *subs] for _, subs, _ in VARIANTS],
                           ("conv3d_fwd_wg_launch", "conv3d_fwd_wg_config"))
    libs = {}
    for (name, _, _), (lib, regs) in zip(VARIANTS, built):
        print(f"{name}: {regs}", flush=True)
        libs[name] = lib
    return libs


def main():
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA GPU")
    import chip_smoke
    from synthsr_tpu_torch.ops import conv_cf

    print(f"device: {device_line()}", flush=True)
    libs = build()
    gen = torch.Generator(device="cuda").manual_seed(0)
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    for cins, cout, spatial, fused in ROWS:
        kw = chip_smoke.kernel_inputs(conv_cf, gen, cins, cout, spatial, fused, torch.bfloat16)
        srcs = kw["x"] if isinstance(kw["x"], list) else [kw["x"]]
        pc = kw["w"] if isinstance(kw["w"], conv_cf.PackedConv) else \
            conv_cf.pack_conv(kw["w"], torch.bfloat16, cins)
        want = conv_cf.conv3d_cf(**kw)
        plan = conv_cf.wg_plan(cout)
        d, h, w = spatial
        bias = kw.get("bias")
        bias = None if bias is None else bias.to(torch.bfloat16).float().contiguous()
        out = torch.empty_like(want)
        stream = torch.cuda.current_stream().cuda_stream

        def launch(lib):
            mtw = lib.conv3d_fwd_wg_config(plan.n) // 16  # the variant's own instance
            tx = 32 if mtw >= 2 else 16
            return lib.conv3d_fwd_wg_launch(
                srcs[0].data_ptr(), cins[0], srcs[1].data_ptr() if len(srcs) > 1 else None,
                cins[1] if len(srcs) > 1 else 0, d, h, w, pc.wg.data_ptr(), cout, plan.n, tx,
                128 * mtw // tx, None if bias is None else bias.data_ptr(), None, None,
                1 if fused != "dx" else 0, n_sm, out.data_ptr(), stream)

        fits = [name for name in libs if launch(libs[name]) == 0]  # else its rings do not fit
        times = {name: [] for name in fits}
        equal = {}
        for order in (fits, fits[::-1]):
            for name in order:
                times[name].append(chip_smoke.cuda_ms(lambda: launch(libs[name]), REPS))
                equal[name] = bool(torch.equal(out, want))
        vox = int(np.prod(spatial))
        bound_ms, _ = chip_smoke.bound(2 * 27 * sum(cins) * cout * vox,
                                       2 * (sum(cins) + cout) * vox + 4 * 27 * sum(cins) * cout)
        for name, subs, same in VARIANTS:
            if name not in times:
                print(f"{sum(cins):4d}->{cout:<4d} @{spatial} {name:36s} does not fit", flush=True)
                continue
            ms = float(np.mean(times[name]))
            tag = ("bit-equal" if equal[name] else "DIFFERS") if same else "timed only"
            print(f"{sum(cins):4d}->{cout:<4d} @{spatial} {name:36s} {ms:.4f} ms "
                  f"({times[name][0]:.4f}, {times[name][1]:.4f}) {bound_ms / ms:6.1%} of bound "
                  f"{tag}", flush=True)
            if same and not equal[name]:
                sys.exit(f"{name} changed the output")
        del kw, srcs, pc, want, out
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
