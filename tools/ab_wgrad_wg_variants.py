"""H-wgrad-wg's design choices and its ring protocol, compared on the card.  A
variant is a copy of synthsr_tpu_torch/csrc/conv3d_wgrad_wg.cu with lines
changed (the schedule), taken out (an ablation: no products, loads,
transposes, fences or drains) or slowed (a stress run: one consumer
warpgroup, or the producer, made to lag; the odd g planes issued before the
even planes before them, so that a warpgroup's boxes land after the other's),
built by nvcc into a library of its own (tools/ab_common.py).  Each row also
runs the built kernel with the stacked layout on and off (where C_out fits
it), with the plan's split count halved and doubled, on x and g swapped
(the taps mirrored and the channels transposed after it, where C_out is not a
multiple of 8) and, beside it, H-wgrad-mma (``conv3d_cf_wgrad(...,
kernel="wgrad_mma")``).
All are launched on the same bf16 inputs in turns (the list, then the list
reversed), each turn timed with CUDA events; every run but an ablation must
agree with the wrapper's output within 1e-4 of its largest value, an
ablation is timed only.  A run that breaks the rings' protocol traps (CUDA
error 719) or disagrees, and ends the tool.

    python3 tools/ab_wgrad_wg_variants.py

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

TRANSPOSE = ("transpose_x4(src + 2u * ((rr * (TY + 2) + yy) * rowx + xx),\n"
             "                       dsts + 16u * (yy * rowc + xx + rr));")
A_LOADS = [("if (load_a) tc::ldsm_x4(af[c & 1], gb + (r0 + a_row) * gy + 2u * c0);", ";"),
           ("if (load_b) tc::ldsm_x4(bf[c & 1], gb + r0 * gy + 2u * c0);", ";")]
STEP_WAIT = "wg_wait<1>();  // the step before the last one has retired: its A is free"
PLANE_WAIT = "wg_wait<0>();  // the plane's products have read its slots: release them"
X_LOAD = """mbar_expect_tx(bar(RAW_FULL, rs), xstage);
          tma_load_4d(raw0 + rs * xstage, &xmap, x0 - 8, y0 - 1, za - 1 + i, 8 * cg,
                      bar(RAW_FULL, rs));"""
G_LOAD = """mbar_expect_tx(full, gbytes);
          tma_load_4d(g0 + sl * gstage, &gmap, x0, co0, y0 - (STACK ? 1 : 0), z, full);"""
STEP_FENCE = """        wg_fence();
#pragma unroll
        for (int dz = 0; dz < 3; ++dz) {"""
NO_WGMMA = [("__device__ __forceinline__ void wgmma_rs24(float* d, const uint32_t* a, uint64_t b) {",
             "__device__ __forceinline__ void wgmma_rs24(float* d, const uint32_t* a, uint64_t b) {\n"
             "  return;")]
# the producer holds each even g plane of a run until the odd plane after it is issued
ODD_FIRST = [
    ("        auto load_g = [&](int k, int z) {",
     "        int held = -1;\n        auto load_g = [&](int k, int z) {"),
    ("""            load_g(gs, za + i - 2);
            ++gs;
          }
        }
""", """            if (gs & 1) {
              load_g(gs, za + i - 2);
              if (held >= 0) load_g(gs - 1, held);
              held = -1;
            } else {
              held = za + i - 2;
            }
            ++gs;
          }
        }
        if (held >= 0) load_g(gs - 1, held);
""")]
CONSUMER_PLANE = "      if ((gs & 1) != cw) continue;"
G_UNPADDED = [("{ return tx + (tx / 8 % 2 == 0 ? 8 : 0); }", "{ return tx; }")]
RING = "constexpr int {0} = {1};"
VARIANTS = [
    ("as built", []),
    ("raw x ring of 4", [(RING.format("RS", 3), RING.format("RS", 4))]),
    ("channels-last ring of 8", [(RING.format("CLS", 6), RING.format("CLS", 8))]),
    ("g ring of 4", [(RING.format("GS", 3), RING.format("GS", 4))]),
    ("g rows unpadded (A loads conflict)", G_UNPADDED),
    ("three A buffers, two steps in flight",
     [(STEP_WAIT, "wg_wait<2>();"), ("af[c & 1]", "af[c % 3]"), ("bf[c & 1]", "bf[c % 3]"),
      ("uint32_t af[2][4] = {{0u, 0u, 0u, 0u}, {0u, 0u, 0u, 0u}};", "uint32_t af[3][4] = {};"),
      ("uint32_t bf[2][4] = {{0u, 0u, 0u, 0u}, {0u, 0u, 0u, 0u}};", "uint32_t bf[3][4] = {};")]),
    ("stress: odd g planes issued first", ODD_FIRST),
    ("stress: warpgroup 0 slowed", [(CONSUMER_PLANE,
                                     CONSUMER_PLANE + "\n      if (cw == 0) __nanosleep(2000);")]),
    ("stress: warpgroup 1 slowed", [(CONSUMER_PLANE,
                                     CONSUMER_PLANE + "\n      if (cw == 1) __nanosleep(2000);")]),
    ("stress: g loads slowed", [(G_LOAD, "__nanosleep(1000);\n          " + G_LOAD)]),
    ("ablation: no wgmma", NO_WGMMA),
    ("ablation: no wgmma, odd g planes first", NO_WGMMA + ODD_FIRST),
    ("ablation: no drain at a plane's end", [(PLANE_WAIT, "wg_wait<1>();")]),
    ("ablation: no fence a step", [(STEP_FENCE, STEP_FENCE.replace("wg_fence();", ";"))]),
    ("ablation: no x loads", [(X_LOAD, "mbar_arrive(bar(RAW_FULL, rs));")]),
    ("ablation: no g loads", [(G_LOAD, "mbar_arrive(full);")]),
    ("ablation: no transposes", [(TRANSPOSE, ";")]),
    ("ablation: no A loads", A_LOADS),
]
# (ci, co, spatial): the train step's rows of each layout and tile width, the critic's
# first and the penalty's last
ROWS = [(24, 24, 128), (48, 24, 128), (4, 24, 128), (96, 48, 64), (192, 96, 32),
        (384, 192, 16), (384, 384, 8), (1, 32, 128), (32, 1, 128)]
REPS = 5


def main():
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA GPU")
    import chip_smoke
    from synthsr_tpu_torch.ops import conv_cf

    print(f"device: {device_line()}", flush=True)
    conv_cf.build_kernels()
    built = build_variants("conv3d_wgrad_wg.cu", [subs for _, subs in VARIANTS],
                           ("conv3d_wgrad_wg_launch",), extra_sources=("conv3d_wgrad.cu",))
    libs = {}
    for (name, _), (lib, regs) in zip(VARIANTS, built):
        print(f"{name}: {regs}", flush=True)
        libs[name] = lib
    gen = torch.Generator(device="cuda").manual_seed(0)
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    dev = torch.device("cuda")
    stream = torch.cuda.current_stream().cuda_stream
    for ci, co, n in ROWS:
        x = torch.randn(ci, n, n, n, device=dev, generator=gen).to(torch.bfloat16)
        g = torch.randn(co, n, n, n, device=dev, generator=gen).to(torch.bfloat16)
        want = conv_cf.conv3d_cf_wgrad(x, g)
        plan = conv_cf.wgrad_wg_plan(ci, co, n, n, n, n_sm)
        swap = conv_cf.wgrad_wg_plan(co, ci, n, n, n, n_sm)
        splits = sorted({plan.n_split, max(1, plan.n_split // 2), 2 * plan.n_split})
        partial = torch.empty(max(max(splits) * 27 * -(-ci // 8) * 8 * plan.ct * plan.co_tiles,
                                  swap.n_split * 27 * -(-co // 8) * 8 * swap.ct * swap.co_tiles),
                              device=dev)
        dw = torch.empty_like(want)
        dws = torch.empty((3, 3, 3, co, ci), device=dev)

        def launcher(lib, stack, k):
            def run():
                err = lib.conv3d_wgrad_wg_launch(x.data_ptr(), g.data_ptr(), ci, co, n, n, n,
                                                 plan.tx, plan.ct, int(stack), k,
                                                 partial.data_ptr(), dw.data_ptr(), stream)
                return err, dw
            return run

        def swapped():
            err = libs["as built"].conv3d_wgrad_wg_launch(
                g.data_ptr(), x.data_ptr(), co, ci, n, n, n, swap.tx, swap.ct, int(swap.stack),
                swap.n_split, partial.data_ptr(), dws.data_ptr(), stream)
            return err, dws.flip((0, 1, 2)).transpose(3, 4).contiguous()

        runs = {}  # name -> (run, checked)
        for name, lib in libs.items():
            runs[name] = (launcher(lib, plan.stack, plan.n_split), "ablation" not in name)
        for k in splits:
            if k != plan.n_split:
                runs[f"as built, {k} splits"] = (launcher(libs["as built"], plan.stack, k), True)
        if plan.ct <= conv_cf.WGRAD_WG_STACK_CT:
            runs[f"as built, {'un' if plan.stack else ''}stacked"] = (
                launcher(libs["as built"], not plan.stack, plan.n_split), True)
        if co % 8:
            runs["as built, x and g swapped"] = (swapped, True)
        runs["H-wgrad-mma"] = (lambda: (0, conv_cf.conv3d_cf_wgrad(x, g, kernel="wgrad_mma")),
                               True)
        for name in list(runs):  # a variant whose rings do not fit is left out
            if name != "as built" and runs[name][0]()[0]:
                print(f"({ci},{co}) @{n}^3 {name:30s} does not fit", flush=True)
                del runs[name]
        times = {name: [] for name in runs}
        err = {}
        for order in (list(runs), list(runs)[::-1]):
            for name in order:
                print(f"  ({ci},{co}) @{n}^3 {name}", flush=True)
                code, out = runs[name][0]()
                if code:
                    sys.exit(f"{name}: launch failed, error {code}")
                torch.cuda.synchronize()
                err[name] = float((out - want).abs().max() / want.abs().max())
                times[name].append(chip_smoke.cuda_ms(runs[name][0], REPS))
        bound_ms, _ = chip_smoke.bound(2 * 27 * ci * co * n ** 3,
                                       2 * (ci + co) * n ** 3 + 4 * 27 * ci * co)
        for name, (_, checked) in runs.items():
            ms = float(np.mean(times[name]))
            tag = f"rel err {err[name]:.1e}" if checked else "timed only"
            print(f"({ci},{co}) @{n}^3 {name:30s} {ms:.4f} ms ({times[name][0]:.4f}, "
                  f"{times[name][1]:.4f}) {bound_ms / ms:6.1%} of bound  {tag}", flush=True)
            if checked and not err[name] <= 1e-4:
                sys.exit(f"{name} disagrees with the wrapper's output")
        del x, g, want, dw, dws, partial
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
