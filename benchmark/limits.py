"""Read the numbers a cell's check compares, for setting its limits: the
program's over many seeds (each a short window at the cell's own sizes and
load, then the check) and the lower-precision control's, the reference
computed in float8 (``reference/precision.py``) in the program's place, on
the first few seeds.  One process for all seeds; one JSON line per seed.

    python3 benchmark/limits.py --workload <cell> --seconds 3 --control 3 --seeds 11 12 ...

Needs a CUDA device.  ``--fault`` plants one of the entry's faults instead,
to read what a broken run gives.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [HERE, os.path.dirname(HERE)]

import harness  # noqa: E402


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--control", type=int, default=3, help="seeds that also read the control")
    p.add_argument("--fault", default=None)
    a = p.parse_args(argv)
    import torch

    from reference.precision import fp8

    if not torch.cuda.is_available():
        print("limits.py: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    wl = harness.workload(a.workload)
    cfg = harness.config(wl["config"])
    entry = harness.entry(wl["entry"])
    for i, seed in enumerate(a.seeds):
        t0 = time.perf_counter()
        b = entry.Bench(cfg, wl, seed, "cuda", fault=a.fault)
        if hasattr(b, "open_window"):
            b.open_window(a.seconds)
        times, _ = harness.closed_loop(b.unit, a.seconds, b.sync)
        if hasattr(b, "after_window"):
            b.after_window(len(times))
        b.release()
        checks, _ = b.check()
        line = {"workload": a.workload, "seed": seed, "fault": a.fault, "units": len(times),
                "program": {n: v for n, v, _ in checks}}
        line["detail"] = getattr(b, "detail", None)
        if i < a.control:
            line["control"] = b.control(fp8)
            line["control_detail"] = getattr(b, "control_detail", None)
        line["seconds"] = time.perf_counter() - t0
        print(json.dumps(line), flush=True)
        del b
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
