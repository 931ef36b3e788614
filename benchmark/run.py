"""Run one cell of the benchmark of ``synthsr_tpu_torch`` once.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout.  Sets up the cell's entry from the seed
(counted as ``setup_s``, from process start), runs its closed loop for
``--seconds``, then checks a sample of what the window produced against the
plain reference and prints one JSON line: the cell's end-to-end metrics
with ``--trace 0``; with ``--trace 1`` the same window with host spans
around the calls into each layer, then a short profiled stretch, and the
cell's per-layer metrics.  Without a CUDA device it exits with code 2 and
prints no result.  The program's one build cache, the kernel library, is
``synthsr_tpu_torch/_build/`` inside the checkout: the first run builds it.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
import tempfile

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [HERE, os.path.dirname(HERE)]  # the benchmark's modules, the program

import harness  # noqa: E402


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=[0, 1], default=0)
    return p.parse_args(argv)


def read_layer_metrics(layer, rec):
    out = {}
    for m in layer:
        v = harness.metric_reader(m["name"]).read(rec)
        if v is not None:
            out[m["name"]] = {"value": float(v), "unit": m["unit"]}
    return out


def run_cell(args, device="cuda", wl=None, cfg=None, fault=None, log=print):
    """One run of a cell: (result dict, the checks' lines).  ``wl``, ``cfg``
    and ``fault`` replace the cell's files and plant a fault; the tests use
    them to drive a run on the CPU at a tiny size."""
    import numpy as np
    import torch

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    bench_def = harness.load_json(os.path.join(harness.ROOT, "BENCHMARK.json"))
    wl = wl or harness.workload(args.workload)
    cfg = cfg or harness.config(wl["config"])
    e2e_defs, layer_defs = harness.cell_metrics(bench_def, args.workload)
    seed = int(args.seed) % 2 ** 63
    b = harness.entry(wl["entry"]).Bench(cfg, wl, seed, device, fault=fault)
    b.sync()
    setup_s = harness.process_age_s()

    spans = harness.Spans() if args.trace else None
    if spans:
        b.instrument(spans)
    if hasattr(b, "open_window"):
        b.open_window(args.seconds)
    times, wall = harness.closed_loop(b.unit, args.seconds, b.sync)
    n = len(times)
    rec = None
    if spans:
        host = dict(spans.seconds)
        counts = dict(spans.count)
        k = wl["profile_units"]
        events, ranges, stretch_s = harness.profile_stretch(
            b.unit, n, k, b.sync, tempfile.gettempdir()) if device != "cpu" else ([], [], 0.0)
        spans.restore()
        flops = sum(b.unit_work(i)[0] for i in range(n))
        least = sum(b.unit_work(i)[1] for i in range(n, n + k))
        rec = {"window": {"units": n, "seconds": wall, "flops": flops,
                          "latencies": [end - start for start, end in times]},
               "spans": {name: {"seconds": s, "count": counts[name]} for name, s in host.items()},
               "profiled": {"units": k, "seconds": stretch_s, "least_s": least},
               "device": events}
    late = b.after_window(n + (wl["profile_units"] if spans else 0)) \
        if hasattr(b, "after_window") else 0
    e2e = b.end_to_end(times, wall)
    if hasattr(b, "notes"):
        log(b.notes())
    peak = torch.cuda.max_memory_allocated(b.dev) if b.dev.type == "cuda" else 0
    log(f"peak device memory {peak} bytes")
    b.release()
    checks, failed = b.check()

    if spans:
        metrics = read_layer_metrics(layer_defs, rec)
    else:
        metrics = {m["name"]: {"value": float(e2e[m["name"]]), "unit": m["unit"]}
                   for m in e2e_defs if m["name"] != "setup_s"}
        metrics["setup_s"] = {"value": setup_s, "unit": "s"}
    dev_info = {"platform": "gpu" if b.dev.type == "cuda" else "cpu",
                "kind": torch.cuda.get_device_name(b.dev) if b.dev.type == "cuda" else "cpu",
                "count": 1, "memory_peak_bytes": int(peak)}
    attempted = n + b.setup_units + late + (rec["profiled"]["units"] if spans else 0)
    result = {"correct": harness.passes(checks), "attempted": attempted, "failed": failed,
              "metrics": metrics, "device": dev_info}
    if spans and rec["profiled"]["seconds"] > 0:
        dev_info["busy_s"] = harness.busy_seconds(rec["device"])
        dev_info["window_s"] = rec["profiled"]["seconds"]
        result["breakdown"] = harness.breakdown(rec["device"], ranges, stretch_s)
    result["checks"] = {name: {"value": harness.number(v), "limit": lim}
                        for name, v, lim in checks}
    lat = [y - x for x, y in times]
    log(f"window: {n} units in {wall!r} s; setup {setup_s!r} s; "
        f"latency p50 {np.median(lat)!r} s, p90 {np.percentile(lat, 90)!r} s")
    return result, harness.check_lines(checks)


def finite(v):
    """``v`` with every float that is not finite replaced by None."""
    if isinstance(v, dict):
        return {k: finite(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [finite(x) for x in v]
    if isinstance(v, float) and not math.isfinite(v):
        return None
    return v


def main(argv=None):
    args = parse(argv)
    try:
        import torch
    except ImportError as e:
        print(f"run.py: {e}", file=sys.stderr)
        return 2
    wl = harness.workload(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < wl["chips"]:
        print(f"run.py: the cell needs {wl['chips']} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result, lines = run_cell(args)
    found = harness.forbidden_modules()
    if found:
        print(f"run.py: JAX or the JAX package is loaded: {found}", file=sys.stderr)
        return 3
    sys.stdout.flush()
    for line in lines:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(finite(result), allow_nan=False))
    return 0


if __name__ == "__main__":
    sys.exit(main())
