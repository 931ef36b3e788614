"""Run cells of the benchmark with the port's tracer on (``utils/profiling``)
and reduce what it records: the stages of predict, the phases of the train
step and the conv calls' host path, on the device trace's clock.

    python3 tools/trace_cells.py [--cells predict-256,predict-clinical,train-128]
        [--seed N] [--seconds S] [--rounds R] [--out FILE.json]

On a CUDA device, from the root of a checkout.  For each cell the
benchmark's entry (``benchmark/entries/``) is set up from the seed, then:

- ``rounds`` pairs of closed-loop windows of ``seconds``, the tracer off
  then on: the cell's rate in each (the tracer's cost);
- one window with the tracer on and the benchmark's own host spans
  (``harness.Spans``, ``bench.*``) around it: the program's span totals and
  conv counters a unit beside ``prepare_ms`` and ``generator_ms`` as the
  benchmark reads them;
- the cell's profiled stretch (its ``profile_units``) under
  ``torch.profiler``: each device operation under the innermost program
  span active at its launch (by correlation id), the device's idle time by
  innermost program span (``harness.breakdown`` on the program's ranges),
  and each span's perf_counter total against its ranges in the trace.

For predict, the device ms (kernels, copies, fills) and the kernels launched
under each stage of ``prepare``, a volume (the stages' host ms are among the
spans), beside the bytes the program counted up and down a volume.  For
train, ``generator_graph_hit.train``: the share of the generator's calls in
the traced window that replayed its CUDA graph.

Prints one JSON object a cell, and writes them all to ``--out`` if given.  It also
times ``span`` and ``count`` off and on (ns a call, on the host).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
import timeit

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [os.path.join(ROOT, "benchmark"), ROOT]

import harness  # noqa: E402

PREDICT_PREP = ("predict.align", "predict.normalise", "predict.pad", "predict.upload")
PREPARE = ("predict.resample", *PREDICT_PREP)
TRAIN_PHASES = ("train.generate", "train.forward", "train.backward", "train.adam")


def program_events(trace: dict, stretch: str = "bench.stretch"):
    """:func:`harness.trace_events` over the program's ranges in place of the
    benchmark's: the ``bench.*`` ranges but the stretch are dropped and every
    other ``user_annotation`` is renamed ``bench.<name>``, which
    ``trace_events`` strips again.  (device events (name, cat, start s, end
    s, innermost program range), program ranges (name, start s, end s),
    stretch seconds)."""
    evs = trace.get("traceEvents", trace) if isinstance(trace, dict) else trace
    relabelled = []
    for e in evs:
        if e.get("ph") == "X" and e.get("cat") == "user_annotation":
            name = e.get("name", "")
            if name.startswith("bench."):
                if name != stretch:
                    continue
            else:
                e = {**e, "name": "bench." + name}
        relabelled.append(e)
    return harness.trace_events(relabelled, stretch)


def profiled(unit, first: int, n: int, sync):
    """``harness.profile_stretch``, returning the whole Chrome trace (that
    function returns only its reduction to the ``bench.*`` ranges)."""
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        sync()
        with torch.profiler.record_function("bench.stretch"):
            for i in range(first, first + n):
                unit(i)
            sync()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        return harness.load_json(path)
    finally:
        os.remove(path)


def costs(n: int = 100000) -> dict:
    """ns a call of ``with span(...)`` and of ``count(...)``, off and on."""
    from synthsr_tpu_torch.utils import profiling

    def spanned():
        with profiling.span("cost.span"):
            pass

    out = {}
    for on in (False, True):
        profiling.tracing(on)
        key = "on" if on else "off"
        out["span_ns_" + key] = 1e9 * timeit.timeit(spanned, number=n) / n
        out["count_ns_" + key] = 1e9 * timeit.timeit(lambda: profiling.count("cost.count"),
                                                     number=n) / n
    profiling.tracing(False)
    profiling.reset()
    return out


def per_unit(spans: dict, names, units: int) -> float | None:
    if not units or not all(n in spans for n in names):
        return None
    return 1e3 * sum(spans[n]["seconds"] for n in names) / units


def run(cell: str, seed: int, seconds: float, rounds: int, device="cuda", wl=None,
        cfg=None) -> dict:
    """One cell; ``device``, ``wl`` and ``cfg`` as in ``benchmark/run.run_cell``
    (a CPU rehearsal at a tiny size)."""
    import torch

    from synthsr_tpu_torch.ops import conv_cf
    from synthsr_tpu_torch.utils import profiling

    wl = wl or harness.workload(cell)
    cfg = cfg or harness.config(wl["config"])
    b = harness.entry(wl["entry"]).Bench(cfg, wl, seed, device)
    b.sync()
    rate = lambda times, wall: next(iter(b.end_to_end(times, wall).values()))
    out = {"cell": cell, "seed": seed, "rates": {"off": [], "on": []}}
    for _ in range(rounds):
        for on in (False, True):
            profiling.tracing(on)
            profiling.reset()
            times, wall = harness.closed_loop(b.unit, seconds, b.sync)
            out["rates"]["on" if on else "off"].append(rate(times, wall))

    # a traced window inside the benchmark's own spans
    spans = harness.Spans()
    b.instrument(spans)
    profiling.tracing(True)
    profiling.reset()
    conv_cf.reset_launch_counts()
    times, wall = harness.closed_loop(b.unit, seconds, b.sync)
    n, snap = len(times), profiling.snapshot()
    bench = {k: {"seconds": spans.seconds[k], "count": spans.count[k]} for k in spans.seconds}

    # the profiled stretch, the tracer and the benchmark's spans still on
    k = wl["profile_units"]
    profiling.reset()
    trace = profiled(b.unit, n, k, b.sync)
    stretch_snap = profiling.snapshot()
    spans.restore()
    profiling.tracing(False)
    b.release()

    events, ranges, stretch_s = program_events(trace)
    bench_events, bench_ranges, _ = harness.trace_events(trace)
    rec = {"spans": bench, "device": bench_events, "profiled": {"units": k},
           "window": {"units": n, "seconds": wall}}
    read = lambda name: harness.metric_reader(name).read(rec)
    sp, ctr = snap["spans"], snap["counters"]
    memcpy_ms = lambda rng: 1e3 * sum(e[3] - e[2] for e in events
                                      if e[1] == "gpu_memcpy" and e[4] == rng) / k
    kernels = lambda rng: sum(1 for e in events if e[1] == "kernel" and e[4] == rng) / k
    device_ms = lambda rng: 1e3 * sum(e[3] - e[2] for e in events if e[4] == rng) / k
    m = {}
    if "predict.volume" in sp:
        vols = sp["predict.volume"]["count"]
        m["resample_ms.predict"] = per_unit(sp, ["predict.resample"], vols)
        m["host_prep_ms.predict"] = per_unit(sp, PREDICT_PREP, vols)
        m["resample_copy_ms.predict"] = memcpy_ms("predict.resample")
        m["output_copy_ms.predict"] = memcpy_ms("predict.output")
        m["prepare_ms.predict (bench)"] = read("prepare_ms.predict")
        m["copy_ms.predict (bench)"] = read("copy_ms.predict")
        m["network_ms.predict (host)"] = per_unit(sp, ["predict.network"], vols)
        m["output_ms.predict (host)"] = per_unit(sp, ["predict.output"], vols)
        m["conv_calls_per_volume"] = ctr.get("conv.calls", 0) / vols
        m["prepare_device_ms by stage"] = {n: device_ms(n) for n in PREPARE}
        m["prepare_kernels by stage"] = {n: kernels(n) for n in PREPARE}
        for c in ("predict.h2d_bytes", "predict.d2h_bytes"):
            m[c + " per volume"] = ctr.get(c, 0) / vols
        units = vols
    else:
        steps = sp["train.step"]["count"]
        for name in ("forward", "backward", "adam"):
            m[f"{name}_ms.train"] = per_unit(sp, [f"train.{name}"], steps)
        m["generator_launches.train"] = kernels("train.generate")
        calls = sum(ctr.get(f"generator.{c}", 0) for c in ("captures", "replays", "eager"))
        m["generator_graph_hit.train"] = ctr.get("generator.replays", 0) / calls if calls else None
        m["adam_launches.train"] = kernels("train.adam")
        m["conv_packs.train"] = ctr.get("conv.packs", 0) / steps
        m["generate_ms.train (host)"] = per_unit(sp, ["train.generate"], steps)
        m["generator_ms.train (bench)"] = read("generator_ms.train")
        m["launches_per_step.train (bench)"] = read("launches_per_step.train")
        m["launches_per_step by phase"] = {p: kernels(p) for p in (*TRAIN_PHASES, "train.step",
                                                                   "other")}
        m["conv_calls_per_step"] = ctr.get("conv.calls", 0) / steps
        units = steps
    if ctr.get("conv.calls"):
        m["conv_host_us"] = 1e6 * ctr["conv.host_s"] / ctr["conv.calls"]
    m["launches_per_unit"] = {key: v / units for key, v in snap["launches"].items() if v}
    out["metrics"] = m
    out["window"] = {"units": n, "seconds": wall, "rate": rate(times, wall)}
    out["spans_ms_per_unit"] = {name: {"ms": 1e3 * s["seconds"] / units,
                                       "self_ms": 1e3 * s["self_seconds"] / units,
                                       "count": s["count"]} for name, s in sp.items()}
    in_trace = {}
    for name, a, b_ in ranges:
        in_trace[name] = in_trace.get(name, 0.0) + (b_ - a)
    out["stretch"] = {
        "units": k, "seconds": stretch_s,
        "idle_by_program_span": harness.breakdown(events, ranges, stretch_s)["idle_gaps"],
        "idle_by_bench_range": harness.breakdown(bench_events, bench_ranges,
                                                 stretch_s)["idle_gaps"],
        "busy_s": harness.busy_seconds(events),
        "span_vs_trace": {name: [s["seconds"], in_trace.get(name)]
                          for name, s in stretch_snap["spans"].items()},
    }
    if b.dev.type == "cuda":
        torch.cuda.empty_cache()
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--cells", default="predict-256,predict-clinical,train-128")
    p.add_argument("--seed", type=int, default=1234567891)
    p.add_argument("--seconds", type=float, default=15.0)
    p.add_argument("--rounds", type=int, default=3)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("trace_cells.py: needs a CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout
    results = {"card": card.strip(), "costs": costs(), "cells": []}
    print(json.dumps({"card": results["card"], "costs": results["costs"]}), flush=True)
    for i, cell in enumerate(args.cells.split(",")):
        t0 = time.perf_counter()
        r = run(cell, args.seed + i, args.seconds, args.rounds)
        r["tool_s"] = time.perf_counter() - t0
        results["cells"].append(r)
        print(json.dumps(r), flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
