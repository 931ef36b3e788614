"""What every cell of the benchmark shares: finding its files by name, the
closed loop of the measured window, host spans, the profiled stretch and its
reduction to device intervals, the import fence and the result line.

A cell is ``workloads/<cell>.json``; it names its configuration
(``configs/<config>.json``), its entry (``entries/<entry>.py``, which sets up
and drives one entry point of the program) and holds its traffic's
parameters.  A per-layer metric is ``metrics/<metric>.py`` with a function
``read(rec)``.  Nothing here names a cell, an entry or a metric.
"""

from __future__ import annotations

import importlib.util
import json
import math
import os
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "synthsr_tpu")


def load_json(path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or not path.is_file():
        raise FileNotFoundError(f"no such benchmark file: {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def workload(name: str) -> dict:
    return load_json(HERE / "workloads" / f"{name}.json")


def config(name: str) -> dict:
    return load_json(HERE / "configs" / f"{name}.json")


def entry(name: str):
    return load_module(HERE / "entries" / f"{name}.py", f"bench_entry_{name}")


def metric_reader(name: str):
    return load_module(HERE / "metrics" / f"{name}.py", "bench_metric_" + name.replace(".", "_"))


def cell_metrics(bench: dict, cell: str):
    """(end-to-end, per-layer) metric entries of ``BENCHMARK.json`` that
    ``cell`` reports: those that list it, or list no cells and move (or
    are) a metric the cell reports."""
    e2e = [m for m in bench["end_to_end"] if cell in m.get("workloads", [cell])]
    names = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if (cell in m["workloads"] if "workloads" in m else m["moves"] in names)]
    return e2e, layer


def process_age_s() -> float:
    """Seconds since this process started (Linux: /proc; 10 ms resolution)."""
    with open("/proc/self/stat") as f:
        start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    return uptime - start_ticks / os.sysconf("SC_CLK_TCK")


def forbidden_modules() -> list:
    """Modules of JAX or of the JAX package loaded in this process, by whole
    top-level name (``synthsr_tpu_torch`` is not ``synthsr_tpu``)."""
    return sorted({m for m in sys.modules if m.split(".")[0] in FORBIDDEN})


_MISSING = object()


class Spans:
    """Host-clock spans around calls into the program, made from the
    benchmark's files: ``wrap(owner, attr, name)`` replaces ``owner.attr``
    by a wrapper that times each call and names it for the profiler
    (``bench.<name>``); ``restore()`` puts every original back."""

    def __init__(self):
        self.seconds, self.count, self._saved = {}, {}, []

    def timed(self, name, fn):
        import torch

        label = "bench." + name

        def wrapper(*args, **kwargs):
            with torch.profiler.record_function(label):
                t0 = time.perf_counter()
                try:
                    return fn(*args, **kwargs)
                finally:
                    self.add(name, time.perf_counter() - t0)

        return wrapper

    def add(self, name, seconds):
        self.seconds[name] = self.seconds.get(name, 0.0) + seconds
        self.count[name] = self.count.get(name, 0) + 1

    def wrap(self, owner, attr, name):
        self._saved.append((owner, attr, vars(owner).get(attr, _MISSING)))
        setattr(owner, attr, self.timed(name, getattr(owner, attr)))

    def restore(self):
        for owner, attr, old in reversed(self._saved):
            if old is _MISSING:
                delattr(owner, attr)
            else:
                setattr(owner, attr, old)
        self._saved = []


def closed_loop(unit, seconds: float, sync):
    """Call ``unit(i)`` for i = 0, 1, ... until ``seconds`` have passed on
    the host clock; ``sync()`` then waits for the device.  Returns (per-unit
    host (start, end) pairs, the window's wall seconds to the sync)."""
    times, i = [], 0
    t0 = time.perf_counter()
    while True:
        a = time.perf_counter()
        unit(i)
        b = time.perf_counter()
        times.append((a - t0, b - t0))
        i += 1
        if b - t0 >= seconds:
            break
    sync()
    return times, time.perf_counter() - t0


# ---------------------------------------------------------------------------
# the profiled stretch
# ---------------------------------------------------------------------------

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def trace_events(chrome_trace: dict, stretch: str = "bench.stretch"):
    """Reduce a ``torch.profiler`` chrome trace to the device's work during
    the ``stretch`` range: (events, host ranges, stretch seconds).  Each event
    is (name, cat, start s, end s, host range): the innermost ``bench.*``
    range active when the host launched it (by correlation id), or "other".
    Times are seconds from the stretch's start."""
    evs = chrome_trace.get("traceEvents", chrome_trace) if isinstance(chrome_trace, dict) \
        else chrome_trace
    ranges, launches, device, win = [], {}, [], None
    for e in evs:
        if e.get("ph") != "X":
            continue
        cat, name = e.get("cat", ""), e.get("name", "")
        ts, dur = float(e.get("ts", 0.0)), float(e.get("dur", 0.0))
        corr = (e.get("args") or {}).get("correlation")
        if cat == "user_annotation" and name.startswith("bench."):
            if name == stretch:
                win = (ts, ts + dur)
            else:
                ranges.append((name[len("bench."):], ts, ts + dur))
        elif cat in DEVICE_CATS:
            device.append((name, cat, ts, ts + dur, corr))
        elif corr is not None and cat in ("cuda_runtime", "cuda_driver"):
            launches[corr] = ts
    if win is None:
        return [], [], 0.0
    t0, t1 = win
    ranges.sort(key=lambda r: r[1])

    def innermost(t):
        best = None
        for name, a, b in ranges:
            if a <= t <= b and (best is None or b - a < best[1]):
                best = (name, b - a)
        return best[0] if best else "other"

    out = []
    for name, cat, a, b, corr in device:
        if b < t0 or a > t1:
            continue
        launch = launches.get(corr)
        rng = innermost(launch) if launch is not None else "other"
        out.append((name, cat, (max(a, t0) - t0) / 1e6, (min(b, t1) - t0) / 1e6, rng))
    host = [(n, (a - t0) / 1e6, (b - t0) / 1e6) for n, a, b in ranges if b >= t0 and a <= t1]
    return out, host, (t1 - t0) / 1e6


def union(intervals):
    """[(start, end)] merged, sorted."""
    merged = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return [(a, b) for a, b in merged]


def busy_seconds(events) -> float:
    return sum(b - a for a, b in union([(e[2], e[3]) for e in events]))


def breakdown(events, host, seconds, top: int = 10) -> dict:
    """The device operations that took most time (summed by name), and the
    device's idle time summed by the innermost host range active in it."""
    by_op = {}
    for name, _, a, b, _ in events:
        key = name if len(name) <= 120 else name[:117] + "..."
        by_op[key] = by_op.get(key, 0.0) + (b - a)
    busy = union([(e[2], e[3]) for e in events])
    gaps, t = [], 0.0
    for a, b in busy:
        if a > t:
            gaps.append((t, a))
        t = max(t, b)
    if t < seconds:
        gaps.append((t, seconds))
    idle = {}
    for a, b in gaps:
        # split each gap at the host ranges' edges, and name each piece
        cuts = sorted({a, b, *(x for _, s, e in host for x in (s, e) if a < x < b)})
        for lo, hi in zip(cuts, cuts[1:]):
            mid, best = 0.5 * (lo + hi), None
            for name, s, e in host:
                if s <= mid <= e and (best is None or e - s < best[1]):
                    best = (name, e - s)
            key = best[0] if best else "outside"
            idle[key] = idle.get(key, 0.0) + (hi - lo)
    order = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:top]]
    return {"device_ops": order(by_op), "idle_gaps": order(idle)}


def profile_stretch(unit, first: int, n: int, sync, tmpdir: str):
    """Run ``unit(first)`` .. ``unit(first + n - 1)`` under ``torch.profiler``
    inside one ``bench.stretch`` range; returns (events, host ranges,
    seconds) of :func:`trace_events`."""
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    path = os.path.join(tmpdir, "bench_trace.json")
    with torch.profiler.profile(activities=acts) as prof:
        sync()
        with torch.profiler.record_function("bench.stretch"):
            for i in range(first, first + n):
                unit(i)
            sync()
    prof.export_chrome_trace(path)
    try:
        trace = load_json(path)
    finally:
        os.remove(path)
    return trace_events(trace)


# ---------------------------------------------------------------------------
# the result
# ---------------------------------------------------------------------------

def number(v):
    v = float(v)
    return v if math.isfinite(v) else None


def check_lines(checks) -> list:
    """'name value limit' lines of the numbers compared."""
    return [f"check {name}: {value!r} (limit {limit!r})" for name, value, limit in checks]


def passes(checks) -> bool:
    return all(v is not None and math.isfinite(v) and v <= lim for _, v, lim in checks)
