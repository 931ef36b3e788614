"""The program's own profiler ranges (``predict.*``, ``train.*``: the spans of
``synthsr_tpu_torch/utils/profiling``) in a profiled stretch beside the
benchmark's ``bench.*`` ranges: the trace reduction, every per-layer reader
and the breakdown read as they do without them, and
``tools/trace_cells.program_events`` puts each device operation under the
innermost program range active at its launch."""

import copy
import os
import sys

import pytest

from bench_common import harness, tiny

sys.path.insert(0, os.path.join(str(harness.ROOT), "tools"))
import trace_cells  # noqa: E402


def x(cat, name, ts, dur, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def ua(name, ts, dur):
    return x("user_annotation", name, ts, dur)


def launched(t, corr, cat, name, start, dur):
    """A launch on the host at ``t`` and its device operation."""
    return [x("cuda_runtime", "cudaLaunchKernel", t, 2, corr), x(cat, name, start, dur, corr)]


# two volumes of predict: bench.volume > bench.prepare (resample, pad, upload) and
# bench.network, the program's spans inside; a kernel before the stretch
PREDICT_BENCH = [
    ua("bench.stretch", 1000, 2000),
    ua("bench.volume", 1000, 900), ua("bench.volume", 2000, 900),
    ua("bench.prepare", 1010, 500), ua("bench.prepare", 2010, 500),
    ua("bench.network", 1600, 200), ua("bench.network", 2600, 200),
    *launched(1050, 1, "gpu_memcpy", "Memcpy HtoD (Pageable -> Device)", 1052, 20),
    *launched(1100, 2, "kernel", "axis_op", 1110, 30),
    *launched(1150, 3, "gpu_memcpy", "Memcpy DtoH (Device -> Pageable)", 1152, 40),
    *launched(1450, 4, "gpu_memcpy", "Memcpy HtoD (Pageable -> Device)", 1452, 30),
    *launched(1650, 5, "kernel", "conv3d_fwd_wg_kernel", 1660, 100),
    *launched(1850, 6, "gpu_memcpy", "Memcpy DtoH (Device -> Pageable)", 1852, 40),
    *launched(2050, 7, "gpu_memcpy", "Memcpy HtoD (Pageable -> Device)", 2052, 20),
    *launched(2150, 8, "gpu_memcpy", "Memcpy DtoH (Device -> Pageable)", 2152, 40),
    *launched(2650, 9, "kernel", "conv3d_fwd_wg_kernel", 2660, 100),
    *launched(2850, 10, "gpu_memcpy", "Memcpy DtoH (Device -> Pageable)", 2852, 40),
    *launched(880, 11, "kernel", "before", 900, 20),
]
PREDICT_PROGRAM = [
    ua("predict.volume", 1005, 890), ua("predict.volume", 2005, 890),
    ua("predict.resample", 1020, 200),
    ua("predict.resample", 2020, 200),
    ua("predict.pad", 1300, 100), ua("predict.upload", 1420, 80),
    ua("predict.network", 1605, 190),
    ua("predict.network", 2605, 190),
    ua("predict.output", 1800, 90), ua("predict.output", 2800, 90),
]
# two train steps: bench.step > train.step > the four phases; the label copy outside
TRAIN_BENCH = [
    ua("bench.stretch", 1000, 2000),
    ua("bench.labels", 1000, 40), ua("bench.labels", 2000, 40),
    ua("bench.step", 1050, 900), ua("bench.step", 2050, 900),
    ua("bench.generate_batch", 1070, 300),
    ua("bench.generate_batch", 2070, 300),
    *launched(1010, 20, "gpu_memcpy", "Memcpy HtoD (Pageable -> Device)", 1012, 10),
    *launched(1100, 21, "kernel", "gen", 1110, 30), *launched(1200, 22, "kernel", "gen", 1210, 30),
    *launched(1500, 23, "kernel", "conv_fwd", 1510, 50),
    *launched(1700, 24, "kernel", "conv_wgrad", 1710, 60),
    *launched(1900, 25, "kernel", "adam", 1905, 10),
    *launched(1910, 26, "kernel", "adam", 1916, 10),
    *launched(2100, 27, "kernel", "gen", 2110, 30),
    *launched(2500, 28, "kernel", "conv_fwd", 2510, 50),
    *launched(2900, 29, "kernel", "adam", 2905, 10),
]
TRAIN_PROGRAM = [
    ua("train.step", 1055, 890), ua("train.step", 2055, 890),
    ua("train.generate", 1060, 320),
    ua("train.generate", 2060, 320),
    ua("train.forward", 1400, 200), ua("train.forward", 2400, 200),
    ua("train.backward", 1620, 250),
    ua("train.backward", 2620, 250),
    ua("train.adam", 1880, 60), ua("train.adam", 2880, 60),
]


def rec_of(events, k=2):
    """The benchmark's record of a traced run from a synthetic trace."""
    device, host, seconds = harness.trace_events({"traceEvents": events})
    spans = {}
    for name, a, b in host:
        s = spans.setdefault(name, {"seconds": 0.0, "count": 0})
        s["seconds"] += b - a
        s["count"] += 1
    rec = {"window": {"units": 10, "seconds": 3.0, "flops": 1e13,
                      "latencies": [0.1 * i for i in range(1, 11)]},
           "spans": spans, "profiled": {"units": k, "seconds": seconds, "least_s": 1e-4},
           "device": device}
    return rec, host, seconds


READERS = {
    "predict": ["volume_p90_s.predict", "prepare_ms.predict", "copy_ms.predict",
                "unet_ms.predict", "unet_roofline.predict", "mfu.predict",
                "device_idle.predict"],
    "train": ["generator_ms.train", "launches_per_step.train", "unet_roofline.train",
              "mfu.train", "device_idle.train"],
}
TRACES = {"predict": (PREDICT_BENCH, PREDICT_PROGRAM), "train": (TRAIN_BENCH, TRAIN_PROGRAM)}


@pytest.mark.parametrize("name", READERS["predict"] + READERS["train"])
def test_readers_ignore_program_ranges(name):
    entry = "predict" if name.endswith(".predict") else "train"
    bench, program = TRACES[entry]
    alone, _, _ = rec_of(bench)
    both, _, _ = rec_of(bench + program)
    want = harness.metric_reader(name).read(alone)
    assert want is not None
    assert harness.metric_reader(name).read(both) == want


@pytest.mark.parametrize("entry", ["predict", "train"])
def test_trace_events_and_breakdown_ignore_program_ranges(entry):
    bench, program = TRACES[entry]
    alone = harness.trace_events({"traceEvents": copy.deepcopy(bench)})
    both = harness.trace_events({"traceEvents": bench + program})
    assert both == alone
    assert harness.breakdown(*both) == harness.breakdown(*alone)


def test_program_events_by_innermost_program_range():
    events, ranges, seconds = trace_cells.program_events({"traceEvents":
                                                          PREDICT_BENCH + PREDICT_PROGRAM})
    assert seconds == pytest.approx(2e-3)
    by = [(e[0][:12], e[4]) for e in events]
    assert by == [("Memcpy HtoD ", "predict.resample"), ("axis_op", "predict.resample"),
                  ("Memcpy DtoH ", "predict.resample"), ("Memcpy HtoD ", "predict.upload"),
                  ("conv3d_fwd_w", "predict.network"), ("Memcpy DtoH ", "predict.output"),
                  ("Memcpy HtoD ", "predict.resample"), ("Memcpy DtoH ", "predict.resample"),
                  ("conv3d_fwd_w", "predict.network"), ("Memcpy DtoH ", "predict.output")]
    assert {r[0] for r in ranges} == {"predict.volume", "predict.resample", "predict.pad",
                                      "predict.upload", "predict.network", "predict.output"}
    idle = dict(harness.breakdown(events, ranges, seconds)["idle_gaps"])
    assert "bench.prepare" not in idle and "prepare" not in idle
    assert idle["predict.pad"] == pytest.approx(100e-6)
    assert sum(idle.values()) == pytest.approx(seconds - harness.busy_seconds(events))


def test_program_events_train_phases():
    events, _, _ = trace_cells.program_events({"traceEvents": TRAIN_BENCH + TRAIN_PROGRAM})
    kernels = {}
    for e in events:
        if e[1] == "kernel":
            kernels[e[4]] = kernels.get(e[4], 0) + 1
    assert kernels == {"train.generate": 3, "train.forward": 2, "train.backward": 1,
                       "train.adam": 3}
    assert [e[4] for e in events if e[1] == "gpu_memcpy"] == ["other"]


@pytest.mark.parametrize("cell,spans", [
    ("predict-clinical", {"predict.volume", "predict.resample", "predict.align",
                          "predict.normalise", "predict.pad", "predict.upload",
                          "predict.network", "predict.output"}),
    ("train-128", {"train.step", "train.generate", "train.forward", "train.backward",
                   "train.adam"})])
def test_trace_cells_runs_a_cell_on_the_cpu(cell, spans):
    """The tool's windows, off and on, and its traced window and stretch at a
    tiny size: every span of the entry read, each unit once, the tracer left
    off."""
    from synthsr_tpu_torch.utils import profiling

    wl, cfg = tiny(cell)
    wl["profile_units"] = 1
    out = trace_cells.run(cell, 5400000016, 0.2, 1, device="cpu", wl=wl, cfg=cfg)
    assert not profiling.enabled
    assert len(out["rates"]["off"]) == len(out["rates"]["on"]) == 1
    assert set(out["spans_ms_per_unit"]) == spans
    assert {s["count"] for s in out["spans_ms_per_unit"].values()} == {out["window"]["units"]}
    assert set(out["stretch"]["span_vs_trace"]) == spans
    m = out["metrics"]
    want = ("resample_ms.predict", "host_prep_ms.predict") if cell.startswith("predict") \
        else ("forward_ms.train", "backward_ms.train", "adam_ms.train")
    assert all(m[k] > 0 for k in want)
