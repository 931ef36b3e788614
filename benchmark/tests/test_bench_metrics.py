"""Each per-layer metric's reader, the trace reduction and the breakdown,
on synthetic records."""

import pytest

from bench_common import harness


def ev(name, cat, start, end, rng):
    return (name, cat, start, end, rng)


PREDICT_REC = {
    "window": {"units": 10, "seconds": 3.0, "flops": 10 * 10.38e12,
               "latencies": [0.1 * i for i in range(1, 11)]},
    "spans": {"prepare": {"seconds": 1.5, "count": 10}, "network": {"seconds": 0.6, "count": 10},
              "volume": {"seconds": 2.9, "count": 10}},
    "profiled": {"units": 2, "seconds": 0.6, "least_s": 2 * 0.011},
    "device": [ev("Memcpy HtoD (Pageable -> Device)", "gpu_memcpy", 0.00, 0.02, "prepare"),
               ev("Memcpy DtoH (Device -> Pageable)", "gpu_memcpy", 0.03, 0.05, "prepare"),
               ev("conv3d_fwd_wg_kernel", "kernel", 0.10, 0.15, "network"),
               ev("elementwise", "kernel", 0.14, 0.16, "network"),   # overlaps the conv
               ev("Memcpy DtoH (Device -> Pageable)", "gpu_memcpy", 0.20, 0.26, "volume"),
               ev("Memset (Device)", "gpu_memset", 0.30, 0.31, "prepare")],
}
TRAIN_REC = {
    "window": {"units": 100, "seconds": 10.0, "flops": 100 * 1.96e12},
    "spans": {"generate_batch": {"seconds": 4.0, "count": 100},
              "labels": {"seconds": 0.5, "count": 100}},
    "profiled": {"units": 2, "seconds": 0.2, "least_s": 2 * 0.002},
    "device": [ev("gen_kernel", "kernel", 0.00, 0.04, "generate_batch"),
               ev("conv", "kernel", 0.05, 0.07, "step"),
               ev("adam", "kernel", 0.07, 0.08, "step"),
               ev("gen_kernel", "kernel", 0.10, 0.14, "generate_batch"),
               ev("conv", "kernel", 0.15, 0.17, "step")],
}


def read(name, rec):
    return harness.metric_reader(name).read(rec)


@pytest.mark.parametrize("name,want", [
    ("prepare_ms.predict", 150.0),
    ("volume_p90_s.predict", 0.91),
    ("copy_ms.predict", 1e3 * (0.02 + 0.02 + 0.06) / 2),
    ("unet_ms.predict", 1e3 * (0.05 + 0.02) / 2),
    ("unet_roofline.predict", 100 * 0.022 / 0.07),
    ("mfu.predict", 100 * 10 * 10.38e12 / (3.0 * 989e12)),
    # busy: union [0, .02] [.03, .05] [.10, .16] [.20, .26] [.30, .31] = 0.17 of 0.6
    ("device_idle.predict", 100 * (1 - 0.17 / 0.6)),
])
def test_predict_readers(name, want):
    assert read(name, PREDICT_REC) == pytest.approx(want)


@pytest.mark.parametrize("name,want", [
    ("generator_ms.train", 40.0),
    ("launches_per_step.train", 2.5),
    ("unet_roofline.train", 100 * 0.004 / 0.05),
    ("mfu.train", 100 * 100 * 1.96e12 / (10.0 * 989e12)),
    ("device_idle.train", 100 * (1 - 0.13 / 0.2)),
])
def test_train_readers(name, want):
    assert read(name, TRAIN_REC) == pytest.approx(want)


EMPTY = {"window": {"units": 0, "seconds": 0.0, "flops": 0.0}, "spans": {},
         "profiled": {"units": 0, "seconds": 0.0, "least_s": 0.0}, "device": []}


@pytest.mark.parametrize("name", [
    "volume_p90_s.predict", "prepare_ms.predict", "copy_ms.predict", "unet_ms.predict",
    "unet_roofline.predict",
    "mfu.predict", "device_idle.predict", "generator_ms.train", "launches_per_step.train",
    "unet_roofline.train", "mfu.train", "device_idle.train"])
def test_reader_with_nothing_to_read_returns_none(name):
    assert read(name, EMPTY) is None


def test_union_merges_overlaps():
    assert harness.union([(3, 4), (0, 1), (0.5, 2), (2, 2.5)]) == [(0, 2.5), (3, 4)]
    assert harness.busy_seconds(PREDICT_REC["device"]) == pytest.approx(0.17)


def test_trace_events_by_correlation():
    trace = {"traceEvents": [
        {"ph": "X", "cat": "user_annotation", "name": "bench.stretch", "ts": 1000, "dur": 1000},
        {"ph": "X", "cat": "user_annotation", "name": "bench.volume", "ts": 1000, "dur": 900},
        {"ph": "X", "cat": "user_annotation", "name": "bench.network", "ts": 1200, "dur": 300},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 1250, "dur": 5,
         "args": {"correlation": 7}},
        {"ph": "X", "cat": "cuda_driver", "name": "cuLaunchKernel", "ts": 1100, "dur": 5,
         "args": {"correlation": 8}},
        {"ph": "X", "cat": "kernel", "name": "k_net", "ts": 1300, "dur": 100,
         "args": {"correlation": 7}},
        {"ph": "X", "cat": "kernel", "name": "k_vol", "ts": 1150, "dur": 20,
         "args": {"correlation": 8}},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoH", "ts": 1950, "dur": 100,
         "args": {"correlation": 9}},
        {"ph": "X", "cat": "kernel", "name": "before", "ts": 100, "dur": 10,
         "args": {"correlation": 10}},
    ]}
    events, host, seconds = harness.trace_events(trace)
    assert seconds == pytest.approx(1e-3)
    assert [(e[0], e[4]) for e in events] == [("k_net", "network"), ("k_vol", "volume"),
                                              ("Memcpy DtoH", "other")]
    assert events[2][3] == pytest.approx(1e-3)  # clipped to the stretch
    assert {h[0] for h in host} == {"volume", "network"}


def test_breakdown_names_idle_by_host_range():
    events = [ev("a", "kernel", 0.1, 0.2, "network"), ev("b", "kernel", 0.25, 0.3, "network"),
              ev("a", "kernel", 0.5, 0.55, "network")]
    host = [("volume", 0.0, 1.0), ("prepare", 0.0, 0.1), ("network", 0.1, 0.4)]
    out = harness.breakdown(events, host, 1.0)
    assert out["device_ops"] == [["a", pytest.approx(0.15)], ["b", pytest.approx(0.05)]]
    idle = dict(out["idle_gaps"])
    assert idle["prepare"] == pytest.approx(0.1)
    assert idle["network"] == pytest.approx(0.05 + 0.1)
    assert idle["volume"] == pytest.approx(0.1 + 0.45)
    assert sum(idle.values()) == pytest.approx(1.0 - 0.2)
