"""The port's tracer (``synthsr_tpu_torch/utils/profiling.py``: ``span``,
``count``, ``tracing``, ``reset``, ``snapshot``) and the spans and counters
placed in ``cli/predict.py``, ``train/training.py`` and ``ops/conv_cf.py``.

On the CPU: off, nothing is recorded; on, predict's seven stages tile
``predict.volume`` and the train step's four phases tile ``train.step``;
self seconds on a fake clock; per-thread nesting; the spans as
``user_annotation`` ranges of a ``profiling.trace`` Chrome trace.  The
``cuda`` case holds the conv counters against ``LAUNCHES`` on the card.
"""

import json
import sys
import threading

import numpy as np
import pytest
import torch

from synthsr_tpu_torch.cli.predict import Predictor
from synthsr_tpu_torch.models.unet import UNet3D
from synthsr_tpu_torch.models.weights import random_variables, variables_to_state_dict
from synthsr_tpu_torch.ops import conv_cf
from synthsr_tpu_torch.utils import profiling

torch.set_num_threads(2)

PREDICT_STAGES = ("predict.resample", "predict.align", "predict.normalise", "predict.pad",
                  "predict.upload", "predict.network", "predict.output")
TRAIN_PHASES = ("train.generate", "train.forward", "train.backward", "train.adam")


@pytest.fixture(autouse=True)
def tracer_off():
    profiling.tracing(False)
    profiling.reset()
    yield
    profiling.tracing(False)
    profiling.reset()


@pytest.fixture(scope="module")
def predictor(tmp_path_factory):
    path = tmp_path_factory.mktemp("weights") / "rand.pt"
    torch.save(variables_to_state_dict(random_variables(seed=0)), str(path))
    return Predictor(model_path=str(path), compute_dtype="float32", device="cpu")


def _scan(seed=0, shape=(14, 12, 10)):
    rng = np.random.default_rng(seed)
    aff = np.diag([1.0, 1.0, 2.0, 1.0])
    return rng.uniform(0, 500, size=shape).astype(np.float32), aff


def _train_step():
    """A tiny CPU ``make_train_step`` (tests/test_torch_train.py's
    configuration) and its first batch."""
    from synthsr_tpu_torch.synth.labels_to_image import GenerationConfig, build_generator
    from synthsr_tpu_torch.train.training import init_unet, make_train_step
    from synthsr_tpu_torch.utils.finite_guard import adam_init

    cfg = GenerationConfig(
        labels_shape=[16, 16, 16], input_channels=[True], output_channel=[0],
        generation_labels=np.array([0, 2, 4], np.int32), n_neutral_labels=3,
        atlas_res=[1.0, 1.0, 1.0], output_shape=16, output_div_by_n=4, flipping=True,
        aff=np.eye(4), randomise_res=False, nonlin_std=0.0,
        data_res=np.array([[1.0, 1.0, 2.0]]), downsample=True, build_reliability_maps=True,
        simulate_registration_error=False)
    rng = np.random.default_rng(0)
    means = torch.from_numpy(rng.uniform(20, 200, (3, 1)).astype(np.float32))
    stds = torch.from_numpy(rng.uniform(1, 10, (3, 1)).astype(np.float32))
    model = init_unet(UNet3D(in_channels=2, nb_features=2, nb_levels=2, nb_conv_per_level=1))
    step = make_train_step(model, build_generator(cfg), lambda gen: (means, stds), 1e-3,
                           loss_cropping=12, residual_indices=[0],
                           compute_dtype=torch.float32)
    labels = torch.from_numpy(rng.integers(0, 3, (1, 16, 16, 16, 1)).astype(np.int32) * 2)
    return step, adam_init(list(model.parameters())), [labels]


class _Ranges:
    """Stands in for ``torch.profiler.record_function``: logs each range's
    (name, depth) as it is entered."""

    def __init__(self):
        self.log, self.depth = [], 0

    def __call__(self, name):
        ranges = self

        class Range:
            def __enter__(self):
                ranges.log.append((name, ranges.depth))
                ranges.depth += 1

            def __exit__(self, *exc):
                ranges.depth -= 1

        return Range()


def test_off_records_nothing(predictor):
    assert not profiling.enabled
    assert profiling.span("predict.volume") is profiling.span("train.step")
    profiling.count("conv.calls")
    predictor.predict_volume(*_scan())
    step, opt, batch = _train_step()
    step(opt, torch.Generator().manual_seed(1), batch)
    snap = profiling.snapshot()
    assert snap["spans"] == {} and snap["counters"] == {}
    assert snap["launches"] == conv_cf.LAUNCHES and snap["launches"] is not conv_cf.LAUNCHES


def test_count_is_inert_when_off():
    profiling.count("conv.packs", 5)
    assert profiling.snapshot()["counters"] == {}
    profiling.tracing(True)
    profiling.count("conv.packs", 5)
    profiling.count("conv.packs")
    profiling.count("conv.host_s", 0.25)
    assert profiling.snapshot()["counters"] == {"conv.packs": 6, "conv.host_s": 0.25}
    profiling.reset()
    assert profiling.snapshot()["counters"] == {}


def test_reset_leaves_the_registered_launch_counts():
    """``LAUNCHES`` is copied into each snapshot and zeroed only by its
    module."""
    saved = dict(conv_cf.LAUNCHES)
    try:
        conv_cf.LAUNCHES["fwd_wg"] += 3
        profiling.reset()
        snap = profiling.snapshot()
        assert snap["launches"] == conv_cf.LAUNCHES and snap["launches"] is not conv_cf.LAUNCHES
        assert snap["launches"]["fwd_wg"] == saved["fwd_wg"] + 3
    finally:
        conv_cf.LAUNCHES.update(saved)


def test_predict_stages_tile_the_volume(predictor, monkeypatch):
    """Each stage once a volume, nested directly under ``predict.volume``."""
    ranges = _Ranges()
    monkeypatch.setattr(torch.profiler, "record_function", ranges)
    profiling.tracing(True)
    for seed in range(2):
        predictor.predict_volume(*_scan(seed))
    profiling.tracing(False)
    assert ranges.log == 2 * ([("predict.volume", 0)] + [(n, 1) for n in PREDICT_STAGES])
    spans = profiling.snapshot()["spans"]
    assert set(spans) == {"predict.volume", *PREDICT_STAGES}
    assert all(s["count"] == 2 for s in spans.values())
    vol = spans["predict.volume"]
    children = sum(spans[n]["seconds"] for n in PREDICT_STAGES)
    assert vol["self_seconds"] == pytest.approx(vol["seconds"] - children, abs=1e-9)
    assert vol["self_seconds"] < 0.05 * vol["seconds"]


def test_train_phases_tile_the_step(monkeypatch):
    ranges = _Ranges()
    monkeypatch.setattr(torch.profiler, "record_function", ranges)
    step, opt, batch = _train_step()
    gen = torch.Generator().manual_seed(1)
    opt, _ = step(opt, gen, batch)  # step 0, untraced
    profiling.tracing(True)
    step(opt, gen, batch)
    profiling.tracing(False)
    assert ranges.log == [("train.step", 0)] + [(n, 1) for n in TRAIN_PHASES]
    spans = profiling.snapshot()["spans"]
    assert set(spans) == {"train.step", *TRAIN_PHASES}
    whole = spans["train.step"]
    phases = sum(spans[n]["seconds"] for n in TRAIN_PHASES)
    assert whole["count"] == 1
    assert whole["self_seconds"] == pytest.approx(whole["seconds"] - phases, abs=1e-9)
    assert whole["self_seconds"] < 0.05 * whole["seconds"]


def test_self_seconds_on_a_fake_clock(monkeypatch):
    """a [0, 10] holds b [1, 4] (which holds c [2, 3]) and d [5, 9]; a
    second a [10, 12] holds nothing."""
    ticks = iter([0.0, 1.0, 2.0, 3.0, 4.0, 5.0, 9.0, 10.0, 10.0, 12.0])
    monkeypatch.setattr(profiling, "_clock", lambda: next(ticks))
    profiling.tracing(True)
    with profiling.span("a"):
        with profiling.span("b"):
            with profiling.span("c"):
                pass
        with profiling.span("d"):
            pass
    with profiling.span("a"):
        pass
    spans = profiling.snapshot()["spans"]
    assert spans == {"a": {"count": 2, "seconds": 12.0, "self_seconds": 5.0},
                     "b": {"count": 1, "seconds": 3.0, "self_seconds": 2.0},
                     "c": {"count": 1, "seconds": 1.0, "self_seconds": 1.0},
                     "d": {"count": 1, "seconds": 4.0, "self_seconds": 4.0}}


def test_a_span_in_another_thread_has_its_own_stack(monkeypatch):
    ticks = iter([0.0, 1.0, 5.0, 10.0])
    monkeypatch.setattr(profiling, "_clock", lambda: next(ticks))
    profiling.tracing(True)
    def worker():
        with profiling.span("worker"):
            pass

    with profiling.span("main"):
        t = threading.Thread(target=worker)
        t.start()
        t.join(timeout=30)
    assert not t.is_alive()
    spans = profiling.snapshot()["spans"]
    assert spans["main"] == {"count": 1, "seconds": 10.0, "self_seconds": 10.0}
    assert spans["worker"] == {"count": 1, "seconds": 4.0, "self_seconds": 4.0}


def test_totals_from_many_threads_lose_no_update():
    n_threads, n = 16, 300
    profiling.tracing(True)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def worker():
            for _ in range(n):
                with profiling.span("outer"):
                    with profiling.span("inner"):
                        profiling.count("hits")
                    profiling.count("weight", 0.5)

        threads = [threading.Thread(target=worker) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    snap = profiling.snapshot()
    assert snap["counters"] == {"hits": n_threads * n, "weight": 0.5 * n_threads * n}
    assert snap["spans"]["outer"]["count"] == snap["spans"]["inner"]["count"] == n_threads * n
    outer = snap["spans"]["outer"]
    assert outer["self_seconds"] == pytest.approx(
        outer["seconds"] - snap["spans"]["inner"]["seconds"], rel=1e-9, abs=1e-9)


def test_predict_spans_in_a_chrome_trace(predictor, tmp_path):
    """Under ``profiling.trace`` the spans are ``user_annotation`` ranges,
    each stage inside its volume's ``predict.volume``."""
    profiling.tracing(True)
    with profiling.trace(str(tmp_path)):
        predictor.predict_volume(*_scan())
    with open(tmp_path / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    ranges = {e["name"]: (e["ts"], e["ts"] + e["dur"]) for e in events
              if e.get("cat") == "user_annotation" and e["name"].startswith("predict.")}
    assert set(ranges) == {"predict.volume", *PREDICT_STAGES}
    lo, hi = ranges["predict.volume"]
    for name in PREDICT_STAGES:
        a, b = ranges[name]
        assert lo <= a <= b <= hi, name
    order = sorted(PREDICT_STAGES, key=lambda n: ranges[n][0])
    assert order == list(PREDICT_STAGES)


@pytest.mark.cuda
def test_conv_counters_match_launches_on_card():
    """One forward on a raw weight (packed at call time), one on a packed
    weight, one weight gradient and one mirrored weight gradient (C_out 1):
    ``conv.calls`` counts the calls, ``conv.packs`` the raw weight, and
    ``conv.host_s`` is their host time."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    import time

    conv_cf.build_kernels()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn(16, 8, 16, 32, device=dev, generator=gen).to(torch.bfloat16)
    w = 0.1 * torch.randn(3, 3, 3, 16, 24, device=dev, generator=gen)
    g = torch.randn(24, 8, 16, 32, device=dev, generator=gen).to(torch.bfloat16)
    g1 = torch.randn(1, 8, 16, 32, device=dev, generator=gen).to(torch.bfloat16)
    x32 = torch.randn(32, 8, 16, 32, device=dev, generator=gen).to(torch.bfloat16)
    packed = conv_cf.pack_conv(w, torch.bfloat16)
    conv_cf.conv3d_cf(x, w)  # warm
    torch.cuda.synchronize()
    profiling.reset()
    conv_cf.reset_launch_counts()
    profiling.tracing(True)
    t0 = time.perf_counter()
    a = conv_cf.conv3d_cf(x, w)
    b = conv_cf.conv3d_cf(x, packed)
    dw = conv_cf.conv3d_cf_wgrad(x, g)
    dw1 = conv_cf.conv3d_cf_wgrad(x32, g1)
    host = time.perf_counter() - t0
    profiling.tracing(False)
    torch.cuda.synchronize()
    snap = profiling.snapshot()
    launches = {k: v for k, v in snap["launches"].items() if v}
    assert launches == {"fwd_wg": 2, "wgrad_wg": 2}
    counters = snap["counters"]
    assert counters["conv.calls"] == sum(launches.values()) == 4
    assert counters["conv.packs"] == 1
    assert 0 < counters["conv.host_s"] <= host
    assert torch.equal(a, b) and dw.shape == (3, 3, 3, 16, 24) and dw1.shape == (3, 3, 3, 32, 1)
