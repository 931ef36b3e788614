"""``Generator.__call__`` on the card (``synth/labels_to_image.py``): ``apply``
captured as a CUDA graph once per input signature and replayed.  At
tutorial 7's shapes (160³ label maps, a 128³ crop, 3 channels, reliability
maps) the replays must equal eager ``apply`` on the same draws bit for bit,
the draws must come through ``sample`` (as the benchmark's train check
records them), and after the capture ``generate_batch`` must not wait on the
card.  On the CPU every case skips.

This file imports nothing of JAX, so it runs on the card with
``--noconftest``.
"""

import numpy as np
import pytest
import torch

from synthsr_tpu_torch.synth import labels_to_image as l2i
from synthsr_tpu_torch.synth.sampling import make_gmm_sampler
from synthsr_tpu_torch.train.training import example_generators, generate_batch
from synthsr_tpu_torch.utils import profiling

torch.set_num_threads(2)

_SIDED = np.array([0, 24, 2, 3, 41, 42], np.int32)

# tutorial-7 as benchmark/configs/tutorial7-sr.json sets it
TUTORIAL7 = dict(
    labels_shape=[160, 160, 160], input_channels=[False, True, True], output_channel=[0],
    output_shape=128, output_div_by_n=16, scaling_bounds=0.1, rotation_bounds=8,
    shearing_bounds=0.01, translation_bounds=False, nonlin_std=2.0, nonlin_shape_factor=0.03125,
    bias_field_std=0.2, bias_shape_factor=0.03125,
    data_res=np.array([[1.0, 1.0, 3.0], [1.0, 4.5, 1.0]]),
    thickness=np.array([[1.0, 1.0, 3.0], [1.0, 3.0, 1.0]]), downsample=True, blur_range=1.15,
    build_reliability_maps=True, simulate_registration_error=True, randomise_res=False)

# a drawn acquisition resolution: mimic_acquisition's path
RANDOMISE_RES = dict(
    labels_shape=[64, 64, 64], input_channels=[True], output_channel=[0], target_res=2.0,
    output_shape=32, randomise_res=True, nonlin_std=3.0, build_reliability_maps=True,
    bias_shape_factor=0.125)


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def _setup(case, dev, batch=2, seed=0):
    """(generator, GMM sampler, label batch (B, X, Y, Z, 1) int32 on ``dev``)."""
    generator = l2i.build_generator(l2i.GenerationConfig(
        **case, generation_labels=_SIDED, n_neutral_labels=2, atlas_res=[1.0, 1.0, 1.0],
        flipping=True, aff=np.eye(4)))
    sampler = make_gmm_sampler(len(_SIDED), None, None, n_channels=generator.cfg.n_channels)
    rng = np.random.default_rng(seed)
    shape = case["labels_shape"]
    lab = np.zeros((batch, *shape, 1), np.int32)
    inner = (slice(None),) + tuple(slice(s // 8, s - s // 8) for s in shape)
    lab[inner] = rng.choice(_SIDED[1:], size=lab[inner].shape)
    return generator, sampler, torch.from_numpy(lab).to(dev)


def _recording(generator, sampler):
    """Swap ``generator.sample`` on the instance and wrap the sampler, as the
    benchmark's train check does: returns (sampler, the records), each
    example's (draws, means, stds)."""
    records, sample = [], generator.sample

    def sample_recorded(gen):
        records[-1].append(sample(gen))
        return records[-1][-1]

    def sampler_recorded(gen):
        params = sampler(gen)
        records.append(list(params))
        return params

    generator.sample = sample_recorded
    return sampler_recorded, records


def _counters():
    c = profiling.snapshot()["counters"]
    return [c.get(f"generator.{n}", 0) for n in ("captures", "replays", "eager")]


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["tutorial7", "randomise_res"])
def test_replays_equal_eager_apply(case):
    """Five steps at batch 2: one capture, then replays; each example's
    pair bit-equal to eager ``apply`` on the draws its ``sample`` override
    recorded (a replay that overwrote the first example's outputs, or read
    stale draws, would differ); the override was called for every example."""
    dev = _card()
    cfg = {"tutorial7": TUTORIAL7, "randomise_res": RANDOMISE_RES}[case]
    generator, sampler, labels = _setup(cfg, dev)
    sampler, records = _recording(generator, sampler)
    was = profiling.tracing(True)
    profiling.reset()
    try:
        for seed in range(5):
            step_gen = torch.Generator().manual_seed(1000 + seed)
            image, target = generate_batch(generator, sampler,
                                           example_generators(step_gen, 2, 0, dev), (labels,))
            assert image.shape[0] == 2
            for i, (means, stds, draws) in enumerate(records[-2:]):
                want = generator.apply(draws, labels[i], means, stds)
                assert torch.equal(image[i], want[0]), (seed, i)
                assert torch.equal(target[i], want[1]), (seed, i)
            assert not torch.equal(image[0], image[1])
        counters = _counters()
    finally:
        profiling.tracing(was)
    assert len(records) == 10 and all(len(r) == 3 for r in records)
    assert counters == [1, 9, 0]


@pytest.mark.cuda
def test_generate_batch_does_not_wait_on_the_card():
    """After the capture, a whole ``generate_batch`` (the step's example
    generators, the GMM draws, ``sample``, the copies, the replay) raises
    nothing under PyTorch's sync debug mode."""
    dev = _card()
    generator, sampler, labels = _setup(TUTORIAL7, dev)
    step_gen = torch.Generator().manual_seed(7)
    generate_batch(generator, sampler, example_generators(step_gen, 2, 0, dev), (labels,))
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = generate_batch(generator, sampler, example_generators(step_gen, 2, 0, dev),
                             (labels,))
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert out[0].shape == (2, 128, 128, 128, 4) and out[1].shape == (2, 128, 128, 128, 1)
    assert torch.isfinite(out[0]).all()


@pytest.mark.cuda
def test_a_second_label_shape_captures_again():
    """Label maps of another shape are another signature: one more capture,
    its replays equal to eager ``apply``, and the first shape still
    replays."""
    dev = _card()
    generator, sampler, labels = _setup(TUTORIAL7, dev, batch=1)
    other = labels[:, 8:-8, 8:-8, 8:-8].contiguous()
    sampler, records = _recording(generator, sampler)
    was = profiling.tracing(True)
    profiling.reset()
    try:
        for step, lab in enumerate((labels, other, other, labels)):
            step_gen = torch.Generator().manual_seed(step)
            image, target = generate_batch(generator, sampler,
                                           example_generators(step_gen, 1, 0, dev), (lab,))
            means, stds, draws = records[-1]
            want = generator.apply(draws, lab[0], means, stds)
            assert torch.equal(image[0], want[0]) and torch.equal(target[0], want[1]), step
        counters = _counters()
    finally:
        profiling.tracing(was)
    assert counters == [2, 2, 0]
    assert len(generator._graphs) == 2
