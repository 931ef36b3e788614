"""The port's lab2im generator and ImageGenerator facade
(synthsr_tpu_torch/synth/lab2im.py, with the crop sampler and applier of
synth/augment.py) against synthsr_tpu/synth/lab2im.py.

The generator runs on JAX's draws, replayed from its key with the split
order of ``build_lab2im_generator`` (the replay helpers of
tests/test_torch_generator.py): image float32 within the ROADMAP bar (rtol
1e-5, atol 2e-4), labels exactly.  The facade mirrors the cases of
tests/test_lab2im.py:23,40,48,60; the crop sampler's own draws are held to
JAX's ``random_crop`` offsets by frequency.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_generator import _replay_deformation, _replay_intensity

from synthsr_tpu.io.volume import save_volume
from synthsr_tpu.synth import lab2im as jlab2im
from synthsr_tpu_torch.synth import augment, lab2im

torch.set_num_threads(2)

TOL = dict(rtol=1e-5, atol=2e-4)
GEN_LABELS = np.array([0, 2, 4], np.int32)


def _t(a):
    return torch.from_numpy(np.array(a))


def _replay_lab2im(cfg, key):
    """The draws of JAX build_lab2im_generator's generate (lab2im.py:91-126)."""
    keys = jax.random.split(key, 6)
    spatial, crop, nc = list(cfg.labels_shape), list(cfg.crop_shape), cfg.n_channels
    d = {"deformation": _replay_deformation(keys[0], None, spatial, spatial, 0.15, 10, 0.02,
                                            False, 4.0, 0.0625)}
    if crop != spatial:
        room = jnp.array([s - c for s, c in zip(spatial, crop)], jnp.float32)
        d["crop_idx"] = _t(jnp.floor(jax.random.uniform(keys[1], (3,)) * room)
                           .astype(jnp.int32)).long()
    d["gmm_noise"] = _t(jax.random.normal(keys[2], (*crop, nc)))
    k_std, k_field, k_prob = jax.random.split(keys[3], 3)
    std = jax.random.uniform(k_std, (1, 1, 1, nc), maxval=0.3)
    small = [int(np.ceil(s * 0.025)) for s in crop]
    d["bias"] = (_t(jax.random.normal(k_field, (*small, nc)) * std),
                 _t(jax.random.uniform(k_prob, ()) < 0.95))
    d["intensity"] = _replay_intensity(keys[4], (*crop, nc), gamma_std=0.2)
    d["blur"] = _t(jax.random.uniform(keys[5], (3,), minval=1 / cfg.blur_range,
                                      maxval=cfg.blur_range))
    return d


CASES = {"crop": dict(output_shape=16, target=1.0, n_channels=1),
         "resample": dict(output_shape=None, target=2.0, n_channels=1),
         "two_channels": dict(output_shape=20, target=1.0, n_channels=2)}


@pytest.mark.parametrize("case", sorted(CASES))
def test_lab2im_generator_matches_jax(case):
    c = CASES[case]
    shape = [24, 24, 24]
    crop, out = lab2im.get_shapes(shape, c["output_shape"], [1.0] * 3, [c["target"]] * 3, None)
    assert (crop, out) == tuple(jlab2im.get_shapes(shape, c["output_shape"], [1.0] * 3,
                                                   [c["target"]] * 3, None))
    kw = dict(labels_shape=shape, n_channels=c["n_channels"], generation_labels=GEN_LABELS,
              output_labels=np.array([0, 1, 1], np.int32),
              atlas_res=np.ones(3, np.float32),
              target_res=np.full(3, c["target"], np.float32), crop_shape=crop, out_shape=out)
    rng = np.random.default_rng(5)
    lab = np.zeros(shape, np.int32)
    lab[4:20, 4:20, 4:20] = rng.integers(0, 3, (16, 16, 16)) * 2
    means = rng.uniform(20, 200, (3, c["n_channels"])).astype(np.float32)
    stds = rng.uniform(1, 10, (3, c["n_channels"])).astype(np.float32)
    key = jax.random.PRNGKey(6)
    want = jax.jit(jlab2im.build_lab2im_generator(jlab2im.Lab2ImConfig(**kw)))(
        key, jnp.asarray(lab), jnp.asarray(means), jnp.asarray(stds))
    generator = lab2im.build_lab2im_generator(lab2im.Lab2ImConfig(**kw))
    draws = _replay_lab2im(generator.cfg, key)
    got = generator.apply(draws, _t(lab), _t(means), _t(stds))
    assert got[0].shape == (*out, c["n_channels"]) and got[1].shape == (*out, 1)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), **TOL)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    own = generator.sample(torch.Generator().manual_seed(0))
    assert own.keys() == draws.keys()
    assert own["deformation"].keys() == draws["deformation"].keys()


def test_crop_sampler_matches_jax_distribution():
    """The port's offsets against JAX random_crop's (10 000 each), per axis and
    value by frequency (within 0.02)."""
    from test_distributions import N, _draws

    spatial, crop = (24, 20, 17), (16, 16, 16)
    room = jnp.array([s - c for s, c in zip(spatial, crop)], jnp.float32)
    want = np.asarray(_draws(lambda k: jnp.floor(jax.random.uniform(k, (3,)) * room)))
    gen = torch.Generator().manual_seed(0)
    got = torch.stack([augment.sample_crop(gen, spatial, crop) for _ in range(N)]).numpy()
    for ax in range(3):
        for v in range(spatial[ax] - crop[ax]):
            assert abs(np.mean(got[:, ax] == v) - np.mean(want[:, ax] == v)) < 0.02, (ax, v)
        assert got[:, ax].max() < spatial[ax] - crop[ax] or spatial[ax] == crop[ax]


def test_random_crop_matches_jax():
    x = np.random.default_rng(7).normal(size=(12, 11, 10, 2)).astype(np.float32)
    key = jax.random.PRNGKey(8)
    from synthsr_tpu.synth import augment as jaug

    (want,) = jaug.random_crop(key, [jnp.asarray(x)], [8, 8, 8])
    idx = _t(jnp.floor(jax.random.uniform(key, (3,)) * jnp.array([4.0, 3.0, 2.0]))).long()
    (got,) = augment.random_crop([_t(x)], idx, [8, 8, 8])
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.fixture(scope="module")
def lab_dir(tmp_path_factory):
    """tests/test_lab2im.py's label maps."""
    root = tmp_path_factory.mktemp("lab2im")
    d = root / "labels"
    d.mkdir()
    rng = np.random.default_rng(0)
    for i in range(2):
        lab = np.zeros((24, 24, 24), np.int32)
        lab[4:20, 4:20, 4:20] = rng.integers(0, 3, (16, 16, 16)) * 2
        save_volume(lab, np.eye(4), None, str(d / f"m{i}.nii.gz"))
    return str(d)


def test_image_generator_basic(lab_dir):
    gen = lab2im.ImageGenerator(lab_dir, generation_labels=np.array([0, 2, 4]),
                                output_labels=np.array([0, 1, 1]), output_shape=16, seed=0,
                                device="cpu")
    image, labels = gen.generate_image()
    assert image.shape == (16, 16, 16) and labels.shape == (16, 16, 16)
    assert set(np.unique(labels)) <= {0, 1}
    assert 0 <= image.min() and image.max() <= 1 + 1e-5
    fg, bg = image[labels == 1], image[labels == 0]
    if len(fg) > 10 and len(bg) > 10:
        assert abs(fg.mean() - bg.mean()) > 1e-3
    again = lab2im.ImageGenerator(lab_dir, generation_labels=np.array([0, 2, 4]),
                                  output_labels=np.array([0, 1, 1]), output_shape=16, seed=0,
                                  device="cpu").generate_image()
    np.testing.assert_array_equal(again[0], image)
    assert np.abs(gen.generate_image()[0] - image).max() > 1e-4


def test_image_generator_resampled_output(lab_dir):
    gen = lab2im.ImageGenerator(lab_dir, generation_labels=np.array([0, 2, 4]),
                                target_res=2.0, seed=1, device="cpu")
    image, labels = gen.generate_image()
    assert image.shape == (12, 12, 12) and labels.shape == (12, 12, 12)


def test_image_generator_multichannel_specific_stats(lab_dir):
    pm = np.array([[0, 100, 200], [1, 2, 3], [50, 150, 250], [1, 2, 3]], np.float32)
    ps = np.abs(np.ones((4, 3), np.float32))
    gen = lab2im.ImageGenerator(lab_dir, generation_labels=np.array([0, 2, 4]), n_channels=2,
                                prior_means=pm, prior_stds=ps, prior_distributions="normal",
                                use_specific_stats_for_channel=True, seed=2, device="cpu")
    image, _ = gen.generate_image()
    assert image.shape[-1] == 2


def test_image_generator_specific_stats_validation(lab_dir):
    pm = np.ones((6, 3), np.float32)  # 3 blocks but 2 channels
    with pytest.raises(ValueError):
        lab2im.ImageGenerator(lab_dir, generation_labels=np.array([0, 2, 4]), n_channels=2,
                              prior_means=pm, prior_stds=np.ones((6, 3)),
                              use_specific_stats_for_channel=True, device="cpu")


def test_image_generator_needs_a_gpu_unless_asked_for_the_cpu(lab_dir):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="cpu"):
        lab2im.ImageGenerator(lab_dir, generation_labels=np.array([0, 2, 4]))
