"""Data parallelism of the port (``synthsr_tpu_torch/parallel/mesh.py`` and the
``group`` of the train steps): two gloo processes at batch 1 each must equal
one process at batch 2, for ``make_train_step``, for the adversarial steps
and for ``training(n_devices=2)`` through the train CLI, after the JAX tests
tests/test_train_fast.py:227 and tests/test_adversarial.py:240,269.  Their
tolerances: loss rtol 1e-5; parameters and BatchNorm statistics atol 1e-5;
with Adam after the critic's batched backward, whose float32 sums reduce in
another order per rank, parameters within 2·lr and 95% of them within 1e-5.

Every multi-process run enforces its own time limit (``spawn(timeout=...)``
kills the ranks and fails) and rendezvouses through a file under the test's
``tmp_path``, so parallel test workers cannot collide.  The workers import
nothing of JAX.
"""

import os

import numpy as np
import pytest
import torch

from synthsr_tpu_torch.parallel.mesh import data_group, spawn

torch.set_num_threads(2)

TIMEOUT = 240  # seconds for two ranks to start, run and exit
LR = 1e-3


def _launch(worker, tmp_path, *args):
    spawn(worker, 2, (str(tmp_path), *args), device_type="cpu", timeout=TIMEOUT,
          rendezvous_dir=str(tmp_path / "rdv"))


def _labels(n=2):
    rng = np.random.default_rng(5)
    return torch.from_numpy(rng.integers(0, 3, (n, 16, 16, 16, 1)).astype(np.int32) * 2)


def _gen_config(**kw):
    from synthsr_tpu_torch.synth.labels_to_image import GenerationConfig

    return GenerationConfig(
        labels_shape=[16, 16, 16], input_channels=[True], output_channel=[0],
        generation_labels=np.array([0, 2, 4], np.int32), n_neutral_labels=3,
        atlas_res=[1.0, 1.0, 1.0], output_shape=16, output_div_by_n=4, flipping=True,
        aff=np.eye(4), randomise_res=False, nonlin_std=0.0,
        data_res=np.array([[1.0, 1.0, 2.0]]), downsample=True, **kw)


def _sampler():
    rng = np.random.default_rng(0)
    means = torch.from_numpy(rng.uniform(20, 200, (3, 1)).astype(np.float32))
    stds = torch.from_numpy(rng.uniform(1, 10, (3, 1)).astype(np.float32))
    return lambda g: (means + torch.rand((3, 1), generator=g), stds)


def _train_step(case, group, labels, remat):
    """One make_train_step (float32, lr 1e-3) from a seeded initialisation:
    (loss, parameters, BatchNorm running statistics).  ``case`` "fast": the
    fast train forward with the frozen segmenter's Dice term; "plain": a
    dropout model on the plain forward_train."""
    from synthsr_tpu_torch.models.unet import UNet3D
    from synthsr_tpu_torch.models.weights import random_variables, variables_to_state_dict
    from synthsr_tpu_torch.synth.labels_to_image import build_generator
    from synthsr_tpu_torch.train.metrics import build_seg_loss_fn
    from synthsr_tpu_torch.train.training import init_unet, make_train_step
    from synthsr_tpu_torch.utils.finite_guard import adam_init

    fast = case == "fast"
    model = init_unet(UNet3D(in_channels=2, nb_features=2, nb_levels=2, nb_conv_per_level=1,
                             conv_dropout=0.0 if fast else 0.3), seed=1)
    seg_fn = None
    if fast:
        cfg = dict(nb_features=2, nb_levels=2, nb_conv_per_level=1, nb_labels=3,
                   final_pred_activation="softmax")
        seg = UNet3D(in_channels=1, **cfg)
        seg.load_state_dict(variables_to_state_dict(random_variables(cfg, 1, seed=4)))
        seg_fn = build_seg_loss_fn(seg, [0, 2, 4], [0, 2, 4], 12, m=0.0, M=1.0)
    step = make_train_step(
        model, build_generator(_gen_config(build_reliability_maps=True,
                                           simulate_registration_error=False),
                               return_labels=fast),
        _sampler(), LR, loss_cropping=12, residual_indices=[0], compute_dtype=torch.float32,
        seg_loss_fn=seg_fn, remat=remat, group=group)
    _, loss = step(adam_init(list(model.parameters())), torch.Generator().manual_seed(7),
                   [labels])
    stats = {k: v for k, v in model.state_dict().items() if "running" in k}
    return float(loss), [p.detach().clone() for p in model.parameters()], stats


def _train_step_worker(rank, world, out_dir, case):
    torch.set_num_threads(1)
    labels = _labels()[rank:rank + 1]  # this rank's contiguous slice
    result = _train_step(case, data_group(world), labels, remat="levels")
    torch.save(result, os.path.join(out_dir, f"rank{rank}.pt"))


@pytest.mark.parametrize("case", ["fast", "plain"])
def test_train_step_two_ranks_equal_batch_two(case, tmp_path):
    """make_train_step on 2 gloo ranks at batch 1 each (remat "levels" there)
    equals one process at batch 2: the per-example draws derive from the
    global example index, BatchNorm's statistics span the ranks inside the
    net, gradients and loss are averaged; both ranks hold the same
    parameters afterwards."""
    want_loss, want_params, want_stats = _train_step(case, None, _labels(), remat=False)
    _launch(_train_step_worker, tmp_path, case)
    ranks = [torch.load(str(tmp_path / f"rank{r}.pt"), weights_only=False) for r in range(2)]
    for loss, params, stats in ranks:
        np.testing.assert_allclose(loss, want_loss, rtol=1e-5)
        for a, b in zip(params, want_params):
            np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5)
        for k, v in want_stats.items():
            np.testing.assert_allclose(stats[k].numpy(), v.numpy(), atol=1e-5, err_msg=k)
    for a, b in zip(ranks[0][1], ranks[1][1]):
        assert torch.equal(a, b)


def _adversarial(group, labels):
    """One critic update and one generator update (float32, Adam lr 1e-3) of
    make_adversarial_steps from seeded networks: (critic loss, generator
    loss, generator parameters, critic parameters)."""
    from synthsr_tpu_torch.models.discriminator import Discriminator3D
    from synthsr_tpu_torch.models.unet import UNet3D
    from synthsr_tpu_torch.models.weights import (disc_variables_to_state_dict,
                                                  random_disc_variables)
    from synthsr_tpu_torch.synth.labels_to_image import build_generator
    from synthsr_tpu_torch.train.adversarial import make_adversarial_steps
    from synthsr_tpu_torch.train.training import init_unet
    from synthsr_tpu_torch.utils.finite_guard import adam_init

    gen_model = init_unet(UNet3D(in_channels=1, nb_features=2, nb_levels=2,
                                 nb_conv_per_level=1), seed=2)
    critic = Discriminator3D((16, 16, 16), n_filters=4, n_levels=2)
    critic.load_state_dict(disc_variables_to_state_dict(
        random_disc_variables((16, 16, 16), n_filters=4, n_levels=2, seed=3)))
    disc_step, gen_step = make_adversarial_steps(
        gen_model, critic, build_generator(_gen_config(build_reliability_maps=False,
                                                       simulate_registration_error=False)),
        _sampler(), lr_generator=LR, lr_discriminator=LR, residual_indices=[0],
        loss_cropping=12, compute_dtype=torch.float32, group=group)
    gen = torch.Generator().manual_seed(11)
    _, d_loss = disc_step(adam_init(list(critic.parameters())), gen, [labels])
    _, g_loss = gen_step(adam_init(list(gen_model.parameters())), gen, [labels])
    return (float(d_loss), float(g_loss), [p.detach().clone() for p in gen_model.parameters()],
            [p.detach().clone() for p in critic.parameters()])


def _adversarial_worker(rank, world, out_dir):
    torch.set_num_threads(1)
    result = _adversarial(data_group(world), _labels()[rank:rank + 1])
    torch.save(result, os.path.join(out_dir, f"rank{rank}.pt"))


def _adam_band(got, want):
    """Adam's first steps move each parameter by about ±lr whatever the
    gradient's size, so a float32 reduction-order residue that flips the sign
    of a near-zero gradient moves it by up to 2·lr
    (tests/test_adversarial.py:269): the bound, and 95% of the elements
    within 1e-5."""
    diffs = torch.cat([(a - b).abs().reshape(-1) for a, b in zip(got, want)]).numpy()
    assert diffs.max() <= 2 * LR, diffs.max()
    assert (diffs <= 1e-5).mean() >= 0.95, (diffs <= 1e-5).mean()


def test_adversarial_steps_two_ranks_equal_batch_two(tmp_path):
    """The critic and generator updates on 2 gloo ranks at batch 1 each equal
    one process at batch 2: the interpolation weights and generation draws
    come from the per-example generators, both updates average gradients
    and losses; the ranks end with the same networks."""
    want = _adversarial(None, _labels())
    _launch(_adversarial_worker, tmp_path)
    ranks = [torch.load(str(tmp_path / f"rank{r}.pt"), weights_only=False) for r in range(2)]
    for d_loss, g_loss, gen_params, critic_params in ranks:
        np.testing.assert_allclose(d_loss, want[0], rtol=1e-5)
        np.testing.assert_allclose(g_loss, want[1], rtol=1e-5)
        _adam_band(gen_params, want[2])
        _adam_band(critic_params, want[3])
    for a, b in zip(ranks[0][2] + ranks[0][3], ranks[1][2] + ranks[1][3]):
        assert torch.equal(a, b)


def _cli_args(lab_dir, labels_npy, model_dir):
    return [lab_dir, model_dir, "100", "10", labels_npy, "--prior_distributions", "uniform",
            "--output_shape", "16", "--work_with_residual_channel", "0", "--loss_cropping", "12",
            "--n_levels", "2", "--unet_feat_count", "2", "--nb_conv_per_level", "1",
            "--epochs", "1", "--steps_per_epoch", "2", "--batchsize", "2", "--nonlin_std", "0",
            "--no_registration_error", "--compute_dtype", "float32", "--lr", "1e-3",
            "--seed", "0", "--cpu"]


def test_train_cli_n_devices_two_equals_one_process(tmp_path):
    """``cli.train --n_devices 2 --cpu`` (two spawned gloo ranks, each fed its
    half of the global batch by build_model_inputs' local_slice; 1 example
    per rank, so no remat by default, where the one process at batch 2
    takes remat "levels") writes the same epoch checkpoint and loss as one
    process at batch 2; rank 0 alone writes them."""
    from synthsr_tpu.io.volume import save_volume
    from synthsr_tpu_torch.cli.train import main

    lab_dir = tmp_path / "labels"
    lab_dir.mkdir()
    rng = np.random.default_rng(0)
    for i in range(3):
        lab = np.zeros((24, 24, 24), np.int32)
        lab[4:20, 4:20, 4:20] = rng.integers(0, 3, (16, 16, 16)) * 2
        save_volume(lab, np.eye(4), None, str(lab_dir / f"m{i}.nii.gz"))
    labels_npy = str(tmp_path / "gen_labels.npy")
    np.save(labels_npy, np.array([0, 2, 4], np.int32))
    one = main(_cli_args(str(lab_dir), labels_npy, str(tmp_path / "one")), log_fn=lambda s: None)
    assert main(_cli_args(str(lab_dir), labels_npy, str(tmp_path / "two"))
                + ["--n_devices", "2"], log_fn=lambda s: None) is None
    ck = {n: torch.load(str(tmp_path / n / "001.pt"), weights_only=True) for n in ("one", "two")}
    np.testing.assert_allclose(np.load(str(tmp_path / "two" / "logs" / "loss_curve.npy")),
                               one["loss_curve"], rtol=1e-5)
    for k, v in ck["one"]["model"].items():
        if "running" in k:
            np.testing.assert_allclose(ck["two"]["model"][k].numpy(), v.numpy(), atol=1e-5,
                                       err_msg=k)
    _adam_band([v for k, v in ck["two"]["model"].items() if k.endswith(("weight", "bias"))],
               [v for k, v in ck["one"]["model"].items() if k.endswith(("weight", "bias"))])
    assert int(ck["two"]["adam"]["count"]) == 2
    with open(str(tmp_path / "two" / "logs" / "training_log.jsonl")) as f:
        assert len(f.readlines()) == 1  # rank 0 alone logs


def test_no_group_raises_and_world_size_one_group_is_none():
    with pytest.raises(RuntimeError, match="spawn"):
        data_group(2)
    assert data_group(None) is None and data_group(1) is None
