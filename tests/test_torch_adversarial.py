"""The port's WGAN-GP fine-tuning (synthsr_tpu_torch/train/adversarial.py)
against the JAX package, and the training loop's mechanics at the tiny sizes
of tests/test_adversarial.py.

The two updates' losses and gradients are held against the JAX loss composed
from ``Discriminator3D.apply``, ``gradient_penalty``, ``UNet3D.apply`` and
``l1_loss`` on the same pre-drawn image, target, fake and interpolation
weight (the random draws themselves cannot match: Philox vs threefry), with
bridged parameters, in float32; the fast paths (kernels' plain versions on
the CPU) and the plain ones alike.  Tolerances: losses 1e-5 relative,
gradients those of the gradient penalty in tests/test_disc_fast.py (5e-4 /
5e-5).  JAX's ``training()`` is not run: its compiles are slow.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from synthsr_tpu.io.volume import save_volume
from synthsr_tpu.models.discriminator import Discriminator3D as FlaxDiscriminator3D
from synthsr_tpu.models.unet import UNet3D as FlaxUNet3D
from synthsr_tpu_torch.models.discriminator import Discriminator3D
from synthsr_tpu_torch.models.unet import UNet3D
from synthsr_tpu_torch.models.weights import (disc_state_dict_to_variables,
                                              disc_variables_to_state_dict,
                                              random_disc_variables, random_variables,
                                              state_dict_to_variables, variables_to_state_dict)
from synthsr_tpu_torch.train.adversarial import (critic_loss, generator_loss,
                                                 make_adversarial_steps, training)

torch.set_num_threads(2)

SPATIAL = (16, 16, 16)
CRITIC = dict(n_filters=4, n_levels=2)
NET = dict(nb_features=4, nb_levels=2, nb_conv_per_level=2, nb_labels=1)
LOSS = dict(rtol=1e-5, atol=1e-7)
GRAD = dict(rtol=5e-4, atol=5e-5)


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _cf(a):
    return None if a is None else _t(np.transpose(a, (0, 4, 1, 2, 3)))


def _close_trees(got, want, **tol):
    for layer, leaves in want.items():
        for key, arr in leaves.items():
            np.testing.assert_allclose(np.asarray(got[layer][key]), np.asarray(arr),
                                       err_msg=f"{layer}/{key}", **tol)


@pytest.fixture(scope="module")
def pair():
    """Pre-drawn values of one update, batch 2: image, target and fake (NDHWC),
    a 0/1 anatomy mask and the interpolation weights; bridged weights of a
    small generator and critic."""
    rng = np.random.default_rng(0)
    shape = (2, *SPATIAL, 1)
    image = rng.normal(size=shape).astype(np.float32)
    target = rng.normal(size=shape).astype(np.float32)
    fake = (0.5 * target + 0.3 * rng.normal(size=shape)).astype(np.float32)
    mask = (rng.uniform(size=shape) > 0.3).astype(np.float32)
    w = rng.uniform(size=(2, 1, 1, 1, 1)).astype(np.float32)
    critic_vars = random_disc_variables(SPATIAL, seed=5, **CRITIC)
    gen_vars = random_variables(NET, in_channels=1, seed=6)
    return dict(image=image, target=target, fake=fake, mask=mask, w=w, critic_vars=critic_vars,
                gen_vars=gen_vars)


def _port_critic(variables):
    critic = Discriminator3D(SPATIAL, **CRITIC)
    critic.load_state_dict(disc_variables_to_state_dict(variables))
    return critic


@pytest.mark.parametrize("masked", [False, True])
def test_critic_update_loss_and_grads_match_jax(pair, masked):
    """The critic update's WGAN-GP loss and its parameter gradient (fast: the
    first conv on the kernels' path and the unrolled penalty program; plain:
    double autograd) against jax.value_and_grad of the JAX loss."""
    from synthsr_tpu.train.adversarial import gradient_penalty

    flax_critic = FlaxDiscriminator3D(compute_dtype=jnp.float32, **CRITIC)
    target, fake, w = pair["target"], pair["fake"], pair["w"]
    mask = pair["mask"] if masked else None
    jmask = None if mask is None else jnp.asarray(mask)

    def jloss(p):
        x_hat = w * target + (1.0 - w) * fake
        d = flax_critic.apply({"params": p}, jnp.concatenate([target, fake]),
                              None if jmask is None else jnp.concatenate([jmask, jmask]))
        gp = gradient_penalty(lambda pp, x, m: flax_critic.apply({"params": pp}, x, m), p,
                              jnp.asarray(x_hat), jmask, 10.0)
        return jnp.mean(-d[:2]) + jnp.mean(d[2:]) + gp

    v_want, g_want = jax.value_and_grad(jloss)(
        jax.tree.map(jnp.asarray, pair["critic_vars"]["params"]))
    for fast in (True, False):
        critic = _port_critic(pair["critic_vars"])
        loss = critic_loss(critic, dict(critic.named_parameters()), _cf(target), _cf(fake),
                           _t(w), _cf(mask), 10.0, fast=fast)
        np.testing.assert_allclose(float(loss.detach()), float(v_want), **LOSS)
        grads = torch.autograd.grad(loss, list(critic.parameters()))
        sd = dict(zip([n for n, _ in critic.named_parameters()], grads))
        _close_trees(disc_state_dict_to_variables(sd)["params"], g_want, **GRAD)


@pytest.mark.parametrize("masked", [False, True])
def test_generator_update_loss_and_grads_match_jax(pair, masked):
    """The generator update's loss (w_D·mean(-D(fake)) + (1 - w_D)·L1 on the
    cropped residual prediction), its parameter gradient (through the critic:
    d(D(fake))/d(fake)) and the new BatchNorm statistics, fast and plain,
    against the JAX composition of UNet3D.apply(train=True),
    assemble_prediction, center_crop, l1_loss and Discriminator3D.apply."""
    from synthsr_tpu.ops.losses import l1_loss
    from synthsr_tpu.train.metrics import assemble_prediction, center_crop

    flax_unet = FlaxUNet3D(compute_dtype=jnp.float32, **NET)
    flax_critic = FlaxDiscriminator3D(compute_dtype=jnp.float32, **CRITIC)
    image, target = pair["image"], pair["target"]
    mask = pair["mask"] if masked else None
    cparams = jax.tree.map(jnp.asarray, pair["critic_vars"]["params"])
    gvars = jax.tree.map(jnp.asarray, pair["gen_vars"])

    def jloss(p):
        out, upd = flax_unet.apply({"params": p, "batch_stats": gvars["batch_stats"]},
                                   jnp.asarray(image), train=True, mutable=["batch_stats"])
        pred, _ = assemble_prediction(out, jnp.asarray(image), work_with_residual_channel=[0])
        l1 = l1_loss(center_crop(pred, 12), center_crop(jnp.asarray(target), 12))
        d = flax_critic.apply({"params": cparams}, pred,
                              None if mask is None else jnp.asarray(mask))
        return 0.01 * jnp.mean(-d) + 0.99 * l1, upd["batch_stats"]

    (v_want, stats_want), g_want = jax.value_and_grad(jloss, has_aux=True)(gvars["params"])
    critic = _port_critic(pair["critic_vars"])
    frozen = {n: p.detach() for n, p in critic.named_parameters()}
    for fast in (True, False):
        model = UNet3D(in_channels=1, **NET)
        model.load_state_dict(variables_to_state_dict(pair["gen_vars"]))
        loss, stats = generator_loss(model, critic, frozen, _t(image), _t(target), _cf(mask),
                                     residual_indices=[0], loss_cropping=12,
                                     relative_weight_discriminator=0.01,
                                     compute_dtype=torch.float32, fast=fast)
        np.testing.assert_allclose(float(loss.detach()), float(v_want), **LOSS)
        grads = torch.autograd.grad(loss, list(model.parameters()))
        sd = dict(model.state_dict())
        sd.update({n: g for (n, _), g in zip(model.named_parameters(), grads)})
        _close_trees(state_dict_to_variables(sd)["params"], g_want, **GRAD)
        for name, (mu, var) in stats.items():
            np.testing.assert_allclose(mu.detach().numpy(), stats_want[name]["mean"],
                                       rtol=1e-5, atol=1e-6)
            np.testing.assert_allclose(var.detach().numpy(), stats_want[name]["var"],
                                       rtol=1e-5, atol=1e-6)


def test_nonfinite_loss_gates_both_updates():
    """A non-finite loss writes nothing: not the critic, not the generator's
    parameters or BatchNorm statistics, not either Adam state; the lagged
    guard names the loss and the step."""
    from synthsr_tpu_torch.train.training import init_unet
    from synthsr_tpu_torch.utils.finite_guard import FiniteGuard, adam_init

    gen_model = init_unet(UNet3D(in_channels=1, **NET))
    critic = _port_critic(random_disc_variables(SPATIAL, seed=1, **CRITIC))
    before = {k: v.clone() for k, v in [*gen_model.state_dict().items(),
                                        *critic.state_dict().items()]}

    def generator(gen, labels, means, stds):
        image = torch.randn((*SPATIAL, 1), generator=gen)
        return image, image * means[0, 0]

    disc_step, gen_step = make_adversarial_steps(
        gen_model, critic, generator, lambda gen: (torch.full((3, 1), float("nan")), None),
        compute_dtype=torch.float32)
    gen = torch.Generator().manual_seed(0)
    batch = [torch.zeros((1, *SPATIAL, 1), dtype=torch.int32)]
    d_opt, d_loss = disc_step(adam_init(list(critic.parameters())), gen, batch)
    g_opt, g_loss = gen_step(adam_init(list(gen_model.parameters())), gen, batch)
    assert not np.isfinite(float(d_loss)) and not np.isfinite(float(g_loss))
    after = {**gen_model.state_dict(), **critic.state_dict()}
    for k, v in before.items():
        assert torch.equal(v, after[k]), k
    for opt in (d_opt, g_opt):
        assert int(opt["count"]) == 0 and all(not m.any() for m in opt["mu"] + opt["nu"])
    guard = FiniteGuard(lag=1, what="discriminator loss")
    guard.push("epoch 1 step 1", d_loss)
    with pytest.raises(FloatingPointError, match="discriminator loss at epoch 1 step 1"):
        guard.flush()


# ---------------------------------------------------------------------------
# the loop (tests/test_adversarial.py:106,134,392 at their tiny sizes)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def adv_dataset(tmp_path_factory):
    root = tmp_path_factory.mktemp("advdata")
    lab_dir, img_dir = root / "labels", root / "images"
    lab_dir.mkdir()
    img_dir.mkdir()
    rng = np.random.default_rng(0)
    for i in range(2):
        lab = np.zeros((24, 24, 24), np.int32)
        lab[4:20, 4:20, 4:20] = rng.integers(0, 3, (16, 16, 16)) * 2
        save_volume(lab, np.eye(4), None, str(lab_dir / f"m{i}.nii.gz"))
        img = (lab > 0) * 100.0 + rng.normal(0, 5, lab.shape)
        save_volume(img.astype(np.float32), np.eye(4), None, str(img_dir / f"m{i}.nii.gz"))
    np.save(str(root / "gen_labels.npy"), np.array([0, 2, 4], np.int32))
    return str(lab_dir), str(img_dir), str(root / "gen_labels.npy")


def _run(adv_dataset, model_dir, logs=None, **kw):
    lab_dir, img_dir, labels_npy = adv_dataset
    args = dict(prior_means=None, prior_stds=None, path_generation_labels=labels_npy,
                prior_distributions="uniform", output_channel=None, output_shape=16,
                randomise_res=True, n_levels=2, unet_feat_count=2, nb_conv_per_level=1,
                nonlin_std=0, simulate_registration_error=False, loss_cropping=12, epochs=1,
                steps_per_epoch=2, first_training_ratio=1, training_ratio=1, seed=0,
                compute_dtype="float32", device="cpu",
                log_fn=(lambda s: None) if logs is None else logs.append)
    args.update(kw)
    return training(lab_dir, img_dir, str(model_dir), **args)


def test_short_run_then_resume(adv_dataset, tmp_path):
    """1 epoch of 2 steps with 3 critic updates on the first step and 1 after
    (4 in all), the per-epoch files, then a resume to epoch 2 (2 critic
    updates: first_training_ratio holds only for the run's very first
    step)."""
    model_dir = tmp_path / "adv"
    logs = []
    first = _run(adv_dataset, model_dir, logs, first_training_ratio=3)
    assert any("4 critic updates" in line for line in logs), logs
    files = sorted(os.listdir(model_dir))
    assert "adv_001.pt" in files
    assert {"generator_1.h5", "discriminator_1.h5"} <= set(files) or \
        any("h5py is not installed" in line for line in logs)
    for name in ("discriminator_loss.npy", "generator_loss.npy"):
        assert os.path.isfile(model_dir / "logs" / name)
    assert np.isfinite(first["d_curve"][0]) and np.isfinite(first["g_curve"][0])

    logs2 = []
    resumed = _run(adv_dataset, model_dir, logs2, first_training_ratio=3, epochs=2)
    assert "resuming from epoch 1" in logs2
    assert any("Epoch 2/2" in line and "2 critic updates" in line for line in logs2), logs2
    assert not any("Epoch 1/2" in line for line in logs2)
    assert resumed["d_curve"][0] == first["d_curve"][0] and len(resumed["d_curve"]) == 2
    np.testing.assert_array_equal(np.load(model_dir / "logs" / "generator_loss.npy"),
                                  resumed["g_curve"])
    assert os.path.isfile(model_dir / "adv_002.pt")


def test_seeded_fast_off_and_mask(adv_dataset, tmp_path):
    """With an anatomy mask: two seeded fast runs give the same curves, and
    fast_forward="off" (the plain networks, the penalty by double autograd)
    reproduces them (tests/test_adversarial.py:134)."""
    curves = []
    for i, mode in enumerate(("auto", "auto", "off")):
        out = _run(adv_dataset, tmp_path / f"m{i}", labels_to_mask=np.array([0, 1, 1]),
                   fast_forward=mode)
        curves.append((out["d_curve"], out["g_curve"]))
    assert curves[0] == curves[1]
    np.testing.assert_allclose(curves[2][0], curves[0][0], rtol=1e-5)
    np.testing.assert_allclose(curves[2][1], curves[0][1], rtol=1e-5)
    assert np.isfinite(curves[0][0][0])


def test_odd_critic_size_fast_matches_off(adv_dataset, tmp_path, monkeypatch):
    """An output shape the generator pads for but that turns odd in the
    critic (20 -> 10 -> 5 -> 3 -> 2) takes the critic's kernel paths, with
    no fallback (each of the 2 critic updates runs the penalty's program),
    and reproduces fast_forward="off"."""
    from synthsr_tpu_torch.train import adversarial

    calls = []
    program = adversarial.fast_disc_input_grad
    monkeypatch.setattr(adversarial, "fast_disc_input_grad",
                        lambda *a, **k: calls.append(1) or program(*a, **k))
    curves = [_run(adv_dataset, tmp_path / mode, output_shape=20, loss_cropping=16,
                   fast_forward=mode) for mode in ("auto", "off")]
    assert len(calls) == 2
    assert curves[0]["critic"].input_shape == (20, 20, 20)
    np.testing.assert_allclose(curves[1]["d_curve"], curves[0]["d_curve"], rtol=1e-5)
    np.testing.assert_allclose(curves[1]["g_curve"], curves[0]["g_curve"], rtol=1e-5)


def test_unported_options_raise(adv_dataset, tmp_path):
    """The options that raised before they were ported run: the frozen
    segmenter (a ``.pt``; without ``images_dir`` it fails, as in JAX) and
    several output channels on the kernels' paths; n_devices > 1 without a
    process group raises, naming how to launch it; without a GPU the default
    device raises."""
    cfg = dict(nb_features=2, nb_levels=2, nb_conv_per_level=1, nb_labels=3,
               final_pred_activation="softmax")
    torch.save(variables_to_state_dict(random_variables(cfg, in_channels=1, seed=3)),
               str(tmp_path / "seg.pt"))
    np.save(str(tmp_path / "eq.npy"), np.array([0, 2, 4]))
    seg = dict(segmentation_model_file=str(tmp_path / "seg.pt"),
               path_segmentation_equivalency=str(tmp_path / "eq.npy"))
    out = _run(adv_dataset, tmp_path / "a", **seg)
    assert np.isfinite(out["d_curve"][0]) and np.isfinite(out["g_curve"][0])
    lab_dir, _, labels_npy = adv_dataset
    with pytest.raises(ValueError, match="images_dir"):
        _run((lab_dir, None, labels_npy), tmp_path / "a2", output_channel=[0], **seg)
    out = _run((lab_dir, None, labels_npy), tmp_path / "two", output_channel=[0, 1],
               input_channels=[True, True], prior_means=np.array([[10.0] * 3, [20.0] * 3] * 2),
               prior_stds=np.array([[1.0] * 3, [2.0] * 3] * 2))
    assert out["gen_model"].likelihood.out_channels == 2 and np.isfinite(out["g_curve"][0])
    with pytest.raises(RuntimeError, match="--n_devices"):
        _run(adv_dataset, tmp_path / "b", n_devices=2)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            _run(adv_dataset, tmp_path / "c", device=None)
