"""The frozen-segmenter Dice regulariser of the port
(``synthsr_tpu_torch.train.metrics.build_seg_loss_fn``, its setup in
``train/training.py`` and its term in the adversarial generator update)
against the JAX package's ``build_seg_loss_fn``
(``synthsr_tpu/train/training.py:82-121``) on the same prediction, labels and
segmenter weights, float32: the loss and d(loss)/d(prediction) within 1e-5.
The JAX package has no test of this path of its own.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from synthsr_tpu.models.unet import UNet3D as FlaxUNet3D
from synthsr_tpu_torch.models.unet import UNet3D
from synthsr_tpu_torch.models.weights import random_variables, variables_to_state_dict
from synthsr_tpu_torch.train.metrics import build_seg_loss_fn

torch.set_num_threads(2)

SEG = dict(nb_features=4, nb_levels=2, nb_conv_per_level=2, final_pred_activation="softmax")
GEN_LABELS = np.array([0, 2, 4, 7], np.int32)
# segmenter outputs -> generation label values: label 2 merges outputs 1 and 3,
# label 7 has no output (no Dice class), output 4 maps to no generation label
EQUIVALENCY = np.array([0, 2, 4, 2, 9], np.int32)
TOL = dict(rtol=1e-5, atol=1e-5)


def _segmenter(seed=4):
    cfg = dict(SEG, nb_labels=len(EQUIVALENCY))
    variables = random_variables(cfg, in_channels=1, seed=seed)
    model = UNet3D(in_channels=1, **cfg)
    model.load_state_dict(variables_to_state_dict(variables))
    return cfg, variables, model


def _inputs(shape=(2, 16, 16, 16)):
    rng = np.random.default_rng(0)
    pred = rng.uniform(-0.5, 1.5, shape + (1,)).astype(np.float32)
    labels = rng.choice(GEN_LABELS, shape + (1,)).astype(np.int32)
    return pred, labels


@pytest.mark.parametrize("fs_header", [False, True], ids=["ras", "fs_header"])
@pytest.mark.parametrize("bounds", [None, (-0.2, 1.1)], ids=["no_norm", "clip_norm"])
def test_seg_loss_matches_jax(fs_header, bounds):
    """Loss and its gradient with respect to the prediction, with and without
    the FreeSurfer header swap and the m/M clip-normalisation, a merge of 2
    outputs into one class, and the one-hot of the label value."""
    from synthsr_tpu.train.training import build_seg_loss_fn as jax_build

    cfg, variables, model = _segmenter()
    pred, labels = _inputs()
    m, M = bounds if bounds is not None else (None, None)
    jax_fn = jax_build(FlaxUNet3D(compute_dtype=jnp.float32, **cfg), variables, GEN_LABELS,
                       EQUIVALENCY, 12, m=m, M=M, fs_header=fs_header)
    want, want_grad = jax.value_and_grad(lambda p: jax_fn(p, jnp.asarray(labels)))(
        jnp.asarray(pred))
    fn = build_seg_loss_fn(model, GEN_LABELS, EQUIVALENCY, 12, m=m, M=M, fs_header=fs_header)
    x = torch.from_numpy(pred).requires_grad_(True)
    got = fn(x, torch.from_numpy(labels))
    (grad,) = torch.autograd.grad(got, x)
    np.testing.assert_allclose(float(got.detach()), float(want), **TOL)
    np.testing.assert_allclose(grad.numpy(), np.asarray(want_grad), **TOL)
    assert 0.0 < float(got.detach()) < 1.0
    assert not any(p.requires_grad for p in model.parameters()) and not model.training


def test_more_than_three_merged_outputs_raise():
    _, _, model = _segmenter()
    with pytest.raises(ValueError, match="more than 3"):
        build_seg_loss_fn(model, GEN_LABELS, np.array([2, 2, 2, 2, 0]), None)


def _train_kwargs(tiny_dataset, model_dir):
    lab_dir, labels_npy = tiny_dataset
    return dict(
        labels_dir=lab_dir, model_dir=model_dir, prior_means=None, prior_stds=None,
        path_generation_labels=labels_npy, prior_distributions="uniform", batchsize=1,
        output_channel=0, output_shape=16, data_res=np.array([1.0, 1.0, 2.0]),
        work_with_residual_channel=0, loss_cropping=12, n_levels=2, unet_feat_count=2,
        nb_conv_per_level=1, lr=0.0, epochs=1, steps_per_epoch=2, seed=0,
        simulate_registration_error=False, compute_dtype="float32", nonlin_std=0.0,
        device="cpu", log_fn=lambda s: None)


@pytest.fixture(scope="module")
def tiny_dataset(tmp_path_factory):
    from synthsr_tpu.io.volume import save_volume

    root = tmp_path_factory.mktemp("segdata")
    (root / "labels").mkdir()
    rng = np.random.default_rng(0)
    for i in range(2):
        lab = np.zeros((24, 24, 24), np.int32)
        lab[4:20, 4:20, 4:20] = rng.integers(0, 3, (16, 16, 16)) * 2
        save_volume(lab, np.eye(4), None, str(root / "labels" / f"m{i}.nii.gz"))
    np.save(str(root / "gen_labels.npy"), np.array([0, 2, 4], np.int32))
    return str(root / "labels"), str(root / "gen_labels.npy")


def test_training_with_segmenter_h5_and_pt(tiny_dataset, tmp_path):
    """training() with a segmenter written as a Keras .h5 (h5py) and as a
    .pt state dict: the same weights give the same curve, and at lr 0 (the
    network does not move) each step's loss is the regression loss of the
    run without the segmenter plus 0.25 times a Dice in (0, 1)."""
    from synthsr_tpu.models.h5_import import export_keras_unet_weights
    from synthsr_tpu_torch.train.training import training

    cfg = dict(nb_features=2, nb_levels=2, nb_conv_per_level=1, nb_labels=3,
               final_pred_activation="softmax")
    variables = random_variables(cfg, in_channels=1, seed=8)
    export_keras_unet_weights(str(tmp_path / "seg.h5"), variables)
    torch.save(variables_to_state_dict(variables), str(tmp_path / "seg.pt"))
    np.save(str(tmp_path / "seg_labels.npy"), np.array([0, 2, 4]))
    curves = {}
    for name in ("h5", "pt", None):
        kw = _train_kwargs(tiny_dataset, str(tmp_path / f"run_{name}"))
        if name is not None:
            kw.update(segmentation_model_file=str(tmp_path / f"seg.{name}"),
                      segmentation_label_list=str(tmp_path / "seg_labels.npy"),
                      segmentation_label_equivalency=np.array([0, 2, 4]))
        curves[name] = training(**kw)["loss_curve"]
    assert curves["h5"] == curves["pt"]
    dice = (curves["pt"][0] - curves[None][0]) / 0.25
    assert 0.0 < dice < 1.0, curves


def test_adversarial_generator_update_with_segmenter_matches_jax():
    """The generator update's loss with the segmentation term (JAX
    adversarial.py:373-387: the L1 weight drops by w_seg, w_seg times the
    Dice of the clip-normalised fake joins) and its parameter gradients,
    against the JAX composition, fast and plain paths, float32."""
    from synthsr_tpu.models.discriminator import Discriminator3D as FlaxDisc
    from synthsr_tpu.ops.losses import l1_loss
    from synthsr_tpu.train.metrics import assemble_prediction, center_crop
    from synthsr_tpu.train.training import build_seg_loss_fn as jax_build
    from synthsr_tpu_torch.models.discriminator import Discriminator3D
    from synthsr_tpu_torch.models.weights import (disc_variables_to_state_dict,
                                                  random_disc_variables,
                                                  state_dict_to_variables)
    from synthsr_tpu_torch.train.adversarial import generator_loss

    seg_cfg, seg_vars, seg_model = _segmenter(seed=6)
    net = dict(nb_features=4, nb_levels=2, nb_conv_per_level=2, nb_labels=1)
    gen_vars = random_variables(net, in_channels=1, seed=2)
    critic_vars = random_disc_variables((16, 16, 16), n_filters=4, n_levels=2, seed=3)
    rng = np.random.default_rng(1)
    image = rng.normal(size=(2, 16, 16, 16, 1)).astype(np.float32)
    target = rng.normal(size=(2, 16, 16, 16, 1)).astype(np.float32)
    _, labels = _inputs()
    m, M = -0.3, 1.2
    w_d, w_s = 0.01, 0.25
    flax_unet = FlaxUNet3D(compute_dtype=jnp.float32, **net)
    flax_critic = FlaxDisc(compute_dtype=jnp.float32, n_filters=4, n_levels=2)
    jax_dice = jax_build(FlaxUNet3D(compute_dtype=jnp.float32, **seg_cfg), seg_vars, GEN_LABELS,
                         EQUIVALENCY, 12, m=m, M=M)

    def jloss(p):
        out, _ = flax_unet.apply({"params": p, "batch_stats": gen_vars["batch_stats"]},
                                 jnp.asarray(image), train=True, mutable=["batch_stats"])
        fake, _ = assemble_prediction(out, jnp.asarray(image), work_with_residual_channel=[0])
        l1 = l1_loss(center_crop(fake, 12), center_crop(jnp.asarray(target), 12))
        d = flax_critic.apply(critic_vars, fake)
        loss = w_d * jnp.mean(-d) + w_s * jax_dice(fake, jnp.asarray(labels))
        return loss + (1.0 - w_d - w_s) * l1

    v_want, g_want = jax.value_and_grad(jloss)(gen_vars["params"])
    critic = Discriminator3D((16, 16, 16), n_filters=4, n_levels=2)
    critic.load_state_dict(disc_variables_to_state_dict(critic_vars))
    frozen = {n: p.detach() for n, p in critic.named_parameters()}
    seg_fn = build_seg_loss_fn(seg_model, GEN_LABELS, EQUIVALENCY, 12, m=m, M=M)
    for fast in (True, False):
        model = UNet3D(in_channels=1, **net)
        model.load_state_dict(variables_to_state_dict(gen_vars))
        loss, _ = generator_loss(model, critic, frozen, torch.from_numpy(image),
                                 torch.from_numpy(target), residual_indices=[0],
                                 loss_cropping=12, relative_weight_discriminator=w_d,
                                 compute_dtype=torch.float32, fast=fast, seg_loss_fn=seg_fn,
                                 seg_target=torch.from_numpy(labels),
                                 relative_weight_segmentation=w_s)
        np.testing.assert_allclose(float(loss.detach()), float(v_want), rtol=1e-5)
        grads = torch.autograd.grad(loss, list(model.parameters()))
        sd = dict(model.state_dict())
        sd.update({n: g for (n, _), g in zip(model.named_parameters(), grads)})
        got = state_dict_to_variables(sd)["params"]
        for layer, leaves in g_want.items():
            for key, arr in leaves.items():
                np.testing.assert_allclose(got[layer][key], np.asarray(arr), rtol=5e-4,
                                           atol=5e-5, err_msg=f"{layer}/{key}")
