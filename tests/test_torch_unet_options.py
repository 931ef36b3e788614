"""Every option of the flax UNet3D in the port (synthsr_tpu_torch/models/unet.py)
against ``synthsr_tpu.models.unet.UNet3D.apply`` on the same numpy inputs and
bridged weights: inference, train mode (outputs, new batch statistics and the
parameter gradients of an l1 loss) and the dropout masks, which the JAX side
draws with ``jax.random.bernoulli`` (recorded here by patching it) and the
port takes pre-drawn.  Also the fast inference forward with a multi-label or
softmax head (models/unet_cf.py) and remat.  Float32, atol 2e-4 (the bar of
tests/test_unet.py:118-167) unless stated.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from synthsr_tpu.models.unet import UNet3D as FlaxUNet3D
from synthsr_tpu_torch.models.unet import UNet3D, dropout_sites, draw_dropout_masks
from synthsr_tpu_torch.models.unet_cf import fast_unet_forward
from synthsr_tpu_torch.models.unet_cf_train import can_fast_train
from synthsr_tpu_torch.models.weights import (load_unet_weights, random_variables,
                                              state_dict_to_variables, variables_to_state_dict)

torch.set_num_threads(2)

BASE = dict(nb_features=4, nb_levels=2, nb_conv_per_level=2, nb_labels=1)
TOL = dict(rtol=1e-4, atol=2e-4)
# option sets, each with the input shape it needs (NDHWC, batch 2)
OPTIONS = {
    "conv_size_5": (dict(conv_size=5), (2, 8, 16, 8, 2)),
    "conv_size_4_even": (dict(conv_size=4), (2, 8, 16, 8, 2)),
    "pool_size_3": (dict(pool_size=3), (2, 9, 12, 6, 2)),
    "layer_nb_feats": (dict(layer_nb_feats=[3, 5, 4, 6, 7, 3, 2, 5]), (2, 8, 16, 8, 2)),
    "skip_n_concatenations": (dict(nb_levels=3, skip_n_concatenations=1), (2, 8, 16, 8, 2)),
    "no_batch_norm": (dict(use_batch_norm=False), (2, 8, 16, 8, 2)),
    "residual_dilated": (dict(use_residuals=True, dilation_rate_mult=2), (2, 8, 16, 8, 2)),
    "residual_no_expand": (dict(use_residuals=True, nb_features=2, feat_mult=1),
                           (2, 8, 16, 8, 2)),
    "residual_single_feature": (dict(use_residuals=True, nb_features=1), (2, 8, 16, 8, 1)),
    "dropout": (dict(conv_dropout=0.4), (2, 8, 16, 8, 2)),
    "dropout_residual": (dict(conv_dropout=0.3, use_residuals=True), (2, 8, 16, 8, 2)),
    "three_labels_softmax": (dict(nb_labels=3, final_pred_activation="softmax", nb_levels=3),
                             (2, 8, 16, 8, 2)),
}


def _cf(x):
    return torch.from_numpy(np.ascontiguousarray(np.transpose(x, (0, 4, 1, 2, 3))))


def _cl(t):
    return np.transpose(t.detach().numpy(), (0, 2, 3, 4, 1))


def _setup(name):
    opts, shape = OPTIONS[name]
    cfg = {**BASE, **opts}
    rng = np.random.default_rng(0)
    variables = random_variables(cfg, in_channels=shape[-1], seed=5)
    x = rng.normal(size=shape).astype(np.float32)
    target = rng.normal(size=shape[:4] + (cfg["nb_labels"],)).astype(np.float32)
    model = UNet3D(in_channels=shape[-1], **cfg)
    model.load_state_dict(variables_to_state_dict(variables))
    return cfg, variables, x, target, model


def _flax_train(cfg, variables, x, target, monkeypatch):
    """flax train-mode loss, output, new batch stats and parameter gradients,
    and the dropout masks it drew, in draw order."""
    flax_model = FlaxUNet3D(compute_dtype=jnp.float32, **cfg)
    masks, bernoulli = [], jax.random.bernoulli

    def recording(key, p=0.5, shape=None, **kw):
        out = bernoulli(key, p, shape, **kw)
        masks.append(np.asarray(out))
        return out

    monkeypatch.setattr(jax.random, "bernoulli", recording)
    rngs = {"dropout": jax.random.PRNGKey(3)}

    def loss_fn(params):
        out, upd = flax_model.apply({"params": params, "batch_stats": variables["batch_stats"]},
                                    jnp.asarray(x), train=True, mutable=["batch_stats"],
                                    rngs=rngs)
        return jnp.mean(jnp.abs(out - target)), (out, upd["batch_stats"])

    flax_model.apply(variables, jnp.asarray(x), train=True, mutable=["batch_stats"], rngs=rngs)
    n = len(masks)
    (loss, (out, stats)), grads = jax.value_and_grad(loss_fn, has_aux=True)(
        variables["params"])
    monkeypatch.setattr(jax.random, "bernoulli", bernoulli)
    return float(loss), np.asarray(out), stats, grads, masks[:n]


@pytest.mark.parametrize("name", list(OPTIONS))
def test_option_matches_flax(name, monkeypatch):
    """Inference output, and train mode on JAX's own dropout masks: output,
    loss, new BatchNorm statistics and every parameter gradient."""
    cfg, variables, x, target, model = _setup(name)
    want = np.asarray(FlaxUNet3D(compute_dtype=jnp.float32, **cfg).apply(variables,
                                                                         jnp.asarray(x)))
    np.testing.assert_allclose(_cl(model(_cf(x))), want, **TOL)

    w_loss, w_out, w_stats, w_grads, jax_masks = _flax_train(cfg, variables, x, target,
                                                             monkeypatch)
    sites = dropout_sites(model)
    assert len(sites) == len(jax_masks)
    masks = None
    if sites:  # (B, 1, 1, 1, C) draws in forward order -> {conv name: (B, C)}
        masks = {s: torch.from_numpy(m.reshape(m.shape[0], -1).copy()) for (s, _), m in
                 zip(sites, jax_masks)}
        assert any(not m.all() for m in masks.values())
    params = list(model.parameters())
    out, stats = model.forward_train(_cf(x), masks=masks)
    loss = torch.mean(torch.abs(out - _cf(target)))
    grads = torch.autograd.grad(loss, params)
    np.testing.assert_allclose(float(loss.detach()), w_loss, rtol=1e-5)
    np.testing.assert_allclose(_cl(out), w_out, **TOL)
    assert sorted(stats) == sorted(w_stats)
    for layer, (mean, var) in stats.items():
        np.testing.assert_allclose(mean.numpy(), np.asarray(w_stats[layer]["mean"]), **TOL)
        np.testing.assert_allclose(var.numpy(), np.asarray(w_stats[layer]["var"]), **TOL)
    sd = dict(model.state_dict())
    sd.update({n: g for (n, _), g in zip(model.named_parameters(), grads)})
    got = state_dict_to_variables(sd)["params"]
    assert sorted(got) == sorted(w_grads)
    for layer, leaves in w_grads.items():
        for key, arr in leaves.items():
            np.testing.assert_allclose(got[layer][key], np.asarray(arr), err_msg=f"{layer}/{key}",
                                       **TOL)


def test_fast_gate_and_bridge(tmp_path):
    """can_fast_train is the JAX gate; every option's weights round-trip the
    bridge and a Keras .h5 (load_unet_weights' template covers the new
    layers)."""
    from synthsr_tpu.models.h5_import import export_keras_unet_weights
    from synthsr_tpu.models.unet_cf_train import can_fast_train as jax_gate

    for name in OPTIONS:
        cfg, variables, x, _, model = _setup(name)
        assert can_fast_train(model) == jax_gate(FlaxUNet3D(**cfg)), name
        path = str(tmp_path / f"{name}.h5")
        export_keras_unet_weights(path, variables)
        again = load_unet_weights(UNet3D(in_channels=x.shape[-1], **cfg), path)
        for k, v in model.state_dict().items():
            assert torch.equal(again.state_dict()[k], v), (name, k)


def test_dropout_masks_are_feature_space():
    """One keep mask per (example, channel) and dropout site, drawn from each
    example's own generator at rate ``conv_dropout``; no masks without
    dropout; the identity at inference; train mode refuses to draw them."""
    model = UNet3D(in_channels=1, **{**BASE, "conv_dropout": 0.25})
    gens = [torch.Generator().manual_seed(s) for s in (1, 2, 1)]
    masks = draw_dropout_masks(model, gens)
    assert list(masks) == [n for n, _ in dropout_sites(model)]
    for name, c in dropout_sites(model):
        assert masks[name].shape == (3, c) and masks[name].dtype == torch.bool
        assert torch.equal(masks[name][0], masks[name][2])
    wide = UNet3D(in_channels=1, **{**BASE, "nb_features": 64, "conv_dropout": 0.25})
    kept = torch.cat([m.reshape(-1) for m in
                      draw_dropout_masks(wide, [torch.Generator().manual_seed(4)]).values()])
    assert abs(1 - float(kept.float().mean()) - 0.25) < 0.05
    assert draw_dropout_masks(UNet3D(in_channels=1, **BASE), gens) is None
    x = torch.randn(1, 1, 8, 8, 8)
    with torch.no_grad():
        np.testing.assert_array_equal(model(x).numpy(), model(x).numpy())
    with pytest.raises(ValueError, match="masks"):
        model.forward_train(x)


@pytest.mark.parametrize("head", [dict(nb_labels=3), dict(nb_labels=3,
                                                         final_pred_activation="softmax"),
                                  dict(nb_labels=1, final_pred_activation="softmax")])
def test_fast_forward_any_head(head):
    """fast_unet_forward with a head it cannot fold (several labels or
    softmax) against flax apply; before the repair it raised on these
    models.  The 1-label linear head still folds (tests/test_torch_unet.py)."""
    cfg = dict(nb_features=4, nb_levels=3, nb_conv_per_level=2, **head)
    variables = random_variables(cfg, in_channels=1, seed=2)
    x = np.random.default_rng(1).normal(size=(1, 16, 8, 16, 1)).astype(np.float32)
    want = np.asarray(FlaxUNet3D(compute_dtype=jnp.float32, **cfg).apply(variables,
                                                                         jnp.asarray(x)))
    model = UNet3D(in_channels=1, **cfg).eval()
    model.load_state_dict(variables_to_state_dict(variables))
    got = _cl(fast_unet_forward(model, _cf(x), torch.float32))
    assert got.shape == want.shape == (1, 16, 8, 16, cfg["nb_labels"])
    np.testing.assert_allclose(got, want, **TOL)


def _one_step(remat, dropout):
    """One make_train_step (float32) at the tiny configuration of
    tests/test_training.py:245, batch 2: (loss, parameters after Adam)."""
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
    model = init_unet(UNet3D(in_channels=2, nb_features=2, nb_levels=2, nb_conv_per_level=1,
                             conv_dropout=dropout), seed=1)
    rng = np.random.default_rng(0)
    means = torch.from_numpy(rng.uniform(20, 200, (3, 1)).astype(np.float32))
    stds = torch.from_numpy(rng.uniform(1, 10, (3, 1)).astype(np.float32))
    step = make_train_step(model, build_generator(cfg), lambda g: (means, stds), 1e-3,
                           loss_cropping=12, residual_indices=[0], compute_dtype=torch.float32,
                           remat=remat)
    labels = torch.from_numpy(rng.integers(0, 2, (2, 16, 16, 16, 1)).astype(np.int32) * 2)
    _, loss = step(adam_init(list(model.parameters())), torch.Generator().manual_seed(7),
                   [labels])
    return float(loss), [p.detach().clone() for p in model.parameters()]


@pytest.mark.parametrize("remat", [True, "levels"])
@pytest.mark.parametrize("dropout", [0.0, 0.3], ids=["fast", "plain_dropout"])
def test_remat_matches_no_remat(remat, dropout):
    """remat only changes what is kept for the backward pass: one step from
    the same state and draws gives the same loss and parameters as
    remat=False (rtol 1e-6, as tests/test_training.py:245), on the fast
    train forward and on the plain one (a dropout model, its masks drawn
    before the forward and so the same in the recomputation)."""
    loss0, params0 = _one_step(False, dropout)
    loss1, params1 = _one_step(remat, dropout)
    np.testing.assert_allclose(loss1, loss0, rtol=1e-6)
    for a, b in zip(params1, params0):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5, atol=1e-7)
