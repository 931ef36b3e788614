"""The port's training slice (synthsr_tpu_torch: models/unet_cf_train.py,
ops/losses.py, train/metrics.py, utils/finite_guard.py, train/training.py,
cli/train.py) against the JAX package on the same numpy inputs and weights,
and the training loop's mechanics at the tiny sizes of tests/test_training.py.

Float32 comparisons use the ROADMAP bar (atol 2e-4) or tighter; the JAX
Pallas kernels run in interpret mode.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from synthsr_tpu.io.volume import save_volume
from synthsr_tpu.models.h5_import import export_keras_unet_weights
from synthsr_tpu.models.unet import UNet3D as FlaxUNet3D
from synthsr_tpu_torch.models.unet import UNet3D
from synthsr_tpu_torch.models.unet_cf_train import fast_train_forward
from synthsr_tpu_torch.models.weights import (random_variables, state_dict_to_variables,
                                              variables_to_state_dict)

torch.set_num_threads(2)

NET = dict(nb_features=4, nb_levels=2, nb_conv_per_level=2, nb_labels=1)
SHAPE = (2, 8, 32, 32, 2)  # NDHWC; H·W = 1024 puts level 0 on the JAX flat kernels


def _ncdhw(x):
    return torch.from_numpy(np.ascontiguousarray(np.transpose(x, (0, 4, 1, 2, 3))))


def _ndhwc(t):
    return np.transpose(t.detach().numpy(), (0, 2, 3, 4, 1))


def _port(variables, in_channels, **cfg):
    model = UNet3D(in_channels=in_channels, **cfg)
    model.load_state_dict(variables_to_state_dict(variables))
    return model


def _port_grads(model, grads):
    """Parameter gradients in the flax tree layout."""
    sd = dict(model.state_dict())
    sd.update({n: g for (n, _), g in zip(model.named_parameters(), grads)})
    return state_dict_to_variables(sd)["params"]


def _assert_trees_close(got, want, **tol):
    for layer, leaves in want.items():
        for key, arr in leaves.items():
            np.testing.assert_allclose(np.asarray(got[layer][key]), np.asarray(arr),
                                       err_msg=f"{layer}/{key}", **tol)


@pytest.fixture(scope="module")
def net():
    rng = np.random.default_rng(0)
    variables = random_variables(NET, in_channels=2, seed=3)
    x = rng.normal(size=SHAPE).astype(np.float32)
    target = rng.normal(size=SHAPE[:4] + (1,)).astype(np.float32)
    return variables, x, target


def test_fast_train_forward_matches_jax(net):
    """fast_train_forward (float32) against make_fast_train_apply(interpret=True)
    and UNet3D.apply(train=True): outputs, new batch_stats (batch 2, BatchNorm
    joint over the examples) and the parameter gradients of an l1 loss; the
    plain UNet3D.forward_train against flax apply as well."""
    from synthsr_tpu.models.unet_cf_train import make_fast_train_apply

    variables, x, target = net
    flax_model = FlaxUNet3D(compute_dtype=jnp.float32, **NET)
    fast = make_fast_train_apply(flax_model, interpret=True)

    def jloss(params, apply):
        out, upd = apply({"params": params, "batch_stats": variables["batch_stats"]})
        return jnp.mean(jnp.abs(out - target)), (out, upd["batch_stats"])

    results = {}
    for name, apply in (("fast", lambda v: fast(v, jnp.asarray(x))),
                        ("flax", lambda v: flax_model.apply(v, jnp.asarray(x), train=True,
                                                            mutable=["batch_stats"]))):
        (loss, (out, stats)), grads = jax.value_and_grad(
            lambda p: jloss(p, apply), has_aux=True)(variables["params"])
        results[name] = (float(loss), np.asarray(out), stats, grads)

    model = _port(variables, 2, **NET)
    params = list(model.parameters())
    tx, tt = _ncdhw(x), _ncdhw(target)
    for name, run in (("fast", lambda: fast_train_forward(model, tx, torch.float32)),
                      ("flax", lambda: model.forward_train(tx))):
        out, stats = run()
        loss = torch.mean(torch.abs(out - tt))
        grads = torch.autograd.grad(loss, params)
        w_loss, w_out, w_stats, w_grads = results[name]
        np.testing.assert_allclose(float(loss.detach()), w_loss, rtol=1e-5)
        np.testing.assert_allclose(_ndhwc(out), w_out, rtol=1e-5, atol=1e-5)
        for layer, (mean, var) in stats.items():
            np.testing.assert_allclose(mean.numpy(), np.asarray(w_stats[layer]["mean"]),
                                       rtol=1e-5, atol=1e-5)
            np.testing.assert_allclose(var.numpy(), np.asarray(w_stats[layer]["var"]),
                                       rtol=1e-5, atol=1e-5)
        assert stats.keys() == w_stats.keys()
        _assert_trees_close(_port_grads(model, grads), w_grads, rtol=1e-5, atol=1e-5)


def test_fast_train_forward_bf16_matches_jax_bf16(net):
    """bf16 fast train forward against the JAX bf16 fast train apply: 1%
    relative L2 of each other, and the port no farther from float32 than the
    JAX bf16 path plus 0.1% (the bar of tests/test_torch_unet.py)."""
    from synthsr_tpu.models.unet_cf_train import make_fast_train_apply

    variables, x, _ = net
    jx = jnp.asarray(x)
    f32 = np.asarray(FlaxUNet3D(compute_dtype=jnp.float32, **NET).apply(
        variables, jx, train=True, mutable=["batch_stats"])[0])
    want = np.asarray(make_fast_train_apply(FlaxUNet3D(compute_dtype=jnp.bfloat16, **NET),
                                            interpret=True)(variables, jx)[0])
    with torch.no_grad():
        got = _ndhwc(fast_train_forward(_port(variables, 2, **NET), _ncdhw(x),
                                        torch.bfloat16)[0])

    def rel(a, b):
        return float(np.linalg.norm(a - b) / np.linalg.norm(b))

    assert rel(got, want) <= 1e-2
    assert rel(got, f32) <= rel(want, f32) + 1e-3


def test_pool_gradient_splits_ties():
    """The reshape-max pooling gives tied maxima equal shares of the gradient,
    as JAX's max does (F.max_pool3d would give it all to one)."""
    from synthsr_tpu_torch.models.unet_cf_train import _pool

    x = torch.zeros(1, 2, 2, 2, requires_grad=True)
    (g,) = torch.autograd.grad(_pool(x).sum(), x)
    np.testing.assert_allclose(g.numpy(), 1 / 8)


# ---------------------------------------------------------------------------
# losses and metrics
# ---------------------------------------------------------------------------

def _loss_inputs(rng, c=3):
    gt = rng.dirichlet(np.ones(c), size=(2, 12, 12, 12)).astype(np.float32)
    pred = rng.dirichlet(np.ones(c), size=(2, 12, 12, 12)).astype(np.float32)
    return gt, pred


def _one_hot_regions(rng, spatial, c=3, block=3):
    """One-hot maps (2, *spatial, c) of blocky label regions, so that the
    boundary weights see boundaries and interiors."""
    coarse = rng.integers(0, c, size=(2, *[-(-s // block) for s in spatial]))
    for ax in range(1, len(spatial) + 1):
        coarse = np.repeat(coarse, block, axis=ax)
    labels = coarse[(slice(None),) + tuple(slice(0, s) for s in spatial)]
    return np.eye(c, dtype=np.float32)[labels]


# boundary-weighted Dice on 1-D and 2-D maps: (spatial, boundary_dist, class_weights)
_DICE_ND = {"dice_boundary_1d_d1": ((40,), 1, [1, 2, 3]),
            "dice_boundary_1d_d3": ((40,), 3, -1),
            "dice_boundary_2d_d1": ((18, 20), 1, -1),
            "dice_boundary_2d_d3": ((18, 20), 3, [1, 2, 3])}


@pytest.mark.parametrize("case", ["l1", "l2", "laplace", "ssim", "dice", "dice_weighted",
                                  "dice_boundary", *_DICE_ND, "weighted_l2", "cross_entropy",
                                  "moment"])
def test_losses_match_jax(case):
    from synthsr_tpu.ops import losses as jl
    from synthsr_tpu_torch.ops import losses as tl

    rng = np.random.default_rng(11)
    gt, pred = _loss_inputs(rng)
    one = (gt[..., :1], pred[..., :1])
    if case in _DICE_ND:
        spatial, dist, cw = _DICE_ND[case]
        pred = rng.dirichlet(np.ones(3), size=(2, *spatial)).astype(np.float32)
        gt = _one_hot_regions(rng, spatial)
    calls = {
        "l1": ("l1_loss", one, {}), "l2": ("l2_loss", one, {}),
        "laplace": ("laplace_nll", (pred[..., :1], pred[..., 1:2], gt[..., :1]), {}),
        "ssim": ("ssim3d_loss", one, {}),
        "dice": ("dice_loss", (gt, pred), {}),
        "dice_weighted": ("dice_loss", (gt, pred), dict(class_weights=-1)),
        "dice_boundary": ("dice_loss", ((gt > 0.5).astype(np.float32), pred),
                          dict(boundary_weights=2.0, boundary_dist=1, class_weights=[1, 2, 3])),
        **{k: ("dice_loss", (gt, pred), dict(boundary_weights=2.0, boundary_dist=v[1],
                                             class_weights=v[2])) for k, v in _DICE_ND.items()},
        "weighted_l2": ("weighted_l2_loss", (gt, pred), {}),
        "cross_entropy": ("cross_entropy_loss", (gt, pred), dict(class_weights=[1, 2, 3])),
        "moment": ("moment_loss", (gt, pred), {}),
    }
    fn, args, kw = calls[case]
    want = float(getattr(jl, fn)(*[jnp.asarray(a) for a in args], **kw))
    got = float(getattr(tl, fn)(*[torch.from_numpy(a) for a in args], **kw))
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=1e-6)


@pytest.mark.parametrize("metrics", ["l1", "l2", "ssim", "laplace"])
def test_regression_loss_matches_jax(metrics):
    """assemble -> residual add -> centre crop -> metric, and the doubled
    residual indices (train/metrics.py)."""
    from synthsr_tpu.train import metrics as jm
    from synthsr_tpu_torch.train import metrics as tm

    rng = np.random.default_rng(12)
    n_out = 2 if metrics == "laplace" else 1
    out = rng.normal(size=(2, 16, 16, 16, n_out)).astype(np.float32)
    image = rng.uniform(size=(2, 16, 16, 16, 4)).astype(np.float32)
    target = rng.uniform(size=(2, 16, 16, 16, 1)).astype(np.float32)
    res = jm.doubled_residual_indices([1], True, input_channels=[False, True, True])
    assert tm.doubled_residual_indices([1], True, input_channels=[False, True, True]) == res
    want = float(jm.regression_loss(jnp.asarray(out), jnp.asarray(image), jnp.asarray(target),
                                    metrics, 12, res))
    got = float(tm.regression_loss(torch.from_numpy(out), torch.from_numpy(image),
                                   torch.from_numpy(target), metrics, 12, res))
    np.testing.assert_allclose(got, want, rtol=2e-5)


# ---------------------------------------------------------------------------
# Adam, the non-finite gate
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("lr_decay", [0.0, 0.3])
def test_adam_matches_optax(lr_decay):
    """adam_update over five steps == optax.adam with the Keras decay schedule
    (synthsr_tpu/train/training.py:42-54)."""
    import optax

    from synthsr_tpu.train.training import make_optimizer
    from synthsr_tpu_torch.utils.finite_guard import adam_init, adam_update

    rng = np.random.default_rng(13)
    params = [rng.normal(size=(3, 4)).astype(np.float32), rng.normal(size=(5,)).astype(np.float32)]
    opt = make_optimizer(1e-2, lr_decay)
    jp = [jnp.asarray(p) for p in params]
    js = opt.init(jp)
    tp = [torch.from_numpy(p) for p in params]
    ts = adam_init(tp)
    for _ in range(5):
        grads = [rng.normal(size=p.shape).astype(np.float32) for p in params]
        upd, js = opt.update([jnp.asarray(g) for g in grads], js, jp)
        jp = optax.apply_updates(jp, upd)
        tp, ts = adam_update(tp, [torch.from_numpy(g) for g in grads], ts, 1e-2, lr_decay)
    for a, b in zip(tp, jp):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-7)


def _tiny_step(gmm_sampler, lr=1e-3):
    """A make_train_step at the configuration of tests/test_training.py:189."""
    from synthsr_tpu_torch.synth.labels_to_image import GenerationConfig, build_generator
    from synthsr_tpu_torch.train.training import init_unet, make_train_step

    cfg = GenerationConfig(
        labels_shape=[16, 16, 16], input_channels=[True], output_channel=[0],
        generation_labels=np.array([0, 2, 4], np.int32), n_neutral_labels=3,
        atlas_res=[1.0, 1.0, 1.0], output_shape=16, output_div_by_n=4, flipping=True,
        aff=np.eye(4), randomise_res=False, nonlin_std=0.0,
        data_res=np.array([[1.0, 1.0, 2.0]]), downsample=True, build_reliability_maps=True,
        simulate_registration_error=False)
    model = init_unet(UNet3D(in_channels=2, nb_features=2, nb_levels=2, nb_conv_per_level=1))
    step = make_train_step(model, build_generator(cfg), gmm_sampler, lr, loss_cropping=12,
                           residual_indices=[0], compute_dtype=torch.float32)
    return model, step


def test_nan_loss_gates_updates_and_aborts_per_step():
    """Mirrors tests/test_training.py:173: a NaN loss writes nothing into the
    parameters, BatchNorm statistics or Adam state; a clean batch from the
    gated state still trains; FiniteGuard aborts within its lag, naming the
    step."""
    from synthsr_tpu_torch.utils.finite_guard import FiniteGuard, adam_init

    rng = np.random.default_rng(0)
    labels = torch.from_numpy(rng.integers(0, 2, (2, 16, 16, 16, 1)).astype(np.int32) * 2)
    means = torch.from_numpy(rng.uniform(20, 200, (3, 1)).astype(np.float32))
    stds = torch.from_numpy(rng.uniform(1, 10, (3, 1)).astype(np.float32))
    bad = means.clone()
    bad[1, 0] = float("nan")
    draws = {"means": bad}
    model, step = _tiny_step(lambda gen: (draws["means"], stds))
    before = {k: v.clone() for k, v in model.state_dict().items()}
    gen = torch.Generator().manual_seed(7)
    opt = adam_init(list(model.parameters()))
    opt1, loss = step(opt, gen, [labels])
    assert not np.isfinite(float(loss))
    for k, v in model.state_dict().items():
        assert torch.equal(v, before[k]), k
    assert int(opt1["count"]) == 0 and all(not m.any() for m in opt1["mu"] + opt1["nu"])

    draws["means"] = means
    _, loss2 = step(opt1, gen, [labels])
    assert np.isfinite(float(loss2))
    assert not torch.equal(model.conv_downarm_0_0.weight, before["conv_downarm_0_0.weight"])

    guard = FiniteGuard(lag=2)
    guard.push("epoch 1 step 1", torch.tensor(1.0))
    guard.push("epoch 1 step 2", torch.tensor(float("nan")))
    guard.push("epoch 1 step 3", torch.tensor(1.0))
    with pytest.raises(FloatingPointError, match="epoch 1 step 2"):
        guard.push("epoch 1 step 4", torch.tensor(1.0))
    guard2 = FiniteGuard(lag=2)
    guard2.push("epoch 1 step 3", torch.tensor(float("inf")))
    with pytest.raises(FloatingPointError, match="epoch 1 step 3"):
        guard2.flush()
    guard2.flush()


# ---------------------------------------------------------------------------
# the loop (tests/test_training.py:44,68,91 at their tiny sizes)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def tiny_dataset(tmp_path_factory):
    root = tmp_path_factory.mktemp("traindata")
    lab_dir = root / "labels"
    lab_dir.mkdir()
    rng = np.random.default_rng(0)
    for i in range(3):
        lab = np.zeros((24, 24, 24), np.int32)
        lab[4:20, 4:20, 4:20] = rng.integers(0, 3, (16, 16, 16)) * 2
        save_volume(lab, np.eye(4), None, str(lab_dir / f"m{i}.nii.gz"))
    np.save(str(root / "gen_labels.npy"), np.array([0, 2, 4], np.int32))
    return str(lab_dir), str(root / "gen_labels.npy")


def _base_kwargs(dataset, model_dir):
    lab_dir, labels_npy = dataset
    return dict(
        labels_dir=lab_dir, model_dir=model_dir, prior_means=None, prior_stds=None,
        path_generation_labels=labels_npy, prior_distributions="uniform", FS_sort=True,
        batchsize=2, input_channels=True, output_channel=0, output_shape=16,
        data_res=np.array([1.0, 1.0, 2.0]), downsample=True, build_reliability_maps=True,
        work_with_residual_channel=0, loss_cropping=12, n_levels=2, unet_feat_count=2,
        nb_conv_per_level=1, lr=1e-3, epochs=2, steps_per_epoch=3, regression_metric="l1",
        simulate_registration_error=False, seed=0, compute_dtype="float32", nonlin_std=0.0,
        device="cpu")


def test_training_short_run_and_resume(tiny_dataset, tmp_path):
    from synthsr_tpu_torch.train.training import latest_checkpoint, training

    model_dir = str(tmp_path / "models")
    logs = []
    out = training(log_fn=logs.append, **_base_kwargs(tiny_dataset, model_dir))
    assert len(out["loss_curve"]) == 2 and all(np.isfinite(out["loss_curve"]))
    assert latest_checkpoint(model_dir) == 2
    assert os.path.isfile(os.path.join(model_dir, "002.h5"))
    assert os.path.isfile(os.path.join(model_dir, "logs", "training_log.jsonl"))
    ck = torch.load(os.path.join(model_dir, "002.pt"), weights_only=True)
    assert ck["epoch"] == 2 and int(ck["adam"]["count"]) == 6
    assert set(ck) == {"model", "adam", "rng", "epoch"}

    kwargs = _base_kwargs(tiny_dataset, model_dir)
    kwargs["epochs"] = 3
    logs2 = []
    training(log_fn=logs2.append, **kwargs)
    assert any("resuming from epoch 2" in s for s in logs2)
    assert sum("epoch 3/3" in s for s in logs2) == 1
    assert latest_checkpoint(model_dir) == 3


def test_training_loss_decreases(tiny_dataset, tmp_path):
    """The full generation graph (SVF deformation on) with a strong lr and an
    easy residual task."""
    from synthsr_tpu_torch.train.training import training

    kwargs = _base_kwargs(tiny_dataset, str(tmp_path / "m2"))
    kwargs.update(lr=3e-3, nonlin_std=4.0)
    curve = training(log_fn=lambda s: None, **kwargs)["loss_curve"]
    assert curve[-1] < curve[0]


def test_training_warm_start_h5(tiny_dataset, tmp_path):
    """Warm start from a Keras .h5 with the likelihood head skipped: at lr 0
    the trained convs equal the file's and the head keeps its initialisation."""
    from synthsr_tpu_torch.train.training import init_unet, training

    net = dict(nb_features=2, nb_levels=2, nb_conv_per_level=1, nb_labels=1)
    variables = random_variables(net, in_channels=2, seed=5)
    h5 = str(tmp_path / "warm.h5")
    export_keras_unet_weights(h5, variables)
    kwargs = _base_kwargs(tiny_dataset, str(tmp_path / "m4"))
    kwargs.update(checkpoint=h5, model_file_has_different_lhood_layer=True, epochs=1,
                  steps_per_epoch=2, lr=0.0)
    out = training(log_fn=lambda s: None, **kwargs)
    assert np.isfinite(out["loss_curve"][0])
    model = out["model"]
    np.testing.assert_array_equal(
        model.conv_downarm_1_0.weight.detach().numpy(),
        np.transpose(variables["params"]["conv_downarm_1_0"]["kernel"], (4, 3, 0, 1, 2)))
    fresh = init_unet(UNet3D(in_channels=2, **net))
    assert torch.equal(model.likelihood.weight.detach(), fresh.likelihood.weight)


def _segmenter_files(tmp_path, labels=(0, 2, 4)):
    """A softmax segmenter of the tiny configuration (one output per label,
    seeded random weights) saved as ``.pt``, its label list and the
    equivalency mapping output i to ``labels[i]``."""
    cfg = dict(nb_features=2, nb_levels=2, nb_conv_per_level=1, nb_labels=len(labels),
               final_pred_activation="softmax")
    path = str(tmp_path / "seg.pt")
    torch.save(variables_to_state_dict(random_variables(cfg, in_channels=1, seed=11)), path)
    np.save(str(tmp_path / "seg_labels.npy"), np.array(labels, np.int32))
    return dict(segmentation_model_file=path,
                segmentation_label_list=str(tmp_path / "seg_labels.npy"),
                segmentation_label_equivalency=np.array(labels, np.int32))


def test_train_cli_and_unported_options(tiny_dataset, tmp_path, monkeypatch):
    """The CLI trains on the CPU with --cpu, with its numbers coerced to int
    indices and shapes; the options that raised before they were ported
    (remat, dropout, the frozen segmenter) now train; n_devices > 1 without a
    process group raises, naming how to launch it; without a GPU the default
    device raises."""
    from synthsr_tpu_torch.cli.train import main
    from synthsr_tpu_torch.train.training import training

    lab_dir, labels_npy = tiny_dataset
    np.save(str(tmp_path / "res.npy"), np.array([1.0, 1.0, 2.0]))
    out = main([lab_dir, str(tmp_path / "cli"), "100", "10", labels_npy,
                "--prior_distributions", "uniform", "--output_shape", "16",
                "--data_res", str(tmp_path / "res.npy"), "--work_with_residual_channel", "0",
                "--loss_cropping", "12", "--n_levels", "2", "--unet_feat_count", "2",
                "--nb_conv_per_level", "1", "--epochs", "1", "--steps_per_epoch", "1",
                "--nonlin_std", "0", "--no_registration_error", "--compute_dtype", "float32",
                "--seed", "0", "--cpu"], log_fn=lambda s: None)
    assert np.isfinite(out["loss_curve"][0])
    for i, opt in enumerate((dict(remat=True), dict(dropout=0.1),
                             _segmenter_files(tmp_path))):
        kwargs = _base_kwargs(tiny_dataset, str(tmp_path / f"opt{i}"))
        kwargs.update(opt, epochs=1, steps_per_epoch=1)
        assert np.isfinite(training(log_fn=lambda s: None, **kwargs)["loss_curve"][0]), opt
    kwargs = _base_kwargs(tiny_dataset, str(tmp_path / "dp"))
    kwargs.update(n_devices=2)
    with pytest.raises(RuntimeError, match="--n_devices"):
        training(log_fn=lambda s: None, **kwargs)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    kwargs = _base_kwargs(tiny_dataset, str(tmp_path / "nogpu"))
    kwargs["device"] = None
    with pytest.raises(RuntimeError):
        training(log_fn=lambda s: None, **kwargs)
