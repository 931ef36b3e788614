"""The port's D-sharded U-Net (synthsr_tpu_torch/parallel/halo.py and
halo_train.py) on 2 and 4 gloo ranks against the JAX package, after
tests/test_halo.py:31,41,52,83,121,153,189,213.

JAX's side runs as its own tests run it (``UNet3D.apply`` and the unsharded
train step ``_unsharded_step`` of tests/test_halo.py, SGD 1e-2) on the same
numpy weights and inputs; the port's ranks run every case of one world size
in one ``mesh.spawn`` (spawning costs seconds) and write their results,
which the tests compare.  Tolerances are JAX's own: the forward atol 1e-4
(the 5-level case 1e-3); a train step's loss rtol 1e-5, its parameters and
BatchNorm statistics atol 5e-5; float64 gradients atol 1e-8 against the
port's unsharded float64 ``forward_train``.  The workers import nothing of
JAX.
"""

import os

import numpy as np
import pytest
import torch

from synthsr_tpu_torch.models.unet import UNet3D
from synthsr_tpu_torch.parallel import halo, halo_train
from synthsr_tpu_torch.parallel.mesh import all_reduce_sum_list, data_group, spawn

torch.set_num_threads(1)

TIMEOUT = 300  # seconds for the ranks of one world size to start, run every case and exit

# name: (world size, kind, architecture, input shape (NDHWC), step options)
ARCH3 = dict(nb_features=3, nb_levels=3, nb_conv_per_level=2, nb_labels=1)
ARCH2 = dict(ARCH3, nb_levels=2)
CASES = {
    "forward_2": (2, "forward", ARCH3, (1, 64, 48, 48, 1), {}),
    "forward_4": (4, "forward", ARCH3, (1, 64, 48, 48, 1), {}),
    "forward_flagship_4": (4, "forward", dict(ARCH3, nb_features=4, nb_levels=5),
                           (1, 128, 64, 64, 1), {}),
    "l1_crop_none_4": (4, "step", ARCH3, (1, 32, 24, 24, 1), dict(loss_cropping=None)),
    "l1_crop_16_4": (4, "step", ARCH3, (1, 32, 24, 24, 1), dict(loss_cropping=16)),
    "l1_crop_16_2": (2, "step", ARCH3, (1, 32, 24, 24, 1), dict(loss_cropping=16)),
    "ssim_crop_none_2": (2, "step", ARCH3, (1, 32, 24, 24, 1),
                         dict(metrics="ssim", loss_cropping=None)),
    "ssim_crop_16_4": (4, "step", ARCH3, (1, 32, 24, 24, 1),
                       dict(metrics="ssim", loss_cropping=16)),
    "laplace_4": (4, "step", dict(ARCH2, nb_labels=2), (1, 16, 16, 16, 1),
                  dict(metrics="laplace", loss_cropping=8, residual_indices=[0])),
    "residual_4": (4, "step", ARCH2, (1, 16, 16, 16, 1), dict(residual_indices=[0])),
    "grads_f64_4": (4, "grads64", ARCH2, (1, 16, 16, 16, 1), {}),
    "indivisible_4": (4, "indivisible", ARCH3, (1, 40, 48, 48, 1), {}),
    # the U-Net's options through the halo hook, against the port's unsharded
    # net: residual levels with dilation 2 (4-plane halos at level 2) and
    # dropout; even kernels dilated 3 (halos of 0 and 1, 1 and 2, 4 and 5 planes)
    "options_2": (2, "options", {
        "residual_dilation_dropout": dict(ARCH3, use_residuals=True, dilation_rate_mult=2,
                                          conv_dropout=0.2),
        "even_kernel_dilation": dict(ARCH3, conv_size=2, dilation_rate_mult=3)},
        (1, 64, 16, 16, 1), {}),
}
OPTIONS = list(CASES["options_2"][2])


def _to_cf(a):
    return torch.from_numpy(np.ascontiguousarray(np.transpose(np.asarray(a), (0, 4, 1, 2, 3))))


def _port_model(arch, state, dtype=torch.float32):
    model = UNet3D(in_channels=1, **arch)
    model.load_state_dict(state)
    return model.to(dtype)


def _run_case(spec, data, group):
    """One case on this rank: the whole output / the stepped state / the
    gradients, as a dict of tensors (rank 0 writes it)."""
    _, kind, arch, _, opts = spec
    if kind == "indivisible":
        try:
            halo.sharded_unet_apply(_port_model(arch, data["state"]), data["x"], group)
        except AssertionError:
            return {"raised": torch.tensor(1)}
        return {"raised": torch.tensor(0)}
    if kind == "forward":
        model = _port_model(arch, data["state"])
        return {"out": halo.gather_d(halo.sharded_unet_apply(model, data["x"], group), group)}
    if kind == "step":
        model = _port_model(arch, data["state"])
        step = halo_train.make_halo_train_step(
            model, torch.optim.SGD(model.parameters(), lr=1e-2), group, **opts)
        loss, _ = step(data["image"], data["target"])
        return {"loss": loss, **{k: v.detach().clone() for k, v in model.state_dict().items()}}
    if kind == "options":
        return {name: _options_errors(variant, data, group) for name, variant in arch.items()}
    # float64 gradients of the sharded l1 loss vs the unsharded forward_train
    from synthsr_tpu_torch.train.metrics import regression_loss

    model = _port_model(arch, data["state"], torch.float64)
    params = list(model.parameters())
    image, target = data["image"].double(), data["target"].double()
    out, _ = model.forward_train(halo.local_d_slice(image, group), torch.float64, halo=group)
    share = halo_train.global_masked_loss(
        torch.abs(out - halo.local_d_slice(target, group)), None, group, image.shape[2])
    grads = all_reduce_sum_list(torch.autograd.grad(share, params), group)
    full, _ = model.forward_train(image, dtype=torch.float64)
    ref = regression_loss(full.permute(0, 2, 3, 4, 1), None, target.permute(0, 2, 3, 4, 1),
                          loss_cropping=None)
    ref_grads = torch.autograd.grad(ref, params)
    return {"max_err": torch.stack([(g - r).abs().max() for g, r in zip(grads, ref_grads)]).max()}


def _options_errors(arch, data, group):
    """The sharded forward and one halo SGD step of a U-Net with options
    against the unsharded ones on the same seeded weights and dropout masks:
    {forward max |diff|, relative loss difference, parameters max |diff|}."""
    from synthsr_tpu_torch.models.unet import draw_dropout_masks
    from synthsr_tpu_torch.train.metrics import regression_loss

    torch.manual_seed(3)
    state = UNet3D(in_channels=1, **arch).state_dict()
    image, target = data["image"], data["target"]
    model, ref = _port_model(arch, state), _port_model(arch, state)
    fwd = halo.gather_d(halo.sharded_unet_apply(model, image, group), group)
    with torch.no_grad():
        fwd_ref = ref(image)
    masks = draw_dropout_masks(model, [torch.Generator().manual_seed(5)])
    step = halo_train.make_halo_train_step(model, torch.optim.SGD(model.parameters(), lr=1e-2),
                                           group)
    loss, _ = step(image, target, masks)
    params = list(ref.parameters())
    out, _ = ref.forward_train(image, masks=masks)
    loss_ref = regression_loss(out.permute(0, 2, 3, 4, 1), None, target.permute(0, 2, 3, 4, 1),
                               loss_cropping=None)
    with torch.no_grad():
        for p, g in zip(params, torch.autograd.grad(loss_ref, params)):
            p.sub_(1e-2 * g)
    return {"forward": (fwd - fwd_ref).abs().max(),
            "loss": (loss - loss_ref.detach()).abs() / loss_ref.detach().abs(),
            "params": max((a - b).detach().abs().max() for a, b in zip(model.parameters(), params))}


def _worker(rank, world, out_dir, names):
    torch.set_num_threads(1)
    group = data_group(world)
    for name in names:
        data = torch.load(os.path.join(out_dir, f"{name}.in.pt"), weights_only=True)
        res = _run_case(CASES[name], data, group)
        if rank == 0:
            torch.save(res, os.path.join(out_dir, f"{name}.out.pt"))


def _jax_case(name):
    """The JAX side of one case: (port inputs, JAX results), numpy weights
    from tests/test_halo.py's ``_model_and_vars``."""
    import jax
    import jax.numpy as jnp
    import optax
    from test_halo import _model_and_vars, _unsharded_step

    from synthsr_tpu.models.unet import UNet3D as JaxUNet3D
    from synthsr_tpu_torch.models.weights import variables_to_state_dict

    _, kind, arch, shape, opts = CASES[name]
    if kind == "options":
        rng = np.random.default_rng(9)
        return {"image": _to_cf(rng.normal(size=shape).astype(np.float32)),
                "target": _to_cf(rng.normal(size=shape).astype(np.float32))}, {}
    size = shape[1]
    model, variables = _model_and_vars(levels=arch["nb_levels"], feats=arch["nb_features"],
                                       size=size)
    if arch["nb_labels"] != 1:  # the laplace net: 2 outputs, flax's own BatchNorm statistics
        model = JaxUNet3D(nb_features=arch["nb_features"], nb_levels=arch["nb_levels"],
                          nb_conv_per_level=2, nb_labels=arch["nb_labels"],
                          compute_dtype=jnp.float32)
        variables = dict(jax.jit(model.init)(jax.random.PRNGKey(0), jnp.zeros(shape)))
        rng = np.random.default_rng(7)
        variables["params"] = jax.tree.map(
            lambda p: jnp.asarray(rng.normal(size=p.shape, scale=0.1).astype(np.float32)),
            variables["params"])
    state = variables_to_state_dict(variables)
    rng = np.random.default_rng(sum(map(ord, name)))
    if kind in ("forward", "indivisible"):
        x = rng.normal(size=shape).astype(np.float32)
        want = {} if kind == "indivisible" else \
            {"out": np.asarray(model.apply(variables, jnp.asarray(x)))}
        return {"state": state, "x": _to_cf(x)}, want
    image = rng.normal(size=shape).astype(np.float32)
    target = rng.normal(size=shape).astype(np.float32)
    data = {"state": state, "image": _to_cf(image), "target": _to_cf(target)}
    if kind == "grads64":
        return data, {}
    optimizer = optax.sgd(1e-2)
    params, batch_stats = variables["params"], variables["batch_stats"]
    step = _unsharded_step(model, optimizer, metrics=opts.get("metrics", "l1"),
                           loss_cropping=opts.get("loss_cropping"),
                           residual_indices=opts.get("residual_indices"))
    p_ref, bs_ref, _, loss_ref = step(params, batch_stats, optimizer.init(params),
                                      jnp.asarray(image), jnp.asarray(target))
    want = {k: v.numpy() for k, v in variables_to_state_dict(
        {"params": p_ref, "batch_stats": bs_ref}).items() if "num_batches" not in k}
    return data, {"loss": float(loss_ref), **want}


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    """Every case: {name: (port result, JAX result)}."""
    root = tmp_path_factory.mktemp("halo")
    wants = {}
    for name in CASES:
        data, wants[name] = _jax_case(name)
        torch.save(data, str(root / f"{name}.in.pt"))
    for world in (2, 4):
        names = [n for n, spec in CASES.items() if spec[0] == world]
        spawn(_worker, world, (str(root), names), device_type="cpu", timeout=TIMEOUT,
              rendezvous_dir=str(root / f"rdv{world}"))
    return {name: (torch.load(str(root / f"{name}.out.pt"), weights_only=True), wants[name])
            for name in CASES}


@pytest.mark.parametrize("name", ["forward_2", "forward_4", "forward_flagship_4"])
def test_sharded_forward_matches_jax_apply(results, name):
    got, want = results[name]
    atol = 1e-3 if "flagship" in name else 1e-4
    np.testing.assert_allclose(got["out"].permute(0, 2, 3, 4, 1).numpy(), want["out"], atol=atol)


def test_sharded_rejects_indivisible(results):
    """D = 40 on 4 ranks of a 3-level net (40 % 16 != 0): AssertionError."""
    assert int(results["indivisible_4"][0]["raised"]) == 1
    model = _port_model(ARCH3, UNet3D(in_channels=1, **ARCH3).state_dict())
    with pytest.raises(AssertionError):
        halo.sharded_unet_apply(model, torch.zeros(1, 1, 42, 16, 16))


@pytest.mark.parametrize("name", [n for n, s in CASES.items() if s[1] == "step"])
def test_halo_train_step_matches_jax_unsharded(results, name):
    """One sharded SGD step == JAX's unsharded step: loss, parameters and
    BatchNorm running statistics."""
    got, want = results[name]
    atol_loss = 1e-8 if "ssim" in name else 0.0  # near-zero SSIM of random images
    np.testing.assert_allclose(float(got["loss"]), want["loss"], rtol=1e-5, atol=atol_loss)
    keys = [k for k in want if k != "loss"]
    assert set(keys) == {k for k in got if k not in ("loss",) and "num_batches" not in k}
    for k in keys:
        np.testing.assert_allclose(got[k].numpy(), want[k], atol=5e-5, err_msg=k)


def test_halo_train_grads_exact_f64(results):
    """In float64 the sharded gradients (summed over 4 ranks) equal the
    unsharded ones within 1e-8: an averaged (1/n) or double-counted (n x)
    gradient would be off by ~1e-3."""
    assert float(results["grads_f64_4"][0]["max_err"]) < 1e-8


@pytest.mark.parametrize("variant", OPTIONS)
def test_halo_unet_options_match_unsharded(results, variant):
    """Residual levels, dilation, dropout and even kernels run through the
    halo hook: the sharded forward within 1e-5 of the unsharded one, and one
    halo SGD step with the loss rtol 1e-5 and the parameters atol 5e-5."""
    got = results["options_2"][0][variant]
    assert float(got["forward"]) < 1e-5
    assert float(got["loss"]) < 1e-5
    assert float(got["params"]) < 5e-5


def test_halo_pad_one_rank_is_zero_padding():
    """Without a group the halo is zeros both sides; its gradient is the
    interior of the padded gradient."""
    x = torch.randn(1, 2, 4, 3, 3, requires_grad=True)
    y = halo.halo_pad(x, None, 2)
    assert y.shape == (1, 2, 8, 3, 3)
    assert torch.equal(y[:, :, 2:6], x) and not y[:, :, :2].any() and not y[:, :, 6:].any()
    g = torch.randn_like(y)
    (gx,) = torch.autograd.grad(y, x, g)
    assert torch.equal(gx, g[:, :, 2:6])


def test_halo_pad_uneven_widths_one_rank():
    """(lo, hi) widths, one of them 0 (even kernels): zeros at both ends; the
    gradient is the interior of the padded gradient."""
    x = torch.randn(1, 2, 4, 3, 3, requires_grad=True)
    for lo, hi in ((0, 1), (1, 2)):
        y = halo.halo_pad(x, None, (lo, hi))
        assert y.shape == (1, 2, 4 + lo + hi, 3, 3)
        assert torch.equal(y[:, :, lo:lo + 4], x) and not y[:, :, :lo].any()
        assert not y[:, :, lo + 4:].any()
        g = torch.randn_like(y)
        (gx,) = torch.autograd.grad(y, x, g)
        assert torch.equal(gx, g[:, :, lo:lo + 4])
