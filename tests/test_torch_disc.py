"""The port's critic (synthsr_tpu_torch: models/discriminator.py,
models/discriminator_cf.py, the critic part of models/weights.py and the
"leaky" epilogue of ops/conv_cf.py / ops/conv_train.py) against the JAX
package on the same numpy inputs and bridged parameters.

Float32 throughout, the JAX Pallas kernels in interpret mode.  The critic is
the small one of tests/test_disc_fast.py: 4 filters, 2 levels, at 32³, so
its first conv sits on the JAX kernels and the deeper level on XLA.  The
tolerances are that file's: 1e-5 on values, 2e-4 / 2e-5 on first-order
gradients, 5e-4 / 5e-5 on the gradient penalty's parameter gradients.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from synthsr_tpu.models.discriminator import Discriminator3D as FlaxDiscriminator3D
from synthsr_tpu_torch.models.discriminator import Discriminator3D, conv_s2, critic_forward
from synthsr_tpu_torch.models.discriminator_cf import (_conv_s2_transpose, fast_disc_apply,
                                                       fast_disc_input_grad)
from synthsr_tpu_torch.models.weights import (disc_state_dict_to_variables,
                                              disc_variables_to_state_dict,
                                              random_disc_variables)
from synthsr_tpu_torch.ops.conv_cf import conv3d_cf
from synthsr_tpu_torch.ops.conv_train import act_grad_from_output
from synthsr_tpu_torch.train.adversarial import gradient_penalty, gradient_penalty_from_grads

torch.set_num_threads(2)

SPATIAL = (32, 32, 32)
CRITIC = dict(n_filters=4, n_levels=2)
VALUE = dict(rtol=1e-5, atol=1e-5)
GRAD = dict(rtol=2e-4, atol=2e-5)
GP_GRAD = dict(rtol=5e-4, atol=5e-5)


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _cf(a):
    """NDHWC numpy -> NCDHW tensor."""
    return _t(np.transpose(a, (0, 4, 1, 2, 3)))


def _ndhwc(t):
    return np.transpose(t.detach().numpy(), (0, 2, 3, 4, 1))


def _assert_params_close(got: dict, want, **tol):
    """Port gradients by state-dict name against a flax gradient tree."""
    got = disc_state_dict_to_variables(got)["params"]
    for layer, leaves in want.items():
        for key, arr in leaves.items():
            np.testing.assert_allclose(got[layer][key], np.asarray(arr),
                                       err_msg=f"{layer}/{key}", **tol)


@pytest.fixture(scope="module", params=["flax-init", "random"])
def critic_setup(request):
    """The flax module's own init (zero biases) or the port's seeded random
    weights (biases of std 0.05), bridged to the port; a batch of two inputs
    and a 0/1 mask."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, *SPATIAL, 1)).astype(np.float32)
    mask = rng.integers(0, 2, x.shape).astype(np.float32)
    flax_model = FlaxDiscriminator3D(compute_dtype=jnp.float32, **CRITIC)
    if request.param == "flax-init":
        variables = {"params": jax.tree.map(np.asarray, dict(
            flax_model.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]))}
    else:
        variables = random_disc_variables(SPATIAL, seed=3, **CRITIC)
    model = Discriminator3D(SPATIAL, **CRITIC)
    model.load_state_dict(disc_variables_to_state_dict(variables))
    return flax_model, variables["params"], model, x, mask


def _jparams(params):
    return jax.tree.map(jnp.asarray, params)


def test_odd_sizes_match_flax():
    """At a size that turns odd on the way down (30x32x26 -> 15x16x13 ->
    8x8x7), with a mask: the fast apply, the input-gradient program and the
    penalty's parameter gradients against the flax critic, jax.grad and JAX
    double autodiff; and the stride-2 transpose against autograd's vjp of the
    plain stride-2 conv at that odd size."""
    from synthsr_tpu.train.adversarial import gradient_penalty as jax_gp

    spatial = (30, 32, 26)
    rng = np.random.default_rng(7)
    x = rng.standard_normal((1, *spatial, 1)).astype(np.float32)
    m = rng.integers(0, 2, x.shape).astype(np.float32)
    variables = random_disc_variables(spatial, seed=5, **CRITIC)
    model = Discriminator3D(spatial, **CRITIC)
    model.load_state_dict(disc_variables_to_state_dict(variables))
    flax_model = FlaxDiscriminator3D(compute_dtype=jnp.float32, **CRITIC)
    jp, jx, jm = _jparams(variables["params"]), jnp.asarray(x), jnp.asarray(m)
    named = dict(model.named_parameters())
    with torch.no_grad():
        got = fast_disc_apply(model, named, _cf(x), _cf(m))
        gx = fast_disc_input_grad(model, named, _cf(x), _cf(m))
    np.testing.assert_allclose(got.numpy(), np.asarray(flax_model.apply({"params": jp}, jx, jm)),
                               **VALUE)
    gx_want = jax.grad(lambda xx: jnp.sum(flax_model.apply({"params": jp}, xx, jm)))(jx)
    np.testing.assert_allclose(_ndhwc(gx), np.asarray(gx_want), **GRAD)

    v_want, g_want = jax.value_and_grad(lambda p: jax_gp(
        lambda pp, xx, mm: flax_model.apply({"params": pp}, xx, mm), p, jx, jm, 10.0))(jp)
    gp = gradient_penalty_from_grads(fast_disc_input_grad(model, named, _cf(x), _cf(m)), 10.0)
    np.testing.assert_allclose(float(gp.detach()), float(v_want), rtol=1e-5, atol=1e-7)
    grads = torch.autograd.grad(gp, list(model.parameters()), allow_unused=True,
                                materialize_grads=True)
    _assert_params_close(dict(zip(named, grads)), g_want, **GP_GRAD)

    s = _t(rng.normal(size=(1, 3, 15, 16, 13)))
    w = _t(rng.normal(size=(5, 3, 3, 3, 3)))
    s.requires_grad_(True)
    y = conv_s2(s, w, torch.zeros(5))
    g = _t(rng.normal(size=tuple(y.shape)))
    (want,) = torch.autograd.grad(y, s, g)
    got = _conv_s2_transpose(g[0], w, (15, 16, 13))
    np.testing.assert_allclose(got.numpy(), want[0].numpy(), atol=1e-5, rtol=1e-5)


def test_leaky_epilogue_matches_pallas():
    """conv3d_cf(activation="leaky") (its plain version on the CPU, which the
    kernels are held to on the card) against conv3d_cf_planes in interpret
    mode: K1 at C_in 1 -> C_out 32, the critic's first conv, and K2 at
    8 -> 16."""
    from synthsr_tpu.ops.conv_pallas import conv3d_cf_planes

    rng = np.random.default_rng(5)
    for cin, cout in ((1, 32), (8, 16)):
        x = rng.normal(size=(cin, 4, 16, 128)).astype(np.float32)
        w = rng.normal(size=(3, 3, 3, cin, cout)).astype(np.float32) * 0.2
        b = rng.normal(size=(cout,)).astype(np.float32) * 0.3
        want = np.asarray(conv3d_cf_planes(jnp.asarray(x), jnp.asarray(w), bias=jnp.asarray(b),
                                           activation="leaky", interpret=True))
        got = conv3d_cf(_t(x), _t(w), bias=_t(b), activation="leaky")
        assert (want < 0).mean() > 0.2  # both branches are exercised
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)


def test_leaky_act_grad_matches_jax():
    """act_grad_from_output("leaky") against JAX's _act_grad_from_output, with
    exact zeros in the output (slope 1 there)."""
    from synthsr_tpu.ops.conv_train import _act_grad_from_output

    rng = np.random.default_rng(2)
    y = rng.normal(size=(4, 6, 5, 7)).astype(np.float32)
    y[0, :2] = 0.0
    dy = rng.normal(size=y.shape).astype(np.float32)
    want = np.asarray(_act_grad_from_output("leaky", jnp.asarray(y), jnp.asarray(dy)))
    np.testing.assert_array_equal(act_grad_from_output("leaky", _t(y), _t(dy)).numpy(), want)


@pytest.mark.parametrize("masked", [False, True])
def test_critic_matches_flax(critic_setup, masked):
    """The plain critic and the fast apply against Discriminator3D.apply."""
    flax_model, params, model, x, mask = critic_setup
    m = mask if masked else None
    want = np.asarray(flax_model.apply({"params": _jparams(params)}, jnp.asarray(x),
                                       None if m is None else jnp.asarray(m)))
    mt = None if m is None else _cf(m)
    with torch.no_grad():
        plain = model(_cf(x), mt)
        fast = fast_disc_apply(model, dict(model.named_parameters()), _cf(x), mt)
    assert plain.shape == fast.shape == (2, 1)
    np.testing.assert_allclose(plain.numpy(), want, **VALUE)
    np.testing.assert_allclose(fast.numpy(), want, **VALUE)


def test_first_order_grads_match_flax(critic_setup):
    """Parameter and input gradients of a WGAN term, through the plain critic
    and the fast apply, against jax.grad of the flax critic."""
    flax_model, params, model, x, _ = critic_setup

    def jloss(p, xx):
        d = flax_model.apply({"params": p}, xx)
        return jnp.mean(-d[:1]) + jnp.mean(d[1:])

    gp_want, gx_want = jax.grad(jloss, argnums=(0, 1))(_jparams(params), jnp.asarray(x))
    names = [n for n, _ in model.named_parameters()]
    for apply in (model, lambda xx: fast_disc_apply(model, dict(model.named_parameters()), xx)):
        xt = _cf(x).requires_grad_(True)
        d = apply(xt)
        grads = torch.autograd.grad(torch.mean(-d[:1]) + torch.mean(d[1:]),
                                    [*model.parameters(), xt])
        _assert_params_close(dict(zip(names, grads[:-1])), gp_want, **GRAD)
        np.testing.assert_allclose(_ndhwc(grads[-1]), np.asarray(gx_want), **GRAD)


@pytest.mark.parametrize("masked", [False, True])
def test_input_grad_program_matches_jax_grad(critic_setup, masked):
    """The unrolled input-gradient program against jax.grad of Σ D."""
    flax_model, params, model, x, mask = critic_setup
    m = mask if masked else None
    want = jax.grad(lambda xx: jnp.sum(flax_model.apply(
        {"params": _jparams(params)}, xx, None if m is None else jnp.asarray(m))))(jnp.asarray(x))
    with torch.no_grad():
        got = fast_disc_input_grad(model, dict(model.named_parameters()), _cf(x),
                                   None if m is None else _cf(m))
    np.testing.assert_allclose(_ndhwc(got), np.asarray(want), **GRAD)


@pytest.mark.parametrize("masked", [False, True])
def test_gp_param_grads_match_double_autodiff(critic_setup, masked):
    """The gradient penalty's parameter gradient, a second derivative of D,
    through the unrolled program and through the port's double autograd of
    the plain critic, against JAX's double autodiff of the flax critic
    (tests/test_disc_fast.py:119).  With the flax init's zero biases a
    masked-out region has pre-activations of exactly 0, where the slope of
    LeakyReLU must be 1 as in JAX."""
    from synthsr_tpu.train.adversarial import gradient_penalty as jax_gp

    flax_model, params, model, x, mask = critic_setup
    x_hat, m = x[:1], (mask[:1] if masked else None)
    jm = None if m is None else jnp.asarray(m)

    def jloss(p):
        return jax_gp(lambda pp, xx, mm: flax_model.apply({"params": pp}, xx, mm), p,
                      jnp.asarray(x_hat), jm, 10.0)

    v_want, g_want = jax.value_and_grad(jloss)(_jparams(params))
    names = [n for n, _ in model.named_parameters()]
    mt = None if m is None else _cf(m)
    fast = gradient_penalty_from_grads(
        fast_disc_input_grad(model, dict(model.named_parameters()), _cf(x_hat), mt), 10.0)
    plain = gradient_penalty(lambda xx, mm: model(xx, mm), _cf(x_hat), mt, 10.0)
    for v in (fast, plain):
        np.testing.assert_allclose(float(v.detach()), float(v_want), rtol=1e-5, atol=1e-7)
        # the stride-1 convs' biases move only LeakyReLU's branch choices:
        # no gradient (zeros in JAX)
        grads = torch.autograd.grad(v, list(model.parameters()), allow_unused=True,
                                    materialize_grads=True)
        _assert_params_close(dict(zip(names, grads)), g_want, **GP_GRAD)


def test_gradient_penalty_at_unit_norm():
    """tests/test_adversarial.py:30: a linear critic of unit gradient norm
    has no penalty; a constant critic is penalised by the weight."""
    x = torch.ones((2, 1, 4, 4, 4))
    gp = gradient_penalty(lambda xx, m=None: xx.sum(dim=(1, 2, 3, 4))[:, None] / 8.0, x)
    assert float(gp) < 1e-8
    gp0 = gradient_penalty(lambda xx, m=None: (0.0 * xx).sum(dim=(1, 2, 3, 4))[:, None], x)
    assert abs(float(gp0) - 10.0) < 1e-3


def test_stride2_transpose_matches_jax():
    """The strided transpose cropped by SAME's (0, 1) pad of an even size
    against the JAX s2d transpose of the same stride-2 conv
    (_conv_s2_cf_transpose)."""
    from synthsr_tpu.models.discriminator_cf import _conv_s2_cf_transpose

    rng = np.random.default_rng(4)
    g = rng.normal(size=(5, 4, 6, 3)).astype(np.float32)
    w = rng.normal(size=(3, 3, 3, 2, 5)).astype(np.float32)  # DHWIO, 2 -> 5 channels
    want = np.asarray(_conv_s2_cf_transpose(jnp.asarray(g), jnp.asarray(w)))
    got = _conv_s2_transpose(_t(g), _t(w).permute(4, 3, 0, 1, 2), (8, 12, 6))
    assert got.shape == (2, 8, 12, 6)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)


def test_bridge_round_trip_and_h5(tmp_path):
    """flax tree -> state dict -> flax tree is exact; the .h5 export with the
    critic prefix reads back through the JAX package's loader; the critic
    on the read-back weights matches."""
    from synthsr_tpu.models.h5_import import load_keras_unet_weights
    from synthsr_tpu_torch.models.h5_import import export_keras_unet_weights

    variables = random_disc_variables(SPATIAL, seed=1, **CRITIC)
    model = Discriminator3D(SPATIAL, **CRITIC)
    model.load_state_dict(disc_variables_to_state_dict(variables))
    back = disc_state_dict_to_variables(model.state_dict())
    for layer, leaves in variables["params"].items():
        for key, arr in leaves.items():
            np.testing.assert_array_equal(back["params"][layer][key], arr)
    assert model.dense_0.weight.shape == (16, 8 * 8 ** 3)
    path = str(tmp_path / "discriminator_1.h5")
    export_keras_unet_weights(path, back, prefix="discriminator_")
    template = {"params": jax.tree.map(np.zeros_like, variables["params"])}
    loaded = load_keras_unet_weights(path, template, prefix="discriminator_")
    x = np.random.default_rng(2).standard_normal((1, *SPATIAL, 1)).astype(np.float32)
    want = FlaxDiscriminator3D(compute_dtype=jnp.float32, **CRITIC).apply(
        {"params": _jparams(loaded["params"])}, jnp.asarray(x))
    with torch.no_grad():
        got = critic_forward(dict(model.named_parameters()), _cf(x), None, 2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **VALUE)
