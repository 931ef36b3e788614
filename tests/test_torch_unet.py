"""The port's U-Net (synthsr_tpu_torch/models) against the flax U-Net of the
JAX package: weight bridge, plain forward, fast forward (float32 and bf16),
the flip-TTA identity, and the device resample."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from synthsr_tpu.models.h5_import import export_keras_unet_weights
from synthsr_tpu.models.unet import UNet3D as FlaxUNet3D
from synthsr_tpu.models.unet import synthsr_unet as flax_synthsr_unet
from synthsr_tpu_torch.models.unet import UNet3D, synthsr_unet
from synthsr_tpu_torch.models.unet_cf import fast_unet_forward, flip_d_state_dict
from synthsr_tpu_torch.models.weights import (load_unet_weights, random_variables,
                                              state_dict_to_variables,
                                              variables_to_state_dict)

torch.set_num_threads(2)

SMALL = dict(nb_features=3, nb_levels=3, nb_conv_per_level=2, nb_labels=2, feat_mult=2)


def _ncdhw(x_ndhwc):
    return torch.from_numpy(np.ascontiguousarray(np.transpose(x_ndhwc, (0, 4, 1, 2, 3))))


def _ndhwc(t):
    return np.transpose(t.detach().numpy(), (0, 2, 3, 4, 1))


def _port(variables, **cfg):
    model = UNet3D(**cfg).eval()
    model.load_state_dict(variables_to_state_dict(variables))
    return model


@pytest.fixture(scope="module")
def full_net():
    """Full-width synthsr_unet with seeded He-style weights in both packages."""
    variables = random_variables(seed=1)
    return variables, _port(variables)


def test_bridge_round_trip_is_bit_exact():
    variables = random_variables(SMALL, in_channels=2, seed=3)
    sd = variables_to_state_dict(variables)
    UNet3D(in_channels=2, **SMALL).load_state_dict(sd)  # strict: names and shapes
    back = state_dict_to_variables(sd)
    for coll in ("params", "batch_stats"):
        assert back[coll].keys() == variables[coll].keys()
        for layer, leaves in variables[coll].items():
            assert back[coll][layer].keys() == leaves.keys()
            for key, arr in leaves.items():
                assert back[coll][layer][key].dtype == arr.dtype
                np.testing.assert_array_equal(back[coll][layer][key], arr)


def test_h5_import_matches_direct_bridge(tmp_path):
    """Keras .h5 export -> import through the bridge gives the same forward as
    the direct bridge."""
    variables = random_variables(SMALL, seed=4)
    path = str(tmp_path / "w.h5")
    export_keras_unet_weights(path, variables)
    via_h5 = load_unet_weights(UNet3D(**SMALL), path).eval()
    direct = _port(variables, **SMALL)
    x = torch.from_numpy(np.random.default_rng(4).normal(size=(1, 1, 8, 8, 8))
                         .astype(np.float32))
    with torch.no_grad():
        assert torch.equal(via_h5(x), direct(x))


@pytest.mark.parametrize("final", ["linear", "softmax"])
def test_plain_forward_matches_flax(final):
    """UNet3D.forward == flax UNet3D.apply in float32 at the small config of
    tests/test_unet.py:118 (atol 2e-4)."""
    cfg = dict(SMALL, final_pred_activation=final)
    rng = np.random.default_rng(0)
    x = rng.normal(size=(1, 8, 8, 8, 1)).astype(np.float32)
    variables = random_variables(cfg, seed=0)
    want = np.asarray(FlaxUNet3D(**cfg).apply(variables, jnp.asarray(x)))
    with torch.no_grad():
        got = _ndhwc(_port(variables, **cfg)(_ncdhw(x)))
    np.testing.assert_allclose(got, want, atol=2e-4)


def test_fast_forward_float32_matches_flax(full_net):
    """Fast forward (every conv through conv3d_cf) == flax apply, full width,
    at the (1, 16, 16, 128, 1) shape of tests/test_unet.py:191."""
    variables, model = full_net
    x = np.random.default_rng(5).normal(size=(1, 16, 16, 128, 1)).astype(np.float32)
    want = np.asarray(flax_synthsr_unet(compute_dtype=jnp.float32)
                      .apply(variables, jnp.asarray(x)))
    got = _ndhwc(fast_unet_forward(model, _ncdhw(x), torch.float32))
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=1e-4)


def _test_unet_scale_variables(seed):
    """The weight regime of tests/test_unet.py:179-187: N(0, 0.05) params,
    BatchNorm var in [0.5, 1.5]; the deep net's output is nearly constant."""
    rng = np.random.default_rng(seed)
    v = random_variables(seed=seed)
    params = {layer: {k: rng.normal(size=a.shape, scale=0.05).astype(np.float32)
                      for k, a in leaves.items()} for layer, leaves in v["params"].items()}
    stats = {layer: {"mean": rng.normal(size=t["mean"].shape, scale=0.05).astype(np.float32),
                     "var": rng.uniform(0.5, 1.5, size=t["var"].shape).astype(np.float32)}
             for layer, t in v["batch_stats"].items()}
    return {"params": params, "batch_stats": stats}


@pytest.mark.parametrize("regime", ["test_unet_scale", "he"])
def test_fast_forward_bf16_matches_pallas_predictor(regime, full_net):
    """bf16 fast forward vs the JAX fast predictor (Pallas kernels in
    interpret mode, bf16 activations).

    In the weight regime of tests/test_unet.py the bar is that test's (rtol
    2e-3, atol 3e-4).  With He-style weights the activations stay O(1) and
    the two bf16 paths round at different places (the JAX one runs its deep
    levels as XLA convs that round before the bias): each lies about 0.6% (relative
    L2) from the float32 flax forward and about 0.5% from the other, as
    independent rounding noise would.  The bar there: 1% from each other, and
    the port no farther from float32 than the JAX bf16 path plus 0.1%."""
    from synthsr_tpu.models.unet_cf import make_fast_predictor

    variables, model = full_net
    if regime == "test_unet_scale":
        variables = _test_unet_scale_variables(7)
        model = _port(variables)
    x = np.random.default_rng(6).normal(size=(1, 16, 16, 128, 1)).astype(np.float32)
    flax_model = flax_synthsr_unet(compute_dtype=jnp.float32)
    run = make_fast_predictor(flax_model, variables, x.shape, interpret=True)
    want = np.asarray(run(jnp.asarray(x)))
    got = _ndhwc(fast_unet_forward(model, _ncdhw(x), torch.bfloat16))
    if regime == "test_unet_scale":
        np.testing.assert_allclose(got, want, rtol=2e-3, atol=3e-4)
        return
    f32 = np.asarray(flax_model.apply(variables, jnp.asarray(x)))

    def rel(a, b):
        return float(np.linalg.norm(a - b) / np.linalg.norm(b))

    assert rel(got, want) <= 1e-2
    assert rel(got, f32) <= rel(want, f32) + 1e-3


def test_flip_d_weights_equal_flipped_forward(full_net):
    """fast(x, flip_d weights) == flip(fast(flip(x))): the TTA pass needs no
    input or output flip."""
    _, model = full_net
    flipped = synthsr_unet().eval()
    flipped.load_state_dict(flip_d_state_dict(model.state_dict()))
    x = torch.from_numpy(np.random.default_rng(7).normal(size=(1, 1, 32, 16, 32))
                         .astype(np.float32))
    a = fast_unet_forward(flipped, x, torch.float32)
    b = torch.flip(fast_unet_forward(model, torch.flip(x, [2]), torch.float32), [2])
    np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5, atol=1e-5)


def test_unported_options_raise():
    """The options that raised before they were ported now build and run
    (tests/test_torch_unet_options.py holds each against flax); a shape that
    does not pool still raises."""
    x = torch.zeros(1, 1, 8, 8, 8)
    for opt in (dict(use_residuals=True), dict(dilation_rate_mult=2),
                dict(conv_dropout=0.1), dict(conv_size=5)):
        out = UNet3D(**SMALL, **opt)(x)
        assert out.shape == (1, 2, 8, 8, 8) and bool(torch.isfinite(out).all()), opt
    with pytest.raises(ValueError):
        UNet3D(**SMALL)(torch.zeros(1, 1, 6, 8, 8))  # 6 does not halve twice


def test_apply_axis_ops_matches_jax():
    """Device resample (three float32 einsums) == the JAX apply_axis_ops and
    the scipy oracle, on the matrices of tests/test_predict.py:57-60."""
    from synthsr_tpu.io.volume import resample_volume
    from synthsr_tpu.ops.host_matrices import resample_volume_matrices
    from synthsr_tpu.ops.linops import apply_axis_ops as jax_apply_axis_ops
    from synthsr_tpu_torch.ops.linops import apply_axis_ops

    rng = np.random.default_rng(1)
    vol = rng.normal(size=(24, 30, 18)).astype(np.float32)
    aff = np.diag([2.0, 0.7, 1.3, 1.0])
    mats, new_shape, _ = resample_volume_matrices(vol.shape, aff, [1.0, 1.0, 1.0])
    want = np.asarray(jax_apply_axis_ops(jnp.asarray(vol), [jnp.asarray(m) for m in mats]))
    got = apply_axis_ops(torch.from_numpy(vol), [torch.from_numpy(m) for m in mats]).numpy()
    assert got.shape == want.shape == new_shape
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    oracle, _ = resample_volume(vol, aff, [1.0, 1.0, 1.0])
    np.testing.assert_allclose(got, oracle, atol=2e-4)
    same = apply_axis_ops(torch.from_numpy(vol), [None, None, None])
    assert torch.equal(same, torch.from_numpy(vol))
