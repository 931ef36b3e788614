"""The port's auto-encoder family (synthsr_tpu_torch/models/autoencoder.py)
against the flax modules of synthsr_tpu/models/autoencoder.py, through the
weight bridge (models/weights.py ``ae_variables_to_state_dict``).

The VAE's noise cannot match bit for bit (Philox vs threefry), so the flax
apply's own draw is recorded (``jax.random.normal`` wrapped during the
apply) and passed to the port as ``eps``.  Float32, atol 2e-4 (the ROADMAP
bar for module ports).  ``LocalBias`` mirrors tests/test_unet.py:318-340.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from synthsr_tpu.models.autoencoder import AutoEncoder3D as JaxAE
from synthsr_tpu.models.autoencoder import LocalBias as JaxLocalBias
from synthsr_tpu_torch.models.autoencoder import AutoEncoder3D, LocalBias
from synthsr_tpu_torch.models.weights import ae_state_dict_to_variables, ae_variables_to_state_dict

torch.set_num_threads(2)

ATOL = 2e-4
SHAPE = (16, 16, 16)


def _to_cf(a):
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(np.asarray(a), -1, 1)))


def _flax(ae_type, do_vae, final):
    model = JaxAE(nb_features=2, nb_levels=2, enc_size=(4,), ae_type=ae_type, do_vae=do_vae,
                  final_pred_activation=final)
    x = jnp.zeros((1, *SHAPE, 1))
    variables = model.init({"params": jax.random.PRNGKey(0), "vae": jax.random.PRNGKey(1)}, x)
    rng = np.random.default_rng(3)
    params = jax.tree.map(lambda p: jnp.asarray(rng.normal(size=p.shape, scale=0.1)
                                                .astype(np.float32)), variables["params"])
    return model, {"params": params}


def _recorded_apply(monkeypatch, model, variables, x, key):
    """flax apply with the VAE's N(0, 1) draw recorded."""
    drawn = []
    normal = jax.random.normal

    def record(*args, **kw):
        out = normal(*args, **kw)
        drawn.append(np.asarray(out))
        return out

    monkeypatch.setattr(jax.random, "normal", record)
    out = model.apply(variables, x, rngs={"vae": key})
    monkeypatch.setattr(jax.random, "normal", normal)
    return np.asarray(out), drawn


@pytest.mark.parametrize("ae_type,do_vae,final", [("conv", False, "linear"),
                                                  ("conv", False, "softmax"),
                                                  ("dense", False, "linear"),
                                                  ("conv", True, "linear"),
                                                  ("dense", True, "softmax")])
def test_autoencoder_matches_flax(monkeypatch, ae_type, do_vae, final):
    model, variables = _flax(ae_type, do_vae, final)
    x = np.random.default_rng(4).normal(size=(1, *SHAPE, 1)).astype(np.float32)
    want, drawn = _recorded_apply(monkeypatch, model, variables, jnp.asarray(x),
                                  jax.random.PRNGKey(2))
    assert len(drawn) == int(do_vae)
    bottleneck = tuple(s // 2 for s in SHAPE)
    port = AutoEncoder3D(in_channels=1, input_shape=SHAPE, nb_features=2, nb_levels=2,
                         enc_size=(4,), ae_type=ae_type, do_vae=do_vae,
                         final_pred_activation=final)
    sd = ae_variables_to_state_dict(variables, bottleneck)
    port.load_state_dict(sd)
    eps = None
    if do_vae:
        eps = torch.from_numpy(drawn[0]) if ae_type == "dense" else _to_cf(drawn[0])
    with torch.no_grad():
        got = port(_to_cf(x), eps=eps)
    np.testing.assert_allclose(got.permute(0, 2, 3, 4, 1).numpy(), want, atol=ATOL)
    back = ae_state_dict_to_variables(sd, bottleneck)["params"]
    jax.tree.map(lambda a, b: np.testing.assert_array_equal(np.asarray(a), b),
                 variables["params"], back)


def test_vae_draws_from_its_generator():
    """The port's VAE is stochastic across generators and repeatable for one
    seed (tests/test_unet.py:327-333)."""
    torch.manual_seed(0)
    vae = AutoEncoder3D(nb_features=2, nb_levels=2, enc_size=(4,), do_vae=True,
                        final_pred_activation="linear")
    x = torch.ones(1, 1, *SHAPE)
    with torch.no_grad():
        y1 = vae(x, generator=torch.Generator().manual_seed(2))
        y2 = vae(x, generator=torch.Generator().manual_seed(3))
        y1b = vae(x, generator=torch.Generator().manual_seed(2))
    assert y1.shape == (1, 1, *SHAPE)
    assert (y1 - y2).abs().max() > 1e-7
    assert torch.equal(y1, y1b)


def test_local_bias_matches_flax():
    """out = in + biasmult·kernel (tests/test_unet.py:335-340), with flax's
    kernel (D, H, W, C) moved to (C, D, H, W)."""
    xr = jnp.ones((1, *SHAPE, 1))
    lb = JaxLocalBias(biasmult=2.0)
    vb = lb.init(jax.random.PRNGKey(0), xr)
    want = np.asarray(lb.apply(vb, xr))
    port = LocalBias((1, *SHAPE), biasmult=2.0, generator=torch.Generator().manual_seed(0))
    assert port.kernel.shape == (1, *SHAPE)
    assert 0.03 < float(port.kernel.detach().std()) < 0.07  # N(0, 0.05²), as flax's initialiser
    with torch.no_grad():
        port.kernel.copy_(_to_cf(np.asarray(vb["params"]["kernel"])[None])[0])
        got = port(torch.ones(1, 1, *SHAPE))
    np.testing.assert_allclose(got.permute(0, 2, 3, 4, 1).numpy(), want, atol=1e-6)
    np.testing.assert_allclose(got[0].numpy(), 1.0 + 2.0 * port.kernel.detach().numpy(),
                               atol=1e-6)
