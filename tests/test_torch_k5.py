"""K5, the TPU's blocked conv (``_kernel``, synthsr_tpu/ops/conv_pallas.py:127,
entry ``conv3d_cf`` :990), against the port's conv3d_cf (H-fwd on a card,
its plain version here), and the large-field-of-view predict path that only
K5 served on the TPU."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import synthsr_tpu.models.unet_cf as jax_unet_cf
from synthsr_tpu.models.unet import UNet3D as FlaxUNet3D
from synthsr_tpu.ops.conv_pallas import (_flat_layout, _plane_layout, split_flat_group_for,
                                         split_group_for)
from synthsr_tpu.ops.conv_pallas import conv3d_cf as jax_k5
from synthsr_tpu_torch.models.unet import UNet3D, unet_layers
from synthsr_tpu_torch.models.unet_cf import fast_unet_forward
from synthsr_tpu_torch.models.weights import random_variables, variables_to_state_dict
from synthsr_tpu_torch.ops.conv_cf import conv3d_cf

torch.set_num_threads(2)

TWO_LEVEL = dict(nb_features=8, nb_levels=2)
KERNELS = ("conv3d_cf", "conv3d_cf_planes", "conv3d_cf_grouped", "conv3d_cf_flat",
           "conv3d_cf_flat_grouped")


@pytest.mark.parametrize("activation,width,bias", [(None, 24, False), ("elu", 24, True),
                                                   ("relu", 24, True), ("elu", 128, True)])
def test_k5_oracle(activation, width, bias):
    """The port's conv3d_cf (float32, plain version on the CPU) == JAX K5 in
    interpret mode at the shapes of tests/test_ops_core.py:191,211, atol 1e-5
    in float32 as that test states (only the summation order differs)."""
    rng = np.random.default_rng(11)
    x = rng.normal(size=(8, 8, 16, width)).astype(np.float32)
    w = rng.normal(size=(3, 3, 3, 8, 16)).astype(np.float32) * 0.1
    b = rng.normal(size=(16,)).astype(np.float32) if bias else None
    want = np.asarray(jax_k5(jnp.asarray(x), jnp.asarray(w),
                             bias=None if b is None else jnp.asarray(b),
                             activation=activation, interpret=True))
    got = conv3d_cf(torch.from_numpy(x), torch.from_numpy(w),
                    bias=None if b is None else torch.from_numpy(b), activation=activation)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


def _record_routes(monkeypatch, run_kernels=True):
    """Wrap the JAX fast forward's kernel entries and its channels-last conv
    so that each conv records (entry, source channels, cout, spatial, fused
    bias); returns the list the calls append to.  With ``run_kernels=False``
    a kernel entry returns zeros of its output's shape and dtype instead of
    tracing the Pallas kernel (the routing depends on shapes alone)."""
    calls = []

    def wrap(name, fn):
        def recorded(x, w, *args, **kwargs):
            srcs = x if isinstance(x, (list, tuple)) else [x]
            spatial = tuple(int(n) for n in srcs[0].shape[1:])
            calls.append((name, tuple(int(s.shape[0]) for s in srcs), int(w.shape[-1]),
                          spatial, "bias" in kwargs))
            if run_kernels:
                return fn(x, w, *args, **kwargs)
            if kwargs.get("head") is not None:
                return jnp.zeros((1, *spatial), jnp.float32)
            return jnp.zeros((int(w.shape[-1]), *spatial), srcs[0].dtype)
        return recorded

    for name in KERNELS:
        monkeypatch.setattr(jax_unet_cf, name, wrap(name, getattr(jax_unet_cf, name)))
    conv_cl = jax_unet_cf._conv_cl

    def recorded_cl(p, x):
        k = p["kernel"]
        calls.append(("xla", (int(k.shape[3]),), int(k.shape[-1]),
                      tuple(int(n) for n in x.shape[1:4]), True))
        return conv_cl(p, x)

    monkeypatch.setattr(jax_unet_cf, "_conv_cl", recorded_cl)
    return calls


def test_fast_forward_through_k5(monkeypatch):
    """A 2-level, 8-feature U-Net at (1, 6, 16, 128, 1): D = 6 fails every
    other layout's D % 4 test, so JAX runs all four level-0 convs on K5
    (checked with the layout gates and by recording the calls).  The port's
    float32 fast forward == the float32 flax forward (rtol 2e-4, atol 1e-4,
    as tests/test_torch_unet.py), and its bf16 fast forward against JAX
    fast_unet_forward(interpret=True) within 1e-2 relative L2 of it and of
    the float32 forward (the bf16 bar of tests/test_torch_unet.py).  The two
    bf16 paths round at different places: at this depth the port sits about
    0.8% from float32, growing stage by stage from the first conv's 0.3%, and
    the JAX path about 0.4%."""
    variables = random_variables(TWO_LEVEL, seed=5)
    level0 = [(cin, cout) for name, kind, cin, cout in unet_layers(UNet3D(**TWO_LEVEL).config, 1)
              if kind == "conv" and name.endswith(("_0_0", "_0_1", "_2_0", "_2_1"))]
    assert level0 == [(1, 8), (8, 8), (24, 8), (8, 8)]
    for cin, cout in level0:
        assert jax_unet_cf._pallas_ok(cin, cout, (6, 16, 128))
        assert _plane_layout(cin, cout, 6, 16, 128) is None
        assert split_group_for(cin, cout, 6, 16, 128) is None
        assert _flat_layout(cin, cout, 6, 16, 128) is None
        assert split_flat_group_for(cin, cout, 6, 16, 128) is None

    calls = _record_routes(monkeypatch)
    x = np.random.default_rng(12).normal(size=(1, 6, 16, 128, 1)).astype(np.float32)
    flax_model = FlaxUNet3D(**TWO_LEVEL)
    want = np.asarray(jax_unet_cf.fast_unet_forward(flax_model, variables, jnp.asarray(x),
                                                    interpret=True))
    assert [c[:3] for c in calls if c[3] == (6, 16, 128)] == [
        ("conv3d_cf", (1,), 8), ("conv3d_cf", (8,), 8), ("conv3d_cf", (24,), 8),
        ("conv3d_cf", (8,), 8)]
    f32 = np.asarray(flax_model.apply(variables, jnp.asarray(x)))

    model = UNet3D(**TWO_LEVEL).eval()
    model.load_state_dict(variables_to_state_dict(variables))
    xt = torch.from_numpy(np.ascontiguousarray(np.transpose(x, (0, 4, 1, 2, 3))))
    got32 = fast_unet_forward(model, xt, torch.float32).numpy()
    np.testing.assert_allclose(np.transpose(got32, (0, 2, 3, 4, 1)), f32, rtol=2e-4, atol=1e-4)
    got = np.transpose(fast_unet_forward(model, xt, torch.bfloat16).numpy(), (0, 2, 3, 4, 1))
    assert got.shape == want.shape == (1, 6, 16, 128, 1)

    def rel(a, b):
        return float(np.linalg.norm(a - b) / np.linalg.norm(b))

    assert rel(got, want) <= 1e-2
    assert rel(got, f32) <= 1e-2


# Which kernel each 3³ conv of the shipped net takes in the JAX fast forward
# (synthsr_tpu/models/unet_cf.py:_conv_cf, PREFER_FLAT off) at a padded
# predict shape, in the order of the net's convs: K1/K2 = conv3d_cf_planes,
# K3 = conv3d_cf_grouped, K4 = conv3d_cf_flat(_grouped), K5 = conv3d_cf,
# xla = the channels-last XLA conv.  PERF.md's routing table is this data.
ROUTES = {
    (192, 256, 512): ["planes", "k5", "planes", "planes", "planes", "planes", "flat", "flat",
                      "xla", "xla", "flat_grouped", "flat", "grouped", "planes", "grouped",
                      "planes", "xla", "xla"],
    (256, 512, 256): ["planes", "k5", "planes", "planes", "flat", "flat", "flat", "flat",
                      "xla", "xla", "flat_grouped", "flat", "flat_grouped", "flat", "grouped",
                      "planes", "k5 unfused", "k5"],
    (256, 256, 256): ["planes", "planes", "planes", "planes", "flat", "flat", "flat", "flat",
                      "xla", "xla", "flat_grouped", "flat", "flat_grouped", "flat", "grouped",
                      "planes", "grouped", "planes"],
}


@pytest.mark.parametrize("shape", list(ROUTES))
def test_large_fov_routing(shape, monkeypatch):
    """The JAX fast forward of the shipped net, traced abstractly
    (jax.eval_shape, nothing computed) at a padded predict shape: K5 carries
    the level-0 convs of a large field of view and no conv at 256³."""
    calls = _record_routes(monkeypatch, run_kernels=False)
    variables = jax.tree.map(lambda a: jax.ShapeDtypeStruct(a.shape, jnp.float32),
                             random_variables(seed=0))
    model = FlaxUNet3D(nb_features=24, nb_levels=5)
    jax.eval_shape(lambda v, x: jax_unet_cf.fast_unet_forward(model, v, x), variables,
                   jax.ShapeDtypeStruct((1, *shape, 1), jnp.float32))
    names = {"conv3d_cf": "k5", "conv3d_cf_planes": "planes", "conv3d_cf_grouped": "grouped",
             "conv3d_cf_flat": "flat", "conv3d_cf_flat_grouped": "flat_grouped", "xla": "xla"}
    routes = [names[entry] + ("" if entry != "conv3d_cf" or fused else " unfused")
              for entry, _, _, _, fused in calls]
    assert routes == ROUTES[shape]
    convs = [(cin, cout) for _, kind, cin, cout in unet_layers(UNet3D().config, 1)
             if kind == "conv"]
    assert [(sum(c[1]), c[2]) for c in calls] == convs
    assert all(c[3] == shape for c, r in zip(calls, routes) if r.startswith("k5"))
