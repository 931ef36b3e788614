"""The port's weight gradient and differentiable conv (synthsr_tpu_torch/ops:
``conv3d_cf_wgrad``, ``conv3d_cf_train``) against the JAX package's Pallas
weight-gradient kernels (K6, K7) and ``conv3d_cf_train`` custom_vjp, run in
interpret mode on the same numpy inputs.

On the CPU ``conv3d_cf_wgrad`` is its plain version (float32
``conv3d_weight``); the ``cuda``-marked test holds H-wgrad-mma (bf16) and
H-wgrad-x3 (float32) against it on the card.  JAX is imported inside the tests
that compare against it, so the ``cuda`` test also runs where JAX is not
installed.
"""

import numpy as np
import pytest
import torch

from synthsr_tpu_torch.ops import conv_cf
from synthsr_tpu_torch.ops.conv_cf import (LAUNCHES, conv3d_cf_wgrad, conv3d_cf_wgrad_reference,
                                           reset_launch_counts, wgrad_plan)
from synthsr_tpu_torch.ops.conv_train import conv3d_cf_train

torch.set_num_threads(2)

WGRAD_TOL = dict(rtol=2e-5, atol=1e-3)  # tests/test_ops_core.py:457
TRAIN_TOL = dict(rtol=1e-5, atol=1e-4)  # float32, sums in another order


def _t(a, grad=False):
    return torch.from_numpy(np.array(a, np.float32)).requires_grad_(grad)


@pytest.mark.parametrize("ci,co,d,h,w", [
    (4, 8, 8, 16, 128), (24, 8, 8, 16, 128),   # K6 shapes (test_ops_core.py:468)
    (6, 4, 8, 32, 96), (4, 4, 8, 32, 160),     # K7 shapes (test_ops_core.py:443)
])
def test_wgrad_reference_matches_pallas(ci, co, d, h, w):
    import jax.numpy as jnp

    from synthsr_tpu.ops.conv_pallas import conv3d_cf_wgrad as jax_wgrad

    rng = np.random.default_rng(ci * 100 + w)
    x = rng.normal(size=(ci, d, h, w)).astype(np.float32)
    g = rng.normal(size=(co, d, h, w)).astype(np.float32)
    want = np.asarray(jax_wgrad(jnp.asarray(x), jnp.asarray(g), interpret=True))
    got = conv3d_cf_wgrad(_t(x), _t(g))
    assert got.shape == (3, 3, 3, ci, co) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **WGRAD_TOL)


def test_wgrad_rounds_g_to_x_dtype_and_dispatches_plain_on_cpu():
    """g is rounded to x.dtype before the float32 sums (conv_pallas.py:1230);
    a CPU tensor runs the plain version and launches nothing; any other
    device raises."""
    rng = np.random.default_rng(1)
    x = _t(rng.normal(size=(3, 4, 6, 10))).to(torch.bfloat16)
    g = _t(rng.normal(size=(5, 4, 6, 10)))
    reset_launch_counts()
    got = conv3d_cf_wgrad(x, g)
    want = conv3d_cf_wgrad_reference(x.float(), g.to(torch.bfloat16).float())
    assert torch.equal(got, want)
    assert LAUNCHES == {"first": 0, "first_mma": 0, "fwd_mma": 0, "wgrad_mma": 0, "fwd_x3": 0,
                        "wgrad_x3": 0}
    with pytest.raises(ValueError):
        conv3d_cf_wgrad(x.to("meta"), g.to("meta"))
    with pytest.raises(ValueError):
        conv3d_cf_wgrad(x, g[:, :3])


@pytest.mark.parametrize("shape", [(4, 24, 128, 128, 128), (48, 24, 128, 128, 128),
                                   (96, 48, 64, 64, 64), (384, 384, 8, 8, 8),
                                   (5, 13, 7, 9, 20), (2, 3, 1, 1, 1)])
def test_wgrad_plan(shape):
    """H-wgrad-mma (bf16) and H-wgrad-x3 (float32): items of 4 x 32 voxels,
    co tiles of 48 where 48 divides C_out (bf16 only), else 32 (16 for C_out
    <= 16),
    WGRAD_MMA_BLOCKS_PER_SM (bf16) or WGRAD_X3_BLOCKS_PER_SM (float32) blocks
    per SM on 132 SMs unless the volume runs out, at least one item per
    split."""
    ci, co, d, h, w = shape
    for dtype, per_sm in ((torch.bfloat16, conv_cf.WGRAD_MMA_BLOCKS_PER_SM),
                          (torch.float32, conv_cf.WGRAD_X3_BLOCKS_PER_SM)):
        plan = wgrad_plan(*shape, n_sm=132, dtype=dtype)
        assert (plan.th, plan.tw) == conv_cf.WGRAD_MMA_TILE
        assert plan.co_tile == (48 if co % 48 == 0 and dtype == torch.bfloat16 else
                                32 if co > 16 else 16)
        items = d * -(-h // plan.th) * -(-w // plan.tw)
        assert 1 <= plan.n_split <= items
        blocks = plan.n_split * -(-ci // 8) * -(-co // plan.co_tile)
        assert blocks >= min(per_sm * 132, items)


@pytest.mark.parametrize("cins,activation,want_dx", [
    ((4,), "elu", True), ((4,), "relu", False), ((4, 4), "elu", True), ((8, 4), "relu", True),
    ((4,), None, True),
])
def test_conv_train_matches_jax_grad(cins, activation, want_dx):
    """Forward and every gradient of the autograd Function against jax.grad
    through conv3d_cf_train(interpret=True) (K2 forward and dx, K6 dw at
    W = 128, D = 4): 1 and 2 sources, elu / relu / none, sources with and
    without a gradient (the JAX want_dx=False)."""
    import jax
    import jax.numpy as jnp

    from synthsr_tpu.ops.conv_train import conv3d_cf_train as jax_train

    rng = np.random.default_rng(sum(cins) + want_dx)
    spatial = (4, 8, 128)
    cout = 8
    srcs = [rng.normal(size=(c, *spatial)).astype(np.float32) for c in cins]
    w = (rng.normal(size=(3, 3, 3, sum(cins), cout)) * 0.2).astype(np.float32)
    b = (rng.normal(size=(cout,)) * 0.1).astype(np.float32)
    cot = rng.normal(size=(cout, *spatial)).astype(np.float32)

    def jloss(srcs_, w_, b_):
        y = jax_train(tuple(srcs_), w_, b_, activation, True, want_dx)
        return jnp.sum(y * cot), y

    (_, jy), (jds, jdw, jdb) = jax.value_and_grad(jloss, argnums=(0, 1, 2), has_aux=True)(
        [jnp.asarray(s) for s in srcs], jnp.asarray(w), jnp.asarray(b))

    ts = [_t(s, want_dx) for s in srcs]
    tw, tb = _t(w, True), _t(b, True)
    y = conv3d_cf_train(ts, tw, tb, activation)
    grads = torch.autograd.grad((y * _t(cot)).sum(), ([*ts] if want_dx else []) + [tw, tb])
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(jy), **TRAIN_TOL)
    np.testing.assert_allclose(grads[-2].numpy(), np.asarray(jdw), rtol=2e-5, atol=2e-3)
    np.testing.assert_allclose(grads[-1].numpy(), np.asarray(jdb), rtol=2e-5, atol=2e-3)
    for got, want in zip(grads[:-2], jds):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TRAIN_TOL)


def test_conv_train_bf16_keeps_dpre_in_activation_dtype():
    """bf16 sources: output and source gradients in bf16, weight and bias
    gradients float32; the values equal the float32 Function run on the
    bf16-rounded inputs and weights within bf16 rounding."""
    rng = np.random.default_rng(7)
    x = _t(rng.normal(size=(6, 4, 8, 16))).to(torch.bfloat16).requires_grad_(True)
    w = _t(rng.normal(size=(3, 3, 3, 6, 8)) * 0.2, True)
    b = _t(rng.normal(size=(8,)) * 0.1, True)
    cot = _t(rng.normal(size=(8, 4, 8, 16)))
    y = conv3d_cf_train((x,), w, b, "elu")
    dx, dw, db = torch.autograd.grad((y.float() * cot).sum(), (x, w, b))
    assert y.dtype == dx.dtype == torch.bfloat16 and dw.dtype == db.dtype == torch.float32
    x32 = x.detach().float().requires_grad_(True)
    w32 = w.detach().to(torch.bfloat16).float().requires_grad_(True)
    y32 = conv3d_cf_train((x32,), w32, b, "elu")
    dx32, dw32 = torch.autograd.grad((y32 * cot).sum(), (x32, w32))
    for got, want in ((y, y32), (dx, dx32), (dw, dw32)):
        rel = float((got.detach().float() - want.detach()).norm() / want.detach().norm())
        assert rel < 1e-2, rel


@pytest.mark.cuda
def test_wgrad_kernel_matches_plain_on_card():
    """H-wgrad-mma (bf16) and H-wgrad-x3 (float32) against
    conv3d_cf_wgrad_reference on the card, at ragged shapes (tiles cut at
    every face, ci and co not multiples of the channel group and co tile,
    W = 20 on the 2-byte load path) and the train step's first-conv shape
    (ci = 4), and two calls bit-equal.  The reference is float32 with TF32
    off."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    old = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        rng = np.random.default_rng(8)
        dev = torch.device("cuda")
        for dtype, kernel in ((torch.bfloat16, "wgrad_mma"), (torch.float32, "wgrad_x3")):
            for ci, co, d, h, w in ((5, 13, 7, 9, 20), (24, 72, 8, 12, 48), (3, 24, 16, 5, 40),
                                    (4, 24, 16, 16, 32), (48, 96, 6, 8, 64)):
                x = _t(rng.normal(size=(ci, d, h, w))).to(dev, dtype)
                g = _t(rng.normal(size=(co, d, h, w))).to(dev, dtype)
                before = LAUNCHES[kernel]
                got = conv3d_cf_wgrad(x, g)
                again = conv3d_cf_wgrad(x, g)
                torch.cuda.synchronize()
                assert LAUNCHES[kernel] == before + 2
                want = conv3d_cf_wgrad_reference(x, g)
                rel = float((got - want).abs().max() / want.abs().max())
                assert rel <= 1e-5, (dtype, ci, co, rel)
                assert torch.equal(got, again)
    finally:
        torch.backends.cudnn.allow_tf32 = old
