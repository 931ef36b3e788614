"""The port's label and tensor utility ops (synthsr_tpu_torch/synth/label_ops.py)
against synthsr_tpu/synth/label_ops.py on the same numpy inputs, with the
random ops fed JAX's draws (replayed from its key with the split order of
each JAX function), the morphology against scipy as tests/test_label_ops.py:
56,65 holds the JAX ops, and the port's own draws against JAX's draws
(KS harness of tests/test_distributions.py for continuous values, the
frequency of each integer within 0.02 for discrete ones).  Exact equality
for integer and mask outputs; float32 gradients atol 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.ndimage import binary_dilation, binary_erosion

from synthsr_tpu.synth import label_ops as jops
from synthsr_tpu_torch.synth import label_ops as ops

torch.set_num_threads(2)


def _t(a):
    return torch.from_numpy(np.array(a))


def test_reset_and_convert_match_jax():
    rng = np.random.default_rng(0)
    x = rng.choice([0, 1, 2, 3, 7, 9], size=(6, 5, 4, 1)).astype(np.int32)
    np.testing.assert_array_equal(ops.reset_values_to_zero(_t(x), [1, 3]).numpy(),
                                  np.asarray(jops.reset_values_to_zero(jnp.asarray(x), [1, 3])))
    for dest in (None, [10, 20, 30, 40, 50, 60]):
        np.testing.assert_array_equal(
            ops.convert_labels(_t(x), [0, 1, 2, 3, 7, 9], dest).numpy(),
            np.asarray(jops.convert_labels(jnp.asarray(x), [0, 1, 2, 3, 7, 9], dest)))


def _replay_mask_edges(key, shape, axes, boundaries, prob_mask):
    """The draws of JAX mask_edges (label_ops.py:37-66)."""
    from synthsr_tpu.utils.misc import reformat_to_list, reformat_to_n_channels_array

    axes = reformat_to_list(axes, dtype="int")
    bounds = reformat_to_n_channels_array(boundaries, n_dims=4, n_channels=len(axes))
    keys = jax.random.split(key, len(axes) + 1)
    idx1, idx2 = [], []
    for i, axis in enumerate(axes):
        size, b = shape[axis], bounds[i]
        i1 = jnp.round(jax.random.uniform(keys[i], (), minval=b[0] * size, maxval=b[1] * size))
        i2 = jnp.round(jax.random.uniform(jax.random.fold_in(keys[i], 1), (),
                                          minval=b[2] * size, maxval=b[3] * size - 1) - i1)
        idx1.append(i1)
        idx2.append(i2)
    coin = jax.random.uniform(keys[-1], ()) < prob_mask
    return {"idx1": _t(jnp.stack(idx1)), "idx2": _t(jnp.stack(idx2)), "apply": _t(coin)}


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_mask_edges_matches_jax_on_replayed_draws(seed):
    x = np.random.default_rng(seed).normal(size=(20, 18, 16, 1)).astype(np.float32)
    bounds = np.array([[0.2, 0.45, 0.85, 0.9], [0.1, 0.3, 0.7, 0.95]])
    key = jax.random.PRNGKey(seed)
    want = jops.mask_edges(key, jnp.asarray(x), axes=[0, 2], boundaries=bounds, prob_mask=0.7)
    draws = _replay_mask_edges(key, x.shape, [0, 2], bounds, 0.7)
    got = ops.mask_edges(_t(x), [0, 2], draws)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    own = ops.sample_mask_edges(torch.Generator().manual_seed(seed), x.shape, [0, 2], bounds, 0.7)
    assert {k: v.shape for k, v in own.items()} == {k: v.shape for k, v in draws.items()}


@pytest.mark.parametrize("kind", ["sobel", "1-step_diff"])
def test_image_gradients_match_jax(kind):
    x = np.random.default_rng(3).normal(size=(10, 11, 12, 2)).astype(np.float32)
    got = ops.image_gradients(_t(x), kind)
    want = jops.image_gradients(jnp.asarray(x), kind)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5)
    np.testing.assert_allclose(ops.image_gradients(_t(x), kind, return_magnitude=True).numpy(),
                               np.asarray(jops.image_gradients(jnp.asarray(x), kind,
                                                               return_magnitude=True)),
                               atol=1e-5)
    np.testing.assert_array_equal(np.stack(ops.sobel_kernels_np(3)),
                                  np.stack(jops.sobel_kernels_np(3)))
    for r in (1, 2, 3):
        np.testing.assert_array_equal(ops.unit_kernel_np(r), jops.unit_kernel_np(r))


def _replay_dilation_erosion(key, min_factor, max_factor, operation):
    k_op, k_f1, k_f2 = jax.random.split(key, 3)
    lo, hi = {"dilation": (0.0, 1.0), "erosion": (-1.0, 0.0), "random": (-1.0, 1.0)}[operation]
    p = jax.random.uniform(k_op, (), minval=lo, maxval=hi)
    if min_factor == max_factor:
        return _t(p), torch.tensor(float(min_factor))
    f_erode = jax.random.randint(k_f1, (), min_factor, max_factor).astype(jnp.float32)
    f_dilate = jax.random.randint(k_f2, (), min_factor, max_factor).astype(jnp.float32)
    return _t(p), _t(jnp.where(p < 0, f_erode, f_dilate))


@pytest.mark.parametrize("operation,prob", [("random", 1.0), ("random", 0.6),
                                            ("dilation", 1.0), ("erosion", 1.0)])
def test_dilation_erosion_matches_jax_on_replayed_draws(operation, prob):
    x = (np.random.default_rng(4).uniform(size=(14, 15, 16, 1)) > 0.7).astype(np.float32) * 3
    for seed in range(4):
        key = jax.random.PRNGKey(seed)
        want = jops.random_dilation_erosion(key, jnp.asarray(x), 1, 3, prob=prob,
                                            operation=operation)
        p, factor = _replay_dilation_erosion(key, 1, 3, operation)
        got = ops.random_dilation_erosion(_t(x), p, factor, 3, prob=prob)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_dilation_matches_scipy(rng):
    """tests/test_label_ops.py:56 on the port."""
    x = (rng.uniform(size=(16, 16, 16, 1)) > 0.9).astype(np.float32)
    p, f = ops.sample_dilation_erosion(torch.Generator().manual_seed(0), 2, 2, operation="dilation")
    out = ops.random_dilation_erosion(_t(x), p, f, 2, return_mask=True)
    ball = ops.unit_kernel_np(2, 3).astype(bool)
    np.testing.assert_array_equal(out.numpy()[..., 0], binary_dilation(x[..., 0] > 0,
                                                                       structure=ball))


def test_erosion_matches_scipy(rng):
    """tests/test_label_ops.py:65 on the port: outside the volume counts as
    foreground (border_value=1)."""
    x = (rng.uniform(size=(16, 16, 16, 1)) > 0.4).astype(np.float32)
    p, f = ops.sample_dilation_erosion(torch.Generator().manual_seed(0), 1, 1, operation="erosion")
    out = ops.random_dilation_erosion(_t(x), p, f, 1, return_mask=True)
    ball = ops.unit_kernel_np(1, 3).astype(bool)
    np.testing.assert_array_equal(out.numpy()[..., 0], binary_erosion(
        x[..., 0] > 0, structure=ball, border_value=1))


def test_port_morphology_and_edge_draws_match_jax_distribution():
    """The port's own draws: the morphology's against JAX's (10 000 each; the
    operation variable by KS, the integer radius by frequency), the edge
    band's rounded start against numpy's round(U(4, 9)) by frequency."""
    from test_distributions import N, P_MIN, _draws, _ks

    def jax_draw(k):
        k_op, k_f1, k_f2 = jax.random.split(k, 3)
        p = jax.random.uniform(k_op, (), minval=-1.0, maxval=1.0)
        return p, jnp.where(p < 0, jax.random.randint(k_f1, (), 1, 4),
                            jax.random.randint(k_f2, (), 1, 4))

    jp, jf = _draws(jax_draw)
    gen = torch.Generator().manual_seed(0)
    own = [ops.sample_dilation_erosion(gen, 1, 4) for _ in range(N)]
    p = torch.stack([o[0] for o in own]).numpy()
    f = torch.stack([o[1] for o in own]).numpy()
    assert _ks(p, np.asarray(jp)) > P_MIN
    for v in (1, 2, 3):
        assert abs(np.mean(f == v) - np.mean(np.asarray(jf) == v)) < 0.02, v
    bounds = np.array([[0.2, 0.45, 0.85, 0.9]])
    edges = [ops.sample_mask_edges(gen, (20, 20, 20, 1), 1, bounds) for _ in range(2000)]
    i1 = np.array([float(e["idx1"][0]) for e in edges])
    ref = np.round(np.random.default_rng(1).uniform(4.0, 9.0, 20000))
    for v in range(4, 10):
        assert abs(np.mean(i1 == v) - np.mean(ref == v)) < 0.03, v
