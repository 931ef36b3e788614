"""Hyperparameter draws on the device: the port of ``synthsr_tpu/synth/sampling.py``
(reference ``utils.draw_value_from_distribution``, utils.py:961-1049).

Every draw takes an explicit ``torch.Generator`` (on the device the values
are drawn on).  torch's Philox stream is not JAX's threefry stream, so a run
reproduces itself from its seed, not the JAX package's numbers; the tests
compare distributions (the KS harness of tests/test_distributions.py) and
feed both packages the same pre-drawn values.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.misc import load_array_if_path
from .device_constants import constant

_NUMERIC = (int, float, np.integer, np.floating)


def normalize_hyperparameter(hyperparameter, size=1, centre=0.0, default_range=10.0):
    """The polymorphic hyperparameter spec as a (2n, m) float32 array, or None
    when the spec is False (reference utils.py:1003-1020)."""
    if hyperparameter is False:
        return None
    hyperparameter = load_array_if_path(hyperparameter, load_as_numpy=True)
    if isinstance(hyperparameter, np.ndarray):
        if hyperparameter.shape[0] % 2:
            raise ValueError("hyperparameter rows must be divisible by 2")
        return np.asarray(hyperparameter, np.float32)
    if hyperparameter is None:
        return np.array([[centre - default_range] * size,
                         [centre + default_range] * size], np.float32)
    if isinstance(hyperparameter, _NUMERIC):
        return np.array([[centre - hyperparameter] * size,
                         [centre + hyperparameter] * size], np.float32)
    if isinstance(hyperparameter, (list, tuple)):
        if len(hyperparameter) != 2:
            raise ValueError("if list, hyperparameter must have length 2")
        return np.tile(np.asarray(hyperparameter, np.float32)[:, None], (1, size))
    raise ValueError("hyperparameter should be False/None/number/sequence/array")


def uniform(gen: torch.Generator, shape, low=0.0, high=1.0):
    """U(low, high) float32 on the generator's device."""
    u = torch.rand(shape, generator=gen, device=gen.device)
    return low + (high - low) * u


def normal(gen: torch.Generator, shape):
    return torch.randn(shape, generator=gen, device=gen.device)


def randint(gen: torch.Generator, low: int, high: int, shape=()):
    return torch.randint(low, high, shape, generator=gen, device=gen.device)


def bernoulli(gen: torch.Generator, prob: float):
    """Scalar coin, the reference's tf.less(uniform, prob) convention."""
    return uniform(gen, ()) < prob


def draw_value(gen: torch.Generator, hyperparameter, size=1, distribution="uniform",
               centre=0.0, default_range=10.0, positive_only=False):
    """(size,) float32 draw following the reference semantics, or None; a spec
    with 2n rows picks a random 2-row modality block first."""
    hp = normalize_hyperparameter(hyperparameter, size, centre, default_range)
    if hp is None:
        return None
    n_mod = hp.shape[0] // 2
    blocks = constant(hp, device=gen.device).reshape(n_mod, 2, hp.shape[1])
    block = blocks[randint(gen, 0, n_mod)] if n_mod > 1 else blocks[0]
    if distribution == "uniform":
        value = uniform(gen, (hp.shape[1],), block[0], block[1])
    elif distribution == "normal":
        value = block[0] + block[1] * normal(gen, (hp.shape[1],))
    else:
        raise ValueError("distribution should be 'uniform' or 'normal'")
    return torch.clamp(value, min=0.0) if positive_only else value


def make_gmm_sampler(n_labels, prior_means, prior_stds, prior_distributions="normal",
                     n_channels=1, generation_classes=None,
                     use_specific_stats_for_channel=None):
    """``gen -> (means, stds)``, each (n_labels, n_channels) float32: the GMM
    prior draws of ``synth/model_inputs.py`` (reference
    SynthSR/model_inputs.py:103-125) on the device.  Per-channel 2-row prior
    blocks, class draws expanded to labels through ``generation_classes``,
    positive-clipped; hyperprior defaults mean 125±100, std 15±10."""
    prior_means = load_array_if_path(prior_means, load_as_numpy=True)
    prior_stds = load_array_if_path(prior_stds, load_as_numpy=True)
    if generation_classes is None:
        generation_classes = np.arange(n_labels)
    generation_classes = np.asarray(load_array_if_path(generation_classes, load_as_numpy=True),
                                    np.int64)
    n_classes = len(np.unique(generation_classes))
    per_channel = use_specific_stats_for_channel in (None, True)
    if per_channel:
        for arr in (prior_means, prior_stds):
            if isinstance(arr, np.ndarray) and arr.shape[0] / 2 != n_channels:
                raise ValueError("the number of blocks in the prior array "
                                 "does not match n_channels")

    def channel_block(arr, channel):
        if isinstance(arr, np.ndarray) and per_channel:
            return arr[2 * channel: 2 * channel + 2, :]
        return arr

    def sample(gen: torch.Generator):
        classes = constant(generation_classes, device=gen.device)
        means, stds = [], []
        for channel in range(n_channels):
            m = draw_value(gen, channel_block(prior_means, channel), n_classes,
                           prior_distributions, 125.0, 100.0, positive_only=True)
            s = draw_value(gen, channel_block(prior_stds, channel), n_classes,
                           prior_distributions, 15.0, 10.0, positive_only=True)
            means.append(m[classes])
            stds.append(s[classes])
        return torch.stack(means, -1), torch.stack(stds, -1)

    return sample
