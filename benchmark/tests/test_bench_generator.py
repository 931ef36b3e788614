"""The plain generator (``reference/generator.py``) against the program's on
the CPU, at the train cell's settings and a tiny size: the static settings it
works out again agree with the program's, and from the same label map, GMM
parameters and draws it makes the same pair."""

import numpy as np
import pytest
import torch

from bench_common import harness, tiny
from reference import generator as ref_gen

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def bench():
    wl, cfg = tiny("train-128")
    return harness.entry(wl["entry"]).Bench(cfg, wl, 2024, "cpu")


def test_settings_match_the_program(bench):
    from synthsr_tpu_torch.ops.blur import blurring_sigma_np

    s, g = bench.ref_settings, bench.generator.cfg
    assert s["labels"] == [int(v) for v in g.generation_labels]
    lut = np.asarray(g.swap_lut)
    assert {a: int(lut[a]) for a in s["swap"]} == s["swap"]
    assert s["padded"] == list(g.padded_shape) and s["out"] == list(g.out_shape)
    assert list(g.crop_shape) == s["out"] and g.flip_axis == 0
    for i in range(g.n_channels):
        assert s["reg_err"][i] == bench.generator._sim_err(i)
        sigma = blurring_sigma_np(g.atlas_res3, g.data_res_rc[i], 0.42, g.thickness_rc[i])
        assert np.allclose(s["sigma"][i], sigma)


@pytest.mark.parametrize("seed", [7, 123456789012])
def test_same_pair_from_the_same_draws(bench, seed):
    gen = torch.Generator().manual_seed(seed)
    labels = torch.as_tensor(bench.maps[seed % len(bench.maps)])[..., None]
    means, stds = bench.sampler(gen)
    draws = bench.generator.sample(gen)
    image, target = bench.generator.apply(draws, labels, means, stds)
    want_i, want_t = ref_gen.generate(bench.ref_settings, labels, means, stds, draws)
    assert image.shape == want_i.shape and target.shape == want_t.shape
    g = ref_gen.gaps(torch.cat([image, target], -1), torch.cat([want_i, want_t], -1))
    assert float(g["max"].max()) < 1e-4, g
