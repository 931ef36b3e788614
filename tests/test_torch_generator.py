"""The port's synthesis slice (synthsr_tpu_torch: ops/interp.py, ops/linops.py,
ops/blur.py, synth/sampling.py, synth/augment.py, synth/labels_to_image.py,
synth/brain_generator.py) against the JAX package on the same numpy arrays.

torch's random stream is not JAX's, so the random stages are compared on the
same draws: the JAX package's values are replayed from its key (the split
order of each JAX function, restated in the ``_replay_*`` helpers) and fed to
the port's apply functions.  The port's own draws, from a ``torch.Generator``,
are held to the reference distributions with the KS harness of
tests/test_distributions.py.  Float32 comparisons use the ROADMAP bar
(atol 2e-4) or tighter.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from synthsr_tpu.io.volume import save_volume
from synthsr_tpu.ops import blur as jblur
from synthsr_tpu.ops import interp as jinterp
from synthsr_tpu.ops import linops as jlinops
from synthsr_tpu.synth import augment as jaug
from synthsr_tpu.synth import labels_to_image as jl2i
from synthsr_tpu_torch.ops import blur, interp, linops
from synthsr_tpu_torch.synth import augment, sampling
from synthsr_tpu_torch.synth import labels_to_image as l2i

torch.set_num_threads(2)

TOL = dict(rtol=1e-5, atol=2e-4)  # ROADMAP.md:22-23


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, **tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **(tol or TOL))


# ---------------------------------------------------------------------------
# interp, linops, blur
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("method", ["linear", "nearest"])
def test_interpn_and_transform_match_jax(method):
    """Sampling inside and outside the volume (edge replication), with and
    without a channel axis, and the dense-shift warp."""
    rng = np.random.default_rng(1)
    vol = rng.normal(size=(9, 10, 11, 2)).astype(np.float32)
    loc = rng.uniform(-2, 12, size=(5, 6, 7, 3)).astype(np.float32)
    shift = rng.normal(size=(9, 10, 11, 3)).astype(np.float32) * 2
    for v in (vol, vol[..., 0]):
        _close(interp.interpn(_t(v), _t(loc), method),
               jinterp.interpn(jnp.asarray(v), jnp.asarray(loc), method))
        _close(interp.transform(_t(v), _t(shift), method),
               jinterp.transform(jnp.asarray(v), jnp.asarray(shift), method))


def test_affine_shifts_match_jax():
    rng = np.random.default_rng(2)
    aff = np.eye(4, dtype=np.float32)
    aff[:3] += rng.normal(size=(3, 4)).astype(np.float32) * 0.1
    svf = rng.normal(size=(8, 9, 10, 3)).astype(np.float32)
    _close(interp.affine_to_shift(_t(aff), (8, 9, 10)),
           jinterp.affine_to_shift(jnp.asarray(aff), (8, 9, 10)))
    _close(interp.combine_nonlinear_and_affine_shift(_t(svf), _t(aff)),
           jinterp.combine_nonlinear_and_affine_shift(jnp.asarray(svf), jnp.asarray(aff)))


@pytest.mark.parametrize("method,dtype", [("linear", np.float32), ("nearest", np.float32),
                                          ("nearest", np.int32)])
def test_resize_matches_jax(method, dtype):
    rng = np.random.default_rng(3)
    vol = (rng.normal(size=(7, 9, 5, 2)) * 10).astype(dtype)
    for shape, zoom in (((14, 4, 10), None), ((5, 5, 5), 0.7)):
        got = interp.resize(_t(vol), shape, zoom, method)
        want = jinterp.resize(jnp.asarray(vol), shape, zoom, method)
        assert got.numpy().dtype == np.asarray(want).dtype
        _close(got, want)


@pytest.mark.parametrize("bound", [None, 4.0])
def test_integrate_vec_matches_jax(bound):
    """The port's all-gather scaling and squaring against the JAX gather
    (bound None) and its stencil-warp fast path (a static bound)."""
    rng = np.random.default_rng(4)
    vec = np.clip(rng.normal(size=(12, 12, 12, 3)) * 1.5, -4, 4).astype(np.float32)
    _close(interp.integrate_vec(_t(vec), nb_steps=7),
           jinterp.integrate_vec(jnp.asarray(vec), nb_steps=7, max_displacement=bound))


def test_linops_match_jax():
    rng = np.random.default_rng(5)
    for sigma in (0.0, 1.3):
        _close(linops.gaussian_kernel_1d(sigma, 7), jlinops.gaussian_kernel_1d(sigma, 7))
    _close(linops.blur_matrix(11, 1.1, 1.5), jlinops.blur_matrix(11, 1.1, 1.5))
    _close(linops.blur_matrix(6, 0.1), jlinops.blur_matrix(6, 0.1))
    for method in ("linear", "nearest"):
        _close(linops.resize_matrix(7, 13, None, method), jlinops.resize_matrix(7, 13, None, method))
        _close(linops.resize_matrix(9, 4, 1.7, method), jlinops.resize_matrix(9, 4, 1.7, method))
        coords = rng.uniform(-1, 14, 10).astype(np.float32)
        _close(linops.sample_matrix(coords, 13, method), jlinops.sample_matrix(coords, 13, method))
    _close(linops.nn_downsample_matrix(6, 13, 0.45, lr_count=4),
           jlinops.nn_downsample_matrix(6, 13, 0.45, lr_count=4))
    vol = rng.normal(size=(6, 7, 8, 2)).astype(np.float32)
    mats = [rng.normal(size=(4, 6)).astype(np.float32), None,
            rng.normal(size=(3, 8)).astype(np.float32)]
    _close(linops.apply_axis_ops(_t(vol), [None if m is None else _t(m) for m in mats]),
           jlinops.apply_axis_ops(jnp.asarray(vol), [None if m is None else jnp.asarray(m)
                                                     for m in mats]))
    _close(linops.blur3d(_t(vol), [0.8, 1.2, 0.0], [1.0, 1.5, 0.0]),
           jlinops.blur3d(jnp.asarray(vol), [0.8, 1.2, 0.0], [1.0, 1.5, 0.0]))


def test_blur_matches_jax():
    rng = np.random.default_rng(6)
    cur = np.array([1.0, 1.0, 1.0], np.float32)
    for down, coef, thick in (([1.0, 3.0, 0.0], None, None), ([2.0, 1.0, 5.0], 0.42, None),
                              ([2.0, 4.0, 5.0], 0.42, [1.5, 4.0, 2.0])):
        _close(blur.blurring_sigma_for_downsampling(cur, np.float32(down), coef, thick),
               jblur.blurring_sigma_for_downsampling(cur, jnp.asarray(down, jnp.float32),
                                                      coef, thick))
        np.testing.assert_array_equal(blur.blurring_sigma_np(cur, down, coef, thick),
                                      jblur.blurring_sigma_np(cur, down, coef, thick))
    vol = rng.normal(size=(8, 9, 10, 1)).astype(np.float32)
    mask = (rng.uniform(size=(8, 9, 10, 1)) > 0.3).astype(np.float32)
    _close(blur.blur_with_mask(_t(vol), [1.0, 0.7, 1.4], _t(mask)),
           jblur.blur_with_mask(jnp.asarray(vol), [1.0, 0.7, 1.4], jnp.asarray(mask)))


# ---------------------------------------------------------------------------
# the augment stages, on the JAX package's draws
# ---------------------------------------------------------------------------

def test_affine_composition_matches_jax(monkeypatch):
    """Scale @ Shear @ (Rx@Ry@Rz) with a translation column, on given angles,
    shears, scales and translation (each package's draw function patched)."""
    values = {15.0: [10.0, -20.0, 35.0], 0.01: [0.01, -0.02, 0.03, 0.0, -0.01, 0.02],
              0.15: [0.9, 1.1, 1.05], 5.0: [1.0, -2.0, 3.5]}

    def fake(arr):
        return lambda _key, hp, size=1, distribution="uniform", centre=0.0, default_range=10.0, \
            positive_only=False: arr(np.asarray(values[default_range], np.float32))

    monkeypatch.setattr(jaug, "draw_traced", fake(jnp.asarray))
    monkeypatch.setattr(augment, "draw_value", fake(torch.from_numpy))
    gen = torch.Generator()
    for kw in (dict(rotation_bounds=15), dict(rotation_bounds=15, scaling_bounds=0.15,
                                              shearing_bounds=0.01, translation_bounds=5)):
        _close(augment.sample_affine_matrix(gen, **kw),
               jaug.sample_affine_matrix(jax.random.PRNGKey(0), **kw), rtol=1e-6, atol=1e-6)


def _replay_deformation(key, key_crop, spatial, crop, scaling_bounds, rotation_bounds,
                        shearing_bounds, translation_bounds, nonlin_std, nonlin_scale):
    """The draws of JAX random_spatial_deformation[_cropped] (augment.py:89-245)."""
    k_aff, k_std, k_svf, _ = jax.random.split(key, 4)
    draws = {}
    if list(crop) != list(spatial):
        room = jnp.array([s - c for s, c in zip(spatial, crop)], jnp.float32)
        draws["crop_idx"] = _t(jnp.floor(jax.random.uniform(key_crop, (3,)) * room)
                               .astype(jnp.int32)).long()
    if any(b is not False for b in (scaling_bounds, rotation_bounds, shearing_bounds,
                                    translation_bounds)):
        draws["affine"] = _t(jaug.sample_affine_matrix(
            k_aff, rotation_bounds, scaling_bounds, shearing_bounds, translation_bounds))
    if nonlin_std > 0:
        std = jax.random.uniform(k_std, (1, 1), maxval=nonlin_std)[0, 0]
        svf = jax.random.normal(k_svf, (*jaug.small_shape_for(spatial, nonlin_scale), 3)) * std
        draws["svf"] = _t(jnp.clip(svf, -4.0 * nonlin_std, 4.0 * nonlin_std))
    return draws


@pytest.mark.parametrize("cropped", [True, False])
def test_spatial_deformation_matches_jax(cropped):
    """Affine + integrated SVF warp of a label map (nearest) and an image
    (linear), on the crop window or the whole volume."""
    rng = np.random.default_rng(7)
    labels = rng.integers(0, 5, (20, 20, 20, 1)).astype(np.int32)
    image = rng.normal(size=(20, 20, 20, 1)).astype(np.float32)
    crop = [12, 16, 14] if cropped else [20, 20, 20]
    bounds = dict(scaling_bounds=0.15, rotation_bounds=15, shearing_bounds=0.012,
                  translation_bounds=False, nonlin_std=3.0, nonlin_scale=0.25)
    key, key_crop = jax.random.split(jax.random.PRNGKey(8))
    vols = [jnp.asarray(labels), jnp.asarray(image)]
    if cropped:
        want = jaug.random_spatial_deformation_cropped(key, key_crop, vols,
                                                       ["nearest", "linear"], crop, **bounds)
    else:
        want = jaug.random_spatial_deformation(key, vols, ["nearest", "linear"], **bounds)
    d = _replay_deformation(key, key_crop, (20, 20, 20), crop, **bounds)
    got = augment.spatial_deformation([_t(labels), _t(image)], ["nearest", "linear"], crop,
                                      d.get("crop_idx"), d["affine"], d["svf"])
    assert got[0].dtype == torch.int32
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    _close(got[1], want[1])


def test_flip_and_gmm_match_jax():
    """Left/right flip with the label swap (both outcomes of the coin), and the
    GMM draw as a plain gather: labels outside the list take row 0, a
    duplicated value takes its last row."""
    rng = np.random.default_rng(9)
    gen_labels = np.array([0, 24, 2, 3, 41, 42, 3], np.int32)
    lut = augment.build_swap_lut(gen_labels[:6], 2)
    np.testing.assert_array_equal(lut, jaug.build_swap_lut(gen_labels[:6], 2))
    labels = rng.choice([0, 24, 2, 3, 41, 42, 7], size=(6, 7, 8, 1)).astype(np.int32)
    image = rng.normal(size=(6, 7, 8, 1)).astype(np.float32)
    flips = set()
    for seed in range(6):
        key = jax.random.PRNGKey(seed)
        want = jaug.random_flip(key, [jnp.asarray(labels), jnp.asarray(image)], [0],
                                [True, False], lut)
        f = _t(jax.random.uniform(key, (1,)) < 0.5)
        flips.add(bool(f[0]))
        got = augment.random_flip([_t(labels), _t(image)], f, [0], [True, False], lut)
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    assert flips == {True, False}
    means = rng.uniform(0, 200, (7, 2)).astype(np.float32)
    stds = rng.uniform(1, 10, (7, 2)).astype(np.float32)
    key = jax.random.PRNGKey(10)
    want = jaug.sample_conditional_gmm(key, jnp.asarray(labels), jnp.asarray(means),
                                       jnp.asarray(stds), gen_labels)
    noise = _t(jax.random.normal(key, (6, 7, 8, 2)))
    _close(augment.sample_conditional_gmm(_t(labels), _t(means), _t(stds), gen_labels, noise),
           want, rtol=1e-6, atol=1e-5)


def _replay_bias(key, spatial, std, scale, prob=0.95):
    k_std, k_field, k_prob = jax.random.split(key, 3)
    s = jax.random.uniform(k_std, (1, 1, 1, 1), maxval=std)
    field = jax.random.normal(k_field, (*jaug.small_shape_for(spatial, scale), 1)) * s
    return _t(field), _t(jax.random.uniform(k_prob, ()) < prob)


def _replay_intensity(key, shape, noise_std=0, gamma_std=0, contrast_inversion=False,
                      separate_channels=True, prob_noise=0.95, prob_gamma=1):
    """The draws of JAX intensity_augmentation (augment.py:575-624)."""
    k_nstd, k_noise, k_pn, k_gamma, k_pg, k_inv = jax.random.split(key, 6)
    sample_shape = (1, 1, 1, shape[-1]) if separate_channels else (1, 1, 1, 1)
    d = {}
    if noise_std > 0:
        std = jax.random.uniform(k_nstd, sample_shape, maxval=noise_std)
        noise = jax.random.normal(k_noise, shape if separate_channels else (*shape[:3], 1))
        d["noise"] = _t(jnp.broadcast_to(noise * std, shape))
        if prob_noise != 1:
            d["noise_on"] = _t(jax.random.uniform(k_pn, ()) < prob_noise)
    if gamma_std > 0:
        d["gamma"] = _t(jax.random.normal(k_gamma, sample_shape) * gamma_std)
        if prob_gamma != 1:
            d["gamma_on"] = _t(jax.random.uniform(k_pg, ()) < prob_gamma)
    if contrast_inversion:
        d["invert"] = _t(jax.random.uniform(k_inv, sample_shape) < 0.5)
    return d


@pytest.mark.parametrize("separate_channels", [True, False])
def test_bias_and_intensity_match_jax(separate_channels):
    """Bias field (both outcomes of its coin over the seeds), then noise ->
    clip -> robust min-max -> gamma -> inversion on the replayed draws."""
    rng = np.random.default_rng(11)
    x = rng.uniform(10, 100, (12, 10, 8, 2)).astype(np.float32)
    for seed in range(3):
        key = jax.random.PRNGKey(seed)
        want = jaug.bias_field_corruption(key, jnp.asarray(x[..., :1]), 0.3, 0.25, prob=0.5)
        got = augment.bias_field_corruption(_t(x[..., :1]), *_replay_bias(key, x.shape[:3],
                                                                          0.3, 0.25, prob=0.5))
        _close(got, want, rtol=1e-5, atol=1e-4)
        kw = dict(noise_std=5.0, gamma_std=0.4, contrast_inversion=True,
                  separate_channels=separate_channels, prob_noise=0.95, prob_gamma=0.9)
        want = jaug.intensity_augmentation(key, jnp.asarray(x), clip=[0, 80], normalise=True,
                                           norm_perc=0.02, **kw)
        got = augment.intensity_augmentation(_t(x), _replay_intensity(key, x.shape, **kw),
                                             clip=[0, 80], normalise=True, norm_perc=0.02,
                                             separate_channels=separate_channels)
        _close(got, want)


def test_blur_resample_and_acquisition_match_jax():
    """The randomised blur on drawn factors, resampling with the reliability
    map, and the acquisition simulation at a drawn resolution."""
    rng = np.random.default_rng(12)
    x = rng.normal(size=(16, 18, 20, 1)).astype(np.float32)
    key = jax.random.PRNGKey(13)
    factors = _t(jax.random.uniform(key, (3,), minval=1 / 1.15, maxval=1.15))
    sigma = np.array([0.8, 1.2, 2.0], np.float32)
    _close(augment.gaussian_blur(_t(x), _t(sigma), factors, 1.15, max_sigma=[1.0, 1.5, 2.5]),
           jaug.gaussian_blur(jnp.asarray(x), jnp.asarray(sigma), key=key, blur_range=1.15,
                              max_sigma=[1.0, 1.5, 2.5]))
    for sub in (None, [1.0, 3.0, 2.0]):
        got = augment.resample_tensor(_t(x), [8, 9, 10], "linear", sub, [1.0, 1.0, 1.0],
                                      build_reliability_map=True)
        want = jaug.resample_tensor(jnp.asarray(x), [8, 9, 10], "linear", sub, [1.0, 1.0, 1.0],
                                    build_reliability_map=True)
        for g, w in zip(got, want):
            _close(g, w)
    res = np.array([1.0, 3.7, 2.2], np.float32)
    got = augment.mimic_acquisition(_t(x), _t(res), [1.0, 1.0, 1.0], [16, 18, 20],
                                    build_dist_map=True)
    want = jaug.mimic_acquisition(jnp.asarray(x), jnp.asarray(res), [1.0, 1.0, 1.0],
                                  [16, 18, 20], build_dist_map=True)
    for g, w in zip(got, want):
        _close(g, w)


# ---------------------------------------------------------------------------
# the whole generator (exact_warp=True semantics)
# ---------------------------------------------------------------------------

def _replay_generator(cfg, key):
    """The draws of JAX build_generator's generate() from ``key``
    (labels_to_image.py:243-387, exact_warp=True), as the port's draws dict."""
    keys = jax.random.split(key, 8 + 8 * cfg.n_channels)
    d = _replay_deformation(keys[0], keys[1], cfg.padded_shape, cfg.crop_shape,
                            cfg.scaling_bounds, cfg.rotation_bounds, cfg.shearing_bounds,
                            cfg.translation_bounds, cfg.nonlin_std, cfg.nonlin_shape_factor)
    crop = list(cfg.crop_shape)
    if cfg.flipping:
        d["flip"] = _t(jax.random.uniform(keys[2], (1,)) < 0.5)
    d["gmm_noise"] = _t(jax.random.normal(keys[3], (*crop, cfg.n_channels)))
    max_res = np.array([cfg.max_res_iso] * 3, np.float32)
    for i in range(cfg.n_channels):
        kc = jax.random.split(keys[5 + i], 8)
        if cfg.input_channels[i]:
            d[f"bias_{i}"] = _replay_bias(kc[0], crop, cfg.bias_field_std, cfg.bias_shape_factor)
        d[f"intensity_{i}"] = _replay_intensity(kc[1], (*crop, 1), gamma_std=0.5)
        if not cfg.input_channels[i]:
            continue
        if cfg.simulate_reg_rc[i] and i != cfg.idx_first_input_channel:
            kt_fwd, kt_err = jax.random.split(jax.random.fold_in(keys[4], i))
            d[f"t_fwd_{i}"] = _t(jaug.sample_affine_matrix(kt_fwd, rotation_bounds=5,
                                                           translation_bounds=5))
            d[f"t_err_{i}"] = _t(jaug.sample_affine_matrix(kt_err, rotation_bounds=0.5,
                                                           translation_bounds=0.5))
        if cfg.randomise_rc[i]:
            res, thick = jaug.sample_resolution(kc[3], list(cfg.atlas_res3),
                                                max_res_iso=max_res, max_res_aniso=max_res)
            d[f"res_{i}"], d[f"thick_{i}"] = _t(res), _t(thick)
        d[f"blur_{i}"] = _t(jax.random.uniform(kc[4] if cfg.randomise_rc[i] else kc[5], (3,),
                                               minval=1 / cfg.blur_range, maxval=cfg.blur_range))
    return d


_SIDED = np.array([0, 24, 2, 3, 41, 42], np.int32)

GENERATOR_CASES = {
    # bench_train.py's tutorial-7 shape at 1/8 size: 2 inputs of fixed
    # anisotropic resolution, the second with registration error; a synthetic
    # target; reliability maps; padding and a crop
    "tutorial7": dict(
        labels_shape=[24, 24, 24], input_channels=[False, True, True], output_channel=[0],
        output_shape=16, output_div_by_n=8, padding_margin=2, scaling_bounds=0.1,
        rotation_bounds=8, shearing_bounds=0.01, translation_bounds=False, nonlin_std=2.0,
        nonlin_shape_factor=0.125, data_res=np.array([[1.0, 1.0, 3.0], [1.0, 3.0, 1.0]]),
        thickness=np.array([[1.0, 1.0, 2.0], [1.0, 2.0, 1.0]]), downsample=True,
        build_reliability_maps=True, bias_field_std=0.2, bias_shape_factor=0.125),
    # a random acquisition resolution, a 2 mm target, no crop
    "randomise_res": dict(
        labels_shape=[32, 32, 32], input_channels=[True], output_channel=[0], target_res=2.0,
        output_shape=16, randomise_res=True, nonlin_std=3.0, build_reliability_maps=True,
        bias_shape_factor=0.125),
}


@pytest.mark.parametrize("case", sorted(GENERATOR_CASES))
def test_generator_matches_jax(case):
    """Labels -> (image, target) of the port on the JAX generator's replayed
    draws, against the JAX generator with exact_warp=True; the resolved
    shapes and the layout of the port's own draws agree too."""
    kw = dict(GENERATOR_CASES[case], generation_labels=_SIDED, n_neutral_labels=2,
              atlas_res=[1.0, 1.0, 1.0], flipping=True, aff=np.eye(4))
    jcfg = jl2i.GenerationConfig(exact_warp=True, **kw).resolve()
    generator = l2i.build_generator(l2i.GenerationConfig(**kw))
    cfg = generator.cfg
    for field in ("crop_shape", "out_shape", "pad_margin", "downsample_rc", "randomise_rc",
                  "flip_axis"):
        assert getattr(cfg, field) == getattr(jcfg, field), field
    np.testing.assert_array_equal(cfg.data_res_rc, jcfg.data_res_rc)

    rng = np.random.default_rng(14)
    lab = np.zeros(kw["labels_shape"], np.int32)
    inner = tuple(slice(3, s - 3) for s in lab.shape)
    lab[inner] = rng.choice(_SIDED[1:], size=lab[inner].shape)
    means = rng.uniform(10, 200, (len(_SIDED), cfg.n_channels)).astype(np.float32)
    stds = rng.uniform(1, 10, (len(_SIDED), cfg.n_channels)).astype(np.float32)
    key = jax.random.PRNGKey(15)
    want = jl2i.build_generator(jcfg)(key, jnp.asarray(lab), jnp.asarray(means),
                                      jnp.asarray(stds))
    draws = _replay_generator(cfg, key)
    got = generator.apply(draws, _t(lab), _t(means), _t(stds))
    n_in = sum(kw["input_channels"]) * 2
    assert got[0].shape == (*cfg.out_shape, n_in) and got[1].shape == (*cfg.out_shape, 1)
    _close(got[0], want[0])
    _close(got[1], want[1])

    own = generator.sample(torch.Generator().manual_seed(0))
    assert own.keys() == draws.keys()
    for k, v in draws.items():
        o = own[k]
        if isinstance(v, dict):
            assert {n: t.shape for n, t in o.items()} == {n: t.shape for n, t in v.items()}, k
        elif isinstance(v, tuple):
            assert [t.shape for t in o] == [t.shape for t in v], k
        else:
            assert o.shape == v.shape and o.dtype == v.dtype, k


def test_brain_generator_facade(tmp_path):
    """The host facade on label maps from disk (tests/test_generator.py:37,90):
    shapes, ranges, determinism per seed and a stream that advances."""
    from synthsr_tpu_torch.synth.brain_generator import BrainGenerator

    rng = np.random.default_rng(0)
    for i in range(2):
        lab = np.zeros((32, 32, 32), np.int32)
        lab[4:28, 4:28, 4:28] = rng.choice(_SIDED, size=(24, 24, 24))
        save_volume(lab, np.eye(4), None, str(tmp_path / f"map{i}.nii.gz"))
    kw = dict(labels_dir=str(tmp_path), generation_labels=_SIDED, n_neutral_labels=2,
              prior_means=None, prior_stds=None, input_channels=True, output_channel=0,
              output_shape=24, data_res=np.array([1.0, 1.0, 3.0]),
              thickness=np.array([1.0, 1.0, 3.0]), downsample=True,
              build_reliability_maps=True, seed=11)
    g1, g2 = BrainGenerator(**kw), BrainGenerator(**kw)
    image, target = g1.generate_brain()
    assert image.shape == (24, 24, 24, 2) and target.shape == (24, 24, 24)
    assert np.isfinite(image).all() and np.isfinite(target).all()
    assert image[..., 1].min() >= -1e-5 and image[..., 1].max() <= 1 + 1e-5
    assert 0 <= target.min() and target.max() <= 1 + 1e-5
    image2, target2 = g2.generate_brain()
    np.testing.assert_array_equal(image, image2)
    np.testing.assert_array_equal(target, target2)
    assert np.abs(g1.generate_brain()[0] - image).max() > 1e-4


# ---------------------------------------------------------------------------
# the port's own draws: the KS harness of tests/test_distributions.py
# ---------------------------------------------------------------------------

def _port_draws(fn, n=None):
    from test_distributions import N

    gen = torch.Generator().manual_seed(0)
    outs = [fn(gen) for _ in range(n or N)]
    if isinstance(outs[0], tuple):
        return tuple(torch.stack([o[i] for o in outs]).numpy() for i in range(len(outs[0])))
    return torch.stack(outs).numpy()


@pytest.mark.parametrize("case", ["both", "iso_only", "aniso_only"])
def test_port_sample_resolution_marginals(case):
    from test_distributions import MAX_ANISO, MAX_ISO, MIN_RES, P_MIN, _ks, _np_res_draws

    max_iso = None if case == "aniso_only" else MAX_ISO
    max_aniso = None if case == "iso_only" else MAX_ANISO
    res, thick = _port_draws(lambda g: augment.sample_resolution(
        g, MIN_RES, max_res_iso=max_iso, max_res_aniso=max_aniso))
    res_np, thick_np = _np_res_draws(max_iso, max_aniso)
    for ax in range(3):
        assert _ks(res[:, ax], res_np[:, ax]) > P_MIN, (case, ax)
        assert _ks(thick[:, ax], thick_np[:, ax]) > P_MIN, (case, ax)
    assert np.all(thick <= res + 1e-5) and np.all(thick >= MIN_RES - 1e-5)


@pytest.mark.parametrize("distribution", ["uniform", "normal"])
def test_port_draw_value_multiblock_marginals(distribution):
    from test_distributions import N, P_MIN, _ks, np_draw_value

    hp = np.array([[0.0, 1.0, -2.0, 5.0], [1.0, 2.0, 1.0, 6.0],
                   [10.0, 10.0, 10.0, 10.0], [12.0, 11.0, 13.0, 10.5],
                   [-5.0, 0.0, 0.0, 0.0], [1.0, 1.0, 1.0, 1.0]], np.float32)
    vals = _port_draws(lambda g: sampling.draw_value(g, hp, distribution=distribution))
    rng = np.random.default_rng(2)
    ref = np.stack([np_draw_value(rng, hp, distribution) for _ in range(N)])
    for col in range(hp.shape[1]):
        assert _ks(vals[:, col], ref[:, col]) > P_MIN, (distribution, col)


def test_port_gmm_sampler_and_gamma_marginals():
    """The GMM prior draws with class sharing (the reference's None-spec
    quirk included: N(25, 225) means, N(5, 25) stds), and the gamma of the
    intensity augmentation."""
    from test_distributions import N, P_MIN, _ks

    classes = np.array([0, 1, 1, 2], np.int32)
    sampler = sampling.make_gmm_sampler(n_labels=4, prior_means=None, prior_stds=None,
                                        prior_distributions="normal",
                                        generation_classes=classes)
    means, stds = _port_draws(sampler)
    means, stds = means[..., 0], stds[..., 0]
    rng = np.random.default_rng(4)
    ref_m = np.maximum(rng.normal(25.0, 225.0, N), 0.0)
    ref_s = np.maximum(rng.normal(5.0, 25.0, N), 0.0)
    for lab in range(4):
        assert _ks(means[:, lab], ref_m) > P_MIN
        assert _ks(stds[:, lab], ref_s) > P_MIN
    np.testing.assert_array_equal(means[:, 1], means[:, 2])
    assert not np.array_equal(means[:, 0], means[:, 1])

    x = torch.tensor([0.0, 0.5, 1.0]).reshape(3, 1, 1, 1)
    vals = _port_draws(lambda g: augment.intensity_augmentation(
        x, augment.sample_intensity_augmentation(g, x.shape, gamma_std=0.4))[1, 0, 0, 0])
    ref = 0.5 ** np.exp(np.random.default_rng(6).normal(0.0, 0.4, N))
    assert _ks(vals, ref) > P_MIN
