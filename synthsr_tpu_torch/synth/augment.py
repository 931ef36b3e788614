"""The synthesis / augmentation ops: the port of ``synthsr_tpu/synth/augment.py``
(the reference's Keras layers of ``ext/lab2im/layers.py``, one sample at a
time, channels-last (X, Y, Z, C)).

Each random op is split in two: ``sample_*`` draws its random values from a
``torch.Generator`` on the device, and the op itself applies given values, so
the tests can feed both packages the same draws.  Resampling runs as per-axis
matrices (``ops/linops.py``) and warps as plain gathers (``ops/interp.py``).
Dropped TPU workarounds: the select-sum forms of the GMM draw and of the
left/right label swap (augment.py:283-345) are plain gathers here, and the
deformation runs on the crop window with one code path whether or not a crop
follows.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..ops import interp, linops
from ..utils.misc import get_mapping_lut
from .device_constants import cached, constant
from .sampling import bernoulli, draw_value, normal, randint, uniform


# ---------------------------------------------------------------------------
# affine sampling (reference utils.py:675-817)
# ---------------------------------------------------------------------------

def _rotation_matrix_3d(gen, rotation_bounds, enable_90_rotations):
    angles = draw_value(gen, rotation_bounds, size=3, default_range=15.0)
    if angles is None:
        angles = torch.zeros(3, device=gen.device)
    if enable_90_rotations:
        angles = angles + 90.0 * randint(gen, 0, 4, (3,)).to(torch.float32)
    a = angles * (math.pi / 180.0)
    c, s = torch.cos(a), torch.sin(a)
    one, zero = torch.ones((), device=a.device), torch.zeros((), device=a.device)
    rx = torch.stack([torch.stack([one, zero, zero]), torch.stack([zero, c[0], -s[0]]),
                      torch.stack([zero, s[0], c[0]])])
    ry = torch.stack([torch.stack([c[1], zero, s[1]]), torch.stack([zero, one, zero]),
                      torch.stack([-s[1], zero, c[1]])])
    rz = torch.stack([torch.stack([c[2], -s[2], zero]), torch.stack([s[2], c[2], zero]),
                      torch.stack([zero, zero, one])])
    return rx @ ry @ rz


def sample_affine_matrix(gen, rotation_bounds=False, scaling_bounds=False,
                         shearing_bounds=False, translation_bounds=False,
                         enable_90_rotations=False):
    """Random (4, 4) affine: Scale @ Shear @ (Rx@Ry@Rz) with a translation
    column (reference utils.sample_affine_transform:675-752)."""
    dev = gen.device
    eye = torch.eye(3, device=dev)
    t_rot = _rotation_matrix_3d(gen, rotation_bounds, enable_90_rotations) \
        if (rotation_bounds is not False) or enable_90_rotations else eye
    t_shear = eye
    if shearing_bounds is not False:
        sh = draw_value(gen, shearing_bounds, size=6, default_range=0.01)
        one = torch.ones((), device=dev)
        t_shear = torch.stack([one, sh[0], sh[1], sh[2], one, sh[3], sh[4], sh[5], one]) \
            .reshape(3, 3)
    t_scale = eye
    if scaling_bounds is not False:
        t_scale = torch.diag(draw_value(gen, scaling_bounds, size=3, centre=1.0,
                                        default_range=0.15))
    trans = torch.zeros(3, device=dev)
    if translation_bounds is not False:
        trans = draw_value(gen, translation_bounds, size=3, default_range=5.0)
    out = torch.eye(4, device=dev)
    out[:3, :3] = t_scale @ t_shear @ t_rot
    out[:3, 3] = trans
    return out


def invert_affine(m):
    """The inverse of a (4, 4) affine ``[A t; 0 1]``: ``[A⁻¹ −A⁻¹t; 0 1]``,
    with A⁻¹ the adjugate over the determinant (row i: the cross product of
    the other two columns of A).  Device ops alone: ``torch.linalg.inv``
    checks its result on the host, which waits on the card and cannot be
    captured in a CUDA graph."""
    a, t = m[:3, :3], m[:3, 3]
    cof = torch.linalg.cross(torch.roll(a, -1, 1), torch.roll(a, -2, 1), dim=0)
    inv = cof.T / (a[:, 0] * cof[:, 0]).sum()
    out = torch.eye(4, dtype=m.dtype, device=m.device)
    out[:3, :3] = inv
    out[:3, 3] = -(inv @ t)
    return out


# ---------------------------------------------------------------------------
# RandomSpatialDeformation + RandomCrop (reference lab2im/layers.py:54-274)
# ---------------------------------------------------------------------------

def small_shape_for(shape, scale):
    """ceil(shape * scale) (reference utils.get_resample_shape:577-588)."""
    return tuple(int(math.ceil(s * scale)) for s in shape)


def _applies_affine(scaling_bounds, rotation_bounds, shearing_bounds, translation_bounds,
                    enable_90_rotations):
    return (scaling_bounds is not False) or (rotation_bounds is not False) \
        or (shearing_bounds is not False) or (translation_bounds is not False) \
        or enable_90_rotations


def sample_deformation(gen, spatial, crop_shape, scaling_bounds=0.15, rotation_bounds=15,
                       shearing_bounds=0.012, translation_bounds=False,
                       enable_90_rotations=False, nonlin_std=3.0, nonlin_scale=0.0625,
                       clip_svf_sigmas=4.0):
    """The draws of :func:`spatial_deformation`: ``crop_idx`` (3,) int64 (only
    when the crop is smaller than ``spatial``), ``affine`` (4, 4) and ``svf``
    (the small velocity field, std ~ U(0, nonlin_std) applied, clipped to
    ±clip_svf_sigmas·nonlin_std as the JAX package does)."""
    draws = {}
    if list(crop_shape) != list(spatial):
        draws["crop_idx"] = sample_crop(gen, spatial, crop_shape)
    if _applies_affine(scaling_bounds, rotation_bounds, shearing_bounds, translation_bounds,
                       enable_90_rotations):
        draws["affine"] = sample_affine_matrix(gen, rotation_bounds, scaling_bounds,
                                               shearing_bounds, translation_bounds,
                                               enable_90_rotations)
    if nonlin_std > 0:
        std = uniform(gen, (), 0.0, nonlin_std)
        svf = normal(gen, (*small_shape_for(spatial, nonlin_scale), 3)) * std
        if clip_svf_sigmas is not None:
            bound = float(clip_svf_sigmas) * float(nonlin_std)
            svf = torch.clamp(svf, -bound, bound)
        draws["svf"] = svf
    return draws


def spatial_deformation(vols, methods, crop_shape, crop_idx=None, affine=None, svf=None):
    """Deform (affine ∘ integrated SVF) and crop every (X, Y, Z, C) tensor of
    ``vols`` jointly, computing the field and the gather on the crop window
    only; ``methods``: 'linear' or 'nearest' per tensor.  The SVF is resized to
    max(spatial // 2, small), integrated in 7 squaring steps and resized to
    the window (reference :178-197)."""
    spatial = vols[0].shape[:3]
    dev = vols[0].device
    idx = torch.zeros(3, dtype=torch.long, device=dev) if crop_idx is None else crop_idx
    if affine is None and svf is None:
        return random_crop(vols, idx, crop_shape)
    coords = [idx[d].to(torch.float32) + torch.arange(crop_shape[d], dtype=torch.float32,
                                                       device=dev) for d in range(3)]
    mesh = list(torch.meshgrid(*coords, indexing="ij"))
    svf_w = None
    if svf is not None:
        half = tuple(max(int(spatial[d] / 2), svf.shape[d]) for d in range(3))
        field = interp.integrate_vec(interp.resize(svf, half, method="linear"), nb_steps=7)
        mats = [linops.sample_matrix(coords[d] / (spatial[d] / half[d]), half[d])
                for d in range(3)]
        svf_w = linops.apply_axis_ops(field, mats)
    if affine is not None:
        centre = [(spatial[d] - 1) / 2.0 for d in range(3)]
        moved = [mesh[d] - centre[d] for d in range(3)]
        if svf_w is not None:
            moved = [moved[d] + svf_w[..., d] for d in range(3)]
        flat = torch.stack([m.reshape(-1) for m in moved]
                           + [torch.ones(moved[0].numel(), device=dev)], 0)
        loc = (affine[:3].to(torch.float32) @ flat).T.reshape(*crop_shape, 3) \
            + constant(centre, torch.float32, dev)
    else:
        loc = torch.stack(mesh, -1) + svf_w
    return [interp.interpn(v.to(torch.float32), loc, method=m).to(v.dtype)
            for v, m in zip(vols, methods)]


def sample_crop(gen, spatial, crop_shape):
    """The offset of :func:`random_crop`: (3,) int64, floor(U(0, 1)·(dim -
    crop)) per axis, as JAX's ``augment.random_crop`` draws it."""
    room = constant([s - c for s, c in zip(spatial, crop_shape)], torch.float32, gen.device)
    return torch.floor(uniform(gen, (3,)) * room).long()


def random_crop(vols, crop_idx, crop_shape):
    """Crop every (X, Y, Z, C) tensor of ``vols`` to ``crop_shape`` at the
    offset ``crop_idx`` (reference RandomCrop, lab2im/layers.py:214-274)."""
    dev = vols[0].device
    idx = crop_idx.to(dev)
    return [v.index_select(0, idx[0] + torch.arange(crop_shape[0], device=dev))
            .index_select(1, idx[1] + torch.arange(crop_shape[1], device=dev))
            .index_select(2, idx[2] + torch.arange(crop_shape[2], device=dev))
            for v in vols]


# ---------------------------------------------------------------------------
# RandomFlip (reference lab2im/layers.py:277-427)
# ---------------------------------------------------------------------------

def build_swap_lut(label_list, n_neutral_labels):
    """LUT exchanging left/right label values (reference :375-386), or None
    when one side is absent."""
    label_list = np.asarray(label_list)
    n_labels = len(label_list)
    if n_neutral_labels == n_labels:
        return None
    mid = n_neutral_labels + int((n_labels - n_neutral_labels) / 2)
    parts = np.split(label_list, [n_neutral_labels, mid])
    return get_mapping_lut(label_list, np.concatenate([parts[0], parts[2], parts[1]]))


def sample_flip(gen, n_axes=1, prob=0.5):
    """(n_axes,) bool: flip along each axis."""
    return uniform(gen, (n_axes,)) < prob


def random_flip(vols, flips, axes, swap_flags, swap_lut=None):
    """Flip every tensor along ``axes`` where ``flips``; swap left/right label
    values (LUT semantics: listed values mapped, the rest of [0, len) -> 0,
    indices clipped) on tensors flagged in ``swap_flags`` when the number of
    flips is odd."""
    odd = flips.to(torch.int64).sum() % 2 != 0
    outs = []
    for v, swap in zip(vols, swap_flags):
        out = v
        if swap and swap_lut is not None:
            lut = constant(swap_lut, device=v.device)
            swapped = lut[torch.clamp(v.to(torch.int64), 0, len(lut) - 1)].to(v.dtype)
            out = torch.where(odd, swapped, out)
        for i, ax in enumerate(axes):
            out = torch.where(flips[i], torch.flip(out, [ax]), out)
        outs.append(out)
    return outs


# ---------------------------------------------------------------------------
# SampleConditionalGMM (reference lab2im/layers.py:430-501)
# ---------------------------------------------------------------------------

def gmm_label_index(generation_labels, device=None):
    """Label value -> GMM row LUT (duplicates keep their LAST row, values not
    listed go to row 0, as the reference's zeros-initialised LUT)."""
    gen = np.asarray(generation_labels, np.int64)
    lut = np.zeros(int(gen.max()) + 1, np.int64)
    for li, lv in enumerate(gen.tolist()):
        lut[lv] = li
    return torch.as_tensor(lut, device=device)


def sample_conditional_gmm(labels, means, stds, generation_labels, noise):
    """image[x, c] = stds[row(labels[x]), c]·noise[x, c] + means[row(labels[x]), c].

    labels: (X, Y, Z) or (X, Y, Z, 1) int; means/stds (n_labels, n_channels);
    noise: N(0, 1) of shape (X, Y, Z, n_channels)."""
    labels = labels.to(torch.int64)
    if labels.dim() == 4:
        labels = labels[..., 0]
    gen_labels = np.asarray(generation_labels, np.int64)
    lut = cached(("gmm_label_index", gen_labels.tobytes(), labels.device),
                 lambda: gmm_label_index(gen_labels, labels.device))
    inside = (labels >= 0) & (labels < len(lut))
    rows = torch.where(inside, lut[torch.clamp(labels, 0, len(lut) - 1)],
                       torch.zeros((), dtype=torch.int64, device=labels.device))
    return stds.to(torch.float32)[rows] * noise + means.to(torch.float32)[rows]


# ---------------------------------------------------------------------------
# SampleResolution (reference lab2im/layers.py:504-652)
# ---------------------------------------------------------------------------

def sample_resolution(gen, min_resolution, max_res_iso=None, max_res_aniso=None,
                      prob_iso=0.1, prob_min=0.05, return_thickness=True):
    """Random acquisition resolution (3,) and slice thickness (3,), with the
    reference's per-axis-independent draws in the 'isotropic' branch (:625).

    With ``return_thickness=False`` only the resolution is returned, but the
    thickness is still drawn: JAX's function splits its key for it either
    way, and here skipping the draw would shift every later draw of ``gen``."""
    min_res = constant(np.asarray(min_resolution, np.float32), device=gen.device)
    max_iso = None if max_res_iso is None else np.asarray(max_res_iso, np.float32)
    max_aniso = None if max_res_aniso is None else np.asarray(max_res_aniso, np.float32)
    if max_iso is not None and np.array_equal(np.asarray(min_resolution, np.float32), max_iso):
        max_iso = None
    if max_aniso is not None and np.array_equal(np.asarray(min_resolution, np.float32),
                                                max_aniso):
        max_aniso = None
    mask = torch.arange(3, device=gen.device) == randint(gen, 0, 3)
    as_t = (lambda a: constant(a, device=gen.device))
    if max_iso is None and max_aniso is None:
        res = min_res
    elif max_aniso is None:
        iso = uniform(gen, (3,), min_res, as_t(max_iso))
        res = torch.where(bernoulli(gen, prob_min), min_res, iso)
    elif max_iso is None:
        aniso = uniform(gen, (3,), min_res, as_t(max_aniso))
        res = torch.where(bernoulli(gen, prob_min), min_res, torch.where(mask, aniso, min_res))
    else:
        iso = uniform(gen, (3,), min_res, as_t(max_iso))
        aniso = uniform(gen, (3,), min_res, as_t(max_aniso))
        res = torch.where(bernoulli(gen, prob_iso), iso, torch.where(mask, aniso, min_res))
        res = torch.where(bernoulli(gen, prob_min), min_res, res)
    thick = uniform(gen, (3,), min_res, res)
    return (res, thick) if return_thickness else res


# ---------------------------------------------------------------------------
# GaussianBlur / DynamicGaussianBlur (reference lab2im/layers.py:655-832)
# ---------------------------------------------------------------------------

def sample_blur_factors(gen, blur_range):
    """σ factors U(1/blur_range, blur_range) (3,) (reference :725-728)."""
    return uniform(gen, (3,), 1.0 / blur_range, blur_range)


def gaussian_blur(x, sigma, factors=None, blur_range=None, max_sigma=None):
    """Separable blur; with ``blur_range`` (≠ 1) the sigma is multiplied by the
    drawn ``factors``.  ``max_sigma`` bounds a drawn sigma (it sizes the
    window); it defaults to ``sigma``."""
    sig = constant(sigma, torch.float32, x.device)
    max_sigma = np.asarray(sigma if max_sigma is None else max_sigma, np.float32)
    if blur_range is not None and blur_range != 1:
        if factors is None:
            raise ValueError("blur_range randomisation needs the drawn factors")
        sig = sig * factors
        max_sigma = max_sigma * blur_range
    return linops.blur3d(x, [sig[0], sig[1], sig[2]], list(max_sigma))


# ---------------------------------------------------------------------------
# MimicAcquisition (reference lab2im/layers.py:835-999)
# ---------------------------------------------------------------------------

def acquisition_down_shape(spatial, volume_res, min_subsample_res=None):
    """The static down grid of :func:`mimic_acquisition` for a volume of
    ``spatial`` voxels at ``volume_res``: its size at the finest resolution
    that can be drawn, ``min_subsample_res`` (default ``volume_res``)."""
    volume_res = np.asarray(volume_res, np.float32)
    if min_subsample_res is None:
        min_subsample_res = volume_res
    return [int(spatial[d] * volume_res[d] / np.asarray(min_subsample_res)[d])
            for d in range(3)]


def sample_acquisition_noise(gen, down_shape, n_channels, noise_std, prob_noise=0.95):
    """The draws of :func:`mimic_acquisition`'s noise on the acquisition grid
    (reference :876, :953-961), in the order of JAX's key split
    (augment.py:484-490): a per-channel std ~ U(0, ``noise_std``) of shape
    (1, 1, 1, C), N(0, 1) over the whole static down grid ``down_shape``
    (:func:`acquisition_down_shape`) times C, and the coin U(0, 1) <
    ``prob_noise``, drawn only when ``prob_noise`` < 1 (else None: always)."""
    std = uniform(gen, (1, 1, 1, n_channels), 0.0, noise_std)
    noise = normal(gen, (*down_shape, n_channels))
    take = bernoulli(gen, prob_noise) if prob_noise < 1 else None
    return std, noise, take


def mimic_acquisition(x, resolution, volume_res, resample_shape, build_dist_map=False,
                      min_subsample_res=None, noise=None):
    """Nearest-downsample to the drawn acquisition grid, then linear re-upsample
    to ``resample_shape``, as per-axis matrices on the static maximum down
    grid (edge semantics of augment.py:431-436).

    ``noise``: the draws of :func:`sample_acquisition_noise` (std, N(0, 1),
    coin), or None.  Without them the two resamplings compose into one
    matrix per axis, as in the generator, which adds no noise.  With them the
    down grid is materialised and ``std·noise`` is added to all of it where
    the coin says so (its rows beyond the drawn size, edge replicas, get
    noise too, as in JAX) before the up-sampling (reference :953-961)."""
    spatial = x.shape[:3]
    dev = x.device
    volume_res = np.asarray(volume_res, np.float32)
    down_static = acquisition_down_shape(spatial, volume_res, min_subsample_res)
    resolution = torch.as_tensor(resolution, dtype=torch.float32, device=dev)
    dmats, umats, dist_axes = [], [], []
    for d in range(3):
        in_d = spatial[d]
        down_d = torch.floor(in_d * float(volume_res[d]) / resolution[d])
        g = torch.arange(down_static[d], dtype=torch.float32, device=dev)
        dmats.append(linops.sample_matrix(torch.clamp(g / (down_d / in_d), 0.0, in_d - 1.0),
                                          in_d, method="nearest"))
        u = torch.arange(resample_shape[d], dtype=torch.float32, device=dev)
        up_coords = torch.clamp(u / (resample_shape[d] / down_d), 0.0, down_static[d] - 1.0)
        umats.append(linops.sample_matrix(up_coords, down_static[d], method="linear"))
        if build_dist_map:
            dist_axes.append(torch.minimum(up_coords - torch.floor(up_coords),
                                           torch.ceil(up_coords) - up_coords) * resolution[d])
    if noise is None:
        out = linops.apply_axis_ops(x, [um @ dm for um, dm in zip(umats, dmats)])
    else:
        std, normal_draw, take = (None if a is None else torch.as_tensor(a, device=dev)
                                  for a in noise)
        down = linops.apply_axis_ops(x, dmats)
        noisy = down + std * normal_draw
        down = noisy if take is None else torch.where(take, noisy, down)
        out = linops.apply_axis_ops(down, umats)
    if not build_dist_map:
        return out
    dist = torch.sqrt(dist_axes[0][:, None, None] ** 2 + dist_axes[1][None, :, None] ** 2
                      + dist_axes[2][None, None, :] ** 2)
    return out, dist[..., None].expand(*dist.shape, x.shape[-1]).contiguous()


# ---------------------------------------------------------------------------
# resample_tensor (+ reliability map) (reference edit_tensors.py:257-338)
# ---------------------------------------------------------------------------

def resample_tensor(x, resample_shape, interp_method="linear", subsample_res=None,
                    volume_res=None, build_reliability_map=False):
    """Optional nearest downsample to ``subsample_res``, then resize to
    ``resample_shape``; closed-form separable reliability map (1 = acquired
    slice, 0 = interpolated)."""
    spatial = list(x.shape[:3])
    downsample_shape = list(spatial)
    out = x
    if subsample_res is not None:
        if volume_res is None:
            raise ValueError("volume_res required with subsample_res")
        sub = list(np.asarray(subsample_res, np.float64))
        vol = list(np.asarray(volume_res, np.float64))
        if sub != vol:
            downsample_shape = [int(spatial[d] * vol[d] / sub[d]) for d in range(3)]
            out = interp.resize(out, downsample_shape, method="nearest")
    if list(resample_shape) != downsample_shape:
        out = interp.resize(out, list(resample_shape), method=interp_method)
    if not build_reliability_map:
        return out
    if downsample_shape != spatial:
        rel = cached(("reliability_map", tuple(resample_shape), tuple(downsample_shape), x.device),
                     lambda: _reliability_map(resample_shape, downsample_shape, x.device))
        mask = rel[..., None].expand(*rel.shape, x.shape[-1]).contiguous()
    else:
        mask = torch.ones_like(out)
    return out, mask


def _reliability_map(resample_shape, downsample_shape, device=None):
    """(X, Y, Z) float32 of :func:`resample_tensor`: the separable weights of
    the acquired slices, 1 on a slice and falling linearly between them."""
    factors = np.array(resample_shape, np.float64) / np.array(downsample_shape)
    rel_maps = []
    for d in range(3):
        loc_float = np.arange(0, resample_shape[d], factors[d])
        loc_floor = np.int32(np.floor(loc_float))
        loc_ceil = np.int32(np.clip(loc_floor + 1, 0, resample_shape[d] - 1))
        tmp = np.zeros(resample_shape[d], np.float32)
        tmp[loc_floor] = 1 - (loc_float - loc_floor)
        tmp[loc_ceil] = tmp[loc_ceil] + (loc_float - loc_floor)
        rel_maps.append(tmp)
    rel = rel_maps[0][:, None, None] * rel_maps[1][None, :, None] * rel_maps[2][None, None, :]
    return torch.tensor(rel, dtype=torch.float32, device=device)


# ---------------------------------------------------------------------------
# BiasFieldCorruption (reference lab2im/layers.py:1002-1097)
# ---------------------------------------------------------------------------

def sample_bias_field(gen, spatial, n_channels=1, bias_field_std=0.3, bias_scale=0.025,
                      prob=0.95):
    """(small field N(0, U(0, std)) of shape (*ceil(spatial·scale), n_channels),
    coin with probability ``prob``), or None when the std is 0."""
    if bias_field_std <= 0:
        return None
    std = uniform(gen, (1, 1, 1, n_channels), 0.0, bias_field_std)
    field = normal(gen, (*small_shape_for(spatial, bias_scale), n_channels)) * std
    return field, bernoulli(gen, prob)


def bias_field_corruption(x, field=None, apply=None):
    """Multiply by exp(linear resize of the small ``field``) where ``apply``."""
    if field is None:
        return x
    out = torch.exp(interp.resize(field, x.shape[:3], method="linear")) * x
    return out if apply is None else torch.where(apply, out, x)


# ---------------------------------------------------------------------------
# IntensityAugmentation (reference lab2im/layers.py:1100-1261)
# ---------------------------------------------------------------------------

def sample_intensity_augmentation(gen, shape, noise_std=0, gamma_std=0,
                                  contrast_inversion=False, separate_channels=True,
                                  prob_noise=0.95, prob_gamma=1):
    """The draws of :func:`intensity_augmentation` for a (X, Y, Z, C) tensor."""
    nc = shape[-1]
    sample_shape = (1, 1, 1, nc) if separate_channels else (1, 1, 1, 1)
    draws = {}
    if noise_std > 0:
        std = uniform(gen, sample_shape, 0.0, noise_std)
        noise = normal(gen, tuple(shape) if separate_channels else (*shape[:3], 1)) * std
        draws["noise"] = noise.expand(*shape)
        if prob_noise != 1:
            draws["noise_on"] = bernoulli(gen, prob_noise)
    if gamma_std > 0:
        draws["gamma"] = normal(gen, sample_shape) * gamma_std
        if prob_gamma != 1:
            draws["gamma_on"] = bernoulli(gen, prob_gamma)
    if contrast_inversion:
        draws["invert"] = uniform(gen, sample_shape) < 0.5
    return draws


def intensity_augmentation(x, draws=None, clip=0, normalise=True, norm_perc=0,
                           separate_channels=True):
    """Noise -> clip -> (robust) min-max normalise -> gamma -> inversion."""
    draws = {} if draws is None else draws
    nc = x.shape[-1]
    if "noise" in draws:
        noisy = x + draws["noise"]
        x = torch.where(draws["noise_on"], noisy, x) if "noise_on" in draws else noisy
    if clip:
        cv = clip if isinstance(clip, (list, tuple)) else [0, clip]
        x = torch.clamp(x, cv[0], cv[1])
    if normalise:
        flat = x.reshape(-1, nc) if separate_channels else x.reshape(-1, 1)
        if norm_perc:
            perc = norm_perc if isinstance(norm_perc, (list, tuple)) \
                else [norm_perc, 1 - norm_perc]
            n = flat.shape[0]
            srt = torch.sort(flat, dim=0).values
            m, big = srt[max(int(perc[0] * n), 0)], srt[min(int(perc[1] * n), n - 1)]
        else:
            m, big = flat.amin(0), flat.amax(0)
        m, big = m.reshape(1, 1, 1, -1), big.reshape(1, 1, 1, -1)
        x = (torch.minimum(torch.maximum(x, m), big) - m) / (big - m + 1e-7)  # K.epsilon()
    if "gamma" in draws:
        powed = torch.pow(torch.clamp(x, min=0.0), torch.exp(draws["gamma"]))
        x = torch.where(draws["gamma_on"], powed, x) if "gamma_on" in draws else powed
    if "invert" in draws:
        x = torch.where(draws["invert"], 1.0 - x, x)
    return x
