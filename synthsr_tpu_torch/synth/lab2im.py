"""The simpler lab2im generative model and the ``ImageGenerator`` facade: the
port of ``synthsr_tpu/synth/lab2im.py`` (reference
``ext/lab2im/lab2im_model.py:28-174``, the segmentation-oriented generator:
deform -> crop -> GMM -> bias -> intensity -> blur -> resample, labels
remapped to output values; and ``ext/lab2im/image_generator.py:27-266``).

Built on the port's augment samplers and appliers (``synth/augment.py``):
:class:`Lab2ImGenerator` draws every random value of one example in
``sample`` from a ``torch.Generator`` and applies them in ``apply``, so the
tests can feed it JAX's draws.  The deformation runs on the whole label map
and the crop follows, as in JAX.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from ..io.labels import get_list_labels
from ..io.volume import align_volume_to_ref, get_volume_info
from ..ops.blur import blurring_sigma_np
from ..utils.misc import (find_closest_number_divisible_by_m, list_images_in_folder,
                          load_array_if_path, reformat_to_list, reformat_to_n_channels_array)
from . import augment, label_ops
from .model_inputs import build_model_inputs
from .sampling import normal

# the fixed augmentation of lab2im_model.py (synthsr_tpu/synth/lab2im.py:95-110)
DEFORMATION = dict(scaling_bounds=0.15, rotation_bounds=10, shearing_bounds=0.02,
                   translation_bounds=False, nonlin_std=4.0, nonlin_scale=0.0625)
BIAS_FIELD_STD, BIAS_SCALE = 0.3, 0.025
CLIP, GAMMA_STD = 300, 0.2


def get_shapes(labels_shape, output_shape, atlas_res, target_res, output_div_by_n):
    """lab2im shape algebra (lab2im_model.py:126-174): (cropping shape, output
    shape)."""
    n_dims = len(atlas_res)
    if list(atlas_res) != list(target_res):
        factor = [atlas_res[i] / float(target_res[i]) for i in range(n_dims)]
    else:
        factor = None
    if output_shape is not None:
        output_shape = reformat_to_list(output_shape, length=n_dims, dtype="int")
        if factor is not None:
            output_shape = [min(int(labels_shape[i] * factor[i]), output_shape[i])
                            for i in range(n_dims)]
        else:
            output_shape = [min(labels_shape[i], output_shape[i]) for i in range(n_dims)]
        if output_div_by_n is not None:
            output_shape = [find_closest_number_divisible_by_m(s, output_div_by_n)
                            for s in output_shape]
        if factor is not None:
            cropping_shape = [int(np.around(output_shape[i] / factor[i], 0))
                              for i in range(n_dims)]
        else:
            cropping_shape = output_shape
    else:
        cropping_shape = list(labels_shape)
        if factor is not None:
            output_shape = [int(np.around(cropping_shape[i] * factor[i], 0))
                            for i in range(n_dims)]
        else:
            output_shape = cropping_shape
        if output_div_by_n is not None:
            output_shape = [find_closest_number_divisible_by_m(s, output_div_by_n)
                            for s in output_shape]
            if factor is not None:
                cropping_shape = [int(np.around(output_shape[i] / factor[i], 0))
                                  for i in range(n_dims)]
            else:
                cropping_shape = output_shape
    return cropping_shape, output_shape


@dataclasses.dataclass
class Lab2ImConfig:
    labels_shape: Sequence[int]
    n_channels: int
    generation_labels: np.ndarray
    output_labels: np.ndarray
    atlas_res: np.ndarray
    target_res: np.ndarray
    crop_shape: Sequence[int]
    out_shape: Sequence[int]
    blur_range: float = 1.15


class Lab2ImGenerator:
    """One example: ``sample(gen)`` draws, ``apply(draws, labels, means,
    stds)`` -> (float32 image (*out_shape, n_channels), int labels
    (*out_shape, 1) in the output values); ``gen(gen, ...)`` does both."""

    def __init__(self, cfg: Lab2ImConfig):
        self.cfg = cfg
        self.sigma = blurring_sigma_np(cfg.atlas_res, cfg.target_res)

    def sample(self, gen: torch.Generator) -> dict:
        cfg = self.cfg
        spatial, crop = list(cfg.labels_shape), list(cfg.crop_shape)
        draws = {"deformation": augment.sample_deformation(gen, spatial, spatial,
                                                           **DEFORMATION)}
        if crop != spatial:
            draws["crop_idx"] = augment.sample_crop(gen, spatial, crop)
        draws["gmm_noise"] = normal(gen, (*crop, cfg.n_channels))
        draws["bias"] = augment.sample_bias_field(gen, crop, cfg.n_channels, BIAS_FIELD_STD,
                                                  BIAS_SCALE)
        draws["intensity"] = augment.sample_intensity_augmentation(
            gen, (*crop, cfg.n_channels), gamma_std=GAMMA_STD)
        draws["blur"] = augment.sample_blur_factors(gen, cfg.blur_range)
        return draws

    def apply(self, draws, labels, means, stds):
        cfg = self.cfg
        if labels.dim() == 3:
            labels = labels[..., None]
        labels = labels.to(torch.int32)
        d = draws["deformation"]
        (labels,) = augment.spatial_deformation([labels], ["nearest"], list(labels.shape[:3]),
                                                affine=d.get("affine"), svf=d.get("svf"))
        if "crop_idx" in draws:
            (labels,) = augment.random_crop([labels], draws["crop_idx"], cfg.crop_shape)
        image = augment.sample_conditional_gmm(labels, means, stds, cfg.generation_labels,
                                               draws["gmm_noise"])
        image = augment.bias_field_corruption(image, *draws["bias"])
        image = augment.intensity_augmentation(image, draws["intensity"], clip=CLIP,
                                               normalise=True)
        image = augment.gaussian_blur(image, list(self.sigma), draws["blur"], cfg.blur_range)
        if list(cfg.crop_shape) != list(cfg.out_shape):
            image = augment.resample_tensor(image, cfg.out_shape, "linear")
            labels = augment.resample_tensor(labels.to(torch.float32), cfg.out_shape,
                                             "nearest").to(torch.int32)
        labels = label_ops.convert_labels(labels, cfg.generation_labels, cfg.output_labels)
        return image.to(torch.float32), labels

    def __call__(self, gen, labels, means, stds):
        return self.apply(self.sample(gen), labels, means, stds)


def build_lab2im_generator(cfg: Lab2ImConfig) -> Lab2ImGenerator:
    """The per-example generator of ``cfg``."""
    return Lab2ImGenerator(cfg)


class ImageGenerator:
    """lab2im facade (reference image_generator.py:27-266): label maps and
    GMM parameters from the numpy host pipeline, each example through
    :class:`Lab2ImGenerator` on ``device`` (the GPU unless the caller passes
    "cpu") with a ``torch.Generator`` seeded from ``seed``."""

    def __init__(self, labels_dir, generation_labels=None, output_labels=None,
                 n_channels=1, target_res=None, output_shape=None,
                 output_div_by_n=None, generation_classes=None, prior_distributions="uniform",
                 prior_means=None, prior_stds=None,
                 use_specific_stats_for_channel=False, blur_range=1.15, seed=None,
                 device=None):
        self.device = torch.device("cuda" if device is None else device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("no CUDA device available; pass device='cpu' to run on the CPU")
        self.labels_paths = list_images_in_folder(labels_dir)
        (self.labels_shape, self.aff, self.n_dims, _, self.header,
         self.atlas_res) = get_volume_info(self.labels_paths[0], aff_ref=np.eye(4))

        if generation_labels is not None:
            self.generation_labels = load_array_if_path(generation_labels)
        else:
            self.generation_labels, _ = get_list_labels(labels_dir=labels_dir)
        if output_labels is not None:
            self.output_labels = load_array_if_path(output_labels)
        else:
            self.output_labels = self.generation_labels

        self.n_channels = n_channels
        atlas = reformat_to_n_channels_array(self.atlas_res, self.n_dims)[0]
        target = atlas if target_res is None else \
            reformat_to_n_channels_array(target_res, self.n_dims)[0]
        crop_shape, out_shape = get_shapes(list(self.labels_shape),
                                           load_array_if_path(output_shape),
                                           atlas, target, output_div_by_n)
        self.model_output_shape = out_shape

        if generation_classes is not None:
            self.generation_classes = load_array_if_path(generation_classes)
        else:
            self.generation_classes = np.arange(self.generation_labels.shape[0])

        prior_means = load_array_if_path(prior_means)
        prior_stds = load_array_if_path(prior_stds)
        if use_specific_stats_for_channel:
            for arr, name in ((prior_means, "prior_means"), (prior_stds, "prior_stds")):
                if isinstance(arr, np.ndarray) and arr.shape[0] / 2 != n_channels:
                    raise ValueError(
                        f"{name} must have 2*n_channels rows when "
                        "use_specific_stats_for_channel is True")
        self._specific_stats = use_specific_stats_for_channel

        self.cfg = Lab2ImConfig(
            labels_shape=list(self.labels_shape), n_channels=n_channels,
            generation_labels=self.generation_labels, output_labels=self.output_labels,
            atlas_res=np.asarray(atlas, np.float32),
            target_res=np.asarray(target, np.float32),
            crop_shape=crop_shape, out_shape=out_shape, blur_range=blur_range)
        self._generate = build_lab2im_generator(self.cfg)
        self._rng = np.random.default_rng(seed)
        self.torch_gen = torch.Generator(device=self.device)
        self.torch_gen.manual_seed(int(self._rng.integers(2 ** 31)))
        self.model_inputs_generator = build_model_inputs(
            path_label_maps=self.labels_paths,
            n_labels=len(self.generation_labels),
            prior_means=prior_means, prior_stds=prior_stds,
            prior_distributions=prior_distributions, batchsize=1,
            n_channels=n_channels, generation_classes=self.generation_classes,
            rng=self._rng if seed is not None else None,
            use_specific_stats_for_channel=use_specific_stats_for_channel)

    def generate_image(self):
        """One (image, labels) pair in native orientation, as numpy
        (reference image_generator.py:232-266)."""
        inputs = [torch.as_tensor(np.asarray(a), device=self.device)
                  for a in next(self.model_inputs_generator)]
        ims, labs = [], []
        for i in range(inputs[0].shape[0]):
            image, labels = self._generate(self.torch_gen, *[a[i] for a in inputs])
            ims.append(align_volume_to_ref(image.cpu().numpy(), np.eye(4), aff_ref=self.aff,
                                           n_dims=self.n_dims))
            labs.append(align_volume_to_ref(labels.cpu().numpy(), np.eye(4), aff_ref=self.aff,
                                            n_dims=self.n_dims))
        return np.squeeze(np.stack(ims, 0)), np.squeeze(np.stack(labs, 0))
