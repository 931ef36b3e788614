"""BrainGenerator, the host-side facade of the generator: the port of
``synthsr_tpu/synth/brain_generator.py`` (reference
``SynthSR/brain_generator.py:28-146`` and ``generate_brain()`` :317-330).

Label maps (and GMM parameters) stream from the numpy host pipeline
(``synth/model_inputs.py``); each example runs through
:class:`~.labels_to_image.Generator` on ``device`` (the GPU unless the
caller passes "cpu"; without a GPU the constructor raises) with a seeded
``torch.Generator``; ``generate_brain`` returns numpy (image, target)
re-aligned to the first label map's orientation.
"""

from __future__ import annotations

import numpy as np
import torch

from ..io.labels import get_list_labels
from ..io.volume import align_volume_to_ref, get_volume_info
from ..utils.misc import list_images_in_folder, load_array_if_path, reformat_to_list
from .labels_to_image import GenerationConfig, build_generator
from .model_inputs import build_model_inputs


class BrainGenerator:

    def __init__(self, labels_dir, prior_means, prior_stds, prior_distributions="normal",
                 generation_labels=None, images_dir=None, n_neutral_labels=None,
                 padding_margin=None, batchsize=1, input_channels=1, output_channel=0,
                 target_res=None, output_shape=None, output_div_by_n=None,
                 generation_classes=None, flipping=True, scaling_bounds=0.15,
                 rotation_bounds=15, shearing_bounds=0.012, translation_bounds=5,
                 nonlin_std=3.0, nonlin_shape_factor=0.0625, simulate_registration_error=True,
                 randomise_res=False, data_res=None, thickness=None, downsample=False,
                 blur_range=1.15, build_reliability_maps=False, bias_field_std=0.3,
                 bias_shape_factor=0.025, seed=None, device=None):
        self.device = torch.device("cuda" if device is None else device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("no CUDA device available; pass device='cpu' to run on the CPU")
        self.labels_paths = list_images_in_folder(labels_dir)
        self.images_paths = None
        if images_dir is not None:
            self.images_paths = list_images_in_folder(images_dir)
            if len(self.labels_paths) != len(self.images_paths):
                raise ValueError("different number of images and segmentations")
        (self.labels_shape, self.aff, self.n_dims, _, self.header,
         self.atlas_res) = get_volume_info(self.labels_paths[0], aff_ref=np.eye(4))
        if generation_labels is not None:
            self.generation_labels = load_array_if_path(generation_labels)
        else:
            self.generation_labels, _ = get_list_labels(labels_dir=labels_dir)
        self.n_neutral_labels = self.generation_labels.shape[0] if n_neutral_labels is None \
            else n_neutral_labels
        self.input_channels = [bool(c) for c in reformat_to_list(input_channels)]
        self.output_channel = None if output_channel is None else reformat_to_list(output_channel)
        self.n_channels = len(self.input_channels)
        self.batchsize = batchsize
        self.prior_distributions = prior_distributions
        if generation_classes is not None:
            self.generation_classes = load_array_if_path(generation_classes)
            if self.generation_classes.shape != self.generation_labels.shape:
                raise ValueError("generation_classes should have the same shape as "
                                 "generation_labels")
            uniq = np.unique(self.generation_classes)
            if not np.array_equal(uniq, np.arange(np.max(uniq) + 1)):
                raise ValueError("generation_classes should be a linear range from 0 to its max")
        else:
            self.generation_classes = np.arange(self.generation_labels.shape[0])
        self.prior_means = load_array_if_path(prior_means)
        self.prior_stds = load_array_if_path(prior_stds)
        data_res = load_array_if_path(data_res)
        if isinstance(randomise_res, bool) and randomise_res and data_res is not None:
            raise ValueError("randomise_res and data_res cannot be provided at the same time")

        self.cfg = GenerationConfig(
            labels_shape=self.labels_shape, input_channels=self.input_channels,
            output_channel=self.output_channel, generation_labels=self.generation_labels,
            n_neutral_labels=self.n_neutral_labels, atlas_res=self.atlas_res,
            target_res=load_array_if_path(target_res),
            output_shape=load_array_if_path(output_shape), output_div_by_n=output_div_by_n,
            padding_margin=load_array_if_path(padding_margin), flipping=flipping,
            aff=np.eye(4), scaling_bounds=load_array_if_path(scaling_bounds),
            rotation_bounds=load_array_if_path(rotation_bounds),
            shearing_bounds=load_array_if_path(shearing_bounds),
            translation_bounds=load_array_if_path(translation_bounds), nonlin_std=nonlin_std,
            nonlin_shape_factor=nonlin_shape_factor,
            simulate_registration_error=simulate_registration_error,
            randomise_res=randomise_res, data_res=data_res,
            thickness=load_array_if_path(thickness), downsample=downsample,
            build_reliability_maps=build_reliability_maps, blur_range=blur_range,
            bias_field_std=bias_field_std, bias_shape_factor=bias_shape_factor)

        self._rng = np.random.default_rng(seed)
        self.torch_gen = torch.Generator(device=self.device)
        self.torch_gen.manual_seed(int(self._rng.integers(2 ** 31)) if seed is not None
                                   else int(np.random.randint(2 ** 31)))
        self._generate = build_generator(self.cfg)
        self.model_inputs_generator = build_model_inputs(
            path_label_maps=self.labels_paths, n_labels=len(self.generation_labels),
            prior_means=self.prior_means, prior_stds=self.prior_stds,
            prior_distributions=self.prior_distributions, path_images=self.images_paths,
            batchsize=self.batchsize, n_channels=self.n_channels,
            generation_classes=self.generation_classes,
            rng=self._rng if seed is not None else None)
        self.model_output_shape = list(self.cfg.out_shape)

    def generate_brain(self):
        """One batch as numpy (image, target), in native orientation."""
        inputs = [torch.as_tensor(np.asarray(a), device=self.device)
                  for a in next(self.model_inputs_generator)]
        images, targets = [], []
        for i in range(self.batchsize):
            image, target = self._generate(self.torch_gen, *[a[i] for a in inputs])
            images.append(align_volume_to_ref(image.cpu().numpy(), np.eye(4), aff_ref=self.aff,
                                              n_dims=self.n_dims))
            targets.append(align_volume_to_ref(target.cpu().numpy(), np.eye(4),
                                               aff_ref=self.aff, n_dims=self.n_dims))
        return np.squeeze(np.stack(images)), np.squeeze(np.stack(targets))
