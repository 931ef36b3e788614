"""The SynthSR generative model, label map -> (input channels, regression
target): the port of ``synthsr_tpu/synth/labels_to_image.py`` (reference
``SynthSR/labels_to_image_model.py:32-266``), one example on the device.

:func:`build_generator` returns a :class:`Generator`: ``sample(gen)`` draws
every random value of one example from a ``torch.Generator`` into a dict,
``apply(draws, labels, means, stds[, real_image])`` runs the pipeline on given
draws (so the tests replay the JAX package's draws through it), and calling it
does both.  Tensors are channels-last (X, Y, Z, C), as in the JAX package.

On a CUDA device a call replays ``apply`` as a CUDA graph.  ``apply`` draws
nothing and its shapes follow from the shapes of its inputs, so for one
signature of inputs (:meth:`Generator.graph_key`) it is a fixed chain of
small kernels, about 2,400 at tutorial 7's shapes.  The first call of a signature runs
``apply`` once on a side stream, to create what it creates lazily (the
host constants of ``device_constants``, cuBLAS's workspace), then captures
it into static input and output buffers; each later call copies its draws
and inputs into those buffers, replays, and returns copies of the outputs.
The ``MAX_GRAPHS`` most recently used signatures keep their graphs.  While
the tracer of ``utils/profiling`` is on, the counters ``generator.captures``,
``generator.replays`` and ``generator.eager`` (a call that ran ``apply``
directly: on the CPU, or with inputs that need autograd) count the calls.

The registration-error warps are joint trilinear gathers: the JAX package's
``exact_warp=True`` semantics.  Its default gather-free shear warp
(``ops/shear_warp.py``) is a TPU deviation and is not ported.
"""

from __future__ import annotations

import collections
import dataclasses
from typing import Any, List, Optional, Sequence

import numpy as np
import torch

from ..io.volume import get_ras_axes
from ..ops import interp
from ..ops.blur import blurring_sigma_for_downsampling, blurring_sigma_np
from ..utils.misc import (find_closest_number_divisible_by_m, reformat_to_list,
                          reformat_to_n_channels_array)
from ..utils.profiling import count
from . import augment, device_constants
from .device_constants import constant
from .sampling import normal


def get_shapes(labels_shape, output_shape, atlas_res, target_res, padding_margin,
               output_div_by_n):
    """(cropping_shape, output_shape, padding_margin): the shape algebra of the
    reference's get_shapes (labels_to_image_model.py:269-335), as the JAX
    package has it (labels_to_image.py:35-97)."""
    atlas_res = reformat_to_list(atlas_res)
    n_dims = len(atlas_res)
    target_res = reformat_to_list(target_res)
    if padding_margin is not None:
        padding_margin = reformat_to_list(padding_margin, length=n_dims, dtype="int")
        labels_shape = [labels_shape[i] + 2 * padding_margin[i] for i in range(n_dims)]
    resample_factor = None if atlas_res == target_res else \
        [atlas_res[i] / float(target_res[i]) for i in range(n_dims)]
    if output_shape is not None:
        output_shape = reformat_to_list(output_shape, length=n_dims, dtype="int")
        if resample_factor is not None:
            output_shape = [min(int(labels_shape[i] * resample_factor[i]), output_shape[i])
                            for i in range(n_dims)]
        else:
            output_shape = [min(labels_shape[i], output_shape[i]) for i in range(n_dims)]
        if output_div_by_n is not None:
            tmp = [find_closest_number_divisible_by_m(s, output_div_by_n) for s in output_shape]
            if output_shape != tmp:
                print(f"output shape {output_shape} not divisible by {output_div_by_n}, "
                      f"changed to {tmp}")
                output_shape = tmp
            if any(s == 0 for s in output_shape):
                raise ValueError(
                    f"output_shape rounds down to {output_shape}: each dim must be at least "
                    f"output_div_by_n={output_div_by_n} (2^(n_levels-1) of the U-Net)")
        cropping_shape = output_shape if resample_factor is None else \
            [int(np.around(output_shape[i] / resample_factor[i], 0)) for i in range(n_dims)]
    elif output_div_by_n is not None:
        if resample_factor is not None:
            output_shape = [find_closest_number_divisible_by_m(
                int(labels_shape[i] * resample_factor[i]), output_div_by_n) for i in range(n_dims)]
            cropping_shape = [int(np.around(output_shape[i] / resample_factor[i], 0))
                              for i in range(n_dims)]
        else:
            cropping_shape = [find_closest_number_divisible_by_m(s, output_div_by_n)
                              for s in labels_shape]
            output_shape = cropping_shape
    else:
        cropping_shape = list(labels_shape)
        output_shape = cropping_shape if resample_factor is None else \
            [int(cropping_shape[i] * resample_factor[i]) for i in range(n_dims)]
    return cropping_shape, output_shape, padding_margin


@dataclasses.dataclass
class GenerationConfig:
    """The parameter surface of labels_to_image_model.py:32-58."""
    labels_shape: Sequence[int]
    input_channels: Sequence[bool]
    output_channel: Optional[Sequence[int]]
    generation_labels: np.ndarray
    n_neutral_labels: int
    atlas_res: Any
    target_res: Any = None
    output_shape: Optional[Sequence[int]] = None
    output_div_by_n: Optional[int] = None
    padding_margin: Any = None
    flipping: bool = True
    aff: Optional[np.ndarray] = None
    scaling_bounds: Any = 0.15
    rotation_bounds: Any = 15
    shearing_bounds: Any = 0.012
    translation_bounds: Any = False
    nonlin_std: float = 3.0
    nonlin_shape_factor: float = 0.0625
    simulate_registration_error: Any = True
    randomise_res: Any = False
    max_res_iso: float = 9.0
    data_res: Any = None
    thickness: Any = None
    downsample: Any = False
    build_reliability_maps: bool = False
    blur_range: float = 1.15
    bias_field_std: float = 0.3
    bias_shape_factor: float = 0.025

    # --- resolved by resolve() ---
    n_channels: int = dataclasses.field(default=0, init=False)
    use_real_image: bool = dataclasses.field(default=False, init=False)
    idx_first_input_channel: int = dataclasses.field(default=0, init=False)
    padded_shape: List[int] = dataclasses.field(default_factory=list, init=False)
    crop_shape: List[int] = dataclasses.field(default_factory=list, init=False)
    out_shape: List[int] = dataclasses.field(default_factory=list, init=False)
    pad_margin: Any = dataclasses.field(default=None, init=False)
    atlas_res3: np.ndarray = dataclasses.field(default=None, init=False)
    target_res3: np.ndarray = dataclasses.field(default=None, init=False)
    data_res_rc: np.ndarray = dataclasses.field(default=None, init=False)
    thickness_rc: np.ndarray = dataclasses.field(default=None, init=False)
    downsample_rc: List[bool] = dataclasses.field(default_factory=list, init=False)
    randomise_rc: List[bool] = dataclasses.field(default_factory=list, init=False)
    simulate_reg_rc: List[bool] = dataclasses.field(default_factory=list, init=False)
    flip_axis: int = dataclasses.field(default=0, init=False)
    swap_lut: Any = dataclasses.field(default=None, init=False)

    def resolve(self) -> "GenerationConfig":
        """Derive the static quantities (reference :70-103)."""
        n_channels = len(self.input_channels)
        self.n_channels = n_channels
        self.use_real_image = self.output_channel is None
        self.idx_first_input_channel = int(np.argmax(self.input_channels))
        self.simulate_reg_rc = reformat_to_list(self.simulate_registration_error,
                                                length=n_channels)
        labels_shape = reformat_to_list(self.labels_shape)
        n_dims = len(labels_shape)
        atlas = reformat_to_n_channels_array(self.atlas_res, n_dims, n_channels)
        data_res, thickness = self.data_res, self.thickness
        if self.output_channel is not None and data_res is not None:
            for idx in reformat_to_list(self.output_channel):
                if not self.input_channels[idx]:
                    data_res = np.insert(np.asarray(data_res, float), idx, 1, axis=0)
                    if thickness is not None:
                        thickness = np.insert(np.asarray(thickness, float), idx, 1, axis=0)
        data_res = atlas if data_res is None \
            else reformat_to_n_channels_array(data_res, n_dims, n_channels)
        thickness = data_res if thickness is None \
            else reformat_to_n_channels_array(thickness, n_dims, n_channels)
        if self.downsample:
            downsample = reformat_to_list(self.downsample, n_channels)
        else:
            downsample = list(np.min(np.asarray(thickness) - np.asarray(data_res), 1) < 0)
        self.data_res_rc = np.asarray(data_res, np.float32)
        self.thickness_rc = np.asarray(thickness, np.float32)
        self.downsample_rc = [bool(d) for d in downsample]
        self.atlas_res3 = np.asarray(atlas[0], np.float32)
        self.target_res3 = self.atlas_res3 if self.target_res is None else \
            np.asarray(reformat_to_n_channels_array(self.target_res, n_dims)[0], np.float32)
        self.randomise_rc = [self.randomise_res] * n_channels \
            if isinstance(self.randomise_res, bool) else list(self.randomise_res)
        crop, out, pad = get_shapes(labels_shape, self.output_shape, list(self.atlas_res3),
                                    list(self.target_res3), self.padding_margin,
                                    self.output_div_by_n)
        self.crop_shape, self.out_shape, self.pad_margin = crop, out, pad
        self.padded_shape = labels_shape if pad is None else \
            [s + 2 * m for s, m in zip(labels_shape, reformat_to_list(pad, length=3))]
        if self.flipping:
            if self.aff is None:
                raise ValueError("aff must be provided when flipping is on")
            self.flip_axis = int(get_ras_axes(self.aff, n_dims)[0])
            self.swap_lut = augment.build_swap_lut(self.generation_labels, self.n_neutral_labels)
        return self


def pad_around_centre(x, margin):
    """Symmetric zero padding of (X, Y, Z, C) (reference PadAroundCentre,
    lab2im/layers.py:1692)."""
    m = reformat_to_list(margin, length=3, dtype="int")
    return torch.nn.functional.pad(x, (0, 0, m[2], m[2], m[1], m[1], m[0], m[0]))


class Generator:
    """One example of the generative model; see the module docstring."""

    def __init__(self, cfg: GenerationConfig, return_labels: bool = False):
        self.cfg = cfg.resolve()
        self.return_labels = return_labels
        self._graphs: "collections.OrderedDict[tuple, _Replay]" = collections.OrderedDict()

    def _sim_err(self, i):
        cfg = self.cfg
        return cfg.input_channels[i] and cfg.simulate_reg_rc[i] \
            and i != cfg.idx_first_input_channel

    def sample(self, gen: torch.Generator) -> dict:
        """Every random value of one example, drawn on ``gen``'s device."""
        cfg = self.cfg
        crop = list(cfg.crop_shape)
        d = augment.sample_deformation(
            gen, cfg.padded_shape, crop, scaling_bounds=cfg.scaling_bounds,
            rotation_bounds=cfg.rotation_bounds, shearing_bounds=cfg.shearing_bounds,
            translation_bounds=cfg.translation_bounds, nonlin_std=cfg.nonlin_std,
            nonlin_scale=cfg.nonlin_shape_factor)
        if cfg.flipping:
            d["flip"] = augment.sample_flip(gen, 1)
        d["gmm_noise"] = normal(gen, (*crop, cfg.n_channels))
        max_res = np.array([cfg.max_res_iso] * 3, np.float32)
        for i in range(cfg.n_channels):
            if cfg.input_channels[i]:
                d[f"bias_{i}"] = augment.sample_bias_field(
                    gen, crop, 1, cfg.bias_field_std, cfg.bias_shape_factor)
            d[f"intensity_{i}"] = augment.sample_intensity_augmentation(
                gen, (*crop, 1), gamma_std=0.5)
            if not cfg.input_channels[i]:
                continue
            if self._sim_err(i):
                d[f"t_fwd_{i}"] = augment.sample_affine_matrix(gen, rotation_bounds=5,
                                                               translation_bounds=5)
                d[f"t_err_{i}"] = augment.sample_affine_matrix(gen, rotation_bounds=0.5,
                                                               translation_bounds=0.5)
            if cfg.randomise_rc[i]:
                d[f"res_{i}"], d[f"thick_{i}"] = augment.sample_resolution(
                    gen, list(cfg.atlas_res3), max_res_iso=max_res, max_res_aniso=max_res)
            if cfg.blur_range is not None and cfg.blur_range != 1:
                d[f"blur_{i}"] = augment.sample_blur_factors(gen, cfg.blur_range)
        return d

    def apply(self, draws, labels, means, stds, real_image=None):
        """(image (X, Y, Z, n_inputs [x2 with reliability maps]), target) float32
        [, deformed labels] for one example, from the given draws."""
        cfg = self.cfg
        if labels.dim() == 3:
            labels = labels[..., None]
        vols, methods, swap_flags = [labels.to(torch.int32)], ["nearest"], [True]
        if cfg.use_real_image:
            if real_image is None:
                raise ValueError("real_image required when output_channel is None")
            if real_image.dim() == 3:
                real_image = real_image[..., None]
            vols.append(real_image.to(torch.float32))
            methods.append("linear")
            swap_flags.append(False)
        if cfg.pad_margin is not None:
            vols = [pad_around_centre(v, cfg.pad_margin) for v in vols]
        vols = augment.spatial_deformation(vols, methods, list(cfg.crop_shape),
                                           draws.get("crop_idx"), draws.get("affine"),
                                           draws.get("svf"))
        if cfg.flipping:
            vols = augment.random_flip(vols, draws["flip"], [cfg.flip_axis], swap_flags,
                                       cfg.swap_lut)
        labels = vols[0]
        real = vols[1] if cfg.use_real_image else None
        image = augment.sample_conditional_gmm(labels, means, stds, cfg.generation_labels,
                                               draws["gmm_noise"])
        resampled = list(cfg.crop_shape) != list(cfg.out_shape)
        channels, targets = [], []
        for i in range(cfg.n_channels):
            channel = image[..., i:i + 1]
            if cfg.input_channels[i]:
                channel = augment.bias_field_corruption(channel, *(draws[f"bias_{i}"] or (None,)))
            channel = augment.intensity_augmentation(channel, draws[f"intensity_{i}"],
                                                     clip=300, normalise=True)
            channel = augment.gaussian_blur(channel, [0.5] * 3)
            # the regression target; as in the reference, `channel` is REASSIGNED
            # to the resampled tensor when crop_shape != out_shape (:189-196)
            if not cfg.use_real_image and i in list(cfg.output_channel):
                if resampled:
                    sigma = blurring_sigma_np(cfg.atlas_res3, cfg.target_res3)
                    channel = augment.resample_tensor(
                        augment.gaussian_blur(channel, list(sigma)), cfg.out_shape)
                targets.append(channel)
            if not cfg.input_channels[i]:
                continue
            sim_err = self._sim_err(i)
            if sim_err:  # registration error, forward part (:201-209)
                t_fwd = draws[f"t_fwd_{i}"]
                channel = interp.transform(channel, interp.affine_to_shift(t_fwd, channel.shape[:3]))
            factors = draws.get(f"blur_{i}")
            if cfg.randomise_rc[i]:  # acquisition simulation (:214-228)
                resolution, blur_res = draws[f"res_{i}"], draws[f"thick_{i}"]
                max_res = np.array([cfg.max_res_iso] * 3, np.float32)
                sigma = blurring_sigma_for_downsampling(
                    constant(cfg.atlas_res3, torch.float32, channel.device), resolution,
                    mult_coef=0.42, thickness=blur_res)
                channel = augment.gaussian_blur(channel, sigma, factors, cfg.blur_range,
                                                max_sigma=0.75 * max_res / cfg.atlas_res3)
                channel, rel_map = augment.mimic_acquisition(
                    channel, resolution, cfg.atlas_res3, cfg.out_shape, build_dist_map=True,
                    min_subsample_res=cfg.atlas_res3)
            else:
                sigma = blurring_sigma_np(cfg.atlas_res3, cfg.data_res_rc[i], 0.42,
                                          cfg.thickness_rc[i])
                channel = augment.gaussian_blur(channel, list(sigma), factors, cfg.blur_range)
                if cfg.downsample_rc[i]:
                    channel, rel_map = augment.resample_tensor(
                        channel, cfg.out_shape, "linear", list(cfg.data_res_rc[i]),
                        list(cfg.atlas_res3), build_reliability_map=True)
                else:
                    channel, rel_map = augment.resample_tensor(channel, cfg.out_shape,
                                                               build_reliability_map=True)
            if sim_err:  # inverse with error (:231-238)
                t_inv = draws[f"t_err_{i}"] @ augment.invert_affine(draws[f"t_fwd_{i}"])
                shift = interp.affine_to_shift(t_inv, channel.shape[:3])
                channel = interp.transform(channel, shift)
                rel_map = interp.transform(rel_map, shift)
            channels.append(channel)
            if cfg.build_reliability_maps:
                channels.append(rel_map)
        image_out = torch.cat(channels, -1)
        if cfg.use_real_image:  # target (:245-258)
            target = augment.intensity_augmentation(real, normalise=True)
            if resampled:
                sigma = blurring_sigma_np(cfg.atlas_res3, cfg.target_res3)
                target = augment.resample_tensor(augment.gaussian_blur(target, list(sigma)),
                                                 cfg.out_shape)
        else:
            target = torch.cat(targets, -1)
        out = (image_out.to(torch.float32), target.to(torch.float32))
        return out + (labels,) if self.return_labels else out

    def graph_key(self, draws, labels, means, stds, real_image=None) -> tuple:
        """What a captured ``apply`` depends on beyond its inputs' values: the
        devices, shapes and dtypes of ``labels``, ``means``, ``stds`` and
        ``real_image``, the draws' keys, shapes, dtypes and Nones,
        ``return_labels``, and an ``apply`` set on the instance."""
        return (_signature((draws, labels, means, stds, real_image)), self.return_labels,
                self.__dict__.get("apply"))

    def __call__(self, gen, labels, means, stds, real_image=None):
        args = (self.sample(gen), labels, means, stds, real_image)
        if labels.device.type != "cuda" or (torch.is_grad_enabled() and any(
                t.requires_grad for t in _leaves(args))):
            count("generator.eager")
            return self.apply(*args)
        key = self.graph_key(*args)
        replay = self._graphs.get(key)
        if replay is None:
            replay = _Replay(self.apply, args)
            self._graphs[key] = replay
            while len(self._graphs) > MAX_GRAPHS:
                self._graphs.popitem(last=False)
            count("generator.captures")
        else:
            self._graphs.move_to_end(key)
            replay.load(args)
            count("generator.replays")
        return replay.run()


MAX_GRAPHS = 4


def _signature(tree):
    if isinstance(tree, torch.Tensor):
        return (tuple(tree.shape), tree.dtype, tree.device)
    if isinstance(tree, dict):
        return ("dict",) + tuple((k, _signature(tree[k])) for k in sorted(tree))
    if isinstance(tree, (tuple, list)):
        return (type(tree).__name__,) + tuple(_signature(v) for v in tree)
    return tree


def _leaves(tree) -> list:
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in _leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [t for v in tree for t in _leaves(v)]
    return []


def _cloned(tree):
    if isinstance(tree, torch.Tensor):
        return tree.clone()
    if isinstance(tree, dict):
        return {k: _cloned(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_cloned(v) for v in tree)
    return tree


class _Replay:
    """``apply`` captured as a CUDA graph on copies of one call's arguments:
    the graph, its static inputs and outputs, and the device constants it
    reads."""

    def __init__(self, apply, args):
        dev = args[1].device
        static = _cloned(args)
        self.inputs = _leaves(static)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.device(dev), torch.no_grad(), device_constants.held() as self.constants:
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                apply(*static)
            with torch.cuda.graph(self.graph, stream=side, capture_error_mode="thread_local"):
                self.outputs = apply(*static)
            torch.cuda.current_stream().wait_stream(side)

    def load(self, args):
        for s, t in zip(self.inputs, _leaves(args)):
            s.copy_(t)

    def run(self) -> tuple:
        self.graph.replay()
        return tuple(o.clone() for o in self.outputs)


def build_generator(cfg: GenerationConfig, return_labels: bool = False) -> Generator:
    """The generator of one example: ``gen, labels, means, stds[, real_image]
    -> (image, target)``; labels (X, Y, Z[, 1]) int, means/stds
    (n_labels, n_channels), all on one device."""
    return Generator(cfg, return_labels)
