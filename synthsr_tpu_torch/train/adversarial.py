"""WGAN-GP adversarial fine-tuning of the SR generator on PyTorch: the port of
``synthsr_tpu/train/adversarial.py`` (reference
``SynthSR/fine_tuning_with_adversary.py:37-479``).

Generator = the U-Net on synthetic pairs made on the device (optionally
warm-started from a Keras ``.h5``); critic = :class:`~..models.discriminator.
Discriminator3D`.  Critic loss ``-D(real) + D(fake) + λ·(‖∇D(x̂)‖ - 1)²`` on
random-weighted interpolates x̂; generator loss ``(1 - w_D)·L1 + w_D·(-D(fake))``
on the cropped volumes.  The loop runs ``first_training_ratio`` critic updates
on the very first step, then ``training_ratio`` per generator update, and
saves per epoch: loss curves as ``.npy``, the generator's and critic's Keras
``.h5`` (where h5py is installed) and an ``adv_{epoch:03d}.pt`` checkpoint
from which a run resumes.

On the fast path (the default) the generator runs the kernels as in
supervised training (``models/unet_cf_train.fast_train_forward`` for its
update, ``models/unet_cf.fast_unet_forward`` for the fake volumes of the
critic updates) and the critic runs ``models/discriminator_cf.py``: its
first conv on the kernels for the WGAN terms, and the unrolled input-gradient
program for the gradient penalty, whose stride-1 convs and their transposes
all run on the kernels, at any spatial size.  ``fast_forward="off"`` runs
the plain float32 networks instead (the critic built in float32 whatever
``compute_dtype`` says), the penalty by double autograd.  Generation and the
interpolation weights are drawn before the differentiated part
(:func:`critic_loss`, :func:`generator_loss` take them as values).

With a frozen segmenter (``segmentation_model_file``, ``.h5`` or ``.pt``,
and ``path_segmentation_equivalency``) the generator loss takes
``relative_weight_segmentation`` from the L1 weight and adds that weight
times the Dice of the segmenter's output on the clip-normalised fake
(``metrics.build_seg_loss_fn``; the clip bounds are the 2nd and 98th
percentiles of the first real image, so it needs ``images_dir``).  A
generator outside the fast gate (dropout, residual levels, ...) runs the
plain ``UNet3D`` forwards in the compute dtype, dropout on masks drawn
before the forward; the critic keeps its kernel paths.  ``n_devices`` = N >
1 runs as one rank of an initialised ``torch.distributed`` group of N ranks
(``parallel/mesh.py``): each rank feeds its slice of the global batch, the
generator's BatchNorm statistics span the ranks, both updates average their
gradients and losses over them, and rank 0 alone logs and writes files.

Differences from the JAX function: ``lax.scan`` and ``cycle_step`` are a
plain loop (``scan_inner`` is accepted and ignored); checkpoints are ``.pt``
files, not orbax directories; every random draw of an update comes from
per-example generators (``training.example_generators``); the penalty's
gradient norm is summed in float32.
"""

from __future__ import annotations

import importlib.util
import os
import re
import time

import numpy as np
import torch

from ..io.labels import get_list_labels
from ..models.discriminator import Discriminator3D, critic_forward, init_critic
from ..models.discriminator_cf import fast_disc_apply, fast_disc_input_grad
from ..models.h5_import import export_keras_unet_weights, load_keras_unet_weights
from ..models.unet import UNet3D, draw_dropout_masks
from ..models.unet_cf import fast_unet_forward
from ..models.unet_cf_train import can_fast_train, fast_train_forward
from ..models.weights import (disc_state_dict_to_variables, state_dict_to_variables,
                              variables_to_state_dict)
from ..ops.losses import l1_loss
from ..parallel.mesh import all_reduce_mean_list, data_group, local_slice, rank_and_size
from ..synth.brain_generator import BrainGenerator
from ..synth.labels_to_image import build_generator
from ..synth.model_inputs import build_model_inputs
from ..synth.sampling import make_gmm_sampler
from ..utils.finite_guard import FiniteGuard, adam_init, gated_adam_step
from ..utils.misc import get_mapping_lut, load_array_if_path, reformat_to_list
from ..utils.prefetch import PrefetchIterator
from .metrics import assemble_prediction, center_crop, doubled_residual_indices
from .training import (bn_layers, example_generators, frozen_segmenter, generate_batch,
                       init_unet, write_bn_stats)

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def _cf(x):
    """(B, X, Y, Z, C) -> (B, C, X, Y, Z); None stays None."""
    return None if x is None else x.permute(0, 4, 1, 2, 3)


def random_weighted_average(real, fake, w):
    """x̂ = w·real + (1 - w)·fake with one weight per example (reference
    RandomWeightedAverage:604-625); ``w`` (B, 1, ..., 1) drawn by the caller."""
    return w * real + (1.0 - w) * fake


def gradient_penalty_from_grads(grads, weight=10.0):
    """λ·mean((‖g‖₂ - 1)²) over input gradients g = ∇_x̂ D(x̂) of (B, C, D, H,
    W), the norm over the spatial axes (reference :585-595), in float32."""
    sq = grads.to(torch.float32).square().sum(dim=(2, 3, 4))
    norm = torch.sqrt(torch.clamp(sq, min=1e-12))
    return weight * (1.0 - norm).square().mean()


def gradient_penalty(disc_apply, x_hat, mask=None, weight=10.0):
    """The penalty by double autograd through ``disc_apply(x, mask) -> (B,
    1)``: differentiable in whatever ``disc_apply`` closes over."""
    x_hat = x_hat.detach().requires_grad_(True)
    (grads,) = torch.autograd.grad(disc_apply(x_hat, mask).sum(), x_hat, create_graph=True)
    return gradient_penalty_from_grads(grads, weight)


def critic_loss(critic: Discriminator3D, params: dict, target, fake, w, mask=None,
                gradient_penalty_weight=10.0, fast=True):
    """The critic update's loss on pre-drawn (target, fake, w), NCDHW:
    ``mean(-D(target)) + mean(D(fake)) + GP(x̂)``, differentiable in
    ``params`` (the sum of :func:`critic_terms`)."""
    d_real, d_fake, gp = critic_terms(critic, params, target, fake, w, mask,
                                      gradient_penalty_weight, fast)
    return torch.mean(-d_real) + torch.mean(d_fake) + gp


def critic_terms(critic: Discriminator3D, params: dict, target, fake, w, mask=None,
                 gradient_penalty_weight=10.0, fast=True):
    """(D(target) (B, 1), D(fake) (B, 1), GP(x̂)) of :func:`critic_loss`:
    D(target) and D(fake) are one critic application of batch 2B (reference
    :321-325); ``fast`` takes the kernels' paths, else the plain critic and
    double autograd."""
    b = target.shape[0]
    both = torch.cat([target, fake]).detach()
    masks = None if mask is None else torch.cat([mask, mask])
    x_hat = random_weighted_average(target, fake, w).detach()
    if fast:
        d = fast_disc_apply(critic, params, both, masks)
        gp = gradient_penalty_from_grads(fast_disc_input_grad(critic, params, x_hat, mask),
                                         gradient_penalty_weight)
    else:
        def apply(x, m=None):
            return critic_forward(params, x, m, critic.n_levels, critic.compute_dtype)

        d = apply(both, masks)
        gp = gradient_penalty(apply, x_hat, mask, gradient_penalty_weight)
    return d[:b], d[b:], gp


def generator_loss(gen_model: UNet3D, critic: Discriminator3D, critic_params: dict, image,
                   target, mask=None, *, residual_indices=None, loss_cropping=None,
                   relative_weight_discriminator=0.01, compute_dtype=torch.bfloat16, fast=True,
                   masks=None, group=None, seg_loss_fn=None, seg_target=None,
                   relative_weight_segmentation=0.25):
    """The generator update's loss on a pre-drawn pair (image, target (B, X,
    Y, Z, C), mask NCDHW): ``w_D·mean(-D(fake)) + (1 - w_D)·L1`` on the
    cropped volumes, and the train forward's new BatchNorm statistics.  With
    ``seg_loss_fn`` the L1 weight drops by ``w_seg`` and ``w_seg`` times the
    segmenter's Dice of the fake against ``seg_target`` joins (JAX
    :373-387).  Differentiable in the generator's parameters;
    ``critic_params`` are taken as they are (pass them detached).  A
    generator outside the fast gate runs ``forward_train`` in
    ``compute_dtype`` with the dropout ``masks``; ``group`` is the
    data-parallel group of its BatchNorm statistics."""
    x = _cf(image)
    if fast and can_fast_train(gen_model):
        out, new_stats = fast_train_forward(gen_model, x, compute_dtype, group)
    else:
        out, new_stats = gen_model.forward_train(x, compute_dtype if fast else torch.float32,
                                                 masks, group)
    fake, _ = assemble_prediction(out.permute(0, 2, 3, 4, 1), image,
                                  work_with_residual_channel=residual_indices)
    l1 = l1_loss(center_crop(fake, loss_cropping), center_crop(target, loss_cropping))
    if fast:
        d = fast_disc_apply(critic, critic_params, _cf(fake), mask)
    else:
        d = critic_forward(critic_params, _cf(fake), mask, critic.n_levels, critic.compute_dtype)
    w = relative_weight_discriminator
    l1_weight = 1.0 - w
    loss = w * torch.mean(-d)
    if seg_loss_fn is not None:
        l1_weight -= relative_weight_segmentation
        loss = loss + relative_weight_segmentation * seg_loss_fn(fake, seg_target)
    return loss + l1_weight * l1, new_stats


def fake_volumes(gen_model: UNet3D, image, residual_indices=None, compute_dtype=torch.bfloat16,
                 fast=True):
    """The generator's inference output for the critic update, (B, X, Y, Z,
    C) float32, with no gradient: the fast forward per example (batch-1
    kernels), the plain forward in ``compute_dtype`` for a generator outside
    the fast gate, or the plain float32 forward when not ``fast``."""
    x = _cf(image)
    with torch.no_grad():
        if fast and can_fast_train(gen_model):
            out = torch.cat([fast_unet_forward(gen_model, x[i:i + 1], compute_dtype)
                             for i in range(x.shape[0])])
        else:
            out = gen_model(x, compute_dtype if fast else torch.float32)
    pred, _ = assemble_prediction(out.permute(0, 2, 3, 4, 1), image,
                                  work_with_residual_channel=residual_indices)
    return pred


def make_adversarial_steps(gen_model: UNet3D, critic: Discriminator3D, generator, gmm_sampler, *,
                           lr_generator=1e-4, lr_discriminator=1e-4, lr_decay=0.0,
                           residual_indices=None, loss_cropping=None,
                           relative_weight_discriminator=0.01, gradient_penalty_weight=10.0,
                           mask_lut=None, use_real_image=False, compute_dtype=torch.bfloat16,
                           fast=True, seg_loss_fn=None, relative_weight_segmentation=0.25,
                           group=None):
    """The two WGAN-GP updates (reference :365-436), each writing its
    network's parameters (and the generator's BatchNorm statistics) in place
    through the non-finite gate:

      disc_step(opt_state, gen, batch) -> (opt_state, loss)
      gen_step(opt_state, gen, batch) -> (opt_state, loss)

    ``gen``: the step generator (CPU) from which each update derives its
    per-example generators (``training.example_generators``); ``batch``:
    (labels (B, X, Y, Z, 1)[, real images]) on the device.  ``generator``
    returns the deformed labels too when ``mask_lut`` (a LUT tensor from
    generation labels to 0/1) or ``seg_loss_fn`` is given: the anatomy mask
    is ``mask_lut[labels]``, the segmenter's target the labels themselves.
    ``group``: the data-parallel process group (``batch`` is this rank's
    slice); both updates average their gradients and losses over it."""
    gen_params = list(gen_model.parameters())
    critic_params = list(critic.parameters())
    bn_names = bn_layers(gen_model)
    rank, _ = rank_and_size(group)

    def generate(gen, batch):
        n = batch[0].shape[0]
        gens = example_generators(gen, n, rank * n, batch[0].device)
        out = generate_batch(generator, gmm_sampler, gens, batch, use_real_image)
        mask = None
        if mask_lut is not None:
            mask = _cf(mask_lut[out[2][..., 0].long()][..., None].to(torch.float32))
        return out[0], out[1], out[2] if len(out) > 2 else None, mask, gens

    def disc_step(opt_state, gen, batch):
        image, target, _, mask, gens = generate(gen, batch)
        fake = fake_volumes(gen_model, image, residual_indices, compute_dtype, fast)
        w = torch.cat([torch.rand((1, 1, 1, 1, 1), generator=g, device=g.device) for g in gens])
        loss = critic_loss(critic, dict(critic.named_parameters()), _cf(target), _cf(fake), w,
                           mask, gradient_penalty_weight, fast)
        grads = torch.autograd.grad(loss, critic_params)
        *grads, loss = all_reduce_mean_list([*grads, loss.detach()], group)
        with torch.no_grad():
            opt_state = gated_adam_step(critic_params, grads, opt_state, torch.isfinite(loss),
                                        lr_discriminator, lr_decay)
        return opt_state, loss.detach()

    def gen_step(opt_state, gen, batch):
        image, target, labels, mask, gens = generate(gen, batch)
        frozen = {n: p.detach() for n, p in critic.named_parameters()}
        loss, new_stats = generator_loss(
            gen_model, critic, frozen, image, target, mask, residual_indices=residual_indices,
            loss_cropping=loss_cropping,
            relative_weight_discriminator=relative_weight_discriminator,
            compute_dtype=compute_dtype, fast=fast, masks=draw_dropout_masks(gen_model, gens),
            group=group, seg_loss_fn=seg_loss_fn, seg_target=labels,
            relative_weight_segmentation=relative_weight_segmentation)
        grads = torch.autograd.grad(loss, gen_params)
        *grads, loss = all_reduce_mean_list([*grads, loss.detach()], group)
        with torch.no_grad():
            finite = torch.isfinite(loss)
            opt_state = gated_adam_step(gen_params, grads, opt_state, finite, lr_generator,
                                        lr_decay)
            write_bn_stats(gen_model, bn_names, new_stats, finite)
        return opt_state, loss.detach()

    return disc_step, gen_step


def training(labels_dir, images_dir, model_dir, prior_means, prior_stds,
             path_generation_labels, path_segmentation_equivalency=None,
             segmentation_model_file=None, prior_distributions="normal",
             path_generation_classes=None, FS_sort=True, batchsize=1, input_channels=True,
             output_channel=None, target_res=None, output_shape=None, flipping=True,
             padding_margin=None, scaling_bounds=0.2, rotation_bounds=20, shearing_bounds=0.03,
             translation_bounds=5, nonlin_std=5.0, nonlin_shape_factor=0.04,
             simulate_registration_error=False, data_res=None, thickness=None,
             randomise_res=True, downsample=True, blur_range=1.03, build_reliability_maps=False,
             bias_field_std=0.4, bias_shape_factor=0.04, n_levels=5, nb_conv_per_level=2,
             conv_size=3, unet_feat_count=24, feat_multiplier=2, dropout=0, activation="elu",
             lr_decay=0, epochs=100, steps_per_epoch=1000, work_with_residual_channel=None,
             loss_cropping=None, lr_generator=1e-4, lr_discriminator=1e-4,
             relative_weight_segmentation=0.25, relative_weight_discriminator=0.01,
             checkpoint_generator=None, gradient_penalty_weight=10, first_training_ratio=100,
             training_ratio=10, labels_to_mask=None, seed=None, compute_dtype="bfloat16",
             n_devices=None, fast_forward="auto", scan_inner="auto", device=None, log_fn=print):
    """WGAN-GP fine-tuning (module docstring), with the JAX function's
    parameters.  ``device``: "cuda" (the default; raises without a card) or
    "cpu"; a data-parallel rank trains on ``cuda:rank`` (the current
    device).  ``n_devices``: the size of the initialised ``torch.distributed``
    group this process is a rank of; None or 1 for one process.
    ``fast_forward``: "off" runs the plain float32 networks, any other of the
    JAX values the kernels' paths.  Returns the networks and loss curves."""
    del scan_inner  # the plain loop needs no scan
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device available; pass device='cpu' to train on the CPU")
    if segmentation_model_file is not None and images_dir is None:
        # JAX reads the first real image unconditionally (:596-601)
        raise ValueError("the frozen segmenter's normalisation takes the percentiles of the "
                         "first real image: pass images_dir")
    group = data_group(n_devices)
    rank, world = rank_and_size(group)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    if rank != 0:
        log_fn = (lambda *a, **k: None)  # noqa: E731 (rank 0 alone logs)
    # the JAX values, for the same signature: "auto", "on" and "interpret"
    # (a TPU notion) all mean the kernels' paths here
    if fast_forward not in ("auto", "on", "interpret", "off"):
        raise ValueError(f"fast_forward must be auto, on, interpret or off, got {fast_forward!r}")
    fast = fast_forward != "off"

    # ----- channel plumbing (reference :240-261) -----
    input_channels_l = [bool(c) for c in reformat_to_list(input_channels)]
    n_output_channels = 1
    if output_channel is not None:
        output_channel = list(reformat_to_list(output_channel))
        n_output_channels = len(output_channel)
    if work_with_residual_channel is not None:
        work_with_residual_channel = reformat_to_list(work_with_residual_channel)
        if output_channel is not None and \
                len(work_with_residual_channel) != len(output_channel):
            raise ValueError("number of residual and output channels must match")
    residual_indices = doubled_residual_indices(work_with_residual_channel,
                                                build_reliability_maps,
                                                input_channels=input_channels_l)

    generation_labels, n_neutral_labels = get_list_labels(
        label_list=path_generation_labels, labels_dir=labels_dir, FS_sort=FS_sort)
    os.makedirs(model_dir, exist_ok=True)
    bg = BrainGenerator(
        labels_dir=labels_dir, images_dir=images_dir, generation_labels=generation_labels,
        n_neutral_labels=n_neutral_labels, padding_margin=padding_margin,
        batchsize=batchsize, input_channels=input_channels_l, output_channel=output_channel,
        target_res=target_res, output_shape=output_shape, output_div_by_n=2 ** n_levels,
        generation_classes=path_generation_classes, prior_means=prior_means,
        prior_stds=prior_stds, prior_distributions=prior_distributions, flipping=flipping,
        scaling_bounds=scaling_bounds, rotation_bounds=rotation_bounds,
        shearing_bounds=shearing_bounds, translation_bounds=translation_bounds,
        nonlin_std=nonlin_std, nonlin_shape_factor=nonlin_shape_factor,
        simulate_registration_error=simulate_registration_error, randomise_res=randomise_res,
        data_res=data_res, thickness=thickness, downsample=downsample, blur_range=blur_range,
        build_reliability_maps=build_reliability_maps, bias_field_std=bias_field_std,
        bias_shape_factor=bias_shape_factor, seed=seed, device=dev)
    mask_lut = None
    if labels_to_mask is not None:
        mask_lut = torch.as_tensor(get_mapping_lut(generation_labels,
                                                   load_array_if_path(labels_to_mask)),
                                   device=dev)
    generator = build_generator(
        bg.cfg, return_labels=mask_lut is not None or segmentation_model_file is not None)

    # ----- networks (reference :288-345) -----
    dt = _DTYPES[str(compute_dtype)]
    n_in = sum(input_channels_l) * (2 if build_reliability_maps else 1)
    gen_model = init_unet(UNet3D(in_channels=n_in, nb_features=unet_feat_count,
                                 nb_levels=n_levels, conv_size=conv_size,
                                 nb_labels=n_output_channels, feat_mult=feat_multiplier,
                                 nb_conv_per_level=nb_conv_per_level, activation=activation,
                                 final_pred_activation="linear", conv_dropout=float(dropout)))
    if checkpoint_generator is not None:
        log_fn(f"loading {checkpoint_generator}")
        template = state_dict_to_variables(gen_model.state_dict())
        gen_model.load_state_dict(variables_to_state_dict(
            load_keras_unet_weights(checkpoint_generator, template)))
    gen_model.to(dev)
    out_shape = bg.model_output_shape
    critic = init_critic(Discriminator3D(out_shape, in_channels=n_output_channels,
                                         compute_dtype=dt if fast else torch.float32)).to(dev)

    seg_loss_fn = None
    if segmentation_model_file is not None:  # the frozen segmenter (JAX :581-601)
        seg_loss_fn = frozen_segmenter(
            segmentation_model_file, path_segmentation_equivalency,
            path_segmentation_equivalency, generation_labels, images_dir, loss_cropping, False,
            dev, dict(nb_features=unet_feat_count, nb_levels=n_levels, conv_size=conv_size,
                      feat_mult=feat_multiplier, nb_conv_per_level=nb_conv_per_level,
                      activation=activation), dt)

    gmm_sampler = make_gmm_sampler(
        n_labels=len(generation_labels), prior_means=bg.prior_means, prior_stds=bg.prior_stds,
        prior_distributions=prior_distributions, n_channels=bg.n_channels,
        generation_classes=bg.generation_classes)
    disc_step, gen_step = make_adversarial_steps(
        gen_model, critic, generator, gmm_sampler, lr_generator=lr_generator,
        lr_discriminator=lr_discriminator, lr_decay=lr_decay, residual_indices=residual_indices,
        loss_cropping=loss_cropping, relative_weight_discriminator=relative_weight_discriminator,
        gradient_penalty_weight=gradient_penalty_weight, mask_lut=mask_lut,
        use_real_image=output_channel is None, compute_dtype=dt, fast=fast,
        seg_loss_fn=seg_loss_fn, relative_weight_segmentation=relative_weight_segmentation,
        group=group)
    gen_opt = adam_init(list(gen_model.parameters()))
    disc_opt = adam_init(list(critic.parameters()))
    gen = torch.Generator().manual_seed(seed if seed is not None else 0)

    log_dir = os.path.join(model_dir, "logs")
    os.makedirs(log_dir, exist_ok=True)
    d_curve, g_curve = [], []
    init_epoch = 0
    last = latest_adv_checkpoint(model_dir)
    if last is not None:
        gen_opt, disc_opt, init_epoch = restore_adv_checkpoint(
            os.path.join(model_dir, f"adv_{last:03d}.pt"), gen_model, critic, gen)
        for name, curve in (("discriminator_loss.npy", d_curve),
                            ("generator_loss.npy", g_curve)):
            path = os.path.join(log_dir, name)
            if os.path.isfile(path):
                curve.extend(np.load(path)[:init_epoch].tolist())
        log_fn(f"resuming from epoch {init_epoch}")

    # ----- loop (reference :444-479): labels-only host stream -----
    inputs = PrefetchIterator(build_model_inputs(
        path_label_maps=bg.labels_paths, n_labels=len(generation_labels),
        prior_means=bg.prior_means, prior_stds=bg.prior_stds, path_images=bg.images_paths,
        batchsize=batchsize, rng=bg._rng if seed is not None else None,
        include_gmm_params=False, local_slice=local_slice(group)), buffer_size=4)

    def next_batch():
        return [torch.as_tensor(np.asarray(a)).to(dev, non_blocking=True) for a in next(inputs)]

    export_h5 = importlib.util.find_spec("h5py") is not None
    if not export_h5:
        log_fn("h5py is not installed: the per-epoch .h5 export is skipped")
    le = len(str(epochs))
    # the steps gate their writes on isfinite(loss); the guards abort lagged
    guard_d = FiniteGuard(lag=2, what="discriminator loss")
    guard_g = FiniteGuard(lag=2, what="generator loss")
    for epoch in range(init_epoch, epochs):
        t0 = time.time()
        sum_d = torch.zeros((), device=dev)
        sum_g = torch.zeros((), device=dev)
        n_d = 0
        for step_i in range(int(steps_per_epoch)):
            ratio = first_training_ratio if (epoch == 0 and step_i == 0) else training_ratio
            tag = f"epoch {epoch + 1} step {step_i + 1}"
            for _ in range(int(ratio)):
                disc_opt, d_loss = disc_step(disc_opt, gen, next_batch())
                guard_d.push(tag, d_loss)
                sum_d += d_loss
                n_d += 1
            gen_opt, g_loss = gen_step(gen_opt, gen, next_batch())
            guard_g.push(tag, g_loss)
            sum_g += g_loss
        guard_d.flush()
        guard_g.flush()
        d_curve.append(float(sum_d) / max(n_d, 1))
        g_curve.append(float(sum_g) / steps_per_epoch)
        log_fn(f"Epoch {epoch + 1:0{le}d}/{epochs}  D {d_curve[-1]:.5f}  G {g_curve[-1]:.5f}  "
               f"({time.time() - t0:.1f}s, {n_d} critic updates)")
        if rank != 0:
            continue
        np.save(os.path.join(log_dir, "discriminator_loss.npy"), np.array(d_curve))
        np.save(os.path.join(log_dir, "generator_loss.npy"), np.array(g_curve))
        if export_h5:
            export_keras_unet_weights(
                os.path.join(model_dir, f"generator_{epoch + 1:0{le}d}.h5"),
                state_dict_to_variables(gen_model.state_dict()))
            export_keras_unet_weights(
                os.path.join(model_dir, f"discriminator_{epoch + 1:0{le}d}.h5"),
                disc_state_dict_to_variables(critic.state_dict()), prefix="discriminator_")
        save_adv_checkpoint(model_dir, epoch + 1, gen_model, critic, gen_opt, disc_opt, gen)
    return {"gen_model": gen_model, "critic": critic, "d_curve": d_curve, "g_curve": g_curve}


# ---------------------------------------------------------------------------
# checkpoints (replacing the JAX module's orbax directories, :821-844)
# ---------------------------------------------------------------------------

def _adam_to(state, dev):
    return {"count": state["count"].to(dev), "mu": [t.to(dev) for t in state["mu"]],
            "nu": [t.to(dev) for t in state["nu"]]}


def save_adv_checkpoint(model_dir, epoch, gen_model, critic, gen_opt, disc_opt, gen):
    """``adv_{epoch:03d}.pt``: both networks' state dicts, both Adam states,
    the draws' generator state and the epoch."""
    cpu = torch.device("cpu")
    torch.save({"generator": {k: v.detach().cpu() for k, v in gen_model.state_dict().items()},
                "critic": {k: v.detach().cpu() for k, v in critic.state_dict().items()},
                "gen_adam": _adam_to(gen_opt, cpu), "critic_adam": _adam_to(disc_opt, cpu),
                "rng": gen.get_state(), "epoch": epoch},
               os.path.join(model_dir, f"adv_{epoch:03d}.pt"))


def latest_adv_checkpoint(model_dir):
    """The newest epoch with an ``adv_NNN.pt`` checkpoint in ``model_dir``, or None."""
    if not os.path.isdir(model_dir):
        return None
    epochs = [int(m.group(1)) for f in os.listdir(model_dir)
              if (m := re.fullmatch(r"adv_(\d{3})\.pt", f))]
    return max(epochs) if epochs else None


def restore_adv_checkpoint(path, gen_model, critic, gen):
    """Load an ``adv_NNN.pt`` into the networks and ``gen``; returns (generator
    Adam state, critic Adam state, epoch), on the networks' device."""
    ck = torch.load(path, map_location="cpu", weights_only=True)
    gen_model.load_state_dict(ck["generator"])
    critic.load_state_dict(ck["critic"])
    gen.set_state(ck["rng"])
    dev = next(gen_model.parameters()).device
    return _adam_to(ck["gen_adam"], dev), _adam_to(ck["critic_adam"], dev), int(ck["epoch"])
