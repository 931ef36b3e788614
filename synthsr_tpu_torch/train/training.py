"""Supervised SR / synthesis training on PyTorch: the port of
``synthsr_tpu/train/training.py`` (reference ``SynthSR/training.py:38-453``).

The synthetic pairs are generated inside the step on the device (GMM prior
draws, deformation, acquisition simulation; ``synth/``), the U-Net runs its
fast train forward and backward through the hand-written kernels
(``models/unet_cf_train.py``), and Adam with the Keras decay updates the
parameters through an on-device non-finite gate (``utils/finite_guard.py``).
Batch 1 runs the generator directly; larger batches loop over the examples
(the JAX package's ``vmap_examples`` is a JAX device), each drawing from its
own generator derived from the step generator and its global index.

- Models outside the fast gate (dropout, residual levels, dilation, other
  conv or pool sizes, ``layer_nb_feats``, no BatchNorm) train on the plain
  ``UNet3D.forward_train`` in the compute dtype, dropout on masks drawn
  before the forward.
- The frozen-segmenter Dice regulariser (``segmentation_model_file``, a
  Keras ``.h5`` where h5py is installed or a ``.pt`` state dict) adds
  ``relative_weight_segmentation`` times the Dice of a softmax ``UNet3D``'s
  segmentation of the prediction (``metrics.build_seg_loss_fn``); its convs
  are plain torch ops (cuDNN on a card), as they are XLA convs in JAX.
- ``remat``: False, True or "levels" (``fast_train_forward``); by default
  "levels" when each rank's batch has 2 examples or more, as in JAX.
- ``n_devices`` = N > 1 runs as one rank of an initialised
  ``torch.distributed`` group of N ranks (``parallel/mesh.py``; the train
  CLI's ``--n_devices`` starts them): each rank feeds its slice of the global
  ``batchsize``, BatchNorm's statistics span the ranks, the gradients and the
  loss are averaged before Adam, and rank 0 alone logs and writes
  checkpoints.

Checkpoints are per-epoch ``{epoch:03d}.pt`` files holding the parameters and
BatchNorm statistics (the model's state dict), the Adam state, the step
generator's state and the epoch; a run resumes from the newest one.  A
Keras ``.h5`` is exported beside each where h5py is installed; without it the
run logs once that the export was skipped.
"""

from __future__ import annotations

import importlib.util
import json
import os
import re
import time

import numpy as np
import torch

from ..io.labels import get_list_labels
from ..models.h5_import import export_keras_unet_weights, load_keras_unet_weights
from ..synth.model_inputs import build_model_inputs
from ..utils.misc import get_padding_margin, load_array_if_path, reformat_to_list
from ..models.unet import UNet3D, draw_dropout_masks
from ..models.unet_cf_train import can_fast_train, fast_train_forward
from ..models.weights import load_unet_weights, state_dict_to_variables, variables_to_state_dict
from ..parallel.mesh import all_reduce_mean_list, data_group, local_slice, rank_and_size
from ..synth.brain_generator import BrainGenerator
from ..synth.labels_to_image import build_generator
from ..synth.sampling import make_gmm_sampler
from ..utils.finite_guard import FiniteGuard, adam_init, gated_adam_step, guard_updates
from ..utils.prefetch import PrefetchIterator
from ..utils.profiling import span
from .metrics import (assemble_prediction, build_seg_loss_fn, doubled_residual_indices,
                      regression_loss)

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def init_unet(model: UNet3D, seed: int = 0) -> UNet3D:
    """flax's default initialisation, in place: conv kernels lecun-normal
    (truncated normal at ±2σ, std sqrt(1/fan_in) corrected for the
    truncation), zero biases; BatchNorm scale 1, bias 0, mean 0, var 1."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, mod in model.named_children():
            if isinstance(mod, torch.nn.Conv3d):
                fan_in = mod.weight[0].numel()
                std = (1.0 / fan_in) ** 0.5 / 0.87962566103423978
                torch.nn.init.trunc_normal_(mod.weight, 0.0, std, -2 * std, 2 * std,
                                            generator=gen)
                mod.bias.zero_()
            else:
                mod.reset_parameters()
    return model


def example_generators(gen: torch.Generator, n_local: int, first_index: int = 0,
                       device=None) -> list:
    """The per-example generators of one step: ONE draw of the step
    generator ``gen`` (a host integer; keep ``gen`` on the CPU, or the draw
    waits for the card), then one generator on ``device`` per example seeded
    by that draw plus the example's GLOBAL index ``first_index + i``.  A
    data-parallel rank passes ``first_index = rank · n_local``, so every
    example sees the same stream whatever the world size (the JAX step splits
    keys for the global batch and slices them per device, :209-218)."""
    base = int(torch.randint(0, 2 ** 62, (1,), generator=gen, device=gen.device))
    dev = torch.device("cpu" if device is None else device)
    return [torch.Generator(device=dev).manual_seed(base + first_index + i)
            for i in range(n_local)]


def generate_batch(generator, gmm_sampler, gens, batch, use_real_image=False):
    """The step's synthetic pairs: (image (B, X, Y, Z, C), target) float32,
    and the deformed label maps (B, X, Y, Z, 1) when the generator returns
    them.  ``batch``: (labels (B, X, Y, Z, 1)[, real images]) on the device;
    ``gens``: one generator per example (:func:`example_generators`), from
    which its GMM parameters are drawn first and then its generation."""
    labels = batch[0]
    outs = []
    for i, g in enumerate(gens):
        params = gmm_sampler(g)
        outs.append(generator(g, labels[i], *params,
                              *((batch[1][i],) if use_real_image else ())))
    return tuple(torch.stack(parts) for parts in zip(*outs))


def forward_loss(model, image, target, metrics="l1", loss_cropping=16, residual_indices=None,
                 compute_dtype=torch.bfloat16, fast=True, masks=None, group=None, remat=False,
                 seg_loss_fn=None, seg_target=None, seg_rel_weight=0.25):
    """Network forward on (B, X, Y, Z, C), the regression loss and, with
    ``seg_loss_fn``, ``seg_rel_weight`` times the frozen segmenter's Dice on
    the assembled prediction against ``seg_target`` (reference :372-409):
    (loss, {bn name: new running stats}).  The fast train forward runs when
    the model passes ``can_fast_train``, else the plain ``forward_train`` in
    ``compute_dtype`` with the dropout ``masks``; ``fast=False`` runs the
    plain float32 ``forward_train``, the reference of the fast path.
    ``group``: the data-parallel group of BatchNorm's statistics."""
    x = image.permute(0, 4, 1, 2, 3)
    if fast and can_fast_train(model):
        out, new_stats = fast_train_forward(model, x, compute_dtype, group, remat)
    else:
        out, new_stats = model.forward_train(x, compute_dtype if fast else torch.float32,
                                             masks, group, remat)
    out = out.permute(0, 2, 3, 4, 1)
    loss = regression_loss(out, image, target, metrics=metrics, loss_cropping=loss_cropping,
                           work_with_residual_channel=residual_indices)
    if seg_loss_fn is not None:
        pred, _ = assemble_prediction(out, image, metrics, residual_indices)
        loss = loss + seg_rel_weight * seg_loss_fn(pred, seg_target)
    return loss, new_stats


def bn_layers(model) -> list:
    """Names of the model's BatchNorm layers."""
    return [n for n, m in model.named_children() if isinstance(m, torch.nn.BatchNorm3d)]


def write_bn_stats(model, bn_names, new_stats, finite: torch.Tensor):
    """Copy the train forward's new running statistics into the model's
    buffers where ``finite`` (under ``torch.no_grad()``)."""
    for name in bn_names:
        bn = getattr(model, name)
        old = [bn.running_mean, bn.running_var]
        for b, n in zip(old, guard_updates(finite, list(new_stats[name]), old)):
            b.copy_(n)


def make_train_step(model, generator, gmm_sampler, lr, lr_decay=0.0, metrics="l1",
                    loss_cropping=16, residual_indices=None, use_real_image=False,
                    compute_dtype=torch.bfloat16, seg_loss_fn=None, seg_rel_weight=0.25,
                    remat=False, group=None):
    """``step(opt_state, gen, batch) -> (opt_state, loss)``: generate, the fast
    train forward (kernels on a card, their plain versions on the CPU; the
    plain ``forward_train`` for models outside the fast gate), backward,
    Adam.  The model's parameters and BatchNorm buffers are written in place,
    through the non-finite gate: a step whose loss is not finite changes
    neither them nor the Adam state.

    ``gen``: the step generator (CPU; :func:`example_generators`).
    ``generator`` must return the deformed labels too when ``seg_loss_fn``
    (:func:`~.metrics.build_seg_loss_fn`) is given.  ``remat``: False, True
    or "levels" (``fast_train_forward``).  ``group``: the data-parallel
    process group: ``batch`` is this rank's slice of the global batch,
    BatchNorm's statistics span the ranks, and the gradients and the loss
    are averaged over them (one flat all-reduce) before the gated Adam.
    The step takes its gradients with ``torch.autograd.grad``, which would
    not fire ``DistributedDataParallel``'s reducer hooks: the average is
    explicit.

    While the tracer of ``utils/profiling`` is on, each step is a
    ``train.step`` span tiled by ``train.generate``, ``train.forward``,
    ``train.backward`` (autograd and the all-reduce) and ``train.adam`` (the
    gate, Adam, the BatchNorm statistics)."""
    params = list(model.parameters())
    bn_names = bn_layers(model)
    rank, _ = rank_and_size(group)

    def step(opt_state, gen, batch):
        with span("train.step"):
            with span("train.generate"):
                n = batch[0].shape[0]
                gens = example_generators(gen, n, rank * n, batch[0].device)
                outs = generate_batch(generator, gmm_sampler, gens, batch, use_real_image)
                masks = draw_dropout_masks(model, gens)
            with span("train.forward"):
                loss, new_stats = forward_loss(
                    model, outs[0], outs[1], metrics, loss_cropping, residual_indices,
                    compute_dtype, masks=masks, group=group, remat=remat,
                    seg_loss_fn=seg_loss_fn,
                    seg_target=outs[2] if seg_loss_fn is not None else None,
                    seg_rel_weight=seg_rel_weight)
            with span("train.backward"):
                grads = torch.autograd.grad(loss, params)
                *grads, loss = all_reduce_mean_list([*grads, loss.detach()], group)
            with span("train.adam"), torch.no_grad():
                finite = torch.isfinite(loss)
                opt_state = gated_adam_step(params, grads, opt_state, finite, lr, lr_decay)
                write_bn_stats(model, bn_names, new_stats, finite)
            return opt_state, loss.detach()

    return step


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------

def save_checkpoint(model_dir, epoch, model, opt_state, gen, export_h5=True):
    """``{epoch:03d}.pt``, and the Keras ``{epoch:03d}.h5`` when ``export_h5``."""
    sd = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    torch.save({"model": sd,
                "adam": {"count": opt_state["count"].cpu(),
                         "mu": [t.cpu() for t in opt_state["mu"]],
                         "nu": [t.cpu() for t in opt_state["nu"]]},
                "rng": gen.get_state(), "epoch": epoch},
               os.path.join(model_dir, f"{epoch:03d}.pt"))
    if export_h5:
        export_keras_unet_weights(os.path.join(model_dir, f"{epoch:03d}.h5"),
                                  state_dict_to_variables(sd))


def latest_checkpoint(model_dir):
    """The newest epoch with a ``NNN.pt`` checkpoint in ``model_dir``, or None."""
    if not os.path.isdir(model_dir):
        return None
    epochs = [int(m.group(1)) for f in os.listdir(model_dir)
              if (m := re.fullmatch(r"(\d{3})\.pt", f))]
    return max(epochs) if epochs else None


def restore_checkpoint(path, model, gen):
    """Load a ``.pt`` checkpoint into ``model`` and ``gen``; returns
    (Adam state on the model's device, epoch)."""
    ck = torch.load(path, map_location="cpu", weights_only=True)
    model.load_state_dict(ck["model"])
    gen.set_state(ck["rng"])
    dev = next(model.parameters()).device
    adam = {"count": ck["adam"]["count"].to(dev),
            "mu": [t.to(dev) for t in ck["adam"]["mu"]],
            "nu": [t.to(dev) for t in ck["adam"]["nu"]]}
    return adam, int(ck["epoch"])


def frozen_segmenter(model_file, label_list, label_equivalency, generation_labels, images_dir,
                      loss_cropping, fs_header, dev, cfg, compute_dtype):
    """The Dice regulariser's loss (reference :372-409, JAX :487-516 and
    adversarial.py:581-601): a softmax ``UNet3D`` of architecture ``cfg`` with
    one output per entry of ``label_list`` (an array or ``.npy`` path), its
    weights from ``model_file`` (``.h5`` or ``.pt``), clip bounds from the
    2nd and 98th percentiles of the first real image when ``images_dir`` is
    given (no normalisation otherwise)."""
    from ..io.volume import load_volume
    from ..utils.misc import list_images_in_folder

    seg_labels = np.asarray(reformat_to_list(label_list, load_as_numpy=True))
    seg_model = UNet3D(in_channels=1, nb_labels=len(seg_labels),
                       final_pred_activation="softmax", **cfg)
    load_unet_weights(seg_model, model_file)
    seg_m = seg_M = None
    if images_dir is not None:
        im0 = load_volume(list_images_in_folder(images_dir)[0]).flatten()
        seg_m, seg_M = float(np.percentile(im0, 2)), float(np.percentile(im0, 98))
    return build_seg_loss_fn(seg_model.to(dev), generation_labels,
                             load_array_if_path(label_equivalency), loss_cropping, m=seg_m,
                             M=seg_M, fs_header=fs_header, compute_dtype=compute_dtype)


# ---------------------------------------------------------------------------
# the training orchestration (reference training():38-453 surface)
# ---------------------------------------------------------------------------

def training(labels_dir, model_dir, prior_means, prior_stds, path_generation_labels,
             segmentation_label_list=None, segmentation_label_equivalency=None,
             segmentation_model_file=None, fs_header_segnet=False,
             relative_weight_segmentation=0.25, prior_distributions="normal", images_dir=None,
             path_generation_classes=None, FS_sort=True, batchsize=1, input_channels=True,
             output_channel=0, target_res=None, output_shape=None, flipping=True,
             padding_margin=None, scaling_bounds=0.15, rotation_bounds=15,
             shearing_bounds=0.02, translation_bounds=5, nonlin_std=4.0,
             nonlin_shape_factor=0.03125, simulate_registration_error=True, data_res=None,
             thickness=None, randomise_res=None, downsample=True, blur_range=1.15,
             build_reliability_maps=True, bias_field_std=0.3, bias_shape_factor=0.03125,
             n_levels=5, nb_conv_per_level=2, conv_size=3, unet_feat_count=24,
             feat_multiplier=2, dropout=0, activation="elu", lr=1e-4, lr_decay=0, epochs=100,
             steps_per_epoch=1000, regression_metric="l1", work_with_residual_channel=None,
             loss_cropping=None, checkpoint=None, model_file_has_different_lhood_layer=False,
             n_devices=None, seed=None, compute_dtype="bfloat16", remat=None, device=None,
             log_fn=print):
    """Train the SR / synthesis U-Net on synthetic pairs made on the device.
    ``device``: "cuda" (the default; raises without a card) or "cpu"; a
    data-parallel rank trains on ``cuda:rank`` (the current device).
    ``n_devices``: the size of the initialised ``torch.distributed`` group
    this process is a rank of (module docstring); None or 1 for one
    process."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device available; pass device='cpu' (--cpu) to train "
                           "on the CPU")
    group = data_group(n_devices)
    rank, world = rank_and_size(group)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    if rank != 0:
        log_fn = (lambda *a, **k: None)  # noqa: E731 (rank 0 alone logs)
    if batchsize % world:
        raise ValueError(f"batchsize {batchsize} must divide evenly over {world} ranks")
    if remat is None:
        # JAX's default (:529-532): per-level remat once a rank holds 2 examples
        remat = "levels" if batchsize // world >= 2 else False

    # ----- channel validation (reference :245-271) -----
    input_channels_l = [bool(c) for c in reformat_to_list(input_channels)]
    n_channels = len(input_channels_l)
    if output_channel is not None:
        output_channel = list(reformat_to_list(output_channel))
    n_output_channels = 1 if output_channel is None else len(output_channel)
    if images_dir is None and output_channel is None:
        raise ValueError("please provide a value for output_channel or images_dir")
    if images_dir is not None and output_channel is not None:
        raise ValueError("provide either output_channel or images_dir, not both")
    if output_channel is not None and any(x >= n_channels for x in output_channel):
        raise ValueError("indices in output_channel exceed the number of channels")
    if work_with_residual_channel is not None:
        work_with_residual_channel = reformat_to_list(work_with_residual_channel)
        if output_channel is not None and \
                len(work_with_residual_channel) != len(output_channel):
            raise ValueError("number of residual and output channels must match")
        if any(x >= n_channels for x in work_with_residual_channel):
            raise ValueError("indices in work_with_residual_channel exceed channels")
    residual_indices = doubled_residual_indices(work_with_residual_channel,
                                                build_reliability_maps,
                                                input_channels=input_channels_l)

    # ----- labels + shapes (reference :273-285) -----
    generation_labels, n_neutral_labels = get_list_labels(
        label_list=path_generation_labels, labels_dir=labels_dir, FS_sort=FS_sort)
    os.makedirs(model_dir, exist_ok=True)
    if loss_cropping == 0:
        padding_margin, loss_cropping = None, None
    elif padding_margin is None:
        padding_margin = get_padding_margin(output_shape, loss_cropping)

    # ----- generator (reference :288-318) -----
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
        simulate_registration_error=simulate_registration_error,
        randomise_res=bool(randomise_res) if randomise_res is not None else False,
        data_res=data_res, thickness=thickness, downsample=downsample,
        blur_range=blur_range, build_reliability_maps=build_reliability_maps,
        bias_field_std=bias_field_std, bias_shape_factor=bias_shape_factor, seed=seed,
        device=dev)
    generator = build_generator(bg.cfg, return_labels=segmentation_model_file is not None)
    use_real = output_channel is None

    # ----- network (reference :321-345) -----
    nb_labels = 2 * n_output_channels if regression_metric == "laplace" else n_output_channels
    n_in = sum(input_channels_l) * (2 if build_reliability_maps else 1)
    model = init_unet(UNet3D(in_channels=n_in, nb_features=unet_feat_count, nb_levels=n_levels,
                             conv_size=conv_size, nb_labels=nb_labels, feat_mult=feat_multiplier,
                             nb_conv_per_level=nb_conv_per_level, activation=activation,
                             final_pred_activation="linear", conv_dropout=float(dropout)))
    if checkpoint is not None and checkpoint.endswith(".h5"):  # warm start (:353-369)
        skip = ("likelihood",) if model_file_has_different_lhood_layer else ()
        template = state_dict_to_variables(model.state_dict())
        model.load_state_dict(variables_to_state_dict(
            load_keras_unet_weights(checkpoint, template, skip_layers=skip)))
    model.to(dev)
    seg_loss_fn = None
    if segmentation_model_file is not None:
        seg_loss_fn = frozen_segmenter(
            segmentation_model_file, segmentation_label_list, segmentation_label_equivalency,
            generation_labels, images_dir, loss_cropping, fs_header_segnet, dev,
            dict(nb_features=unet_feat_count, nb_levels=n_levels, conv_size=conv_size,
                 feat_mult=feat_multiplier, nb_conv_per_level=nb_conv_per_level,
                 activation=activation), _DTYPES[str(compute_dtype)])

    gmm_sampler = make_gmm_sampler(
        n_labels=len(generation_labels), prior_means=bg.prior_means, prior_stds=bg.prior_stds,
        prior_distributions=prior_distributions, n_channels=bg.n_channels,
        generation_classes=bg.generation_classes)
    step = make_train_step(model, generator, gmm_sampler, lr, lr_decay,
                           metrics=regression_metric, loss_cropping=loss_cropping,
                           residual_indices=residual_indices, use_real_image=use_real,
                           compute_dtype=_DTYPES[str(compute_dtype)], seg_loss_fn=seg_loss_fn,
                           seg_rel_weight=relative_weight_segmentation, remat=remat,
                           group=group)
    opt_state = adam_init(list(model.parameters()))
    gen = torch.Generator().manual_seed(seed if seed is not None else 0)

    # ----- resume (reference :434-439: the epoch is in the file name) -----
    init_epoch = 0
    last = latest_checkpoint(model_dir)
    if checkpoint is not None and not checkpoint.endswith(".h5"):
        if re.search(r"(\d{3})\.pt$", checkpoint) is None:
            raise ValueError(f"checkpoint '{checkpoint}' is neither a .h5 file nor an "
                             "epoch-numbered '.pt' checkpoint (e.g. '<model_dir>/042.pt')")
        opt_state, init_epoch = restore_checkpoint(checkpoint, model, gen)
    elif last is not None:
        opt_state, init_epoch = restore_checkpoint(
            os.path.join(model_dir, f"{last:03d}.pt"), model, gen)
        log_fn(f"resuming from epoch {init_epoch}")

    # ----- loop: labels-only host stream, GMM params drawn on the device -----
    inputs = PrefetchIterator(build_model_inputs(
        path_label_maps=bg.labels_paths, n_labels=len(generation_labels),
        prior_means=bg.prior_means, prior_stds=bg.prior_stds, path_images=bg.images_paths,
        batchsize=batchsize, rng=bg._rng if seed is not None else None,
        include_gmm_params=False, local_slice=local_slice(group)), buffer_size=4)
    log_path = os.path.join(model_dir, "logs")
    os.makedirs(log_path, exist_ok=True)
    export_h5 = importlib.util.find_spec("h5py") is not None
    if not export_h5:
        log_fn("h5py is not installed: the per-epoch .h5 export is skipped")
    if world > 1:
        log_fn(f"data parallel over {world} ranks, {batchsize // world} examples each")
    loss_curve = []
    guard = FiniteGuard(lag=2)  # the step itself gates its writes on isfinite(loss)
    for epoch in range(init_epoch, epochs):
        t0 = time.time()
        epoch_losses = []
        for step_i in range(steps_per_epoch):
            batch = [torch.as_tensor(np.asarray(a)).to(dev, non_blocking=True)
                     for a in next(inputs)]
            opt_state, loss = step(opt_state, gen, batch)
            guard.push(f"epoch {epoch + 1} step {step_i + 1}", loss)
            epoch_losses.append(loss)
        guard.flush()
        mean_loss = float(np.mean([float(v) for v in epoch_losses]))
        loss_curve.append(mean_loss)
        dt_s = time.time() - t0
        log_fn(f"epoch {epoch + 1}/{epochs}  loss {mean_loss:.5f}  "
               f"({dt_s:.1f}s, {steps_per_epoch / dt_s:.2f} steps/s)")
        if rank == 0:
            with open(os.path.join(log_path, "training_log.jsonl"), "a") as f:
                f.write(json.dumps({"epoch": epoch + 1, "loss": mean_loss,
                                    "seconds": dt_s}) + "\n")
            np.save(os.path.join(log_path, "loss_curve.npy"), np.array(loss_curve))
            save_checkpoint(model_dir, epoch + 1, model, opt_state, gen, export_h5)
    return {"model": model, "opt_state": opt_state, "loss_curve": loss_curve}
