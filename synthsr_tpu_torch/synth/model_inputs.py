"""Host-side input sampler: random label-map pick + GMM prior draws.  The
port's own copy of ``synthsr_tpu/synth/model_inputs.py``.

Re-implementation of ``SynthSR/model_inputs.py:25-139``: an infinite generator
yielding (label_map, means, stds[, real_image]) batches.  Per reference
defaults, class means draw from the hyperprior with centre 125 ± 100 and stds
with 15 ± 10, positive-clipped (:118-121); class draws are expanded to labels
via ``generation_classes`` (:122); multi-channel priors use per-channel 2-row
blocks when the prior array has 2·n_channels rows.  An optional ``rng`` makes
the stream reproducible.
"""

from __future__ import annotations

import numpy as np

from ..io.volume import get_volume_info, load_volume
from ..utils.misc import draw_value_from_distribution


def build_model_inputs(path_label_maps, n_labels, prior_means, prior_stds,
                       prior_distributions="normal", path_images=None,
                       batchsize=1, n_channels=1, generation_classes=None,
                       rng: np.random.Generator | None = None,
                       use_specific_stats_for_channel=None,
                       include_gmm_params=True, local_slice=None):
    """Infinite generator of model inputs (lists stacked to batch arrays).

    ``use_specific_stats_for_channel``: None = SynthSR semantics (a 2n-row
    prior array must have one 2-row block per channel, model_inputs.py:105-116);
    True = the same as the lab2im option (image_generator.py); False = the
    lab2im default, a random modality block is drawn per channel.
    ``include_gmm_params=False`` yields only
    (labels[, image]), for the training path that draws the GMM parameters on
    the device (``synth/sampling.make_gmm_sampler``).

    ``local_slice``: (rank, world size) of a data-parallel run: label-map
    picks and GMM draws are made for the GLOBAL ``batchsize`` from the shared
    seeded stream, but only this rank's contiguous slice of examples is
    loaded and yielded.  Concatenating the ranks' yields in rank order
    reproduces the one-process stream exactly (same rng consumption order),
    so seeded runs do not depend on the world size."""
    _ = get_volume_info(path_label_maps[0])  # validates the first map

    if generation_classes is None:
        generation_classes = np.arange(n_labels)
    generation_classes = np.asarray(generation_classes, np.int32)
    n_classes = len(np.unique(generation_classes))
    rand = rng if rng is not None else np.random.default_rng()

    pid, n_procs = local_slice if local_slice is not None else (0, 1)
    if batchsize % n_procs:
        raise ValueError(f"global batchsize {batchsize} must divide evenly "
                         f"over {n_procs} processes")
    local_bs = batchsize // n_procs
    lo = pid * local_bs

    while True:
        indices = rand.integers(len(path_label_maps), size=batchsize)

        list_label_maps, list_means, list_stds, list_images = [], [], [], []
        for pos, idx in enumerate(indices):
            is_local = lo <= pos < lo + local_bs
            if is_local:
                lab = load_volume(path_label_maps[idx], dtype="int32", aff_ref=np.eye(4))
                list_label_maps.append(lab[None, ..., None])
                if path_images is not None:
                    im = load_volume(path_images[idx], dtype="float", aff_ref=np.eye(4))
                    list_images.append(im[None, ..., None])
            if not include_gmm_params:
                continue

            # GMM draws consume the rng for EVERY global example (stream
            # parity across process counts); only local ones are kept

            means = np.empty((1, n_labels, 0))
            stds = np.empty((1, n_labels, 0))
            for channel in range(n_channels):
                pm, ps = prior_means, prior_stds
                per_channel = use_specific_stats_for_channel in (None, True)
                if isinstance(pm, np.ndarray) and per_channel:
                    if pm.shape[0] / 2 != n_channels:
                        raise ValueError("the number of blocks in prior_means "
                                         "does not match n_channels")
                    pm = pm[2 * channel: 2 * channel + 2, :]
                if isinstance(ps, np.ndarray) and per_channel:
                    if ps.shape[0] / 2 != n_channels:
                        raise ValueError("the number of blocks in prior_stds "
                                         "does not match n_channels")
                    ps = ps[2 * channel: 2 * channel + 2, :]
                cls_means = draw_value_from_distribution(
                    pm, n_classes, prior_distributions, 125.0, 100.0,
                    positive_only=True, rng=rng)
                cls_stds = draw_value_from_distribution(
                    ps, n_classes, prior_distributions, 15.0, 10.0,
                    positive_only=True, rng=rng)
                means = np.concatenate([means, cls_means[generation_classes][None, :, None]],
                                       axis=-1)
                stds = np.concatenate([stds, cls_stds[generation_classes][None, :, None]],
                                      axis=-1)
            if is_local:
                list_means.append(means)
                list_stds.append(stds)

        inputs = [np.concatenate(list_label_maps, 0).astype(np.int32, copy=False)]
        if include_gmm_params:
            inputs += [np.concatenate(list_means, 0).astype(np.float32),
                       np.concatenate(list_stds, 0).astype(np.float32)]
        if path_images is not None:
            inputs.append(np.concatenate(list_images, 0).astype(np.float32))
        yield inputs
