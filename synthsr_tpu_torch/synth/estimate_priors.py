"""The port's own copy of ``synthsr_tpu/synth/estimate_priors.py``,
held equal to it by ``tests/test_torch_host.py``.

Estimate GMM hyperpriors from (image, segmentation) datasets.

Re-implementation of ``SynthSR/estimate_priors.py``: per-class robust stats
(median + median absolute deviation, normal-consistent scale) from real
images (:76-130), dataset-level aggregation into (2·n_mod, K) prior arrays
(:133-221), the multi-dataset ``build_intensity_stats`` driver (:224-310),
and the ``estimate_t2_cropping`` helper (:27-73).  Pure host/numpy.
"""

from __future__ import annotations

import os

import numpy as np

from ..io.volume import load_volume, mask_volume, rescale_volume
from ..utils.misc import LoopInfo, get_dims, list_images_in_folder, reformat_to_list


def _mad(x):
    from scipy.stats import median_abs_deviation

    # the reference uses scipy's (now removed) median_absolute_deviation,
    # whose default scale was the normal-consistency constant 1.4826
    return median_abs_deviation(x, scale="normal", nan_policy="omit")


def sample_intensity_stats_from_image(image, segmentation, labels_list,
                                      classes_list=None,
                                      keep_strictly_positive=True):
    """(2, K) array of per-class [median; MAD] intensities
    (reference estimate_priors.py:76-130)."""
    labels_list = np.array(reformat_to_list(labels_list, load_as_numpy=True,
                                            dtype="int"))
    if classes_list is not None:
        classes_list = np.array(reformat_to_list(classes_list, load_as_numpy=True,
                                                 dtype="int"))
    else:
        classes_list = np.arange(labels_list.shape[0])
    assert len(classes_list) == len(labels_list), \
        "labels and classes lists should have the same length"

    unique_classes = np.unique(classes_list)
    n_classes = len(unique_classes)
    if not np.array_equal(unique_classes, np.arange(n_classes)):
        raise ValueError("classes_list should contain values in [0, K-1], "
                         f"K={n_classes}")

    means = np.zeros(n_classes)
    stds = np.zeros(n_classes)
    for idx, tmp_class in enumerate(unique_classes):
        class_labels = labels_list[classes_list == tmp_class]
        intensities = np.concatenate(
            [image[segmentation == label] for label in class_labels]
            or [np.empty(0)])
        if tmp_class and keep_strictly_positive:  # background keeps zeros
            intensities = intensities[intensities > 0]
        if len(intensities) != 0:
            means[idx] = np.nanmedian(intensities)
            stds[idx] = _mad(intensities)
    return np.stack([means, stds])


def sample_intensity_stats_from_single_dataset(image_dir, labels_dir, labels_list,
                                               classes_list=None, max_channel=3,
                                               rescale=True):
    """(2·n_channels, K) priors from one dataset: rows are per-channel
    [mean of per-image medians; std of per-image medians] for means and the
    same for MADs (reference :133-221)."""
    path_images = list_images_in_folder(image_dir)
    path_labels = list_images_in_folder(labels_dir)
    assert len(path_images) == len(path_labels), \
        "image and labels folders must have the same number of files"

    labels_list = np.array(reformat_to_list(labels_list, load_as_numpy=True,
                                            dtype="int"))
    if classes_list is not None:
        classes_list = np.array(reformat_to_list(classes_list, load_as_numpy=True,
                                                 dtype="int"))
    else:
        classes_list = np.arange(labels_list.shape[0])
    n_classes = len(np.unique(classes_list))

    im0 = load_volume(path_images[0])
    _, n_channels = get_dims(im0.shape, max_channels=max_channel)

    means = np.zeros((len(path_images), n_classes, n_channels))
    stds = np.zeros((len(path_images), n_classes, n_channels))
    loop_info = LoopInfo(len(path_images), 10, "estimating", print_time=True)
    for idx, (path_im, path_la) in enumerate(zip(path_images, path_labels)):
        loop_info.update(idx)
        image = load_volume(path_im)
        la = load_volume(path_la, dtype="int")
        if n_channels == 1:
            image = image[..., None]
        for ch in range(n_channels):
            im = image[..., ch]
            if rescale:
                im = rescale_volume(im)
            stats = sample_intensity_stats_from_image(im, la, labels_list,
                                                      classes_list=classes_list)
            means[idx, :, ch] = stats[0]
            stds[idx, :, ch] = stats[1]

    mean_means = np.mean(means, axis=0)
    std_means = np.std(means, axis=0)
    mean_stds = np.mean(stds, axis=0)
    std_stds = np.std(stds, axis=0)

    prior_means = np.zeros((2 * n_channels, n_classes))
    prior_stds = np.zeros((2 * n_channels, n_classes))
    for ch in range(n_channels):
        prior_means[2 * ch, :] = mean_means[:, ch]
        prior_means[2 * ch + 1, :] = std_means[:, ch]
        prior_stds[2 * ch, :] = mean_stds[:, ch]
        prior_stds[2 * ch + 1, :] = std_stds[:, ch]
    return prior_means, prior_stds


def build_intensity_stats(list_image_dir, list_labels_dir, result_dir,
                          estimation_labels, estimation_classes=None,
                          max_channel=3, rescale=True):
    """Multi-dataset priors, stacked per modality and saved as
    prior_means.npy / prior_stds.npy (reference :224-310)."""
    list_image_dir = reformat_to_list(list_image_dir)
    list_labels_dir = reformat_to_list(list_labels_dir, length=len(list_image_dir))
    os.makedirs(result_dir, exist_ok=True)

    estimation_labels = np.array(reformat_to_list(estimation_labels,
                                                  load_as_numpy=True, dtype="int"))
    if estimation_classes is not None:
        estimation_classes = np.array(reformat_to_list(estimation_classes,
                                                       load_as_numpy=True,
                                                       dtype="int"))
    else:
        estimation_classes = np.arange(estimation_labels.shape[0])
    n_classes = len(np.unique(estimation_classes))
    if not np.array_equal(np.unique(estimation_classes), np.arange(n_classes)):
        raise ValueError("estimation_classes should contain values in [0, K-1]")

    pm_list, ps_list = [], []
    for image_dir, labels_dir in zip(list_image_dir, list_labels_dir):
        pm, ps = sample_intensity_stats_from_single_dataset(
            image_dir, labels_dir, estimation_labels,
            classes_list=estimation_classes, max_channel=max_channel,
            rescale=rescale)
        pm_list.append(pm)
        ps_list.append(ps)

    prior_means = np.concatenate(pm_list, axis=0)
    prior_stds = np.concatenate(ps_list, axis=0)
    np.save(os.path.join(result_dir, "prior_means.npy"), prior_means)
    np.save(os.path.join(result_dir, "prior_stds.npy"), prior_stds)
    return prior_means, prior_stds


def estimate_t2_cropping(image_dir, result_dir=None, dilation=5):
    """Cropping stats of the T2 (hippocampus) channel (reference :27-73):
    [mean min-crop, std min-crop, mean max-crop, std max-crop], proportional
    to image size along the longest axis."""
    if result_dir is not None:
        os.makedirs(result_dir, exist_ok=True)
    paths = list_images_in_folder(image_dir)
    max_props = np.zeros(len(paths))
    min_props = np.zeros(len(paths))
    loop_info = LoopInfo(len(paths), 10, "processing")
    for idx, path in enumerate(paths):
        loop_info.update(idx)
        im = load_volume(path)
        t2 = im[..., 1]
        shape = t2.shape
        hdim = int(np.argmax(shape))
        _, mask = mask_volume(t2, threshold=0, dilate=dilation, return_mask=True)
        indices = np.nonzero(mask)[hdim]
        min_props[idx] = max(np.min(indices) + int(dilation / 2), 0) / shape[hdim]
        max_props[idx] = min(np.max(indices) - int(dilation / 2), shape[hdim]) / shape[hdim]
    stats = np.array([np.mean(min_props), np.std(min_props),
                      np.mean(max_props), np.std(max_props)])
    if result_dir is not None:
        np.save(os.path.join(result_dir, "t2_cropping_stats.npy"), stats)
    return stats
