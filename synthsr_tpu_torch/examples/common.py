"""Shared paths and settings of the tutorial entry points: the port of
``examples/common.py`` (the reference's scripts/tutorials).

- ``SYNTHSR_DATA``: a directory holding ``labels/`` (and ``images/`` for the
  real-target tutorials) and ``labels_classes_priors/`` (the generation
  labels and classes and the ``prior_{means,stds}_{t1_hr,t1_lr,t2}.npy``
  priors); by default ``data``, the reference repository's asset folder,
  relative to the working directory;
- ``SYNTHSR_RESULTS``: where the tutorials write (``./generated_examples``);
- ``SYNTHSR_SMOKE=1``: a fast run (one sample, 64³ crops, the training
  tutorials cut to one short epoch at 32³);
- ``SYNTHSR_DEVICE``: ``cuda`` (the default; raises without a GPU) or
  ``cpu``.

When ``images/`` is missing (the reference ships the paired real images
through git-LFS), :func:`ensure_images` synthesizes GMM stand-in T1 volumes
from the label maps and the shipped priors, so tutorials 1, 3, 5 and 8 run.
"""

from __future__ import annotations

import os

import numpy as np
import torch

DATA = os.environ.get("SYNTHSR_DATA", "data")
LABELS = os.path.join(DATA, "labels")
IMAGES = os.path.join(DATA, "images")
PRIORS = os.path.join(DATA, "labels_classes_priors")
RESULTS = os.environ.get("SYNTHSR_RESULTS", "./generated_examples")

GEN_LABELS = os.path.join(PRIORS, "generation_labels.npy")
GEN_CLASSES = os.path.join(PRIORS, "generation_classes.npy")

SMOKE = bool(int(os.environ.get("SYNTHSR_SMOKE", "0")))
N_SAMPLES = 1 if SMOKE else 3
SMOKE_SHAPE = 64 if SMOKE else None  # None = tutorial default (full volume)

# write_synthetic_data's label values (FreeSurfer left/right pairs) and classes
SYNTHETIC_LABELS = np.array([0, 2, 3, 4, 41, 42, 43], np.int32)
SYNTHETIC_CLASSES = np.array([0, 1, 2, 3, 1, 2, 3], np.int32)


def device() -> str:
    """``SYNTHSR_DEVICE`` (default ``cuda``); raises when it names a GPU that
    is not there."""
    dev = os.environ.get("SYNTHSR_DEVICE", "cuda")
    if dev not in ("cuda", "cpu"):
        raise ValueError(f"SYNTHSR_DEVICE must be cuda or cpu, got {dev!r}")
    if dev == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device available; set SYNTHSR_DEVICE=cpu to run on the CPU")
    return dev


def compute_dtype(dev: str) -> str:
    """The training tutorials' compute dtype: bfloat16 on the GPU (the
    kernels' path), float32 on the CPU, where bf16 convolutions are slow."""
    return "bfloat16" if dev == "cuda" else "float32"


def priors(contrast):
    return (os.path.join(PRIORS, f"prior_means_{contrast}.npy"),
            os.path.join(PRIORS, f"prior_stds_{contrast}.npy"))


def out_dir(name: str) -> str:
    path = os.path.join(RESULTS, name)
    os.makedirs(path, exist_ok=True)
    return path


def ensure_images():
    """A directory of HR T1 images paired (by sorted order) with the label
    maps: ``data/images`` when present, else synthesized GMM stand-ins (per
    class t1_hr prior means + noise + light smoothing)."""
    from scipy.ndimage import gaussian_filter

    from ..io.volume import load_volume, save_volume
    from ..utils.misc import list_images_in_folder

    def listing(d):
        try:
            return list_images_in_folder(d)
        except RuntimeError:  # raises on empty dirs
            return []

    if os.path.isdir(IMAGES) and listing(IMAGES):
        return IMAGES
    standin = os.path.join(RESULTS, "_standin_images")
    labels = list_images_in_folder(LABELS)
    os.makedirs(standin, exist_ok=True)
    if len(listing(standin)) == len(labels):
        return standin
    gen_labels = np.load(GEN_LABELS)
    gen_classes = np.load(GEN_CLASSES)
    means = np.load(priors("t1_hr")[0])[0]  # class means row
    lut = np.zeros(int(gen_labels.max()) + 1, np.float32)
    lut[gen_labels] = means[gen_classes]
    rng = np.random.default_rng(0)
    for p in labels:
        lab, aff, h = load_volume(p, im_only=False, dtype="int32")
        lab = np.clip(lab, 0, len(lut) - 1)
        im = lut[lab] + rng.normal(0, 6.0, lab.shape).astype(np.float32)
        im = gaussian_filter(im, 0.6) * (lab > 0)
        name = os.path.basename(p).replace("_labels", "")
        save_volume(im.astype(np.float32), aff, h, os.path.join(standin, name))
    return standin


def run_samples(gen, save):
    """Draw ``N_SAMPLES`` examples from ``gen`` (a ``BrainGenerator``) and
    hand each to ``save(n, inputs, target)``."""
    import time

    for n in range(N_SAMPLES):
        t0 = time.time()
        inputs, target = gen.generate_brain()
        print(f"sample {n}: {time.time() - t0:.2f}s shapes {inputs.shape} {target.shape}")
        save(n, inputs, target)


def write_synthetic_data(root, n_maps=2, shape=(40, 40, 40), seed=0):
    """Write a seeded synthetic ``SYNTHSR_DATA`` tree under ``root``:
    ``labels/`` (nested boxes split into left and right label values) and
    ``labels_classes_priors/`` (generation labels and classes, and
    per-contrast (2, n_classes) normal priors), for runs without the
    reference's data."""
    from ..io.volume import save_volume

    rng = np.random.default_rng(seed)
    lab_dir = os.path.join(root, "labels")
    pri = os.path.join(root, "labels_classes_priors")
    os.makedirs(lab_dir)
    os.makedirs(pri)
    for i in range(n_maps):
        lab = np.zeros(shape, np.int32)
        c = [s // 2 + int(rng.integers(-2, 3)) for s in shape]
        for k, (left, right) in enumerate(((2, 41), (3, 42), (4, 43))):
            r = int(min(shape) * (0.4 - 0.125 * k))
            box = tuple(slice(ci - r, ci + r) for ci in c)
            half = np.zeros(shape, bool)
            half[box] = True
            lab[half] = left
            lab[half & (np.arange(shape[0]) >= c[0])[:, None, None]] = right
        save_volume(lab, np.eye(4), None, os.path.join(lab_dir, f"subject{i}_labels.nii.gz"))
    np.save(os.path.join(pri, "generation_labels.npy"), SYNTHETIC_LABELS)
    np.save(os.path.join(pri, "generation_classes.npy"), SYNTHETIC_CLASSES)
    for name, base in (("t1_hr", 80.0), ("t1_lr", 70.0), ("t2", 60.0)):
        means = np.stack([base + 30.0 * np.arange(4), np.full(4, 5.0)]).astype(np.float32)
        means[0, 0] = 0.0
        stds = np.stack([np.full(4, 6.0), np.full(4, 1.0)]).astype(np.float32)
        np.save(os.path.join(pri, f"prior_means_{name}.npy"), means)
        np.save(os.path.join(pri, f"prior_stds_{name}.npy"), stds)
