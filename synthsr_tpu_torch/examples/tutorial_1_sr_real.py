"""Joint SR/synthesis pairs with REAL HR T1 regression targets (the port of
``examples/1_sr_real.py``, reference scripts/tutorials/1-SR_real.py):
synthetic LR-like inputs generated from label maps, spatially augmented
jointly with the real target scans."""

import numpy as np

from ..io.volume import save_volume
from ..synth.brain_generator import BrainGenerator
from .common import (GEN_CLASSES, GEN_LABELS, LABELS, SMOKE_SHAPE, device, ensure_images,
                     out_dir, priors, run_samples)


def main():
    dev = device()
    images = ensure_images()
    pm, ps = priors("t1_hr")
    gen = BrainGenerator(labels_dir=LABELS, images_dir=images,
                         generation_labels=GEN_LABELS, generation_classes=GEN_CLASSES,
                         prior_means=pm, prior_stds=ps, prior_distributions="normal",
                         input_channels=True, output_channel=None,
                         data_res=np.array([1.0, 1.0, 3.0]), thickness=np.array([1.0, 1.0, 3.0]),
                         downsample=True, build_reliability_maps=True, output_shape=SMOKE_SHAPE,
                         device=dev)
    out = out_dir("1-SR_real")

    def save(n, inputs, target):
        save_volume(inputs[..., 0], gen.aff, None, f"{out}/input_{n}.nii.gz")
        save_volume(inputs[..., 1], gen.aff, None, f"{out}/reliability_{n}.nii.gz")
        save_volume(target, gen.aff, None, f"{out}/target_{n}.nii.gz")

    run_samples(gen, save)


if __name__ == "__main__":
    main()
