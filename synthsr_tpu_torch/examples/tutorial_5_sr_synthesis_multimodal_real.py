"""Multimodal T1+T2 inputs, a real target and simulated registration error
(the port of ``examples/5_sr_synthesis_multimodal_real.py``, reference
tutorials/5)."""

import numpy as np

from ..io.volume import save_volume
from ..synth.brain_generator import BrainGenerator
from .common import (GEN_CLASSES, GEN_LABELS, LABELS, SMOKE_SHAPE, device, ensure_images,
                     out_dir, priors, run_samples)


def main():
    dev = device()
    images = ensure_images()
    pm = np.concatenate([np.load(priors("t1_lr")[0]), np.load(priors("t2")[0])], 0)
    ps = np.concatenate([np.load(priors("t1_lr")[1]), np.load(priors("t2")[1])], 0)
    gen = BrainGenerator(labels_dir=LABELS, images_dir=images,
                         generation_labels=GEN_LABELS, generation_classes=GEN_CLASSES,
                         prior_means=pm, prior_stds=ps, prior_distributions="normal",
                         input_channels=[True, True], output_channel=None,
                         data_res=np.array([[1.0, 1.0, 3.0], [1.0, 4.5, 1.0]]),
                         thickness=np.array([[1.0, 1.0, 3.0], [1.0, 3.0, 1.0]]),
                         downsample=True, build_reliability_maps=True,
                         simulate_registration_error=True, output_shape=SMOKE_SHAPE,
                         device=dev)
    out = out_dir("5-SR_synthesis_multimodal_real")

    def save(n, inputs, target):
        for c, name in ((0, "t1"), (2, "t2")):
            save_volume(inputs[..., c], gen.aff, None, f"{out}/input_{name}_{n}.nii.gz")
        save_volume(target, gen.aff, None, f"{out}/target_{n}.nii.gz")

    run_samples(gen, save)


if __name__ == "__main__":
    main()
