"""Multimodal inputs with a synthetic target channel (the port of
``examples/6_sr_synthesis_multimodal_synthetic.py``, reference tutorials/6)."""

import numpy as np

from ..io.volume import save_volume
from ..synth.brain_generator import BrainGenerator
from .common import (GEN_CLASSES, GEN_LABELS, LABELS, SMOKE_SHAPE, device, out_dir, priors,
                     run_samples)


def main():
    contrasts = ("t1_hr", "t1_lr", "t2")
    pm = np.concatenate([np.load(priors(c)[0]) for c in contrasts], 0)
    ps = np.concatenate([np.load(priors(c)[1]) for c in contrasts], 0)
    gen = BrainGenerator(labels_dir=LABELS, generation_labels=GEN_LABELS,
                         generation_classes=GEN_CLASSES, prior_means=pm, prior_stds=ps,
                         prior_distributions="normal", input_channels=[False, True, True],
                         output_channel=0, output_shape=SMOKE_SHAPE or 128,
                         data_res=np.array([[1.0, 1.0, 3.0], [1.0, 4.5, 1.0]]),
                         thickness=np.array([[1.0, 1.0, 3.0], [1.0, 3.0, 1.0]]),
                         downsample=True, build_reliability_maps=True, device=device())
    out = out_dir("6-SR_synthesis_multimodal_synthetic")

    def save(n, inputs, target):
        save_volume(target, gen.aff, None, f"{out}/target_{n}.nii.gz")

    run_samples(gen, save)


if __name__ == "__main__":
    main()
