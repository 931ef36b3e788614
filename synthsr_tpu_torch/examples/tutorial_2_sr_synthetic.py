"""Plain SR with synthetic HR targets (the port of
``examples/2_sr_synthetic.py``, reference tutorials/2-SR_synthetic.py)."""

import numpy as np

from ..io.volume import save_volume
from ..synth.brain_generator import BrainGenerator
from .common import (GEN_CLASSES, GEN_LABELS, LABELS, SMOKE_SHAPE, device, out_dir, priors,
                     run_samples)


def main():
    pm, ps = priors("t1_lr")
    gen = BrainGenerator(labels_dir=LABELS, generation_labels=GEN_LABELS,
                         generation_classes=GEN_CLASSES, prior_means=pm, prior_stds=ps,
                         prior_distributions="normal", input_channels=True, output_channel=0,
                         target_res=1.5, output_shape=SMOKE_SHAPE or 128,
                         data_res=np.array([1.0, 1.0, 3.0]), thickness=np.array([1.0, 1.0, 3.0]),
                         downsample=True, build_reliability_maps=True, device=device())
    out = out_dir("2-SR_synthetic")

    def save(n, inputs, target):
        save_volume(inputs[..., 0], gen.aff, None, f"{out}/input_{n}.nii.gz")
        save_volume(target, gen.aff, None, f"{out}/target_{n}.nii.gz")

    run_samples(gen, save)


if __name__ == "__main__":
    main()
