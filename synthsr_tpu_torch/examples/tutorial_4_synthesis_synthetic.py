"""T2 -> T1 synthesis with synthetic targets (the port of
``examples/4_synthesis_synthetic.py``, reference tutorials/4)."""

import numpy as np

from ..io.volume import save_volume
from ..synth.brain_generator import BrainGenerator
from .common import (GEN_CLASSES, GEN_LABELS, LABELS, SMOKE_SHAPE, device, out_dir, priors,
                     run_samples)


def main():
    pm_t2, ps_t2 = priors("t2")
    pm_t1, ps_t1 = priors("t1_hr")
    pm = np.concatenate([np.load(pm_t1), np.load(pm_t2)], 0)
    ps = np.concatenate([np.load(ps_t1), np.load(ps_t2)], 0)
    gen = BrainGenerator(labels_dir=LABELS, generation_labels=GEN_LABELS,
                         generation_classes=GEN_CLASSES, prior_means=pm, prior_stds=ps,
                         prior_distributions="normal", input_channels=[False, True],
                         output_channel=0, output_shape=SMOKE_SHAPE or 128, randomise_res=True,
                         build_reliability_maps=True, device=device())
    out = out_dir("4-synthesis_synthetic")

    def save(n, inputs, target):
        save_volume(inputs[..., 0], gen.aff, None, f"{out}/input_t2_{n}.nii.gz")
        save_volume(target, gen.aff, None, f"{out}/target_t1_{n}.nii.gz")

    run_samples(gen, save)


if __name__ == "__main__":
    main()
