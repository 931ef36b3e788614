"""Contrast synthesis with real targets and a RANDOM acquisition resolution
(the port of ``examples/3_synthesis_real.py``, reference
tutorials/3-synthesis_real.py)."""

from ..io.volume import save_volume
from ..synth.brain_generator import BrainGenerator
from .common import (GEN_CLASSES, GEN_LABELS, LABELS, SMOKE_SHAPE, device, ensure_images,
                     out_dir, priors, run_samples)


def main():
    dev = device()
    images = ensure_images()
    pm, ps = priors("t2")
    gen = BrainGenerator(labels_dir=LABELS, images_dir=images,
                         generation_labels=GEN_LABELS, generation_classes=GEN_CLASSES,
                         prior_means=pm, prior_stds=ps, prior_distributions="normal",
                         input_channels=True, output_channel=None, randomise_res=True,
                         build_reliability_maps=True, output_shape=SMOKE_SHAPE, device=dev)
    out = out_dir("3-synthesis_real")

    def save(n, inputs, target):
        save_volume(inputs[..., 0], gen.aff, None, f"{out}/input_{n}.nii.gz")
        save_volume(target, gen.aff, None, f"{out}/target_{n}.nii.gz")

    run_samples(gen, save)


if __name__ == "__main__":
    main()
