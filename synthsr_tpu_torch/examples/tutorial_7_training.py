"""Joint SR + synthesis training at the tutorial-7 configuration (the port of
``examples/7_training.py``, reference tutorials/7): 3 epochs x 5 steps at
128³, or in smoke mode 1 epoch x 2 steps at 32³ (loss crop 24)."""

import numpy as np

from ..train.training import training
from .common import (GEN_CLASSES, GEN_LABELS, LABELS, RESULTS, SMOKE, compute_dtype, device,
                     priors)


def main():
    dev = device()
    contrasts = ("t1_hr", "t1_lr", "t2")
    pm = np.concatenate([np.load(priors(c)[0]) for c in contrasts], 0)
    ps = np.concatenate([np.load(priors(c)[1]) for c in contrasts], 0)
    training(labels_dir=LABELS, model_dir=f"{RESULTS}/7-training",
             prior_means=pm, prior_stds=ps, path_generation_labels=GEN_LABELS,
             path_generation_classes=GEN_CLASSES, prior_distributions="normal",
             input_channels=[False, True, True], output_channel=0,
             work_with_residual_channel=1, output_shape=32 if SMOKE else 128,
             data_res=np.array([[1.0, 1.0, 3.0], [1.0, 4.5, 1.0]]),
             thickness=np.array([[1.0, 1.0, 3.0], [1.0, 3.0, 1.0]]),
             downsample=True, build_reliability_maps=True, flipping=True,
             scaling_bounds=0.1, rotation_bounds=8, shearing_bounds=0.01,
             translation_bounds=False, nonlin_std=2.0, bias_field_std=0.2,
             loss_cropping=24 if SMOKE else 96, epochs=1 if SMOKE else 3,
             steps_per_epoch=2 if SMOKE else 5, lr=1e-4, compute_dtype=compute_dtype(dev),
             device=dev)


if __name__ == "__main__":
    main()
