"""Diffusion-MRI (log-tensor) SR training (the port of
``examples/9_log_tensor_diffusion.py``, reference scripts/logTensorSRtest.py).

Eight input channels (six 2.5 mm log-tensor components + 1 mm T1 + T2, the
two structural channels with simulated registration error), six regression
targets trained as residual channels, no flipping (DTI has no left/right
intensity symmetry), no bias field.  The reference's priors for the
log-tensor channels live on a private cluster; this tutorial builds stand-in
8-channel priors from the shipped t1/t2 stats so the configuration runs
anywhere.
"""

import numpy as np

from ..train.training import training
from .common import (GEN_CLASSES, GEN_LABELS, LABELS, RESULTS, SMOKE, compute_dtype, device,
                     priors)


def main():
    dev = device()
    t1m, t1s = (np.load(p) for p in priors("t1_hr"))
    t2m, t2s = (np.load(p) for p in priors("t2"))
    # stand-in per-channel GMM stats: six pseudo log-tensor channels (scaled,
    # offset t1 stats so each channel draws a distinct contrast) + real t1/t2
    rng = np.random.default_rng(0)
    scales = (0.35, 0.3, 0.3, 0.25, 0.25, 0.2)
    chan_means = [t1m * s + o for s, o in zip(scales, rng.uniform(2.0, 12.0, 6))] + [t1m, t2m]
    chan_stds = [t1s * s for s in scales] + [t1s, t2s]
    pm, ps = np.concatenate(chan_means, 0), np.concatenate(chan_stds, 0)
    training(labels_dir=LABELS, model_dir=f"{RESULTS}/9-log-tensor",
             prior_means=pm, prior_stds=ps * 0.5, path_generation_labels=GEN_LABELS,
             path_generation_classes=GEN_CLASSES, prior_distributions="normal",
             batchsize=1, input_channels=[True] * 8, output_channel=[0, 1, 2, 3, 4, 5],
             work_with_residual_channel=[0, 1, 2, 3, 4, 5], target_res=None,
             output_shape=32 if SMOKE else 64, loss_cropping=24 if SMOKE else 56,
             flipping=False, bias_field_std=0.0, scaling_bounds=0.1, rotation_bounds=5,
             shearing_bounds=0.01, translation_bounds=False, nonlin_std=2.0,
             simulate_registration_error=[False] * 6 + [True, True],
             data_res=np.array([[2.5] * 3] * 6 + [[1.0] * 3] * 2),
             thickness=np.array([[2.5] * 3] * 6 + [[1.0] * 3] * 2),
             downsample=True, build_reliability_maps=False, blur_range=1.15,
             n_levels=5, nb_conv_per_level=2, conv_size=3, unet_feat_count=24,
             feat_multiplier=2, dropout=0, activation="elu", lr=1e-4, lr_decay=0,
             regression_metric="l1", FS_sort=False, epochs=1 if SMOKE else 2,
             steps_per_epoch=2 if SMOKE else 5, compute_dtype=compute_dtype(dev), device=dev)


if __name__ == "__main__":
    main()
