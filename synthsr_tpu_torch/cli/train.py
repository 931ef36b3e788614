"""Train CLI on PyTorch: the port of ``synthsr_tpu/cli/train.py`` (reference
``scripts/training.py:21-93``), with the same flags and the same polymorphic
``infer`` coercion (str -> float / bool / str) for flags that take numbers,
paths or False.  Trains on the GPU unless ``--cpu`` is given; a missing GPU
raises.

    python -m synthsr_tpu_torch.cli.train labels_dir model_dir \\
        prior_means.npy prior_stds.npy generation_labels.npy [options]
"""

from __future__ import annotations

import argparse

from synthsr_tpu.utils.misc import infer


def build_arg_parser():
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    # positional
    p.add_argument("labels_dir", help="folder of training label maps")
    p.add_argument("model_dir", help="folder where models and logs are saved")
    p.add_argument("prior_means", type=infer, help="hyperprior for GMM means (.npy or value)")
    p.add_argument("prior_stds", type=infer, help="hyperprior for GMM stds (.npy or value)")
    p.add_argument("path_generation_labels", help="labels used for generation (.npy)")
    # generation
    p.add_argument("--images_dir", default=None)
    p.add_argument("--path_generation_classes", default=None)
    p.add_argument("--prior_distributions", default="normal")
    p.add_argument("--no_fs_sort", action="store_false", dest="FS_sort")
    p.add_argument("--batchsize", type=int, default=1)
    p.add_argument("--input_channels", type=infer, nargs="+", default=True)
    p.add_argument("--output_channel", type=infer, nargs="+", default=0)
    p.add_argument("--target_res", type=infer, default=None)
    p.add_argument("--output_shape", type=infer, default=None)
    p.add_argument("--no_flipping", action="store_false", dest="flipping")
    p.add_argument("--padding_margin", type=infer, default=None)
    # spatial augmentation
    p.add_argument("--scaling_bounds", type=infer, default=0.15)
    p.add_argument("--rotation_bounds", type=infer, default=15)
    p.add_argument("--shearing_bounds", type=infer, default=0.02)
    p.add_argument("--translation_bounds", type=infer, default=5)
    p.add_argument("--nonlin_std", type=float, default=4.0)
    p.add_argument("--nonlin_shape_factor", type=float, default=0.03125)
    p.add_argument("--no_registration_error", action="store_false",
                   dest="simulate_registration_error")
    # acquisition simulation
    p.add_argument("--randomise_res", action="store_true", default=None)
    p.add_argument("--data_res", type=infer, default=None)
    p.add_argument("--thickness", type=infer, default=None)
    p.add_argument("--no_downsample", action="store_false", dest="downsample")
    p.add_argument("--blur_range", type=float, default=1.15)
    p.add_argument("--no_reliability_maps", action="store_false", dest="build_reliability_maps")
    p.add_argument("--bias_field_std", type=float, default=0.3)
    p.add_argument("--bias_shape_factor", type=float, default=0.03125)
    # architecture
    p.add_argument("--n_levels", type=int, default=5)
    p.add_argument("--nb_conv_per_level", type=int, default=2)
    p.add_argument("--conv_size", type=int, default=3)
    p.add_argument("--unet_feat_count", type=int, default=24)
    p.add_argument("--feat_multiplier", type=int, default=2)
    p.add_argument("--dropout", type=float, default=0)
    p.add_argument("--activation", default="elu")
    # training
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--lr_decay", type=float, default=0)
    p.add_argument("--epochs", type=int, default=100)
    p.add_argument("--steps_per_epoch", type=int, default=1000)
    p.add_argument("--regression_metric", default="l1", choices=["l1", "l2", "ssim", "laplace"])
    p.add_argument("--work_with_residual_channel", type=infer, nargs="+", default=None)
    p.add_argument("--loss_cropping", type=infer, default=None)
    p.add_argument("--checkpoint", default=None)
    p.add_argument("--different_lhood_layer", action="store_true",
                   dest="model_file_has_different_lhood_layer")
    # segmentation regulariser
    p.add_argument("--segmentation_label_list", default=None)
    p.add_argument("--segmentation_label_equivalency", default=None)
    p.add_argument("--segmentation_model_file", default=None)
    p.add_argument("--fs_header_segnet", action="store_true")
    p.add_argument("--relative_weight_segmentation", type=float, default=0.25)
    # backend
    p.add_argument("--n_devices", type=int, default=None)
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--compute_dtype", default="bfloat16", choices=["bfloat16", "float32"])
    p.add_argument("--cpu", action="store_true", help="train on the CPU instead of the GPU")
    return p


_INDEX_FLAGS = ("output_channel", "work_with_residual_channel", "output_shape",
                "loss_cropping", "padding_margin")


def _int_if_integral(v):
    if isinstance(v, list):
        return [_int_if_integral(x) for x in v]
    return int(v) if isinstance(v, float) and v.is_integer() else v


def main(argv=None, log_fn=print):
    args = vars(build_arg_parser().parse_args(argv))
    # infer() makes every number a float; channel indices and shapes are ints
    # (the JAX CLI passes them on as floats, and float indices fail)
    for k in _INDEX_FLAGS:
        args[k] = _int_if_integral(args[k])
    # scalars passed through nargs="+" arrive as 1-lists
    for k in ("input_channels", "output_channel", "work_with_residual_channel"):
        v = args[k]
        if isinstance(v, list) and len(v) == 1:
            args[k] = v[0]
    from ..train.training import training

    return training(device="cpu" if args.pop("cpu") else None, log_fn=log_fn, **args)


if __name__ == "__main__":
    main()
