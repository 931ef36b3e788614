"""GPU smoke run of the PyTorch port: builds the hand-written CUDA kernels,
holds each against its plain PyTorch version (and times the one PyTorch call
that computes the same function, and the card's bound) at the shapes of the
port's main paths: H-first-mma, H-fwd-wg (wgmma and TMA, timed in turns
with H-fwd-mma at every row its gate gives it: every conv of the 256³
predict pass, whose Σ launches × ms is printed beside the network's time),
H-wgrad-wg (wgmma and TMA, timed in turns with H-wgrad-mma at every row its
gate gives it: every weight gradient of the train step, whose Σ launches ×
ms is printed for both), H-fwd-mma and H-wgrad-mma in bf16, and the
split-TF32 tensor-core H-first-x3, H-fwd-x3 and H-wgrad-x3 in float32.  Then
it drives each path at full width (24 features, 5 levels, seeded random
weights and data):

- predict: ``synthsr_tpu_torch.cli.predict.main`` with flip TTA over three
  synthetic volumes, and the fast network against the plain float32 forward;
  then one volume through ``Predictor(compute_dtype="float32")``, the path of
  the float32 kernels;
- predict at a large field of view: ``cli.predict.main`` on a 1 mm CT
  phantom of 180x250x500 voxels (padded to 192x256x512, the shape whose
  level-0 24->24 conv only the TPU's blocked kernel K5 served);
- Hyperfine: ``cli.predict_hyperfine.main`` on two synthetic 1.5x1.5x5 mm
  T1/T2 pairs, one T2 oblique, and its residual network against the plain
  float32 forward;
- train: ``synthsr_tpu_torch.cli.train.main`` at the tutorial-7 configuration
  of ``bench_train.py`` (128³, 4 input channels, bf16) on seeded synthetic
  label maps, 2 epochs x 3 steps then a resume to epoch 3, one step's
  gradients against the plain float32 autograd of ``UNet3D.forward_train``,
  and the time of consecutive warm steps; then 2 steps with
  ``--compute_dtype float32``, the path of the float32 kernels;
- adversarial: ``synthsr_tpu_torch.train.adversarial.training`` (WGAN-GP
  fine-tuning) at ``bench_adversarial.py``'s configuration (a 24-feature
  generator, a 32-filter 4-level critic, 128³, bf16) on the same label maps,
  1 epoch x 2 steps then a resume to epoch 2, one critic update's loss and
  gradient against plain float32 double autograd, where a 10:1 cycle's time
  goes and the time of warm cycles; then one float32 step at 64³;
- the rest of the training path: ``cli.train.main`` at batch 2 with a frozen
  segmenter (remat "levels" by default) and a resume, one such step against
  plain float32 autograd and with remat=False (equal; peak memory and time,
  the segmenter's share); a train step and a 10:1 cycle in a one-rank NCCL
  group against no group (equal); one adversarial cycle with the segmenter;
  one plain float32 step of three U-Net options against the same step on
  the CPU; the fast forward of a 3-label softmax net against plain float32;
- the rest of the port: the halo-sharded forward (256³, full width) and one
  halo train step (128³) in a one-rank NCCL group against the plain float32
  forward and step; the auto-encoder and the VAE at 128³ on the card
  against the CPU; lab2im's ``ImageGenerator`` on the 160³ label maps
  (timed with ``utils/profiling.StepTimer``, one sample under its
  ``trace``); random dilation and erosion against scipy; the C++ NIfTI
  loader against the numpy path; the tutorial entry points in smoke mode;
- the port's last surface: ``mimic_acquisition`` with noise on the
  acquisition grid at the adversarial generator's 128^3 shape and the
  boundary-weighted Dice on 2-D maps, each on the card against the CPU, and
  ``BrainGenerator`` built without ``device=`` (the card by default).

    python3 chip_smoke.py

Needs one CUDA GPU and ``nvcc``; imports nothing of JAX.  Exits non-zero on
any failure, and prints as its last line
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Every comparison with a plain version runs it in float32 with TF32 off.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

KERNEL_BOUND = 1e-2   # max|kernel - plain| / max|plain|, bf16 output (2^-8 rounding)
HEAD_BOUND = 1e-4     # the same for the f32 head output (sum order only)
WGRAD_BOUND = 1e-4    # the same for H-wgrad-wg / -mma: f32 sums of bf16 products (order only)
F32_BOUND = 1e-5      # the same for the float32 kernels (order; split TF32's ~2^-22)
NET_BOUND = 2e-2      # relative L2, bf16 fast TTA network output vs plain f32
NET_F32_BOUND = 1e-4  # the same for the float32 fast network (sum order only)
GRAD_BOUND = 5e-2     # relative L2, one train step's bf16 kernel-path gradient vs plain f32
# the same for each 3³ conv's weight gradient on its own: the whole-gradient
# bound is dominated by the largest leaves, while a wrong dw or dx at any one
# conv puts an error of order 1 into that conv's leaf (and those before it)
LEAF_BOUND = 0.15
LOSS_BOUND = 1e-2     # relative difference of that step's loss
# the critic update's loss -D(target) + D(fake) + GP is a small difference of
# two scores of tens: each score is held as a network output (NET_BOUND, the
# pair's relative L2), the penalty and the loss by LOSS_BOUND, the loss's
# difference over the sum of its terms' magnitudes
WARM_STEPS = 12       # consecutive warm train steps timed with CUDA events
# adversarial fine-tuning at bench_adversarial.py:55-88's configuration: the
# generator's synthesis (1 input channel, output_channel [0], 128^3) with
# train/adversarial.training's defaults for the arguments the benchmark leaves
# out; a 24-feature 5-level ELU generator, a 32-filter 4-level critic, batch 1,
# bf16, loss_cropping 96
ADV_CONFIG = dict(input_channels=[True], output_channel=[0], output_shape=128, flipping=True,
                  scaling_bounds=0.2, rotation_bounds=20, shearing_bounds=0.03,
                  translation_bounds=5, nonlin_std=5.0, nonlin_shape_factor=0.04,
                  randomise_res=True, downsample=True, build_reliability_maps=False,
                  bias_field_std=0.4, bias_shape_factor=0.04, blur_range=1.03,
                  simulate_registration_error=False)
ADV_RATIO = 10        # critic updates per generator update (training_ratio)
ADV_FIRST_RATIO = 10  # first_training_ratio: 100 in the configuration, cut for the time limit
ADV_CYCLES = 5        # warm 10:1 cycles timed with CUDA events
# the bound: the larger of the operations over the H100 SXM's peak for their
# type and the bytes (each input read once, each output written once) over its
# memory rate (NVIDIA's data sheet, at the full 700 W power limit).  bf16:
# dense on the tensor cores.  float32: the least time for float32-accurate
# work is split TF32 on the tensor cores, three TF32 products per product at
# 495 TFLOP/s dense, so 495 / 3 = 165 TFLOP/s (the CUDA cores' float32 FMA
# peak, 67 TFLOP/s, is below it)
PEAK_FLOPS = 989e12
PEAK_F32_FLOPS = 495e12 / 3
PEAK_BYTES = 3.35e12
FIRST_X3_SOURCE = "synthsr_tpu_torch/csrc/conv3d_first_x3.cu"
X3_SOURCE = "synthsr_tpu_torch/csrc/conv3d_fwd_x3.cu"
WGRAD_X3_SOURCE = "synthsr_tpu_torch/csrc/conv3d_wgrad_x3.cu"
MMA_SOURCE = "synthsr_tpu_torch/csrc/conv3d_fwd_mma.cu"
WG_SOURCE = "synthsr_tpu_torch/csrc/conv3d_fwd_wg.cu"
FIRST_MMA_SOURCE = "synthsr_tpu_torch/csrc/conv3d_first_mma.cu"
WGRAD_MMA_SOURCE = "synthsr_tpu_torch/csrc/conv3d_wgrad_mma.cu"
WGRAD_WG_SOURCE = "synthsr_tpu_torch/csrc/conv3d_wgrad_wg.cu"
PALLAS = "synthsr_tpu/ops/conv_pallas.py"
NO_LAUNCHES = {"first_x3": 0, "first_mma": 0, "fwd_mma": 0, "wgrad_mma": 0, "fwd_x3": 0,
               "wgrad_x3": 0, "fwd_wg": 0, "wgrad_wg": 0}
# Every bf16 conv below that is not a first conv takes H-fwd-wg
# (conv_cf.fwd_wg_ok: C_out % 8 == 0, no accum) but the critic's 32->1
# input gradient (C_out 1), which takes H-fwd-mma; every bf16 weight gradient
# takes H-wgrad-wg (conv_cf.wgrad_wg_ok: W >= 8; the penalty's 32->1 runs
# mirrored, as (1,32)) but the tutorials' 4^3 and 2^3 levels, which take
# H-wgrad-mma.
# kernel launches per train step of the shipped net (4 input channels, so no
# first-conv kernel): 18 forward convs + 17 input gradients (not the first conv's) on
# H-fwd-wg; 18 weight gradients + 4 for the decoders' second sources on
# H-wgrad-wg; in float32 the same counts on H-fwd-x3 and H-wgrad-x3
TRAIN_LAUNCHES = {**NO_LAUNCHES, "fwd_wg": 35, "wgrad_wg": 22}
TRAIN_F32_LAUNCHES = {**NO_LAUNCHES, "fwd_x3": 35, "wgrad_x3": 22}
TRAIN_F32_STEPS = 2
# kernel launches of one critic update: the generator's fake (1 first_mma + 17
# fwd_wg); the critic's first conv on target and fake (2 first_mma) and its
# weight gradients (2 wgrad_wg; the input is detached: no dx); the gradient
# penalty's program, forward: 4 stride-1 trunk convs (1 first_mma + 3 fwd_wg)
# and 4 transposed convs (3 fwd_wg, and the 32->1 on fwd_mma), backward: those
# transposed convs' dx (1 first_mma for 1->32, 3 fwd_wg) and weight gradients
# (4 wgrad_wg); the trunk gets no gradient from the penalty (LeakyReLU's
# slope is piecewise constant)
ADV_DISC_LAUNCHES = {**NO_LAUNCHES, "first_mma": 5, "fwd_wg": 26, "fwd_mma": 1, "wgrad_wg": 6}
# of one generator update: the train forward (1 first_mma + 17 fwd_wg) and
# backward (17 dx fwd_wg, 22 wgrad_wg); the critic's first conv on the fake
# (1 first_mma) and its dx, 32->1 (1 fwd_mma; the critic is frozen: no wgrad)
ADV_GEN_LAUNCHES = {**NO_LAUNCHES, "first_mma": 2, "fwd_wg": 34, "fwd_mma": 1, "wgrad_wg": 22}
# per 10:1 cycle; the float32 run (one critic and one generator update) takes
# the same counts on H-first-x3, H-fwd-x3 and H-wgrad-x3
ADV_LAUNCHES = {k: ADV_RATIO * ADV_DISC_LAUNCHES[k] + ADV_GEN_LAUNCHES[k] for k in NO_LAUNCHES}
ADV_F32_LAUNCHES = {**NO_LAUNCHES, "first_x3": 7, "fwd_x3": 62, "wgrad_x3": 28}
# per train step at batch 2 with remat "levels" (the default at 2 examples a
# rank): per example 18 forward convs, run again by the recomputation of the
# backward pass (every conv sits in a checkpointed level), 17 input gradients
# and 22 weight gradients; the frozen segmenter's convs are cuDNN's.  Counted
# on the CPU with the dispatch gate mirrored (each would-be launch is one call
# of the plain version); with remat=False 36 + 34 on H-fwd-wg
SEG_TRAIN_LAUNCHES = {**NO_LAUNCHES, "fwd_wg": 106, "wgrad_wg": 44}
SEG_TRAIN_STEPS = 2   # steps per epoch of the segmenter run (1 epoch + a resume to 2)
SEG_STEP_REPS = 3     # timed rounds of the segmenter step's remat variants, in turns
# a fast forward with a 3-label softmax head: the shipped net's 1 + 17 convs;
# the likelihood runs after the last conv in float32 (it cannot fold)
HEAD3_LAUNCHES = {**NO_LAUNCHES, "first_mma": 1, "fwd_wg": 17}
# U-Net options that train on the plain path (cuDNN), one step each at 64^3
# in float32 against the same step on the CPU
OPTIONS = [("residual levels, dilation 2", dict(use_residuals=True, dilation_rate_mult=2)),
           ("dropout 0.2 (pre-drawn masks)", dict(conv_dropout=0.2)),
           ("conv_size 5", dict(conv_size=5))]
CPU_BOUND = 1e-4      # relative, the card's float32 step vs the CPU's (options_phase)
REMAT_BOUND = 1e-6    # relative, a step with remat "levels" vs without (the kernels repeat)

# (name, kernel, source channels, cout, spatial, fused epilogue, dtype)
BF16, F32 = torch.bfloat16, torch.float32

# the rest of the port (halo sharding, auto-encoder, lab2im, label ops, native
# loader, profiling, tutorials)
HALO_FWD_SIZE = 256   # the sharded forward at full width vs the plain float32 forward
HALO_FWD_BOUND = 1e-5  # relative L2 (float32 summation order only)
HALO_STEP_SIZE = 128  # one halo train step (tutorial-7 architecture, float32, SGD)
HALO_LOSS_RTOL, HALO_PARAM_ATOL = 1e-5, 5e-5
AE_SIZE = 128         # auto-encoder and VAE on the card vs the CPU
AE_BOUND = 1e-4       # relative L2, float32 card (TF32 off) vs CPU
LAB2IM_SAMPLES = 5    # timed ImageGenerator samples on the 160^3 label maps
TUTORIAL_LIMIT_S = 90.0  # all nine tutorials in smoke mode (6.3-7.9 s on an H100)
TUTORIAL_MAP = 96     # the tutorials' synthetic label maps (96^3; 64^3 smoke crops)
# the port's last surface (surface_phase): the card against the CPU on the same draws
SURFACE_BOUND = 1e-5  # relative L2 (float32 summation order only)
ACQ_NOISE_STD = 0.05  # the acquisition noise's largest std, on intensities in [0, 1)
DICE_SHAPE = (4, 256, 256, 8)  # a batch of 2-D one-hot maps: B, H, W, labels
TUTORIALS = ("tutorial_1_sr_real", "tutorial_2_sr_synthetic", "tutorial_3_synthesis_real",
             "tutorial_4_synthesis_synthetic", "tutorial_5_sr_synthesis_multimodal_real",
             "tutorial_6_sr_synthesis_multimodal_synthetic", "tutorial_8_estimate_priors",
             "tutorial_7_training", "tutorial_9_log_tensor_diffusion")
SHAPES = [
    ("1->24 @256^3", "first_mma", (1,), 24, (256, 256, 256), "bias+elu", BF16),
    ("2->24 @256^3", "first_mma", (2,), 24, (256, 256, 256), "bias+elu", BF16),
    # Hyperfine's first conv at its padded 192x256x160 (W = 160: five 32-wide tiles)
    ("2->24 @192x256x160", "first_mma", (2,), 24, (192, 256, 160), "bias+elu", BF16),
    ("24->24 @256^3", "fwd_wg", (24,), 24, (256, 256, 256), "bias+elu", BF16),
    ("[24,48]->24 @256^3", "fwd_wg", (24, 48), 24, (256, 256, 256), "bias+elu", BF16),
    ("24->24 @256^3 +post+head", "fwd_wg", (24,), 24, (256, 256, 256), "bias+elu+post+head",
     BF16),
    ("4->24 @128^3", "fwd_wg", (4,), 24, (128, 128, 128), "bias+elu", BF16),
    ("24->48 @128^3", "fwd_wg", (24,), 48, (128, 128, 128), "bias+elu", BF16),
    ("48->48 @128^3", "fwd_wg", (48,), 48, (128, 128, 128), "bias+elu", BF16),
    ("[48,96]->48 @128^3", "fwd_wg", (48, 96), 48, (128, 128, 128), "bias+elu", BF16),
    ("48->96 @64^3", "fwd_wg", (48,), 96, (64, 64, 64), "bias+elu", BF16),
    ("96->96 @64^3", "fwd_wg", (96,), 96, (64, 64, 64), "bias+elu", BF16),
    ("[96,192]->96 @64^3", "fwd_wg", (96, 192), 96, (64, 64, 64), "bias+elu", BF16),
    ("96->192 @32^3", "fwd_wg", (96,), 192, (32, 32, 32), "bias+elu", BF16),
    ("192->192 @32^3", "fwd_wg", (192,), 192, (32, 32, 32), "bias+elu", BF16),
    ("[192,384]->192 @32^3 +post", "fwd_wg", (192, 384), 192, (32, 32, 32), "bias+elu+post",
     BF16),
    ("192->384 @16^3", "fwd_wg", (192,), 384, (16, 16, 16), "bias+elu", BF16),
    ("384->384 @16^3", "fwd_wg", (384,), 384, (16, 16, 16), "bias+elu", BF16),
    ("1->24 @192x224x192", "first_mma", (1,), 24, (192, 224, 192), "bias+elu", BF16),
    # W % 8 != 0: the 2-byte load and store path
    ("1->24 @192x224x190", "first_mma", (1,), 24, (192, 224, 190), "bias+elu", BF16),
    ("24->24 @192x224x192", "fwd_wg", (24,), 24, (192, 224, 192), "bias+elu", BF16),
    # a large field of view: the level-0 convs that K5 served on the TPU,
    # 24-, 48- and 72-channel sources of 25 M voxels (a 72-channel source's
    # byte offsets pass 2^31)
    ("1->24 @192x256x512", "first_mma", (1,), 24, (192, 256, 512), "bias+elu", BF16),
    ("24->24 @192x256x512 (K5)", "fwd_wg", (24,), 24, (192, 256, 512), "bias+elu", BF16),
    ("[24,48]->24 @192x256x512", "fwd_wg", (24, 48), 24, (192, 256, 512), "bias+elu", BF16),
    ("72->24 @192x256x512", "fwd_wg", (72,), 24, (192, 256, 512), "bias+elu", BF16),
    ("24->24 @64x384x384 (K5)", "fwd_wg", (24,), 24, (64, 384, 384), "bias+elu", BF16),
    # the train step's input-gradient convs: flipped, transposed weights, no epilogue
    ("24->72 @128^3 (dx)", "fwd_wg", (24,), 72, (128, 128, 128), "dx", BF16),
    ("48->144 @64^3 (dx)", "fwd_wg", (48,), 144, (64, 64, 64), "dx", BF16),
    # the float32 kernels (H-first-x3 and H-fwd-x3, split TF32):
    # the float32 train step's convs at 128^3 (forward and input gradients,
    # each level's), then the level-0 convs of the float32 predict phase's
    # clinical volume
    ("1->24 @128^3 f32", "first_x3", (1,), 24, (128, 128, 128), "bias+elu", F32),
    ("24->24 @128^3 f32", "fwd_x3", (24,), 24, (128, 128, 128), "bias+elu", F32),
    ("4->24 @128^3 f32", "fwd_x3", (4,), 24, (128, 128, 128), "bias+elu", F32),
    ("[24,48]->24 @128^3 f32", "fwd_x3", (24, 48), 24, (128, 128, 128), "bias+elu", F32),
    ("24->72 @128^3 f32 (dx)", "fwd_x3", (24,), 72, (128, 128, 128), "dx", F32),
    ("24->24 @128^3 f32 (dx)", "fwd_x3", (24,), 24, (128, 128, 128), "dx", F32),
    ("48->48 @64^3 f32", "fwd_x3", (48,), 48, (64, 64, 64), "bias+elu", F32),
    ("48->144 @64^3 f32 (dx)", "fwd_x3", (48,), 144, (64, 64, 64), "dx", F32),
    ("[192,384]->192 @16^3 f32", "fwd_x3", (192, 384), 192, (16, 16, 16), "bias+elu", F32),
    ("1->24 @192x224x192 f32", "first_x3", (1,), 24, (192, 224, 192), "bias+elu", F32),
    ("24->24 @192x224x192 f32", "fwd_x3", (24,), 24, (192, 224, 192), "bias+elu", F32),
    ("[24,48]->24 @192x224x192 f32", "fwd_x3", (24, 48), 24, (192, 224, 192), "bias+elu", F32),
    # the critic's stride-1 convs (LeakyReLU fused) at 128^3 and the input
    # gradient of its first conv, 32->1 (one n8 tile of output channels); in
    # float32 the 64^3 adversarial run's first two
    ("1->32 @128^3 leaky", "first_mma", (1,), 32, (128, 128, 128), "bias+leaky", BF16),
    ("32->64 @64^3 leaky", "fwd_wg", (32,), 64, (64, 64, 64), "bias+leaky", BF16),
    ("64->128 @32^3 leaky", "fwd_wg", (64,), 128, (32, 32, 32), "bias+leaky", BF16),
    ("128->256 @16^3 leaky", "fwd_wg", (128,), 256, (16, 16, 16), "bias+leaky", BF16),
    ("32->1 @128^3 (dx)", "fwd_mma", (32,), 1, (128, 128, 128), "dx", BF16),
    # the gradient penalty's transposed stride-1 convs of levels 1-3 (C_in =
    # 2·C_out, no epilogue; level 0's is the 32->1 row)
    ("64->32 @64^3 (dx)", "fwd_wg", (64,), 32, (64, 64, 64), "dx", BF16),
    ("128->64 @32^3 (dx)", "fwd_wg", (128,), 64, (32, 32, 32), "dx", BF16),
    ("256->128 @16^3 (dx)", "fwd_wg", (256,), 128, (16, 16, 16), "dx", BF16),
    ("1->32 @64^3 f32 leaky", "first_x3", (1,), 32, (64, 64, 64), "bias+leaky", F32),
    # Hyperfine's first conv in float32 (compute_dtype="float32") at its padded
    # shape, and W % 4 != 0: H-first-x3's 4-byte load and store path
    ("2->24 @192x256x160 f32", "first_x3", (2,), 24, (192, 256, 160), "bias+elu", F32),
    ("1->24 @192x224x190 f32", "first_x3", (1,), 24, (192, 224, 190), "bias+elu", F32),
    ("32->64 @32^3 f32 leaky", "fwd_x3", (32,), 64, (32, 32, 32), "bias+leaky", F32),
]


def tutorial_shapes():
    """The conv shapes of the training tutorials' smoke step (tutorials 7 and
    9: bf16, 32^3 in, 24 features, 5 levels, so 32^3 down to 2^3, where most
    tiles are masked; 4 and 8 input channels): (SHAPES rows of every forward
    and input-gradient conv, WGRAD_SHAPES rows of every weight gradient)."""
    fwd, wgrad = [], []
    levels = [(32 >> i, 24 << i) for i in range(5)]  # (spatial, features)
    for i, (n, f) in enumerate(levels):
        sp = (n, n, n)
        for c in ((4, 8) if i == 0 else (f // 2,)):
            fwd.append((f"{c}->{f} @{n}^3", "fwd_wg", (c,), f, sp, "bias+elu", BF16))
            wgrad.append((c, f, n, BF16))
            if i:
                fwd.append((f"{f}->{c} @{n}^3 (dx)", "fwd_wg", (f,), c, sp, "dx", BF16))
        fwd.append((f"{f}->{f} @{n}^3", "fwd_wg", (f,), f, sp, "bias+elu", BF16))
        fwd.append((f"{f}->{f} @{n}^3 (dx)", "fwd_wg", (f,), f, sp, "dx", BF16))
        wgrad.append((f, f, n, BF16))
        if i < len(levels) - 1:  # the decoder's [skip, up] conv of this level
            fwd.append((f"[{f},{2 * f}]->{f} @{n}^3", "fwd_wg", (f, 2 * f), f, sp, "bias+elu",
                        BF16))
            fwd.append((f"{f}->{3 * f} @{n}^3 (dx)", "fwd_wg", (f,), 3 * f, sp, "dx", BF16))
            wgrad.append((2 * f, f, n, BF16))
    return fwd, wgrad


TUTORIAL_SHAPES, TUTORIAL_WGRAD_SHAPES = tutorial_shapes()
# the 256^3 flip-TTA predict pass: its conv rows of SHAPES and their launches
# per TTA pair (a row's +post twin, the decoder's second conv, counted with it)
PREDICT_ROWS = {"1->24 @256^3": 2, "24->24 @256^3": 2, "24->24 @256^3 +post+head": 2,
                "[24,48]->24 @256^3": 2, "24->48 @128^3": 2, "48->48 @128^3": 4,
                "[48,96]->48 @128^3": 2, "48->96 @64^3": 2, "96->96 @64^3": 4,
                "[96,192]->96 @64^3": 2, "96->192 @32^3": 2, "192->192 @32^3": 4,
                "[192,384]->192 @32^3 +post": 2, "192->384 @16^3": 2, "384->384 @16^3": 2}
SHAPES += TUTORIAL_SHAPES
TIMED = {"first_mma": "1->24 @256^3", "first_x3": "1->24 @128^3 f32",
         "fwd_wg": "[24,48]->24 @256^3", "fwd_mma": "32->1 @128^3 (dx)",
         "wgrad_mma": "(192,192) @4^3", "fwd_x3": "24->24 @128^3 f32",
         "wgrad_x3": "(24,24) @64^3 f32", "wgrad_wg": "(24,24) @128^3"}


def train_wgrad():
    """The train step's 22 weight gradients, {(ci, co, spatial): launches per
    step}: at level i = 0-3 ((128 / 2^i)^3 voxels, f = 24·2^i features) the
    encoder's (c_in, f) (c_in 4 at level 0, f / 2 below) and (f, f), the
    decoder's [skip, up] conv as (f, f) and (2f, f) and its second conv (f,
    f); at 8^3 (192, 384) and (384, 384)."""
    rows = {}
    for i in range(4):
        n, f = 128 >> i, 24 << i
        rows.update({(4 if i == 0 else f // 2, f, n): 1, (f, f, n): 3, (2 * f, f, n): 1})
    return {**rows, (192, 384, 8): 1, (384, 384, 8): 1}


TRAIN_WGRAD = train_wgrad()
assert sum(TRAIN_WGRAD.values()) == TRAIN_LAUNCHES["wgrad_wg"]
# the weight-gradient kernels at the train step's shapes in bf16 and in
# float32, then at the earlier float32 row's (24,24) @64^3: (ci, co, spatial, dtype)
WGRAD_SHAPES = [(*s, BF16) for s in TRAIN_WGRAD] + [(*s, F32) for s in TRAIN_WGRAD] + [
                (24, 24, 64, F32),
                # the critic's: its first conv, a trunk conv's shape, and the
                # weight gradients of the penalty's four transposed convs (the
                # only ones it launches: the trunk convs get none from the penalty,
                # and those after the first run on cuDNN in the WGAN terms)
                (1, 32, 128, BF16), (32, 64, 64, BF16), (32, 1, 128, BF16),
                (64, 32, 64, BF16), (128, 64, 32, BF16), (256, 128, 16, BF16)]
WGRAD_SHAPES += TUTORIAL_WGRAD_SHAPES

# synthetic inputs: (file name, shape, voxel size mm, CT); the first resamples
# to 256^3, the second is a clinical anisotropic scan padding to 192x224x192
VOLUMES = [("t1_256.nii.gz", (256, 256, 128), (1.0, 1.0, 2.0), False),
           ("flair_clinical.nii.gz", (176, 208, 36), (1.0, 1.0, 5.0), False),
           ("head_ct.nii.gz", (192, 192, 64), (0.9, 0.9, 2.5), True)]
# a 1 mm head-and-neck CT with 500 mm cranio-caudal coverage: pads to 192x256x512
LARGE_FOV = ("head_neck_ct.nii", (180, 250, 500), (1.0, 1.0, 1.0))
# Hyperfine T1/T2 pairs at 1.5 x 1.5 x 5 mm: (T1 shape, T2 rotated about z, degrees)
HYPERFINE = [((128, 160, 32), 0.0), ((128, 160, 32), 10.0)]
PREDICT_LAUNCHES = {**NO_LAUNCHES, "first_mma": 2, "fwd_wg": 34}   # per volume, flip TTA
HYPERFINE_LAUNCHES = {**NO_LAUNCHES, "first_mma": 1, "fwd_wg": 17}  # per pair, one forward
PREDICT_F32_LAUNCHES = {**NO_LAUNCHES, "first_x3": 2, "fwd_x3": 34}  # per volume, float32 compute


def ptxas_summary(log):
    """{kernel<template args>: "N registers, S B spill"} from the
    ``-Xptxas -v`` output of the build."""
    import re

    out, name = {}, None
    for line in log.splitlines():
        m = re.search(r"entry function '\w*?\d+(conv3d_[a-z0-9_]+?_kernel)(I\w*?EE)?", line)
        if m:
            targs = m.group(2) or ""
            args = (["bf16"] if "bfloat16" in targs else ["f32"] if targs.startswith("If") else [])
            name = m.group(1) + "<" + ",".join(args + re.findall(r"L[ib](\d+)E", targs)) + ">"
            continue
        m = re.search(r"(\d+) bytes spill stores", line)
        if m and name:
            out[name] = f"{m.group(1)} B spill"
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out[name] = f"{m.group(1)} registers, " + out.get(name, "")
            name = None
    return out


def require(ok, what):
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def phase(name):
    print(f"== {name}", flush=True)


def bound(flops, nbytes, dtype=BF16):
    """(bound_ms, bound_by): the least time the card could take."""
    t_ops = flops / (PEAK_FLOPS if dtype == BF16 else PEAK_F32_FLOPS)
    t_bytes = nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def cuda_ms(fn, reps):
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    fn()
    torch.cuda.synchronize()
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def kernel_inputs(conv_cf, gen, cins, cout, spatial, fused, dtype):
    """The ``conv3d_cf`` arguments of one SHAPES row, drawn from ``gen`` on the
    card: the sources, the weights (packed, or an input gradient's flipped,
    transposed ones), bias, activation, ``post`` and ``head``."""
    dev = torch.device("cuda")

    def randn(*shape, scale=1.0):
        return torch.randn(*shape, device=dev, generator=gen) * scale

    cin = sum(cins)
    srcs = [randn(c, *spatial).to(dtype) for c in cins]
    if fused == "dx":
        w = randn(3, 3, 3, cout, cin, scale=(2 / (27 * cin)) ** 0.5)
        kw = dict(x=srcs[0], w=torch.flip(w, (0, 1, 2)).transpose(3, 4))
    else:
        kw = dict(x=srcs if len(srcs) > 1 else srcs[0],
                  w=conv_cf.pack_conv(randn(3, 3, 3, cin, cout, scale=(2 / (27 * cin)) ** 0.5),
                                      dtype, cins),
                  bias=randn(cout, scale=0.1),
                  activation="leaky" if "leaky" in fused else "elu")
    if "post" in fused:
        kw["post"] = torch.stack([torch.rand(cout, device=dev, generator=gen) * 0.4 + 0.8,
                                  randn(cout, scale=0.1)])
    if "head" in fused:
        kw["head"] = (randn(cout, scale=cout ** -0.5), torch.tensor(0.25, device=dev))
    return kw


def check_kernels(conv_cf, gen):
    """Each kernel against conv3d_cf_reference on the same bf16 (or float32)
    inputs."""
    results = []
    for name, kernel, cins, cout, spatial, fused, dtype in SHAPES:
        cin = sum(cins)
        kw = kernel_inputs(conv_cf, gen, cins, cout, spatial, fused, dtype)
        lib = library_conv(conv_cf, kw)
        before = dict(conv_cf.LAUNCHES)
        got = conv_cf.conv3d_cf(**kw)
        torch.cuda.synchronize()
        launched = [k for k in before if conv_cf.LAUNCHES[k] != before[k]]
        require(launched == [kernel], (name, launched))
        if dtype == BF16 and not kernel.startswith("first"):  # the gate, stated once
            require(conv_cf.fwd_wg_ok(kw["x"], cout, head=kw.get("head")) == (kernel == "fwd_wg"),
                    (name, kernel))
        want = conv_cf.conv3d_cf_reference(**kw)
        torch.cuda.synchronize()
        require(got.shape == want.shape and got.dtype == want.dtype, name)
        err = float((got.float() - want.float()).abs().max())
        rel = err / float(want.float().abs().max())
        tol = F32_BOUND if dtype == F32 else HEAD_BOUND if "head" in fused else KERNEL_BOUND
        reps = 3 if cin * np.prod(spatial) > 2 ** 28 else 10
        ab = {}  # H-fwd-wg's rows: it and H-fwd-mma in turns, A B B A
        for k in ((None, "fwd_mma", "fwd_mma", None) if kernel == "fwd_wg" else (None,)):
            ab.setdefault(k, []).append(
                cuda_ms(lambda: conv_cf.conv3d_cf(**kw, kernel=k), reps))
        ms = float(np.mean(ab[None]))
        mma_ms = ab.get("fwd_mma")
        plain_ms = cuda_ms(lambda: conv_cf.conv3d_cf_reference(**kw), reps)
        library_ms = cuda_ms(lib, reps)
        vox = int(np.prod(spatial))
        size = 2 if dtype == BF16 else 4
        out_bytes = 4 * vox if "head" in fused else size * cout * vox
        bound_ms, bound_by = bound(2 * 27 * cin * cout * vox,
                                   size * cin * vox + 4 * 27 * cin * cout + out_bytes,
                                   dtype)
        turns = "" if mma_ms is None else \
            f" (A/B: H-fwd-wg {ab[None][0]:.3f}, {ab[None][1]:.3f}; H-fwd-mma {mma_ms[0]:.3f}, " \
            f"{mma_ms[1]:.3f})"
        print(f"  {kernel:9s} {name:28s} {fused:20s} max_abs_err {err:.3e} rel {rel:.3e} "
              f"(tolerance {tol:.0e})  kernel {ms:.3f} ms{turns}  plain {plain_ms:.3f} ms  "
              f"library {library_ms:.3f} ms  bound {bound_ms:.3f} ms ({bound_by})", flush=True)
        require(np.isfinite(rel) and rel <= tol, (name, rel, tol))
        results.append(dict(kernel=kernel, shape=name, fused=fused, dtype=str(dtype)[6:],
                            max_abs_err=err,
                            rel_err=rel, ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                            bound_ms=bound_ms, bound_by=bound_by, mma_ms=mma_ms))
        del kw, got, want, lib
        torch.cuda.empty_cache()
    return results


def library_conv(conv_cf, kw):
    """One cuDNN call on the same bf16 (or float32, TF32 off) operands:
    F.conv3d of the concatenated sources (concatenated here, outside the
    timing) with the bias; the activation, ``post`` and ``head`` epilogues are
    not part of it."""
    srcs = kw["x"] if isinstance(kw["x"], list) else [kw["x"]]
    x = torch.cat(srcs, 0)[None] if len(srcs) > 1 else srcs[0][None]
    w = kw["w"].w if isinstance(kw["w"], conv_cf.PackedConv) else kw["w"]
    w = w.to(x.dtype).permute(4, 3, 0, 1, 2).contiguous()
    b = kw.get("bias")
    b = None if b is None else b.to(x.dtype)
    return lambda: torch.nn.functional.conv3d(x, w, b, padding=1)


def check_wgrad(conv_cf, gen):
    """H-wgrad-wg and H-wgrad-mma (bf16) and H-wgrad-x3 (float32) against
    conv3d_cf_wgrad_reference (float32 conv3d_weight, TF32 off) on the same
    inputs, and two calls bit-equal; H-wgrad-wg's rows also H-wgrad-mma's
    time, in turns."""
    dev = torch.device("cuda")
    results = []
    for ci, co, n, dtype in WGRAD_SHAPES:
        tol = WGRAD_BOUND if dtype == BF16 else F32_BOUND
        name = f"({ci},{co}) @{n}^3" + (" f32" if dtype == F32 else "")
        x = torch.randn(ci, n, n, n, device=dev, generator=gen).to(dtype)
        g = torch.randn(co, n, n, n, device=dev, generator=gen).to(dtype)
        kernel = "wgrad_x3" if dtype == F32 else \
            "wgrad_wg" if conv_cf.wgrad_wg_ok(x, g) else "wgrad_mma"
        require(dtype == F32 or (kernel == "wgrad_wg") == (n >= 8),
                (name, kernel))
        before = dict(conv_cf.LAUNCHES)
        got = conv_cf.conv3d_cf_wgrad(x, g)
        again = conv_cf.conv3d_cf_wgrad(x, g)
        torch.cuda.synchronize()
        launched = {k: conv_cf.LAUNCHES[k] - before[k] for k in before
                    if conv_cf.LAUNCHES[k] != before[k]}
        require(launched == {kernel: 2}, (name, launched))
        want = conv_cf.conv3d_cf_wgrad_reference(x, g)
        torch.cuda.synchronize()
        require(got.shape == want.shape == (3, 3, 3, ci, co), name)
        err = float((got - want).abs().max())
        rel = err / float(want.abs().max())
        same = bool(torch.equal(got, again))
        ab = {}  # H-wgrad-wg's rows: it and H-wgrad-mma in turns, A B B A
        for k in ((None, "wgrad_mma", "wgrad_mma", None) if kernel == "wgrad_wg" else (None,)):
            ab.setdefault(k, []).append(cuda_ms(lambda: conv_cf.conv3d_cf_wgrad(x, g, kernel=k), 5))
        ms = float(np.mean(ab[None]))
        mma_ms = ab.get("wgrad_mma")
        plain_ms = cuda_ms(lambda: conv_cf.conv3d_cf_wgrad_reference(x, g), 5)
        library_ms = cuda_ms(lambda: torch.nn.grad.conv3d_weight(
            x[None], (co, ci, 3, 3, 3), g[None], padding=1), 5)
        flops = 2 * 27 * ci * co * n ** 3
        size = 2 if dtype == BF16 else 4
        bound_ms, bound_by = bound(flops, size * (ci + co) * n ** 3 + 4 * 27 * ci * co, dtype)
        turns = "" if mma_ms is None else \
            f" (A/B: H-wgrad-wg {ab[None][0]:.3f}, {ab[None][1]:.3f}; H-wgrad-mma " \
            f"{mma_ms[0]:.3f}, {mma_ms[1]:.3f})"
        print(f"  {kernel:9s} {name:20s} max_abs_err {err:.3e} rel {rel:.3e} (tolerance "
              f"{tol:.0e})  bit-equal repeat {same}  kernel {ms:.3f} ms "
              f"({flops / ms / 1e9:.1f} TFLOP/s){turns}  plain {plain_ms:.3f} ms  library "
              f"{library_ms:.3f} ms  bound {bound_ms:.3f} ms ({bound_by})", flush=True)
        require(np.isfinite(rel) and rel <= tol, (name, rel))
        require(same, (name, "repeat differs"))
        results.append(dict(kernel=kernel, shape=name, fused="", dtype=str(dtype)[6:],
                            max_abs_err=err,
                            rel_err=rel, ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                            bound_ms=bound_ms, bound_by=bound_by, mma_ms=mma_ms))
        del x, g, got, again, want
    torch.cuda.empty_cache()
    train_wgrad_sums(results)
    return results


def train_wgrad_sums(results):
    """Σ launches × ms of a train step's 22 weight gradients, per dtype: the
    kernel's, the bound's and cuDNN's, and in bf16 H-wgrad-mma's from the
    same turns."""
    rows = {c["shape"]: c for c in results}
    for dtype, tag in ((BF16, ""), (F32, " f32")):
        mine = [(n, rows[f"({ci},{co}) @{s}^3{tag}"]) for (ci, co, s), n in TRAIN_WGRAD.items()]
        sums = {k: sum(n * c[k] for n, c in mine) for k in ("ms", "bound_ms", "library_ms")}
        mma = "" if dtype == F32 else \
            f", H-wgrad-mma {sum(n * float(np.mean(c['mma_ms'])) for n, c in mine):.3f} ms"
        per_step = ", ".join(f"{c['shape']} x{n}" for n, c in mine)
        print(f"  train step{tag or ' bf16'}: sum of launches x ms over its 22 weight gradients "
              f"({per_step}): kernel {sums['ms']:.3f} ms{mma}, bound {sums['bound_ms']:.3f} ms, "
              f"cuDNN {sums['library_ms']:.3f} ms", flush=True)


def make_train_data(root, rng):
    """Seeded synthetic training inputs: three 160³ label maps of nested
    ellipsoids split into left and right hemispheres (FreeSurfer label ids),
    the generation label list and 3-channel normal GMM priors."""
    from synthsr_tpu_torch.io.volume import save_volume

    left, right = [2, 3, 4, 17], [41, 42, 43, 53]
    labels = np.array([0, 14, 24] + left + right, np.int32)
    lab_dir = os.path.join(root, "labels")
    os.makedirs(lab_dir)
    n = 160
    grid = np.meshgrid(*[np.arange(n) - n / 2] * 3, indexing="ij", sparse=True)
    for i in range(3):
        lab = np.zeros((n, n, n), np.int32)
        for k, r in enumerate((70, 55, 40, 25)):
            radii = r * rng.uniform(0.85, 1.1, 3)
            inside = sum((g / ri) ** 2 for g, ri in zip(grid, radii)) < 1
            side = np.broadcast_to(np.where(grid[0] < 0, left[k], right[k]), lab.shape)
            lab[inside] = side[inside]
        lab[(np.abs(grid[0]) < 2) & (lab > 0)] = 24
        lab[(np.abs(grid[1]) < 3) & (np.abs(grid[2]) < 3) & (lab > 0)] = 14
        save_volume(lab, np.eye(4), None, os.path.join(lab_dir, f"subject{i}.nii.gz"))
    np.save(os.path.join(root, "generation_labels.npy"), labels)
    n_lab = len(labels)
    means = np.concatenate([np.stack([rng.uniform(10, 240, n_lab), rng.uniform(5, 25, n_lab)])
                            for _ in range(3)])
    stds = np.concatenate([np.stack([rng.uniform(2, 12, n_lab), rng.uniform(1, 3, n_lab)])
                           for _ in range(3)])
    np.save(os.path.join(root, "prior_means.npy"), means.astype(np.float32))
    np.save(os.path.join(root, "prior_stds.npy"), stds.astype(np.float32))
    np.save(os.path.join(root, "data_res.npy"), np.array([[1.0, 1.0, 3.0], [1.0, 4.5, 1.0]]))
    np.save(os.path.join(root, "thickness.npy"), np.array([[1.0, 1.0, 3.0], [1.0, 3.0, 1.0]]))
    return lab_dir


def train_args(root, model_dir, epochs, dtype="bfloat16", steps=3, batch=1):
    """cli.train arguments of bench_train.py's tutorial-7 configuration."""
    return [os.path.join(root, "labels"), model_dir, os.path.join(root, "prior_means.npy"),
            os.path.join(root, "prior_stds.npy"), os.path.join(root, "generation_labels.npy"),
            "--input_channels", "False", "True", "True", "--output_channel", "0",
            "--output_shape", "128", "--data_res", os.path.join(root, "data_res.npy"),
            "--thickness", os.path.join(root, "thickness.npy"), "--nonlin_std", "2.0",
            "--bias_field_std", "0.2", "--work_with_residual_channel", "1",
            "--loss_cropping", "96", "--lr", "1e-4", "--batchsize", str(batch),
            "--scaling_bounds", "0.1", "--rotation_bounds", "8", "--shearing_bounds", "0.01",
            "--translation_bounds", "False", "--compute_dtype", dtype,
            "--epochs", str(epochs), "--steps_per_epoch", str(steps), "--seed", "0"]


def train_phase(conv_cf, root):
    """The train main path on the label maps under ``root``, then one step's
    gradients against the plain float32 autograd, then where a warm step's
    time goes."""
    from synthsr_tpu_torch.cli import train as train_cli

    phase("main path: train (tutorial-7 configuration, 128^3, bf16)")
    model_dir = os.path.join(root, "model")
    logs = []
    log = (lambda line: (logs.append(line), print("  " + line, flush=True)))
    conv_cf.reset_launch_counts()
    t0 = time.perf_counter()
    first = train_cli.main(train_args(root, model_dir, 2), log_fn=log)
    resumed = train_cli.main(train_args(root, model_dir, 3), log_fn=log)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    launches = dict(conv_cf.LAUNCHES)
    steps = 9
    print(f"  main(): 2 epochs + resume to 3, {steps} steps in {train_s:.2f} s; "
          f"launches {launches} (expected {TRAIN_LAUNCHES} per step)")
    require(launches == {k: v * steps for k, v in TRAIN_LAUNCHES.items()}, launches)
    curve = first["loss_curve"] + resumed["loss_curve"]
    require(len(curve) == 3 and all(np.isfinite(curve)) and 0 < max(curve) < 10, curve)
    require(any("resuming from epoch 2" in line for line in logs), "no resume")
    require(sum("epoch 3/3" in line for line in logs) == 1, "epoch 3 ran more than once")
    files = sorted(os.listdir(model_dir))
    require(all(f"{e:03d}.pt" in files for e in (1, 2, 3)), files)
    h5 = all(f"{e:03d}.h5" in files for e in (1, 2, 3))
    require(h5 or any("h5py is not installed" in line for line in logs), files)
    with open(os.path.join(model_dir, "logs", "training_log.jsonl")) as f:
        epochs = [json.loads(line) for line in f]
    epoch_step_s = [e["seconds"] / 3 for e in epochs[1:]]
    print(f"  losses {curve}; checkpoints {files}; epoch-clock seconds per step "
          f"(epoch 2; epoch 3, whose first step also waits on the resumed run's "
          f"first label-map load) {epoch_step_s}")
    summary = dict(loss_curve=curve, launches=launches, seconds=train_s,
                   epoch_step_s=epoch_step_s, h5_exported=h5)
    summary.update(gradient_check(resumed["model"], root))

    phase(f"main path: train in float32 ({TRAIN_F32_STEPS} steps, H-fwd-x3 and H-wgrad-x3)")
    f32_dir = os.path.join(root, "model_f32")
    conv_cf.reset_launch_counts()
    t0 = time.perf_counter()
    f32 = train_cli.main(train_args(root, f32_dir, 1, "float32", TRAIN_F32_STEPS),
                         log_fn=lambda line: print("  " + line, flush=True))
    torch.cuda.synchronize()
    f32_s = time.perf_counter() - t0
    f32_launches = dict(conv_cf.LAUNCHES)
    print(f"  main(): 1 epoch x {TRAIN_F32_STEPS} steps in {f32_s:.2f} s; launches "
          f"{f32_launches} (expected {TRAIN_F32_LAUNCHES} per step)")
    require(f32_launches == {k: v * TRAIN_F32_STEPS for k, v in TRAIN_F32_LAUNCHES.items()},
            f32_launches)
    curve = f32["loss_curve"]
    require(len(curve) == 1 and np.isfinite(curve[0]), curve)
    summary["float32"] = dict(seconds=f32_s, launches=f32_launches,
                              loss_curve=f32["loss_curve"])
    return {"launches": launches, "f32_launches": f32_launches, "summary": summary}


def tutorial7_generator(root, dev, n_maps, return_labels=False):
    """The generator and GMM sampler of the train path's tutorial-7
    configuration, and a batch of the first ``n_maps`` label maps on ``dev``."""
    from synthsr_tpu_torch.io.labels import get_list_labels
    from synthsr_tpu_torch.io.volume import load_volume
    from synthsr_tpu_torch.synth.labels_to_image import GenerationConfig, build_generator
    from synthsr_tpu_torch.synth.sampling import make_gmm_sampler
    from synthsr_tpu_torch.utils.misc import get_padding_margin

    labels, n_neutral = get_list_labels(
        label_list=os.path.join(root, "generation_labels.npy"), FS_sort=True)
    labs = [load_volume(os.path.join(root, "labels", f"subject{i}.nii.gz"), dtype="int")
            for i in range(n_maps)]
    cfg = GenerationConfig(
        labels_shape=list(labs[0].shape), input_channels=[False, True, True],
        output_channel=[0], generation_labels=labels, n_neutral_labels=n_neutral,
        atlas_res=[1.0, 1.0, 1.0], output_shape=128, output_div_by_n=32,
        padding_margin=get_padding_margin(128, 96), flipping=True, aff=np.eye(4),
        scaling_bounds=0.1, rotation_bounds=8, shearing_bounds=0.01, translation_bounds=False,
        nonlin_std=2.0, nonlin_shape_factor=0.03125,
        data_res=np.load(os.path.join(root, "data_res.npy")),
        thickness=np.load(os.path.join(root, "thickness.npy")), downsample=True,
        build_reliability_maps=True, bias_field_std=0.2, bias_shape_factor=0.03125)
    sampler = make_gmm_sampler(len(labels), np.load(os.path.join(root, "prior_means.npy")),
                               np.load(os.path.join(root, "prior_stds.npy")), "normal",
                               n_channels=3)
    batch = [torch.as_tensor(np.stack(labs)[..., None], device=dev)]
    return build_generator(cfg, return_labels=return_labels), sampler, batch


def adversarial_generator(root, dev, pm, ps, return_labels=False):
    """The generator and GMM sampler of the adversarial path's configuration
    (ADV_CONFIG), and a batch of the first label map on ``dev``."""
    from synthsr_tpu_torch.io.labels import get_list_labels
    from synthsr_tpu_torch.io.volume import load_volume
    from synthsr_tpu_torch.synth.brain_generator import BrainGenerator
    from synthsr_tpu_torch.synth.labels_to_image import build_generator
    from synthsr_tpu_torch.synth.sampling import make_gmm_sampler

    labels, n_neutral = get_list_labels(
        label_list=os.path.join(root, "generation_labels.npy"),
        labels_dir=os.path.join(root, "labels"), FS_sort=True)
    bg = BrainGenerator(os.path.join(root, "labels"), pm, ps, generation_labels=labels,
                        n_neutral_labels=n_neutral, output_div_by_n=32, seed=1, device=dev,
                        **ADV_CONFIG)
    sampler = make_gmm_sampler(len(labels), bg.prior_means, bg.prior_stds, "normal",
                               n_channels=bg.n_channels, generation_classes=bg.generation_classes)
    lab = load_volume(os.path.join(root, "labels", "subject0.nii.gz"), dtype="int")
    batch = [torch.as_tensor(lab[None, ..., None], device=dev)]
    return build_generator(bg.cfg, return_labels=return_labels), sampler, batch


def gradient_check(trained, root):
    """One step's loss and parameter gradient, bf16 kernel path vs the plain
    float32 autograd of UNet3D.forward_train, on one generated batch and the
    trained weights; then a timed and profiled warm step, and WARM_STEPS
    consecutive whole steps of make_train_step."""
    from synthsr_tpu_torch.models.unet import UNet3D
    from synthsr_tpu_torch.train.training import (example_generators, forward_loss,
                                                  generate_batch, make_train_step)
    from synthsr_tpu_torch.utils.finite_guard import adam_init

    phase("one train step: kernel path (bf16) vs plain float32 autograd")
    dev = torch.device("cuda")
    model = UNet3D(in_channels=4).to(dev)
    model.load_state_dict(trained.state_dict())
    generator, sampler, batch = tutorial7_generator(root, dev, 1)
    gen = torch.Generator().manual_seed(1)  # the step generator stays on the host
    image, target = generate_batch(generator, sampler, example_generators(gen, 1, 0, dev), batch)
    require(image.shape == (1, 128, 128, 128, 4) and target.shape == (1, 128, 128, 128, 1),
            (image.shape, target.shape))
    require(bool(torch.isfinite(image).all() and torch.isfinite(target).all()), "non-finite pair")
    params = list(model.parameters())
    kw = dict(metrics="l1", loss_cropping=96, residual_indices=[2])
    loss_k, _ = forward_loss(model, image, target, fast=True, **kw)
    grads_k = torch.autograd.grad(loss_k, params)
    loss_p, _ = forward_loss(model, image, target, fast=False, **kw)
    grads_p = torch.autograd.grad(loss_p, params)
    flat = lambda gs: torch.cat([g.reshape(-1) for g in gs])  # noqa: E731
    rel_grad = float((flat(grads_k) - flat(grads_p)).norm() / flat(grads_p).norm())
    rel_loss = abs(float(loss_k.detach()) - float(loss_p.detach())) / abs(float(loss_p.detach()))
    leaf_rel = {n: float((a - b).norm() / b.norm())
                for (n, p), a, b in zip(model.named_parameters(), grads_k, grads_p)
                if p.dim() == 5 and p.shape[-1] == 3}
    worst = sorted(leaf_rel, key=leaf_rel.get, reverse=True)
    print(f"  loss kernel {float(loss_k.detach()):.6f} plain {float(loss_p.detach()):.6f}: relative "
          f"{rel_loss:.3e} (bound {LOSS_BOUND:.0e}); gradient relative L2 {rel_grad:.3e} "
          f"(bound {GRAD_BOUND:.0e}); worst 3³-conv weight gradient relative L2 "
          f"{leaf_rel[worst[0]]:.3e} (bound {LEAF_BOUND:g})")
    for n in worst:
        print(f"    {n:24s} {leaf_rel[n]:.3e}")
    del grads_p, loss_p
    torch.cuda.empty_cache()

    phase("where a warm train step's time goes (CUDA events, then torch.profiler)")
    spans = {}

    def forward():
        im, tg = cuda_span(spans, "generator",
                           lambda: generate_batch(generator, sampler,
                                                  example_generators(gen, 1, 0, dev), batch))
        return cuda_span(spans, "forward+loss",
                         lambda: forward_loss(model, im, tg, fast=True, **kw))[0]

    def backward(loss):
        cuda_span(spans, "backward", lambda: torch.autograd.grad(loss, params))

    for _ in range(2):
        backward(forward())
    print(f"  ms: {spans}")
    kernel_ms = {}
    for part in ("forward", "backward"):
        loss = None if part == "forward" else forward()
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            if part == "forward":
                forward()
            else:
                backward(loss)
        rows = sorted(((getattr(ev, "self_device_time_total", 0) or 0) / 1e3, ev.key[:70])
                      for ev in prof.key_averages())
        total = sum(ms for ms, _ in rows)
        convs = {k: ms for ms, k in rows if "conv3d_" in k and ms > 0}
        kernel_ms[part] = dict(total=total, conv_kernels=convs,
                               top=[(k, ms) for ms, k in rows[::-1][:8]])
        print(f"  profiler, {part} of a warm step (generator included in forward): device "
              f"{total:.1f} ms; conv kernels {convs if convs else 'not measured'}")
        for ms, k in rows[::-1][:8]:
            print(f"    {ms:8.2f} ms  {k}")

    phase(f"{WARM_STEPS} consecutive warm train steps (generator, forward, backward, Adam, "
          f"gate), CUDA events")
    step = make_train_step(model, generator, sampler, 1e-4, **kw)
    opt = adam_init(params)
    for _ in range(2):
        opt, loss = step(opt, gen, batch)
    events = [torch.cuda.Event(enable_timing=True) for _ in range(WARM_STEPS + 1)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    events[0].record()
    for e in events[1:]:
        opt, loss = step(opt, gen, batch)
        e.record()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / WARM_STEPS
    step_ms = [a.elapsed_time(b) for a, b in zip(events, events[1:])]
    print(f"  ms per step: median {float(np.median(step_ms)):.3f}, min {min(step_ms):.3f}, "
          f"max {max(step_ms):.3f}; host wall {wall_ms:.3f} per step; all {step_ms}")
    require(bool(torch.isfinite(loss)), "non-finite loss in the warm steps")

    require(np.isfinite(rel_grad) and rel_grad <= GRAD_BOUND, rel_grad)
    require(np.isfinite(rel_loss) and rel_loss <= LOSS_BOUND, rel_loss)
    require(all(np.isfinite(v) and v <= LEAF_BOUND for v in leaf_rel.values()), leaf_rel)
    return dict(grad_rel_l2=rel_grad, loss_rel=rel_loss, leaf_grad_rel_l2=leaf_rel,
                span_ms=spans, profiler_ms=kernel_ms, warm_step_ms=step_ms,
                warm_step_wall_ms=wall_ms)


def cuda_span(spans, name, fn):
    """``fn()`` between two CUDA events; its device-clock ms into ``spans``."""
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    e0.record()
    out = fn()
    e1.record()
    torch.cuda.synchronize()
    spans[name] = e0.elapsed_time(e1)
    return out


def adversarial_phase(conv_cf, root):
    """The adversarial main path on the label maps under ``root``: training
    plus a resume, one critic update's gradient against plain float32 double
    autograd, where a 10:1 cycle's time goes, warm cycles; then the float32
    run at 64³."""
    from synthsr_tpu_torch.train import adversarial as adv

    phase("main path: adversarial fine-tuning (bench_adversarial.py configuration, 128^3, "
          "bf16)")
    print(f"  reduction: first_training_ratio {ADV_FIRST_RATIO} (100 in the configuration), "
          f"1 epoch x 2 steps and a resume to epoch 2", flush=True)
    # the synthetic priors' first channel (the configuration synthesises one)
    pm = np.load(os.path.join(root, "prior_means.npy"))[:2]
    ps = np.load(os.path.join(root, "prior_stds.npy"))[:2]
    args = (os.path.join(root, "labels"), None, os.path.join(root, "adv"), pm, ps,
            os.path.join(root, "generation_labels.npy"))
    logs = []
    kw = dict(ADV_CONFIG, loss_cropping=96, first_training_ratio=ADV_FIRST_RATIO,
              training_ratio=ADV_RATIO, steps_per_epoch=2, seed=0, compute_dtype="bfloat16",
              log_fn=lambda line: (logs.append(line), print("  " + line, flush=True)))
    conv_cf.reset_launch_counts()
    t0 = time.perf_counter()
    first = adv.training(*args, epochs=1, **kw)
    resumed = adv.training(*args, epochs=2, **kw)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = dict(conv_cf.LAUNCHES)
    cycles = 4
    print(f"  training(): 1 epoch + resume to 2, {cycles} cycles of {ADV_RATIO} critic updates "
          f"+ 1 generator update in {seconds:.2f} s; launches {launches} (expected "
          f"{ADV_LAUNCHES} per cycle)")
    require(launches == {k: v * cycles for k, v in ADV_LAUNCHES.items()}, launches)
    d_curve, g_curve = resumed["d_curve"], resumed["g_curve"]
    require(d_curve[0] == first["d_curve"][0] and len(d_curve) == len(g_curve) == 2, d_curve)
    require(all(np.isfinite(d_curve + g_curve)), (d_curve, g_curve))
    require("resuming from epoch 1" in logs, "no resume")
    require(sum("Epoch 2/2" in line for line in logs) == 1, "epoch 2 ran more than once")
    require(sum(f"{2 * ADV_RATIO} critic updates" in line for line in logs) == 2, logs)
    files = sorted(os.listdir(args[2]))
    require({"adv_001.pt", "adv_002.pt"} <= set(files), files)
    h5 = {"generator_1.h5", "discriminator_2.h5"} <= set(files)
    require(h5 or any("h5py is not installed" in line for line in logs), files)
    print(f"  critic loss curve {d_curve}, generator {g_curve}; files {files}")
    summary = dict(d_curve=d_curve, g_curve=g_curve, launches=launches, seconds=seconds,
                   h5_exported=h5)
    summary.update(adversarial_checks(conv_cf, adv, resumed, root, pm, ps))

    phase("main path: adversarial in float32 (1 step, ratio 1, 64^3: H-first-x3, H-fwd-x3, "
          "H-wgrad-x3)")
    conv_cf.reset_launch_counts()
    t0 = time.perf_counter()
    f32 = adv.training(*args[:2], os.path.join(root, "adv_f32"), *args[3:], epochs=1,
                       **dict(kw, output_shape=64, loss_cropping=48, first_training_ratio=1,
                              training_ratio=1, steps_per_epoch=1, compute_dtype="float32"))
    torch.cuda.synchronize()
    f32_s = time.perf_counter() - t0
    f32_launches = dict(conv_cf.LAUNCHES)
    print(f"  training(): 1 critic + 1 generator update in {f32_s:.2f} s; launches "
          f"{f32_launches} (expected {ADV_F32_LAUNCHES})")
    require(f32_launches == ADV_F32_LAUNCHES, f32_launches)
    require(all(np.isfinite(f32["d_curve"] + f32["g_curve"])), f32)
    summary["float32"] = dict(seconds=f32_s, launches=f32_launches, d_curve=f32["d_curve"],
                              g_curve=f32["g_curve"])
    return {"launches": launches, "f32_launches": f32_launches, "summary": summary,
            "trained": resumed, "priors": (pm, ps)}


def adversarial_checks(conv_cf, adv, trained, root, pm, ps):
    """On the trained networks and one generated batch: a critic update's loss
    and gradient and d(D(fake))/d(fake), bf16 kernel path vs plain float32
    double autograd; the spans of each update's parts; a profiled cycle; and
    ADV_CYCLES warm 10:1 cycles of make_adversarial_steps."""
    from synthsr_tpu_torch.models.discriminator import Discriminator3D, critic_forward
    from synthsr_tpu_torch.models.discriminator_cf import fast_disc_apply, fast_disc_input_grad
    from synthsr_tpu_torch.train.training import example_generators, generate_batch
    from synthsr_tpu_torch.utils.finite_guard import adam_init, gated_adam_step

    phase("one critic update: kernel path (bf16) vs plain float32 double autograd")
    dev = torch.device("cuda")
    gen_model, critic = trained["gen_model"], trained["critic"]
    generator, sampler, batch = adversarial_generator(root, dev, pm, ps)
    gen = torch.Generator().manual_seed(1)  # the step generator stays on the host
    image, target = generate_batch(generator, sampler, example_generators(gen, 1, 0, dev), batch)
    fake = adv.fake_volumes(gen_model, image)
    require(image.shape == fake.shape == target.shape == (1, 128, 128, 128, 1),
            (image.shape, fake.shape, target.shape))
    require(bool(torch.isfinite(fake).all() and torch.isfinite(target).all()), "non-finite pair")
    cf = (lambda t: t.permute(0, 4, 1, 2, 3))  # noqa: E731
    # both paths get the kernel path's bf16-rounded volumes, as every kernel
    # row gets the same rounded inputs
    tgt, fk = (cf(t).to(torch.bfloat16).float() for t in (target, fake))
    w = torch.rand((1, 1, 1, 1, 1), generator=gen).to(dev)
    plain = Discriminator3D(critic.input_shape).to(dev)
    plain.load_state_dict(critic.state_dict())
    losses, grads, terms = {}, {}, {}
    for name, net, fast in (("kernel", critic, True), ("plain", plain, False)):
        d_real, d_fake, gp = adv.critic_terms(net, dict(net.named_parameters()), tgt, fk, w,
                                              fast=fast)
        loss = torch.mean(-d_real) + torch.mean(d_fake) + gp  # adv.critic_loss
        grads[name] = torch.autograd.grad(loss, list(net.parameters()))
        losses[name] = float(loss.detach())
        terms[name] = np.array([float(d_real), float(d_fake), float(gp)])
    dt = terms["kernel"] - terms["plain"]
    rel_scores = float(np.linalg.norm(dt[:2]) / np.linalg.norm(terms["plain"][:2]))
    rel_gp = float(abs(dt[2]) / abs(terms["plain"][2]))
    rel_loss = abs(losses["kernel"] - losses["plain"]) / float(np.abs(terms["plain"]).sum())
    print(f"  D(target), D(fake), GP: kernel {terms['kernel'].tolist()}, plain "
          f"{terms['plain'].tolist()}; scores relative L2 {rel_scores:.3e} (bound "
          f"{NET_BOUND:.0e}), GP relative {rel_gp:.3e} (bound {LOSS_BOUND:.0e})")
    flat = lambda gs: torch.cat([g.reshape(-1) for g in gs])  # noqa: E731
    rel_grad = float((flat(grads["kernel"]) - flat(grads["plain"])).norm()
                     / flat(grads["plain"]).norm())
    leaf_rel = {n: float((a - b).norm() / b.norm())
                for (n, p), a, b in zip(critic.named_parameters(), grads["kernel"],
                                        grads["plain"]) if p.dim() == 5}
    # the generator update's path into the critic: d(D(fake))/d(fake)
    dfake = {}
    for name, net, fn in (("kernel", critic, fast_disc_apply),
                          ("plain", plain, lambda m, p, x: critic_forward(p, x, None, 4))):
        x = fk.clone().requires_grad_(True)
        frozen = {n: p.detach() for n, p in net.named_parameters()}
        dfake[name] = torch.autograd.grad(fn(net, frozen, x).sum(), x)[0].float()
    rel_dfake = float((dfake["kernel"] - dfake["plain"]).norm() / dfake["plain"].norm())
    print(f"  critic loss kernel {losses['kernel']:.6f} plain {losses['plain']:.6f}: difference "
          f"over the terms' magnitudes {rel_loss:.3e} (bound {LOSS_BOUND:.0e}); gradient "
          f"relative L2 {rel_grad:.3e} "
          f"(bound {GRAD_BOUND:.0e}); d(D(fake))/d(fake) relative L2 {rel_dfake:.3e} (bound "
          f"{LEAF_BOUND:g}, one tensor); conv weight gradients relative L2 (bound "
          f"{LEAF_BOUND:g}):")
    for n, v in leaf_rel.items():
        print(f"    {n:24s} {v:.3e}")
    del grads, dfake, plain
    torch.cuda.empty_cache()

    phase("where a warm adversarial cycle's time goes (CUDA events, then torch.profiler)")
    params = list(critic.parameters())
    gen_params = list(gen_model.parameters())
    d_opt, g_opt = adam_init(params), adam_init(gen_params)
    spans = {"critic update": {}, "generator update": {}}

    def critic_update(s):
        nonlocal d_opt
        im, tg = cuda_span(s, "generation", lambda: generate_batch(
            generator, sampler, example_generators(gen, 1, 0, dev), batch))
        fk = cuda_span(s, "fake forward", lambda: adv.fake_volumes(gen_model, im))
        named = dict(critic.named_parameters())
        x_hat = adv.random_weighted_average(cf(tg), cf(fk), torch.rand(
            (1, 1, 1, 1, 1), generator=gen).to(dev))
        d = cuda_span(s, "critic WGAN term", lambda: fast_disc_apply(
            critic, named, torch.cat([cf(tg), cf(fk)])))
        gp = cuda_span(s, "GP program", lambda: adv.gradient_penalty_from_grads(
            fast_disc_input_grad(critic, named, x_hat)))
        loss = torch.mean(-d[:1]) + torch.mean(d[1:]) + gp
        gs = cuda_span(s, "backward", lambda: torch.autograd.grad(loss, params))
        with torch.no_grad():
            d_opt = cuda_span(s, "Adam", lambda: gated_adam_step(
                params, gs, d_opt, torch.isfinite(loss), 1e-4))

    def generator_update(s):
        nonlocal g_opt
        im, tg = cuda_span(s, "generation", lambda: generate_batch(
            generator, sampler, example_generators(gen, 1, 0, dev), batch))
        frozen = {n: p.detach() for n, p in critic.named_parameters()}
        loss, _ = cuda_span(s, "forward + loss", lambda: adv.generator_loss(
            gen_model, critic, frozen, im, tg, loss_cropping=96))
        gs = cuda_span(s, "backward", lambda: torch.autograd.grad(loss, gen_params))
        with torch.no_grad():
            g_opt = cuda_span(s, "Adam", lambda: gated_adam_step(
                gen_params, gs, g_opt, torch.isfinite(loss), 1e-4))

    for _ in range(2):  # the second pass is the one kept
        critic_update(spans["critic update"])
        generator_update(spans["generator update"])
    for part, s in spans.items():
        print(f"  {part}, ms: {s} (sum {sum(s.values()):.3f})")

    disc_step, gen_step = adv.make_adversarial_steps(gen_model, critic, generator, sampler,
                                                     loss_cropping=96)

    def cycle():
        nonlocal d_opt, g_opt
        for _ in range(ADV_RATIO):
            d_opt, d_loss = disc_step(d_opt, gen, batch)
        g_opt, g_loss = gen_step(g_opt, gen, batch)
        return d_loss, g_loss

    cycle()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        cycle()
        torch.cuda.synchronize()
        prof_wall_ms = (time.perf_counter() - t0) * 1e3
    kinds = {"H-first-mma": "conv3d_first_mma_kernel", "H-fwd-wg": "conv3d_fwd_wg_kernel",
             "H-fwd-mma": "conv3d_fwd_mma_kernel", "H-wgrad-mma": "conv3d_wgrad_mma_kernel",
             "H-wgrad-wg": "conv3d_wgrad_wg_kernel"}
    device_ms = dict.fromkeys([*kinds, "other"], 0.0)
    others = []
    for ev in prof.key_averages():
        ms = (getattr(ev, "self_device_time_total", 0) or 0) / 1e3
        kind = next((k for k, tag in kinds.items() if tag in ev.key), "other")
        device_ms[kind] += ms
        if kind == "other" and ms > 0:
            others.append((ms, ev.key[:70]))
    idle = 1.0 - sum(device_ms.values()) / prof_wall_ms
    print(f"  profiled cycle: wall {prof_wall_ms:.1f} ms, device ms "
          f"{ {k: round(v, 3) for k, v in device_ms.items()} }, device idle {idle:.1%}; "
          f"largest other kernels:")
    for ms, k in sorted(others, reverse=True)[:10]:
        print(f"    {ms:8.2f} ms  {k}")

    phase(f"{ADV_CYCLES} warm 10:1 cycles ({ADV_RATIO} critic updates + 1 generator update), "
          f"CUDA events")
    conv_cf.reset_launch_counts()
    events = [torch.cuda.Event(enable_timing=True) for _ in range(ADV_CYCLES + 1)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    events[0].record()
    for e in events[1:]:
        d_loss, g_loss = cycle()
        e.record()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / ADV_CYCLES
    cycle_ms = [a.elapsed_time(b) for a, b in zip(events, events[1:])]
    cycle_launches = dict(conv_cf.LAUNCHES)
    median = float(np.median(cycle_ms))
    print(f"  ms per cycle: median {median:.3f}, min {min(cycle_ms):.3f}, max "
          f"{max(cycle_ms):.3f} ({1e3 / median:.4f} generator updates/s); host wall "
          f"{wall_ms:.3f} per cycle; all {cycle_ms}; launches {cycle_launches}")
    require(cycle_launches == {k: v * ADV_CYCLES for k, v in ADV_LAUNCHES.items()},
            cycle_launches)
    require(bool(torch.isfinite(d_loss) and torch.isfinite(g_loss)), "non-finite warm losses")

    odd = odd_size_critic_check(conv_cf, adv)

    require(np.isfinite(rel_scores) and rel_scores <= NET_BOUND, rel_scores)
    require(np.isfinite(rel_gp) and rel_gp <= LOSS_BOUND, rel_gp)
    require(np.isfinite(rel_loss) and rel_loss <= LOSS_BOUND, rel_loss)
    require(np.isfinite(rel_grad) and rel_grad <= GRAD_BOUND, rel_grad)
    require(np.isfinite(rel_dfake) and rel_dfake <= LEAF_BOUND, rel_dfake)
    require(all(np.isfinite(v) and v <= LEAF_BOUND for v in leaf_rel.values()), leaf_rel)
    return dict(critic_loss=losses, critic_terms={k: v.tolist() for k, v in terms.items()},
                critic_scores_rel_l2=rel_scores, critic_gp_rel=rel_gp, critic_loss_rel=rel_loss,
                odd_size_critic=odd,
                critic_grad_rel_l2=rel_grad,
                critic_leaf_grad_rel_l2=leaf_rel, dfake_rel_l2=rel_dfake, span_ms=spans,
                profiled_cycle_wall_ms=prof_wall_ms, profiled_device_ms=device_ms,
                profiled_device_idle=idle, warm_cycle_ms=cycle_ms, warm_cycle_wall_ms=wall_ms,
                generator_updates_per_s=1e3 / median)


def odd_size_critic_check(conv_cf, adv):
    """The critic's kernel paths at a size that turns odd on the way down
    (the 24^3 output of a 3-level generator: 24 -> 12 -> 6 -> 3 -> 2), a
    32-filter 4-level critic on seeded random weights and inputs: scores, the
    penalty's input gradient and its parameter gradient against the plain
    critic by double autograd, in float32 (H-first-x3 / H-fwd-x3, NET_F32_BOUND:
    sum order only), and in bf16 (H-first-mma / H-fwd-mma) the scores and the
    penalty by NET_BOUND against plain float32.  The bf16 gradients are
    printed, not bounded: on these random weights they sit near 0.1-0.15
    relative L2 from bf16 LeakyReLU branch choices alone (the same against a
    plain bf16 critic), where the critic update at 128^3 holds them.  Each
    path must launch its kernels."""
    from synthsr_tpu_torch.models.discriminator import Discriminator3D
    from synthsr_tpu_torch.models.discriminator_cf import fast_disc_apply, fast_disc_input_grad
    from synthsr_tpu_torch.models.weights import disc_variables_to_state_dict, \
        random_disc_variables

    phase("the critic's kernel paths at an odd size (24^3: 3^3 at level 3)")
    dev = torch.device("cuda")
    spatial = (24, 24, 24)
    gen = torch.Generator(device=dev).manual_seed(3)
    x = torch.randn((2, 1, *spatial), generator=gen, device=dev)
    plain = Discriminator3D(spatial).to(dev)
    plain.load_state_dict(disc_variables_to_state_dict(random_disc_variables(spatial, seed=4)))
    params = dict(plain.named_parameters())
    with torch.no_grad():
        d_want = plain(x)
    x1 = x[:1].clone().requires_grad_(True)
    (gx_want,) = torch.autograd.grad(plain(x1).sum(), x1, create_graph=True)
    gp_want = adv.gradient_penalty_from_grads(gx_want)
    gp_grads_want = torch.autograd.grad(gp_want, list(plain.parameters()), allow_unused=True,
                                        materialize_grads=True)
    flat = lambda gs: torch.cat([g.reshape(-1) for g in gs])  # noqa: E731
    rl2 = lambda a, b: float((a.float() - b).norm() / b.norm())  # noqa: E731
    out = {}
    for dtype, kernels in ((torch.float32, ("first_x3", "fwd_x3")),
                           (torch.bfloat16, ("first_mma", "fwd_wg", "fwd_mma"))):
        critic = Discriminator3D(spatial, compute_dtype=dtype).to(dev)
        critic.load_state_dict(plain.state_dict())
        named = dict(critic.named_parameters())
        before = dict(conv_cf.LAUNCHES)
        with torch.no_grad():
            d = fast_disc_apply(critic, named, x)
        gx = fast_disc_input_grad(critic, named, x[:1])
        gp = adv.gradient_penalty_from_grads(gx)
        gp_grads = torch.autograd.grad(gp, list(critic.parameters()), allow_unused=True,
                                       materialize_grads=True)
        torch.cuda.synchronize()
        launched = {k: conv_cf.LAUNCHES[k] - before[k] for k in kernels}
        rel = dict(scores=rl2(d, d_want), gp=rl2(gp.detach(), gp_want.detach()),
                   input_grad=rl2(gx.detach(), gx_want.detach()),
                   gp_grad=rl2(flat(gp_grads), flat(gp_grads_want)))
        if dtype == torch.float32:
            bounds = dict.fromkeys(rel, NET_F32_BOUND)
        else:
            bounds = dict(scores=NET_BOUND, gp=NET_BOUND)
        name = str(dtype)[6:]
        print(f"  {name}: launches {launched}; relative to plain float32 {rel} (bounds "
              f"{bounds})")
        require(all(v > 0 for v in launched.values()), (name, launched))
        require(all(np.isfinite(rel[k]) and rel[k] <= b for k, b in bounds.items()), (name, rel))
        out[name] = dict(launches=launched, rel=rel)
    return out


def segmenter_files(root):
    """A frozen segmenter for the Dice regulariser: the shipped architecture
    (24 features, 5 levels) with a softmax head of one output per generation
    label and seeded random weights, saved as a ``.pt`` state dict (the card's
    machine has no h5py); the label list, which is also the equivalency
    (output i is label i)."""
    from synthsr_tpu_torch.models.weights import random_variables, variables_to_state_dict

    labels = np.load(os.path.join(root, "generation_labels.npy"))
    cfg = dict(nb_labels=len(labels), final_pred_activation="softmax")
    path = os.path.join(root, "segmenter.pt")
    torch.save(variables_to_state_dict(random_variables(cfg, in_channels=1, seed=7)), path)
    labels_path = os.path.join(root, "segmentation_labels.npy")
    np.save(labels_path, labels)
    return path, labels_path


def load_segmenter_loss(seg_path, labels_path, dtype):
    """The train path's Dice term on the segmenter of :func:`segmenter_files`
    (no clip bounds: the configuration synthesises its target), the
    segmenter run in ``dtype``."""
    from synthsr_tpu_torch.train.training import frozen_segmenter

    return frozen_segmenter(seg_path, labels_path, labels_path, np.load(labels_path), None, 96,
                            False, torch.device("cuda"), {}, dtype)


def seg_train_phase(conv_cf, root):
    """The train CLI at batch 2 with the frozen segmenter (remat "levels" by
    default at 2 examples), 1 epoch and a resume, then one step against the
    plain float32 autograd, remat against no remat, and the segmenter's share
    of a step."""
    from synthsr_tpu_torch.cli import train as train_cli

    phase('main path: train at batch 2 with the frozen segmenter (remat "levels" by default)')
    seg_path, labels_path = segmenter_files(root)
    model_dir = os.path.join(root, "model_seg")
    seg_args = ["--segmentation_model_file", seg_path, "--segmentation_label_list", labels_path,
                "--segmentation_label_equivalency", labels_path]
    logs = []
    log = (lambda line: (logs.append(line), print("  " + line, flush=True)))
    conv_cf.reset_launch_counts()
    t0 = time.perf_counter()
    first = train_cli.main(train_args(root, model_dir, 1, steps=SEG_TRAIN_STEPS, batch=2)
                           + seg_args, log_fn=log)
    resumed = train_cli.main(train_args(root, model_dir, 2, steps=SEG_TRAIN_STEPS, batch=2)
                             + seg_args, log_fn=log)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = dict(conv_cf.LAUNCHES)
    steps = 2 * SEG_TRAIN_STEPS
    print(f"  main(): 1 epoch + resume to 2, {steps} steps at batch 2 in {seconds:.2f} s; "
          f"launches {launches} (expected {SEG_TRAIN_LAUNCHES} per step)")
    require(launches == {k: v * steps for k, v in SEG_TRAIN_LAUNCHES.items()}, launches)
    curve = first["loss_curve"] + resumed["loss_curve"]
    require(len(curve) == 2 and all(np.isfinite(curve)) and 0 < max(curve) < 10, curve)
    require(any("resuming from epoch 1" in line for line in logs), "no resume")
    require(os.path.isfile(os.path.join(model_dir, "002.pt")), os.listdir(model_dir))
    summary = dict(loss_curve=curve, launches=launches, seconds=seconds)
    summary.update(seg_step_checks(resumed["model"], root, seg_path, labels_path))
    return {"launches": launches, "summary": summary, "trained": resumed["model"],
            "segmenter": (seg_path, labels_path)}


def seg_step_checks(trained, root, seg_path, labels_path):
    """On the trained weights and one generated batch of 2: the segmenter step
    on the kernels (bf16, remat "levels") against plain float32 autograd (the
    segmenter in float32 too); the step with remat=False and "levels" (equal;
    peak memory and time of each); the segmenter's share of a step."""
    from synthsr_tpu_torch.models.unet import UNet3D
    from synthsr_tpu_torch.train.training import (example_generators, forward_loss,
                                                  generate_batch)

    phase('one segmenter step at batch 2: kernel path (bf16, remat "levels") vs plain float32')
    dev = torch.device("cuda")
    model = UNet3D(in_channels=4).to(dev)
    model.load_state_dict(trained.state_dict())
    seg_bf16 = load_segmenter_loss(seg_path, labels_path, torch.bfloat16)
    seg_f32 = load_segmenter_loss(seg_path, labels_path, torch.float32)
    generator, sampler, batch = tutorial7_generator(root, dev, 2, return_labels=True)
    gens = example_generators(torch.Generator().manual_seed(2), 2, 0, dev)
    image, target, seg_target = generate_batch(generator, sampler, gens, batch)
    require(image.shape == (2, 128, 128, 128, 4) and seg_target.shape == (2, 128, 128, 128, 1),
            (image.shape, seg_target.shape))
    params = list(model.parameters())

    def run(fast, remat, seg):
        loss, _ = forward_loss(model, image, target, "l1", 96, [2], torch.bfloat16, fast=fast,
                               remat=remat, seg_loss_fn=seg, seg_target=seg_target)
        return loss, torch.autograd.grad(loss, params)

    loss_k, grads_k = run(True, "levels", seg_bf16)
    loss_p, grads_p = run(False, False, seg_f32)
    flat = lambda gs: torch.cat([g.reshape(-1) for g in gs])  # noqa: E731
    rel_grad = float((flat(grads_k) - flat(grads_p)).norm() / flat(grads_p).norm())
    rel_loss = abs(float(loss_k.detach()) - float(loss_p.detach())) / abs(float(loss_p.detach()))
    leaf_rel = {n: float((a - b).norm() / b.norm())
                for (n, p), a, b in zip(model.named_parameters(), grads_k, grads_p)
                if p.dim() == 5 and p.shape[-1] == 3}
    worst = max(leaf_rel, key=leaf_rel.get)
    print(f"  loss kernel {float(loss_k.detach()):.6f} plain {float(loss_p.detach()):.6f}: "
          f"relative {rel_loss:.3e} (bound {LOSS_BOUND:.0e}); gradient relative L2 "
          f"{rel_grad:.3e} (bound {GRAD_BOUND:.0e}); worst 3³-conv weight gradient {worst} "
          f"{leaf_rel[worst]:.3e} (bound {LEAF_BOUND:g})")
    del grads_k, grads_p, loss_k, loss_p
    torch.cuda.empty_cache()

    phase('the segmenter step with remat=False and "levels": equal results, peak memory, time')
    variants = {"False": (False, seg_bf16), "levels": ("levels", seg_bf16),
                "levels, no segmenter": ("levels", None)}
    steps = {name: dict(ms=[]) for name in variants}
    for rep in range(SEG_STEP_REPS + 1):  # in turns; the first round warms up
        for name, (remat, seg) in variants.items():
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            start = torch.cuda.memory_allocated()
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            e0.record()
            loss, grads = run(True, remat, seg)
            e1.record()
            torch.cuda.synchronize()
            if rep:
                peak = torch.cuda.max_memory_allocated()
                steps[name].update(peak_bytes=peak, peak_above_start_bytes=peak - start,
                                   loss=loss.detach(), grads=grads)
                steps[name]["ms"].append(e0.elapsed_time(e1))
            del loss, grads
    for name, st in steps.items():
        st["median_ms"] = float(np.median(st["ms"]))
        print(f"  remat {name}: forward + backward median {st['median_ms']:.3f} ms of "
              f"{[round(v, 3) for v in st['ms']]}, peak allocated "
              f"{st['peak_bytes'] / 2 ** 30:.3f} GiB "
              f"({st['peak_above_start_bytes'] / 2 ** 30:.3f} above the start)")
    a, b = steps["False"], steps["levels"]
    bit_equal = bool(torch.equal(a["loss"], b["loss"])
                     and all(torch.equal(x, y) for x, y in zip(a["grads"], b["grads"])))
    remat_rel = max([abs(float(a["loss"] - b["loss"])) / abs(float(a["loss"]))]
                    + [float((x - y).norm() / y.norm().clamp_min(1e-30))
                       for x, y in zip(a["grads"], b["grads"])])
    no_seg = steps["levels, no segmenter"]["median_ms"]
    share = 1.0 - no_seg / b["median_ms"]
    pred = torch.rand((2, 128, 128, 128, 1), device=dev).requires_grad_(True)
    seg_ms = cuda_ms(lambda: torch.autograd.grad(seg_bf16(pred, seg_target), pred), 3)
    print(f"  remat False vs levels: bit-equal {bit_equal}, largest relative difference "
          f"{remat_rel:.3e} (bound {REMAT_BOUND:.0e}); the segmenter's share of the step "
          f"{share:.1%} (median {b['median_ms']:.3f} ms with it, {no_seg:.3f} without); its "
          f"forward + backward alone {seg_ms:.3f} ms")
    require(np.isfinite(rel_grad) and rel_grad <= GRAD_BOUND, rel_grad)
    require(np.isfinite(rel_loss) and rel_loss <= LOSS_BOUND, rel_loss)
    require(all(np.isfinite(v) and v <= LEAF_BOUND for v in leaf_rel.values()), leaf_rel)
    require(np.isfinite(remat_rel) and remat_rel <= REMAT_BOUND, remat_rel)
    steps = {k: {m: v[m] for m in ("ms", "median_ms", "peak_bytes", "peak_above_start_bytes")}
             for k, v in steps.items()}
    return dict(grad_rel_l2=rel_grad, loss_rel=rel_loss, leaf_grad_rel_l2=leaf_rel,
                remat_steps=steps, remat_bit_equal=bit_equal, remat_rel=remat_rel,
                segmenter_share=share, segmenter_fwd_bwd_ms=seg_ms)


def dp_phase(conv_cf, root, trained, segmenter, adv_trained, pm, ps):
    """One train step (the segmenter step at batch 2) and one 10:1 adversarial
    cycle inside a one-rank NCCL group, each against the same step with no
    group: exactly equal."""
    import torch.distributed as dist

    from synthsr_tpu_torch.models.discriminator import Discriminator3D
    from synthsr_tpu_torch.models.unet import UNet3D
    from synthsr_tpu_torch.train import adversarial as adv
    from synthsr_tpu_torch.train.training import make_train_step
    from synthsr_tpu_torch.utils.finite_guard import adam_init

    phase("data parallelism at world size 1 (NCCL): a train step and an adversarial cycle in "
          "a one-rank group vs no group")
    dev = torch.device("cuda")
    dist.init_process_group("nccl", init_method="file://" + os.path.join(root, "rendezvous"),
                            world_size=1, rank=0)
    try:
        group = dist.group.WORLD
        seg_fn = load_segmenter_loss(*segmenter, torch.bfloat16)
        generator, sampler, batch = tutorial7_generator(root, dev, 2, return_labels=True)
        adv_generator, adv_sampler, adv_batch = adversarial_generator(root, dev, pm, ps)
        train, cycle = {}, {}
        conv_cf.reset_launch_counts()
        for name, g in (("no group", None), ("one-rank group", group)):
            model = UNet3D(in_channels=4).to(dev)
            model.load_state_dict(trained.state_dict())
            step = make_train_step(model, generator, sampler, 1e-4, metrics="l1",
                                   loss_cropping=96, residual_indices=[2], seg_loss_fn=seg_fn,
                                   remat="levels", group=g)
            _, loss = step(adam_init(list(model.parameters())), torch.Generator().manual_seed(3),
                           batch)
            train[name] = [loss, *model.state_dict().values()]
            gen_model = UNet3D(in_channels=1).to(dev)
            gen_model.load_state_dict(adv_trained["gen_model"].state_dict())
            critic = Discriminator3D((128,) * 3, compute_dtype=torch.bfloat16).to(dev)
            critic.load_state_dict(adv_trained["critic"].state_dict())
            disc_step, gen_step = adv.make_adversarial_steps(
                gen_model, critic, adv_generator, adv_sampler, loss_cropping=96, group=g)
            gen = torch.Generator().manual_seed(4)
            d_opt = adam_init(list(critic.parameters()))
            losses = []
            for _ in range(ADV_RATIO):
                d_opt, d_loss = disc_step(d_opt, gen, adv_batch)
                losses.append(d_loss)
            _, g_loss = gen_step(adam_init(list(gen_model.parameters())), gen, adv_batch)
            cycle[name] = [*losses, g_loss, *gen_model.state_dict().values(),
                           *critic.state_dict().values()]
        torch.cuda.synchronize()
        launches = dict(conv_cf.LAUNCHES)
    finally:
        dist.destroy_process_group()
    equal = {k: all(torch.equal(a, b) for a, b in zip(v["no group"], v["one-rank group"]))
             for k, v in (("train step", train), ("adversarial cycle", cycle))}
    want = {k: 2 * (SEG_TRAIN_LAUNCHES[k] + ADV_LAUNCHES[k]) for k in NO_LAUNCHES}
    print(f"  exactly equal to the step without a group: {equal}; train loss "
          f"{float(train['one-rank group'][0]):.6f}, critic losses "
          f"{[round(float(x), 6) for x in cycle['one-rank group'][:ADV_RATIO]]}, generator "
          f"{float(cycle['one-rank group'][ADV_RATIO]):.6f}; launches {launches} (expected "
          f"{want})")
    require(all(equal.values()), equal)
    require(all(np.isfinite(float(x)) for x in cycle["one-rank group"][:ADV_RATIO + 1]), cycle)
    require(launches == want, launches)
    return {"launches": launches, "summary": dict(equal=equal, launches=launches)}


def adversarial_segmenter_phase(conv_cf, root, pm, ps, segmenter):
    """``train.adversarial.training`` for one 10:1 cycle with the frozen
    segmenter, on a folder of seeded synthetic images for its percentiles."""
    from synthsr_tpu_torch.io.volume import save_volume
    from synthsr_tpu_torch.train import adversarial as adv

    phase("adversarial: one cycle with the frozen segmenter (bench_adversarial.py configuration)")
    img_dir = os.path.join(root, "images")
    os.makedirs(img_dir)
    rng = np.random.default_rng(3)
    for i in range(3):  # one image per label map, paired in sorted order
        save_volume(phantom((160,) * 3, (1.0, 1.0, 1.0), False, rng), np.eye(4), None,
                    os.path.join(img_dir, f"subject{i}.nii.gz"))
    seg_path, labels_path = segmenter
    logs = []
    conv_cf.reset_launch_counts()
    t0 = time.perf_counter()
    out = adv.training(os.path.join(root, "labels"), img_dir, os.path.join(root, "adv_seg"), pm,
                       ps, os.path.join(root, "generation_labels.npy"),
                       path_segmentation_equivalency=labels_path,
                       segmentation_model_file=seg_path, loss_cropping=96,
                       first_training_ratio=ADV_RATIO, training_ratio=ADV_RATIO, epochs=1,
                       steps_per_epoch=1, seed=0, compute_dtype="bfloat16",
                       log_fn=lambda line: (logs.append(line), print("  " + line, flush=True)),
                       **ADV_CONFIG)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = dict(conv_cf.LAUNCHES)
    print(f"  training(): 1 cycle of {ADV_RATIO} critic updates + 1 generator update in "
          f"{seconds:.2f} s; launches {launches} (expected {ADV_LAUNCHES})")
    require(launches == ADV_LAUNCHES, launches)
    require(all(np.isfinite(out["d_curve"] + out["g_curve"])), (out["d_curve"], out["g_curve"]))
    return {"launches": launches,
            "summary": dict(seconds=seconds, d_curve=out["d_curve"], g_curve=out["g_curve"])}


def options_phase():
    """One plain train step of the full-width net with each option of
    OPTIONS at 64^3 (forward_train, a mean-square loss, autograd) from the
    same weights, input and dropout masks: float32 on the card (cuDNN),
    float32 and float64 on the CPU.  The step's loss, output and new
    BatchNorm statistics must equal the CPU's float32 step within CPU_BOUND.
    The gradient sums hundreds of thousands of terms of either sign at level
    0, so float32 resolves it only to the CPU's own float32 distance from the
    float64 step; the card's float32 gradient must be no farther from the
    float64 one than that plus CPU_BOUND."""
    from synthsr_tpu_torch.models.unet import UNet3D, draw_dropout_masks
    from synthsr_tpu_torch.models.weights import random_variables, variables_to_state_dict

    phase("U-Net options on the card: one plain float32 step each at 64^3 vs the CPU")
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.normal(size=(1, 1, 64, 64, 64)))
    t = torch.from_numpy(rng.normal(size=(1, 1, 64, 64, 64)))
    flat = (lambda ts: torch.cat([v.detach().reshape(-1).double().cpu() for v in ts]))  # noqa: E731
    out = {}
    for name, opts in OPTIONS:
        sd = variables_to_state_dict(random_variables(opts, in_channels=1, seed=6))
        masks = draw_dropout_masks(UNet3D(in_channels=1, **opts),
                                   [torch.Generator().manual_seed(8)])
        res = {}
        for dev, dtype in (("cuda", torch.float32), ("cpu", torch.float32),
                           ("cpu", torch.float64)):
            model = UNet3D(in_channels=1, **opts)
            model.load_state_dict(sd)
            model.to(dev, dtype)
            params = list(model.parameters())
            t0 = time.perf_counter()
            y, stats = model.forward_train(
                x.to(dev, dtype), dtype,
                masks=None if masks is None else {k: v.to(dev) for k, v in masks.items()})
            loss = torch.mean(torch.square(y - t.to(dev, dtype)))
            grads = torch.autograd.grad(loss, params)
            res[(dev, dtype)] = dict(loss=flat([loss]), output=flat([y]),
                                     batch_stats=flat([v for pair in stats.values()
                                                       for v in pair]),
                                     gradient=flat(grads),
                                     seconds=time.perf_counter() - t0)
        card, cpu, ref = (res[k] for k in (("cuda", torch.float32), ("cpu", torch.float32),
                                          ("cpu", torch.float64)))
        rl2 = (lambda a, b: float((a - b).norm() / b.norm()))  # noqa: E731
        rel = {k: rl2(card[k], cpu[k]) for k in ("loss", "output", "batch_stats")}
        grad = dict(card_vs_cpu=rl2(card["gradient"], cpu["gradient"]),
                    card_vs_float64=rl2(card["gradient"], ref["gradient"]),
                    cpu_vs_float64=rl2(cpu["gradient"], ref["gradient"]))
        print(f"  {name}: loss {float(card['loss']):.6f}; the step, card vs CPU relative {rel} "
              f"(bound {CPU_BOUND:.0e}); gradient relative L2 {grad} (bound: card vs float64 "
              f"<= CPU vs float64 + {CPU_BOUND:.0e}); step {card['seconds']:.2f} s on the card, "
              f"{cpu['seconds']:.2f} s on the CPU (float64 {ref['seconds']:.2f} s)")
        require(all(np.isfinite(v) and v <= CPU_BOUND for v in rel.values()), (name, rel))
        require(np.isfinite(grad["card_vs_float64"])
                and grad["card_vs_float64"] <= grad["cpu_vs_float64"] + CPU_BOUND, (name, grad))
        out[name] = dict(rel=rel, gradient=grad, card_s=card["seconds"], cpu_s=cpu["seconds"])
    return out


def head3_phase(conv_cf):
    """The fast inference forward of a full-width net with a 3-label softmax
    head (the likelihood after the last conv, in float32) at 128^3 against
    the plain float32 forward."""
    from synthsr_tpu_torch.models.unet import UNet3D
    from synthsr_tpu_torch.models.unet_cf import fast_unet_forward, pack_unet
    from synthsr_tpu_torch.models.weights import random_variables, variables_to_state_dict

    phase("fast forward with a 3-label softmax head (128^3, bf16) vs the plain float32 forward")
    dev = torch.device("cuda")
    cfg = dict(nb_labels=3, final_pred_activation="softmax")
    model = UNet3D(in_channels=1, **cfg)
    model.load_state_dict(variables_to_state_dict(random_variables(cfg, in_channels=1, seed=9)))
    model.to(dev).eval()
    x = torch.randn((1, 1, 128, 128, 128), device=dev,
                    generator=torch.Generator(device=dev).manual_seed(6))
    packed = pack_unet(model, torch.bfloat16)
    conv_cf.reset_launch_counts()
    fast = fast_unet_forward(model, x, torch.bfloat16, packed)
    torch.cuda.synchronize()
    launches = dict(conv_cf.LAUNCHES)
    with torch.no_grad():
        plain = model(x)
    rel = float((fast - plain).norm() / plain.norm())
    ms = cuda_ms(lambda: fast_unet_forward(model, x, torch.bfloat16, packed), 3)
    print(f"  output {tuple(fast.shape)}, softmax sums within "
          f"{float((fast.sum(1) - 1).abs().max()):.1e} of 1; launches {launches} (expected "
          f"{HEAD3_LAUNCHES}); vs plain float32: relative L2 {rel:.3e} (bound {NET_BOUND:.0e}); "
          f"forward {ms:.3f} ms")
    require(launches == HEAD3_LAUNCHES, launches)
    require(fast.shape == plain.shape == (1, 3, 128, 128, 128), fast.shape)
    require(np.isfinite(rel) and rel <= NET_BOUND, rel)
    return {"launches": launches, "summary": dict(rel_l2=rel, ms=ms)}


def rel_l2(a, b):
    return float((a.double() - b.double()).norm() / b.double().norm())


def halo_phase(root):
    """The D-sharded U-Net (``parallel/halo.py``, ``parallel/halo_train.py``)
    in a one-rank NCCL group (the card has one H100; NCCL puts no two ranks on
    one GPU): the full-width forward at 256^3 against the plain float32
    forward (both without autograd; the plain forward's own distance from
    float64 is the scale of summation-order differences), and one halo train
    step at 128^3 against the plain unsharded step (SGD 1e-2, l1 on the
    centre 96^3, residual channel 2), both timed, and the halo step's device
    time by kernel (torch.profiler)."""
    import copy

    import torch.distributed as dist

    from synthsr_tpu_torch.models.unet import UNet3D, synthsr_unet
    from synthsr_tpu_torch.models.weights import random_variables, variables_to_state_dict
    from synthsr_tpu_torch.parallel import halo, halo_train
    from synthsr_tpu_torch.train.metrics import regression_loss

    phase(f"halo-sharded U-Net at world size 1 (NCCL): forward {HALO_FWD_SIZE}^3 vs plain, "
          f"one train step {HALO_STEP_SIZE}^3 vs the unsharded step")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(11)
    dist.init_process_group("nccl", init_method="file://" + os.path.join(root, "halo_rdv"),
                            world_size=1, rank=0)
    try:
        group = dist.group.WORLD
        model = synthsr_unet()
        model.load_state_dict(variables_to_state_dict(random_variables(seed=0)))
        model.to(dev).eval()
        x = torch.randn((1, 1) + (HALO_FWD_SIZE,) * 3, device=dev, generator=gen)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        sharded = halo.gather_d(halo.sharded_unet_apply(model, x, group), group)
        torch.cuda.synchronize()
        fwd_peak = torch.cuda.max_memory_allocated() - base
        fwd_ms = cuda_ms(lambda: halo.sharded_unet_apply(model, x, group), 2)
        with torch.no_grad():
            plain = model(x)
            plain_ms = cuda_ms(lambda: model(x), 2)
            f32_rel = rel_l2(plain, copy.deepcopy(model).double()(x.double(), torch.float64))
        fwd_rel = rel_l2(sharded, plain)
        del x, sharded, plain
        torch.cuda.empty_cache()

        sd = variables_to_state_dict(random_variables(in_channels=4, seed=1))
        image = torch.randn((1, 4) + (HALO_STEP_SIZE,) * 3, device=dev, generator=gen)
        target = torch.randn((1, 1) + (HALO_STEP_SIZE,) * 3, device=dev, generator=gen)
        sharded_model, plain_model = (UNet3D(in_channels=4).to(dev) for _ in range(2))
        for m in (sharded_model, plain_model):
            m.load_state_dict(sd)
        step = halo_train.make_halo_train_step(
            sharded_model, torch.optim.SGD(sharded_model.parameters(), lr=1e-2), group,
            loss_cropping=96, residual_indices=[2])
        params = list(plain_model.parameters())

        def plain_step():
            out, stats = plain_model.forward_train(image)
            loss = regression_loss(out.permute(0, 2, 3, 4, 1), image.permute(0, 2, 3, 4, 1),
                                   target.permute(0, 2, 3, 4, 1), loss_cropping=96,
                                   work_with_residual_channel=[2])
            grads = torch.autograd.grad(loss, params)
            with torch.no_grad():
                for p_, g in zip(params, grads):
                    p_.sub_(1e-2 * g)
            return loss.detach(), stats

        peaks = {}
        for name, fn in (("halo", lambda: step(image, target)), ("plain", plain_step)):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            peaks[name] = (fn(), torch.cuda.max_memory_allocated() - base)
        (loss, new_stats), step_peak = peaks["halo"]
        (ref, stats), plain_step_peak = peaks["plain"]
        loss_rel = abs(float(loss) - float(ref)) / abs(float(ref))
        param_err = max(float((a - b).detach().abs().max())
                        for a, b in zip(sharded_model.parameters(), params))
        stat_err = max(float((new_stats[k][i] - stats[k][i]).abs().max())
                       for k in stats for i in (0, 1))
        # timed after the comparison: these steps move the weights on
        step_ms = cuda_ms(lambda: step(image, target), 2)
        plain_step_ms = cuda_ms(plain_step, 2)
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            step(image, target)
            torch.cuda.synchronize()
        rows = sorted((((getattr(ev, "self_device_time_total", 0) or 0) / 1e3, ev.key[:70])
                       for ev in prof.key_averages()), reverse=True)
    finally:
        dist.destroy_process_group()
    step_device_ms = sum(ms for ms, _ in rows)
    print(f"  forward {HALO_FWD_SIZE}^3 (24 features, 5 levels, no autograd): sharded "
          f"{fwd_ms:.1f} ms vs plain {plain_ms:.1f} ms, relative L2 {fwd_rel:.3e} (bound "
          f"{HALO_FWD_BOUND:.0e}; the plain float32 forward is {f32_rel:.3e} from float64), "
          f"peak {fwd_peak / 2 ** 30:.2f} GiB above the inputs")
    print(f"  train step {HALO_STEP_SIZE}^3 (4 channels, float32, SGD): halo {step_ms:.1f} ms, "
          f"peak {step_peak / 2 ** 30:.2f} GiB; plain unsharded {plain_step_ms:.1f} ms, peak "
          f"{plain_step_peak / 2 ** 30:.2f} GiB; loss {float(loss):.6f} vs {float(ref):.6f} "
          f"(relative {loss_rel:.2e}, bound {HALO_LOSS_RTOL:.0e}), parameters max |diff| "
          f"{param_err:.2e}, BatchNorm statistics {stat_err:.2e} (bound {HALO_PARAM_ATOL:.0e})")
    print(f"  profiler, one halo step: device {step_device_ms:.1f} ms; the top kernels:")
    for ms, k in rows[:6]:
        print(f"    {ms:8.2f} ms  {k}")
    require(np.isfinite(fwd_rel) and fwd_rel <= HALO_FWD_BOUND, fwd_rel)
    require(np.isfinite(float(loss)) and loss_rel <= HALO_LOSS_RTOL, loss_rel)
    require(param_err <= HALO_PARAM_ATOL and stat_err <= HALO_PARAM_ATOL, (param_err, stat_err))
    return dict(forward_ms=fwd_ms, plain_forward_ms=plain_ms, forward_rel_l2=fwd_rel,
                plain_f32_vs_f64_rel_l2=f32_rel, forward_peak_bytes=fwd_peak, step_ms=step_ms,
                step_peak_bytes=step_peak, plain_step_ms=plain_step_ms,
                plain_step_peak_bytes=plain_step_peak, step_device_ms=step_device_ms,
                step_top_kernels=[(k, ms) for ms, k in rows[:6]], step_loss_rel=loss_rel,
                step_param_max_abs=param_err, step_bn_max_abs=stat_err)


def autoencoder_phase():
    """The auto-encoder and the VAE (the default configuration, 16 features, 3
    levels, a conv bottleneck, with a 4-label softmax head) at 128^3 in
    float32 on the card against the CPU, from the same seeded weights, input
    and VAE noise."""
    from synthsr_tpu_torch.models.autoencoder import AutoEncoder3D

    phase(f"auto-encoder and VAE at {AE_SIZE}^3: the card vs the CPU")
    out = {}
    x = torch.randn((1, 1) + (AE_SIZE,) * 3, generator=torch.Generator().manual_seed(12))
    for name, vae in (("ae", False), ("vae", True)):
        torch.manual_seed(13)
        model = AutoEncoder3D(nb_labels=4, do_vae=vae)
        eps = torch.randn((1, 16) + (AE_SIZE // 4,) * 3,
                          generator=torch.Generator().manual_seed(14)) if vae else None
        with torch.no_grad():
            t0 = time.perf_counter()
            cpu = model(x, eps=eps)
            cpu_s = time.perf_counter() - t0
            model.cuda()
            card = model(x.cuda(), eps=None if eps is None else eps.cuda())
            ms = cuda_ms(lambda: model(x.cuda(), eps=None if eps is None else eps.cuda()), 3)
        rel = rel_l2(card.cpu(), cpu)
        print(f"  {name}: output {tuple(card.shape)}, card vs CPU relative L2 {rel:.3e} (bound "
              f"{AE_BOUND:.0e}); forward {ms:.2f} ms on the card, {cpu_s:.2f} s on the CPU")
        require(np.isfinite(rel) and rel <= AE_BOUND, (name, rel))
        require(torch.allclose(card.sum(1), torch.ones((), device="cuda"), atol=1e-5), name)
        out[name] = dict(rel_l2=rel, ms=ms, cpu_s=cpu_s)
    return out


def lab2im_phase(root):
    """``ImageGenerator`` on the card over the seeded synthetic 160^3 label
    maps at full size: shapes, finite values, ms per sample (StepTimer, with a
    CUDA synchronize); one sample under the ported ``trace`` (torch.profiler,
    a Chrome trace)."""
    from synthsr_tpu_torch.synth.lab2im import ImageGenerator
    from synthsr_tpu_torch.utils.profiling import StepTimer, device_memory_stats, trace

    phase(f"lab2im ImageGenerator on 160^3 label maps ({LAB2IM_SAMPLES} timed samples), "
          "one profiled with utils/profiling.trace")
    labels = np.load(os.path.join(root, "generation_labels.npy"))
    gen = ImageGenerator(os.path.join(root, "labels"), generation_labels=labels,
                         output_labels=(labels > 0).astype(np.int32), seed=0)
    timer = StepTimer(os.path.join(root, "lab2im_steps.jsonl"), warmup_steps=1)
    for _ in range(LAB2IM_SAMPLES + 1):
        with timer.step():
            image, lab = gen.generate_image()
        require(image.shape == (160, 160, 160) and lab.shape == (160, 160, 160), image.shape)
        require(np.isfinite(image).all() and 0 <= image.min() and image.max() <= 1 + 1e-5,
                (image.min(), image.max()))
        require(set(np.unique(lab)) <= {0, 1}, np.unique(lab))
    summary = timer.summary()
    log_dir = os.path.join(root, "lab2im_trace")
    with trace(log_dir) as prof:
        gen.generate_image()
        torch.cuda.synchronize()
    events = prof.key_averages()
    device_us = sum(getattr(e, "self_device_time_total", 0) or 0 for e in events)
    trace_bytes = os.path.getsize(os.path.join(log_dir, "trace.json"))
    peak = device_memory_stats()["cuda:0"]["allocated_bytes.all.peak"]
    print(f"  image {image.shape}, range [{image.min():.3f}, {image.max():.3f}]; "
          f"{1e3 * summary['p50_s']:.1f} ms per sample (median of {summary['steps']}, "
          f"mean {1e3 * summary['mean_s']:.1f}); traced sample: {trace_bytes} B Chrome trace, "
          f"{len(events)} ops, device time {device_us / 1e3:.1f} ms; peak allocated "
          f"{peak / 2 ** 30:.2f} GiB")
    require(trace_bytes > 0 and len(events) > 0, trace_bytes)
    return dict(ms_per_sample=1e3 * summary["p50_s"], mean_ms=1e3 * summary["mean_s"],
                samples=summary["steps"], traced_device_ms=device_us / 1e3,
                trace_bytes=trace_bytes)


def label_ops_phase():
    """``random_dilation_erosion`` on the card (the ball convolution is
    F.conv3d) against scipy's binary dilation and erosion."""
    from scipy.ndimage import binary_dilation, binary_erosion

    from synthsr_tpu_torch.synth import label_ops

    phase("label ops: random dilation and erosion on the card vs scipy (128^3)")
    rng = np.random.default_rng(15)
    gen = torch.Generator(device="cuda").manual_seed(16)
    out = {}
    for op, radius, density, kw in (("dilation", 2, 0.9, {}),
                                    ("erosion", 1, 0.4, dict(border_value=1))):
        x = (rng.uniform(size=(128, 128, 128, 1)) > density).astype(np.float32)
        p, f = label_ops.sample_dilation_erosion(gen, radius, radius, operation=op)
        got = label_ops.random_dilation_erosion(torch.from_numpy(x).cuda(), p, f, radius,
                                                return_mask=True)
        ms = cuda_ms(lambda: label_ops.random_dilation_erosion(
            torch.from_numpy(x).cuda(), p, f, radius, return_mask=True), 3)
        ball = label_ops.unit_kernel_np(radius, 3).astype(bool)
        fn = binary_dilation if op == "dilation" else binary_erosion
        want = fn(x[..., 0] > 0, structure=ball, **kw)
        mism = int((got.cpu().numpy()[..., 0] != want).sum())
        print(f"  {op} radius {radius}: {mism} voxels differ from scipy; {ms:.3f} ms")
        require(mism == 0, (op, mism))
        out[op] = dict(mismatches=mism, ms=ms)
    return out


def native_phase(root):
    """The C++ NIfTI loader (built with g++ on first use) reads back written
    volumes bit-equal to the numpy path."""
    from synthsr_tpu_torch.io.volume import load_volume, save_volume
    from synthsr_tpu_torch.native import native_available

    phase("native NIfTI loader: written volumes read back bit-equal to the numpy path")
    t0 = time.perf_counter()
    ok = native_available()
    build_s = time.perf_counter() - t0
    require(ok, "native loader unavailable (g++ or zlib missing)")
    rng = np.random.default_rng(17)
    out = {"build_s": build_s}
    for name, vol, dtype in (("labels.nii.gz", rng.integers(0, 60, (160, 160, 160)), "int32"),
                             ("image.nii", rng.normal(50, 20, (192, 224, 192)), "float32")):
        path = os.path.join(root, name)
        save_volume(vol.astype(dtype), np.eye(4), None, path)
        times = {}
        res = {}
        for fast in (True, False):
            t0 = time.perf_counter()
            res[fast] = load_volume(path, im_only=False, dtype=dtype, fast=fast)
            times[fast] = time.perf_counter() - t0
        equal = all(np.array_equal(a, b) for a, b in zip(res[True][:2], res[False][:2]))
        print(f"  {name} {vol.shape} {dtype}: bit-equal {equal}; native {1e3 * times[True]:.1f} "
              f"ms, numpy {1e3 * times[False]:.1f} ms")
        require(equal and res[True][0].dtype == np.dtype(dtype), name)
        out[name] = dict(native_ms=1e3 * times[True], numpy_ms=1e3 * times[False])
    return out


def tutorials_phase(conv_cf, root):
    """The nine tutorial entry points in smoke mode on the card, in one
    process (``SYNTHSR_SMOKE=1``, ``SYNTHSR_DEVICE=cuda``, seeded synthetic
    96^3 label maps and priors), within TUTORIAL_LIMIT_S.  Each must write its
    outputs.  The training tutorials' conv shapes are held against the plain
    versions in "kernels vs plain" and "H-wgrad-mma and H-wgrad-x3 vs plain"
    (TUTORIAL_SHAPES, TUTORIAL_WGRAD_SHAPES)."""
    import importlib

    data = os.path.join(root, "tutorial_data")
    results = os.path.join(root, "tutorial_results")
    os.environ.update(SYNTHSR_DATA=data, SYNTHSR_RESULTS=results, SYNTHSR_SMOKE="1",
                      SYNTHSR_DEVICE="cuda")
    from synthsr_tpu_torch.examples.common import write_synthetic_data

    phase(f"tutorial entry points in smoke mode (limit {TUTORIAL_LIMIT_S:.0f} s)")
    write_synthetic_data(data, shape=(TUTORIAL_MAP,) * 3)
    conv_cf.reset_launch_counts()
    seconds = {}
    t_all = time.perf_counter()
    for name in TUTORIALS:
        t0 = time.perf_counter()
        importlib.import_module(f"synthsr_tpu_torch.examples.{name}").main()
        torch.cuda.synchronize()
        seconds[name] = time.perf_counter() - t0
        written = [f for _, _, fs in os.walk(results) for f in fs]
        print(f"  {name}: {seconds[name]:.2f} s; {len(written)} files under the results so far",
              flush=True)
    launches = dict(conv_cf.LAUNCHES)
    total = time.perf_counter() - t_all
    print(f"  all {len(TUTORIALS)} in {total:.1f} s; launches {launches}")
    require(total <= TUTORIAL_LIMIT_S, total)
    require(launches["fwd_wg"] > 0 and launches["wgrad_wg"] > 0 and launches["wgrad_mma"] > 0,
            launches)
    for sub in ("7-training", "9-log-tensor"):  # bf16 training on the kernels
        require(os.path.isfile(os.path.join(results, sub, "001.pt")), sub)
    return {"launches": launches, "summary": dict(seconds=seconds, seconds_all=total)}


def surface_phase(conv_cf, root, pm, ps):
    """What the port gained last, on the card against the CPU on the same
    draws: ``mimic_acquisition`` with noise on the acquisition grid at the
    adversarial generator's shape (ADV_CONFIG: a 1-channel volume on the 1 mm
    atlas grid up-sampled to 128^3, a resolution drawn as the generator draws
    it), the noise taken always and by a 0.95 coin; the boundary-weighted Dice
    on a batch of 2-D one-hot maps; and ``BrainGenerator`` built without
    ``device=``, which must land on the card and generate.  No conv kernel
    runs here."""
    from synthsr_tpu_torch.io.labels import get_list_labels
    from synthsr_tpu_torch.ops.losses import dice_loss
    from synthsr_tpu_torch.synth import augment
    from synthsr_tpu_torch.synth.brain_generator import BrainGenerator

    phase("the port's last surface on the card: acquisition noise, 2-D boundary Dice, "
          "BrainGenerator's default device")
    conv_cf.reset_launch_counts()
    labels, n_neutral = get_list_labels(
        label_list=os.path.join(root, "generation_labels.npy"),
        labels_dir=os.path.join(root, "labels"), FS_sort=True)
    t0 = time.perf_counter()
    bg = BrainGenerator(os.path.join(root, "labels"), pm, ps, generation_labels=labels,
                        n_neutral_labels=n_neutral, output_div_by_n=32, seed=2, **ADV_CONFIG)
    image, target = bg.generate_brain()
    gen_s = time.perf_counter() - t0
    print(f"  BrainGenerator() without device=: on {bg.device}; generate_brain {gen_s:.2f} s "
          f"(first call), image {image.shape}, target {target.shape}")
    require(bg.device.type == "cuda", bg.device)
    require(image.shape[:3] == tuple(bg.model_output_shape), (image.shape, bg.model_output_shape))
    require(np.isfinite(image).all() and np.isfinite(target).all(), "non-finite generated pair")
    out = {"brain_generator": dict(device=str(bg.device), first_call_s=gen_s,
                                   image_shape=list(image.shape))}

    cfg = bg.cfg
    crop, shape, atlas = list(cfg.crop_shape), list(cfg.out_shape), cfg.atlas_res3
    cpu = torch.Generator().manual_seed(18)
    max_res = np.array([cfg.max_res_iso] * 3, np.float32)
    res = augment.sample_resolution(cpu, list(atlas), max_res_iso=max_res,
                                    max_res_aniso=max_res, return_thickness=False)
    x = torch.rand((*crop, 1), generator=cpu)
    down = augment.acquisition_down_shape(crop, atlas, atlas)
    for name, prob in (("always", 1.0), ("coin 0.95", 0.95)):
        noise = augment.sample_acquisition_noise(cpu, down, 1, ACQ_NOISE_STD, prob)
        on_card = [x.cuda(), res.cuda(), tuple(None if a is None else a.cuda() for a in noise)]

        def acquire(x_, res_, noise_):
            return augment.mimic_acquisition(x_, res_, atlas, shape, build_dist_map=True,
                                             min_subsample_res=atlas, noise=noise_)

        t0 = time.perf_counter()
        want = acquire(x, res, noise)
        cpu_ms = 1e3 * (time.perf_counter() - t0)
        got = acquire(*on_card)
        ms = cuda_ms(lambda: acquire(*on_card), 3)
        rel = max(rel_l2(g.cpu(), w) for g, w in zip(got, want))
        taken = noise[2] is None or bool(noise[2])
        print(f"  mimic_acquisition + noise ({name}; taken {taken}): {crop} at "
              f"{res.tolist()} mm (static down grid {down}) -> {shape}; card vs CPU relative "
              f"L2 {rel:.3e} (bound {SURFACE_BOUND:.0e}); {ms:.3f} ms on the card, "
              f"{cpu_ms:.1f} ms on the CPU")
        require(tuple(got[0].shape) == (*shape, 1) and bool(torch.isfinite(got[0]).all()),
                got[0].shape)
        require(np.isfinite(rel) and rel <= SURFACE_BOUND, (name, rel))
        out[f"acquisition_noise_{name.split()[0]}"] = dict(
            resolution=res.tolist(), taken=taken, rel_l2=rel, ms=ms, cpu_ms=cpu_ms)

    g = torch.Generator().manual_seed(19)
    b, h, w, c = DICE_SHAPE
    lab = torch.randint(0, c, (b, h // 8, w // 8), generator=g)
    lab.view(b, -1)[:, :c] = torch.arange(c)  # every label in every map: finite inverse volumes
    gt = torch.nn.functional.one_hot(lab.repeat_interleave(8, 1).repeat_interleave(8, 2),
                                     c).float()
    pred = torch.softmax(torch.randn((b, h, w, c), generator=g), -1)
    kw = dict(class_weights=-1, boundary_weights=2.0, boundary_dist=3)
    t0 = time.perf_counter()
    want = float(dice_loss(gt, pred, **kw))
    cpu_ms = 1e3 * (time.perf_counter() - t0)
    gt_card, pred_card = gt.cuda(), pred.cuda()
    got = float(dice_loss(gt_card, pred_card, **kw))
    ms = cuda_ms(lambda: dice_loss(gt_card, pred_card, **kw), 3)
    rel = abs(got - want) / abs(want)
    print(f"  dice_loss, boundary weights 2.0 within 3 voxels, inverse-volume class weights, "
          f"on {DICE_SHAPE}: {got:.7f} on the card vs {want:.7f} on the CPU, relative "
          f"{rel:.3e} (bound {SURFACE_BOUND:.0e}); {ms:.3f} ms on the card, {cpu_ms:.1f} ms "
          f"on the CPU")
    require(np.isfinite(rel) and rel <= SURFACE_BOUND, rel)
    out["dice_2d"] = dict(shape=list(DICE_SHAPE), loss=got, rel=rel, ms=ms, cpu_ms=cpu_ms)
    launches = dict(conv_cf.LAUNCHES)
    require(launches == NO_LAUNCHES, launches)
    return out


def phantom(shape, zooms, ct, rng):
    """Ellipsoids of random intensity plus noise, in HU for a CT."""
    grid = np.meshgrid(*[(np.arange(n) - n / 2) * z for n, z in zip(shape, zooms)],
                       indexing="ij", sparse=True)
    vol = np.zeros(shape, np.float32)
    for _ in range(6):
        c = rng.uniform(-30, 30, 3)
        r = rng.uniform(20, 80, 3)
        inside = sum(((g - ci) / ri) ** 2 for g, ci, ri in zip(grid, c, r)) < 1
        vol[inside] = rng.uniform(200, 800) if not ct else rng.uniform(-100, 1500)
    vol += rng.normal(0, 20, shape).astype(np.float32)
    return vol


def profile_predict_volume(predictor, vol, aff):
    """Where one warm predict_volume's time goes: device time by kind
    (torch.profiler) over its wall, and the device's idle share."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        predictor.predict_volume(vol, aff)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kinds = {"H-fwd-wg": "conv3d_fwd_wg_kernel", "H-fwd-mma": "conv3d_fwd_mma_kernel",
             "H-first-mma": "conv3d_first_mma_kernel",
             "H-first-x3": "conv3d_first_x3_kernel",
             "copy host->device": "Memcpy HtoD", "copy device->host": "Memcpy DtoH"}
    device_ms = dict.fromkeys([*kinds, "other"], 0.0)
    for ev in prof.key_averages():
        ms = (getattr(ev, "self_device_time_total", 0) or 0) / 1e3
        device_ms[next((k for k, tag in kinds.items() if tag in ev.key), "other")] += ms
    idle = 1.0 - sum(device_ms.values()) / wall_ms
    print(f"  profiled predict_volume: wall {wall_ms:.1f} ms, device ms "
          f"{ {k: round(v, 3) for k, v in device_ms.items()} }, device idle {idle:.1%}")
    return wall_ms, device_ms, idle


def predict_f32_phase(predict, conv_cf, weights, clinical):
    """``Predictor(compute_dtype="float32").predict_volume`` on the clinical
    volume: the float32 path of H-first-x3 and H-fwd-x3, and
    its fast network against the plain float32 forward."""
    phase("main path: predict in float32 (H-first-x3, H-fwd-x3; clinical volume)")
    _, vol, aff, shape, zooms = clinical
    f32 = predict.Predictor(model_path=weights, compute_dtype="float32")
    conv_cf.reset_launch_counts()
    t0 = time.perf_counter()
    pred, aff_out = f32.predict_volume(vol, aff)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = dict(conv_cf.LAUNCHES)
    want = tuple(int(np.ceil(s * z)) for s, z in zip(shape, zooms))
    require(launches == PREDICT_F32_LAUNCHES, launches)
    require(pred.shape == want and np.all(np.isfinite(pred)), (pred.shape, want))
    require(pred.min() >= 0 and pred.max() <= 128, "range")
    x, _, _ = f32.prepare(vol, aff)
    # the float32 rows of SHAPES hold H-first-x3 and H-fwd-x3 at this padded shape
    require(tuple(x.shape[2:]) == (192, 224, 192), tuple(x.shape[2:]))
    with torch.no_grad():
        fast = f32.network(x)
        plain = 0.5 * f32.model(x) + 0.5 * torch.flip(f32.model(torch.flip(x, [2])), [2])
    rel = float((fast - plain).norm() / plain.norm())
    print(f"  predict_volume {seconds:.3f} s (first call); launches {launches}; padded "
          f"{tuple(x.shape[2:])}; network vs plain: relative L2 {rel:.3e} "
          f"(bound {NET_F32_BOUND:.0e})")
    require(np.isfinite(rel) and rel <= NET_F32_BOUND, rel)
    del x, fast, plain, f32
    torch.cuda.empty_cache()
    return {"launches": launches, "summary": dict(seconds=seconds, net_rel_l2=rel)}


def large_fov_phase(predict, conv_cf, weights, tmp, rng):
    """``predict.main`` on a 1 mm CT phantom that pads to 192x256x512, then
    its warm prepare, network and predict_volume times, peak memory, and the
    fast TTA network against the plain float32 forward."""
    phase("main path: predict at a large field of view (1 mm CT, 180x250x500)")
    fname, shape, zooms = LARGE_FOV
    vol = phantom(shape, zooms, True, rng)
    aff = np.diag(list(zooms) + [1.0])
    path_in = os.path.join(tmp, fname)
    path_out = os.path.join(tmp, fname.replace(".nii", "_SynthSR.nii"))
    predict.save_volume(vol, aff, None, path_in)
    conv_cf.reset_launch_counts()
    t0 = time.perf_counter()
    predict.main([path_in, path_out, "--ct", "--model", weights])
    torch.cuda.synchronize()
    main_s = time.perf_counter() - t0
    launches = dict(conv_cf.LAUNCHES)
    print(f"  main(): 1 volume in {main_s:.2f} s (incl. NIfTI I/O, weight load); "
          f"launches {launches}")
    require(launches == PREDICT_LAUNCHES, launches)
    pred, aff_out, _ = predict.load_volume(path_out, im_only=False)
    require(pred.shape == shape, (pred.shape, shape))
    require(np.allclose(aff_out[:3, :3], np.eye(3), atol=1e-6), aff_out)
    require(np.all(np.isfinite(pred)) and pred.min() >= 0 and pred.max() <= 128, "range")
    require(0 < pred.mean() < 128, pred.mean())
    print(f"  out {pred.shape} 1 mm RAS, range [{pred.min():.2f}, {pred.max():.2f}], "
          f"mean {pred.mean():.2f}")
    del pred

    ct = predict.Predictor(model_path=weights, ct=True)
    ct.predict_volume(vol, aff)  # unmeasured warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    x, _, _ = ct.prepare(vol, aff)
    torch.cuda.synchronize()
    prepare_s = time.perf_counter() - t0
    padded = tuple(x.shape[2:])
    require(padded == tuple(-(-s // 32) * 32 for s in shape), padded)
    net_ms = cuda_ms(lambda: ct.network(x), 2)
    torch.cuda.reset_peak_memory_stats()
    secs = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ct.predict_volume(vol, aff)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated()
    wall_ms, device_ms, idle = profile_predict_volume(ct, vol, aff)
    with torch.no_grad():
        fast = ct.network(x)
        plain = 0.5 * ct.model(x) + 0.5 * torch.flip(ct.model(torch.flip(x, [2])), [2])
    rel = float((fast - plain).norm() / plain.norm())
    max_out = float(255 * (fast - plain).abs().max())
    print(f"  padded {padded}  prepare {prepare_s:.3f} s  predict_volume {secs} s  network "
          f"(2 forwards) {net_ms:.1f} ms  peak allocated {peak / 2 ** 30:.2f} GiB  vs plain: "
          f"relative L2 {rel:.3e} (bound {NET_BOUND:.0e}), max |diff| x255 = {max_out:.3f}")
    require(np.isfinite(rel) and rel <= NET_BOUND, rel)
    del x, fast, plain, ct
    torch.cuda.empty_cache()
    return {"launches": launches,
            "summary": dict(padded=list(padded), main_seconds=main_s, prepare_s=prepare_s,
                            predict_volume_s=secs, network_tta_ms=net_ms,
                            peak_allocated_bytes=peak, net_rel_l2=rel,
                            profiled_wall_ms=wall_ms, device_ms=device_ms, device_idle=idle)}


def rotated_z(zooms, shape, degrees):
    """An affine of voxel size ``zooms`` rotated about z by ``degrees`` around
    the centre of a ``shape`` volume on the axis-aligned grid of the same
    voxel size."""
    c, s = np.cos(np.deg2rad(degrees)), np.sin(np.deg2rad(degrees))
    lin = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]]) @ np.diag(zooms)
    centre = (np.array(shape) - 1) / 2
    aff = np.eye(4)
    aff[:3, :3] = lin
    aff[:3, 3] = np.diag(zooms) @ centre - lin @ centre
    return aff


def hyperfine_phase(conv_cf, tmp, rng):
    """``predict_hyperfine.main`` on synthetic T1/T2 pairs (one T2 oblique),
    then per pair the warm network and predict_pair times and the residual
    network against the plain float32 forward."""
    from synthsr_tpu_torch.cli import predict_hyperfine
    from synthsr_tpu_torch.models.weights import random_variables, variables_to_state_dict

    phase("main path: Hyperfine (T1 + T2 at 1.5x1.5x5 mm, one T2 oblique)")
    weights = os.path.join(tmp, "hyperfine.pt")
    torch.save(variables_to_state_dict(random_variables(in_channels=2, seed=1)), weights)
    dirs = [os.path.join(tmp, d) for d in ("t1", "t2", "hyperfine_out")]
    for d in dirs[:2]:
        os.makedirs(d)
    zooms = (1.5, 1.5, 5.0)
    pairs = []
    for i, (shape, degrees) in enumerate(HYPERFINE):
        aff1 = np.diag(list(zooms) + [1.0])
        aff2 = rotated_z(zooms, shape, degrees)
        t1, t2 = phantom(shape, zooms, False, rng), phantom(shape, zooms, False, rng)
        predict_hyperfine.save_volume(t1, aff1, None, os.path.join(dirs[0], f"pair{i}.nii.gz"))
        predict_hyperfine.save_volume(t2, aff2, None, os.path.join(dirs[1], f"pair{i}.nii.gz"))
        pairs.append((t1, aff1, t2, aff2, shape, degrees))
    conv_cf.reset_launch_counts()
    t0 = time.perf_counter()
    predict_hyperfine.main(dirs + ["--model", weights])
    torch.cuda.synchronize()
    main_s = time.perf_counter() - t0
    launches = dict(conv_cf.LAUNCHES)
    n = len(HYPERFINE)
    print(f"  main(): {n} pairs in {main_s:.2f} s (incl. NIfTI I/O, weight load); "
          f"launches {launches}")
    require(launches == {k: v * n for k, v in HYPERFINE_LAUNCHES.items()}, launches)
    for i, (_, _, _, _, shape, _) in enumerate(pairs):
        out = os.path.join(dirs[2], f"pair{i}_SynthSR.nii.gz")
        pred, aff, _ = predict_hyperfine.load_volume(out, im_only=False)
        want = tuple(int(np.ceil(s * z)) for s, z in zip(shape, zooms))
        require(pred.shape == want, (out, pred.shape, want))
        require(np.allclose(aff[:3, :3], np.eye(3), atol=1e-6), (out, aff))
        require(np.all(np.isfinite(pred)) and pred.min() >= 0, out)
        print(f"  pair{i}: out {pred.shape} 1 mm RAS, range [{pred.min():.2f}, "
              f"{pred.max():.2f}], mean {pred.mean():.2f}")

    warm = predict_hyperfine.HyperfinePredictor(model_path=weights)
    summary = dict(main_seconds=main_s, pairs=[])
    for t1, aff1, t2, aff2, _, degrees in pairs:
        warm.predict_pair(t1, aff1, t2, aff2)  # unmeasured warm-up
        x = warm.prepare(t1, aff1, t2, aff2)[0]
        net_ms = cuda_ms(lambda: warm.network(x), 3)
        secs = []
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            warm.predict_pair(t1, aff1, t2, aff2)
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
        with torch.no_grad():
            fast = warm.network(x)
            plain = warm.model(x)
        rel = float((fast - plain).norm() / plain.norm())
        print(f"  T2 rotated {degrees:g} deg: padded {tuple(x.shape[2:])}  predict_pair {secs} s"
              f"  network {net_ms:.1f} ms  residual vs plain: relative L2 {rel:.3e} "
              f"(bound {NET_BOUND:.0e})")
        require(np.isfinite(rel) and rel <= NET_BOUND, (degrees, rel))
        summary["pairs"].append(dict(t2_degrees=degrees, padded=list(x.shape[2:]),
                                     predict_pair_s=secs, network_ms=net_ms, net_rel_l2=rel))
        del x, fast, plain
    return {"launches": launches, "summary": summary}


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        sys.exit(1)
    from synthsr_tpu_torch.cli import predict
    from synthsr_tpu_torch.ops import conv_cf, cuda_build
    from synthsr_tpu_torch.models.weights import random_variables, variables_to_state_dict

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    phase("environment")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    kind = torch.cuda.get_device_name(0)
    print(f"  python {sys.version.split()[0]}  torch {torch.__version__}  cuda {torch.version.cuda}")
    print(f"  device {kind}  count {torch.cuda.device_count()}  nvidia-smi: {smi}")

    phase("build")
    seconds = conv_cf.build_kernels()
    log = (cuda_build.BUILD_DIR / cuda_build.source_hash() / "build.log").read_text()
    print(f"  nvcc build {seconds:.1f} s (0 = reused); ptxas: {ptxas_summary(log)}")

    phase("kernels vs plain")
    gen = torch.Generator(device="cuda").manual_seed(0)
    checks = check_kernels(conv_cf, gen)

    phase("H-wgrad-wg, H-wgrad-mma and H-wgrad-x3 vs plain")
    checks += check_wgrad(conv_cf, gen)

    phase("main path: predict")
    rng = np.random.default_rng(0)
    with tempfile.TemporaryDirectory() as tmp:
        weights = os.path.join(tmp, "weights.pt")
        torch.save(variables_to_state_dict(random_variables(seed=0)), weights)
        mr_dir, out_dir = os.path.join(tmp, "mr"), os.path.join(tmp, "out")
        os.makedirs(mr_dir)
        inputs = {}
        for fname, shape, zooms, ct in VOLUMES:
            path = os.path.join(tmp if ct else mr_dir, fname)
            vol = phantom(shape, zooms, ct, rng)
            aff = np.diag(list(zooms) + [1.0])
            predict.save_volume(vol, aff, None, path)
            inputs[fname] = (path, vol, aff, shape, zooms)

        warm = predict.Predictor(model_path=weights)
        t256 = inputs["t1_256.nii.gz"]
        warm.predict_volume(t256[1], t256[2])  # unmeasured warm-up
        torch.cuda.synchronize()

        conv_cf.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        predict.main([mr_dir, out_dir, "--model", weights])
        ct_in = inputs["head_ct.nii.gz"][0]
        ct_out = os.path.join(out_dir, "head_ct_SynthSR.nii.gz")
        predict.main([ct_in, ct_out, "--ct", "--model", weights])
        torch.cuda.synchronize()
        main_s = time.perf_counter() - t0
        launches = dict(conv_cf.LAUNCHES)
        peak = torch.cuda.max_memory_allocated()
        n = len(VOLUMES)
        print(f"  main(): {n} volumes in {main_s:.2f} s (incl. NIfTI I/O, weight load); "
              f"launches {launches}; peak allocated {peak / 2 ** 30:.2f} GiB")
        require(launches == {k: v * n for k, v in PREDICT_LAUNCHES.items()}, launches)

        for fname, (_, _, _, shape, zooms) in inputs.items():
            out = os.path.join(out_dir, fname.replace(".nii.gz", "_SynthSR.nii.gz"))
            pred, aff, _ = predict.load_volume(out, im_only=False)
            want = tuple(int(np.ceil(s * z)) for s, z in zip(shape, zooms))
            require(pred.shape == want, (fname, pred.shape, want))
            require(np.allclose(np.diag(aff)[:3], 1.0, atol=1e-6), (fname, aff))
            require(np.all(np.isfinite(pred)) and pred.min() >= 0 and pred.max() <= 128, fname)
            require(0 < pred.mean() < 128, (fname, pred.mean()))
            print(f"  {fname}: out {pred.shape} 1 mm RAS, range [{pred.min():.2f}, "
                  f"{pred.max():.2f}], mean {pred.mean():.2f}")

        phase("warm seconds per volume; fast network vs plain float32 forward")
        timings = {}
        for fname in ("t1_256.nii.gz", "flair_clinical.nii.gz"):
            _, vol, aff, _, _ = inputs[fname]
            x, _, _ = warm.prepare(vol, aff)
            net_ms = cuda_ms(lambda: warm.network(x), 2)
            secs = []
            for _ in range(2):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                warm.predict_volume(vol, aff)
                torch.cuda.synchronize()
                secs.append(time.perf_counter() - t0)
            with torch.no_grad():
                fast = warm.network(x)
                plain = 0.5 * warm.model(x) + 0.5 * torch.flip(warm.model(torch.flip(x, [2])), [2])
            rel = float((fast - plain).norm() / plain.norm())
            max_out = float(255 * (fast - plain).abs().max())
            timings[fname] = dict(padded=list(x.shape[2:]), predict_volume_s=secs,
                                  network_tta_ms=net_ms, net_rel_l2=rel)
            if fname == "t1_256.nii.gz":
                wall_ms, device_ms, idle = profile_predict_volume(warm, vol, aff)
                timings[fname].update(profiled_wall_ms=wall_ms, device_ms=device_ms,
                                      device_idle=idle)
                rows = {c["shape"]: c["ms"] for c in checks if c["shape"] in PREDICT_ROWS}
                for row, n_pair in PREDICT_ROWS.items():
                    print(f"  predict pass row {row:28s} {n_pair} launches per TTA pair x "
                          f"{rows[row]:.3f} ms")
                sigma = sum(n_pair * rows[row] for row, n_pair in PREDICT_ROWS.items())
                print(f"  sum of launches x kernel ms over the pass: {sigma:.3f} ms, beside the "
                      f"network's {net_ms:.3f} ms (CUDA events)")
                timings[fname]["sum_launches_x_ms"] = sigma
            print(f"  {fname}: padded {tuple(x.shape[2:])}  predict_volume {secs} s  "
                  f"network (2 forwards) {net_ms:.1f} ms  vs plain: relative L2 {rel:.3e} "
                  f"(bound {NET_BOUND:.0e}), max |diff| x255 = {max_out:.3f}")
            require(np.isfinite(rel) and rel <= NET_BOUND, (fname, rel))
            del x, fast, plain
        del warm
        torch.cuda.empty_cache()

        predict_f32 = predict_f32_phase(predict, conv_cf, weights, inputs["flair_clinical.nii.gz"])
        large_fov = large_fov_phase(predict, conv_cf, weights, tmp, rng)
        hyperfine = hyperfine_phase(conv_cf, tmp, rng)

    with tempfile.TemporaryDirectory() as root:
        make_train_data(root, rng)
        train = train_phase(conv_cf, root)
        adversarial = adversarial_phase(conv_cf, root)
        seg_train = seg_train_phase(conv_cf, root)
        pm, ps = adversarial["priors"]
        dp = dp_phase(conv_cf, root, seg_train["trained"], seg_train["segmenter"],
                      adversarial["trained"], pm, ps)
        adv_seg = adversarial_segmenter_phase(conv_cf, root, pm, ps, seg_train["segmenter"])
        halo = halo_phase(root)
        lab2im = lab2im_phase(root)
        native = native_phase(root)
        tutorials = tutorials_phase(conv_cf, root)
        surface = surface_phase(conv_cf, root, pm, ps)
    options = options_phase()
    head3 = head3_phase(conv_cf)
    autoencoder = autoencoder_phase()
    label_ops = label_ops_phase()
    path_launches = {"predict": launches, "predict_float32": predict_f32["launches"],
                     "predict_large_fov": large_fov["launches"],
                     "hyperfine": hyperfine["launches"], "train": train["launches"],
                     "train_float32": train["f32_launches"],
                     "adversarial": adversarial["launches"],
                     "adversarial_float32": adversarial["f32_launches"],
                     "train_segmenter": seg_train["launches"],
                     "data_parallel_world_1": dp["launches"],
                     "adversarial_segmenter": adv_seg["launches"],
                     "fast_forward_3_label": head3["launches"],
                     "tutorials": tutorials["launches"]}

    kernels = []
    fwd_also = [f"{PALLAS}:920", f"{PALLAS}:1297", f"{PALLAS}:127"]
    for kernel, source, replaces, also in (
            ("first_mma", FIRST_MMA_SOURCE, f"{PALLAS}:569", []),
            ("first_x3", FIRST_X3_SOURCE, f"{PALLAS}:569", []),
            ("fwd_wg", WG_SOURCE, f"{PALLAS}:270", fwd_also),
            ("fwd_mma", MMA_SOURCE, f"{PALLAS}:270", fwd_also),
            ("wgrad_wg", WGRAD_WG_SOURCE, f"{PALLAS}:1090", [f"{PALLAS}:1705"]),
            ("wgrad_mma", WGRAD_MMA_SOURCE, f"{PALLAS}:1090", [f"{PALLAS}:1705"]),
            ("fwd_x3", X3_SOURCE, f"{PALLAS}:270", fwd_also),
            ("wgrad_x3", WGRAD_X3_SOURCE, f"{PALLAS}:1090", [f"{PALLAS}:1705"])):
        mine = [c for c in checks if c["kernel"] == kernel]
        timed = next(c for c in mine if c["shape"] == TIMED[kernel])
        kernels.append(dict(
            name=f"h_{kernel}", route="cuda", source=source, replaces=replaces,
            also_replaces=also, launches=sum(v[kernel] for v in path_launches.values()),
            launches_by_path={p: v[kernel] for p, v in path_launches.items()},
            max_abs_err=max(c["max_abs_err"] for c in mine), ms=timed["ms"],
            plain_ms=timed["plain_ms"], bound_ms=timed["bound_ms"], bound_by=timed["bound_by"],
            library_ms=timed["library_ms"], timed_shape=timed["shape"],
            checks=[{k: c.get(k) for k in ("shape", "fused", "dtype", "rel_err", "ms", "plain_ms",
                                           "library_ms", "bound_ms", "bound_by", "mma_ms")}
                    for c in mine]))
    print(json.dumps({"timings": timings, "main_seconds": main_s,
                      "peak_allocated_bytes": peak, "predict_float32": predict_f32["summary"],
                      "large_fov": large_fov["summary"],
                      "hyperfine": hyperfine["summary"], "train": train["summary"],
                      "adversarial": adversarial["summary"],
                      "train_segmenter": seg_train["summary"],
                      "data_parallel_world_1": dp["summary"],
                      "adversarial_segmenter": adv_seg["summary"], "unet_options": options,
                      "fast_forward_3_label": head3["summary"], "halo_world_1": halo,
                      "autoencoder": autoencoder, "lab2im": lab2im, "label_ops": label_ops,
                      "native_loader": native, "tutorials": tutorials["summary"],
                      "surface": surface}))
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
