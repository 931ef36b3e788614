"""synthsr_tpu_torch — the PyTorch / CUDA port of ``synthsr_tpu`` for NVIDIA
Hopper (H100).

This package covers the predict paths (the all-purpose 24-feature, 5-level
U-Net with flip TTA, at any field of view, and the Hyperfine T1+T2 residual
net), supervised training (every U-Net option, the frozen-segmenter Dice
regulariser, remat, data parallelism over ``torch.distributed``), WGAN-GP
fine-tuning, and the rest of the JAX package: the halo-sharded U-Net, the
auto-encoder, lab2im and the label ops, the host dataset tools, the C++
NIfTI loader and the tutorial entry points.  It imports ``torch`` and never ``jax``,
``flax`` or ``synthsr_tpu``: the host modules it needs from the JAX package
are copied here under the same module names.

Modules, each beside its JAX counterpart of the same path unless named:

- ``ops/conv_cf.py`` (``ops/conv_pallas.py``'s forward and weight-gradient
  entries): ``conv3d_cf`` / ``conv3d_cf_wgrad`` dispatch, launch counts and
  their plain versions;
- ``csrc/``: CUDA C++ for sm_90a.  ``conv3d_fwd_wg.cu`` (H-fwd-wg, bf16 on
  wgmma and TMA), ``conv3d_fwd_mma.cu`` (H-fwd-mma, bf16 on mma.sync, what
  H-fwd-wg's gate refuses) and ``conv3d_fwd_x3.cu`` (H-fwd-x3, float32 on the
  tensor cores by split TF32) replace ``_plane_kernel``,
  ``conv3d_cf_grouped``, ``_flat_kernel`` and ``_kernel``;
  ``conv3d_first_mma.cu`` (H-first-mma, bf16 on the tensor cores) and
  ``conv3d_first_x3.cu`` (H-first-x3, float32 on the tensor cores by split
  TF32) replace ``_first_kernel``;
  ``conv3d_wgrad_wg.cu`` (H-wgrad-wg, bf16 on wgmma and TMA),
  ``conv3d_wgrad_mma.cu`` (H-wgrad-mma, bf16, what H-wgrad-wg's gate
  refuses: volumes narrower than 8) and ``conv3d_wgrad_x3.cu``
  (H-wgrad-x3, float32, split TF32) replace ``_wgrad_kernel`` and ``_wgrad_flat_kernel``, with
  ``conv3d_wgrad.cu``'s reduce; ``wg_common.cuh`` holds what the wgmma
  kernels share, ``mma_common.cuh`` what the mma.sync ones share;
- ``ops/cuda_build.py`` (no counterpart: Pallas compiles in ``jit``): nvcc
  build on first use, ctypes load;
- ``ops/conv_train.py``, ``ops/linops.py``, ``ops/blur.py``,
  ``ops/interp.py``, ``ops/losses.py``: the differentiable conv, the device
  resample and the generator's and losses' ops;
- ``models/unet.py`` (plain forwards), ``models/unet_cf.py``
  (``fast_unet_forward``), ``models/unet_cf_train.py`` (fast train-mode
  forward), ``models/weights.py`` (flax tree <-> state dict, seeded
  ``random_variables``, weight loading);
- ``synth/``, ``train/``, ``utils/finite_guard.py``: the generator and the
  training loops (``train/training.py``, ``train/adversarial.py``);
- ``parallel/mesh.py``: the data-parallel process group, its all-reduces
  and the worker launcher; ``parallel/halo.py`` and
  ``parallel/halo_train.py``: the D-sharded U-Net forward and train step
  with a halo exchange;
- ``models/autoencoder.py``: the auto-encoder / VAE and ``LocalBias``;
  ``synth/lab2im.py`` and ``synth/label_ops.py``: lab2im and its label ops;
  ``utils/profiling.py``: torch.profiler traces and step timing;
- ``native/`` (the JAX package's C++ NIfTI loader, built with g++ on first
  use) behind ``io/volume.load_volume(fast=True)``;
- ``cli/predict.py``, ``cli/predict_hyperfine.py``, ``cli/train.py``,
  ``cli/parity.py``: the CLIs, with the JAX ones' flags;
- ``examples/``: the tutorial entry points of ``examples/1-9``;
- copies of the JAX package's host modules: ``io/nifti.py``,
  ``io/volume.py``, ``io/labels.py``, ``io/label_edit.py``,
  ``io/dataset_tools.py``, ``ops/host_matrices.py``, ``models/h5_import.py``,
  ``synth/model_inputs.py``, ``synth/estimate_priors.py``, ``utils/misc.py``,
  ``utils/prefetch.py``, ``cli/_pipeline.py``.

Run the predict CLIs with ``python -m synthsr_tpu_torch.cli.predict in out``
and ``python -m synthsr_tpu_torch.cli.predict_hyperfine t1 t2 out``, a
tutorial with ``python -m synthsr_tpu_torch.examples.tutorial_1_sr_real``.
"""

__version__ = "0.1.0"
