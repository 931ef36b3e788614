"""synthsr_tpu_torch — the PyTorch / CUDA port of ``synthsr_tpu`` for NVIDIA
Hopper (H100).

This package covers the predict paths (the all-purpose 24-feature, 5-level
U-Net with flip TTA, at any field of view, and the Hyperfine T1+T2 residual
net), supervised training (every U-Net option, the frozen-segmenter Dice
regulariser, remat, data parallelism over ``torch.distributed``) and
WGAN-GP fine-tuning.  It imports ``torch`` and never ``jax``,
``flax`` or ``synthsr_tpu``: the host modules it needs from the JAX package
are copied here under the same module names.

Modules, each beside its JAX counterpart of the same path unless named:

- ``ops/conv_cf.py`` (``ops/conv_pallas.py``'s forward and weight-gradient
  entries): ``conv3d_cf`` / ``conv3d_cf_wgrad`` dispatch, launch counts and
  their plain versions;
- ``csrc/``: CUDA C++ for sm_90a.  ``conv3d_fwd_mma.cu`` (H-fwd-mma, bf16
  on the tensor cores) and ``conv3d_cf.cu``'s H-fwd (float32) replace
  ``_plane_kernel``, ``conv3d_cf_grouped``, ``_flat_kernel`` and ``_kernel``;
  ``conv3d_first_mma.cu`` (H-first-mma, bf16 on the tensor cores) and
  ``conv3d_cf.cu``'s H-first (float32) replace ``_first_kernel``;
  ``conv3d_wgrad_mma.cu`` (H-wgrad-mma, bf16) and ``conv3d_wgrad.cu``
  (H-wgrad, float32) replace ``_wgrad_kernel`` and ``_wgrad_flat_kernel``;
  ``mma_common.cuh`` holds what the mma kernels share;
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
  and the worker launcher;
- ``cli/predict.py``, ``cli/predict_hyperfine.py``, ``cli/train.py``: the
  CLIs, with the JAX ones' flags;
- copies of the JAX package's host modules: ``io/nifti.py``,
  ``io/volume.py``, ``io/labels.py`` (without the C++ NIfTI loader),
  ``ops/host_matrices.py``, ``models/h5_import.py``,
  ``synth/model_inputs.py``, ``utils/misc.py``, ``utils/prefetch.py``,
  ``cli/_pipeline.py``.

Run the predict CLIs with ``python -m synthsr_tpu_torch.cli.predict in out``
and ``python -m synthsr_tpu_torch.cli.predict_hyperfine t1 t2 out``.
"""

__version__ = "0.1.0"
