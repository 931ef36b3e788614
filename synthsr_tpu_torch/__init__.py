"""synthsr_tpu_torch — the PyTorch / CUDA port of ``synthsr_tpu`` for NVIDIA
Hopper (H100).

This package covers the predict path: the 24-feature, 5-level U-Net with
flip TTA.  It imports ``torch`` and never ``jax`` or ``flax``; the jax-free
host modules of ``synthsr_tpu`` (NIfTI I/O, host resample matrices, Keras .h5
import, the threaded batch pipeline) are imported, not copied.

=========================  =========================================  ====================================
module                     JAX counterpart                            what it holds
=========================  =========================================  ====================================
``ops/conv_cf.py``         ``synthsr_tpu/ops/conv_pallas.py``         ``conv3d_cf`` (kernel dispatch, launch
                           (forward family)                           counts) and ``conv3d_cf_reference``
``csrc/conv3d_cf.cu``      ``_first_kernel``, ``_plane_kernel``,      H-first and H-fwd, CUDA C++ for sm_90a
                           ``conv3d_cf_grouped``, ``_flat_kernel``
``ops/cuda_build.py``      (none: Pallas compiles in ``jit``)         nvcc build on first use, ctypes load
``ops/linops.py``          ``synthsr_tpu/ops/linops.py``              ``apply_axis_ops`` (device resample)
``models/unet.py``         ``synthsr_tpu/models/unet.py``             ``UNet3D`` (plain forward), ``synthsr_unet``
``models/unet_cf.py``      ``synthsr_tpu/models/unet_cf.py``          ``fast_unet_forward``, ``pack_unet``,
                                                                      ``bn_affine``, ``flip_d_state_dict``
``models/weights.py``      flax ``init`` + ``models/h5_import.py``    flax tree <-> state dict, seeded
                           glue                                       ``random_variables``, weight loading
``cli/predict.py``         ``synthsr_tpu/cli/predict.py``             ``Predictor``, ``run_batch``, ``main``
=========================  =========================================  ====================================

Run the predict CLI with ``python -m synthsr_tpu_torch.cli.predict in out``.
"""

__version__ = "0.1.0"
