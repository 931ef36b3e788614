"""Hyperfine multispectral predict CLI on PyTorch: T1 + T2 low-field pairs ->
synthetic 1 mm MP-RAGE.  The port of ``synthsr_tpu/cli/predict_hyperfine.py``
(reference ``scripts/predict_command_line_hyperfine.py``).

Same flags, file/directory batch semantics and ``_SynthSR`` output naming,
same math: a 2-channel U-Net predicting a RESIDUAL; T1 resampled to 1 mm (on
the device, as per-axis matrices) and RAS-aligned (:110-112); T2 resliced
into that grid (:113-114), through per-axis matrices on the device when the
transform between the grids is axis-aligned and through the host
``resample_volume_like`` when it is oblique; the training-quirk
normalisations kept exactly, T1 divided by max/3 and T2 scaled to [0, 2]
(:116-121); centre zero-pad to a multiple of 32; one forward, no flip TTA;
prediction ``minimum + spread·(residual + t1)`` clipped at 0 (:128-131).

The network runs on CUDA unless ``--cpu`` (or ``device="cpu"``) is given; a
missing GPU raises.  ``--fast_inference`` (default on) runs the fast forward
(``models/unet_cf.py``: 1 H-first-mma launch for the 2-channel first conv,
17 H-fwd-mma in bf16; H-first-x3 and H-fwd-x3 in float32); ``off`` selects the plain float32 ``UNet3D.forward``, a test
reference that is refused on a CUDA device.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch

from ..io.volume import align_volume_to_ref, load_volume, resample_volume_like, save_volume
from ..models.unet import synthsr_unet
from ..models.unet_cf import fast_unet_forward, pack_unet
from ..models.weights import load_unet_weights
from ..ops.host_matrices import reslice_like_matrices, resample_volume_matrices
from ..utils.misc import list_images_in_folder
from ._pipeline import run_pipelined
from .predict import _DTYPES, _EXTS, _device, _output_name, device_axis_ops, pad_to_32

DEFAULT_MODEL = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "models", "SynthSR_v10_210712_hyperfine.h5")


def build_arg_parser():
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("path_t1_images", help="T1 image or folder of T1 images")
    p.add_argument("path_t2_images", help="T2 image or folder (same order as T1)")
    p.add_argument("path_predictions", help="output path (file or folder)")
    p.add_argument("--cpu", action="store_true", help="run on the CPU instead of the GPU")
    p.add_argument("--threads", type=int, default=1,
                   help="CPU threads when running with --cpu")
    p.add_argument("--model", default=None,
                   help="model weights (.h5 Keras or a torch.save'd state dict .pt)")
    p.add_argument("--fast_inference", choices=["auto", "on", "off"], default="auto",
                   help="fast forward through the conv kernels (auto = on); off = "
                        "plain float32 reference forward, CPU only")
    return p


def _prepare_paths(t1, t2, preds):
    """File-or-directory batch semantics (reference :95-108): T1 and T2 lists
    pair in sorted order; outputs are named after the T1 images."""
    t1, t2, preds = map(os.path.abspath, (t1, t2, preds))
    if not os.path.basename(t1).endswith(_EXTS):
        if os.path.isfile(t1):
            raise ValueError(f"extension not supported for {t1}")
        t1s = list_images_in_folder(t1)
        t2s = list_images_in_folder(t2)
        if len(t1s) != len(t2s):
            raise ValueError(f"{len(t1s)} T1 images but {len(t2s)} T2 images")
        os.makedirs(preds, exist_ok=True)
        return t1s, t2s, [_output_name(im, preds) for im in t1s]
    for path in (t1, t2):
        if not os.path.isfile(path):
            raise FileNotFoundError(f"file does not exist: {path}")
    return [t1], [t2], [preds]


class HyperfinePredictor:
    """The T1+T2 residual pipeline on one device, weights loaded and packed once."""

    def __init__(self, model_path=None, compute_dtype="bfloat16", fast_inference="auto",
                 device=None):
        self.device = _device(device)
        self.dtype = _DTYPES[str(compute_dtype)]
        if fast_inference not in ("auto", "on", "off"):
            raise ValueError(f"fast_inference must be auto, on or off, got {fast_inference!r}")
        self.use_fast = fast_inference != "off"
        if not self.use_fast and self.device.type == "cuda":
            raise ValueError("fast_inference='off' (the plain reference forward) is "
                             "refused on a CUDA device")
        self.model = synthsr_unet(nb_channels=2)
        load_unet_weights(self.model, DEFAULT_MODEL if model_path is None else model_path)
        self.model.to(self.device).eval()
        self.packed = pack_unet(self.model, self.dtype) if self.use_fast else None

    @torch.no_grad()
    def network(self, x: torch.Tensor) -> torch.Tensor:
        """(1, 2, D, H, W) float32 on the device -> the residual (1, 1, D, H, W)
        float32."""
        if self.use_fast:
            return fast_unet_forward(self.model, x, self.dtype, self.packed)
        return self.model(x)

    def prepare(self, im1, aff1, im2, aff2):
        """T1 to 1 mm RAS, T2 resliced into that grid, both normalised, stacked
        and centre-padded to a multiple of 32.

        Returns (x (1, 2, D, H, W) float32 on the device, crop slices, the
        normalised T1, its minimum and spread, the output affine)."""
        im1 = np.asarray(im1, np.float32)
        im2 = np.asarray(im2, np.float32)
        mats, _, aff1 = resample_volume_matrices(im1.shape, aff1, [1.0, 1.0, 1.0])
        im1 = device_axis_ops(im1, mats, self.device)
        im1, aff_out = align_volume_to_ref(im1, aff1, aff_ref=np.eye(4), return_aff=True,
                                           n_dims=3)
        mats2 = reslice_like_matrices(im1.shape, aff_out, im2.shape, aff2)
        if mats2 is not None:
            im2 = device_axis_ops(im2, mats2, self.device)
        else:  # oblique transform: host fallback
            im2 = resample_volume_like(im1, aff_out, im2, aff2)

        minimum = float(np.min(im1))
        im1 = im1 - minimum
        spread = float(np.max(im1)) / 3.0
        if spread > 0:
            im1 = im1 / spread
        im2 = im2 - np.min(im2)
        mx2 = np.max(im2)
        if mx2 > 0:
            im2 = im2 / mx2 * 2.0

        padded, crop = pad_to_32(im1.shape)
        s = np.zeros((1, 2, *padded), np.float32)
        s[(0, 0) + crop] = im1
        s[(0, 1) + crop] = im2
        return torch.from_numpy(s).to(self.device), crop, im1, minimum, spread, aff_out

    def predict_pair(self, im1, aff1, im2, aff2):
        """Run the full pipeline on one T1/T2 pair; returns (pred, aff)."""
        x, crop, t1, minimum, spread, aff = self.prepare(im1, aff1, im2, aff2)
        residual = self.network(x)[0, 0].cpu().numpy()[crop]
        pred = minimum + spread * (residual + t1)
        pred[pred < 0] = 0
        return pred, aff

    def predict_files(self, p1: str, p2: str, pout: str):
        im1, aff1, _ = load_volume(p1, im_only=False, dtype="float")
        im2, aff2, _ = load_volume(p2, im_only=False, dtype="float")
        pred, aff = self.predict_pair(im1, aff1, im2, aff2)
        save_volume(pred, aff, None, pout)


def run_batch(predictor: HyperfinePredictor, t1s, t2s, outs, prefetch: int = 2,
              verbose: bool = False):
    """Directory batch mode on the three-stage pipeline (``cli/_pipeline.py``:
    loader thread ahead, writer behind)."""
    def loads():
        for p1, p2 in zip(t1s, t2s):
            yield (load_volume(p1, im_only=False, dtype="float"),
                   load_volume(p2, im_only=False, dtype="float"))

    def predict(item):
        (im1, aff1, _), (im2, aff2, _) = item
        return predictor.predict_pair(im1, aff1, im2, aff2)

    run_pipelined(loads(), predict, outs, prefetch=prefetch, verbose=verbose,
                  describe=lambda idx: t1s[idx] + ", " + t2s[idx])


def main(argv=None):
    args = build_arg_parser().parse_args(argv)
    device = None
    if args.cpu:
        print("using CPU backend")
        torch.set_num_threads(args.threads)
        device = "cpu"
    t1s, t2s, outs = _prepare_paths(args.path_t1_images, args.path_t2_images,
                                    args.path_predictions)
    print(f"Found {len(t1s)} images")
    predictor = HyperfinePredictor(model_path=args.model,
                                   fast_inference=args.fast_inference, device=device)
    run_batch(predictor, t1s, t2s, outs, verbose=True)
    print("\nAll done!\n")


if __name__ == "__main__":
    sys.exit(main())
