"""All-purpose SynthSR predict CLI on PyTorch: arbitrary MRI/CT -> synthetic
1 mm MP-RAGE.  The port of ``synthsr_tpu/cli/predict.py``.

Same flags, file/directory batch semantics and ``_SynthSR`` output naming,
same math: CT clip to [0, 80] HU, resample to 1 mm (as per-axis matrices),
RAS alignment, min-max normalisation, centre zero-pad to a multiple of 32,
flip-averaged TTA, output ``clip(255·(y0+y1)/2, 0, 128)``, unpad.  The raw
scan is copied to the device once; everything up to the output's copy back
runs there, with no host synchronisation, and gives the bits the same
operations give in numpy.

While the tracer of ``utils/profiling`` is on, each ``predict_volume`` is a
``predict.volume`` span tiled by ``predict.resample``, ``predict.align``,
``predict.normalise``, ``predict.pad``, ``predict.upload``,
``predict.network`` and ``predict.output``.  The five stages of
``prepare`` are host time to launch their device work (the device's share
is in a profiler trace, under the stage's range): the raw scan's copy, the
CT clip and the axis products; the swaps and flips; the min and max;
the zeroed pad buffer and the normalised volume written into it;
``predict.upload`` only hands the padded tensor over.  The counters
``predict.h2d_bytes`` and ``predict.d2h_bytes`` add the bytes of the raw
scan copied to the device and of the output copied back.

The network runs on CUDA unless ``--cpu`` (or ``device="cpu"``) is given; a
missing GPU raises.  ``--fast_inference`` (default on) runs the fast forward
(``models/unet_cf.py``): its convs launch the hand-written kernels on a card
and their plain versions on the CPU.  ``off`` selects the plain float32
``UNet3D.forward``, a test reference that is refused on a CUDA device.  The
flip-TTA pass of the fast forward reuses it with D-flipped conv kernels
(no input or output flip); the plain pass flips input and output.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch

from ..io.volume import _ras_moves, load_volume, save_volume
from ..models.unet import synthsr_unet
from ..models.unet_cf import fast_unet_forward, flip_d_state_dict, pack_unet
from ..models.weights import load_unet_weights
from ..ops.host_matrices import resample_volume_matrices
from ..ops.linops import apply_axis_ops
from ..utils.misc import list_images_in_folder
from ..utils.profiling import count, span
from ._pipeline import run_pipelined

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
_EXTS = (".nii.gz", ".nii", ".mgz", ".npz")

DEFAULT_MODEL = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "models", "SynthSR_v10_210712.h5")


def build_arg_parser():
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("path_images",
                   help="image or folder of images to super-resolve / synthesize")
    p.add_argument("path_predictions",
                   help="output path; same type as path_images (file or folder)")
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU instead of the GPU")
    p.add_argument("--threads", type=int, default=1,
                   help="CPU threads when running with --cpu")
    p.add_argument("--ct", action="store_true", help="input is a CT scan")
    p.add_argument("--model", default=None,
                   help="model weights (.h5 Keras or a torch.save'd state dict .pt)")
    p.add_argument("--disable_flipping", action="store_true",
                   help="disable flip test-time augmentation")
    p.add_argument("--fast_inference", choices=["auto", "on", "off"], default="auto",
                   help="fast forward through the conv kernels (auto = on); off = "
                        "plain float32 reference forward, CPU only")
    return p


def _output_name(path_in: str, out_dir: str) -> str:
    name = os.path.basename(path_in)
    for e in _EXTS:
        if name.endswith(e):
            name = name[: -len(e)] + "_SynthSR" + e
            break
    return os.path.join(out_dir, name)


def _prepare_paths(path_images: str, path_predictions: str):
    """File-or-directory batch semantics with _SynthSR suffix naming
    (reference predict_command_line.py:91-105), as
    ``synthsr_tpu/cli/predict.py:_prepare_paths``."""
    path_images = os.path.abspath(path_images)
    path_predictions = os.path.abspath(path_predictions)
    if not os.path.basename(path_images).endswith(_EXTS):
        if os.path.isfile(path_images):
            raise ValueError(f"extension not supported for {path_images}, "
                             "only use: nii.gz, .nii, .mgz, or .npz")
        images = list_images_in_folder(path_images)
        os.makedirs(path_predictions, exist_ok=True)
        return images, [_output_name(im, path_predictions) for im in images]
    if not os.path.isfile(path_images):
        raise FileNotFoundError(f"file does not exist: {path_images}")
    return [path_images], [path_predictions]


def _device(device) -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device available; pass --cpu (device='cpu') "
                               "to run on the CPU")
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev


def device_axis_ops(im: np.ndarray, mats, device: torch.device) -> np.ndarray:
    """Per-axis matrices (host-built, ``ops/host_matrices.py``) applied to a
    float32 volume on ``device`` (``ops/linops.apply_axis_ops``); the result
    comes back to the host as float32 numpy."""
    out = apply_axis_ops(torch.from_numpy(im).to(device),
                         [torch.from_numpy(m).to(device) for m in mats])
    return out.cpu().numpy()


def pad_to_32(shape):
    """The centred zero-pad of a volume to a multiple of 32 in every axis:
    (padded shape, the slices of the volume inside it)."""
    shape = np.array(shape)
    padded = (np.ceil(shape / 32.0) * 32).astype(int)
    lo = np.floor((padded - shape) / 2).astype(int)
    return tuple(int(p) for p in padded), tuple(slice(a, a + s) for a, s in zip(lo, shape))


class Predictor:
    """The predict pipeline on one device, weights loaded and packed once."""

    def __init__(self, model_path=None, disable_flipping=False, ct=False,
                 compute_dtype="bfloat16", n_channels=1, fast_inference="auto",
                 device=None):
        self.device = _device(device)
        self.dtype = _DTYPES[str(compute_dtype)]
        if fast_inference not in ("auto", "on", "off"):
            raise ValueError(f"fast_inference must be auto, on or off, got {fast_inference!r}")
        self.use_fast = fast_inference != "off"
        if not self.use_fast and self.device.type == "cuda":
            raise ValueError("fast_inference='off' (the plain reference forward) is "
                             "refused on a CUDA device")
        self.disable_flipping = disable_flipping
        self.ct = ct
        self.model = synthsr_unet(nb_channels=n_channels)
        load_unet_weights(self.model, DEFAULT_MODEL if model_path is None else model_path)
        self.model.to(self.device).eval()
        if self.use_fast:
            self.packed = pack_unet(self.model, self.dtype)
            self.packed_flip = None
            if not disable_flipping:
                flipped = synthsr_unet(nb_channels=n_channels)
                flipped.load_state_dict(flip_d_state_dict(self.model.state_dict()))
                self.packed_flip = pack_unet(flipped.to(self.device).eval(), self.dtype)

    @torch.no_grad()
    def network(self, x: torch.Tensor) -> torch.Tensor:
        """(1, C, D, H, W) float32 on the device -> the TTA-averaged network
        output (1, 1, D, H, W) float32, before scaling and clipping."""
        if self.use_fast:
            y0 = fast_unet_forward(self.model, x, self.dtype, self.packed)
            if self.disable_flipping:
                return y0
            y1 = fast_unet_forward(self.model, x, self.dtype, self.packed_flip)
        else:
            y0 = self.model(x)
            if self.disable_flipping:
                return y0
            y1 = torch.flip(self.model(torch.flip(x, [2])), [2])
        return 0.5 * y0 + 0.5 * y1

    def prepare(self, im: np.ndarray, aff: np.ndarray):
        """CT clip, resample to 1 mm, RAS alignment, min-max normalisation and
        centre pad to a multiple of 32, on the device after one copy of the
        raw scan, without waiting on it.

        Returns (x (1, 1, D, H, W) float32 on the device, crop slices, aff)."""
        dev = self.device
        with span("predict.resample"):
            im = np.asarray(im, np.float32)
            mats, _, aff = resample_volume_matrices(im.shape, aff, [1.0, 1.0, 1.0])
            # pageable sources: non_blocking only drops the wait for the copy
            mats = [torch.from_numpy(m).to(dev, non_blocking=True) for m in mats]
            x = torch.from_numpy(im).to(dev, non_blocking=True)
            count("predict.h2d_bytes", x.nbytes)
            if self.ct:
                x = torch.clamp(x, 0.0, 80.0)
            x = apply_axis_ops(x, mats)
        with span("predict.align"):
            swaps, flips, aff2 = _ras_moves(aff, x.shape)
            for a, b in swaps:
                x = x.transpose(a, b)
            if flips:
                x = torch.flip(x, flips)
        with span("predict.normalise"):
            lo, hi = torch.aminmax(x)
            # max(x - lo) is hi - lo: rounding is monotone.  A 0-d device
            # divisor keeps a true division (a CPU scalar becomes a multiply
            # by its reciprocal on CUDA) and needs no sync.
            top = hi - lo
            top = torch.where(top > 0, top, 1.0)
        with span("predict.pad"):
            padded, crop = pad_to_32(x.shape)
            s = torch.zeros((1, 1, *padded), dtype=torch.float32, device=dev)
            inner = s[(0, 0) + crop]
            torch.sub(x, lo, out=inner)
            inner.div_(top)
        with span("predict.upload"):
            x = s
        return x, crop, aff2

    def predict_volume(self, im: np.ndarray, aff: np.ndarray):
        """Run the full pipeline on one volume; returns (pred, aff)."""
        with span("predict.volume"):
            x, crop, aff2 = self.prepare(im, aff)
            with span("predict.network"):
                y = self.network(x)
            with span("predict.output"):
                pred = torch.clamp(255.0 * y, 0.0, 128.0)
                count("predict.d2h_bytes", pred[0, 0].nbytes)
                return pred[0, 0].cpu().numpy()[crop], aff2

    def predict_file(self, path_in: str, path_out: str):
        im, aff, _ = load_volume(path_in, im_only=False, dtype="float")
        pred, aff2 = self.predict_volume(im, aff)
        save_volume(pred, aff2, None, path_out)


def run_batch(predictor: Predictor, images, outs, prefetch: int = 2,
              verbose: bool = False):
    """Directory batch mode on the three-stage pipeline (``cli/_pipeline.py``:
    loader thread ahead, writer behind)."""
    def loads():
        for pin in images:
            yield load_volume(pin, im_only=False, dtype="float")

    run_pipelined(loads(), lambda item: predictor.predict_volume(item[0], item[1]),
                  outs, prefetch=prefetch, verbose=verbose,
                  describe=lambda idx: images[idx])


def main(argv=None):
    args = build_arg_parser().parse_args(argv)
    device = None
    if args.cpu:
        print("using CPU backend")
        torch.set_num_threads(args.threads)
        device = "cpu"
    images, outs = _prepare_paths(args.path_images, args.path_predictions)
    print(f"Found {len(images)} images")
    predictor = Predictor(model_path=args.model, disable_flipping=args.disable_flipping,
                          ct=args.ct, fast_inference=args.fast_inference, device=device)
    run_batch(predictor, images, outs, verbose=True)
    print("\nAll done!\n")


if __name__ == "__main__":
    sys.exit(main())
